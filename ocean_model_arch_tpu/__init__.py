"""Shallow-water (barotropic) ocean modeling framework in JAX.

A from-scratch JAX/XLA re-design of the capabilities of the PSyKAl
Fortran reference (Andrcraft9/ocean_model_arch, INMOM barotropic core):

- Arakawa-C finite-difference shallow-water dynamics (ssh, u, v) with
  Coriolis, Rayleigh/bottom friction, lateral viscosity and land/sea masks
  (reference: kernel/shallow_water/*.f90).
- Passive tracer advection-diffusion (reference: kernel/tracer/*.f90).
- Cartesian / spherical / curvilinear (bipolar) grid metrics
  (reference: kernel/service/grid_parameters.f90).
- 2D device-mesh SPMD via jax.shard_map with ppermute halo exchange
  (replacing the reference's MPI block decomposition + hand-packed halo
  sync, shared/mpp/*).
- A fused whole-step update for the hot stencil path (replacing the
  reference's CUDA Fortran mirror, gpu/*): plain jnp that carries only
  the 6 prognostic fields, compiled by XLA.

The package is organized as:
  config/    typed configs + reference-compatible .par file loaders
  core/      grid construction: masks, metrics, depths, state pytrees
  ops/       the physics kernels (pure jnp on padded arrays + the fused
             step)
  parallel/  mesh, sharding, halo exchange, decomposition diagnostics
  model/     step composition and the time-loop driver
  io/        mask/GrADS/checkpoint IO
  utils/     timers, error guards
"""

__version__ = "0.1.0"
