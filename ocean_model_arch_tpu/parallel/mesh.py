"""Device mesh construction.

The replacement for the reference's 2D MPI Cartesian communicator
(shared/mpp/mpp.f90:83-93, mpi_dims_create + mpi_cart_create): a 2D jax
device mesh with axes ("x", "y") over which every 2D field is sharded
P("x", "y"). Halo traffic is ppermute collectives between neighbouring
devices (parallel/halo.py).
"""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(px: int, py: int, devices=None) -> Mesh:
    """A px*py 2D mesh. Like mpi_dims_create, prefers the given split; the
    caller picks px, py with px*py == number of devices used."""
    if devices is None:
        devices = jax.devices()
    n = px * py
    if len(devices) < n:
        raise ValueError(f"need {n} devices, have {len(devices)}")
    dev = np.array(devices[:n]).reshape(px, py)
    return Mesh(dev, ("x", "y"))


def auto_dims(n: int) -> tuple[int, int]:
    """Closest-to-square factorization, like mpi_dims_create."""
    best = (n, 1)
    for px in range(1, int(np.sqrt(n)) + 1):
        if n % px == 0:
            best = (n // px, px)
    return best


def field_spec(ndim: int) -> P:
    """PartitionSpec for a model array: 2D fields shard over the mesh, 3D
    tracer stacks shard their spatial dims, 1D coordinate arrays and
    scalars replicate."""
    if ndim == 2:
        return P("x", "y")
    if ndim == 3:
        return P(None, "x", "y")
    return P()


def tree_specs(tree):
    """PartitionSpecs for a state/grid pytree by array rank."""
    return jax.tree.map(lambda a: field_spec(np.ndim(a)), tree)


def shard_tree(tree, mesh: Mesh):
    """Device-put a pytree with its natural shardings."""
    return jax.tree.map(
        lambda a, s: jax.device_put(a, NamedSharding(mesh, s)),
        tree, tree_specs(tree))
