"""Fused step over full 2D meshes vs the single-device jnp path."""

import jax
import numpy as np
import pytest

from ocean_model_arch_tpu.config import (ModelConfig, Precision, SWConfig,
                                         basinpar_flat)
from ocean_model_arch_tpu.core.grid import build_grid
from ocean_model_arch_tpu.core.masks import frame_of_land_mask
from ocean_model_arch_tpu.model.fused_sharded2d import FusedSharded2DModel
from ocean_model_arch_tpu.model.init import init_ocean_state
from ocean_model_arch_tpu.model.step import make_step, run_steps


@pytest.fixture(scope="module")
def case():
    basin = basinpar_flat(70, 52, curve_grid=1, rlon=27.5, rlat=41.0)
    prec = Precision.f32()
    cfg = ModelConfig(basin=basin,
                      sw=SWConfig(use_tracers=1, tracer_num=1),
                      precision=prec)
    mask = frame_of_land_mask(70, 52)
    rng = np.random.RandomState(3)
    mask[2:-2, 2:-2] |= (rng.rand(66, 48) < 0.15).astype(np.int32)
    grid = build_grid(basin, mask, precision=prec)
    state = init_ocean_state(grid, cfg)
    ref, ok = run_steps(jax.jit(make_step(grid, cfg)), state,
                        np.float32(1.0), 30)
    assert bool(ok)
    return grid, cfg, state, ref


@pytest.mark.parametrize("px,py", [(1, 2), (2, 2), (2, 4), (4, 2), (8, 1)])
def test_fused_2d_mesh_matches(case, px, py):
    grid, cfg, state, ref = case
    fm = FusedSharded2DModel(grid, cfg, 1.0, px, py)
    c = fm.pack(state)
    c, ok = fm.make_runner(30)(c)
    assert bool(ok)
    fields = fm.extract(c)
    pairs = [("ssh", fields[0], ref.ssh), ("sshp", fields[1], ref.sshp),
             ("u", fields[2], ref.ubrtr), ("up", fields[3], ref.ubrtrp),
             ("v", fields[4], ref.vbrtr), ("vp", fields[5], ref.vbrtrp),
             ("ff", fields[6], ref.ff[0]), ("ffp", fields[7], ref.ffp[0])]
    for name, a, b in pairs:
        a, b = np.asarray(a), np.asarray(b)
        rel = np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)
        assert rel < 1e-5, (name, rel)


def test_narrow_shard_rejected(case):
    grid, cfg, state, ref = case
    # 52 columns over 8 shards leave 7 per shard, under the 8-cell
    # margin of two chained steps per exchange
    with pytest.raises(ValueError, match="margin"):
        FusedSharded2DModel(grid, cfg, 1.0, 1, 8, steps_per_call=2)


@pytest.mark.parametrize("static_rslu,spc", [(False, 1), (True, 2)])
def test_fused_2d_mesh_variants(case, static_rslu, spc):
    """The non-static raw step and the chained 2-steps-per-exchange
    mode must match the jnp reference trajectory too."""
    grid, cfg, state, ref = case
    fm = FusedSharded2DModel(grid, cfg, 1.0, 2, 2,
                             static_rslu=static_rslu, steps_per_call=spc)
    c, ok = fm.make_runner(30)(fm.pack(state))
    assert bool(ok)
    fields = fm.extract(c)
    for name, a, b in [("ssh", fields[0], ref.ssh),
                       ("u", fields[2], ref.ubrtr),
                       ("ff", fields[6], ref.ff[0])]:
        a, b = np.asarray(a), np.asarray(b)
        rel = np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)
        assert rel < 1e-5, (name, rel)


def test_fused_2d_mesh_bipolar():
    """2D metric planes (bipolar curvilinear grid,
    grid_parameters.f90:183) on the sharded fused path."""
    basin = basinpar_flat(70, 52, curve_grid=2, rlon=27.5, rlat=41.0)
    prec = Precision.f32()
    cfg = ModelConfig(basin=basin, precision=prec)
    mask = frame_of_land_mask(70, 52)
    rng = np.random.RandomState(5)
    mask[2:-2, 2:-2] |= (rng.rand(66, 48) < 0.15).astype(np.int32)
    grid = build_grid(basin, mask, precision=prec)
    state = init_ocean_state(grid, cfg)
    ref, ok = run_steps(jax.jit(make_step(grid, cfg)), state,
                        np.float32(1.0), 30)
    assert bool(ok)
    fm = FusedSharded2DModel(grid, cfg, 1.0, 2, 2)
    assert fm.metrics_2d
    c, ok2 = fm.make_runner(30)(fm.pack(state))
    assert bool(ok2)
    fields = fm.extract(c)
    for name, a, b in [("ssh", fields[0], ref.ssh),
                       ("u", fields[2], ref.ubrtr),
                       ("v", fields[4], ref.vbrtr)]:
        a, b = np.asarray(a), np.asarray(b)
        rel = np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)
        assert rel < 2e-5, (name, rel)


def test_fused_2d_mesh_weighted_cuts(case):
    """Weighted (equal-wet) cut lines in BOTH axes must reproduce the
    reference trajectory exactly like the uniform split — the applied
    form of the reference's 2D weighted block assignment
    (decomposition.f90:532-669)."""
    grid, cfg, state, ref = case
    fm = FusedSharded2DModel(grid, cfg, 1.0, 4, 2,
                             weighted=True)
    assert fm.weighted_x and fm.weighted_y
    assert int(fm.x_edges[-1]) == grid.nx     # cuts span exactly [0, nx)
    assert int(fm.y_edges[-1]) == grid.ny
    # weighted y cuts actually moved (the test mask is y-asymmetric)
    uniform_y = np.arange(3) * (-(-grid.ny // 2))
    assert not np.array_equal(np.asarray(fm.y_edges), uniform_y)
    c, ok = fm.make_runner(30)(fm.pack(state))
    assert bool(ok)
    fields = fm.extract(c)
    for name, a, b in [("ssh", fields[0], ref.ssh),
                       ("u", fields[2], ref.ubrtr),
                       ("ff", fields[6], ref.ff[0])]:
        a, b = np.asarray(a), np.asarray(b)
        rel = np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)
        assert rel < 1e-5, (name, rel)


def test_fused_sharded_collective_schedule(case):
    """The fused sharded step exchanges exactly the prognostic set —
    (6+2T) fields x 4 permutes (2 strips x 2 axes) per exchange, like
    the reference's per-step sync lists (sw_interface.f90:330-381) —
    and steps_per_call=2 halves the per-model-step collective count."""
    grid, cfg, state, _ = case
    for spc in (1, 2):
        fm = FusedSharded2DModel(grid, cfg, 1.0, 2, 2, steps_per_call=spc)
        runner = fm.make_runner(8)
        txt = jax.jit(lambda c: runner(c)).lower(fm.pack(state)).as_text()
        i = txt.find("stablehlo.while")
        assert i > 0
        body = txt[i:].count("collective_permute")
        assert body == (6 + 2 * fm.n_tracers) * 4, (spc, body)
        # spc=2: the same per-iteration exchange advances TWO model
        # steps (scan length halves), so collectives per step halve


@pytest.mark.parametrize("px,py", [(2, 2), (1, 2)])
def test_fused_2d_mesh_periodic_x(px, py):
    """Periodic-x channel on the sharded fused path: the margin exchange
    wraps around the seam (ppermute wrap pair / local concatenate)."""
    import dataclasses
    basin = dataclasses.replace(basinpar_flat(64, 48), periodicity_x=1)
    prec = Precision.f32()
    cfg = ModelConfig(basin=basin, precision=prec)
    mask = np.zeros((64, 48), np.int32)
    mask[:, :2] = 1
    mask[:, -2:] = 1   # walls in y only; open (periodic) in x
    grid = build_grid(basin, mask, precision=prec)
    state = init_ocean_state(grid, cfg)
    ref, ok = run_steps(jax.jit(make_step(grid, cfg)), state,
                        np.float32(1.0), 40)
    assert bool(ok)
    fm = FusedSharded2DModel(grid, cfg, 1.0, px, py)
    c, ok2 = fm.make_runner(40)(fm.pack(state))
    assert bool(ok2)
    fields = fm.extract(c)
    for name, a, b in [("ssh", fields[0], ref.ssh),
                       ("u", fields[2], ref.ubrtr),
                       ("v", fields[4], ref.vbrtr)]:
        a, b = np.asarray(a), np.asarray(b)
        rel = np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)
        assert rel < 1e-5, (name, rel)


def test_fused_2d_mesh_viscosity(case):
    """Nonzero constant mu drives the fused stress/uv_diff2 branch on the
    sharded path (vel_ssh.f90:375-452; wired from the state's mu by
    OceanModel.state_mu_const)."""
    import dataclasses
    grid, cfg, state, _ = case
    MU = 1000.0
    state = dataclasses.replace(state, mu=jax.numpy.full_like(state.mu, MU))
    ref, ok = run_steps(jax.jit(make_step(grid, cfg)), state,
                        np.float32(1.0), 30)
    assert bool(ok)
    fm = FusedSharded2DModel(grid, cfg, 1.0, 2, 2,
                             mu_const=MU)
    c, ok2 = fm.make_runner(30)(fm.pack(state))
    assert bool(ok2)
    fields = fm.extract(c)
    for name, a, b in [("ssh", fields[0], ref.ssh),
                       ("u", fields[2], ref.ubrtr),
                       ("v", fields[4], ref.vbrtr)]:
        a, b = np.asarray(a), np.asarray(b)
        rel = np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)
        assert rel < 2e-5, (name, rel)


def test_fused_2d_mesh_file_cuts(case):
    """Explicit cut lines (parallel.par mod_decomposition=2: cuts read
    back from a decomposition.txt dump) reproduce the reference
    trajectory — including unequal band widths, which exercise the
    dynamic-offset margin strips."""
    grid, cfg, state, ref = case
    xe = np.array([0, 24, 40, 70], np.int64)       # unequal on purpose
    ye = np.array([0, 30, 52], np.int64)
    fm = FusedSharded2DModel(grid, cfg, 1.0, 3, 2,
                             x_edges=xe, y_edges=ye)
    assert fm.weighted_x and fm.weighted_y         # dynamic margins
    np.testing.assert_array_equal(np.asarray(fm.x_edges), xe)
    np.testing.assert_array_equal(np.asarray(fm.y_edges), ye)
    c, ok = fm.make_runner(30)(fm.pack(state))
    assert bool(ok)
    fields = fm.extract(c)
    for name, a, b in [("ssh", fields[0], ref.ssh),
                       ("u", fields[2], ref.ubrtr),
                       ("ff", fields[6], ref.ff[0])]:
        a, b = np.asarray(a), np.asarray(b)
        rel = np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)
        assert rel < 1e-5, (name, rel)


def test_fused_2d_mesh_bipolar_fast2d_chained():
    """fast2d on the sharded driver with chained steps + share_prev:
    margin exchange every 2 model steps, pruned metric-plane streaming,
    reductions at defaults."""
    basin = basinpar_flat(70, 52, curve_grid=2, rlon=27.5, rlat=41.0)
    prec = Precision.f32()
    cfg = ModelConfig(basin=basin, precision=prec)
    mask = frame_of_land_mask(70, 52)
    rng = np.random.RandomState(5)
    mask[2:-2, 2:-2] |= (rng.rand(66, 48) < 0.15).astype(np.int32)
    grid = build_grid(basin, mask, precision=prec)
    state = init_ocean_state(grid, cfg)
    ref, ok = run_steps(jax.jit(make_step(grid, cfg)), state,
                        np.float32(1.0), 30)
    assert bool(ok)
    fm = FusedSharded2DModel(grid, cfg, 1.0, 2, 2,
                             steps_per_call=2, share_prev=True)
    assert fm.fast2d and fm.elide_sel and fm.q4
    c, ok2 = fm.make_runner(30)(fm.pack(state))
    assert bool(ok2)
    fields = fm.extract(c)
    for name, a, b in [("ssh", fields[0], ref.ssh),
                       ("u", fields[2], ref.ubrtr),
                       ("v", fields[4], ref.vbrtr)]:
        a, b = np.asarray(a), np.asarray(b)
        rel = np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)
        assert rel < 2e-5, (name, rel)
