"""The fused whole-step update (ops/fused_step.py) vs the general jnp
composition; chip_smoke.py repeats the comparison on the GPU at the
production extent."""

import dataclasses

import jax
import numpy as np
import pytest

from ocean_model_arch_tpu.config import (ModelConfig, Precision, SWConfig,
                                         basinpar_flat)
from ocean_model_arch_tpu.core.grid import build_grid
from ocean_model_arch_tpu.core.masks import frame_of_land_mask
from ocean_model_arch_tpu.model.fused import FusedSWModel, fused_available
from ocean_model_arch_tpu.model.init import init_ocean_state
from ocean_model_arch_tpu.model.step import make_step, run_steps
from ocean_model_arch_tpu.ops import fused_step as fsk


def _case(curve_grid, with_islands, nx=70, ny=52):
    basin = basinpar_flat(nx, ny, curve_grid=curve_grid,
                          rlon=27.5, rlat=41.0)
    prec = Precision.f32()
    cfg = ModelConfig(basin=basin, sw=SWConfig(use_tracers=0),
                      precision=prec)
    mask = frame_of_land_mask(nx, ny)
    if with_islands:
        rng = np.random.RandomState(3)
        mask[2:-2, 2:-2] |= (rng.rand(nx - 4, ny - 4) < 0.15).astype(np.int32)
    grid = build_grid(basin, mask, precision=prec)
    state = init_ocean_state(grid, cfg)
    return grid, cfg, state


@pytest.mark.parametrize("curve_grid,with_islands",
                         [(0, False), (1, True), (1, False),
                          (2, False), (2, True)])
def test_fused_matches_jnp(curve_grid, with_islands):
    """curve_grid=2 (bipolar) exercises the 2D-metrics kernel variant:
    metrics stream as full planes instead of latitude profiles."""
    grid, cfg, state = _case(curve_grid, with_islands)
    step = jax.jit(make_step(grid, cfg))
    ref, ok = run_steps(step, state, np.float32(1.0), 30)
    assert bool(ok)

    fm = FusedSWModel(grid, cfg, 1.0)
    s6 = fm.pack(state)
    s6, ok2 = jax.jit(lambda s: fm.run_steps(s, 30))(s6)
    assert bool(ok2)
    out = fm.unpack(s6, state)
    for name in ("ssh", "sshp", "ubrtr", "vbrtr", "ubrtrp", "vbrtrp",
                 "hhu", "hhv", "hhh", "hhq"):
        a = np.asarray(getattr(out, name))
        b = np.asarray(getattr(ref, name))
        scale = max(np.abs(b).max(), 1e-30)
        assert np.abs(a - b).max() / scale < 1e-5, name


@pytest.mark.parametrize("curve_grid,static_rslu",
                         [(1, False), (2, False), (1, True)])
def test_fused_tracers_match_jnp(curve_grid, static_rslu):
    basin = basinpar_flat(70, 52, curve_grid=curve_grid,
                          rlon=27.5, rlat=41.0)
    prec = Precision.f32()
    cfg = ModelConfig(basin=basin,
                      sw=SWConfig(use_tracers=1, tracer_num=2),
                      precision=prec)
    mask = frame_of_land_mask(70, 52)
    rng = np.random.RandomState(3)
    mask[2:-2, 2:-2] |= (rng.rand(66, 48) < 0.15).astype(np.int32)
    grid = build_grid(basin, mask, precision=prec)
    state = init_ocean_state(grid, cfg)
    ref, ok = run_steps(jax.jit(make_step(grid, cfg)), state,
                        np.float32(1.0), 30)
    assert bool(ok)
    fm = FusedSWModel(grid, cfg, 1.0,
                      static_rslu=static_rslu)
    s = fm.pack(state)
    s, ok2 = jax.jit(lambda c: fm.run_steps(c, 30))(s)
    assert bool(ok2)
    out = fm.unpack(s, state)
    for t in range(2):
        for name in ("ff", "ffp"):
            a = np.asarray(getattr(out, name)[t])
            b = np.asarray(getattr(ref, name)[t])
            # f32 round-off: the fused flux reassociates (a+b)(c)(-dyh/2)
            # for VPU strength reduction, ~1 ulp/step vs the jnp order
            rel = np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)
            assert rel < 1e-5, (name, t, rel)


@pytest.mark.parametrize("curve_grid,static_rslu",
                         [(1, False), (2, False), (1, True)])
def test_fused_viscosity_branch(curve_grid, static_rslu):
    """Constant nonzero mu exercises the fused stress/uv_diff2 branch
    (dead with the reference's zeroed mu); curve_grid=2 covers the
    2D-metrics shifts (dxb²mu at dn=-1 / dyb²mu at dm=-1); static_rslu
    covers the fast-mode static-mask/profile-ratio variant."""
    grid, cfg, state = _case(curve_grid, True)
    MU = 1000.0
    state = dataclasses.replace(
        state, mu=jax.numpy.full_like(state.mu, MU))
    ref, ok = run_steps(jax.jit(make_step(grid, cfg)), state,
                        np.float32(1.0), 30)
    assert bool(ok)
    fm = FusedSWModel(grid, cfg, 1.0, mu_const=MU,
                      static_rslu=static_rslu)
    s = fm.pack(state)
    s, ok2 = jax.jit(lambda c: fm.run_steps(c, 30))(s)
    assert bool(ok2)
    out = fm.unpack(s, state)
    for name in ("ssh", "ubrtr", "vbrtr"):
        a = np.asarray(getattr(out, name))
        b = np.asarray(getattr(ref, name))
        rel = np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)
        assert rel < 2e-5, (name, rel)


def test_fused_static_rslu_bitexact_2d():
    """With 2D metrics (bipolar) and fast2d OFF, the static planes only
    replace the interp reciprocal-count selects — results must be
    bit-identical to the in-kernel select chains."""
    grid, cfg, state = _case(2, True)
    fm = FusedSWModel(grid, cfg, 1.0)
    fs = FusedSWModel(grid, cfg, 1.0,
                      static_rslu=True, fast2d=False)
    a6, ok1 = jax.jit(lambda s: fm.run_steps(s, 20))(fm.pack(state))
    b6, ok2 = jax.jit(lambda s: fs.run_steps(s, 20))(fs.pack(state))
    assert bool(ok1) and bool(ok2)
    for a, b in zip(a6, b6):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("with_islands,tracers,mu",
                         [(False, 0, 0.0), (True, 0, 0.0),
                          (True, 2, 500.0)])
def test_fused_fast2d_matches_jnp(with_islands, tracers, mu):
    """fast2d: the fast-mode restructurings with pointwise 2D
    metric planes on a bipolar grid — the full production envelope
    (grid_parameters.f90:183-417) through the fast kernel, streaming
    only the config's consumed metric rows. Compared against the jnp
    composition at f32 round-off tolerance (reassociation), with the
    reductions at their fast-mode defaults."""
    basin = basinpar_flat(70, 52, curve_grid=2, rlon=27.5, rlat=41.0)
    prec = Precision.f32()
    cfg = ModelConfig(basin=basin,
                      sw=SWConfig(use_tracers=1 if tracers else 0,
                                  tracer_num=tracers or 1),
                      precision=prec)
    mask = frame_of_land_mask(70, 52)
    if with_islands:
        rng = np.random.RandomState(3)
        mask[2:-2, 2:-2] |= (rng.rand(66, 48) < 0.15).astype(np.int32)
    grid = build_grid(basin, mask, precision=prec)
    state = init_ocean_state(grid, cfg)
    if mu:
        state = dataclasses.replace(
            state, mu=jax.numpy.full_like(state.mu, mu))
    ref, ok = run_steps(jax.jit(make_step(grid, cfg)), state,
                        np.float32(1.0), 30)
    assert bool(ok)
    fs = FusedSWModel(grid, cfg, 1.0,
                      static_rslu=True, steps_per_call=2, mu_const=mu,
                      share_prev=True)
    assert fs.fast2d and fs.elide_sel and fs.q4
    s6, ok2 = jax.jit(lambda s: fs.run_steps(s, 30))(fs.pack(state))
    assert bool(ok2)
    out = fs.unpack(s6, state)
    names = ["ssh", "sshp", "ubrtr", "vbrtr", "ubrtrp", "vbrtrp"]
    for t in range(tracers):
        names += ["ff", "ffp"]
    for name in names:
        a = np.asarray(getattr(out, name))
        b = np.asarray(getattr(ref, name))
        rel = np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)
        assert rel < 2e-5, (name, rel)


@pytest.mark.parametrize("with_islands", [False, True])
def test_fused_fast_mode_matches_jnp(with_islands):
    """static_rslu + x-uniform metrics = the fast kernel (static mask
    planes, profile-restructured vorticity, folded 0.25s). FP order is
    intentionally reassociated, so compare against the jnp reference
    with an f32 round-off tolerance."""
    grid, cfg, state = _case(1, with_islands)
    ref, ok = run_steps(jax.jit(make_step(grid, cfg)), state,
                        np.float32(1.0), 30)
    assert bool(ok)
    fs = FusedSWModel(grid, cfg, 1.0,
                      static_rslu=True)
    s6, ok2 = jax.jit(lambda s: fs.run_steps(s, 30))(fs.pack(state))
    assert bool(ok2)
    out = fs.unpack(s6, state)
    for name in ("ssh", "sshp", "ubrtr", "vbrtr", "ubrtrp", "vbrtrp",
                 "hhu", "hhv", "hhh", "hhq"):
        a = np.asarray(getattr(out, name))
        b = np.asarray(getattr(ref, name))
        scale = max(np.abs(b).max(), 1e-30)
        assert np.abs(a - b).max() / scale < 1e-5, name


def test_fused_varying_bathymetry_matches_jnp():
    """Non-flat hhq_rest keeps the hrludxdy static plane (flat
    bathymetry folds it into a scalar — verify BOTH branches against
    the jnp path)."""
    nx, ny = 70, 52
    basin = basinpar_flat(nx, ny, curve_grid=1, rlon=27.5, rlat=41.0)
    prec = Precision.f32()
    cfg = ModelConfig(basin=basin, sw=SWConfig(use_tracers=1,
                                               tracer_num=1),
                      precision=prec)
    mask = frame_of_land_mask(nx, ny)
    rng = np.random.RandomState(11)
    hr = 100.0 + 40.0 * rng.rand(nx, ny).astype(np.float32)
    grid = build_grid(basin, mask, hhq_rest=hr, precision=prec)
    state = init_ocean_state(grid, cfg)
    ref, ok = run_steps(jax.jit(make_step(grid, cfg)), state,
                        np.float32(1.0), 30)
    assert bool(ok)
    fs = FusedSWModel(grid, cfg, 1.0,
                      static_rslu=True, steps_per_call=2)
    assert fs.hr_const is None      # plane branch in force
    s6, ok2 = jax.jit(lambda s: fs.run_steps(s, 30))(fs.pack(state))
    assert bool(ok2)
    out = fs.unpack(s6, state)
    for name in ("ssh", "ubrtr", "vbrtr", "ff"):
        a = np.asarray(getattr(out, name))
        b = np.asarray(getattr(ref, name))
        scale = max(np.abs(b).max(), 1e-30)
        assert np.abs(a - b).max() / scale < 1e-5, name
    # flat bathymetry takes the folded-scalar branch on the same config
    grid_f = build_grid(basin, mask, precision=prec)
    assert FusedSWModel(grid_f, cfg, 1.0,
                        static_rslu=True).hr_const == 100.0


def test_fused_availability_checks():
    grid, cfg, state = _case(1, False)
    assert fused_available(grid)
    # periodic -> unsupported
    grid_p = dataclasses.replace(grid, periodic_x=True)
    assert not fused_available(grid_p)
    # bipolar (x-varying metrics) -> supported via the 2D-metrics variant
    basin2 = basinpar_flat(40, 36, curve_grid=2)
    grid2 = build_grid(basin2, frame_of_land_mask(40, 36),
                      precision=Precision.f32())
    assert fused_available(grid2)
    fm = FusedSWModel(grid2, cfg, 1.0)
    assert fm.metrics_2d
    # the sharded fused driver covers the full envelope: bipolar (2D
    # metric planes) and divisible periodic axes are supported; periodic
    # with padding between seam neighbours is not
    assert fused_available(grid, sharded=True)
    assert fused_available(grid2, sharded=True)
    assert fused_available(grid_p, sharded=True, px=7, py=1)  # 70 = 7*10
    assert not fused_available(grid_p, sharded=True, px=4, py=1)


def test_fused_guard_trips():
    grid, cfg, state = _case(1, False)
    fm = FusedSWModel(grid, cfg, 1.0)
    bad = dataclasses.replace(state,
                              sshp=state.sshp.at[30, 30].set(2.0e4))
    s6 = fm.pack(bad)
    _, ok = fm.run_steps(s6, 1)
    assert not bool(ok)


def test_fused_guard_catches_mid_window_transient():
    """The guard accumulates the kernel's per-step |ssh| max through the
    scan carry (check_ssh_err cadence, vel_ssh.f90:40-67): an sshp spike
    blows past the bound in the first few steps, then the Robert-Asselin
    filter + gravity-wave spreading damp it BELOW the bound by the end
    of the window — a final-state-only check would miss it."""
    grid, cfg, state = _case(1, False)
    bad = dataclasses.replace(state,
                              sshp=state.sshp.at[30, 30].set(1.2e4))
    fm = FusedSWModel(grid, cfg, 1.0,
                      static_rslu=True, steps_per_call=2)
    s6, ok = fm.run_steps(fm.pack(bad), 30)
    final = np.abs(np.asarray(fm.unpack(s6, state).ssh)).max()
    assert final < 1.0e4, "not a transient: final state still blown up"
    assert not bool(ok), "per-step guard missed the mid-window transient"

    # same through the 2D-sharded driver (per-shard kernel maxes psum'd)
    from ocean_model_arch_tpu.model.fused_sharded2d import (
        FusedSharded2DModel)
    fs = FusedSharded2DModel(grid, cfg, 1.0, 2, 2,
                             steps_per_call=2)
    _, ok2 = fs.make_runner(30)(fs.pack(bad))
    assert not bool(ok2)
    good, ok3 = fs.make_runner(30)(fs.pack(state))
    assert bool(ok3), "guard tripped on a healthy run"


@pytest.mark.parametrize("static_rslu,tracers",
                         [(True, 0), (False, 0), (True, 2)])
def test_fused_two_steps_per_call_bitexact(static_rslu, tracers):
    """steps_per_call=2 chains two whole model steps inside one kernel
    invocation (step A at halo 4, step B at halo 0). The per-step reach
    is <= 4 and the output-stage selects restore exact zeros on land, so
    the chained results match two 1-step calls to within XLA's FMA
    contraction (+-1 ulp on isolated elements)."""
    basin = basinpar_flat(70, 52, curve_grid=1, rlon=27.5, rlat=41.0)
    prec = Precision.f32()
    cfg = ModelConfig(basin=basin,
                      sw=SWConfig(use_tracers=1 if tracers else 0,
                                  tracer_num=tracers),
                      precision=prec)
    mask = frame_of_land_mask(70, 52)
    rng = np.random.RandomState(5)
    mask[2:-2, 2:-2] |= (rng.rand(66, 48) < 0.15).astype(np.int32)
    grid = build_grid(basin, mask, precision=prec)
    state = init_ocean_state(grid, cfg)

    f1 = FusedSWModel(grid, cfg, 1.0,
                      static_rslu=static_rslu, steps_per_call=1)
    f2 = FusedSWModel(grid, cfg, 1.0,
                      static_rslu=static_rslu, steps_per_call=2)
    a, ok1 = f1.run_steps(f1.pack(state), 20)
    b, ok2 = f2.run_steps(f2.pack(state), 20)
    assert bool(ok1) and bool(ok2)
    for x, y in zip(a, b):
        # chaining is algebraically exact; the few-ulp slack absorbs
        # XLA's FMA contraction differing between the two graph shapes
        # (the chained layout has the wider margin: compare the domain)
        np.testing.assert_allclose(np.asarray(fsk.extract(f1.lay, x)),
                                   np.asarray(fsk.extract(f2.lay, y)),
                                   rtol=1e-6, atol=1e-11)


def test_round5_reductions_bitexact():
    """elide_sel (redundant land selects dropped) and q4 (advection 1/4
    folded into the rslu_u/v planes — power-of-two scale) are exact in
    real arithmetic; the only observed deviation is XLA FMA-contraction
    re-fusing around the removed ops (~1 ulp/step). Land cells must stay
    EXACTLY zero (the grounding invariant the elision relies on)."""
    grid, cfg, state = _case(1, True)
    ctl = FusedSWModel(grid, cfg, 1.0,
                       static_rslu=True, steps_per_call=2,
                       elide_sel=False, q4=False)
    opt = FusedSWModel(grid, cfg, 1.0,
                       static_rslu=True, steps_per_call=2)
    assert opt.elide_sel and opt.q4       # fast-mode defaults
    a6, ok1 = jax.jit(lambda s: ctl.run_steps(s, 30))(ctl.pack(state))
    b6, ok2 = jax.jit(lambda s: opt.run_steps(s, 30))(opt.pack(state))
    assert bool(ok1) and bool(ok2)
    _assert_ulp_close(ctl, a6, opt, b6)


def _assert_ulp_close(ctl, a6, opt, b6, rel=1e-6):
    """Interior cells within FMA-contraction round-off; land cells (and
    every interior land zero) bit-exact zeros in the reduced kernel."""
    lay = opt.lay
    lu = np.asarray(opt.grid.lu) > 0.5
    for a, b in zip(a6, b6):
        ai = np.asarray(a)[lay.margin:lay.margin + lay.nx,
                           lay.ypad:lay.ypad + lay.ny]
        bi = np.asarray(b)[lay.margin:lay.margin + lay.nx,
                           lay.ypad:lay.ypad + lay.ny]
        scale = max(np.abs(ai).max(), 1e-30)
        assert np.abs(ai - bi).max() / scale < rel
        # the elided-select invariant: land stays exactly zero for the
        # velocity/tracer carriers (b6[0:2] are ssh/sshp, which keep
        # their selects and the reference's land values)
    for b in b6[2:]:
        bi = np.asarray(b)[lay.margin:lay.margin + lay.nx,
                           lay.ypad:lay.ypad + lay.ny]
        assert np.all(bi[~lu] == 0.0)


def test_round5_reductions_bitexact_tracers_visc():
    """Same exactness contract with the tracer + viscosity branches on
    (their q4 compensations and elided tracer selects)."""
    basin = basinpar_flat(70, 52, curve_grid=1, rlon=27.5, rlat=41.0)
    prec = Precision.f32()
    cfg = ModelConfig(basin=basin,
                      sw=SWConfig(use_tracers=1, tracer_num=2),
                      precision=prec)
    mask = frame_of_land_mask(70, 52)
    rng = np.random.RandomState(3)
    mask[2:-2, 2:-2] |= (rng.rand(66, 48) < 0.15).astype(np.int32)
    grid = build_grid(basin, mask, precision=prec)
    state = init_ocean_state(grid, cfg)
    MU = 500.0
    state = dataclasses.replace(
        state, mu=jax.numpy.full_like(state.mu, MU))
    ctl = FusedSWModel(grid, cfg, 1.0, mu_const=MU,
                       static_rslu=True, steps_per_call=2,
                       elide_sel=False, q4=False)
    opt = FusedSWModel(grid, cfg, 1.0, mu_const=MU,
                       static_rslu=True, steps_per_call=2)
    a6, ok1 = jax.jit(lambda s: ctl.run_steps(s, 30))(ctl.pack(state))
    b6, ok2 = jax.jit(lambda s: opt.run_steps(s, 30))(opt.pack(state))
    assert bool(ok1) and bool(ok2)
    _assert_ulp_close(ctl, a6, opt, b6)


def test_round5_share_prev_tolerance():
    """share_prev regroups step B's prev-depth interps through the
    filter identity (exact in real arithmetic) — f32 round-off only."""
    grid, cfg, state = _case(1, True)
    ctl = FusedSWModel(grid, cfg, 1.0,
                       static_rslu=True, steps_per_call=2,
                       share_prev=False)
    opt = FusedSWModel(grid, cfg, 1.0,
                       static_rslu=True, steps_per_call=2,
                       share_prev=True)
    a6, ok1 = jax.jit(lambda s: ctl.run_steps(s, 30))(ctl.pack(state))
    b6, ok2 = jax.jit(lambda s: opt.run_steps(s, 30))(opt.pack(state))
    assert bool(ok1) and bool(ok2)
    _assert_ulp_close(ctl, a6, opt, b6, rel=1e-5)


@pytest.mark.parametrize("nx,ny", [(37, 29), (131, 23), (45, 133)])
def test_fused_odd_extents_match_jnp(nx, ny):
    """Extents that are no multiple of any tile or lane width: the fused
    layout pads nothing beyond its land margins, so prime-ish and
    lopsided grids must track the composition like the 70x52 cases."""
    basin = basinpar_flat(nx, ny, curve_grid=1, rlon=27.5, rlat=41.0)
    prec = Precision.f32()
    cfg = ModelConfig(basin=basin, sw=SWConfig(use_tracers=1, tracer_num=1),
                      precision=prec)
    mask = frame_of_land_mask(nx, ny)
    rng = np.random.RandomState(nx + ny)
    mask[2:-2, 2:-2] |= (rng.rand(nx - 4, ny - 4) < 0.15).astype(np.int32)
    grid = build_grid(basin, mask, precision=prec)
    state = init_ocean_state(grid, cfg)
    ref, ok = run_steps(jax.jit(make_step(grid, cfg)), state,
                        np.float32(1.0), 20)
    assert bool(ok)
    fm = FusedSWModel(grid, cfg, 1.0, static_rslu=True, steps_per_call=2)
    assert (fm.lay.Xs, fm.lay.Ys) == (nx + 16, ny + 4)
    s6, ok2 = jax.jit(lambda s: fm.run_steps(s, 20))(fm.pack(state))
    assert bool(ok2)
    out = fm.unpack(s6, state)
    for name in ("ssh", "ubrtr", "vbrtr", "ff"):
        a = np.asarray(getattr(out, name))
        b = np.asarray(getattr(ref, name))
        rel = np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)
        assert rel < 1e-5, (name, rel)


def _custom_calls(hlo_text):
    """Names of the custom calls in a lowered module (a Pallas/Mosaic
    kernel lowers to one)."""
    import re
    return re.findall(r"custom_call_target\s*=\s*\"([^\"]+)\"", hlo_text) \
        + re.findall(r"stablehlo\.custom_call\s+@([\w.]+)", hlo_text)


def test_fused_step_lowers_without_custom_calls():
    """The single-device fused step is plain XLA: lowered for the GPU,
    its module holds no Mosaic or tpu_custom_call kernel."""
    grid, cfg, state = _case(1, True)
    fm = FusedSWModel(grid, cfg, 1.0, static_rslu=True, steps_per_call=2)
    txt = jax.jit(lambda s: fm.run_steps(s, 4)).trace(
        fm.pack(state)).lower(lowering_platforms=("cuda",)).as_text()
    assert "while" in txt            # the scan is there ...
    calls = _custom_calls(txt)
    assert not [c for c in calls if "tpu" in c.lower()
                or "mosaic" in c.lower()], calls


def test_fused_sharded_step_lowers_without_custom_calls():
    """Same for the fused-sharded driver on a 2x2 mesh."""
    from ocean_model_arch_tpu.model.fused_sharded2d import (
        FusedSharded2DModel)
    grid, cfg, state = _case(1, True)
    fs = FusedSharded2DModel(grid, cfg, 1.0, 2, 2, steps_per_call=2)
    txt = fs.make_runner(4).trace(fs.pack(state)).lower(
        lowering_platforms=("cuda",)).as_text()
    assert "collective_permute" in txt
    calls = _custom_calls(txt)
    assert not [c for c in calls if "tpu" in c.lower()
                or "mosaic" in c.lower()], calls
