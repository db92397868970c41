"""Golden-trajectory regression anchor.

tests/golden_bs100.json holds committed digests of a 100-step f64 Black
Sea run (scripts/make_golden_bs.py). Asserting against the committed
file — not a freshly computed oracle — catches silent physics drift from
jax/XLA upgrades or fused-step optimization that paired
same-version comparisons cannot see. This is the regression analog of
the reference's sync_test discipline (syncborder_block2D_gen_test.fi):
an exact, decomposition-independent anchor.
"""

import json
import os

import jax
import numpy as np

from ocean_model_arch_tpu.config import (ModelConfig, Precision, SWConfig,
                                         basinpar_bs4km)
from ocean_model_arch_tpu.core.grid import build_grid
from ocean_model_arch_tpu.io.mask_io import read_mask
from ocean_model_arch_tpu.model.init import init_ocean_state
from ocean_model_arch_tpu.model.step import make_step, run_steps

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

with open(os.path.join(REPO, "tests", "golden_bs100.json")) as f:
    GOLDEN = json.load(f)
POINTS = [tuple(p) for p in GOLDEN["points"]]


def _digests(a):
    a = np.asarray(a, np.float64)
    return {"sum": float(a.sum()),
            "l2": float(np.sqrt((a * a).sum())),
            "absmax": float(np.abs(a).max()),
            "points": [float(a[i, j]) for (i, j) in POINTS]}


def _build(precision):
    basin = basinpar_bs4km()
    cfg = ModelConfig(basin=basin,
                      sw=SWConfig(use_tracers=1, tracer_num=1),
                      precision=precision)
    mask = read_mask(os.path.join(REPO, basin.mask_file_name),
                     basin.nx, basin.ny)
    grid = build_grid(basin, mask, precision=cfg.precision)
    return grid, cfg, init_ocean_state(grid, cfg)


def _check(state, step_key, rtol, pt_atol):
    got = {"ssh": _digests(state.ssh), "u": _digests(state.ubrtr),
           "v": _digests(state.vbrtr), "tracer": _digests(state.ff[0])}
    want = GOLDEN["steps"][step_key]
    for fld in got:
        for k in ("sum", "l2", "absmax"):
            np.testing.assert_allclose(
                got[fld][k], want[fld][k], rtol=rtol,
                err_msg=f"step {step_key} {fld}.{k} drifted")
        np.testing.assert_allclose(
            got[fld]["points"], want[fld]["points"], rtol=rtol,
            atol=pt_atol, err_msg=f"step {step_key} {fld}.points drifted")


def test_golden_bs100_f64_jnp():
    """The f64 jnp path must reproduce the committed digests to near
    machine precision (reduction-order slack only)."""
    grid, cfg, state = _build(Precision.f64())
    step = jax.jit(make_step(grid, cfg))
    done = 0
    for s in sorted(GOLDEN["steps"], key=int):
        state, ok = run_steps(step, state, 1.0, int(s) - done)
        done = int(s)
        assert bool(ok)
        _check(state, s, rtol=1e-9, pt_atol=1e-12)


def test_golden_bs100_f32_fused():
    """The fused step (f32) must track the f64 golden within f32
    accumulation error — anchoring the production path to committed
    physics, not just to same-build comparisons."""
    from ocean_model_arch_tpu.model.fused import FusedSWModel

    grid, cfg, state = _build(Precision.f32())
    fm = FusedSWModel(grid, cfg, 1.0,
                      static_rslu=True, steps_per_call=2)
    s6 = fm.pack(state)
    done = 0
    for s in sorted(GOLDEN["steps"], key=int):
        s6, ok = fm.run_steps(s6, int(s) - done)
        done = int(s)
        assert bool(ok)
        _check(fm.unpack(s6, state), s, rtol=3e-4, pt_atol=5e-6)


def test_validation_bundle_consistent():
    """The committed 10k-step A/B bundle is internally consistent: the
    RESULTS_TPU records match the digests in tests/golden_bs10k.json
    (guards against either half being regenerated without the other —
    the bundle is the committed side of the BASELINE Fortran gate)."""
    import json
    import os

    import numpy as np

    from ocean_model_arch_tpu.io import grads

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(repo, "tests", "golden_bs10k.json")) as f:
        g = json.load(f)
    d = os.path.join(repo, "examples", "validation_bs10k", "RESULTS_TPU")
    pts = [tuple(p) for p in g["points"]]
    for name, recs in (("ssh", 11), ("hhq", 1), ("ff1", 11)):
        path = os.path.join(d, f"{name}.dat")
        for r in range(1, recs + 1):
            a = np.asarray(grads.read_record(path, r, 289, 163),
                           np.float64)
            want = g["records"][name][r - 1]
            assert abs(a.sum() - want["sum"]) <= 1e-9 * max(
                1.0, abs(want["sum"])), (name, r)
            got_l2 = float(np.sqrt((a * a).sum()))
            assert abs(got_l2 - want["l2"]) <= 1e-9 * max(
                1.0, want["l2"]), (name, r)
            for (i, j), v in zip(pts, want["points"]):
                assert a[i, j] == v, (name, r, i, j)
