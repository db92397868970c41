"""Smoke test of the model on one GPU: ``python3 chip_smoke.py [--four]``.

One process owns the card. Phases, each printing its results on its own
lines:

0. the card (``nvidia-smi`` name and power limit), the JAX version and
   ``XLA_FLAGS``; exits non-zero unless JAX's first device is a GPU.
1. the CLI main path, in process, on ``examples/05_azov_hires`` (Azov
   Sea 250 m, 1525x1115, 605 steps, output every 60) in f32: the
   printed compute path is the rule's, every ``ssh`` record is written,
   wet values are finite with |ssh| < 1 m, and ``wet_points_per_sec`` is
   printed.
2. at 1525x1115 f32, the fused step against the jnp composition over
   100 steps: max|a-b|/max|b| for ssh, u and v, both step times and
   compile times. It passes at < 1e-5; where f32 round-off alone
   separates the two orderings by more, it passes only if both stay
   equally close to the f64 composition (see judge), which is checked
   once 64-bit types are on.
3. the Black Sea 100-step golden (tests/golden_bs100.json): the fused
   step in f32 (rtol 3e-4, point atol 5e-6), then the composition in f64
   (rtol 1e-9); then the Azov CLI run of phase 1 in the f64 default.

``--four`` runs only the four-card check: Azov 05 on a 2x2 mesh, the
fused-sharded driver with weighted cuts (mod_decomposition=1) and the
jnp-sharded step, 120 steps each, each against the single-card run of
its own arithmetic, judged as phase 2 is.

Any failure raises, so the process exits non-zero without the last line.
The last line is one JSON object naming the device.
"""

import argparse
import contextlib
import dataclasses
import io
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

import jax  # noqa: E402

from ocean_model_arch_tpu.config import Precision  # noqa: E402
from ocean_model_arch_tpu.diag.scaling import time_stepper  # noqa: E402
from ocean_model_arch_tpu.io import grads  # noqa: E402
from ocean_model_arch_tpu.model.fused import FusedSWModel  # noqa: E402
from ocean_model_arch_tpu.model.init import init_ocean_state  # noqa: E402
from ocean_model_arch_tpu.model.model import (  # noqa: E402
    OceanModel, load_config_dir)
from ocean_model_arch_tpu.model.step import make_step, run_steps  # noqa

AZOV = os.path.join(REPO, "examples", "05_azov_hires")
REL_TOL = 1e-5          # fused vs composition, f32 (tests/test_fused.py)
FIELDS = (("ssh", "ssh"), ("u", "ubrtr"), ("v", "vbrtr"))


def rel_err(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def compile_timed(fn, *args):
    """(compiled fn, seconds to lower + compile)."""
    t0 = time.perf_counter()
    c = jax.jit(fn).lower(*args).compile()
    return c, time.perf_counter() - t0


def phase0(n_cards: int):
    dev = jax.devices()[0]
    print(f"PHASE 0: jax {jax.__version__}, "
          f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}, "
          f"platform {dev.platform}, {len(jax.devices())} device(s)")
    if dev.platform != "gpu":
        print(f"PHASE 0: FAILED: no GPU (JAX platform {dev.platform})")
        sys.exit(1)
    if len(jax.devices()) < n_cards:
        print(f"PHASE 0: FAILED: {n_cards} GPUs needed, "
              f"{len(jax.devices())} found")
        sys.exit(1)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    print(smi.strip().splitlines()[0])
    return dev


def cli_run(f32: bool, results: str) -> str:
    """``python -m ocean_model_arch_tpu examples/05_azov_hires`` in
    process; returns its standard output."""
    from ocean_model_arch_tpu.__main__ import main
    argv = [AZOV, "--results", results] + (["--f32"] if f32 else [])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    check(rc == 0, f"CLI exit code {rc}")
    return buf.getvalue()


def check_cli_output(out: str, results: str, expected_path: str,
                     tag: str) -> None:
    cfg = load_config_dir(AZOV)
    nx, ny = cfg.basin.nx, cfg.basin.ny
    lines = out.splitlines()
    path_lines = [ln for ln in lines if "compute path:" in ln]
    check(len(path_lines) == 1, f"{tag}: no compute path printed")
    got = path_lines[0].split("compute path:")[1].strip()
    check(got == expected_path,
          f"{tag}: compute path {got!r}, rule says {expected_path!r}")
    last = [ln for ln in lines if ln.startswith("MODEL: step ")][-1]
    n_total = cfg.run.num_step_max
    check(last.split()[2] == f"{n_total}/{n_total}",
          f"{tag}: run ended at {last!r}")
    rate = [ln for ln in lines if "wet_points_per_sec" in ln]
    check(bool(rate), f"{tag}: wet_points_per_sec not printed")
    n_out = cfg.run.output_every_steps
    n_rec = 1 + -(-n_total // n_out)
    ssh_path = os.path.join(results, "ssh.dat")
    size = os.path.getsize(ssh_path)
    check(size == n_rec * (nx - 4) * (ny - 4) * 4,
          f"{tag}: ssh.dat holds {size} bytes, not {n_rec} records")
    from ocean_model_arch_tpu.io.mask_io import load_mask
    wet = np.asarray(load_mask(cfg.basin.mask_file_name, nx, ny,
                               AZOV)) == 0
    peak = 0.0
    for k in range(1, n_rec + 1):
        rec = grads.read_record(ssh_path, k, nx, ny)[wet]
        check(bool(np.isfinite(rec).all()), f"{tag}: record {k} not finite")
        peak = max(peak, float(np.abs(rec).max()))
    check(peak < 1.0, f"{tag}: |ssh| reached {peak} m")
    print(f"{tag}: compute path: {got}; {last.strip()}; "
          f"{n_rec} ssh records, wet max|ssh| {peak:.6g} m; "
          f"{rate[0].strip()}")


def expected_path(f32: bool) -> str:
    cfg = load_config_dir(AZOV)
    if f32:
        cfg = dataclasses.replace(cfg, precision=Precision.f32())
    return OceanModel(cfg, base_dir=AZOV,
                      results_dir=tempfile.mkdtemp()).path


def phase1(tmp: str, f32: bool) -> None:
    tag = "PHASE 1" if f32 else "PHASE 3 (f64 CLI)"
    results = os.path.join(tmp, "f32" if f32 else "f64")
    want = expected_path(f32)
    t0 = time.perf_counter()
    out = cli_run(f32, results)
    print(f"{tag}: CLI run {time.perf_counter() - t0:.1f} s "
          "(compilation included)")
    check_cli_output(out, results, want, tag)


def azov_f32():
    """Grid, config and initial state of examples/05_azov_hires in f32."""
    cfg = load_config_dir(AZOV)
    cfg = dataclasses.replace(cfg, precision=Precision.f32())
    om = OceanModel(cfg, base_dir=AZOV, results_dir=tempfile.mkdtemp())
    return om.grid, cfg, om.state


def phase2(n: int = 100) -> None:
    grid, cfg, state = azov_f32()
    tau = cfg.run.tau
    step = make_step(grid, cfg)
    comp, c_comp = compile_timed(
        lambda st: run_steps(step, st, tau, n), state)
    fm = FusedSWModel(grid, cfg, tau, static_rslu=True, steps_per_call=2)

    def fused_run(st):
        s6, ok = fm.run_steps(fm.pack(st), n)
        return fm.unpack(s6, st), ok

    fused, c_fused = compile_timed(fused_run, state)
    a, ok_a = fused(state)
    b, ok_b = comp(state)
    check(bool(ok_a) and bool(ok_b), "PHASE 2: stability guard tripped")
    errs = {k: rel_err(getattr(a, f), getattr(b, f)) for k, f in FIELDS}
    host = {k: (np.asarray(getattr(a, f)), np.asarray(getattr(b, f)))
            for k, f in FIELDS}
    t_comp = time_stepper(comp, b, n)
    t_fused = time_stepper(fused, a, n)
    print(f"PHASE 2: {grid.nx}x{grid.ny} f32, {n} steps: fused vs "
          "composition max|a-b|/max|b| "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + f" (limit {REL_TOL:g})")
    print(f"PHASE 2: step time composition {t_comp * 1e3:.4f} ms, "
          f"fused {t_fused * 1e3:.4f} ms; compile composition "
          f"{c_comp:.1f} s, fused {c_fused:.1f} s")
    return host


def judge(tag: str, host: dict, n: int) -> None:
    """Pass each field whose candidate is within REL_TOL of its f32
    reference; where f32 round-off alone separates the two orderings by
    more, require the candidate to stay as close to the f64 composition
    as the reference does (at most 1.25x its error). ``host``: field ->
    (candidate, f32 reference) host arrays after ``n`` Azov steps."""
    errs = {k: rel_err(c, r) for k, (c, r) in host.items()}
    if all(v < REL_TOL for v in errs.values()):
        print(f"{tag}: passed at the 1e-5 limit")
        return
    cfg = load_config_dir(AZOV)
    om = OceanModel(cfg, base_dir=AZOV, results_dir=tempfile.mkdtemp())
    step = make_step(om.grid, cfg)
    jax.config.update("jax_enable_x64", True)
    ref, ok = jax.jit(lambda st: run_steps(step, st, cfg.run.tau, n))(
        om.state)
    check(bool(ok), f"{tag}: f64 guard tripped")
    ref = {"ssh": ref.ssh, "u": ref.ubrtr, "v": ref.vbrtr}
    for k, (c, r) in host.items():
        e_c, e_r = rel_err(c, ref[k]), rel_err(r, ref[k])
        print(f"{tag}: {k} vs f64 composition: candidate {e_c:.3e}, "
              f"f32 reference {e_r:.3e}")
        check(errs[k] < REL_TOL or e_c <= 1.25 * e_r,
              f"{tag}: {k} strays from f64 ({e_c:.3e} vs {e_r:.3e})")
    print(f"{tag}: passed: beyond 1e-5 only by f32 round-off")


def golden_case(precision):
    from ocean_model_arch_tpu.config import (ModelConfig, SWConfig,
                                             basinpar_bs4km)
    from ocean_model_arch_tpu.core.grid import build_grid
    from ocean_model_arch_tpu.io.mask_io import read_mask
    basin = basinpar_bs4km()
    cfg = ModelConfig(basin=basin,
                      sw=SWConfig(use_tracers=1, tracer_num=1),
                      precision=precision)
    mask = read_mask(os.path.join(REPO, basin.mask_file_name),
                     basin.nx, basin.ny)
    grid = build_grid(basin, mask, precision=cfg.precision)
    return grid, cfg, init_ocean_state(grid, cfg)


def golden_check(state, want, rtol, pt_atol, points) -> float:
    """Largest relative deviation from the golden digests; raises past
    the tolerances."""
    worst = 0.0
    for fld, arr in (("ssh", state.ssh), ("u", state.ubrtr),
                     ("v", state.vbrtr), ("tracer", state.ff[0])):
        a = np.asarray(arr, np.float64)
        got = {"sum": a.sum(), "l2": np.sqrt((a * a).sum()),
               "absmax": np.abs(a).max()}
        for k, v in got.items():
            np.testing.assert_allclose(v, want[fld][k], rtol=rtol,
                                       err_msg=f"{fld}.{k}")
            worst = max(worst, abs(v - want[fld][k])
                        / max(abs(want[fld][k]), 1e-300))
        pts = [a[i, j] for (i, j) in points]
        np.testing.assert_allclose(pts, want[fld]["points"], rtol=rtol,
                                   atol=pt_atol,
                                   err_msg=f"{fld}.points")
    return worst


def phase3(f32: bool) -> None:
    with open(os.path.join(REPO, "tests", "golden_bs100.json")) as f:
        golden = json.load(f)
    points = [tuple(p) for p in golden["points"]]
    steps = sorted(golden["steps"], key=int)
    if f32:
        grid, cfg, state = golden_case(Precision.f32())
        fm = FusedSWModel(grid, cfg, 1.0, static_rslu=True,
                          steps_per_call=2)
        run = jax.jit(fm.run_steps, static_argnums=1)
        s6, done, worst = fm.pack(state), 0, 0.0
        for s in steps:
            s6, ok = run(s6, int(s) - done)
            check(bool(ok), f"PHASE 3: guard tripped by step {s}")
            done = int(s)
            worst = max(worst, golden_check(
                fm.unpack(s6, state), golden["steps"][s], 3e-4, 5e-6,
                points))
        print(f"PHASE 3: golden bs100, fused f32: worst digest rel dev "
              f"{worst:.3e} (limit 3e-4)")
        return
    grid, cfg, state = golden_case(Precision.f64())
    step = jax.jit(make_step(grid, cfg))
    done, worst = 0, 0.0
    for s in steps:
        state, ok = run_steps(step, state, 1.0, int(s) - done)
        check(bool(ok), f"PHASE 3: guard tripped by step {s}")
        done = int(s)
        worst = max(worst, golden_check(state, golden["steps"][s], 1e-9,
                                        1e-12, points))
    print(f"PHASE 3: golden bs100, composition f64: worst digest rel dev "
          f"{worst:.3e} (limit 1e-9)")


def four_cards(n: int = 120) -> None:
    from ocean_model_arch_tpu.model.fused_sharded2d import (
        FusedSharded2DModel)
    from ocean_model_arch_tpu.model.sharded import (make_sharded_step,
                                                    prepare)
    from ocean_model_arch_tpu.parallel.domain import crop_state
    from ocean_model_arch_tpu.parallel.mesh import make_mesh

    grid, cfg, state = azov_f32()
    tau = cfg.run.tau
    fm = FusedSWModel(grid, cfg, tau, static_rslu=True, steps_per_call=2)
    s6, ok = jax.jit(lambda st: fm.run_steps(fm.pack(st), n))(state)
    check(bool(ok), "FOUR: single-card fused guard tripped")
    one_f = fm.unpack(s6, state)
    step = make_step(grid, cfg)
    one_c, ok = jax.jit(lambda st: run_steps(step, st, tau, n))(state)
    check(bool(ok), "FOUR: single-card composition guard tripped")

    fs = FusedSharded2DModel(grid, cfg, tau, 2, 2, weighted=True,
                             steps_per_call=2)
    runner = fs.make_runner(n)
    carry, ok = runner(fs.pack(state))
    check(bool(ok), "FOUR: fused-sharded guard tripped")
    out = fs.extract(carry)
    host_f = {k: (np.asarray(out[i]), np.asarray(getattr(one_f, f)))
              for i, (k, f) in zip((0, 2, 4), FIELDS)}
    t_f = time_stepper(runner, carry, n)

    mesh = make_mesh(2, 2)
    gs, ss = prepare(grid, state, mesh)
    stepn = make_sharded_step(gs, cfg, mesh, n_inner=n)
    st2, ok = stepn(ss, tau)
    check(bool(ok), "FOUR: jnp-sharded guard tripped")
    st2c = crop_state(st2, grid.nx, grid.ny)
    host_c = {k: (np.asarray(getattr(st2c, f)),
                  np.asarray(getattr(one_c, f))) for k, f in FIELDS}
    t_c = time_stepper(lambda st: stepn(st, tau), st2, n)
    print(f"FOUR: 2x2 mesh, {grid.nx}x{grid.ny} f32, {n} steps; weighted "
          f"x cuts {list(map(int, fs.x_edges))}, y cuts "
          f"{list(map(int, fs.y_edges))}")
    for name, host, t in (("fused-sharded vs single-card fused", host_f,
                           t_f),
                          ("jnp-sharded vs single-card composition",
                           host_c, t_c)):
        print(f"FOUR: {name} rel err ssh/u/v "
              + " ".join(f"{rel_err(c, r):.3e}" for c, r in host.values())
              + f"; step {t * 1e3:.4f} ms")
    judge("FOUR (fused-sharded)", host_f, n)
    judge("FOUR (jnp-sharded)", host_c, n)


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--four", action="store_true",
                   help="run only the 2x2 four-card check")
    args = p.parse_args()
    dev = phase0(4 if args.four else 1)
    if args.four:
        four_cards()
    else:
        with tempfile.TemporaryDirectory() as tmp:
            phase1(tmp, f32=True)
            host = phase2()
            phase3(f32=True)
            # the f64 validation mode last: it turns on 64-bit types for
            # the rest of the process, as the CLI's f64 default does
            jax.config.update("jax_enable_x64", True)
            judge("PHASE 2", host, 100)
            phase3(f32=False)
            phase1(tmp, f32=False)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
