"""Step cost of the jnp composition vs the fused step on the GPU.

    python3 scripts/step_profile.py [--config DIR] [--out DIR] [--steps N]

At a config (default: examples/05_azov_hires, 1525x1115) in f32, for the
composition (model/step.py make_step + run_steps) and the fused step
(ops/fused_step.py through FusedSWModel) with each shift form (its own
zero-filled slices of the padded array, and a wrapping ``jnp.roll``):

- compile seconds (lower + compile) of an N-step scan window;
- seconds per step through diag/scaling.py::time_stepper;
- from XLA's cost analysis of ONE call (1 step for the composition, 2
  chained steps for the fused step): bytes accessed per point per step,
  against the floor of reading and writing the carried state once;
- from a profiler trace of a short window: device kernels per step,
  device busy time per step, idle share, and the busiest kernels.

Prints one JSON line per variant and writes the traces and a summary
to ``--out`` (default chiprun_out/step_profile). Needs a GPU.
"""

import argparse
import dataclasses
import glob
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax import lax  # noqa: E402

from ocean_model_arch_tpu.config import Precision  # noqa: E402
from ocean_model_arch_tpu.diag.scaling import time_stepper  # noqa: E402
from ocean_model_arch_tpu.model.fused import FusedSWModel  # noqa: E402
from ocean_model_arch_tpu.model.model import (  # noqa: E402
    OceanModel, load_config_dir)
from ocean_model_arch_tpu.model.step import make_step, run_steps  # noqa
from ocean_model_arch_tpu.ops import fused_step as fsk  # noqa: E402


def shift_roll(a, dm: int = 0, dn: int = 0):
    """result[m, n] = a[m + dm, n + dn], wrapping at the array edges —
    the alternative to the fused step's zero-filled slices."""
    if dm:
        a = jnp.roll(a, -dm, axis=0)
    if dn:
        a = jnp.roll(a, -dn, axis=1)
    return a


def device_summary(trace_dir: str, n_steps: int) -> dict:
    """Kernels, busy time and the top kernels of the GPU planes of the
    newest trace under ``trace_dir``."""
    path = sorted(glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                            recursive=True))[-1]
    pd = jax.profiler.ProfileData.from_file(path)
    lines, kern, spans = {}, {}, []
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            evs = list(line.events)
            lines[f"{plane.name}|{line.name}"] = len(evs)
            if "stream" not in line.name.lower():
                continue
            for ev in evs:
                spans.append((ev.start_ns, ev.end_ns))
                k = kern.setdefault(ev.name, [0, 0.0])
                k[0] += 1
                k[1] += ev.duration_ns
    spans.sort()
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    window = (spans[-1][1] - spans[0][0]) if spans else 0.0
    top = sorted(kern.items(), key=lambda kv: -kv[1][1])[:8]
    return {"trace": os.path.relpath(path, REPO),
            "lines": lines,
            "kernels_per_step": sum(v[0] for v in kern.values()) / n_steps,
            "busy_us_per_step": busy / n_steps / 1e3,
            "idle_share_in_window": (1 - busy / window) if window else None,
            "top_kernels_us_per_step": {
                k: round(v[1] / n_steps / 1e3, 3) for k, v in top}}


def bytes_per_point_step(compiled, points: int, steps: int):
    ca = compiled.cost_analysis()
    if isinstance(ca, (list, tuple)):
        ca = ca[0]
    b = (ca or {}).get("bytes accessed")
    return None if b is None else b / points / steps


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default=os.path.join(REPO, "chiprun_out",
                                                 "step_profile"))
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--config", default=os.path.join(
        REPO, "examples", "05_azov_hires"))
    args = p.parse_args()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"no GPU (JAX platform {dev.platform})")
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    os.makedirs(args.out, exist_ok=True)
    n = args.steps

    d = args.config
    cfg = dataclasses.replace(load_config_dir(d),
                              precision=Precision.f32())
    om = OceanModel(cfg, base_dir=d, results_dir=tempfile.mkdtemp())
    grid, state, tau = om.grid, om.state, cfg.run.tau
    points = grid.nx * grid.ny
    step = make_step(grid, cfg)

    variants = {"composition": None, "fused_zero_fill": fsk._shift,
                "fused_roll": shift_roll}
    rows = []
    own = fsk._shift
    for name, shift in variants.items():
        if shift is None:
            def window(st):
                return run_steps(step, st, tau, n)
            one = jax.jit(lambda st: step(st, tau)).lower(state).compile()
            carry, per_call = state, 1
        else:
            fsk._shift = shift          # read when the step is built
            try:
                fm = FusedSWModel(grid, cfg, tau, static_rslu=True,
                                  steps_per_call=2)
            finally:
                fsk._shift = own

            def window(s6, fm=fm):
                return fm.run_steps(s6, n)
            carry = fm.pack(state)
            one = jax.jit(lambda *f, fm=fm: fm.step6(*f)).lower(
                *carry).compile()
            per_call = 2
        t0 = time.perf_counter()
        run = jax.jit(window).lower(carry).compile()
        t_compile = time.perf_counter() - t0
        t_step = time_stepper(run, carry, n, windows=5)
        # the trace covers a short window of its own (traces are large)
        n_tr = min(n, 10 * per_call)
        if shift is None:
            short = jax.jit(lambda st: run_steps(step, st, tau, n_tr))
        else:
            short = jax.jit(lambda s6, fm=fm: fm.run_steps(s6, n_tr))
        carry2, ok = short(carry)
        bool(ok)
        tdir = os.path.join(args.out, name)
        with jax.profiler.trace(tdir):
            carry2, ok = short(carry2)
            bool(ok)
        row = {"variant": name, "card": card,
               "device_kind": dev.device_kind,
               "grid": [grid.nx, grid.ny], "steps_per_window": n,
               "compile_s": round(t_compile, 3),
               "step_ms": t_step * 1e3,
               "points_per_s": points / t_step,
               "bytes_per_point_step": bytes_per_point_step(
                   one, points, per_call)}
        row.update(device_summary(tdir, n_tr))
        print(json.dumps(row), flush=True)
        rows.append(row)
    # carried state read + written once per call: 6 f32 fields
    floor = {"composition_state_bytes_per_point_step": 32 * 2 * 4,
             "fused_state_bytes_per_point_step": 6 * 2 * 4 / 2}
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump({"rows": rows, "floor": floor}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
