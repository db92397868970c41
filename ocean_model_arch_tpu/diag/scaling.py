"""Halo-overlap and weak-scaling accounting — the two BASELINE.json
metrics beyond points/s/chip.

The reference's analog is the sync-phase share of the mpp_finalize timer
table (mpp.f90:272-341: sync total / pack / isend-irecv / wait vs model
step) and its aspiration to overlap sync with compute
(`_MPP_HYBRID_BLOCK_MODE_`, README.md:56-57 — dead stubs). Here the
halo exchange is ppermute collectives that XLA schedules asynchronously,
so the per-device measurables are:

- **collective bytes/step** — exact, read from the lowered HLO of the
  sharded runner (every ``collective_permute`` the scan body executes).
  Divided by a given link rate this bounds the un-overlapped comm time
  per step.
- **weak-scaling efficiency** — t_step(1 device) / t_step(N devices) at
  a FIXED per-device subdomain, the BASELINE.json 1→N gate. The harness
  runs unchanged on any jax backend: a real multi-GPU mesh or the
  virtual CPU mesh used in the tests.
"""

from __future__ import annotations

import dataclasses
import re
import time

import jax
import numpy as np

_DTYPE_BYTES = {"f32": 4, "f64": 8, "bf16": 2, "f16": 2, "i32": 4,
                "si32": 4, "ui32": 4, "i8": 1, "si8": 1}


def collective_bytes(lowered_text: str) -> int:
    """Sum the operand bytes of every ``collective_permute`` in a lowered
    StableHLO module. Inside a ``lax.scan`` body each op executes once
    per trip, so lower a runner with ONE scan trip and scale by trips
    yourself."""
    total = 0
    # operand type = the `: (tensor<...>)` signature suffix (NOT the
    # source_target_pairs attribute, also a tensor<..i64> literal)
    for m in re.finditer(
            r'collective_permute.*?:\s*\(tensor<([0-9x]+)x([a-z0-9]+)>\)',
            lowered_text):
        dims = [int(d) for d in m.group(1).split("x")]
        bsz = _DTYPE_BYTES.get(m.group(2))
        if bsz is None:
            continue
        total += int(np.prod(dims)) * bsz
    return total


def halo_bytes_per_step(fs, verify_expected: bool = True) -> int:
    """Collective bytes per MODEL STEP of a FusedSharded2DModel: lower a
    one-trip runner and read the collective_permute shapes (exact — this
    is what XLA will execute), then divide by the steps chained per
    exchange."""
    spc = fs.steps_per_call
    runner = fs.make_runner(spc)          # one scan trip
    lowered = runner.lower(
        tuple(jax.ShapeDtypeStruct(
            (fs.px * (fs.Xpad + 2 * fs.M), fs.py * fs.Ysp), np.float32)
            for _ in range(6 + 2 * fs.n_tracers)))
    per_call = collective_bytes(lowered.as_text())
    if verify_expected and per_call == 0 and (fs.px > 1 or fs.py > 1):
        raise RuntimeError("no collective_permute found in lowered HLO")
    return per_call // spc


def expected_halo_bytes_per_step(fs) -> int:
    """Analytic cross-check of :func:`halo_bytes_per_step`: per exchange,
    each of the 6+2T prognostic fields sends an (M, Ysp) row strip to
    each x neighbour and an (Xpad+2M, M) lane strip of the (post-x-pass)
    margined carry to each y neighbour."""
    M = fs.M
    nf = 6 + 2 * fs.n_tracers
    # HLO shapes are PER-DEVICE (shard_map manual mode): each device's
    # program moves 2 strips per sharded axis per field per exchange
    bx = 2 * int(fs.px > 1) * M * fs.Ysp * 4 * nf
    by = 2 * int(fs.py > 1) * (fs.Xpad + 2 * M) * M * 4 * nf
    return (bx + by) // fs.steps_per_call


def halo_overlap_report(fs, link_gbps: float,
                        t_step_sharded: float | None = None) -> dict:
    """Comm accounting for a sharded model: exact collective bytes/step
    plus, if a measured per-step time is given, the comm share at the
    given per-link rate (GB/s) and zero overlap (an upper bound — XLA
    overlaps the permutes with the step where the schedule allows)."""
    bytes_step = halo_bytes_per_step(fs)
    out = {
        "collective_bytes_per_step": bytes_step,
        "link_GBps": link_gbps,
        "comm_seconds_per_step_bound": bytes_step / (link_gbps * 1e9),
    }
    if t_step_sharded is not None:
        out["comm_fraction_bound"] = min(
            1.0, out["comm_seconds_per_step_bound"] / t_step_sharded)
    return out


def time_stepper(stepper, carry, n_inner: int, windows: int = 3) -> float:
    """Best-of-N per-step seconds of a ``carry -> (carry, ok)`` stepper.

    The ONE timing loop every harness shares: reading the ok flag on the
    host waits for the window's device work, so each window is timed to
    its end."""
    carry, ok = stepper(carry)
    if not bool(ok):                      # transfer = true barrier
        raise RuntimeError("stability guard tripped during warmup")
    best = float("inf")
    for _ in range(windows):
        t0 = time.perf_counter()
        carry, ok = stepper(carry)
        good = bool(ok)                   # transfer = true barrier
        best = min(best, time.perf_counter() - t0)
        if not good:
            raise RuntimeError("stability guard tripped during timing")
    return best / n_inner


def weak_scaling(mesh_shapes, nx_loc: int, ny_loc: int,
                 n_inner: int = 64, steps_per_call: int = 2,
                 windows: int = 3, devices=None, verbose: bool = False,
                 path: str = "auto") -> dict:
    """Weak-scaling harness: fixed (nx_loc x ny_loc) per-device subdomain
    over growing meshes; efficiency(N) = t_step(smallest) / t_step(N)
    (BASELINE.json's 1 host -> N gate; >= 0.9 is the target).

    ``mesh_shapes``: [(px, py), ...]; each must fit in ``devices``
    (default jax.devices()). ``path``: 'fused' = the fused-sharded
    runner; 'jnp' = the jnp-composed sharded step; 'auto' = whichever
    the model's path rule (model.select_path) picks for the config. Runs
    unchanged on a real GPU mesh and the 8-device virtual CPU mesh."""
    from jax.sharding import Mesh

    from ..config import ModelConfig, Precision, SWConfig, basinpar_flat
    from ..core.grid import build_grid
    from ..core.masks import frame_of_land_mask
    from ..model.fused_sharded2d import FusedSharded2DModel
    from ..model.init import init_ocean_state
    from ..model.model import PATH_JNP, PATH_JNP_SHARDED, select_path
    from ..model.sharded import make_sharded_step, prepare

    devs = list(devices if devices is not None else jax.devices())
    rows = []
    chosen = set()
    for px, py in mesh_shapes:
        n = px * py
        if n > len(devs):
            raise ValueError(f"mesh {px}x{py} needs {n} devices, "
                             f"have {len(devs)}")
        nx, ny = nx_loc * px, ny_loc * py
        basin = basinpar_flat(nx, ny, curve_grid=1, rlon=27.5, rlat=41.0)
        cfg = ModelConfig(basin=basin, sw=SWConfig(use_tracers=0),
                          precision=Precision.f32())
        grid = build_grid(basin, frame_of_land_mask(nx, ny),
                          precision=cfg.precision)
        state = init_ocean_state(grid, cfg)
        p = path
        if p == "auto":
            cfg_m = dataclasses.replace(cfg, parallel=dataclasses.replace(
                cfg.parallel, mesh_x=px, mesh_y=py))
            p = ("jnp" if select_path(grid, cfg_m, 0.0)
                 in (PATH_JNP, PATH_JNP_SHARDED) else "fused")
        chosen.add(p)
        if p == "fused":
            fs = FusedSharded2DModel(grid, cfg, 1.0, px, py,
                                     devices=devs[:n],
                                     steps_per_call=steps_per_call)
            t = time_stepper(fs.make_runner(n_inner), fs.pack(state),
                             n_inner, windows)
            cbytes = halo_bytes_per_step(fs) if n > 1 else 0
        else:
            mesh = Mesh(np.array(devs[:n]).reshape(px, py), ("x", "y"))
            grid_s, state_s = prepare(grid, state, mesh)
            stepped = make_sharded_step(grid_s, cfg, mesh,
                                        n_inner=n_inner)
            tau = np.float32(1.0)
            t = time_stepper(lambda st: stepped(st, tau), state_s,
                             n_inner, windows)
            cbytes = 0
        rows.append({"mesh": [px, py], "devices": n,
                     "points": nx * ny,
                     "step_seconds": t,
                     "points_per_sec": nx * ny / t,
                     "collective_bytes_per_step": cbytes})
        if verbose:
            print(f"WEAK: {px}x{py}  {t * 1e3:8.3f} ms/step", flush=True)
    # baseline = the SMALLEST mesh timed, wherever it appears in the list
    t1 = min(rows, key=lambda r: r["devices"])["step_seconds"]
    for r in rows:
        # true weak-scaling efficiency: each device is real hardware,
        # so ideal t(N) == t(1)
        r["efficiency"] = t1 / r["step_seconds"]
        # shared-core form: a VIRTUAL mesh timeshares one host's cores,
        # so ideal t(N) == N*t(1); this isolates the collective + seam
        # overhead the virtual mesh CAN see
        r["efficiency_work_normalized"] = \
            r["devices"] * t1 / r["step_seconds"]
    shared_cores = devs[0].platform == "cpu"
    return {"nx_loc": nx_loc, "ny_loc": ny_loc,
            "path": "/".join(sorted(chosen)),
            "shared_cores": shared_cores,
            "rows": rows,
            "efficiency_last": rows[-1][
                "efficiency_work_normalized" if shared_cores
                else "efficiency"]}
