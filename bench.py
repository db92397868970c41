"""Throughput of the full shallow-water step on one device.

    python3 bench.py [default|azov_mask|bipolar|bipolar_azov]
    python3 bench.py weak_scaling | halo_overlap

Workload = the reference's shipped default configuration (basin.par: Azov
Sea 250 m extents 1525x1115, spherical metrics, 'none' mask -> 2-cell land
frame, flat 100 m bathymetry, gaussian-bump SSH; sw.par defaults: full free
surface + momentum transport + lateral viscosity, no tracers), run in f32
production precision. ``azov_mask`` uses the real Azov coastline,
``bipolar`` the bipolar grid at Black Sea extents, ``bipolar_azov`` the
bipolar grid at Azov extents with the real coastline.

The model is built through OceanModel, so the compute path is the one the
path rule (model.select_path) picks for the config. Each mode prints ONE
JSON line naming the device (``device_kind``) and the compute path.
"""

import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

_CPU_SUB = """
import os
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8")
import jax, json
jax.config.update("jax_platforms", "cpu")
{body}
"""


def _run_cpu_subprocess(body: str) -> dict:
    """Run a snippet on the virtual 8-device CPU mesh in a child process
    that never opens an accelerator (the CPU platform is fixed before
    its JAX backend starts), and parse the single JSON line it prints."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, "-c", _CPU_SUB.format(body=body)],
        capture_output=True, text=True, cwd=REPO, env=env)
    if out.returncode != 0:
        raise RuntimeError(f"CPU subprocess failed:\n{out.stderr[-3000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def bench_weak_scaling():
    """Weak-scaling harness over the virtual 8-device CPU mesh (real XLA
    collectives; the same harness runs unchanged on a GPU mesh —
    diag/scaling.py). On the shared-core virtual mesh the figure is
    WORK-NORMALIZED efficiency (ideal t(N) = N*t(1))."""
    rep = _run_cpu_subprocess("""
from ocean_model_arch_tpu.diag.scaling import weak_scaling
rep = weak_scaling([(1, 1), (2, 1), (2, 2), (4, 2)],
                   nx_loc=256, ny_loc=256, n_inner=20, windows=3)
rep["device_kind"] = jax.devices()[0].device_kind
print(json.dumps(rep))
""")
    out = {
        "metric": "weak_scaling_efficiency_1_to_8",
        "value": rep["efficiency_last"],
        "unit": ("N*t(1)/t(N), work-normalized (shared-core virtual "
                 "mesh), fixed 256x256/dev" if rep["shared_cores"]
                 else "t_step(1 dev) / t_step(N dev), fixed 256x256/dev"),
        "path": rep["path"],
        "device_kind": rep["device_kind"],
        "rows": [{"mesh": r["mesh"],
                  "ms_per_step": r["step_seconds"] * 1e3,
                  "efficiency": r["efficiency"],
                  "efficiency_work_normalized":
                      r["efficiency_work_normalized"]}
                 for r in rep["rows"]],
    }
    print(json.dumps(out))


def _model(workload: str, precision=None):
    """OceanModel for a workload (f32 unless ``precision`` is given)."""
    from ocean_model_arch_tpu.config import (ModelConfig, Precision,
                                             SWConfig, basinpar_as250m_test)
    from ocean_model_arch_tpu.model.model import OceanModel

    basin = basinpar_as250m_test()
    if workload == "bipolar":
        # the bipolar conformal grid (grid_parameters.f90:183) at Black
        # Sea extents
        basin = dataclasses.replace(basin, nx=289, ny=163,
                                    dxst=0.05, dyst=0.04,
                                    rlon=27.525, rlat=40.94,
                                    curve_grid=2)
    elif workload == "bipolar_azov":
        basin = dataclasses.replace(basin, curve_grid=2)
    if workload in ("azov_mask", "bipolar_azov"):
        # the reference's shipped workload: the real Azov Sea coastline
        # (data/AS/maskAzovCor.txt, 41.1% wet)
        basin = dataclasses.replace(basin,
                                    mask_file_name="data/AS/maskAzovCor.txt")
    cfg = ModelConfig(basin=basin, sw=SWConfig(use_tracers=0),
                      precision=precision or Precision.f32())
    return OceanModel(cfg, base_dir=REPO,
                      results_dir=os.path.join(REPO, "RESULTS"))


def bench_halo_overlap():
    """Halo-exchange accounting: exact collective bytes/step of the
    fused-sharded step on a 4x2 mesh at the bench extents (lowered HLO on
    the virtual CPU mesh), plus the measured step time of the fused
    step and of the fused-sharded driver at 1x1 (margin exchange, no
    collectives) on the device."""
    import jax

    from ocean_model_arch_tpu.diag.scaling import time_stepper
    from ocean_model_arch_tpu.model.fused import FusedSWModel
    from ocean_model_arch_tpu.model.fused_sharded2d import \
        FusedSharded2DModel
    from ocean_model_arch_tpu.utils.cache import enable_compilation_cache
    enable_compilation_cache()

    om = _model("default")
    grid, cfg, state = om.grid, om.cfg, om.state
    n_inner = 2000
    fm = FusedSWModel(grid, cfg, 1.0, static_rslu=True, steps_per_call=2)
    t_fused = time_stepper(jax.jit(lambda c: fm.run_steps(c, n_inner)),
                           fm.pack(state), n_inner)
    fs = FusedSharded2DModel(grid, cfg, 1.0, 1, 1, steps_per_call=2)
    t_1x1 = time_stepper(fs.make_runner(n_inner), fs.pack(state),
                         n_inner)

    rep = _run_cpu_subprocess("""
from bench import _model
from ocean_model_arch_tpu.diag.scaling import halo_bytes_per_step
from ocean_model_arch_tpu.model.fused_sharded2d import FusedSharded2DModel
om = _model("default")
fs = FusedSharded2DModel(om.grid, om.cfg, 1.0, 4, 2, steps_per_call=2)
print(json.dumps({"bytes": halo_bytes_per_step(fs)}))
""")
    print(json.dumps({
        "metric": "halo_exchange_accounting",
        "device_kind": jax.devices()[0].device_kind,
        "fused_ms_per_step": t_fused * 1e3,
        "sharded_1x1_ms_per_step": t_1x1 * 1e3,
        "exchange_overhead_fraction": max(0.0,
                                          (t_1x1 - t_fused) / t_1x1),
        "collective_bytes_per_step_4x2": rep["bytes"],
    }))


def main(workload: str = "default"):
    import jax

    from ocean_model_arch_tpu.utils.cache import enable_compilation_cache
    enable_compilation_cache()

    om = _model(workload)
    grid = om.grid
    # long scan windows amortize the per-dispatch host round trip
    # against device compute; the whole window is one XLA program
    # (lax.scan), so compile cost is independent of n_inner
    n_inner = 2000
    run_j = om.make_runner(n_inner)
    carry = om._state_s if om.mesh is not None else om.state

    t0 = time.perf_counter()
    carry, ok = run_j(carry)
    if not bool(ok):
        raise RuntimeError("stability guard tripped in benchmark")
    t_first = time.perf_counter() - t0
    # best of several windows; reading the flag waits for the device
    # (not an assert: python -O must not strip the barrier)
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        carry, ok = run_j(carry)
        good = bool(ok)
        best = min(best, time.perf_counter() - t0)
        if not good:
            raise RuntimeError("stability guard tripped in benchmark")

    points = grid.nx * grid.ny
    wet_points = int((np.asarray(grid.lu) > 0.5).sum())
    tag = "" if workload == "default" else f"[{workload}]"
    print(json.dumps({
        "metric": f"sw_step_points_per_sec{tag}",
        "value": points * n_inner / best,
        "unit": "points/s",
        "wet_points_per_sec": wet_points * n_inner / best,
        "wet_fraction": wet_points / points,
        "ms_per_step": best / n_inner * 1e3,
        "first_window_s": t_first,
        "path": om.path,
        "device_kind": jax.devices()[0].device_kind,
        "device_count": len(jax.devices()),
    }))


if __name__ == "__main__":
    mode = sys.argv[1] if len(sys.argv) > 1 else "default"
    if mode == "weak_scaling":
        bench_weak_scaling()
    elif mode == "halo_overlap":
        bench_halo_overlap()
    else:
        main(mode)
