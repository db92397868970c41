"""Per-config benchmarks for the five example workloads (examples 01-05:
flat-basin gravity wave, rotating basin, tracer-coupled, Black Sea mask,
Azov hires; reference workload definitions basinpar.f90:96-166).

Each config runs in f32 on the compute path the path rule
(model.select_path) picks, through OceanModel.make_runner. Prints ONE
JSON line per config: points/s, wet points/s, ms/step, the path and the
device. Compare numbers only within one run on one device.

Run: python scripts/bench_configs.py [config ...]   (defaults: all five)
"""

import dataclasses
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from ocean_model_arch_tpu.utils.cache import enable_compilation_cache  # noqa

CONFIGS = ["01_flat_basin", "02_rotating_basin", "03_tracer",
           "04_black_sea", "05_azov_hires"]


def bench_one(name: str, n_inner: int = 2000, windows: int = 3):
    import jax

    from ocean_model_arch_tpu.config import Precision
    from ocean_model_arch_tpu.model.model import (OceanModel,
                                                  load_config_dir)

    d = os.path.join(REPO, "examples", name)
    cfg = load_config_dir(d)
    cfg = dataclasses.replace(cfg, precision=Precision.f32())
    om = OceanModel(cfg, base_dir=d)
    grid = om.grid
    run = om.make_runner(n_inner)
    carry = om._state_s if om.mesh is not None else om.state

    carry, ok = run(carry)
    if not bool(ok):
        raise RuntimeError(f"{name}: stability guard tripped in warmup")
    best = float("inf")
    for _ in range(windows):
        t0 = time.perf_counter()
        carry, ok = run(carry)
        good = bool(ok)          # reading the flag waits for the device
        best = min(best, time.perf_counter() - t0)
        if not good:
            raise RuntimeError(f"{name}: stability guard tripped")
    pts = grid.nx * grid.ny
    wet = float((np.asarray(grid.lu) > 0.5).mean())
    pps = pts * n_inner / best
    print(json.dumps({
        "metric": f"sw_step_points_per_sec[{name}]",
        "value": pps,
        "unit": "points/s",
        "ms_per_step": best / n_inner * 1e3,
        "grid": f"{grid.nx}x{grid.ny}",
        "wet_fraction": wet,
        "wet_points_per_sec": pps * wet,
        "tracers": cfg.sw.tracer_num if cfg.sw.use_tracers else 0,
        "path": om.path,
        "device_kind": jax.devices()[0].device_kind,
    }), flush=True)


def main():
    enable_compilation_cache()
    for name in sys.argv[1:] or CONFIGS:
        try:
            bench_one(name)
        except Exception as e:  # noqa: BLE001 - report and continue
            print(f"{name} FAILED: {type(e).__name__}: {str(e)[:300]}",
                  flush=True)


if __name__ == "__main__":
    main()
