"""Long-horizon drift of the PRODUCTION fused f32 step vs the f64 jnp
golden: Black Sea 4 km workload (the golden_bs100
config: real coastline, flat 100 m, one tracer, tau=1), compared at
checkpoints out to 2000 steps.

The f64 golden runs in a CPU subprocess (x64 mode, the general jnp
path); the fused step runs compiled on the device in production f32
with all reductions at their defaults (steps_per_call=2,
elide_sel/q4/share_prev). Reported: relative L2 and Linf error of ssh
(wet cells) and tracer at each checkpoint — the committed error-growth
curve for VALIDATION.md section 4.

Run from the repo root: python scripts/drift_curve.py
"""

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, ".")

from ocean_model_arch_tpu.utils.cache import enable_compilation_cache

CHECKS = [100, 200, 500, 1000, 2000]

_CPU64 = r"""
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
import sys, numpy as np
sys.path.insert(0, ".")
from ocean_model_arch_tpu.config import (ModelConfig, Precision, SWConfig,
                                         basinpar_bs4km)
from ocean_model_arch_tpu.core.grid import build_grid
from ocean_model_arch_tpu.io.mask_io import read_mask
from ocean_model_arch_tpu.model.init import init_ocean_state
from ocean_model_arch_tpu.model.step import make_step, run_steps
basin = basinpar_bs4km()
cfg = ModelConfig(basin=basin, sw=SWConfig(use_tracers=1, tracer_num=1),
                  precision=Precision.f64())
mask = read_mask(basin.mask_file_name, basin.nx, basin.ny)
grid = build_grid(basin, mask, precision=cfg.precision)
state = init_ocean_state(grid, cfg)
step = jax.jit(make_step(grid, cfg))
out = {}
done = 0
for n in %CHECKS%:
    state, ok = run_steps(step, state, np.float64(1.0), n - done)
    assert bool(ok), n
    done = n
    out[str(n)] = (np.asarray(state.ssh), np.asarray(state.ff[0]))
np.savez("%OUT%", **{f"ssh{k}": v[0] for k, v in out.items()},
         **{f"ff{k}": v[1] for k, v in out.items()})
print("golden done")
"""


def main():
    enable_compilation_cache()
    import jax

    from ocean_model_arch_tpu.config import (ModelConfig, Precision,
                                             SWConfig, basinpar_bs4km)
    from ocean_model_arch_tpu.core.grid import build_grid
    from ocean_model_arch_tpu.io.mask_io import read_mask
    from ocean_model_arch_tpu.model.fused import FusedSWModel
    from ocean_model_arch_tpu.model.init import init_ocean_state

    golden_path = os.path.join(tempfile.gettempdir(),
                               "drift_golden_bs.npz")
    if not os.path.exists(golden_path):
        print("computing f64 golden on CPU ...", flush=True)
        code = _CPU64.replace("%CHECKS%", repr(CHECKS)).replace(
            "%OUT%", golden_path)
        r = subprocess.run([sys.executable, "-c", code],
                           capture_output=True, text=True, cwd=".")
        if r.returncode != 0:
            raise RuntimeError(r.stderr[-2000:])
    gold = np.load(golden_path)

    basin = basinpar_bs4km()
    cfg = ModelConfig(basin=basin,
                      sw=SWConfig(use_tracers=1, tracer_num=1),
                      precision=Precision.f32())
    mask = read_mask(basin.mask_file_name, basin.nx, basin.ny)
    grid = build_grid(basin, mask, precision=cfg.precision)
    state = init_ocean_state(grid, cfg)
    wet = np.asarray(grid.lu) > 0.5
    fm = FusedSWModel(grid, cfg, 1.0, static_rslu=True,
                      steps_per_call=2)
    carry = fm.pack(state)

    run = jax.jit(lambda c, n: fm.run_steps(c, n), static_argnums=1)
    done = 0
    rows = []
    for n in CHECKS:
        t0 = time.perf_counter()
        carry, ok = run(carry, n - done)
        assert bool(ok), n
        done = n
        out = fm.unpack(carry, state)
        ssh = np.asarray(out.ssh, np.float64)
        ff = np.asarray(out.ff[0], np.float64)
        g_ssh = gold[f"ssh{n}"]
        g_ff = gold[f"ff{n}"]

        def rel(a, b):
            d = (a - b)[wet]
            bb = b[wet]
            return (float(np.sqrt((d * d).sum())
                          / max(np.sqrt((bb * bb).sum()), 1e-300)),
                    float(np.abs(d).max() / max(np.abs(bb).max(),
                                                1e-300)))
        l2s, lis = rel(ssh, g_ssh)
        l2f, lif = rel(ff, g_ff)
        rows.append({"steps": n, "ssh_rel_l2": l2s, "ssh_rel_linf": lis,
                     "tracer_rel_l2": l2f, "tracer_rel_linf": lif,
                     "wall_s": round(time.perf_counter() - t0, 2)})
        print(json.dumps(rows[-1]), flush=True)
    print(json.dumps({"metric": "fused_f32_drift_vs_f64_golden",
                      "device_kind": jax.devices()[0].device_kind,
                      "rows": rows}))


if __name__ == "__main__":
    main()
