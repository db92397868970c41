"""Generate the committed golden-trajectory digests (tests/golden_bs100.json).

100-step f64 run of the Black Sea 4 km workload (basinpar.f90:96-130,
real coastline mask, flat 100 m bathymetry, gaussian-bump SSH, one
tracer) on the general jnp path, CPU. The digests anchor the physics:
optimization rounds and jax/XLA upgrades are asserted
against them by tests/test_golden.py, the regression analog of the
reference's sync_test discipline (syncborder_block2D_gen_test.fi).

Run from the repo root: python scripts/make_golden_bs.py
"""

import json
import os
import sys

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

from ocean_model_arch_tpu.config import (ModelConfig, Precision,  # noqa: E402
                                         SWConfig, basinpar_bs4km)
from ocean_model_arch_tpu.core.grid import build_grid  # noqa: E402
from ocean_model_arch_tpu.io.mask_io import read_mask  # noqa: E402
from ocean_model_arch_tpu.model.init import init_ocean_state  # noqa: E402
from ocean_model_arch_tpu.model.step import make_step, run_steps  # noqa: E402

# fixed probe points (i, j), wet on the BS mask — direct value anchors in
# addition to the global moments
POINTS = [(60, 40), (120, 80), (200, 90), (150, 60), (90, 110)]
STEPS = [50, 100]
TAU = 1.0


def digests(a: np.ndarray) -> dict:
    a = np.asarray(a, np.float64)
    return {
        "sum": float(a.sum()),
        "l2": float(np.sqrt((a * a).sum())),
        "absmax": float(np.abs(a).max()),
        "points": [float(a[i, j]) for (i, j) in POINTS],
    }


def main():
    basin = basinpar_bs4km()
    cfg = ModelConfig(basin=basin,
                      sw=SWConfig(use_tracers=1, tracer_num=1),
                      precision=Precision.f64())
    mask = read_mask(basin.mask_file_name, basin.nx, basin.ny)
    grid = build_grid(basin, mask, precision=cfg.precision)
    state = init_ocean_state(grid, cfg)
    assert int(np.asarray(mask == 0).sum()) > 0

    step = jax.jit(make_step(grid, cfg))
    out = {"workload": "bs4km f64 jnp path, flat 100 m, bump ssh, "
                       "1 tracer, tau=1.0",
           "points": POINTS, "steps": {}}
    done = 0
    for s in STEPS:
        state, ok = run_steps(step, state, TAU, s - done)
        assert bool(ok), f"stability guard tripped at step {s}"
        done = s
        out["steps"][str(s)] = {
            "ssh": digests(state.ssh),
            "u": digests(state.ubrtr),
            "v": digests(state.vbrtr),
            "tracer": digests(state.ff[0]),
        }
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tests", "golden_bs100.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print("wrote", path)


if __name__ == "__main__":
    main()
