"""Fused step under SPMD x-sharding vs the single-device jnp path."""

import jax
import numpy as np
import pytest

from ocean_model_arch_tpu.config import (ModelConfig, Precision, SWConfig,
                                         basinpar_flat)
from ocean_model_arch_tpu.core.grid import build_grid
from ocean_model_arch_tpu.core.masks import frame_of_land_mask
from ocean_model_arch_tpu.model.fused_sharded import FusedShardedSWModel
from ocean_model_arch_tpu.model.init import init_ocean_state
from ocean_model_arch_tpu.model.step import make_step, run_steps


@pytest.fixture(scope="module")
def case():
    basin = basinpar_flat(70, 52, curve_grid=1, rlon=27.5, rlat=41.0)
    prec = Precision.f32()
    cfg = ModelConfig(basin=basin, sw=SWConfig(use_tracers=0),
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


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_fused_sharded_matches(case, n):
    grid, cfg, state, ref = case
    fm = FusedShardedSWModel(grid, cfg, 1.0, n)
    s6 = fm.pack(state)
    out6, ok = fm.make_runner(30)(s6)
    assert bool(ok)
    ssh, sshp, u, up, v, vp = fm.extract(out6)
    for name, a, b in [("ssh", ssh, ref.ssh), ("sshp", sshp, ref.sshp),
                       ("u", u, ref.ubrtr), ("up", up, ref.ubrtrp),
                       ("v", v, ref.vbrtr), ("vp", vp, ref.vbrtrp)]:
        a, b = np.asarray(a), np.asarray(b)
        rel = np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)
        assert rel < 1e-5, (name, rel)
