"""The compute-path rule (model.select_path): one function of the
configuration, the same on every backend."""

import dataclasses

import jax
import pytest

from ocean_model_arch_tpu.config import (ModelConfig, ParallelConfig,
                                         Precision, SWConfig, basinpar_flat)
from ocean_model_arch_tpu.core.grid import build_grid
from ocean_model_arch_tpu.core.masks import frame_of_land_mask
from ocean_model_arch_tpu.model import model as mm


def _grid_cfg(nx=40, ny=36, f64=False, periodic_x=0, periodic_y=0,
              mesh=(1, 1)):
    basin = dataclasses.replace(basinpar_flat(nx, ny, curve_grid=1,
                                              rlon=27.5, rlat=41.0),
                                periodicity_x=periodic_x,
                                periodicity_y=periodic_y)
    prec = Precision.f64() if f64 else Precision.f32()
    cfg = ModelConfig(basin=basin, sw=SWConfig(use_tracers=0),
                      precision=prec,
                      parallel=ParallelConfig(mesh_x=mesh[0],
                                              mesh_y=mesh[1]))
    grid = build_grid(basin, frame_of_land_mask(nx, ny), precision=prec)
    return grid, cfg


@pytest.mark.parametrize("kw,mu,expected", [
    (dict(), 0.0, mm.PATH_FUSED),
    (dict(f64=True), 0.0, mm.PATH_JNP),
    (dict(), None, mm.PATH_JNP),                       # varying mu
    (dict(periodic_x=1), 0.0, mm.PATH_FUSED_PERIODIC),
    (dict(periodic_y=1), 0.0, mm.PATH_FUSED_PERIODIC),
    (dict(mesh=(2, 2)), 0.0, mm.PATH_FUSED_SHARDED),
    (dict(mesh=(2, 2), f64=True), 0.0, mm.PATH_JNP_SHARDED),
    # periodic x over 3 shards of 40 rows: the seam shards would differ
    (dict(mesh=(3, 1), periodic_x=1), 0.0, mm.PATH_JNP_SHARDED),
    # 36 columns over 8 shards: narrower than the fused margin
    (dict(mesh=(1, 8)), 0.0, mm.PATH_JNP_SHARDED),
])
def test_select_path(monkeypatch, kw, mu, expected):
    grid, cfg = _grid_cfg(**kw)

    def no_platform(*a, **k):
        raise AssertionError("the path rule must not ask the platform")

    monkeypatch.setattr(jax, "devices", no_platform)
    assert mm.select_path(grid, cfg, mu) == expected
    # the blockers explain every composition pick, and only those
    assert bool(mm.fused_blockers(grid, cfg, mu)) == \
        expected.startswith("jnp")
