"""Halo-overlap accounting + weak-scaling harness (diag/scaling.py) —
the BASELINE.json metrics beyond points/s/chip, exercised on the virtual
8-device CPU mesh. The reference's analog is the sync-phase share of the
mpp_finalize timer table (mpp.f90:272-341)."""

import numpy as np

from ocean_model_arch_tpu.config import (ModelConfig, Precision, SWConfig,
                                         basinpar_flat)
from ocean_model_arch_tpu.core.grid import build_grid
from ocean_model_arch_tpu.core.masks import frame_of_land_mask
from ocean_model_arch_tpu.diag.scaling import (expected_halo_bytes_per_step,
                                               halo_bytes_per_step,
                                               halo_overlap_report,
                                               weak_scaling)
from ocean_model_arch_tpu.model.fused_sharded2d import FusedSharded2DModel


def _model(px, py, nx=64, ny=160, spc=2, tracers=0):
    basin = basinpar_flat(nx, ny, curve_grid=1, rlon=27.5, rlat=41.0)
    cfg = ModelConfig(
        basin=basin,
        sw=SWConfig(use_tracers=int(tracers > 0), tracer_num=tracers),
        precision=Precision.f32())
    grid = build_grid(basin, frame_of_land_mask(nx, ny),
                      precision=cfg.precision)
    return FusedSharded2DModel(grid, cfg, 1.0, px, py, steps_per_call=spc)


def test_halo_bytes_match_analytic_2d_mesh():
    fs = _model(2, 2)
    got = halo_bytes_per_step(fs)
    assert got == expected_halo_bytes_per_step(fs), \
        (got, expected_halo_bytes_per_step(fs))
    assert got > 0


def test_halo_bytes_match_analytic_x_only_with_tracers():
    fs = _model(4, 1, tracers=2)
    got = halo_bytes_per_step(fs)
    assert got == expected_halo_bytes_per_step(fs)


def test_halo_bytes_scale_with_chaining():
    m1, m2 = _model(2, 2, spc=1), _model(2, 2, spc=2)
    b1, b2 = halo_bytes_per_step(m1), halo_bytes_per_step(m2)
    assert (b1, b2) == (expected_halo_bytes_per_step(m1),
                        expected_halo_bytes_per_step(m2))
    # spc=2 doubles the margin (4 -> 8 cells) and halves the exchanges
    # per step: per step the strips stay 4 cells wide, and only the
    # wider margins' corners add bytes
    assert m2.M == 2 * m1.M
    assert b1 <= b2 < 1.25 * b1


def test_halo_overlap_report_fields():
    rep = halo_overlap_report(_model(2, 2), link_gbps=100.0,
                              t_step_sharded=1e-3)
    assert rep["collective_bytes_per_step"] > 0
    assert 0.0 <= rep["comm_fraction_bound"] <= 1.0
    assert rep["comm_seconds_per_step_bound"] == \
        rep["collective_bytes_per_step"] / (rep["link_GBps"] * 1e9)


def test_weak_scaling_harness_fused_path():
    # tiny shards + few steps: this validates the HARNESS (it must run
    # unchanged on real meshes); CPU timings say nothing about a GPU, so
    # no efficiency assertion. 'auto' follows the path rule: f32 with
    # constant mu takes the fused step.
    rep = weak_scaling([(1, 1), (2, 1), (2, 2)], nx_loc=32, ny_loc=64,
                       n_inner=4, windows=1, path="auto")
    assert rep["path"] == "fused"
    assert len(rep["rows"]) == 3
    assert rep["rows"][0]["devices"] == 1
    assert rep["rows"][2]["collective_bytes_per_step"] > 0
    for r in rep["rows"]:
        assert r["step_seconds"] > 0
        assert r["points"] == 32 * r["mesh"][0] * 64 * r["mesh"][1]


def test_weak_scaling_harness_jnp_path_on_cpu():
    # the jnp-composed sharded step on the virtual mesh exercises REAL
    # single-process XLA collectives
    rep = weak_scaling([(1, 1), (2, 2)], nx_loc=32, ny_loc=64,
                       n_inner=4, windows=1, path="jnp")
    assert rep["path"] == "jnp"
    assert rep["rows"][1]["devices"] == 4
    assert all(r["step_seconds"] > 0 for r in rep["rows"])
