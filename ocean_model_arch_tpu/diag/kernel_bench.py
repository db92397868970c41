"""Per-kernel timing (the kernel_runtime.f90 registry + per-kernel timer
table, mpp.f90:342-384 — flagged unsupported in the reference; supported
here).

Times every physics kernel of the jnp layer standalone under jit on the
current backend.
"""

from __future__ import annotations

import time

import jax
import numpy as np

from ..config import ModelConfig
from ..core.grid import Grid
from ..core.state import SWState
from ..model.step import GlobalHalo
from ..ops import depth_kernels as dk
from ..ops import sw_kernels as swk
from ..ops import tracer_kernels as trk


def _time(fn, *args, reps=10):
    out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps


def run(grid: Grid, cfg: ModelConfig, state: SWState, tau=1.0) -> dict:
    """Returns {kernel_name: seconds_per_call} for the 11 SW + 3 tracer
    kernels (each jitted standalone — includes its own memory traffic,
    which the fused step amortizes)."""
    hp = GlobalHalo(grid.periodic_x, grid.periodic_y)
    ex = hp.ex
    s, g = state, grid
    results = {}

    def bench(name, fn, *args):
        results[name] = _time(jax.jit(fn), *args)

    bench("sw_update_ssh", swk.update_ssh, tau, ex(g.lu), ex(g.dx),
          ex(g.dy), ex(g.dxh), ex(g.dyh), ex(s.hhu), ex(s.hhv),
          ex(s.sshn), ex(s.sshp), ex(s.ubrtr), ex(s.vbrtr))
    bench("uv_trans_vort", swk.uv_trans_vort, ex(g.luu), ex(g.dxt),
          ex(g.dyt), ex(g.dxb), ex(g.dyb), ex(s.ubrtr), ex(s.vbrtr),
          ex(s.vort))
    bench("uv_trans", swk.uv_trans, ex(g.lcu), ex(g.lcv), ex(g.luu),
          ex(g.dxh), ex(g.dyh), ex(s.ubrtr), ex(s.vbrtr), ex(s.vort),
          ex(s.hhq), ex(s.hhu), ex(s.hhv), ex(s.hhh),
          ex(s.rhsx_adv), ex(s.rhsy_adv))
    bench("stress_components", swk.stress_components, ex(g.lu), ex(g.luu),
          ex(g.dx), ex(g.dy), ex(g.dxt), ex(g.dyt), ex(g.dxh), ex(g.dyh),
          ex(g.dxb), ex(g.dyb), ex(s.ubrtrp), ex(s.vbrtrp),
          ex(s.str_t), ex(s.str_s))
    bench("uv_diff2", swk.uv_diff2, ex(g.lcu), ex(g.lcv), ex(g.dx),
          ex(g.dy), ex(g.dxt), ex(g.dyt), ex(g.dxh), ex(g.dyh),
          ex(g.dxb), ex(g.dyb), ex(s.mu), ex(s.str_t), ex(s.str_s),
          ex(s.hhq), ex(s.hhu), ex(s.hhv), ex(s.hhh),
          ex(s.rhsx_dif), ex(s.rhsy_dif))
    bench("sw_update_uv", swk.update_uv, tau, ex(g.lcu), ex(g.lcv),
          ex(g.dxt), ex(g.dyt), ex(g.dxh), ex(g.dyh), ex(g.dxb),
          ex(g.dyb), ex(s.hhu), ex(s.hhu_n), ex(s.hhu_p), ex(s.hhv),
          ex(s.hhv_n), ex(s.hhv_p), ex(s.hhh), ex(s.ssh), ex(s.ubrtr),
          ex(s.ubrtrn), ex(s.ubrtrp), ex(s.vbrtr), ex(s.vbrtrn),
          ex(s.vbrtrp), ex(s.r_diss), ex(g.rlh_s), ex(s.rhsx),
          ex(s.rhsy), ex(s.rhsx_adv), ex(s.rhsy_adv), ex(s.rhsx_dif),
          ex(s.rhsy_dif))
    bench("sw_next_step", swk.next_step, cfg.sw.time_smooth, ex(g.lu),
          ex(g.lcu), ex(g.lcv), ex(s.ssh), ex(s.sshn), ex(s.sshp),
          ex(s.ubrtr), ex(s.ubrtrn), ex(s.ubrtrp), ex(s.vbrtr),
          ex(s.vbrtrn), ex(s.vbrtrp))
    bench("hh_update", dk.hh_update, ex(g.lu), ex(g.llu), ex(g.llv),
          ex(g.luh), ex(g.dx), ex(g.dy), ex(g.dxt), ex(g.dyt), ex(g.dxh),
          ex(g.dyh), ex(g.dxb), ex(g.dyb), ex(s.ssh), ex(g.hhq_rest),
          ex(s.hhu_n), ex(s.hhv_n), ex(s.hhh_n))
    bench("hh_shift", dk.hh_shift, cfg.sw.time_smooth, ex(g.lu),
          ex(g.llu), ex(g.llv), ex(g.luh), ex(s.hhq), ex(s.hhq_p),
          ex(s.hhq_n), ex(s.hhu), ex(s.hhu_p), ex(s.hhu_n), ex(s.hhv),
          ex(s.hhv_p), ex(s.hhv_n), ex(s.hhh), ex(s.hhh_p), ex(s.hhh_n))
    import functools
    dk_hh_init = functools.partial(dk.hh_init, cfg.sw.full_free_surface)
    bench("hh_init", lambda *a: dk_hh_init(*a), ex(g.lu),
          ex(g.llu), ex(g.llv), ex(g.luh), ex(g.dx), ex(g.dy), ex(g.dxt),
          ex(g.dyt), ex(g.dxh), ex(g.dyh), ex(g.dxb), ex(g.dyb),
          ex(s.ssh), ex(s.sshp), ex(g.hhq_rest), ex(s.hhu), ex(s.hhu_p),
          ex(s.hhu_n), ex(s.hhv), ex(s.hhv_p), ex(s.hhv_n), ex(s.hhh),
          ex(s.hhh_p), ex(s.hhh_n))
    bench("check_ssh_err", swk.check_ssh_ok, ex(g.lu), ex(s.ssh))

    if cfg.sw.use_tracers > 0 and s.ff is not None:
        bench("tran_diff_fluxes", trk.tran_diff_fluxes, ex(g.lcu),
              ex(g.lcv), ex(g.dxt), ex(g.dyt), ex(g.dxh), ex(g.dyh),
              ex(s.hhu), ex(s.hhv), ex(s.ff[0]), ex(s.ffp[0]),
              ex(s.ubrtr), ex(s.vbrtr), ex(s.mu), 1.0,
              ex(s.flux_x), ex(s.flux_y))
        bench("tran_diff_tracer", trk.tran_diff_tracer, tau, ex(g.lu),
              ex(g.dx), ex(g.dy), ex(s.hhq_n), ex(s.hhq_p), ex(s.flux_x),
              ex(s.flux_y), ex(s.ffp[0]), ex(s.ffn[0]))
        bench("tracer_next_step", trk.tracer_next_step,
              cfg.sw.time_smooth, ex(g.lu), ex(s.ffn[0]), ex(s.ffp[0]),
              ex(s.ff[0]))
    return results


def format_table(results: dict, n_points: int) -> str:
    lines = ["================ PER-KERNEL TIMES ================",
             f"{'kernel':<20} {'us/call':>10} {'Gpts/s':>9}"]
    tot = 0.0
    for k, v in sorted(results.items(), key=lambda kv: -kv[1]):
        lines.append(f"{k:<20} {v * 1e6:>10.1f} {n_points / v / 1e9:>9.2f}")
        tot += v
    lines.append(f"{'TOTAL (sum)':<20} {tot * 1e6:>10.1f} "
                 f"{n_points / tot / 1e9:>9.2f}")
    lines.append("==================================================")
    return "\n".join(lines)
