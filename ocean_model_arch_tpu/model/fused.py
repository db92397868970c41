"""Driver for the fused whole-step update (ops/fused_step.py).

Wraps the fused step with layout embedding, precondition checks (the
general jnp composition covers what it does not), scan-based multi-step
running, and SWState conversion so outputs/checkpoints stay
interchangeable with the reference formats.
"""

from __future__ import annotations

import dataclasses
import jax
import jax.numpy as jnp
import numpy as np

from ..config import ModelConfig
from ..core.grid import Grid
from ..core.state import SWState
from ..ops import fused_step as fsk
from ..ops import sw_kernels as swk


class FusedSWModel:
    """Shallow-water core on the fused step. Carries only the 6
    prognostic fields; depths/masks are recomputed every step."""

    def __init__(self, grid: Grid, cfg: ModelConfig, tau: float,
                 mu_const: float = 0.0, static_rslu: bool = False,
                 steps_per_call: int = 1,
                 elide_sel: bool | None = None, q4: bool | None = None,
                 share_prev: bool | None = None,
                 fast2d: bool | None = None):
        if grid.periodic_x or grid.periodic_y:
            raise ValueError("fused path: periodic boundaries unsupported")
        self.grid = grid
        self.cfg = cfg
        self.tau = float(tau)
        self.n_tracers = (cfg.sw.tracer_num if cfg.sw.use_tracers > 0
                          else 0)
        self.lay = fsk.make_layout(grid.nx, grid.ny,
                                   steps_per_call=steps_per_call)
        m = self.lay.margin
        # x-uniform metrics ride as latitude profiles (free broadcast);
        # bipolar/curvilinear grids read full metric planes — by default
        # through the fast-2D mode: the fast restructurings with
        # pointwise planes, keeping ONLY the rows this config consumes
        # (fast2d_met_rows) instead of all 16
        met22 = None
        try:
            met = fsk.metrics_profile_from_grid(grid, self.lay)
            self.metrics_2d = False
            self.fast2d = False
            self._met_map = None
        except ValueError:
            self.metrics_2d = True
            self.fast2d = (bool(static_rslu) if fast2d is None
                           else bool(fast2d))
            if self.fast2d and not static_rslu:
                raise ValueError("fast2d requires static_rslu=True")
            met22 = fsk.metrics_full_from_grid(grid, self.lay,
                                               derived=self.fast2d)
            if self.fast2d:
                visc2 = bool(cfg.sw.ksw_lat and mu_const != 0.0)
                rows = fsk.fast2d_met_rows(cfg.sw.trans_terms, visc2,
                                           self.n_tracers)
                self._met_map = {r: i for i, r in enumerate(rows)}
                met = met22[list(rows)]
            else:
                met = met22
                self._met_map = None
        yp = self.lay.ypad
        lu_s = np.zeros((self.lay.Xs, self.lay.Ys), np.float32)
        lu_s[m:m + grid.nx, yp:yp + grid.ny] = np.asarray(grid.lu)
        hr_s = np.zeros_like(lu_s)
        hr_s[m:m + grid.nx, yp:yp + grid.ny] = np.asarray(grid.hhq_rest)
        # mu is spatially constant in the reference (the init quirk zeroes
        # it, init_data.f90:76-77); a nonzero constant enables the fused
        # stress/diffusion branch
        self.mu_const = float(mu_const)
        # spatially-constant bathymetry (the reference's shipped default:
        # flat 100 m) folds the hrludxdy static plane into a scalar
        # (fast mode + ffs only)
        hr_np = np.asarray(grid.hhq_rest, np.float32)
        self.hr_const = (float(hr_np.flat[0])
                         if np.ptp(hr_np) == 0.0 else None)
        # fast-mode arithmetic reductions (fused_step.py), ALL default ON
        # in fast mode: elide_sel / q4 are exact in real arithmetic
        # (~1 ulp FMA-contraction drift); share_prev REGROUPS the
        # chained-step prev-depth interps (f32 round-off vs the
        # two-interp order)
        fast = bool(static_rslu) and (not self.metrics_2d
                                      or self.fast2d)
        self.elide_sel = fast if elide_sel is None else bool(elide_sel)
        self.q4 = fast if q4 is None else bool(q4)
        self.share_prev = (fast if share_prev is None
                           else bool(share_prev)) and steps_per_call > 1
        if (self.elide_sel or self.q4 or self.share_prev) and not fast:
            raise ValueError("elide_sel/q4/share_prev require fast mode "
                             "(static_rslu=True, x-uniform metrics or "
                             "fast2d)")
        if static_rslu:
            # fast mode: fold the interpolation metric factors into the
            # rslu planes (one multiply per depth interpolation); q4
            # additionally folds the advection 1/4 into the u/v recips
            # (exact power-of-two scale, compensated in the step)
            qs = np.float32(0.25) if self.q4 else np.float32(1.0)
            if self.fast2d:
                dxdy = met22[0] * met22[1]           # (Xs, Ys) planes
                recips = (met22[10] * qs, met22[11] * qs,
                          met22[14] * met22[15])
            elif self.metrics_2d:
                dxdy = met[0] * met[1]               # (Xs, Ys) planes
                recips = None
            else:
                dxdy = (met[0] * met[1])[None, :]    # (1, Ys) profile
                recips = (met[10:11] * qs, met[11:12] * qs,
                          (met[14] * met[15])[None])
            names = fsk.plane_names(
                cfg.sw.full_free_surface, cfg.sw.ksw_lat, self.mu_const,
                self.metrics_2d,
                hr_const=(self.hr_const
                          if (not self.metrics_2d or self.fast2d)
                          else None),
                fast2d=self.fast2d)
            rslu = fsk.static_planes(lu_s, hr_s, dxdy, names,
                                     interp_recips=recips)
        else:
            rslu = None
        del met22
        self.steps_per_call = int(steps_per_call)
        self.step6 = fsk.build_fused_sw_step(
            self.lay, lu_s, hr_s, met, self.tau, cfg.sw.time_smooth,
            cfg.sw.full_free_surface, cfg.sw.trans_terms, cfg.sw.ksw_lat,
            self.mu_const, n_tracers=self.n_tracers,
            metrics_2d=self.metrics_2d, rslu_planes=rslu,
            steps_per_call=self.steps_per_call, hr_const=self.hr_const,
            elide_sel=self.elide_sel, q4=self.q4,
            share_prev=self.share_prev, fast2d=self.fast2d,
            met_map=self._met_map)
        if self.elide_sel:
            # land-zero invariant the elided selects rely on: mask the
            # velocity/tracer carriers once at pack time (bit-exact for
            # every state the framework produces — land velocities are
            # zero-init and never written; sw_next_step only updates
            # wlcu/wlcv points)
            wlcu, wlcv, wlu = fsk.staggered_wet_masks(lu_s)
            self._wlcu = jnp.asarray(wlcu)
            self._wlcv = jnp.asarray(wlcv)
            self._wlu = jnp.asarray(wlu)

    # -- state conversion ------------------------------------------------
    def validate_state(self, state: SWState) -> None:
        """Eager-mode precondition check (pack itself is jit-safe)."""
        mu = np.asarray(state.mu)
        if mu.size and not np.all(mu == mu.flat[0]):
            raise ValueError("fused path requires spatially-constant mu")
        if mu.size and float(mu.flat[0]) != self.mu_const:
            raise ValueError("state.mu does not match the step's mu_const")

    def pack(self, state: SWState):
        """SWState -> (6 + 2*T)-tuple in fused layout (jit-safe)."""
        e = lambda a: fsk.embed(self.lay, a)
        if self.elide_sel:
            carry = [e(state.ssh), e(state.sshp),
                     e(state.ubrtr) * self._wlcu,
                     e(state.ubrtrp) * self._wlcu,
                     e(state.vbrtr) * self._wlcv,
                     e(state.vbrtrp) * self._wlcv]
            for t in range(self.n_tracers):
                carry.append(e(state.ff[t]) * self._wlu)
                carry.append(e(state.ffp[t]) * self._wlu)
        else:
            carry = [e(state.ssh), e(state.sshp), e(state.ubrtr),
                     e(state.ubrtrp), e(state.vbrtr), e(state.vbrtrp)]
            for t in range(self.n_tracers):
                carry.append(e(state.ff[t]))
                carry.append(e(state.ffp[t]))
        return tuple(carry)

    def unpack(self, s6, template: SWState) -> SWState:
        """6-tuple -> full SWState; depth families + 'n' levels are
        regenerated with the jnp kernels so the result matches the general
        path's state layout (for output / checkpoint / tracer coupling)."""
        x = lambda a: fsk.extract(self.lay, a).astype(
            template.ssh.dtype)
        ssh, sshp, u, up, v, vp = (x(a) for a in s6[:6])
        st = dataclasses.replace(template, ssh=ssh, sshp=sshp, ubrtr=u,
                                 ubrtrp=up, vbrtr=v, vbrtrp=vp)
        if self.n_tracers:
            ff = jnp.stack([x(s6[6 + 2 * t])
                            for t in range(self.n_tracers)])
            ffp = jnp.stack([x(s6[7 + 2 * t])
                             for t in range(self.n_tracers)])
            # post-rotation ffn == ff at wet points (tracer_next_step)
            st = dataclasses.replace(st, ff=ff, ffp=ffp, ffn=ff)
        # regenerate depths exactly as the end-of-step hh_init would
        from .step import reinit_depth_families
        return reinit_depth_families(st, self.grid, self.cfg)

    # -- running ---------------------------------------------------------
    def run_steps(self, s6, n_steps: int):
        """Scan the fused step; returns (s6', ok). ``ok`` accumulates the
        per-step |ssh| max through the scan carry, so the guard cadence
        matches the reference's every-step check_ssh_err
        (vel_ssh.f90:40-67) — a transient blowup at ANY chained step of
        any window trips it. ``n_steps`` must be a multiple of
        ``steps_per_call``."""
        spc = self.steps_per_call
        if n_steps % spc:
            raise ValueError(f"n_steps={n_steps} not a multiple of "
                             f"steps_per_call={spc}")

        def body(c, _):
            fields, mx = c
            fields, smax = self.step6(*fields)
            return (fields, jnp.maximum(mx, smax)), None

        (s6, mx), _ = jax.lax.scan(
            body, (tuple(s6), jnp.zeros((), jnp.float32)), None,
            length=n_steps // spc)
        ok = mx < swk.SSH_ERR_BOUND        # NaN compares False
        return s6, ok


def fused_available(grid: Grid, sharded: bool = False,
                    px: int = 1, py: int = 1) -> bool:
    """Whether the fused step supports this grid. x-varying (bipolar)
    metrics are handled by the 2D-metrics mode on both the single-device
    and sharded drivers. Periodic boundaries are supported on the sharded
    driver (the margin exchange adds the wrap pair) when the periodic
    axis is exactly mesh-divisible; the single-device layout has static
    land margins, so periodic runs route through FusedSharded2DModel (a
    1x1 'mesh' wraps locally)."""
    if not sharded:
        return not (grid.periodic_x or grid.periodic_y)
    if grid.periodic_x and grid.nx % px:
        return False
    if grid.periodic_y and grid.ny % py:
        return False
    return True
