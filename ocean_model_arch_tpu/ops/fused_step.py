"""Fused whole-step shallow-water update in plain ``jax.numpy``.

One function evaluates the full update_ssh -> hh_update -> vort ->
uv_trans -> stress -> uv_diff2 -> update_uv -> next_step -> [tracer]
chain over the whole stored array. It is the counterpart of the
reference's CUDA Fortran kernel layer (gpu/kernel/*, gpu/interface/*),
but instead of mirroring the 11 separate kernels it exploits two
structural facts the reference cannot:

1. **Depths are recomputable.** Because expl_shallow_water ends every step
   with hh_init (shallow_water.f90:82-87), every depth field entering a
   step is a pure function of (ssh, sshp, hhq_rest). The fused step
   recomputes them instead of carrying 12 depth arrays from step to step,
   so the carried state is the 6 prognostic fields (plus 2 per tracer).
   Likewise the staggered masks are recomputed from ``lu``, and
   hh_update's new-level depths coincide with the current-level ones
   (hqn = h_r + ssh = hq when full_free_surface=1), so one interpolation
   family serves both.

2. **Steps chain.** The per-step stencil reach is <= 4 cells and the
   output-stage masked selects restore exact zeros on every land cell, so
   one call can advance ``steps_per_call`` whole model steps; the sharded
   drivers then exchange a margin of 4 * steps_per_call cells once per
   call instead of once per step.

Layout: arrays are (Xs, Ys) float32 with land margins around the physical
(nx, ny) block: ``margin`` rows in x and ``ypad`` columns in y. Shifts are
static slices of the array zero-padded by the shift, evaluated over the
whole array; the zeros shifted in at the array edge reach only land cells
(the reference's 2-cell land frame plus the margins cover the 4-cell
reach), and the output selects write exact zeros there. Metric
fields that are x-uniform (every reference config with xgr_type=0) ride
as (N_PROF, Ys) latitude profiles broadcast across rows; x-varying
(bipolar/curvilinear) metrics ride as pointwise (n, Xs, Ys) planes.

Restrictions vs the jnp composition (which remains the general path):
non-periodic boundaries on a single device (the sharded driver wraps
periodic axes through its margin exchange), spatially-constant mu, and
r_diss = 0 (the reference never writes it, core/data_types zero-init).

Arithmetic reductions of the fast mode (static planes), default ON in the
drivers:

- ``elide_sel``: the four u/up/v/vp filter selects (plus the tracer
  pair) are dropped — un1/vn1 already select 0 at land and pack masks
  the carriers, so land stays exactly 0 and the selects were identity.
- ``q4``: the advection 1/4 interpolation factor folds into the
  rslu_u/rslu_v static planes; every compensating constant (-4g,
  -8tau, tau/2, 0.1875 thresholds, tracer -2.0/4mu) is an exact
  exponent shift, so the F/G/K/L per-point 0.25 multiplies vanish.
- ``share_prev``: step B of a chained call rebuilds its prev-level
  depth interps from step A's (hu, hv, hup, hvp) through the leapfrog
  filter identity (aq is affine in ssh with land-zero coefficients and
  ts1 + 2*ts2 == 1), replacing two interps + two shifts + the aq fma
  with three elementwise ops.

All three are exact in real arithmetic; the observed deviation from the
unreduced form is ~1 ulp/step from XLA's FMA contraction
(tests/test_fused.py::test_round5_*).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np
from jax import lax

from ..core.constants import FREE_FALL_ACC

YPAD = 2            # land columns each side in y (single-device layout)
N_PROF = 24         # profile rows (9 metrics + 7 reciprocals + 6 derived)


def margin_for(steps_per_call: int) -> int:
    """Margin width for a chaining depth: 4 cells of stencil reach per
    chained step."""
    return 4 * int(steps_per_call)


class FusedLayout(NamedTuple):
    nx: int          # physical extents
    ny: int
    X: int           # domain rows (nx, or a shard's padded extent)
    Xs: int          # stored rows = X + 2*margin
    Ys: int          # stored columns
    margin: int      # x margin rows (>= 4 * steps_per_call)
    ypad: int = YPAD  # physical y offset (the y land margin)


def make_layout(nx: int, ny: int, steps_per_call: int = 1) -> FusedLayout:
    """Single-device layout: the physical block between land margins."""
    m = margin_for(steps_per_call)
    return FusedLayout(nx, ny, nx, nx + 2 * m, ny + 2 * YPAD, m)


def embed(lay: FusedLayout, a) -> jnp.ndarray:
    """Place an (nx, ny) field into the fused (Xs, Ys) layout (zeros
    elsewhere — land)."""
    out = jnp.zeros((lay.Xs, lay.Ys), jnp.float32)
    return out.at[lay.margin:lay.margin + lay.nx,
                  lay.ypad:lay.ypad + lay.ny].set(
                      jnp.asarray(a, jnp.float32))


def extract(lay: FusedLayout, a) -> jnp.ndarray:
    """Crop back to the physical (nx, ny) extents."""
    return a[lay.margin:lay.margin + lay.nx,
             lay.ypad:lay.ypad + lay.ny]


def _shift(a, dm: int = 0, dn: int = 0):
    """result[m, n] = a[m + dm, n + dn], zero beyond the array edge: a
    static slice of the array zero-padded by the shift. (On the H100 this
    form ran 27% faster than a wrapping ``jnp.roll`` — PERF.md.)"""
    for axis, d in ((0, dm), (1, dn)):
        if d == 0 or a.shape[axis] == 1:
            continue
        pad = [(0, 0, 0)] * a.ndim
        pad[axis] = (0, d, 0) if d > 0 else (-d, 0, 0)
        a = lax.slice_in_dim(lax.pad(a, jnp.zeros((), a.dtype), pad),
                             max(d, 0), max(d, 0) + a.shape[axis],
                             axis=axis)
    return a


def plane_names(ffs: int, ksw: int, mu_const: float,
                metrics_2d: bool, hr_const: float | None = None,
                fast2d: bool = False) -> tuple:
    """Static-plane set for the fast mode, config-dependent so that no
    unused plane is built or read:

    - ``rslu_u/v/h``: reciprocal wet-neighbor counts of the depth
      interpolations (1/max(#wet,1)), premultiplied by the interp metric
      rows — they replace select chains, and they ENCODE the staggered
      wet masks: wlcu <=> rslu_u == 0.5/dxt (both neighbours wet),
      wluu <=> rslu_h == 0.25/(dxb*dyb) (all four wet), so the step
      derives wlcu/wlcv/wluu by comparing against scaled profile rows
      instead of reading three extra mask planes;
    - ``ludxdy`` = lu*dx*dy and ``hrludxdy`` = hhq_rest*lu*dx*dy — the
      weighted depth columns' static factors (ludxdy > 0.5 doubles as the
      wlu wet mask: metric products are >> 1 m^2 on every config);
    - ``wlu``: only the viscosity branch multiplies by it.

    With 2D metrics (bipolar grids) the default mode consumes only the
    three reciprocal planes; the fast-2D mode (``fast2d=True``) uses the
    FULL fast set — the rslu planes carry the pointwise 2D metric recips
    exactly as the 1D planes carry latitude rows, so every fast-mode
    restructuring transfers verbatim.
    """
    if metrics_2d and not fast2d:
        return ("rslu_u", "rslu_v", "rslu_h")
    names = ["rslu_u", "rslu_v", "rslu_h", "ludxdy"]
    # spatially-constant bathymetry (the reference's shipped default:
    # flat 100 m, init_data.f90:113-114): hrludxdy == hr*ludxdy exactly,
    # so the plane folds into a scalar
    if not (hr_const is not None and ffs):
        names.append("hrludxdy")
    if ksw and mu_const != 0.0:
        names.append("wlu")
    return tuple(names)


def _make_advance(lay: FusedLayout, tau: float, time_smooth: float,
                  ffs: int, trans: int, ksw: int, mu_const: float,
                  n_tracers: int = 0, metrics_2d: bool = False,
                  static_rslu: bool = False, steps_per_call: int = 1,
                  guard_col: int = 0, hr_const: float | None = None,
                  elide_sel: bool = False, q4: bool = False,
                  share_prev: bool = False, fast2d: bool = False,
                  met_map: dict | None = None):
    """Build ``advance(lu, hr, met, planes, state, tracers) ->
    (state', tracers', max|ssh|)`` advancing ``steps_per_call`` steps."""
    M = lay.margin
    assert M >= 4 * steps_per_call, \
        f"margin {M} < 4*steps_per_call={4 * steps_per_call}"
    g = float(FREE_FALL_ACC)
    ts = float(time_smooth)
    visc = bool(ksw and mu_const != 0.0)
    # fast mode: static mask planes + extended profile rows drop the
    # per-step mask recomputes, fold the 0.25 constants into
    # end-of-chain/profile scalings, and restructure vorticity around
    # precomputed metric-difference profiles (x-uniform metrics);
    # fast2d: the same restructurings with per-point 2D metric planes
    # (MT reads a pruned full-plane stack through met_map)
    assert not fast2d or (static_rslu and metrics_2d and met_map), \
        "fast2d needs static planes, 2D metrics, and a met row map"
    fast = bool(static_rslu and (not metrics_2d or fast2d))
    hrc = hr_const if (hr_const is not None and ffs and fast) else None
    spx = ({n: i for i, n in enumerate(
        plane_names(ffs, ksw, mu_const, metrics_2d, hr_const=hrc,
                    fast2d=fast2d))}
        if static_rslu else None)
    assert not (elide_sel or q4 or share_prev) or fast, \
        "elide_sel/q4/share_prev are fast-mode levers"
    # q4 scalar rescales: the 1/4 advection-interpolation factor moves
    # into the rslu_u/rslu_v static planes (host-side; power of two ->
    # exact), so hu/hv/hup/hvp and the fluxes arrive pre-quartered and
    # the per-point F/G/K/L 0.25 multiplies vanish. Every compensating
    # constant below is an exact exponent shift.
    g_s = -4.0 * g if q4 else -g                # slx/sly pressure scalar
    tau_n = 0.5 * tau if q4 else 2.0 * tau      # un/vn numerator row
    tau_c = -8.0 * tau if q4 else -2.0 * tau    # continuity row
    thr_uv = 0.1875 if q4 else 0.75             # encoded-mask thresholds
    inv2tau = float(1.0 / (2.0 * tau))
    S = _shift
    # rows/columns whose |ssh| the stability guard reads: the domain
    # rows, and all columns except wet y-margins (sharded layout), which
    # hold neighbour cells checked on their own shard
    gr = (slice(M, M + lay.X), slice(guard_col, lay.Ys - guard_col))

    def advance(lu8, hr8, met, planes, state, tracers):
        # Metric planes: 0 dx, 1 dy, 2 dxt, 3 dyt, 4 dxh, 5 dyh, 6 dxb,
        # 7 dyb, 8 rlh_s, 9 1/(dx*dy), 10-15 reciprocals of 2-7 (host-
        # precomputed), 16-21 derived (see metrics_profile_from_grid).
        # Profile mode: met is (N_PROF, Ys) latitude rows, broadcast
        # across rows. 2D mode (bipolar / curvilinear grids): met is a
        # full-plane stack.
        if metrics_2d:
            def MT(j, dm=0, dn=0):
                j2 = met_map[j] if met_map is not None else j
                return S(met[j2], dm, dn)
        else:
            def MT(j, dm=0, dn=0):
                return S(met[j:j + 1, :], 0, dn)

        def SP(name):
            """Static plane (see plane_names)."""
            return planes[spx[name]]

        def LU(dm=0, dn=0):
            return S(lu8, dm, dn)

        def WLCU():
            return (LU() * LU(1, 0)) > 0.5

        def WLCV():
            return (LU() * LU(0, 1)) > 0.5

        def WLUU():
            return (LU() * LU(1, 0) * LU(0, 1) * LU(1, 1)) > 0.5

        def one_step(state, tracers, prev_dep=None):
            """One full model step. ``prev_dep``: the previous chained
            step's (hu, hv, hup, hvp) metric-weighted depth interps —
            see share_prev below."""
            ssh8, sshp8, u8, up8, v8, vp8 = state

            # ---- depth interpolations (hh_init/hh_update, depth.f90) --
            # hq = h_r + ssh*ffs on T; area-weighted onto U/V/H points.
            # The weighted column aq = hq*dx*dy*lu is shared by all three
            # interps. No wet-select is needed: aq carries the lu factor,
            # so an all-land neighborhood yields an exactly-zero numerator
            # (and rslu = 1).
            def _rslu_u():
                if static_rslu:
                    return SP("rslu_u")
                slu = LU() + LU(1, 0)
                return jnp.where(slu > 1.5, 0.5, 1.0)

            def _rslu_v():
                if static_rslu:
                    return SP("rslu_v")
                slu = LU() + LU(0, 1)
                return jnp.where(slu > 1.5, 0.5, 1.0)

            def _rslu_h():
                if static_rslu:
                    return SP("rslu_h")
                slu = LU() + LU(1, 0) + LU(0, 1) + LU(1, 1)
                # slu in {0..4}; select the reciprocal (1/3 rounds once,
                # same as the division up to 1 ulp)
                return jnp.where(
                    slu > 3.5, 0.25,
                    jnp.where(slu > 2.5, np.float32(1.0 / 3.0),
                              jnp.where(slu > 1.5, 0.5, 1.0)))

            # In fast mode the u/v interps return the metric-weighted
            # depths hhu*dyh / hhv*dxh (one profile factor instead of
            # two): every consumer (continuity fluxes, pressure gradient,
            # bp chains, tracer transports) wants exactly those products —
            # and the remaining 1/dxt / 1/dyt / 1/(dxb*dyb) profile
            # factors are premultiplied into the rslu static planes
            # (static_planes interp_recips), so each interpolation costs
            # ONE multiply off its numerator.
            def interp_u(aq0):
                """slu in {0,1,2}: the reciprocal is an exact select (or
                a precomputed static plane), no division."""
                s = aq0 + S(aq0, 1, 0)
                if fast:
                    return s * _rslu_u()    # plane carries rslu/dxt
                return s * _rslu_u() * (MT(10) * MT(13))  # 1/dxt*1/dyh

            def interp_v(aq0, aq0y):
                """aq0y = aq0 shifted by +1 in y (shared across interps)."""
                s = aq0 + aq0y
                if fast:
                    return s * _rslu_v()    # plane carries rslu/dyt
                return s * _rslu_v() * (MT(12) * MT(11))  # 1/dxh*1/dyt

            def interp_h(aq0, aq0y):
                q = aq0 + S(aq0, 1, 0) + aq0y + S(aq0y, 1, 0)
                return q * _rslu_h() * (MT(14) * MT(15))  # 1/(dxb*dyb)

            if fast:
                def aq_of(src):
                    # ludxdy / hrludxdy fold the lu gating and metric
                    # product into one mul-add:
                    # aq = ssh*lu*dx*dy + hr*lu*dx*dy  (ffs=1);
                    # constant bathymetry folds the hr plane into a
                    # scalar: aq = (ssh + hr)*lu*dx*dy
                    if ffs and hrc is not None:
                        return (src + hrc) * SP("ludxdy")
                    if ffs:
                        return src * SP("ludxdy") + SP("hrludxdy")
                    return SP("hrludxdy")
            else:
                def aq_of(src):
                    hq = hr8 + src * float(ffs)
                    # (dx*dy) groups metric*metric so the chain stays 2
                    # full-array muls off the state in profile mode
                    return hq * (MT(0) * MT(1)) * LU()

            # current-level depths (== new-level: hqn = h_r + ssh = hq)
            aq_cur = aq_of(ssh8)
            aq_cury = S(aq_cur, 0, 1)
            if fast:
                # share the u-numerator with the h-interp: the 4-point
                # sum is the 2-point sum plus its own y-shift (exact:
                # shifts commute with the adds)
                su3 = aq_cur + S(aq_cur, 1, 0)
                hu3 = su3 * _rslu_u()
                hv3 = (aq_cur + aq_cury) * _rslu_v()
                hh3 = (su3 + S(su3, 0, 1)) * _rslu_h()
            else:
                hu3 = interp_u(aq_cur)
                hv3 = interp_v(aq_cur, aq_cury)
                hh3 = interp_h(aq_cur, aq_cury)
            # previous-level depths (pointwise consumers in update_uv)
            if prev_dep is not None:
                # share_prev: the previous chained step already interped
                # hu/hv/hup/hvp, and this step's sshp is its FILTER
                # output. aq is affine in ssh with both coefficients 0
                # on land and ts1 + 2*ts2 == 1 exactly, so the filter
                # commutes through the (linear) interpolation sums:
                #   hup = interp(aq(ts1*ssh + ts2*(sshn + sshp)))
                #       = ts1*hu_prev + ts2*(hu_cur + hup_prev)
                # — three cheap ops replacing the aq_prev fma, two
                # interps, and their two shifts (f32 regrouping only).
                phu, phv, phup, phvp = prev_dep
                hup1 = (1.0 - ts) * phu + (0.5 * ts) * (hu3 + phup)
                hvp1 = (1.0 - ts) * phv + (0.5 * ts) * (hv3 + phvp)
            else:
                aq_prev = aq_of(sshp8)
                hup1 = interp_u(aq_prev)
                hvp1 = interp_v(aq_prev, S(aq_prev, 0, 1))

            # ---- continuity: sshn (sw_update_ssh_kernel) ----
            # uflux3/vflux3 double as uv_trans's u*dyh*hu / v*dxh*hv
            if fast:
                uflux3 = u8 * hu3   # hu3 already carries dyh
                vflux3 = v8 * hv3   # hv3 already carries dxh
            else:
                uflux3 = u8 * hu3 * MT(5)
                vflux3 = v8 * hv3 * MT(4)
            fluxdiv2 = (uflux3 - S(uflux3, -1, 0)
                        + vflux3 - S(vflux3, 0, -1))
            if fast:
                # the lu select is redundant here: every consumer
                # re-masks (final writes select by wlu0; tracer aq
                # carries the LU factor), and land fluxes are exactly
                # zero via hu/hv. The -2tau scalar folds into the
                # (1, Ys) profile row.
                sshn2 = sshp8 + fluxdiv2 * (tau_c * MT(9))
            else:
                sshn2 = jnp.where(
                    LU() > 0.5,
                    sshp8 - 2.0 * tau * (fluxdiv2 * MT(9)), 0.0)

            # wet masks shared by advection / viscosity / momentum /
            # tracers
            u_c = u8
            v_c = v8
            if fast:
                u_y1_2 = S(u8, 0, 1)
                v_y1_2 = S(v8, 0, 1)
                u_x1_2 = S(u8, 1, 0)
                v_x1_2 = S(v8, 1, 0)
                s2u = u_y1_2 + u_c             # shared: G2/M2/Coriolis
                s2v = v_x1_2 + v_c             # shared: L2/H2/Coriolis

                # the staggered wet masks are ENCODED in the rslu planes
                # (see plane_names): both-wet <=> reciprocal 1/2, all-
                # four-wet <=> 1/4; the thresholds ride the same metric
                # rows the planes were premultiplied with, so a compare
                # against a scaled (1, Ys) row replaces a mask plane
                def WLCU_f():
                    return SP("rslu_u") < thr_uv * MT(10)

                def WLCV_f():
                    return SP("rslu_v") < thr_uv * MT(11)

                def WLUU_f():
                    return SP("rslu_h") < 0.29 * (MT(14) * MT(15))

                wlcu1 = WLCU_f()
                wlcv1 = WLCV_f()
            else:
                wlcu1 = WLCU()
                wlcv1 = WLCV()

            # ---- momentum advection (uv_trans_vort + uv_trans) ----
            if trans and fast:
                # Profile-mode vorticity: with x-uniform metrics the four
                # metric-weighted differences collapse onto three
                # precomputed profile rows (16: dyt-dyb,
                # 17: dxt(n+1)-dxb, 18: dxt-dxb):
                #   vort = (v(m+1)-v)*(dyt-dyb) - u(n+1)*(dxt(n+1)-dxb)
                #          + u*(dxt-dxb)
                # — 3 muls off the state instead of the vd_t/ud_t
                # products plus four differences. Masks are static
                # planes; every 0.25 folds into one end-of-chain scaling.
                wluu_b2 = WLUU_f()
                # rows 16-18 carry the advection 1/4 (folded at build),
                # so vort/H2/M2 arrive pre-scaled like the MT21-folded
                # Coriolis terms — which lets the Coriolis pair MERGE
                # into the advection tail below
                vort2 = jnp.where(
                    wluu_b2,
                    (v_x1_2 - v_c) * MT(16)
                    - u_y1_2 * MT(17)
                    + u_c * MT(18), 0.0)
                ud2 = uflux3
                ud2x = S(uflux3, 1, 0)
                ud2y = S(uflux3, 0, 1)
                vd2 = vflux3
                vd2x = S(vflux3, 1, 0)
                vd2y = S(vflux3, 0, 1)
                # telescoped edge fluxes (see the non-fast branch), each
                # pre-scaled by 1/4 on its F/G/K/L-private factor; the
                # luu mask is static. With q4 the 1/4 already rides the
                # rslu_u/rslu_v planes (hu/hv and hence ud/vd arrive
                # quartered), so the four per-point scalar multiplies
                # vanish — exactly (power-of-two scaling).
                if q4:
                    F2 = (ud2 + ud2x) * (u_c + u_x1_2)
                    G2 = (vd2 + vd2x) * jnp.where(wluu_b2, s2u, 0.0)
                    K2 = (vd2 + vd2y) * (v_c + v_y1_2)
                    L2 = (ud2 + ud2y) * s2v
                else:
                    F2 = (ud2 + ud2x) * ((u_c + u_x1_2) * 0.25)
                    G2 = ((vd2 + vd2x) * 0.25) \
                        * jnp.where(wluu_b2, s2u, 0.0)
                    K2 = (vd2 + vd2y) * ((v_c + v_y1_2) * 0.25)
                    L2 = ((ud2 + ud2y) * 0.25) * s2v
                # Coriolis (MT21 = rlh*dxb*dyb/4) merges with the
                # advection tail TWICE over:
                # 1. the vorticity and Coriolis h-point factors share
                #    their s2u/s2v multipliers, so
                #      H2 + C2v = (vort + rlh_row)*hh * s2v  (= Px)
                #      M2 + C2u = (vort + rlh_row)*hh * s2u  (= Ty)
                #    — 4 full-array ops instead of 8;
                # 2. all terms sharing a shift collapse into ONE shifted
                #    array:
                #      rx_adv + cpair_x = Px - F2 - G2 + (Px+G2)(n-1)
                #                         + F2(m-1)
                #    does the work of 4 shifts in 2.
                # The wlcu/wlcv selects are redundant (un1/vn1 re-select).
                vc2 = (vort2 + MT(21)) * hh3
                Px = vc2 * s2v
                Ty = vc2 * s2u
                Rx = Px + G2
                acx1 = (Px - F2 - G2 + S(Rx, 0, -1) + S(F2, -1, 0))
                Sy = L2 - Ty
                acy1 = (-Ty - L2 - K2 + S(Sy, -1, 0) + S(K2, 0, -1))
            elif trans:
                wluu2 = WLUU()
                vd_t = v8 * MT(3)      # v*dyt
                ud_t = u8 * MT(2)
                vort2 = jnp.where(
                    wluu2,
                    (S(vd_t, 1, 0) - vd_t)
                    - (S(ud_t, 0, 1) - ud_t)
                    - ((S(v8, 1, 0) - v_c) * MT(7)
                       - (S(u8, 0, 1) - u_c) * MT(6)), 0.0)

                ud3 = uflux3                       # u*dyh*hu
                vd3 = vflux3
                vorth2 = vort2 * hh3
                luu2f = jnp.where(wluu2, 1.0, 0.0)

                # Flux-form telescoping (uv_trans_kernel): the minus-side
                # flux at a cell IS the plus-side flux of its neighbor,
                # so each edge-flux field is computed ONCE and its
                # shifted view supplies the minus side — bit-identical to
                # evaluating both, at ~half the work.
                #   F(m,n) = (ud(m)+ud(m+1))(u(m)+u(m+1))/4
                #   G(m,n) = (vd(m)+vd(m+1))(u(n)+u(n+1))luu/4
                #   K(m,n) = (vd(n)+vd(n+1))(v(n)+v(n+1))/4
                #   L(m,n) = (ud(n)+ud(n+1))(v(m)+v(m+1))/4
                F2 = (ud3 + S(ud3, 1, 0)) * (u8 + S(u8, 1, 0)) * 0.25
                G2 = (vd3 + S(vd3, 1, 0)) * (S(u8, 0, 1) + u8) \
                    * (luu2f * 0.25)
                K2 = (vd3 + S(vd3, 0, 1)) * (v8 + S(v8, 0, 1)) * 0.25
                L2 = (ud3 + S(ud3, 0, 1)) * (S(v8, 1, 0) + v8) * 0.25
                # vorticity double-terms telescope the same way; the
                # (v+v_x1)/(u+u_y1) factors are shared with Coriolis
                s2v = S(v8, 1, 0) + v8
                s2u = S(u8, 0, 1) + u8
                H2 = vorth2 * s2v              # rx term; + H2(n-1)
                M2 = vorth2 * s2u              # ry term; + M2(m-1)

                rx_adv1 = jnp.where(
                    wlcu1,
                    -(F2 - S(F2, -1, 0) + G2 - S(G2, 0, -1))
                    + (H2 + S(H2, 0, -1)) * 0.25,
                    0.0)
                ry_adv1 = jnp.where(
                    wlcv1,
                    -(L2 - S(L2, -1, 0) + K2 - S(K2, 0, -1))
                    - (M2 + S(M2, -1, 0)) * 0.25,
                    0.0)
            else:
                rx_adv1 = 0.0
                ry_adv1 = 0.0
                if not fast:
                    s2v = S(v8, 1, 0) + v8
                    s2u = S(u8, 0, 1) + u8

            # ---- lateral viscosity (stress_components + uv_diff2) ----
            if visc:
                q3 = up8 * MT(13)
                r3 = vp8 * MT(12)
                s1 = up8 * MT(10)
                s2 = vp8 * MT(11)
                if fast:
                    # static masks as 0/1 multiplies; dy/dx & dx/dy are
                    # profile rows 19/20; the rx/ry selects are dropped
                    # (un1 re-selects)
                    str_t2 = (MT(19) * (q3 - S(q3, -1, 0))
                              - MT(20) * (r3 - S(r3, 0, -1))) * SP("wlu")
                    wluu_v = WLUU_f()
                else:
                    dy_dx = MT(1) / MT(0)   # profile mode: row ratios,
                    dx_dy = MT(0) / MT(1)   # divisions touch Ys points
                    str_t2 = jnp.where(
                        LU() > 0.5,
                        dy_dx * (q3 - S(q3, -1, 0))
                        - dx_dy * (r3 - S(r3, 0, -1)),
                        0.0)
                    wluu_v = WLUU()
                str_s2 = jnp.where(
                    wluu_v,
                    (MT(6) * MT(15)) * (S(s1, 0, 1) - s1)
                    + (MT(7) * MT(14)) * (S(s2, 1, 0) - s2), 0.0)
                hq2 = hr8 + ssh8 * float(ffs)
                t2 = hq2 * str_t2              # shared T-point stress
                a2 = (MT(1) * MT(1) * mu_const) * t2
                b2 = (MT(0) * MT(0) * mu_const) * t2
                # H-point stress terms telescope (uv_diff2_kernel): the
                # minus side is the same field at (n-1)/(m-1) — shifting
                # the product also shifts its metric factor, exactly as
                # the reference evaluates dxb/dyb at the shifted point
                hs2 = hh3 * str_s2
                D2 = (MT(6) * MT(6) * mu_const) * hs2
                E2 = (MT(7) * MT(7) * mu_const) * hs2
                rx_dif1 = (S(a2, 1, 0) - a2) * MT(13) \
                    + (D2 - S(D2, 0, -1)) * MT(10)
                ry_dif1 = -(S(b2, 0, 1) - b2) * MT(12) \
                    + (E2 - S(E2, -1, 0)) * MT(11)
                if not fast:
                    rx_dif1 = jnp.where(wlcu1, rx_dif1, 0.0)
                    ry_dif1 = jnp.where(wlcv1, ry_dif1, 0.0)
            else:
                rx_dif1 = 0.0
                ry_dif1 = 0.0

            # ---- momentum update (sw_update_uv) ----
            hu1 = hu3
            hv1 = hv3

            if not (fast and trans):
                # Coriolis double-terms telescope like the advection
                # ones: C2v(n-1) / C2u(m-1) are the second summands.
                # (In the fast+trans path these merged into acx1/acy1.)
                if fast:
                    # row 21 = rlh_s*dxb*dyb*0.25 — the 1/4 folds into
                    # the precomputed profile
                    corio2 = MT(21) * hh3
                else:
                    corio2 = (MT(8) * MT(6) * MT(7)) * hh3
                C2v = corio2 * s2v
                C2u = corio2 * s2u
                cpair_x = C2v + S(C2v, 0, -1)
                cpair_y = C2u + S(C2u, -1, 0)
                if not fast:
                    cpair_x = cpair_x * 0.25
                    cpair_y = cpair_y * 0.25

            if fast:
                # hu/hv carry dyh/dxh already; the 0-division at all-land
                # points yields inf/nan in the *discarded* select branch.
                # The bp metric factor cancels between numerator and
                # denominator:
                #   (up*bp0 + grx)/bp = (up*hup + grx*2tau/dxt)/hu
                # so the update costs one full-array multiply less per
                # component; 2tau/dxt is a (1, Ys) row.
                slx = (S(ssh8, 1, 0) - ssh8) * hu1 * g_s
                sly = (S(ssh8, 0, 1) - ssh8) * hv1 * g_s
                if trans:
                    grx = slx + rx_dif1 + acx1
                    gry = sly + ry_dif1 + acy1
                else:
                    grx = slx + rx_dif1 + cpair_x
                    gry = sly + ry_dif1 - cpair_y
                un1 = jnp.where(
                    wlcu1,
                    (up8 * hup1 + grx * (tau_n * MT(10))) / hu1, 0.0)
                vn1 = jnp.where(
                    wlcv1,
                    (vp8 * hvp1 + gry * (tau_n * MT(11))) / hv1, 0.0)
            else:
                bpm_u = MT(2) * MT(5) * inv2tau  # dxt*dyh/2tau
                bpm_v = MT(3) * MT(4) * inv2tau  # dyt*dxh/2tau
                bp_u = hu1 * bpm_u          # hhun == hhu (see docstring)
                bp0_u = hup1 * bpm_u
                slx = (S(ssh8, 1, 0) - ssh8) * hu1 * (MT(5) * (-g))
                grx = slx + rx_dif1 + rx_adv1 + cpair_x
                un1 = jnp.where(
                    wlcu1,
                    (up8 * bp0_u + grx) / jnp.where(wlcu1, bp_u, 1.0),
                    0.0)
                bp_v = hv1 * bpm_v
                bp0_v = hvp1 * bpm_v
                sly = (S(ssh8, 0, 1) - ssh8) * hv1 * (MT(4) * (-g))
                gry = sly + ry_dif1 + ry_adv1 - cpair_y
                vn1 = jnp.where(
                    wlcv1,
                    (vp8 * bp0_v + gry) / jnp.where(wlcv1, bp_v, 1.0),
                    0.0)

            # ---- leapfrog rotation + filter (sw_next_step) ----
            if fast:
                wlu0 = SP("ludxdy") > 0.5
                if not elide_sel:
                    wlcu0 = WLCU_f()
                    wlcv0 = WLCV_f()
            else:
                wlu0 = LU() > 0.5
                wlcu0 = WLCU()
                wlcv0 = WLCV()

            # filter rewritten as f + ts2*(n - 2f + p) = (1-ts)*f
            # + ts2*(n + p): one op fewer per filtered field
            ts2 = ts * 0.5                  # trace-time constant folds
            ts1 = 1.0 - ts
            ssh_new0 = jnp.where(wlu0, sshn2, ssh8)
            sshp_new0 = jnp.where(
                wlu0, ts1 * ssh8 + ts2 * (sshn2 + sshp8), sshp8)
            if elide_sel:
                # The velocity selects are REDUNDANT given the land-zero
                # invariant (pack masks u/up by wlcu, v/vp by wlcv; land
                # velocities are never written — sw_next_step only
                # updates wlcu/wlcv points): at non-wlcu cells un1's own
                # select yields 0 == u0, and the filter of three zeros
                # is 0 == up0, so dropping the four wheres is BIT-EXACT.
                # (ssh keeps its selects: sshn2 is nonzero on land cells
                # adjacent to wet — the flux divergence reaches them.)
                u_new0, up_new0 = un1, ts1 * u8 + ts2 * (un1 + up8)
                v_new0, vp_new0 = vn1, ts1 * v8 + ts2 * (vn1 + vp8)
            else:
                u_new0 = jnp.where(wlcu0, un1, u8)
                up_new0 = jnp.where(
                    wlcu0, ts1 * u8 + ts2 * (un1 + up8), up8)
                v_new0 = jnp.where(wlcv0, vn1, v8)
                vp_new0 = jnp.where(
                    wlcv0, ts1 * v8 + ts2 * (vn1 + vp8), vp8)
            new_state = (ssh_new0, sshp_new0, u_new0, up_new0,
                         v_new0, vp_new0)

            # ---- tracer pass (expl_tracer, runs after the SW step) ----
            new_tracers = []
            if n_tracers:
                # post-step depths: hh_init from the NEW (ssh, sshp) sets
                # hhu = interp(h_r + ssh_new), hhq_n = h_r,
                # hhq_p = h_r + sshp_new (tracer_interface.f90 bindings)
                if fast:
                    # land values of sshn2 are killed by the ludxdy plane
                    if ffs and hrc is not None:
                        aq_new2 = (sshn2 + hrc) * SP("ludxdy")
                    elif ffs:
                        aq_new2 = sshn2 * SP("ludxdy") + SP("hrludxdy")
                    else:
                        aq_new2 = SP("hrludxdy")
                else:
                    ssh_new2 = jnp.where(LU() > 0.5, sshn2, ssh8)
                    aq_new2 = (hr8 + ssh_new2 * float(ffs)) \
                        * (MT(0) * MT(1)) * LU()
                hun1 = interp_u(aq_new2)
                hvn1 = interp_v(aq_new2, S(aq_new2, 0, 1))
                u_new1 = jnp.where(wlcu1, un1, u8)
                v_new1 = jnp.where(wlcv1, vn1, v8)

                diffusive = mu_const != 0.0
                if fast:
                    # flux masks hoisted onto the tracer-independent
                    # transport products (wlcu1/wlcv1 are the derived
                    # rslu-encoded masks)
                    uh1 = jnp.where(wlcu1, u_new1 * hun1, 0.0)
                    vh1 = jnp.where(wlcv1, v_new1 * hvn1, 0.0)
                    if diffusive:
                        hun1m = jnp.where(wlcu1, hun1, 0.0)
                        hvn1m = jnp.where(wlcv1, hvn1, 0.0)
                # (mu+mu)/2 * factor(=1) * dyh/dxt; in fast mode the
                # dyh/dxh ride inside hun1/hvn1 already (and with q4 so
                # does a 1/4 — compensated exactly in the scalar)
                mu_c = 4.0 * mu_const if q4 else mu_const
                mu_x = mu_c * (MT(10) if fast else MT(5) * MT(10))
                mu_y = mu_c * (MT(11) if fast else MT(4) * MT(11))
                # leapfrog update (tran_diff_tracer_kernel):
                # bp = hhq_n*area/2tau with hhq_n = h_r,
                # bp0 with hhq_p = h_r + sshp_new*ffs
                area0 = MT(0) * MT(1) * inv2tau
                bp = hr8 * area0
                bp0 = (hr8 + sshp_new0 * float(ffs)) * area0
                bp_g = bp if fast else jnp.where(wlu0, bp, 1.0)
                for t in range(n_tracers):
                    ff2 = tracers[2 * t]
                    ffp0 = tracers[2 * t + 1]
                    # fluxes (tran_diff_fluxes_kernel): advective +
                    # diffusive
                    dfdx = S(ff2, 1, 0) - ff2
                    dfdy = S(ff2, 0, 1) - ff2
                    if fast:
                        adv_s = -2.0 if q4 else -0.5
                        fx1 = uh1 * ((ff2 + S(ff2, 1, 0)) * adv_s)
                        fy1 = vh1 * ((ff2 + S(ff2, 0, 1)) * adv_s)
                        if diffusive:
                            fx1 = fx1 + mu_x * hun1m * dfdx
                            fy1 = fy1 + mu_y * hvn1m * dfdy
                    else:
                        fx1 = jnp.where(
                            wlcu1,
                            (u_new1 * hun1) * (ff2 + S(ff2, 1, 0))
                            * (MT(5) * -0.5)
                            + mu_x * hun1 * dfdx, 0.0)
                        fy1 = jnp.where(
                            wlcv1,
                            (v_new1 * hvn1) * (ff2 + S(ff2, 0, 1))
                            * (MT(4) * -0.5)
                            + mu_y * hvn1 * dfdy, 0.0)
                    rhs = (fx1 - S(fx1, -1, 0) + fy1 - S(fy1, 0, -1))
                    ffn0 = jnp.where(
                        wlu0, (bp0 * ffp0 + rhs) / bp_g, 0.0)
                    # filter + rotation (tracer_next_step_kernel); with
                    # elide_sel the land selects drop (ffn0 is already
                    # wlu0-selected to 0 and pack masks ff/ffp by wlu,
                    # so the land filter is 0 == ffp0 — bit-exact)
                    if elide_sel:
                        new_tracers.append(ffn0)
                        new_tracers.append(
                            ts1 * ff2 + ts2 * (ffn0 + ffp0))
                    else:
                        new_tracers.append(jnp.where(wlu0, ffn0, ff2))
                        new_tracers.append(jnp.where(
                            wlu0, ts1 * ff2 + ts2 * (ffn0 + ffp0),
                            ffp0))

            # ---- per-step stability reduction (check_ssh_err_kernel,
            # vel_ssh.f90:40-67 — the reference checks EVERY step) ----
            stepmax = jnp.max(jnp.abs(ssh_new0[gr]))
            return (new_state, new_tracers, stepmax,
                    (hu3, hv3, hup1, hvp1))

        mx = jnp.zeros((), jnp.float32)
        dep = None
        for _ in range(steps_per_call):
            state, tracers, stepmax, dep_out = one_step(
                state, tracers, prev_dep=dep)
            if share_prev:
                dep = dep_out
            mx = jnp.maximum(mx, stepmax)
        return tuple(state), tuple(tracers), mx

    return advance


def build_fused_sw_step(lay: FusedLayout, lu_s, hhq_rest_s, metrics_profile,
                        tau: float, time_smooth: float, ffs: int,
                        trans: int, ksw: int, mu_const: float = 0.0,
                        n_tracers: int = 0, metrics_2d: bool = False,
                        rslu_planes=None, steps_per_call: int = 1,
                        guard_y_margin: bool = False,
                        hr_const: float | None = None,
                        elide_sel: bool = False, q4: bool = False,
                        share_prev: bool = False, fast2d: bool = False,
                        met_map: dict | None = None):
    """Returns the fused step on fused-layout arrays; each call advances
    ``steps_per_call`` model steps (see module docstring). Every step
    function returns ``(fields_tuple, ssh_max)`` where ``ssh_max`` is the
    running max of |ssh| over the domain across ALL chained steps — the
    per-step stability guard (check_ssh_err_kernel, vel_ssh.f90:40-67).
    ``guard_y_margin``: the layout has wet y-margins (sharded driver)
    that the reduction must exclude.

    With ``lu_s`` given: ``step(ssh, sshp, u, up, v, vp, *tracers)`` where
    tracers = ff_0, ffp_0, ff_1, ... With ``lu_s=None``: the raw form
    ``step(lu, hr, met, [planes,] ssh, ...)`` for the sharded drivers
    (``rslu_planes=True`` then means the planes arrive at call time).

    ``metrics_profile``: (N_PROF, Ys) float32 rows =
    [dx, dy, dxt, dyt, dxh, dyh, dxb, dyb, rlh_s, <derived>] latitude
    profiles (x-uniform metrics), or with ``metrics_2d=True`` the
    (n, Xs, Ys) full planes from :func:`metrics_full_from_grid` — the
    bipolar / curvilinear-grid path (grid_parameters.f90:183).

    ``rslu_planes``: the (n, Xs, Ys) static planes from
    :func:`static_planes` (fast mode).
    """
    static_rslu = rslu_planes is not None and rslu_planes is not False
    advance = _make_advance(
        lay, tau, time_smooth, ffs, trans, ksw, mu_const, n_tracers,
        metrics_2d=metrics_2d, static_rslu=static_rslu,
        steps_per_call=steps_per_call,
        guard_col=lay.margin if guard_y_margin else 0,
        hr_const=hr_const, elide_sel=elide_sel, q4=q4,
        share_prev=share_prev, fast2d=fast2d, met_map=met_map)

    def run(lu_a, hr_a, met_a, planes_a, fields):
        state, tracers, mx = advance(lu_a, hr_a, met_a, planes_a,
                                     tuple(fields[:6]), tuple(fields[6:]))
        return state + tracers, mx

    if lu_s is None:
        if static_rslu:
            assert rslu_planes is True, \
                "raw form takes planes at call time (rslu_planes=True)"

            def step_raw(lu_a, hr_a, met_a, planes_a, *fields):
                return run(lu_a, hr_a, met_a, planes_a, fields)
            return step_raw

        def step_raw(lu_a, hr_a, met_a, *fields):
            return run(lu_a, hr_a, met_a, None, fields)
        return step_raw

    lu = jnp.asarray(lu_s, jnp.float32)
    hr = jnp.asarray(hhq_rest_s, jnp.float32)
    met = jnp.asarray(metrics_profile, jnp.float32)
    planes = (jnp.asarray(rslu_planes, jnp.float32) if static_rslu
              else None)

    def step(*fields):
        return run(lu, hr, met, planes, fields)

    return step


def staggered_wet_masks(lu) -> tuple:
    """(wlcu, wlcv, wlu) float32 0/1 masks from a T-point wet mask in
    any layout — the staggered-gridpoint wet sets (grid_kernels.f90:
    40-92 lcu/lcv/lu) used by the drivers' elide_sel pack masking."""
    lu_b = np.asarray(lu) > 0.5
    x1 = np.zeros_like(lu_b)
    x1[:-1] = lu_b[1:]
    y1 = np.zeros_like(lu_b)
    y1[:, :-1] = lu_b[:, 1:]
    return ((lu_b & x1).astype(np.float32),
            (lu_b & y1).astype(np.float32),
            lu_b.astype(np.float32))


def metrics_profile_from_grid(grid, lay: FusedLayout) -> np.ndarray:
    """Extract the (N_PROF, Ys) latitude profiles from a Grid; raises if
    any metric is not x-uniform (then use the jnp path)."""
    rows = np.zeros((N_PROF, lay.Ys), np.float32)
    names = ["dx", "dy", "dxt", "dyt", "dxh", "dyh", "dxb", "dyb", "rlh_s"]
    for k, name in enumerate(names):
        f = np.asarray(getattr(grid, name))
        if not np.allclose(f, f[:1, :], rtol=0, atol=0):
            raise ValueError(f"metric {name} is not x-uniform; "
                             "fused path unsupported (use jnp step)")
        yp = lay.ypad
        rows[k, yp:yp + lay.ny] = f[0, :]
        # extend profiles into the y land margin so divisions stay finite
        rows[k, :yp] = f[0, 0]
        rows[k, yp + lay.ny:] = f[0, -1]
    # rows 9-15: reciprocal profiles — metric divisions become multiplies
    with np.errstate(divide="ignore"):
        rows[9] = np.float32(1.0) / (rows[0] * rows[1])   # 1/(dx*dy)
        for k, src in ((10, 2), (11, 3), (12, 4), (13, 5), (14, 6),
                       (15, 7)):
            rows[k] = np.float32(1.0) / rows[src]
        # rows 16-21 (fast mode): vorticity metric differences (carrying
        # the advection 1/4 so vort/H2/M2 arrive pre-scaled and merge
        # with the MT21-folded Coriolis terms), stress ratios, and the
        # 0.25-folded Coriolis product
        rows[16] = (rows[3] - rows[7]) * np.float32(0.25)  # (dyt-dyb)/4
        rows[17] = (np.concatenate([rows[2][1:], rows[2][-1:]])
                    - rows[6]) * np.float32(0.25)
        rows[18] = (rows[2] - rows[6]) * np.float32(0.25)  # (dxt-dxb)/4
        rows[19] = rows[1] / rows[0]                      # dy/dx
        rows[20] = rows[0] / rows[1]                      # dx/dy
        rows[21] = rows[8] * rows[6] * rows[7] * np.float32(0.25)
    bad = ~np.isfinite(rows[9:])
    rows[9:][bad] = 0.0
    return rows


def static_planes(lu_s: np.ndarray, hr_s: np.ndarray, dxdy: np.ndarray,
                  names: tuple, interp_recips=None) -> np.ndarray:
    """(len(names), Xs, Ys) static planes, pure functions of the land
    mask / bathymetry / metrics — see :func:`plane_names`. Precomputing
    them removes the per-step mask/select recomputes and the aq
    metric/gating muls from the hot loop.
    ``dxdy``: (Xs, Ys) full plane or (1, Ys) y-profile row.
    ``interp_recips``: fast mode only — ((1,Ys) rows 1/dxt, 1/dyt,
    1/(dxb*dyb)) folded into the rslu planes so each depth interpolation
    costs one multiply instead of two."""
    lu = np.asarray(lu_s, np.float32)
    x1 = np.zeros_like(lu)
    x1[:-1, :] = lu[1:, :]          # lu[i+1, j]
    y1 = np.zeros_like(lu)
    y1[:, :-1] = lu[:, 1:]          # lu[i, j+1]
    xy1 = np.zeros_like(lu)
    xy1[:-1, :-1] = lu[1:, 1:]      # lu[i+1, j+1]

    def recip(s):
        return np.float32(1.0) / np.maximum(s, 1.0)

    if interp_recips is not None:
        r_u, r_v, r_h = (np.asarray(r, np.float32) for r in interp_recips)
    else:
        r_u = r_v = r_h = np.float32(1.0)

    ludxdy = (lu * np.asarray(dxdy, np.float32)).astype(np.float32)
    if "ludxdy" in names:
        wet = ludxdy[lu > 0.5]
        assert wet.size == 0 or wet.min() > 0.5, \
            "dx*dy too small for ludxdy to double as the wlu mask"
    build = {
        "rslu_u": lambda: recip(lu + x1) * r_u,
        "rslu_v": lambda: recip(lu + y1) * r_v,
        "rslu_h": lambda: recip(lu + x1 + y1 + xy1) * r_h,
        "wlu": lambda: lu,
        "ludxdy": lambda: ludxdy,
        "hrludxdy": lambda: (np.asarray(hr_s, np.float32)
                             * ludxdy).astype(np.float32),
    }
    return np.stack([build[n]() for n in names]).astype(np.float32)


def fast2d_met_rows(trans: int, visc: bool, n_tracers: int) -> tuple:
    """Metric-plane rows the fast mode consumes for a config — the
    2D-metrics fast path keeps only these (a pruned stack instead of
    all 16/22 planes). Row meanings match
    :func:`metrics_profile_from_grid`."""
    rows = {9, 10, 11, 21}
    if trans:
        rows |= {14, 15, 16, 17, 18}
    if visc:
        rows |= {0, 1, 6, 7, 12, 13, 14, 15, 19, 20}
    if n_tracers:
        rows |= {0, 1}
    return tuple(sorted(rows))


def metrics_full_from_grid(grid, lay: FusedLayout,
                           derived: bool = False) -> np.ndarray:
    """(16, Xs, Ys) full metric planes for the 2D-metrics fused path
    (bipolar / curvilinear grids, grid_parameters.f90:183 — metrics vary
    in both directions). Margins are edge-replicated so reciprocals stay
    finite; plane order matches :func:`metrics_profile_from_grid`.
    ``derived=True`` (the fast-2D path) appends rows 16-21 — the
    vorticity metric differences, stress ratios, and 0.25-folded
    Coriolis product — computed pointwise exactly as the profile builder
    does per latitude."""
    M = lay.margin
    n = 22 if derived else 16
    planes = np.zeros((n, lay.Xs, lay.Ys), np.float32)
    names = ["dx", "dy", "dxt", "dyt", "dxh", "dyh", "dxb", "dyb", "rlh_s"]
    for k, name in enumerate(names):
        f = np.asarray(getattr(grid, name), np.float32)
        p = planes[k]
        yp = lay.ypad
        p[M:M + lay.nx, yp:yp + lay.ny] = f
        # edge-replicate into the margins (y first, then x rows cover
        # the corners too)
        p[M:M + lay.nx, :yp] = f[:, :1]
        p[M:M + lay.nx, yp + lay.ny:] = f[:, -1:]
        p[:M, :] = p[M, :]
        p[M + lay.nx:, :] = p[M + lay.nx - 1, :]
    with np.errstate(divide="ignore"):
        planes[9] = np.float32(1.0) / (planes[0] * planes[1])
        for k, src in ((10, 2), (11, 3), (12, 4), (13, 5), (14, 6),
                       (15, 7)):
            planes[k] = np.float32(1.0) / planes[src]
        if derived:
            planes[16] = (planes[3] - planes[7]) * np.float32(0.25)
            dxt_n1 = np.concatenate(
                [planes[2][:, 1:], planes[2][:, -1:]], axis=1)
            planes[17] = (dxt_n1 - planes[6]) * np.float32(0.25)
            planes[18] = (planes[2] - planes[6]) * np.float32(0.25)
            planes[19] = planes[1] / planes[0]
            planes[20] = planes[0] / planes[1]
            planes[21] = planes[8] * planes[6] * planes[7] \
                * np.float32(0.25)
    planes[9:][~np.isfinite(planes[9:])] = 0.0
    return planes
