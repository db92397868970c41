"""Fused step over a full 2D device mesh.

Generalizes model/fused_sharded.py (x-only) to P("x", "y") sharding: each
exchange the prognostic shards swap M-row x-margins and M-column
y-margins with their mesh neighbours in two ppermute passes (the y-pass
runs on the x-margined array, so corner margins arrive from the diagonal
neighbour — the same composition as parallel/halo.py), then every shard
runs the whole-step update on its (xl+2M, yl+2M) margined block.

Margin-width safety: the step's shifts read zeros past the block edge;
that edge error creeps inward by the cumulative stencil reach (<= 4
cells) per step, so M = 4*steps_per_call-cell margins cover all chained
model steps per exchange — dividing the per-step collective count by
steps_per_call.

Full config envelope (matching the reference's GPU layer covering every
configuration, gpu/interface/sw_interface_gpu.f90):

- fast mode (static mask/reciprocal planes) whenever metrics are
  x-uniform — the same planes as the single-device driver, built globally
  and sliced per shard so seams are exact;
- 2D metric planes (bipolar / curvilinear grids,
  grid_parameters.f90:183): per-shard (16, xl+2M, yl+2M) blocks;
- periodic basins: the margin exchange adds the wrap ppermute pair (or a
  local wrap concatenate on 1-shard axes) and the static margins are
  wrap-padded; requires the periodic axis to be exactly mesh-divisible
  (no padding between the seam neighbours).

Weighted decomposition (``weighted=True``, parallel.par
mod_decomposition=1): the cut lines in BOTH axes follow the wet-point
cumulative distribution (parallel/decomposition.py::weighted_x_edges /
weighted_y_edges) instead of an even split — the applied form of the
reference's 2D weighted block assignment (core/decomposition.f90:532-669,
which balances a bnx x bny block grid). Shards get unequal valid extents
(padded to common local extents); the margin exchange slices each shard's
edge strips at its own dynamic offsets. Every shard computes its whole
padded block, land included, so the cuts balance wet points, not work.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import ModelConfig
from ..core.grid import Grid
from ..core.state import SWState
from ..ops import sw_kernels as swk
from ..ops import fused_step as fsk
from ..parallel.decomposition import weighted_x_edges, weighted_y_edges


class FusedSharded2DModel:
    """Fused model sharded over a px * py mesh."""

    def __init__(self, grid: Grid, cfg: ModelConfig, tau: float,
                 px: int, py: int, devices=None, mu_const: float = 0.0,
                 static_rslu: bool = True, steps_per_call: int = 1,
                 weighted: bool = False, x_edges=None, y_edges=None,
                 elide_sel: bool | None = None, q4: bool | None = None,
                 share_prev: bool | None = None,
                 fast2d: bool | None = None):
        """``weighted``: equal-wet cut lines (mod_decomposition=1).
        ``x_edges``/``y_edges``: explicit cut lines (len px+1 / py+1,
        spanning [0, nx] / [0, ny]) — parallel.par mod_decomposition=2,
        cuts read back from a decomposition.txt file
        (parallel/decomposition.py::read_decomposition)."""
        self.grid = grid
        self.cfg = cfg
        self.px, self.py = px, py
        if devices is None:
            devices = jax.devices()[:px * py]
        self.mesh = Mesh(np.array(devices).reshape(px, py), ("x", "y"))

        self.periodic_x = bool(grid.periodic_x)
        self.periodic_y = bool(grid.periodic_y)
        # margin width in both axes: 4 cells of stencil reach per
        # chained step, so deeper chaining widens the exchanged strips
        # instead of adding exchanges
        M = self.M = fsk.margin_for(steps_per_call)
        int_mask = (np.asarray(grid.lu) < 0.5).astype(np.int32)
        # ---- x cut lines ------------------------------------------------
        if x_edges is not None:
            edges = np.asarray(x_edges, np.int64)
            if len(edges) != px + 1:      # user-editable file input —
                raise ValueError(         # must survive python -O
                    f"x_edges has {len(edges)} entries for a px={px} "
                    "mesh (need px+1)")
        elif weighted and px > 1:
            # equal-wet x cut lines; local pad (not global) absorbs the
            # unequal band widths
            edges = weighted_x_edges(int_mask, px, min_width=M)
        else:
            xl = -(-grid.nx // px)
            edges = np.arange(px + 1, dtype=np.int64) * xl
        self.x_edges = edges
        lx = np.diff(edges).astype(np.int64)          # valid rows/shard
        Xpad = int(lx.max())                          # common local extent
        # ---- y cut lines ------------------------------------------------
        if y_edges is not None:
            y_edges = np.asarray(y_edges, np.int64)
            if len(y_edges) != py + 1:
                raise ValueError(
                    f"y_edges has {len(y_edges)} entries for a py={py} "
                    "mesh (need py+1)")
        elif weighted and py > 1:
            y_edges = weighted_y_edges(int_mask, py, min_width=M)
        else:
            yl_u = -(-grid.ny // py)
            y_edges = np.arange(py + 1, dtype=np.int64) * yl_u
        self.y_edges = y_edges
        ly = np.diff(y_edges).astype(np.int64)        # valid cols/shard
        Ymax = int(ly.max())                          # common local extent
        # shards need dynamic-offset margin handling whenever any valid
        # extent differs from the padded one (weighted or file cuts)
        self.weighted_x = px > 1 and bool((lx != Xpad).any())
        self.weighted_y = py > 1 and bool((ly != Ymax).any())
        if int(lx.min()) < M or int(ly.min()) < M:
            raise ValueError(
                f"shards must be at least {M} cells wide for the margin "
                f"exchange (got {lx.min()}x{ly.min()}); use a smaller mesh")
        if self.periodic_x and int(edges[-1]) != grid.nx:
            raise ValueError(
                f"periodic x needs nx divisible by px "
                f"(nx={grid.nx}, px={px})")
        if self.periodic_y and int(y_edges[-1]) != grid.ny:
            raise ValueError(
                f"periodic y needs ny divisible by py "
                f"(ny={grid.ny}, py={py})")
        self.lx, self.ly = lx, ly
        self.Xpad, self.Ymax = Xpad, Ymax
        self.Eg = int(edges[-1])     # global x extent spanned by the cuts
        self.Yg = int(y_edges[-1])   # global y extent spanned by the cuts
        # static arrays must cover every shard's FULL padded window with
        # land-consistent values: zero-filled pads would read as "wet" in
        # the step's encoded mask compares (0 < threshold) and breed
        # 0-division garbage next to weighted-cut margins
        self.Exg = max(self.Eg, int(max(edges[i] + Xpad
                                        for i in range(px))))
        self.Eyg = max(self.Yg, int(max(y_edges[j] + Ymax
                                        for j in range(py))))
        Ysp = Ymax + 2 * M
        self.Ysp = Ysp
        self.lay = fsk.FusedLayout(nx=grid.nx, ny=grid.ny, X=Xpad,
                                   Xs=Xpad + 2 * M, Ys=Ysp, margin=M)

        # ---- global -> per-shard margined statics -----------------------
        if (self.periodic_x and self.Exg != grid.nx) or \
                (self.periodic_y and self.Eyg != grid.ny):
            raise ValueError("periodic axes need pad-free weighted cuts; "
                             "use uniform decomposition on this mesh")

        def pad2(g):
            """(Exg, Eyg) -> (Exg+2M, Eyg+2M) margins: wrapped on
            periodic axes (seam adjacency), land zeros elsewhere."""
            g = np.pad(g, ((M, M), (0, 0)),
                       mode="wrap" if self.periodic_x else "constant")
            return np.pad(g, ((0, 0), (M, M)),
                          mode="wrap" if self.periodic_y else "constant")

        def shard4(gp, lead=0, box=False):
            """Margined global (..., Exg+2M, Eyg+2M) -> per-shard
            blocks (px, py, ..., Xpad+2M, Ysp): every shard slices its
            FULL window (valid + margins + pad, land-consistent).

            ``box=True`` (mask-like fields): force LAND beyond each
            shard's (valid + 2M-margin) box. The persistent margined
            carry (make_runner) refreshes only 2M strips per exchange;
            cells beyond the box then carry stale values — land-boxed
            masks make the step's output selects copy those cells
            through unchanged (exact zeros from pack time), so they can
            never evolve, blow up, or reach the stability guard."""
            out = np.zeros((px, py) + gp.shape[:lead]
                           + (Xpad + 2 * M, Ysp), np.float32)
            h = Ymax + 2 * M
            for i in range(px):
                for j in range(py):
                    out[i, j, ..., :, :h] = \
                        gp[..., edges[i]: edges[i] + Xpad + 2 * M,
                           y_edges[j]: y_edges[j] + h]
                    if box:
                        out[i, j, ..., int(lx[i]) + 2 * M:, :] = 0.0
                        out[i, j, ..., :, int(ly[j]) + 2 * M:] = 0.0
            return out

        def glob(field2d):
            g = np.zeros((self.Exg, self.Eyg), np.float32)
            g[:grid.nx, :grid.ny] = np.asarray(field2d)
            return g

        lu_gp = pad2(glob(grid.lu))
        hr_gp = pad2(glob(grid.hhq_rest))
        lu_sh = shard4(lu_gp, box=True)
        hr_sh = shard4(hr_gp, box=True)
        self.lu_shards = jnp.asarray(lu_sh)
        self.hr_shards = jnp.asarray(hr_sh)

        # per-shard valid extents
        self.lx_arr = jnp.asarray(lx.astype(np.int32))
        self.ly_arr = jnp.asarray(ly.astype(np.int32))

        # ---- metrics: y-profiles (x-uniform) or full 2D planes ----------
        try:
            gprof = self._global_profiles(grid)       # (N_PROF, ny)
            self.metrics_2d = False
        except ValueError:
            self.metrics_2d = True
        self.fast2d = (bool(static_rslu) and self.metrics_2d
                       if fast2d is None
                       else bool(fast2d))
        if self.fast2d and not (static_rslu and self.metrics_2d):
            raise ValueError("fast2d requires static_rslu and 2D metrics")
        met_sh = prof_sh = None
        self._met_map = None
        if self.metrics_2d:
            met_g = self._global_planes(grid, derived=self.fast2d)
            if self.fast2d:
                # keep only the consumed metric rows (fast2d_met_rows)
                visc2 = bool(cfg.sw.ksw_lat and mu_const)
                n_tr = (cfg.sw.tracer_num if cfg.sw.use_tracers > 0
                        else 0)
                rows = fsk.fast2d_met_rows(cfg.sw.trans_terms, visc2,
                                           n_tr)
                self._met_map = {r: i for i, r in enumerate(rows)}
                met_sh = shard4(met_g[list(rows)], lead=1)
            else:
                met_sh = shard4(met_g, lead=1)
            self._met_g = met_g        # full stack: static-plane recips
            self.met_shards = jnp.asarray(met_sh)
            met_spec = P("x", "y", None, None, None)
            prof_padded = None
        else:
            gprof = np.pad(gprof, ((0, 0), (0, self.Eyg - grid.ny)),
                           mode="edge")
            prof_padded = np.pad(gprof, ((0, 0), (M, M)),
                                 mode="wrap" if self.periodic_y
                                 else "edge")      # (N_PROF, Eyg+2M)
            prof_sh = np.zeros((py, fsk.N_PROF, Ysp), np.float32)
            h = Ymax + 2 * M
            for j in range(py):
                prof_sh[j, :, :h] = \
                    prof_padded[:, y_edges[j]: y_edges[j] + h]
            self.met_shards = jnp.asarray(prof_sh)
            met_spec = P("y", None, None)
        self._met_spec = met_spec

        self.n_tracers = (cfg.sw.tracer_num if cfg.sw.use_tracers > 0
                          else 0)
        self.mu_const = float(mu_const or 0.0)

        # ---- static mask/reciprocal planes (fast mode) -------------------
        self.static_rslu = bool(static_rslu)
        # constant bathymetry folds the hrludxdy plane into a scalar
        # (exactness needs hr constant only on wet cells — ludxdy is 0
        # elsewhere — so the physical-field check is conservative)
        hr_np = np.asarray(grid.hhq_rest, np.float32)
        self.hr_const = (float(hr_np.flat[0])
                         if np.ptp(hr_np) == 0.0 else None)
        # fast-mode reductions (see model/fused.py), default
        # ON whenever the fast mode runs (elide_sel/q4 exact in real
        # arithmetic; share_prev regroups at f32 round-off); safe
        # across shard margins — within each shard's valid+margin box the masks are
        # the true global masks (the elided filter then reproduces the
        # neighbour's own interior update bit-for-bit), and beyond the
        # box the land-boxed planes keep every cell an exact zero
        fast = self.static_rslu and (not self.metrics_2d or self.fast2d)
        self.elide_sel = fast if elide_sel is None else bool(elide_sel)
        self.q4 = fast if q4 is None else bool(q4)
        self.share_prev = (fast if share_prev is None
                           else bool(share_prev)) and steps_per_call > 1
        if (self.elide_sel or self.q4 or self.share_prev) and not fast:
            raise ValueError("elide_sel/q4/share_prev require fast mode")
        if self.static_rslu:
            names = fsk.plane_names(
                cfg.sw.full_free_surface, cfg.sw.ksw_lat, self.mu_const,
                self.metrics_2d,
                hr_const=(self.hr_const
                          if (not self.metrics_2d or self.fast2d)
                          else None),
                fast2d=self.fast2d)
            # planes are built PER SHARD from the land-boxed lu/hr
            # slices (see shard4): beyond each shard's valid+margin box
            # the rslu/ludxdy planes then take their LAND values, so the
            # step's encoded-mask compares read land there and the
            # persistent carry's stale cells are copy-through no-ops
            planes = np.zeros((px, py, len(names), Xpad + 2 * M, Ysp),
                              np.float32)
            # q4 folds the advection 1/4 into the u/v interp recips
            # (exact power-of-two scale, compensated in the step)
            qs = np.float32(0.25 if self.q4 else 1.0)
            if self.fast2d:
                # per-shard pointwise recips for the rslu/metric folds
                # (rows 0,1 dxdy; 10,11 interp recips; 14*15 h recip)
                aux_sh = shard4(self._met_g[[0, 1, 10, 11, 14, 15]],
                                lead=1)
            for i in range(px):
                for j in range(py):
                    if self.fast2d:
                        dxdy = aux_sh[i, j, 0] * aux_sh[i, j, 1]
                        recips = (aux_sh[i, j, 2] * qs,
                                  aux_sh[i, j, 3] * qs,
                                  aux_sh[i, j, 4] * aux_sh[i, j, 5])
                    elif self.metrics_2d:
                        dxdy = met_sh[i, j, 0] * met_sh[i, j, 1]
                        recips = None
                    else:
                        dxdy = (prof_sh[j, 0] * prof_sh[j, 1])[None, :]
                        recips = (prof_sh[j, 10:11] * qs,
                                  prof_sh[j, 11:12] * qs,
                                  (prof_sh[j, 14]
                                   * prof_sh[j, 15])[None, :])
                    planes[i, j] = fsk.static_planes(
                        lu_sh[i, j], hr_sh[i, j], dxdy, names,
                        interp_recips=recips)
            self.plane_shards = jnp.asarray(planes)
        else:
            self.plane_shards = None
        if hasattr(self, "_met_g"):
            del self._met_g        # full metric stack: init-time only

        self.steps_per_call = int(steps_per_call)
        self.step_raw = fsk.build_fused_sw_step(
            self.lay, None, None, None, float(tau), cfg.sw.time_smooth,
            cfg.sw.full_free_surface, cfg.sw.trans_terms, cfg.sw.ksw_lat,
            mu_const=self.mu_const, n_tracers=self.n_tracers,
            metrics_2d=self.metrics_2d,
            rslu_planes=(True if self.static_rslu else None),
            steps_per_call=self.steps_per_call, guard_y_margin=True,
            hr_const=self.hr_const, elide_sel=self.elide_sel, q4=self.q4,
            share_prev=self.share_prev, fast2d=self.fast2d,
            met_map=self._met_map)

    @staticmethod
    def _global_profiles(grid: Grid) -> np.ndarray:
        """(N_PROF, ny) metric + reciprocal latitude profiles (the
        unsharded builder's layout, without the YPAD embedding)."""
        lay0 = fsk.FusedLayout(grid.nx, grid.ny, grid.nx, grid.nx,
                               grid.ny + 2 * fsk.YPAD, 0)
        rows = fsk.metrics_profile_from_grid(grid, lay0)
        return rows[:, fsk.YPAD:fsk.YPAD + grid.ny]

    def _global_planes(self, grid: Grid,
                       derived: bool = False) -> np.ndarray:
        """(16, Exg+2M, Eyg+2M) full metric planes for the 2D-metrics
        sharded path; physical edges replicated (or wrapped on periodic
        axes) so reciprocals stay finite. ``derived`` appends rows 16-21
        (fast2d: vorticity diffs, stress ratios, folded Coriolis)."""
        M = self.M
        names = ["dx", "dy", "dxt", "dyt", "dxh", "dyh", "dxb", "dyb",
                 "rlh_s"]
        planes = np.zeros((22 if derived else 16,
                           self.Exg + 2 * M, self.Eyg + 2 * M),
                          np.float32)
        for k, name in enumerate(names):
            f = np.asarray(getattr(grid, name), np.float32)
            # edge-extend over the mesh-divisible pad, then margin
            g = np.pad(f, ((0, self.Exg - grid.nx),
                           (0, self.Eyg - grid.ny)), mode="edge")
            gp = np.pad(g, ((M, M), (0, 0)),
                        mode="wrap" if self.periodic_x else "edge")
            planes[k] = np.pad(gp, ((0, 0), (M, M)),
                               mode="wrap" if self.periodic_y else "edge")
        with np.errstate(divide="ignore"):
            planes[9] = np.float32(1.0) / (planes[0] * planes[1])
            for k, src in ((10, 2), (11, 3), (12, 4), (13, 5), (14, 6),
                           (15, 7)):
                planes[k] = np.float32(1.0) / planes[src]
            if derived:
                planes[16] = (planes[3] - planes[7]) * np.float32(0.25)
                if self.periodic_y:
                    # the padded planes are wrap-consistent, so the y+1
                    # shift must wrap too (edge replication would plant
                    # a wrong dxt(n+1) exactly at the seam margin)
                    dxt_n1 = np.roll(planes[2], -1, axis=1)
                else:
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

    # ------------------------------------------------------------------
    def _pack_maps(self):
        """Precomputed (numpy, cached) gather maps between the physical
        (nx, ny) layout and the MARGINED band-major (px*Xs, py*Ysp)
        carry layout (Xs = Xpad+2M; each shard's valid data sits at
        local offset (M, M), its margins/pads at exact zeros) —
        pack/extract then cost ONE fancy-index op per field instead of
        a px*py loop of dispatches."""
        if getattr(self, "_pk", None) is not None:
            return self._pk
        nx, ny = self.grid.nx, self.grid.ny
        M = self.M
        Xs, Ys = self.Xpad + 2 * M, self.Ysp
        # band-major index -> (band, local offset)
        gr = np.arange(self.px * Xs)
        gi, gl = gr // Xs, gr % Xs - M               # local valid offset
        src_r = self.x_edges[gi] + gl                # physical row
        vr = (gl >= 0) & (gl < np.diff(self.x_edges)[gi])
        vr &= src_r < nx
        gc = np.arange(self.py * Ys)
        gj, gm = gc // Ys, gc % Ys - M
        src_c = self.y_edges[gj] + gm
        vc = (gm >= 0) & (gm < np.diff(self.y_edges)[gj])
        vc &= src_c < ny
        valid = vr[:, None] & vc[None, :]
        src_r = np.where(vr, src_r, 0)
        src_c = np.where(vc, src_c, 0)
        # physical index -> band-major index (cuts partition [0, nx))
        pr = np.arange(nx)
        bi = np.searchsorted(self.x_edges, pr, side="right") - 1
        bi = np.clip(bi, 0, self.px - 1)
        dst_r = bi * Xs + M + (pr - self.x_edges[bi])
        pc = np.arange(ny)
        bj = np.searchsorted(self.y_edges, pc, side="right") - 1
        bj = np.clip(bj, 0, self.py - 1)
        dst_c = bj * Ys + M + (pc - self.y_edges[bj])
        self._pk = (jnp.asarray(src_r), jnp.asarray(src_c),
                    jnp.asarray(valid),
                    jnp.asarray(dst_r), jnp.asarray(dst_c))
        return self._pk

    def pack(self, state: SWState):
        """State fields -> margined band-major arrays (px*Xs, py*Ysp),
        sharded P("x","y"): shard (i,j) holds band rows
        [x_edges[i], x_edges[i+1]) x columns [y_edges[j], y_edges[j+1])
        at local offset (M, M); margins/pads start as exact zeros (the
        first exchange fills the margins)."""
        src_r, src_c, valid, _, _ = self._pack_maps()

        def embed(a):
            a = jnp.asarray(a, jnp.float32)
            g = jnp.where(valid, a[src_r[:, None], src_c[None, :]], 0.0)
            return jax.device_put(
                g, NamedSharding(self.mesh, P("x", "y")))
        if self.elide_sel:
            # land-zero invariant for the elided velocity/tracer selects
            # (see model/fused.py::pack): mask once on the physical grid
            wlcu, wlcv, wlu = (jnp.asarray(m) for m in
                               fsk.staggered_wet_masks(self.grid.lu))
            fields = [state.ssh, state.sshp, state.ubrtr * wlcu,
                      state.ubrtrp * wlcu, state.vbrtr * wlcv,
                      state.vbrtrp * wlcv]
            for t in range(self.n_tracers):
                fields += [state.ff[t] * wlu, state.ffp[t] * wlu]
        else:
            fields = [state.ssh, state.sshp, state.ubrtr, state.ubrtrp,
                      state.vbrtr, state.vbrtrp]
            for t in range(self.n_tracers):
                fields += [state.ff[t], state.ffp[t]]
        return tuple(embed(a) for a in fields)

    def extract(self, carry):
        """Margined band-major carry arrays -> (nx, ny) global views."""
        _, _, _, dst_r, dst_c = self._pack_maps()
        return tuple(a[dst_r[:, None], dst_c[None, :]] for a in carry)

    # ------------------------------------------------------------------
    def make_runner(self, n_inner: int):
        M = self.M
        px, py = self.px, self.py
        spc = self.steps_per_call
        if n_inner % spc:
            raise ValueError(f"n_inner={n_inner} not a multiple of "
                             f"steps_per_call={spc}")
        fwd_x = [(i, i + 1) for i in range(px - 1)]
        bwd_x = [(i + 1, i) for i in range(px - 1)]
        fwd_y = [(i, i + 1) for i in range(py - 1)]
        bwd_y = [(i + 1, i) for i in range(py - 1)]
        if self.periodic_x and px > 1:
            fwd_x.append((px - 1, 0))
            bwd_x.append((0, px - 1))
        if self.periodic_y and py > 1:
            fwd_y.append((py - 1, 0))
            bwd_y.append((0, py - 1))
        weighted_x, weighted_y = self.weighted_x, self.weighted_y
        Xs, Ys = self.Xpad + 2 * M, self.Ysp
        dus = lax.dynamic_update_slice_in_dim
        dsl = lax.dynamic_slice_in_dim

        # Single-shard non-periodic axes need NO margin work at all:
        # their margins are land, where the step's output selects copy
        # the pack-time zeros through — zeros persist for the whole scan.
        need_x = px > 1 or self.periodic_x
        need_y = py > 1 or self.periodic_y

        def exchange(f, lxl, lyl):
            """Strip-wise margin refresh of a persistent margined
            (Xs, Ys) carry: each exchange ppermutes the M-wide edge
            strips and dynamic-update-slices them over the margins in
            place — never a full pad/concat rebuild (the reference
            likewise packs/unpacks only strips,
            syncborder_block2D_gen_all.fi:41-82). Valid rows are
            [M, M+lxl); the y-pass slices AFTER the x strips landed, so
            corner cells ride through the orthogonal neighbour exactly
            as in parallel/halo.py. ``lxl``/``lyl``: this shard's valid
            extents (weighted/file cuts make them dynamic)."""
            if weighted_x:
                # rows beyond the received strip up to Xs are not
                # exchanged when lxl < Xpad — ground them BEFORE the
                # strip writes (the update-slice clamp makes the strips
                # rewrite any overlap)
                f = dus(f, jnp.zeros((M, f.shape[1]), f.dtype),
                        M + lxl + M, 0)
            if need_x:
                if px == 1:                 # periodic wrap, local
                    low = dsl(f, lxl, M, 0)
                    high = f[M:2 * M]
                else:
                    # send: last M valid rows fwd, first M valid bwd;
                    # edge shards receive ppermute's zero fill = land
                    low = lax.ppermute(dsl(f, lxl, M, 0), "x", fwd_x)
                    high = lax.ppermute(f[M:2 * M], "x", bwd_x)
                f = dus(f, low, 0, 0)
                f = dus(f, high, M + lxl, 0) if weighted_x \
                    else dus(f, high, M + self.Xpad, 0)
            # y strips span ALL rows (including the fresh x strips ->
            # corners arrive from the diagonal neighbour)
            if need_y:
                if py == 1:                 # periodic wrap, local
                    lo = dsl(f, lyl, M, 1)
                    hi = f[:, M:2 * M]
                else:
                    lo = lax.ppermute(dsl(f, lyl, M, 1), "y", fwd_y)
                    hi = lax.ppermute(f[:, M:2 * M], "y", bwd_y)
                f = dus(f, lo, 0, 1)
                f = dus(f, hi, M + lyl, 1) if weighted_y \
                    else dus(f, hi, M + self.Ymax, 1)
            return f

        def local_fn(lu_b, hr_b, met_b, plane_b, lx_b, ly_b, carry):
            lu_l = lu_b[0, 0]
            hr_l = hr_b[0, 0]
            met_l = met_b[0, 0] if self.metrics_2d else met_b[0]
            lxl = lx_b[0] if weighted_x else self.Xpad
            lyl = ly_b[0] if weighted_y else self.Ymax
            extra = ()
            if self.static_rslu:
                extra = (plane_b[0, 0],)

            # No per-step pad re-grounding: the land-boxed static
            # planes (shard4 box=True) make every cell beyond the
            # valid+margin box a copy-through no-op, so pack-time zeros
            # persist there for the whole scan and the carry stays in
            # the margined layout end to end.
            def one(c, _):
                fields, mx = c
                fields = tuple(exchange(f, lxl, lyl) for f in fields)
                outs, smax = self.step_raw(lu_l, hr_l, met_l, *extra,
                                           *fields)
                return (tuple(outs), jnp.maximum(mx, smax)), None

            (carry, mx), _ = lax.scan(
                one, (tuple(carry), jnp.zeros((), jnp.float32)), None,
                length=n_inner // spc)
            # per-step |ssh| max (check_ssh_err cadence);
            # NaN compares False
            okl = mx < swk.SSH_ERR_BOUND
            ok = lax.psum(okl.astype(jnp.int32), ("x", "y")) == px * py
            return carry, ok

        nf = 6 + 2 * self.n_tracers
        plane_spec = (P("x", "y", None, None, None)
                      if self.static_rslu else P())
        planes = (self.plane_shards if self.static_rslu
                  else jnp.zeros((), jnp.float32))
        sharded = jax.shard_map(
            local_fn, mesh=self.mesh,
            in_specs=(P("x", "y", None, None), P("x", "y", None, None),
                      self._met_spec, plane_spec, P("x"), P("y"),
                      tuple(P("x", "y") for _ in range(nf))),
            out_specs=(tuple(P("x", "y") for _ in range(nf)), P()),
            check_vma=False,
        )

        @jax.jit
        def runner(carry):
            return sharded(self.lu_shards, self.hr_shards,
                           self.met_shards, planes, self.lx_arr,
                           self.ly_arr, tuple(carry))

        return runner
