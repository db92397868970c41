"""Top-level model driver — the analog of the reference's program model
(model.f90): config loading, mask/grid/state init, the time loop with
output cadence, the per-step stability guard, phase timers, and
checkpoint/resume.

The inner loop runs ``output_every_steps`` model steps per device-side
lax.scan invocation (the whole inter-output trajectory is one XLA
program), then returns to host for output/guard — mirroring the
reference's master-thread output block (model.f90:172-197) at the same
cadence.
"""

from __future__ import annotations

import os
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..config import (ModelConfig, load_basinpar, load_parallel,
                      load_runpar, load_sw)
from ..core.grid import Grid, build_grid
from ..core.state import SWState
from ..io import grads
from ..io.checkpoint import load_checkpoint, save_checkpoint
from ..io.mask_io import load_mask
from ..parallel.domain import crop_state
from ..parallel.mesh import make_mesh
from ..utils.calendar import model_time
from ..utils.timers import PhaseTimers
from .init import init_ocean_state
from .sharded import make_sharded_step, prepare
from .step import make_step, run_steps


# The compute paths ``OceanModel.run`` reports, chosen by select_path.
PATH_FUSED = "fused step"
PATH_FUSED_PERIODIC = "fused step, periodic (1x1 wrap)"
PATH_FUSED_SHARDED = "fused step, sharded"
PATH_JNP = "jnp composition"
PATH_JNP_SHARDED = "jnp composition, sharded"

# narrowest shard the fused-sharded driver takes: its margin at two
# chained steps per exchange (fused_step.margin_for(2))
MIN_FUSED_SHARD = 8


def fused_blockers(grid: Grid, cfg: ModelConfig,
                   mu_const: Optional[float]) -> str:
    """Why the fused step cannot run this configuration, as a
    comma-separated list (empty = it can). ``mu_const`` is the state's
    spatially-constant viscosity, or None if mu varies."""
    from .fused import fused_available
    px, py = cfg.parallel.mesh_x, cfg.parallel.mesh_y
    why = []
    if px * py > 1 and (grid.nx // px < MIN_FUSED_SHARD
                        or grid.ny // py < MIN_FUSED_SHARD):
        why.append(f"shards narrower than {MIN_FUSED_SHARD} cells")
    if cfg.precision.state_dtype != np.float32:
        why.append("f64 precision")
    if mu_const is None:
        why.append("spatially-varying mu")
    if not fused_available(grid, sharded=True, px=px, py=py):
        why.append("periodic axis not mesh-divisible")
    return ", ".join(why)


def select_path(grid: Grid, cfg: ModelConfig,
                mu_const: Optional[float]) -> str:
    """The compute path for a configuration: the fused step wherever it
    applies (f32 state, constant mu, mesh-divisible periodic axes,
    shards at least MIN_FUSED_SHARD wide), the jnp composition
    otherwise. The mesh is ``cfg.parallel``'s; the rule reads only the
    configuration, never the platform."""
    sharded = cfg.parallel.mesh_x * cfg.parallel.mesh_y > 1
    if fused_blockers(grid, cfg, mu_const):
        return PATH_JNP_SHARDED if sharded else PATH_JNP
    if sharded:
        return PATH_FUSED_SHARDED
    if grid.periodic_x or grid.periodic_y:
        return PATH_FUSED_PERIODIC
    return PATH_FUSED


def load_config_dir(path: str = ".", argv=None) -> ModelConfig:
    """Load the four reference-format .par files from a directory
    (model.f90:50-56)."""
    return ModelConfig(
        basin=load_basinpar(os.path.join(path, "basin.par")),
        sw=load_sw(os.path.join(path, "sw.par")),
        parallel=load_parallel(os.path.join(path, "parallel.par"), argv),
        run=load_runpar(os.path.join(path, "ocean_run.par")),
    )


class OceanModel:
    """Build + run a configured model."""

    def __init__(self, cfg: ModelConfig, base_dir: str = ".",
                 results_dir: Optional[str] = None):
        self.cfg = cfg
        self.base_dir = base_dir
        self.results_dir = results_dir or os.path.join(base_dir, "RESULTS")
        self.timers = PhaseTimers()

        basin = cfg.basin
        with self.timers.phase("init_grid"):
            int_mask = load_mask(basin.mask_file_name, basin.nx, basin.ny,
                                 base_dir)
            hhq_rest = None
            if basin.bottom_topography_file_name != "none":
                hhq_rest = grads.read_record(
                    os.path.join(base_dir,
                                 basin.bottom_topography_file_name),
                    1, basin.nx, basin.ny).astype(cfg.precision.state_dtype)
            self.grid: Grid = build_grid(basin, int_mask, hhq_rest,
                                         cfg.precision)

        with self.timers.phase("init_state"):
            ssh0 = None
            if cfg.sw.ssh_init_file_name != "none":
                ssh0 = grads.read_record(
                    os.path.join(base_dir, "INIT",
                                 cfg.sw.ssh_init_file_name),
                    1, basin.nx, basin.ny)
            self.state: SWState = init_ocean_state(self.grid, cfg, ssh0)
        self.num_step = cfg.run.init_step

        # Mesh selection (parallel.par analog): 1x1 -> single-device path
        px, py = cfg.parallel.mesh_x, cfg.parallel.mesh_y
        if cfg.parallel.mod_decomposition not in (0, 1, 2):
            # parity with abort_model('Unknown decomposition mode!')
            # (decomposition.f90:888-890)
            raise ValueError("Unknown decomposition mode! "
                             f"(mod_decomposition="
                             f"{cfg.parallel.mod_decomposition})")
        self._file_cuts = None
        if cfg.parallel.mod_decomposition == 2:
            # cut lines read back from a decomposition.txt-format file
            # (the format the reference writes at debug_level >= 3,
            # decomposition.f90:895-909, but never reads)
            from ..parallel.decomposition import (cuts_from_decomposition,
                                                  read_decomposition)
            dec = read_decomposition(
                os.path.join(base_dir, cfg.parallel.file_decomposition),
                nx=basin.nx, ny=basin.ny)
            xe, ye = cuts_from_decomposition(dec, px, py)
            # block grids cover the significant interior [2, n-2); shard
            # cuts span the full padded domain (the frame is land)
            xe[0], xe[-1] = 0, basin.nx
            ye[0], ye[-1] = 0, basin.ny
            self._file_cuts = (xe, ye)
        self.mesh = None
        self.path = select_path(self.grid, cfg, self.state_mu_const())
        if px * py > 1:
            self.mesh = make_mesh(px, py)
            self._grid_s, self._state_s = prepare(self.grid, self.state,
                                                  self.mesh)
            # Cut-line policy is decided HERE, not at run time, so config
            # validity does not depend on when a path gets built.
            # Non-uniform cut lines (weighted / file) are realized by the
            # fused-sharded driver's pad+valid-extent margined carries;
            # the uniform jnp-sharded path cannot honor them.
            if self.path != PATH_FUSED_SHARDED:
                why = fused_blockers(self.grid, cfg, self.state_mu_const())
                if self._file_cuts is not None:
                    raise ValueError(
                        "mod_decomposition=2 (cuts from file) needs the "
                        "fused-sharded path, which this config cannot "
                        f"select ({why}); use mod_decomposition=0, or "
                        "lift the blocker")
                if cfg.parallel.mod_decomposition == 1:
                    print("MODEL: mod_decomposition=1 (weighted cuts) "
                          "needs the fused-sharded path, which this "
                          f"config cannot select ({why}); falling back "
                          "to uniform cuts on the jnp-sharded path")

    def startup_report(self) -> str:
        """Decomposition + memory diagnostics (the reference's DD INFO /
        SYNC INFO / memory-profile startup prints)."""
        from ..diag.memory import report as mem_report
        from ..parallel.decomposition import (mesh_split_report,
                                              weighted_x_edges,
                                              x_band_balance)
        px, py = self.cfg.parallel.mesh_x, self.cfg.parallel.mesh_y
        lines = []
        int_mask = (np.asarray(self.grid.lu) < 0.5).astype(np.int32)
        rep = mesh_split_report(int_mask, px, py)
        lines.append(f"DD INFO: mesh {px}x{py}, wet fraction "
                     f"{rep['wet_fraction']:.3f}, load-balance ratio "
                     f"(max/mean wet points) {rep['balance_ratio']:.3f}")
        if px > 1:
            try:
                edges = weighted_x_edges(int_mask, px)
                ratio = x_band_balance(int_mask, edges, py)
                tag = ("selected" if self.cfg.parallel.mod_decomposition
                       == 1 else "available via mod_decomposition=1")
                lines.append(
                    f"DD INFO: weighted x-cuts {list(map(int, edges))} "
                    f"balance {ratio:.3f} ({tag})")
            except ValueError:
                pass
        lines.append(mem_report(self.state, self.grid))
        return "\n".join(lines)

    # ------------------------------------------------------------------
    def state_mu_const(self):
        """The state's spatially-constant viscosity, or None if mu varies
        (then only the general jnp path applies). The reference's init
        zeroes mu (init_data.f90:76-77), so this is normally 0.0; a
        nonzero constant drives the fused stress/uv_diff2 branch
        (vel_ssh.f90:375-452)."""
        mu = np.asarray(self.state.mu)
        if mu.size == 0:
            return 0.0
        v = mu.flat[0]
        return float(v) if np.all(mu == v) else None

    def dump_decomposition_txt(self) -> str:
        """Write the active decomposition to RESULTS/decomposition.txt —
        the reference's debug_level >= 3 dump
        (decomposition.f90:895-909), driven by parallel.par's
        parallel_dbg line. Returns the path."""
        from ..parallel.decomposition import (BlockDecomposition,
                                              dump_decomposition)
        px, py = self.cfg.parallel.mesh_x, self.cfg.parallel.mesh_y
        fs = getattr(self, "_fused_sh", None)
        if fs is not None:
            xe = np.asarray(fs.x_edges, np.int64)
            ye = np.asarray(fs.y_edges, np.int64)
            xe, ye = xe.copy(), ye.copy()
            xe[-1] = min(int(xe[-1]), self.grid.nx)
            ye[-1] = min(int(ye[-1]), self.grid.ny)
        elif self._file_cuts is not None:
            xe, ye = self._file_cuts
        else:
            xe = ye = None
            if self.cfg.parallel.mod_decomposition == 1 and px * py > 1:
                from ..parallel.decomposition import (weighted_x_edges,
                                                      weighted_y_edges)
                im = (np.asarray(self.grid.lu) < 0.5).astype(np.int32)
                try:
                    xe = (weighted_x_edges(im, px) if px > 1 else
                          np.array([0, self.grid.nx], np.int64))
                    ye = (weighted_y_edges(im, py) if py > 1 else
                          np.array([0, self.grid.ny], np.int64))
                except ValueError:
                    xe = ye = None
            if xe is None:
                xe = np.linspace(0, self.grid.nx, px + 1).astype(np.int64)
                ye = np.linspace(0, self.grid.ny, py + 1).astype(np.int64)
        wet = np.asarray(self.grid.lu) > 0.5
        w = np.array([[wet[xe[i]:xe[i + 1], ye[j]:ye[j + 1]].sum()
                       for j in range(py)] for i in range(px)], np.int64)
        owner = (np.arange(px * py).reshape(px, py)).astype(np.int64)
        path = os.path.join(self.results_dir, "decomposition.txt")
        os.makedirs(self.results_dir, exist_ok=True)
        dump_decomposition(
            BlockDecomposition(px, py, w, owner, xe, ye), path)
        return path

    def locate_blowup(self, prev_state: SWState, n_batch: int):
        """Re-run a failed window un-fused (the jnp composition) from the
        last good state and return (k, m, n, value): the first step k
        (1-based within the window) whose post-step check trips, and the
        offending wet cell — the information the reference prints before
        aborting ('ERROR!!! In the point m=, n=', vel_ssh.f90:52-58) and
        the fused path's scalar max reduction discards. Returns None
        if the re-run stays stable (trajectories differ at roundoff
        level; the window bound still stands)."""
        from .step import reinit_depth_families
        st = reinit_depth_families(prev_state, self.grid, self.cfg)
        step = make_step(self.grid, self.cfg)
        tau = self.cfg.run.tau
        jstep = jax.jit(lambda s: step(s, tau))
        lu = np.asarray(self.grid.lu) > 0.5
        for k in range(n_batch):
            st, ok = jstep(st)
            if not bool(ok):
                ssh = np.asarray(st.ssh)
                bad = np.abs(np.where(lu & np.isfinite(ssh), ssh,
                                      np.where(lu, np.inf, 0.0)))
                m, n = np.unravel_index(int(np.argmax(bad)), bad.shape)
                return k + 1, int(m), int(n), float(ssh[m, n])
        return None

    def _raise_blowup(self, prev_state, n_batch: int, done: int,
                      sharded: bool = False):
        """The stability guard tripped inside the last window: localize
        the blow-up (step + cell) before raising — the
        reference aborts with the offending (m, n) every step
        (check_ssh_err_kernel); the fused scan only carries a window-level
        scalar, so the failed window is replayed un-fused host-side."""
        first = done - n_batch
        if jax.process_count() > 1:
            # multi-process shards are not host-addressable here; a
            # crop/replay would raise a different exception and mask the
            # diagnostic — fall back to the plain window-range error
            raise FloatingPointError(
                "SIGFPRE predict error: |ssh| bound exceeded between "
                f"steps {first + 1} and {done} (multi-process run; "
                "re-run single-process to localize the cell)")
        if sharded:     # padded jnp-sharded state -> plain global view
            prev_state = crop_state(prev_state, self.cfg.basin.nx,
                                    self.cfg.basin.ny)
        loc = self.locate_blowup(prev_state, n_batch)
        if loc is not None:
            k, m, n, val = loc
            raise FloatingPointError(
                f"SIGFPRE predict error: in the point m={m} n={n} "
                f"ssh={val:.6g} at step {first + k}")
        raise FloatingPointError(
            "SIGFPRE predict error: |ssh| >= 1e4 "
            f"within steps {first}..{done}")

    def _fused_sharded_runner(self, fs, n_inner: int):
        inner = fs.make_runner(n_inner)

        def runner(st):
            carry = fs.pack(st)
            carry, ok = inner(carry)
            fields = fs.extract(carry)
            import dataclasses as _dc
            upd = dict(zip(("ssh", "sshp", "ubrtr", "ubrtrp",
                            "vbrtr", "vbrtrp"), fields[:6]))
            if fs.n_tracers:
                upd["ff"] = jnp.stack(fields[6::2])
                upd["ffp"] = jnp.stack(fields[7::2])
                upd["ffn"] = upd["ff"]
            return _dc.replace(st, **{k: jnp.asarray(
                v, st.ssh.dtype) for k, v in upd.items()}), ok
        return runner

    def make_runner(self, n_inner: int):
        """``state -> (state, ok)`` advancing ``n_inner`` steps on the
        selected compute path (``self.path``); the jnp-sharded path takes
        and returns the padded sharded state (``self._state_s``)."""
        tau = self.cfg.run.tau
        if self.path == PATH_FUSED_SHARDED:
            from .fused_sharded2d import FusedSharded2DModel
            fs = getattr(self, "_fused_sh", None)
            if fs is not None and n_inner % fs.steps_per_call == 0:
                return self._fused_sharded_runner(fs, n_inner)
            # chained 2-steps-per-exchange halves the collective count
            # (the margin widens instead — module docstring); odd
            # windows fall back to 1. A rebuild keeps the cut lines
            # already selected (mod_decomposition=2).
            spc = 2 if n_inner % 2 == 0 else 1
            xe, ye = self._file_cuts or (None, None)
            if fs is not None:
                xe = np.asarray(fs.x_edges)
                ye = np.asarray(fs.y_edges)
            # parallel.par mod_decomposition=1 selects the weighted
            # (equal-wet) cut lines (decomposition.f90:614-669)
            self._fused_sh = FusedSharded2DModel(
                self.grid, self.cfg, tau,
                self.cfg.parallel.mesh_x, self.cfg.parallel.mesh_y,
                mu_const=self.state_mu_const(),
                weighted=self.cfg.parallel.mod_decomposition == 1,
                x_edges=xe, y_edges=ye, steps_per_call=spc)
            return self._fused_sharded_runner(self._fused_sh, n_inner)
        if self.path == PATH_JNP_SHARDED:
            stepn = make_sharded_step(self._grid_s, self.cfg, self.mesh,
                                      n_inner=n_inner)
            def runner(st):
                return stepn(st, tau)
            return runner
        if self.path == PATH_FUSED_PERIODIC:
            # periodic single-device: the fused step on a 1x1 'mesh'
            # whose margin exchange wraps locally
            from .fused_sharded2d import FusedSharded2DModel
            if not hasattr(self, "_fused_per"):
                self._fused_per = FusedSharded2DModel(
                    self.grid, self.cfg, tau, 1, 1,
                    mu_const=self.state_mu_const())
            return self._fused_sharded_runner(self._fused_per, n_inner)
        if self.path == PATH_FUSED:
            from .fused import FusedSWModel
            # chained 2 steps per call; odd batch sizes fall back to 1
            # step per call
            spc = 2 if n_inner % 2 == 0 else 1
            if getattr(self, "_fused_spc", None) != spc:
                self._fused = FusedSWModel(self.grid, self.cfg, tau,
                                           static_rslu=True,
                                           mu_const=self.state_mu_const(),
                                           steps_per_call=spc)
                self._fused_spc = spc
            # never silently drop physics: the step's compiled-in mu
            # must match the state it will advance
            self._fused.validate_state(self.state)

            @jax.jit
            def runner(st):
                s6 = self._fused.pack(st)
                s6, ok = self._fused.run_steps(s6, n_inner)
                return self._fused.unpack(s6, st), ok
            return runner
        step = make_step(self.grid, self.cfg)

        @jax.jit
        def runner(st):
            return run_steps(step, st, tau, n_inner)
        return runner

    def _output(self, state: SWState, nrec: int):
        basin, run = self.cfg.basin, self.cfg.run
        t = model_time(self.num_step, run.tau, run.init_year)
        lu = np.asarray(self.grid.lu)
        common = dict(nx=basin.nx - 4, ny=basin.ny - 4, nt=nrec,
                      x0=basin.rlon, hx=basin.dxst,
                      y0=basin.rlat, hy=basin.dyst,
                      year=t.year, month=t.month, day=t.day,
                      hour=t.hour, minute=t.minute,
                      tstep_sec=run.loc_data_wr_period_min * 60.0)
        if nrec == 1:
            p = os.path.join(self.results_dir, "hhq.dat")
            grads.write_record(p, 1, np.asarray(self.grid.hhq_rest), lu)
            grads.write_ctl(p, title="HHQ, m", varname="hhq", **common)
        p = os.path.join(self.results_dir, "ssh.dat")
        grads.write_record(p, nrec, np.asarray(state.ssh), lu)
        grads.write_ctl(p, title="SSH, m", varname="ssh", **common)
        if self.cfg.sw.use_tracers > 0 and state.ff is not None:
            p = os.path.join(self.results_dir, "ff1.dat")
            grads.write_record(p, nrec, np.asarray(state.ff[-1]), lu)
            grads.write_ctl(p, title="ff1 (last)", varname="ff1", **common)

    # ------------------------------------------------------------------
    def run(self, checkpoint_path: Optional[str] = None,
            verbose: bool = True,
            checkpoint_format: str = "npz",
            checkpoint_every: Optional[int] = None) -> SWState:
        """The main time loop (model.f90:132-200).

        ``checkpoint_format``: "npz" (host-gathered single file) or
        "orbax" (per-shard tensorstore directory; multi-host capable).
        Resume auto-detects: a directory is an orbax checkpoint.

        ``checkpoint_every``: write a restart point to
        ``checkpoint_path`` every N steps DURING the run (rounded to
        the output-window boundaries the loop already returns to host
        on) — production restart safety beyond the reference, which
        only writes diagnostics mid-run. Resume (start_type=1) picks
        the run up from the last completed window."""
        cfg = self.cfg
        run = cfg.run
        n_total = run.num_step_max
        n_out = run.output_every_steps or n_total

        if run.start_type == 1 and checkpoint_path \
                and os.path.exists(checkpoint_path):
            if os.path.isdir(checkpoint_path):
                from ..io.checkpoint import load_checkpoint_sharded
                self.state, self.num_step = load_checkpoint_sharded(
                    checkpoint_path)
            else:
                self.state, self.num_step = load_checkpoint(checkpoint_path)
            if verbose:
                print(f"MODEL: resumed from {checkpoint_path} "
                      f"at step {self.num_step}")

        if cfg.parallel.dlb_balance_steps > 0 and verbose:
            # the reference's dlb branch (model.f90:64-89) re-cuts by
            # measured per-shard work; every shard here computes its
            # whole padded block, so there is no work imbalance to
            # measure
            print("MODEL: dynamic load balancing is not available "
                  f"(dlb_balance_steps={cfg.parallel.dlb_balance_steps} "
                  "ignored); running with the configured cut lines")

        if cfg.parallel.debug_level >= 2 and self.mesh is not None:
            # the reference's sync_test hook (init_data.f90:41-44,
            # syncborder_block2D_gen_test.fi): verify the halo exchange
            # against the analytic i*j field before the production loop
            from ..parallel.halo import halo_self_test
            px, py = cfg.parallel.mesh_x, cfg.parallel.mesh_y
            nxt = -(-self.grid.nx // px) * px
            nyt = -(-self.grid.ny // py) * py
            halo_self_test(self.mesh, nxt, nyt,
                           self.grid.periodic_x and nxt == self.grid.nx,
                           self.grid.periodic_y and nyt == self.grid.ny)
            if verbose:
                print("SYNC INFO: halo self-test passed "
                      f"({px}x{py} mesh)")
        if cfg.parallel.debug_level >= 3:
            # the reference's debug ladder writes decomposition.txt on
            # every run at this level (decomposition.f90:895-909)
            p = self.dump_decomposition_txt()
            if verbose:
                print(f"DD INFO: Print decomposition in file {p}")

        if verbose:
            print(self.startup_report())
            print(f"MODEL: compute path: {self.path}")

        # the fused-sharded runner packs/unpacks internally and consumes
        # the plain (unsharded) state view
        sharded = self.path == PATH_JNP_SHARDED
        state = self._state_s if sharded else self.state
        runner = self.make_runner(n_out)

        nrec = 1
        if run.output_every_steps:
            with self.timers.phase("output"):
                out_state = (crop_state(state, cfg.basin.nx, cfg.basin.ny)
                             if sharded else state)
                self._output(out_state, nrec)

        done = self.num_step
        while done < n_total:
            n_batch = min(n_out, n_total - done)
            if n_batch != n_out:
                runner = self.make_runner(n_batch)
            prev_state = state
            with self.timers.phase("model_step"):
                state, ok = runner(state)
                # reading the flag waits for the window to finish, so
                # the phase timer covers the device work
                stable = bool(ok)
            done += n_batch
            self.num_step += n_batch
            if not stable:
                self._raise_blowup(prev_state, n_batch, done,
                                   sharded=sharded)
            if run.output_every_steps:
                nrec += 1
                with self.timers.phase("output"):
                    out_state = (crop_state(state, cfg.basin.nx,
                                            cfg.basin.ny)
                                 if sharded else state)
                    self._output(out_state, nrec)
            if checkpoint_path and checkpoint_every \
                    and done < n_total \
                    and done % max(checkpoint_every, 1) < n_batch:
                with self.timers.phase("checkpoint"):
                    ck_state = (crop_state(state, cfg.basin.nx,
                                           cfg.basin.ny)
                                if sharded else state)
                    if checkpoint_format == "orbax" \
                            or os.path.isdir(checkpoint_path):
                        from ..io.checkpoint import \
                            save_checkpoint_sharded
                        save_checkpoint_sharded(checkpoint_path,
                                                ck_state, self.num_step)
                    else:
                        save_checkpoint(checkpoint_path, ck_state,
                                        self.num_step)
                if verbose:
                    print(f"MODEL: restart point at step "
                          f"{self.num_step} -> {checkpoint_path}")
            if verbose:
                t = model_time(self.num_step, run.tau, run.init_year)
                print(f"MODEL: step {self.num_step}/{n_total}  {t.stamp()}")

        final = (crop_state(state, cfg.basin.nx, cfg.basin.ny)
                 if sharded else state)
        self.state = final
        if checkpoint_path:
            with self.timers.phase("checkpoint"):
                if checkpoint_format == "orbax" \
                        or os.path.isdir(checkpoint_path):
                    # per-shard tensorstore write — no host gather, the
                    # multi-host path (collective MPI-IO analog)
                    from ..io.checkpoint import save_checkpoint_sharded
                    save_checkpoint_sharded(checkpoint_path, final,
                                            self.num_step)
                else:
                    save_checkpoint(checkpoint_path, final, self.num_step)
        wet = float(np.asarray(self.grid.lu).sum())
        steps_done = self.num_step - run.init_step
        t_step = self.timers.acc.get("model_step", 0.0)
        pts = wet * steps_done / max(t_step, 1e-12)
        # multi-process: ONE max/min-over-ranks table (mpp_finalize,
        # mpp.f90:272-341). The gather is COLLECTIVE, so every process
        # must reach it regardless of its local verbose flag (ranks
        # often run verbose=(process_index()==0)); only the print is
        # conditional.
        rep = self.timers.reduced_report(
            extra={"wet_points_per_sec": f"{pts:.3e}"})
        if verbose and jax.process_index() == 0:
            print(rep)
        return final
