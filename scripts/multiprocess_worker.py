"""Worker for the multi-process CPU execution test (one OS process = one
'host' with one CPU device, wired by jax.distributed + Gloo collectives).

The analog of the reference's multi-rank MPI execution
(shared/mpp/mpp.f90:64-93 mpi_init + cart comm;
syncborder_block2D_gen_all.fi:100-129 inter-rank sends): the SAME
sharded-model code that runs on a single-process device mesh runs
unchanged across processes — shard_map ppermutes become cross-process
Gloo transfers.

Usage (spawned by tests/test_multiprocess.py or scripts by hand):
  python scripts/multiprocess_worker.py <proc_id> <nproc> <port> <outdir> \
      [jnp|fused2d]

jnp mode (default): runs N steps of the jnp-sharded model over a
(nproc, 1) mesh, writes the gathered trajectory (proc 0), saves an orbax
sharded checkpoint from ALL processes, restores it with the target
shardings in place, runs M more steps, and writes the continued
trajectory.

fused2d mode (nproc=4): the PRODUCTION path — FusedSharded2DModel
over a 2x2 mesh whose BOTH axes cross process
boundaries, so the margin-strip ppermutes (including the corner
composition) ride Gloo inter-process transport — the analog of the
reference's inter-rank sends incl. corner directions
(syncborder_block2D_gen_all.fi:100-129).
"""

import os
import sys


N1, N2 = 12, 8          # steps before / after the checkpoint boundary


def build_workload(nproc: int, curve_grid: int = 1):
    """Deterministic tiny workload, identical on every process (and in
    the single-process reference the test compares against);
    ``curve_grid=2`` makes it bipolar (the fast2d sharded path)."""
    from ocean_model_arch_tpu.config import (ModelConfig, Precision,
                                             SWConfig, basinpar_flat)
    from ocean_model_arch_tpu.core.grid import build_grid
    from ocean_model_arch_tpu.core.masks import frame_of_land_mask
    from ocean_model_arch_tpu.model.init import init_ocean_state

    nx, ny = 8 * max(nproc, 2), 24
    basin = basinpar_flat(nx, ny, curve_grid=curve_grid,
                          rlon=27.5, rlat=41.0)
    cfg = ModelConfig(basin=basin, sw=SWConfig(use_tracers=1,
                                               tracer_num=1),
                      precision=Precision.f32())
    grid = build_grid(basin, frame_of_land_mask(nx, ny),
                      precision=cfg.precision)
    return grid, cfg, init_ocean_state(grid, cfg)


def main_fused2d(proc_id: int, nproc: int, port: int, outdir: str,
                 curve_grid: int = 1) -> None:
    """FusedSharded2DModel across 4 processes on a 2x2 mesh
    (curve_grid=2: the fast2d bipolar step with its pruned metric
    planes exchanges margins over Gloo)."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 1)
    jax.distributed.initialize(f"127.0.0.1:{port}", nproc, proc_id)

    import numpy as np
    from jax.experimental import multihost_utils

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, repo)
    from ocean_model_arch_tpu.model.fused_sharded2d import \
        FusedSharded2DModel

    assert nproc == 4 and len(jax.devices()) == 4
    grid, cfg, state = build_workload(nproc, curve_grid)
    # steps_per_call=2 — the production driver's chained-exchange mode
    # (one margin exchange per TWO model steps crosses Gloo)
    fm = FusedSharded2DModel(grid, cfg, 1.0, 2, 2,
                             devices=jax.devices(), steps_per_call=2)
    c, ok = fm.make_runner(N1)(fm.pack(state))
    assert bool(ok), "stability guard tripped across processes (fused2d)"
    c, ok = fm.make_runner(N2)(c)
    assert bool(ok)
    fields = fm.extract(c)
    host = [np.asarray(multihost_utils.process_allgather(f, tiled=True))
            for f in fields]
    if proc_id == 0:
        np.savez(os.path.join(outdir, "fused2d.npz"), ssh=host[0],
                 u=host[2], v=host[4], tr=host[6])
        with open(os.path.join(outdir, "ok"), "w") as f:
            f.write("ok")
    jax.distributed.shutdown()


def main(proc_id: int, nproc: int, port: int, outdir: str) -> None:
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 1)
    jax.distributed.initialize(f"127.0.0.1:{port}", nproc, proc_id)

    import numpy as np
    from jax.experimental import multihost_utils

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, repo)
    from ocean_model_arch_tpu.io.checkpoint import (
        load_checkpoint_sharded, save_checkpoint_sharded)
    from ocean_model_arch_tpu.model.sharded import (make_sharded_step,
                                                    prepare)
    from ocean_model_arch_tpu.parallel.domain import crop_state
    from ocean_model_arch_tpu.parallel.mesh import make_mesh, tree_specs
    from jax.sharding import NamedSharding

    assert len(jax.devices()) == nproc, \
        f"expected {nproc} global devices, got {len(jax.devices())}"

    grid, cfg, state = build_workload(nproc)

    mesh = make_mesh(nproc, 1)          # x axis spans the processes
    gs, ss = prepare(grid, state, mesh)
    n1, n2 = N1, N2

    step = make_sharded_step(gs, cfg, mesh, n_inner=n1)
    mid, ok = step(ss, np.float32(1.0))
    assert bool(ok), "stability guard tripped across processes"

    def gather(st):
        full = jax.tree.map(
            lambda a: np.asarray(multihost_utils.process_allgather(
                a, tiled=True)), st)
        return crop_state(full, grid.nx, grid.ny)

    if proc_id == 0:
        g = gather(mid)
        np.savez(os.path.join(outdir, "mid.npz"), ssh=g.ssh, u=g.ubrtr,
                 v=g.vbrtr, tr=g.ff[0])
    else:
        gather(mid)     # allgather is collective — all procs join

    # ---- orbax sharded checkpoint across the process boundary --------
    ck = os.path.join(outdir, "ckpt")
    save_checkpoint_sharded(ck, mid, n1)
    import dataclasses
    specs = tree_specs(mid)
    shardings = {f.name: NamedSharding(mesh, getattr(specs, f.name))
                 for f in dataclasses.fields(mid)
                 if getattr(mid, f.name) is not None}
    restored, step0 = load_checkpoint_sharded(ck, shardings)
    assert step0 == n1
    # the prognostic fields restored with their target shardings in
    # place, no host gather
    for f in ("ssh", "sshp", "ubrtr", "vbrtr", "ff"):
        a = getattr(restored, f)
        assert a.sharding.is_equivalent_to(
            NamedSharding(mesh, getattr(specs, f)), a.ndim), f

    step2 = make_sharded_step(gs, cfg, mesh, n_inner=n2)
    end, ok2 = step2(restored, np.float32(1.0))
    assert bool(ok2)

    # ---- cross-process timer reduction (mpp_finalize analog) ---------
    # distinct per-rank totals + a rank-private phase name prove the
    # reduction really crossed the process boundary
    from ocean_model_arch_tpu.utils.timers import PhaseTimers
    tm = PhaseTimers()
    tm.add("model_step", 1.0 + proc_id)
    tm.add(f"only_rank{proc_id}", 0.5)
    rep = tm.reduced_report()
    if proc_id == 0:
        with open(os.path.join(outdir, "timers.txt"), "w") as f:
            f.write(rep)
    if proc_id == 0:
        g = gather(end)
        np.savez(os.path.join(outdir, "end.npz"), ssh=g.ssh, u=g.ubrtr,
                 v=g.vbrtr, tr=g.ff[0])
        with open(os.path.join(outdir, "ok"), "w") as f:
            f.write("ok")
    else:
        gather(end)
    jax.distributed.shutdown()


if __name__ == "__main__":
    mode = sys.argv[5] if len(sys.argv) > 5 else "jnp"
    if mode == "fused2d_bipolar":
        main_fused2d(int(sys.argv[1]), int(sys.argv[2]),
                     int(sys.argv[3]), sys.argv[4], curve_grid=2)
    else:
        entry = {"jnp": main, "fused2d": main_fused2d}[mode]
        entry(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]),
              sys.argv[4])
