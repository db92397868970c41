"""Multi-PROCESS execution test (SURVEY §5.8).

Spawns N separate OS processes wired by jax.distributed (CPU backend,
Gloo collectives) — the same code path a multi-host mesh uses — and
asserts the cross-process trajectory matches the single-process one
bit-for-bit, including an orbax sharded checkpoint saved and restored
ACROSS the process boundary mid-run. This actually leaves XLA's
single-process collective path, unlike the virtual-device mesh tests.

Reference analog: mpi_init + cart comm (shared/mpp/mpp.f90:64-93) and
inter-rank halo sends (syncborder_block2D_gen_all.fi:100-129), exercised
by every reference run with mpirun -n N.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "scripts", "multiprocess_worker.py")


@pytest.mark.parametrize("nproc", [2])
def test_multiprocess_matches_single_process(nproc, tmp_path):
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS",)}   # workers pick their own devices
    procs = [subprocess.Popen(
        [sys.executable, WORKER, str(i), str(nproc), "12477",
         str(tmp_path)],
        cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT) for i in range(nproc)]
    outs = [p.communicate(timeout=600)[0].decode() for p in procs]
    for i, p in enumerate(procs):
        assert p.returncode == 0, f"worker {i} failed:\n{outs[i][-3000:]}"
    assert (tmp_path / "ok").exists()

    # ONE reduced timer table over ranks (mpp_finalize, mpp.f90:272-341):
    # rank-private phases appear merged; distinct per-rank totals reduce
    # to max/min
    timers = (tmp_path / "timers.txt").read_text()
    assert f"{nproc} processes" in timers and "max/min" in timers
    assert "only_rank0" in timers and f"only_rank{nproc - 1}" in timers
    step_line = [ln for ln in timers.splitlines()
                 if ln.startswith("model_step")][0]
    cols = step_line.split()
    assert float(cols[1]) == 1.0 + (nproc - 1) and float(cols[2]) == 1.0

    # reference 1: the SAME sharded program on a single-process virtual
    # 2-device mesh — the cross-process run must match it BITWISE (same
    # XLA program, only the collective transport differs: Gloo vs local)
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    import multiprocess_worker as mw
    import jax
    from ocean_model_arch_tpu.model.sharded import make_sharded_step, prepare
    from ocean_model_arch_tpu.parallel.domain import crop_state
    from ocean_model_arch_tpu.parallel.mesh import make_mesh
    from ocean_model_arch_tpu.model.step import make_step, run_steps

    grid, cfg, state = mw.build_workload(nproc)
    mesh = make_mesh(nproc, 1, jax.devices()[:nproc])
    gs, ss = prepare(grid, state, mesh)
    vm_mid, ok = make_sharded_step(gs, cfg, mesh, n_inner=mw.N1)(
        ss, np.float32(1.0))
    assert bool(ok)
    vm_end, ok = make_sharded_step(gs, cfg, mesh, n_inner=mw.N2)(
        vm_mid, np.float32(1.0))
    assert bool(ok)
    vm_mid = crop_state(jax.tree.map(np.asarray, vm_mid), grid.nx, grid.ny)
    vm_end = crop_state(jax.tree.map(np.asarray, vm_end), grid.nx, grid.ny)

    mid = np.load(tmp_path / "mid.npz")
    end = np.load(tmp_path / "end.npz")
    for name, a, b in (("mid ssh", mid["ssh"], vm_mid.ssh),
                       ("mid u", mid["u"], vm_mid.ubrtr),
                       ("mid tracer", mid["tr"], vm_mid.ff[0]),
                       ("end ssh", end["ssh"], vm_end.ssh),
                       ("end u", end["u"], vm_end.ubrtr),
                       ("end v", end["v"], vm_end.vbrtr),
                       ("end tracer", end["tr"], vm_end.ff[0])):
        np.testing.assert_array_equal(
            np.asarray(a), np.asarray(b),
            err_msg=f"{name}: cross-process trajectory diverged from the "
                    "single-process run of the same sharded program")

    # reference 2: the unsharded jnp composition — same trajectory up to
    # XLA fusion (FMA contraction) differences between the two programs
    step = jax.jit(make_step(grid, cfg))
    ref_end, ok = run_steps(step, state, np.float32(1.0), mw.N1 + mw.N2)
    assert bool(ok)
    np.testing.assert_allclose(end["ssh"], np.asarray(ref_end.ssh),
                               rtol=2e-6, atol=1e-9)
    np.testing.assert_allclose(end["u"], np.asarray(ref_end.ubrtr),
                               rtol=2e-6, atol=1e-9)


def test_multiprocess_fused2d_2x2(tmp_path):
    """The PRODUCTION (fused-sharded) path across real process
    boundaries: 4 OS processes on a 2x2 mesh, so margin-strip ppermutes
    cross processes in BOTH axes (corners ride the diagonal). Must match
    the same program on a single-process virtual 4-device mesh
    bitwise."""
    nproc = 4
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS",)}
    procs = [subprocess.Popen(
        [sys.executable, WORKER, str(i), str(nproc), "12491",
         str(tmp_path), "fused2d"],
        cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT) for i in range(nproc)]
    outs = [p.communicate(timeout=600)[0].decode() for p in procs]
    for i, p in enumerate(procs):
        assert p.returncode == 0, f"worker {i} failed:\n{outs[i][-3000:]}"
    assert (tmp_path / "ok").exists()

    sys.path.insert(0, os.path.join(REPO, "scripts"))
    import multiprocess_worker as mw
    import jax
    from ocean_model_arch_tpu.model.fused_sharded2d import \
        FusedSharded2DModel

    grid, cfg, state = mw.build_workload(nproc)
    fm = FusedSharded2DModel(grid, cfg, 1.0, 2, 2,
                             devices=jax.devices()[:4],
                             steps_per_call=2)
    c, ok = fm.make_runner(mw.N1)(fm.pack(state))
    assert bool(ok)
    c, ok = fm.make_runner(mw.N2)(c)
    assert bool(ok)
    fields = fm.extract(c)
    got = np.load(tmp_path / "fused2d.npz")
    for name, a, b in (("ssh", got["ssh"], fields[0]),
                       ("u", got["u"], fields[2]),
                       ("v", got["v"], fields[4]),
                       ("tracer", got["tr"], fields[6])):
        np.testing.assert_array_equal(
            np.asarray(a), np.asarray(b),
            err_msg=f"{name}: fused-sharded cross-process trajectory "
                    "diverged from the single-process virtual-mesh run")


def test_multiprocess_fused2d_bipolar_2x2(tmp_path):
    """fast2d across real process boundaries: the bipolar sharded
    fused step — pointwise pruned metric planes, reductions at
    their defaults — on 4 OS processes over Gloo, bitwise vs the
    single-process virtual-mesh run."""
    nproc = 4
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS",)}
    procs = [subprocess.Popen(
        [sys.executable, WORKER, str(i), str(nproc), "12495",
         str(tmp_path), "fused2d_bipolar"],
        cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT) for i in range(nproc)]
    outs = [p.communicate(timeout=600)[0].decode() for p in procs]
    for i, p in enumerate(procs):
        assert p.returncode == 0, f"worker {i} failed:\n{outs[i][-3000:]}"
    assert (tmp_path / "ok").exists()

    sys.path.insert(0, os.path.join(REPO, "scripts"))
    import multiprocess_worker as mw
    import jax
    from ocean_model_arch_tpu.model.fused_sharded2d import \
        FusedSharded2DModel

    grid, cfg, state = mw.build_workload(nproc, curve_grid=2)
    fm = FusedSharded2DModel(grid, cfg, 1.0, 2, 2,
                             devices=jax.devices()[:4],
                             steps_per_call=2)
    assert fm.fast2d
    c, ok = fm.make_runner(mw.N1)(fm.pack(state))
    assert bool(ok)
    c, ok = fm.make_runner(mw.N2)(c)
    assert bool(ok)
    fields = fm.extract(c)
    got = np.load(tmp_path / "fused2d.npz")
    for name, a, b in (("ssh", got["ssh"], fields[0]),
                       ("u", got["u"], fields[2]),
                       ("v", got["v"], fields[4]),
                       ("tracer", got["tr"], fields[6])):
        np.testing.assert_array_equal(
            np.asarray(a), np.asarray(b),
            err_msg=f"{name}: bipolar fast2d cross-process trajectory "
                    "diverged from the single-process virtual-mesh run")
