"""IO (mask/GrADS/checkpoint) + top-level driver tests, including the
Black Sea realistic-mask config (benchmark config 4)."""

import os

import numpy as np

from ocean_model_arch_tpu.io import grads
from ocean_model_arch_tpu.io.checkpoint import (load_checkpoint,
                                                save_checkpoint)
from ocean_model_arch_tpu.io.mask_io import load_mask, read_mask, write_mask

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_mask_roundtrip(tmp_path):
    rng = np.random.RandomState(0)
    mask = (rng.rand(12, 9) < 0.5).astype(np.int32)
    p = tmp_path / "m.txt"
    write_mask(str(p), mask, "test mask")
    back = read_mask(str(p), 12, 9)
    np.testing.assert_array_equal(mask, back)


def test_black_sea_mask():
    mask = load_mask("data/BS/mask_bs4km.txt", 289, 163, REPO)
    assert mask.shape == (289, 163)
    wet = (mask == 0).sum()
    assert 10000 < wet < 289 * 163          # a real coastline
    # the frame must be land for the mmm=3 convention
    assert (mask[:2, :] == 1).all() and (mask[-2:, :] == 1).all()
    assert (mask[:, :2] == 1).all() and (mask[:, -2:] == 1).all()


def test_grads_record_roundtrip(tmp_path):
    nx, ny = 20, 14
    rng = np.random.RandomState(1)
    lu = np.zeros((nx, ny), np.float32)
    lu[2:-2, 2:-2] = (rng.rand(nx - 4, ny - 4) < 0.7)
    f1 = rng.randn(nx, ny).astype(np.float64)
    f2 = rng.randn(nx, ny).astype(np.float64)
    p = str(tmp_path / "ssh.dat")
    grads.write_record(p, 1, f1, lu)
    grads.write_record(p, 2, f2, lu)
    b1 = grads.read_record(p, 1, nx, ny)
    b2 = grads.read_record(p, 2, nx, ny)
    wet = lu > 0.5
    np.testing.assert_allclose(b1[wet], f1[wet].astype(np.float32))
    np.testing.assert_allclose(b2[wet], f2[wet].astype(np.float32))
    assert (b1[~wet] == 0).all()
    ctl = grads.write_ctl(p, nx=nx - 4, ny=ny - 4, nt=2, title="SSH, m",
                          varname="ssh")
    text = open(ctl).read()
    assert "DSET    ^ssh.dat" in text and "VARS 1" in text


def _run_dir(tmp_path, mask_path, nx, ny, steps_min=1.0,
             duration_days=0.0007, mesh=None, tau=1.0,
             mod_decomposition=0, decomposition_file="none",
             parallel_dbg=0):
    (tmp_path / "basin.par").write_text(
        f"{nx} : nx\n{ny} : ny\n1 : nz\n0 :\n0 :\n0.05d0 :\n0.04d0 :\n"
        "27.525d0 :\n40.940d0 :\n0 :\n0 :\n1 : curve\n0.0d0 :\n0.0d0 :\n"
        "90.0d0 :\n60.0d0 :\n90.0d0 :\n-90.0d0 :\n"
        f"{mask_path} : mask\nnone : topo\n")
    (tmp_path / "sw.par").write_text(
        "1 :\n1 :\n1 :\n0.5d0 :\n1.0d+03 :\n1 : tracers\n1 :\nnone :\n")
    (tmp_path / "parallel.par").write_text(
        f"{mod_decomposition} :\n{decomposition_file} :\n1 :\n1 :\n"
        f"{parallel_dbg} :\n0 :\nnone :\n0 :\n0 :\n")
    (tmp_path / "ocean_run.par").write_text(
        f"0 :\n{tau}d0 : tau\n{duration_days} : days\n0 :\n2012 :\n"
        f"{steps_min} : out min\n-1.0 :\n0 :\n0 :\nnone :\n")
    return str(tmp_path)


def test_blowup_localization(tmp_path):
    """An unstable run (tau far beyond the gravity-wave CFL) must abort
    naming the offending step and wet cell — parity with the reference's
    check_ssh_err_kernel print ('ERROR!!! In the point m=, n=',
    vel_ssh.f90:52-58); the fused paths only carry a window-level scalar,
    so the driver replays the failed window un-fused to localize."""
    import pytest
    from ocean_model_arch_tpu.model.model import OceanModel, load_config_dir

    d = _run_dir(tmp_path, os.path.join(REPO, "data/BS/mask_bs4km.txt"),
                 289, 163, steps_min=-1.0, duration_days=0.5, tau=1000.0)
    cfg = load_config_dir(d)
    model = OceanModel(cfg, base_dir=d)
    with pytest.raises(FloatingPointError) as ei:
        model.run(verbose=False)
    msg = str(ei.value)
    assert "in the point m=" in msg and "at step" in msg, msg
    # the named cell must be a wet cell inside the domain
    import re
    m = int(re.search(r"m=(\d+)", msg).group(1))
    n = int(re.search(r"n=(\d+)", msg).group(1))
    assert np.asarray(model.grid.lu)[m, n] > 0.5


def test_driver_black_sea(tmp_path):
    """End-to-end: Black Sea mask, spherical metrics, tracer, output +
    checkpoint + resume."""
    from ocean_model_arch_tpu.model.model import OceanModel, load_config_dir

    d = _run_dir(tmp_path, os.path.join(REPO, "data/BS/mask_bs4km.txt"),
                 289, 163)
    cfg = load_config_dir(d)
    assert cfg.run.num_step_max == 60
    model = OceanModel(cfg, base_dir=d)
    ck = str(tmp_path / "ck.npz")
    final = model.run(checkpoint_path=ck, verbose=False)
    s = np.asarray(final.ssh)
    assert np.isfinite(s).all()
    # outputs written (1 initial + 1 per output minute)
    assert os.path.exists(os.path.join(d, "RESULTS", "ssh.dat"))
    assert os.path.exists(os.path.join(d, "RESULTS", "ssh.ctl"))
    assert os.path.exists(os.path.join(d, "RESULTS", "hhq.dat"))
    assert os.path.exists(os.path.join(d, "RESULTS", "ff1.dat"))

    # checkpoint round-trips bit-exactly
    st, step = load_checkpoint(ck)
    assert step == 60
    np.testing.assert_array_equal(np.asarray(st.ssh), s)


def test_checkpoint_resume_continues(tmp_path):
    """Running 2*N steps straight == running N, checkpointing, resuming N."""
    import dataclasses

    from ocean_model_arch_tpu.model.model import OceanModel, load_config_dir

    d = _run_dir(tmp_path, "none", 40, 30, steps_min=0.5,
                 duration_days=60.0 / 86400.0)
    cfg = load_config_dir(d)
    m1 = OceanModel(cfg, base_dir=d)
    full = m1.run(verbose=False)

    half = dataclasses.replace(
        cfg, run=dataclasses.replace(cfg.run, run_duration_days=30.0 / 86400.0))
    m2 = OceanModel(half, base_dir=d)
    ck = str(tmp_path / "half.npz")
    m2.run(checkpoint_path=ck, verbose=False)

    resumed_cfg = dataclasses.replace(
        cfg, run=dataclasses.replace(cfg.run, start_type=1))
    m3 = OceanModel(resumed_cfg, base_dir=d)
    final = m3.run(checkpoint_path=ck, verbose=False)
    np.testing.assert_allclose(np.asarray(final.ssh), np.asarray(full.ssh),
                               rtol=0, atol=0)


def test_checkpoint_resume_orbax(tmp_path):
    """Same resume-equivalence through the orbax (per-shard) format;
    resume auto-detects the directory checkpoint."""
    import dataclasses

    from ocean_model_arch_tpu.model.model import OceanModel, load_config_dir

    d = _run_dir(tmp_path, "none", 40, 30, steps_min=0.5,
                 duration_days=60.0 / 86400.0)
    cfg = load_config_dir(d)
    full = OceanModel(cfg, base_dir=d).run(verbose=False)

    half = dataclasses.replace(
        cfg, run=dataclasses.replace(cfg.run,
                                     run_duration_days=30.0 / 86400.0))
    ck = str(tmp_path / "half_orbax")
    OceanModel(half, base_dir=d).run(checkpoint_path=ck, verbose=False,
                                     checkpoint_format="orbax")
    assert os.path.isdir(ck)

    resumed_cfg = dataclasses.replace(
        cfg, run=dataclasses.replace(cfg.run, start_type=1))
    final = OceanModel(resumed_cfg, base_dir=d).run(checkpoint_path=ck,
                                                    verbose=False)
    np.testing.assert_allclose(np.asarray(final.ssh), np.asarray(full.ssh),
                               rtol=0, atol=0)


def test_sharded_checkpoint_roundtrip(tmp_path):
    """Orbax per-shard checkpointing (the multi-host MPI-IO analog):
    a state sharded over a 2x4 mesh saves without host gather and
    restores bit-exactly INTO a requested sharding."""
    import dataclasses as dc

    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from ocean_model_arch_tpu.config import (ModelConfig, Precision,
                                             SWConfig, basinpar_flat)
    from ocean_model_arch_tpu.core.grid import build_grid
    from ocean_model_arch_tpu.core.masks import frame_of_land_mask
    from ocean_model_arch_tpu.io.checkpoint import (
        load_checkpoint_sharded, save_checkpoint_sharded)
    from ocean_model_arch_tpu.model.init import init_ocean_state
    from ocean_model_arch_tpu.model.sharded import prepare
    from ocean_model_arch_tpu.parallel.mesh import make_mesh

    basin = basinpar_flat(36, 36)
    prec = Precision.f32()
    cfg = ModelConfig(basin=basin, sw=SWConfig(use_tracers=1, tracer_num=1),
                      precision=prec)
    grid = build_grid(basin, frame_of_land_mask(36, 36), precision=prec)
    state = init_ocean_state(grid, cfg)
    mesh = make_mesh(2, 4)
    _, ss = prepare(grid, state, mesh)

    path = str(tmp_path / "ck_orbax")
    save_checkpoint_sharded(path, ss, step=7)

    sh = NamedSharding(mesh, P("x", "y"))
    shardings = {f.name: sh for f in dc.fields(ss)
                 if getattr(ss, f.name) is not None
                 and getattr(ss, f.name).ndim == 2}
    restored, step = load_checkpoint_sharded(path, shardings)
    assert step == 7
    for f in dc.fields(ss):
        a, b = getattr(ss, f.name), getattr(restored, f.name)
        if a is None:
            assert b is None
            continue
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        if f.name in shardings:
            assert b.sharding == sh, f.name
    # unsharded restore also round-trips
    restored2, step2 = load_checkpoint_sharded(path)
    assert step2 == 7
    np.testing.assert_array_equal(np.asarray(restored2.ssh),
                                  np.asarray(ss.ssh))


def test_driver_sharded_mesh(tmp_path):
    """The driver on a 2x2 device mesh matches the single-device run."""
    import dataclasses

    from ocean_model_arch_tpu.model.model import OceanModel, load_config_dir

    d = _run_dir(tmp_path, "none", 40, 30, steps_min=0.5,
                 duration_days=60.0 / 86400.0)
    cfg = load_config_dir(d)
    ref = OceanModel(cfg, base_dir=d).run(verbose=False)

    cfg2 = dataclasses.replace(
        cfg, parallel=dataclasses.replace(cfg.parallel, mesh_x=2, mesh_y=2))
    out = OceanModel(cfg2, base_dir=d).run(verbose=False)
    np.testing.assert_allclose(np.asarray(out.ssh), np.asarray(ref.ssh),
                               rtol=0, atol=1e-12)


def test_ctl_roundtrip(tmp_path):
    p = str(tmp_path / "ssh.dat")
    ctl = grads.write_ctl(p, nx=20, ny=14, nt=3, x0=27.5, hx=0.05,
                          y0=41.0, hy=0.04, title="SSH, m", varname="ssh")
    meta = grads.read_ctl(ctl)
    assert meta["dset"] == "ssh.dat"
    assert meta["nx"] == 20 and meta["ny"] == 14 and meta["nt"] == 3
    assert abs(meta["x0"] - 27.5) < 1e-12 and abs(meta["hx"] - 0.05) < 1e-12
    assert meta["varname"] == "ssh"
    assert meta["undef"] < -1e31


def test_driver_reads_binary_bathymetry(tmp_path):
    """bottom_topography_file_name != none: real4 record ingestion
    (init_grid_data, init_data.f90:112-121)."""
    import dataclasses

    from ocean_model_arch_tpu.model.model import OceanModel, load_config_dir

    nx, ny = 40, 30
    d = _run_dir(tmp_path, "none", nx, ny, steps_min=0.5,
                 duration_days=30.0 / 86400.0)
    # depth ramp written in the reference record format
    depth = np.zeros((nx, ny))
    depth[2:-2, 2:-2] = 50.0 + np.linspace(0, 100, nx - 4)[:, None]
    lu = np.zeros((nx, ny), np.float32)
    lu[2:-2, 2:-2] = 1.0
    topo = str(tmp_path / "topo.dat")
    grads.write_record(topo, 1, depth, lu)
    # point basin.par at it
    bp = (tmp_path / "basin.par").read_text().replace(
        "none : topo", "topo.dat : topo")
    (tmp_path / "basin.par").write_text(bp)

    cfg = load_config_dir(str(tmp_path))
    m = OceanModel(cfg, base_dir=str(tmp_path))
    hr = np.asarray(m.grid.hhq_rest)
    np.testing.assert_allclose(hr[2:-2, 2:-2],
                               depth[2:-2, 2:-2].astype(np.float32))
    st = m.run(verbose=False)
    assert np.isfinite(np.asarray(st.ssh)).all()


def test_decomposition_config_tail(tmp_path):
    """parallel.par's decomposition tail: parallel_dbg >= 3 writes
    decomposition.txt (the reference's debug ladder,
    decomposition.f90:895-909), unknown modes abort like abort_model
    ('Unknown decomposition mode!', :888), and mod_decomposition=2 reads
    cut lines back from a decomposition.txt-format file."""
    import pytest
    from ocean_model_arch_tpu.model.model import OceanModel, load_config_dir
    from ocean_model_arch_tpu.parallel import decomposition as dd

    mask = os.path.join(REPO, "data/BS/mask_bs4km.txt")
    d = _run_dir(tmp_path, mask, 289, 163, steps_min=-1.0,
                 duration_days=0.00002, parallel_dbg=3)
    cfg = load_config_dir(d)
    assert cfg.parallel.debug_level == 3
    model = OceanModel(cfg, base_dir=d)
    model.run(verbose=False)
    p = os.path.join(d, "RESULTS", "decomposition.txt")
    assert os.path.exists(p)
    back = dd.read_decomposition(p)
    assert (back.bnx, back.bny) == (1, 1)
    assert int(back.weights.sum()) == int(
        (np.asarray(model.grid.lu) > 0.5).sum())

    # unknown decomposition mode aborts at startup
    (tmp_path / "bad").mkdir()
    d2 = _run_dir(tmp_path / "bad", mask, 289, 163, mod_decomposition=7)
    with pytest.raises(ValueError, match="Unknown decomposition mode"):
        OceanModel(load_config_dir(d2), base_dir=d2)

    # mod_decomposition=2: cuts read back from a decomposition file
    # (block grid 2x2 uniformly owned by the run's 1x1 device mesh)
    intm = (np.asarray(model.grid.lu) < 0.5).astype(np.int32)
    dec = dd.assign_uniform(dd.block_weights(intm, 2, 2), 1, 1)
    dd.dump_decomposition(dec, str(tmp_path / "cuts.txt"))
    (tmp_path / "m2").mkdir()
    d3 = _run_dir(tmp_path / "m2", mask, 289, 163, mod_decomposition=2,
                  decomposition_file=str(tmp_path / "cuts.txt"))
    m3 = OceanModel(load_config_dir(d3), base_dir=d3)
    xe, ye = m3._file_cuts
    assert xe[0] == 0 and xe[-1] == 289 and len(xe) == 2  # mesh 1x1: px=1
    assert ye[0] == 0 and ye[-1] == 163


def test_driver_halo_self_test_at_debug2(tmp_path):
    """parallel_dbg >= 2 on a mesh runs the startup halo self-test (the
    reference's sync_test hook, init_data.f90:41-44) and reports it."""
    import dataclasses
    import io as _io
    from contextlib import redirect_stdout

    from ocean_model_arch_tpu.model.model import OceanModel, load_config_dir

    d = _run_dir(tmp_path, "none", 48, 40, steps_min=-1.0,
                 duration_days=10.0 / 86400.0, parallel_dbg=2)
    cfg = load_config_dir(d)
    cfg = dataclasses.replace(
        cfg, parallel=dataclasses.replace(cfg.parallel, mesh_x=2,
                                          mesh_y=2))
    model = OceanModel(cfg, base_dir=d)
    buf = _io.StringIO()
    with redirect_stdout(buf):
        model.run(verbose=True)
    assert "halo self-test passed" in buf.getvalue()


def test_periodic_checkpointing(tmp_path):
    """checkpoint_every writes restart points DURING the run; resuming
    from the mid-run restart reproduces the straight run exactly
    (production restart safety; the reference only writes diagnostics
    mid-run)."""
    import dataclasses
    import io as _io
    from contextlib import redirect_stdout

    from ocean_model_arch_tpu.model.model import OceanModel, load_config_dir

    d = _run_dir(tmp_path, "none", 40, 30, steps_min=0.5,
                 duration_days=60.0 / 86400.0)   # 60 steps, 30/window
    cfg = load_config_dir(d)
    full = OceanModel(cfg, base_dir=d).run(verbose=False)

    ck = str(tmp_path / "restart.npz")
    m = OceanModel(cfg, base_dir=d)
    # simulate a crash DURING the second window, after the step-30
    # restart point was written but before the end-of-run save: hook
    # the per-window output (runs before the restart block), so the
    # crash fires at nrec=3 when the step-30 restart already exists
    orig_out = m._output

    def out_hook(state, nrec):
        orig_out(state, nrec)
        if nrec >= 3:
            assert os.path.exists(ck)
            raise KeyboardInterrupt
    m._output = out_hook
    buf = _io.StringIO()
    with redirect_stdout(buf):
        try:
            m.run(checkpoint_path=ck, verbose=True, checkpoint_every=30)
            raise AssertionError("crash hook never fired")
        except KeyboardInterrupt:
            pass
    assert "restart point at step 30" in buf.getvalue()

    # the surviving file is the MID-RUN restart (step 30); resuming it
    # must reproduce the straight 60-step run bit-for-bit
    from ocean_model_arch_tpu.io.checkpoint import load_checkpoint
    _, step30 = load_checkpoint(ck)
    assert step30 == 30
    resumed_cfg = dataclasses.replace(
        cfg, run=dataclasses.replace(cfg.run, start_type=1))
    final = OceanModel(resumed_cfg, base_dir=d).run(checkpoint_path=ck,
                                                    verbose=False)
    np.testing.assert_allclose(np.asarray(final.ssh),
                               np.asarray(full.ssh), rtol=0, atol=0)


def test_cut_line_policy_decided_at_init(tmp_path):
    """Non-uniform cut lines are a CONSTRUCTION-time decision, not a
    run-time surprise. Where the fused-sharded path cannot be selected
    (an f64 config), mod_decomposition=2 raises at OceanModel() with the
    blocker named, and mod_decomposition=1 constructs with an explicit
    uniform-fallback notice; in f32 the same file cuts select the
    fused-sharded path, on any backend."""
    import dataclasses
    import io
    from contextlib import redirect_stdout

    import pytest
    from ocean_model_arch_tpu.config import ParallelConfig
    from ocean_model_arch_tpu.parallel import decomposition as dd

    from ocean_model_arch_tpu.model.model import OceanModel, \
        load_config_dir

    mask = os.path.join(REPO, "data/BS/mask_bs4km.txt")
    d = _run_dir(tmp_path, mask, 289, 163)
    cfg = load_config_dir(d)

    # file cuts for a 2x1 mesh
    m = np.asarray(read_mask(mask, 289, 163))
    dec = dd.assign_uniform(dd.block_weights(m, 2, 2), 2, 1)
    cuts = str(tmp_path / "cuts2.txt")
    dd.dump_decomposition(dec, cuts)

    cfg2 = dataclasses.replace(cfg, parallel=ParallelConfig(
        mod_decomposition=2, file_decomposition=cuts,
        mesh_x=2, mesh_y=1))
    with pytest.raises(ValueError, match="f64 precision"):
        OceanModel(cfg2, base_dir=d)
    from ocean_model_arch_tpu.config import Precision
    from ocean_model_arch_tpu.model.model import PATH_FUSED_SHARDED
    om2 = OceanModel(dataclasses.replace(cfg2, precision=Precision.f32()),
                     base_dir=d)
    assert om2.path == PATH_FUSED_SHARDED

    cfg1 = dataclasses.replace(cfg, parallel=ParallelConfig(
        mod_decomposition=1, mesh_x=2, mesh_y=1))
    buf = io.StringIO()
    with redirect_stdout(buf):
        om = OceanModel(cfg1, base_dir=d)
    assert "falling back to uniform cuts" in buf.getvalue()
    assert om.mesh is not None          # the run still proceeds
