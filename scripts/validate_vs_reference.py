#!/usr/bin/env python
"""A/B validation against the Fortran reference's output files.

The build environment has no Fortran toolchain, so the reference binary
cannot be compiled here; this script completes the validation loop
whenever reference outputs are available:

1. On any machine with gfortran+MPI, build and run the reference
   (`make gcc && mpirun -n N ./model`) with a chosen
   basin.par/sw.par/ocean_run.par; it writes RESULTS/ssh.dat (+ hhq.dat,
   ff1.dat) as real4 direct-access records of the (nx-4)x(ny-4) interior.
2. Run this script with the same config directory; it runs this
   framework in f64 validation mode for the same number of steps and
   compares every output record (our reader ingests the reference's
   files byte-compatibly — io/grads.py).

Usage:
  python scripts/validate_vs_reference.py CONFIG_DIR REFERENCE_RESULTS_DIR
         [--rtol 1e-9] [--atol 1e-9] [--f32] [--precomputed]

``--precomputed``: do NOT re-run this framework — compare the reference
results against the COMMITTED records in CONFIG_DIR/RESULTS_TPU (the
10k-step Black Sea bundle generated by scripts/make_validation_bundle.py
lives in examples/validation_bs10k). This closes the BASELINE 10k-step
correctness gate on a gfortran machine with one command and no JAX run.
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main():
    p = argparse.ArgumentParser()
    p.add_argument("config_dir")
    p.add_argument("reference_results")
    p.add_argument("--rtol", type=float, default=1e-9)
    p.add_argument("--atol", type=float, default=1e-9)
    p.add_argument("--f32", action="store_true")
    p.add_argument("--precomputed", action="store_true",
                   help="compare against the committed RESULTS_TPU "
                        "records instead of re-running the framework")
    args = p.parse_args()

    import dataclasses

    from ocean_model_arch_tpu.config import Precision
    from ocean_model_arch_tpu.io import grads

    if args.precomputed:
        from ocean_model_arch_tpu.config import (load_basinpar,  # noqa
                                                 load_runpar, load_sw)
        from ocean_model_arch_tpu.config import ModelConfig
        cfg = ModelConfig(
            basin=load_basinpar(os.path.join(args.config_dir,
                                             "basin.par")),
            sw=load_sw(os.path.join(args.config_dir, "sw.par")),
            run=load_runpar(os.path.join(args.config_dir,
                                         "ocean_run.par")))
    else:
        import jax

        from ocean_model_arch_tpu.model.model import (OceanModel,
                                                      load_config_dir)
        cfg = load_config_dir(args.config_dir)
        if args.f32:
            cfg = dataclasses.replace(cfg, precision=Precision.f32())
        else:
            jax.config.update("jax_enable_x64", True)

        model = OceanModel(cfg, base_dir=args.config_dir,
                           results_dir=os.path.join(args.config_dir,
                                                    "RESULTS_TPU"))
        model.run(verbose=False)

    basin = cfg.basin
    n_rec = 1 + (cfg.run.num_step_max // cfg.run.output_every_steps
                 if cfg.run.output_every_steps else 0)
    worst = 0.0
    n_bad = 0
    for name in ("ssh", "hhq") + (("ff1",) if cfg.sw.use_tracers else ()):
        ref_p = os.path.join(args.reference_results, f"{name}.dat")
        our_p = os.path.join(args.config_dir, "RESULTS_TPU", f"{name}.dat")
        if not os.path.exists(ref_p):
            print(f"SKIP {name}: no reference file")
            continue
        recs = 1 if name == "hhq" else n_rec
        for r in range(1, recs + 1):
            a = grads.read_record(ref_p, r, basin.nx, basin.ny)
            b = grads.read_record(our_p, r, basin.nx, basin.ny)
            err = np.abs(a - b)
            scale = np.maximum(np.abs(a), 1.0)
            rel = float((err / scale).max())
            worst = max(worst, rel)
            ok = np.allclose(a, b, rtol=args.rtol, atol=args.atol)
            status = "OK " if ok else "FAIL"
            if not ok:
                n_bad += 1
            print(f"{status} {name} rec {r}: max rel err {rel:.3e}")
    print(f"worst relative error: {worst:.3e}")
    sys.exit(1 if n_bad else 0)


if __name__ == "__main__":
    main()
