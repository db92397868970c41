"""CLI driver: ``python -m ocean_model_arch_tpu [config_dir] [overrides]``.

Mirrors the reference's invocation (./model with basin.par/sw.par/
parallel.par/ocean_run.par in the working directory + positional CLI
overrides, configs/cmd.f90).
"""

import argparse
import sys


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="ocean_model_arch_tpu",
        description="shallow-water ocean model (JAX)")
    p.add_argument("config_dir", nargs="?", default=".",
                   help="directory with basin.par/sw.par/parallel.par/"
                        "ocean_run.par")
    p.add_argument("overrides", nargs="*",
                   help="positional overrides: mod_decomposition bppnx bppny")
    p.add_argument("--mesh", default=None,
                   help="device mesh as PXxPY (e.g. 2x4), or 'auto' to "
                        "pick the wet-balance-optimal factorization of "
                        "all visible devices (choose_mesh_dims)")
    p.add_argument("--results", default=None,
                   help="output directory (default: <config_dir>/RESULTS)")
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--ckpt-format", choices=("npz", "orbax"),
                   default="npz",
                   help="npz = host-gathered file; orbax = per-shard "
                        "tensorstore dir (multi-host)")
    p.add_argument("--f32", action="store_true",
                   help="f32 production precision (default: f64 validation)")
    p.add_argument("--quiet", action="store_true")
    args = p.parse_args(argv)

    import dataclasses

    import jax

    from .utils.cache import enable_compilation_cache
    enable_compilation_cache()

    from .config import Precision
    from .model.model import OceanModel, load_config_dir

    cfg = load_config_dir(args.config_dir, args.overrides)
    if args.f32:
        cfg = dataclasses.replace(cfg, precision=Precision.f32())
    else:
        jax.config.update("jax_enable_x64", True)
    if args.mesh == "auto":
        from .io.mask_io import load_mask
        from .parallel.decomposition import choose_mesh_dims
        int_mask = load_mask(cfg.basin.mask_file_name, cfg.basin.nx,
                             cfg.basin.ny, args.config_dir)
        px, py = choose_mesh_dims(int_mask, jax.device_count())
        print(f"MODEL: auto mesh {px}x{py} "
              f"(wet-balance-optimal for {jax.device_count()} devices)")
        cfg = dataclasses.replace(
            cfg, parallel=dataclasses.replace(cfg.parallel,
                                              mesh_x=px, mesh_y=py))
    elif args.mesh:
        px, py = (int(v) for v in args.mesh.lower().split("x"))
        cfg = dataclasses.replace(
            cfg, parallel=dataclasses.replace(cfg.parallel,
                                              mesh_x=px, mesh_y=py))

    model = OceanModel(cfg, base_dir=args.config_dir,
                       results_dir=args.results)
    model.run(checkpoint_path=args.checkpoint, verbose=not args.quiet,
              checkpoint_format=args.ckpt_format)
    return 0


if __name__ == "__main__":
    sys.exit(main())
