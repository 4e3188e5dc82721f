"""CLI entrypoint — same surface as the reference
(`/root/reference/exp_runner.py:665-719`):

    python exp_runner.py --mode {train_rnb, validate_mesh, validate_mesh_texture,
                                 validate_image_ps, interpolate_i_j}
                         --conf CONF --case CASE
                         [--mcube_threshold T] [--is_continue] [--no_albedo]
                         [--shard auto|off|N]

Differences: ``--gpu`` is replaced by ``--shard`` (device-mesh width; the
reference selects one CUDA device, we shard over every visible device); the broken
``validate_image_ps`` mode works here (SURVEY.md §Fidelity).
"""

from __future__ import annotations

import argparse
import logging
import os


def main(argv=None):
    FORMAT = "[%(filename)s:%(lineno)s - %(funcName)20s() ] %(message)s"
    logging.basicConfig(level=logging.INFO, format=FORMAT)

    if os.environ.get("RNB_DEBUG_NANS", "0") == "1":
        import jax
        jax.config.update("jax_debug_nans", True)

    parser = argparse.ArgumentParser(description="rnb_tpu experiment runner")
    parser.add_argument("--conf", type=str, default="./confs/wmask_rnb.conf")
    parser.add_argument("--mode", type=str, default="train_rnb")
    parser.add_argument("--mcube_threshold", type=float, default=0.0)
    parser.add_argument("--is_continue", default=False, action="store_true")
    parser.add_argument("--case", type=str, default="")
    parser.add_argument("--no_albedo", default=False, action="store_true")
    parser.add_argument("--shard", type=str, default="auto",
                        help="'auto' | 'off' | integer mesh width")
    parser.add_argument("--set", dest="overrides", action="append", default=[],
                        metavar="PATH=VALUE",
                        help="conf override, e.g. --set train.end_iter=1000 "
                             "--set train.batch_size=2048 (repeatable; "
                             "replaces the reference jobs' heredoc-templated "
                             "per-case confs)")
    parser.add_argument("--mesh_resolution", type=int, default=512,
                        help="marching-cubes grid resolution for final/CLI "
                             "extraction (reference uses 512, "
                             "exp_runner.py:697,702)")
    args = parser.parse_args(argv)

    from rnb_tpu.parallel.mesh import maybe_initialize_distributed
    maybe_initialize_distributed()

    shard = args.shard
    if shard not in ("auto", "off"):
        shard = int(shard)
    elif shard == "off":
        shard = 1

    from rnb_tpu.train.runner import Runner

    if args.mode == "train_rnb":
        runner = Runner(args.conf, args.mode, args.case, args.is_continue,
                        args.no_albedo, shard=shard,
                        overrides=args.overrides)
        runner.train_rnb()
        runner.validate_mesh(world_space=True, resolution=args.mesh_resolution,
                             threshold=args.mcube_threshold)
    elif args.mode == "validate_mesh":
        runner = Runner(args.conf, args.mode, args.case, True,
                        args.no_albedo, shard=shard,
                        overrides=args.overrides)
        runner.validate_mesh(world_space=True, resolution=args.mesh_resolution,
                             threshold=args.mcube_threshold)
    elif args.mode == "validate_mesh_texture":
        runner = Runner(args.conf, args.mode, args.case, True,
                        args.no_albedo, shard=shard,
                        overrides=args.overrides)
        runner.validate_mesh_texture(world_space=True,
                                     resolution=args.mesh_resolution,
                                     threshold=args.mcube_threshold)
    elif args.mode == "validate_image_ps":
        runner = Runner(args.conf, args.mode, args.case, True,
                        args.no_albedo, shard=shard,
                        overrides=args.overrides)
        runner.validate_image_ps()
    elif args.mode.startswith("interpolate"):
        _, i0, i1 = args.mode.split("_")
        runner = Runner(args.conf, args.mode, args.case, True,
                        args.no_albedo, shard=shard,
                        overrides=args.overrides)
        runner.interpolate_view(int(i0), int(i1))
    else:
        raise SystemExit(f"unknown mode {args.mode!r}")


if __name__ == "__main__":
    main()
