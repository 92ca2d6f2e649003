"""Command-line entry points mirroring the reference's 7 binaries.

(reference: CMakeLists.txt:160-181 — run_matching, run_reconstruction,
run_triangulation, rec_kitti, rec_1dsfm, estimate_scale,
unpack_collect_data)

Usage: python -m xrsfm_tpu.cli <command> [args...]
       python -m xrsfm_tpu.cli <command> --config config.json

Each command also accepts a JSON config file with the same keys the
reference binaries read (run_matching.cc:158-166 etc.); explicit
positional arguments override config values.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None, stats=None):
    """stats (optional dict) is handed to run_matching, which records its
    stage times there."""
    from . import enable_compilation_cache

    enable_compilation_cache()
    argv = argv if argv is not None else sys.argv[1:]
    ap = argparse.ArgumentParser(prog="xrsfm_tpu")
    sub = ap.add_subparsers(dest="cmd", required=True)

    def add(name, help_):
        p = sub.add_parser(name, help=help_)
        p.add_argument("--config", default=None,
                       help="JSON config (reference-compatible keys)")
        p.add_argument("--profile_dir", default=None,
                       help="write a JAX profiler trace here")
        return p

    p = add("run_matching", "matching stage")
    p.add_argument("images_dir", nargs="?")
    p.add_argument("retrieval_path", nargs="?")
    p.add_argument("matching_type", nargs="?",
                   choices=["sequential", "retrieval", "covisibility"])
    p.add_argument("output_dir", nargs="?")
    p.add_argument("--n_devices", type=int, default=1,
                   help="shard descriptor matching over this many devices")

    p = add("retrieve", "build retrieval.txt from images (VLAD; new "
                        "capability — the reference needs an external tool)")
    p.add_argument("images_dir", nargs="?")
    p.add_argument("output_dir", nargs="?")
    p.add_argument("--topk", type=int, default=25)
    p.add_argument("--num_words", type=int, default=64)

    p = add("run_reconstruction", "incremental reconstruction")
    p.add_argument("bin_dir", nargs="?")
    p.add_argument("camera_txt", nargs="?")
    p.add_argument("output_dir", nargs="?")
    p.add_argument("--init_id1", type=int, default=-1)
    p.add_argument("--init_id2", type=int, default=-1)
    p.add_argument("--correct_pose", action="store_true",
                   help="enable drift/loop error correction "
                        "(reference hardcodes this off here and on for "
                        "rec_kitti; exposed as a flag)")
    p.add_argument("--snapshot_every", type=int, default=0,
                   help="checkpoint the mapper state to "
                        "<output_dir>/snapshot.npz every N registrations")
    p.add_argument("--resume", action="store_true",
                   help="resume from <output_dir>/snapshot.npz if present")
    p.add_argument("--n_devices", type=int, default=1,
                   help="shard global BA over this many devices "
                        "(parallel/dist_ba; 1 = single-device)")

    p = add("run_triangulation", "triangulate with known poses")
    p.add_argument("bin_dir", nargs="?")
    p.add_argument("model_dir", nargs="?")
    p.add_argument("output_dir", nargs="?")

    p = add("rec_kitti", "KITTI odometry reconstruction")
    p.add_argument("bin_dir", nargs="?")
    p.add_argument("seq_name", nargs="?")
    p.add_argument("output_dir", nargs="?")
    p.add_argument("--timestamp_path", default="")

    p = add("rec_1dsfm", "1DSfM unordered scene reconstruction")
    p.add_argument("bin_dir", nargs="?")
    p.add_argument("camera_info_path", nargs="?")
    p.add_argument("output_dir", nargs="?")
    p.add_argument("--n_devices", type=int, default=1,
                   help="shard global BA (incl. intrinsics-refining GBA) "
                        "over this many devices")

    p = add("estimate_scale", "AprilTag metric scale")
    p.add_argument("images_dir", nargs="?")
    p.add_argument("model_dir", nargs="?")
    p.add_argument("--tag_length", type=float, default=0.113)

    p = add("unpack_collect_data", "unpack phone capture")
    p.add_argument("input_path", nargs="?")
    p.add_argument("output_dir", nargs="?")

    args = ap.parse_args(argv)
    if getattr(args, "config", None) or _has_missing(args):
        from .utils import config as C

        C.resolve(args.cmd, args, args.config)

    from .utils.profiling import maybe_trace

    with maybe_trace(getattr(args, "profile_dir", None)):
        _dispatch(args, stats)


def _has_missing(args) -> bool:
    return any(
        v is None for k, v in vars(args).items()
        if k not in ("cmd", "config", "profile_dir")
    )


def _dispatch(args, stats=None):
    if args.cmd == "run_matching":
        from .pipelines import run_matching as M

        M.main(args.images_dir, args.retrieval_path, args.matching_type,
               args.output_dir, n_devices=args.n_devices, stats=stats)
    elif args.cmd == "retrieve":
        from .pipelines import retrieve as RV

        RV.main(args.images_dir, args.output_dir, args.topk, args.num_words)
    elif args.cmd == "run_reconstruction":
        from .pipelines import run_reconstruction as R

        R.main(args.bin_dir, args.camera_txt, args.output_dir,
               args.init_id1, args.init_id2,
               correct_pose=args.correct_pose,
               snapshot_every=args.snapshot_every, resume=args.resume,
               n_devices=args.n_devices)
    elif args.cmd == "run_triangulation":
        from .pipelines import run_triangulation as T

        T.main(args.bin_dir, args.model_dir, args.output_dir)
    elif args.cmd == "rec_kitti":
        from .pipelines import rec_kitti as K

        K.main(args.bin_dir, args.seq_name, args.output_dir,
               args.timestamp_path)
    elif args.cmd == "rec_1dsfm":
        from .pipelines import rec_1dsfm as U

        U.main(args.bin_dir, args.camera_info_path, args.output_dir,
               n_devices=args.n_devices)
    elif args.cmd == "estimate_scale":
        from .pipelines import estimate_scale as S

        S.main(args.images_dir, args.model_dir, args.tag_length)
    elif args.cmd == "unpack_collect_data":
        from .pipelines import unpack_collect_data as UC

        UC.main(args.input_path, args.output_dir)


if __name__ == "__main__":
    main()
