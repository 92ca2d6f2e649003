"""End-to-end IMAGE-pipeline throughput on the device: pixels -> SIFT ->
match -> F-verify -> incremental reconstruction, timed per stage.

The north-star metric is e2e frames/s on the image path.  Renders an
N-image synthetic scene (scripts/synth_dataset.py), then runs the real
pipeline entry points with a warm compilation cache and prints ONE JSON
line: {n_images, extract_s, match_s, reconstruct_s, total_s,
frames_per_s, registered, ate_pct}.

Usage: python scripts/e2e_bench.py [--n_images 96] [--scene corridor]
       [--workdir DIR] [--steady]

--steady runs each phase twice in this process and reports the second
pass (jit warm-up paid once, as in a long-lived service).
"""

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n_images", type=int, default=96)
    ap.add_argument("--scene", default="corridor")
    ap.add_argument("--workdir",
                    default=os.path.join(tempfile.gettempdir(), "e2e_bench"))
    # steady-state mode: run each phase twice in this process and report
    # the second pass (per-process jit warm-up paid once)
    ap.add_argument("--steady", action="store_true")
    args = ap.parse_args()

    import jax

    from xrsfm_tpu import enable_compilation_cache

    enable_compilation_cache()
    import numpy as np
    import synth_dataset as sd

    ws = args.workdir
    shutil.rmtree(ws, ignore_errors=True)
    sd.main(ws, n_cams=args.n_images, scene=args.scene)

    from xrsfm_tpu.pipelines import run_matching as RM
    from xrsfm_tpu.pipelines import run_reconstruction as RR

    images = os.path.join(ws, "images")
    bin_dir = os.path.join(ws, "bins")
    os.makedirs(bin_dir, exist_ok=True)
    names = __import__("xrsfm_tpu.utils.io_features",
                       fromlist=["x"]).load_image_names(images)

    passes = 2 if args.steady else 1
    for _pass in range(passes):
        if _pass:  # second pass re-does the work with jits warm
            os.remove(os.path.join(bin_dir, "ftr.bin"))
            for fp in ("fp.bin", "fp_init.bin"):
                p = os.path.join(bin_dir, fp)
                if os.path.exists(p):
                    os.remove(p)
        t0 = time.time()
        feats = RM.get_features(images, os.path.join(bin_dir, "ftr.bin"),
                                names, verbose=False)
        extract_s = time.time() - t0
        t0 = time.time()
        RM.main(images, "", "sequential", bin_dir)
        match_s = time.time() - t0  # features cached: pure match+verify
        t0 = time.time()
        m = RR.main(bin_dir, os.path.join(ws, "camera.txt"),
                    os.path.join(ws, "model"))
        reconstruct_s = time.time() - t0
    reg = int(np.count_nonzero(m.registered)) if m is not None else 0

    ate_pct = None
    gt = os.path.join(ws, "gt_poses.txt")
    if m is not None and os.path.exists(gt):
        from xrsfm_tpu.ops.umeyama import ate_rmse
        from xrsfm_tpu.utils import geometry as G

        gtp = {}
        for line in open(gt):
            p = line.split()
            gtp[p[0]] = (np.array(list(map(float, p[1:5]))),
                         np.array(list(map(float, p[5:8]))))
        est_c, gt_c = [], []
        for i in range(m.num_frames):
            if m.registered[i] and m.names[i] in gtp:
                est_c.append(G.pose_center_np(np.asarray(m.q[i]),
                                              np.asarray(m.t[i])))
                gt_c.append(G.pose_center_np(*gtp[m.names[i]]))
        est_c, gt_c = np.asarray(est_c), np.asarray(gt_c)
        span = float(np.linalg.norm(gt_c.max(0) - gt_c.min(0)))
        ate_pct = round(100.0 * float(ate_rmse(gt_c, est_c)) / span, 3)

    total = extract_s + match_s + reconstruct_s
    dev = jax.devices()[0]
    out = {
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "mode": "steady" if args.steady else "fresh_process",
        "n_images": args.n_images,
        "n_feats_mean": int(np.mean([len(f.keypoints) for f in feats])),
        "extract_s": extract_s,
        "match_s": match_s,
        "reconstruct_s": reconstruct_s,
        "total_s": total,
        "frames_per_s": args.n_images / total,
        "registered": reg,
        "ate_pct_span": ate_pct,
    }
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
