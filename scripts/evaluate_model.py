#!/usr/bin/env python
"""Evaluate a reconstructed COLMAP model against ground-truth poses.

Usage: python scripts/evaluate_model.py <model_dir> <gt_poses.txt>

gt_poses.txt: `name qw qx qy qz tx ty tz` (Tcw), as written by
synth_dataset.py.  Reports sim3-aligned ATE RMSE, per-pair relative pose
errors, and reconstruction statistics.
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def evaluate(model_dir: str, gt_poses: str) -> dict:
    """Metrics of a COLMAP model against gt_poses.txt: frames, registered,
    points, mean_track, ate, span, ate_pct, reproj_mean_px,
    reproj_median_px, reproj_p95_px, rot_mean_deg, rot_max_deg."""
    from xrsfm_tpu.ops.umeyama import ate_rmse
    from xrsfm_tpu.utils import geometry as G
    from xrsfm_tpu.utils import io_colmap as IOC

    imgs = IOC.read_images_bin(os.path.join(model_dir, "images.bin"))
    pts = IOC.read_points3d_bin(os.path.join(model_dir, "points3D.bin"))
    gt = {}
    for line in open(gt_poses):
        p = line.split()
        gt[p[0]] = (
            np.array(list(map(float, p[1:5]))),
            np.array(list(map(float, p[5:8]))),
        )
    est_c, gt_c, names = [], [], []
    for im in sorted(imgs.values(), key=lambda im: im.name):
        if im.name not in gt:
            continue
        est_c.append(
            G.pose_center_np(im.qvec, im.tvec)
        )
        qg, tg = gt[im.name]
        gt_c.append(
            G.pose_center_np(qg, tg)
        )
        names.append(im.name)
    est_c = np.asarray(est_c)
    gt_c = np.asarray(gt_c)
    ate = ate_rmse(gt_c, est_c)
    span = np.linalg.norm(gt_c.max(0) - gt_c.min(0))
    tl = [len(p.image_ids) for p in pts.values()]

    # mean reprojection error over all observations (host numpy)
    cams = IOC.read_cameras_bin(os.path.join(model_dir, "cameras.bin"))
    from xrsfm_tpu.utils import camera as Cam

    xyz = {pid: p.xyz for pid, p in pts.items()}
    uvn_all, cp_all, obs_xy = [], [], []
    for im in imgs.values():
        R = G.quat_to_rotmat_np(im.qvec)
        cam = cams[im.camera_id]
        cp = Cam.canonicalize_params(cam.model_id, cam.params)
        for (x, y), pid in zip(im.xys, im.point3D_ids):
            if pid < 0 or pid not in xyz:
                continue
            pc = R @ xyz[pid] + im.tvec
            if pc[2] <= 1e-6:
                continue
            uvn_all.append(pc[:2] / pc[2])
            cp_all.append(cp)
            obs_xy.append((x, y))
    if uvn_all:
        # one batched call for all observations
        pix = np.asarray(Cam.normalized_to_image(
            np.asarray(cp_all, np.float32), np.asarray(uvn_all, np.float32)
        ))
        errs = np.linalg.norm(pix - np.asarray(obs_xy), axis=1)
    else:
        errs = np.zeros(0)

    # per-frame rotation error vs GT (relative rotation drift, gauge-free:
    # align est->gt with the rotation that matches the first frame)
    rot_errs = []
    by_name = {im.name: im for im in imgs.values()}
    for i, name in enumerate(names):
        qg, _ = gt[name]
        qe = by_name[name].qvec
        # world-alignment rotation R_est^T R_gt — constant across frames
        # for a perfect reconstruction; its per-frame spread is the
        # rotation drift
        q_rel = G.quat_mul_np(qe * np.array([1.0, -1, -1, -1]), qg)
        rot_errs.append(q_rel)
    q0 = rot_errs[0]
    ang = []
    for q_rel in rot_errs:
        dq = G.quat_mul_np(q_rel, q0 * np.array([1.0, -1, -1, -1]))
        ang.append(2 * np.degrees(np.arccos(np.clip(abs(dq[0]), -1, 1))))

    nan = float("nan")
    return {
        "frames": len(gt), "registered": len(est_c), "points": len(pts),
        "mean_track": float(np.mean(tl)) if tl else nan,
        "ate": ate, "span": float(span),
        "ate_pct": 100 * ate / max(span, 1e-9),
        "reproj_mean_px": float(errs.mean()) if len(errs) else nan,
        "reproj_median_px": float(np.median(errs)) if len(errs) else nan,
        "reproj_p95_px": float(np.percentile(errs, 95)) if len(errs) else nan,
        "rot_mean_deg": float(np.mean(ang)),
        "rot_max_deg": float(np.max(ang)),
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("model_dir")
    ap.add_argument("gt_poses")
    a = ap.parse_args()
    ev = evaluate(a.model_dir, a.gt_poses)
    print(f"registered: {ev['registered']}/{ev['frames']} frames")
    print(f"points: {ev['points']}, mean track length {ev['mean_track']:.2f}")
    print(
        f"reprojection error: mean {ev['reproj_mean_px']:.3f}px  "
        f"median {ev['reproj_median_px']:.3f}px  "
        f"p95 {ev['reproj_p95_px']:.3f}px"
    )
    print(f"rotation error vs GT: mean {ev['rot_mean_deg']:.3f} deg  "
          f"max {ev['rot_max_deg']:.3f} deg")
    print(f"ATE (sim3-aligned) RMSE: {ev['ate']:.5f}  "
          f"({ev['ate_pct']:.3f}% of span {ev['span']:.2f})")
    return ev["ate"]


if __name__ == "__main__":
    main()
