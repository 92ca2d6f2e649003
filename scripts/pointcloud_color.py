#!/usr/bin/env python
"""Write per-point RGB into a COLMAP model from the source images.

Equivalent of the reference's scripts/pointcloud_color_calculator.py:8-45
(sample the image pixel under every observation, average per 3D point,
rewrite points3D.bin) — vectorized: one fancy-index gather per image and
one scatter-add into the accumulators instead of the reference's
per-observation Python loop.

Usage: python scripts/pointcloud_color.py --image_dir DIR --bin_dir MODEL
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

from xrsfm_tpu.utils import io_colmap as IOC  # noqa: E402


def add_color(image_dir: str, bin_dir: str) -> int:
    """Returns the number of points that received a color."""
    from xrsfm_tpu.utils import image_io

    images = IOC.read_images_bin(os.path.join(bin_dir, "images.bin"))
    points = IOC.read_points3d_bin(os.path.join(bin_dir, "points3D.bin"))
    if not points:
        return 0
    max_id = max(points.keys())
    acc = np.zeros((max_id + 1, 3), np.float64)
    cnt = np.zeros(max_id + 1, np.int64)
    for img in images.values():
        path = os.path.join(image_dir, img.name)
        if not os.path.exists(path):
            continue
        cv = image_io.read_image(path)
        if cv.ndim == 2:
            cv = np.repeat(cv[:, :, None], 3, axis=2)
        cv = cv[:, :, :3]
        h, w, _ = cv.shape
        ids = np.asarray(img.point3D_ids, np.int64)
        xy = np.asarray(img.xys, np.float64)
        ok = (ids >= 0) & (ids <= max_id)
        x = xy[:, 0].astype(np.int64)
        y = xy[:, 1].astype(np.int64)
        ok &= (x >= 0) & (x < w) & (y >= 0) & (y < h)
        ids, x, y = ids[ok], x[ok], y[ok]
        np.add.at(acc, ids, cv[y, x])
        np.add.at(cnt, ids, 1)
    n_colored = 0
    for pid, p in points.items():
        if cnt[pid] > 0:
            p.rgb = np.clip(acc[pid] / cnt[pid], 0, 255).astype(np.uint8)
            n_colored += 1
    IOC.write_points3d_bin(os.path.join(bin_dir, "points3D.bin"), points)
    return n_colored


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--image_dir", required=True)
    ap.add_argument("--bin_dir", required=True)
    a = ap.parse_args()
    n = add_color(a.image_dir, a.bin_dir)
    print(f"colored {n} points in {a.bin_dir}/points3D.bin", flush=True)


if __name__ == "__main__":
    main()
