"""AprilTag metric scale estimation pipeline.

(reference: src/estimate_scale.cc:17-32 -> tag_refine,
src/tag/tag_extract.hpp:133-277; tag side defaults to 0.113 m per
docs/en/faq.md)

Reads a COLMAP model + images, detects tags, triangulates corners with
fixed poses, estimates the global metric scale, rescales the model in
place, and rewrites the binaries.
"""

from __future__ import annotations

import os
import time

import numpy as np

from ..base.colmap_bridge import colmap_to_map, map_to_colmap
from ..feature import tags as T


def main(images_dir: str, model_dir: str, tag_length: float = 0.113):
    from ..utils import image_io

    t0 = time.time()
    m = colmap_to_map(model_dir)
    detections = {}
    n_det = 0
    for fid, name in enumerate(m.names):
        path = os.path.join(images_dir, name)
        if not os.path.exists(path):
            continue
        img = image_io.read_gray(path)
        tags = T.detect_tags(img)
        if tags:
            detections[fid] = tags
            n_det += len(tags)
    print(f"[estimate_scale] {n_det} tag detections in "
          f"{len(detections)} frames", flush=True)
    corners = T.triangulate_tag_corners(m, detections)
    scale, poses = T.estimate_scale_from_corners(corners, tag_length)
    if scale <= 0:
        print("[estimate_scale] no usable tags; model unchanged", flush=True)
        return None
    # joint refinement against all corner reprojections (reference:
    # second Ceres solve, tag_extract.hpp:237-265)
    scale = T.joint_refine_scale(
        m, detections, corners, scale, poses, tag_length
    )
    T.apply_metric_scale(m, scale)
    map_to_colmap(m, model_dir)
    print(
        f"[estimate_scale] scale {scale:.6f} (1 m = {scale:.4f} units), "
        f"model rescaled in {time.time() - t0:.1f}s",
        flush=True,
    )
    return scale
