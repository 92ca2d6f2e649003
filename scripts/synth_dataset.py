#!/usr/bin/env python
"""Render a synthetic multi-view dataset (images + camera.txt + GT poses).

Serves the role of the reference's test_data workspace (README.md:55-63):
a small end-to-end smoke dataset — but generated, so ground truth poses
are known and ATE can be measured.

Scenes (all ray-cast textured Lambertian planes, so every pixel observes
a fixed 3D point and features are fully view-consistent):
  arc       (default) wall + floor viewed from an arc of cameras
  loop      square room, cameras on a full 360-degree circle looking
            tangentially — sequential mapping accumulates drift that the
            loop-closure / error-correction path must fix
  corridor  KITTI-like forward motion between two side walls + floor

Output layout:
  <out>/images/*.png
  <out>/camera.txt          (reference single-camera format)
  <out>/gt_poses.txt        (name qw qx qy qz tx ty tz, Tcw)
  <out>/retrieval.txt       (ranked pairs, view-overlap order)
  <out>/times.txt           (corridor only: KITTI-style timestamps)
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def look_at_R(center, target, up=(0.0, -1.0, 0.0)):
    z = np.asarray(target, np.float64) - center
    z /= np.linalg.norm(z)
    x = np.cross(up, z)
    if np.linalg.norm(x) < 1e-9:
        x = np.array([1.0, 0, 0])
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    return np.stack([x, y, z])


def make_texture(rng, res=1024, smooth=3):
    """Random smooth texture (Gaussian-blurred noise)."""
    from scipy.ndimage import gaussian_filter

    t = rng.uniform(0, 1, (res, res)).astype(np.float32)
    t = gaussian_filter(t, smooth, mode="mirror", truncate=4.0)
    t = (t - t.min()) / (t.max() - t.min() + 1e-9)
    return t


class Plane:
    """Textured finite plane: p0 + a*ex + b*ey, (a, b) in [0, 1]^2."""

    def __init__(self, p0, ex, ey, tex):
        self.p0 = np.asarray(p0, np.float64)
        self.ex = np.asarray(ex, np.float64)
        self.ey = np.asarray(ey, np.float64)
        self.n = np.cross(self.ex, self.ey)
        self.n /= np.linalg.norm(self.n)
        self.tex = tex


def render_scene(planes, R, t, f, cx, cy, w, h, near=0.2):
    """Ray-cast all planes, nearest hit wins."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    dirs_cam = np.stack(
        [(xx - cx) / f, (yy - cy) / f, np.ones_like(xx)], axis=-1
    )
    Rt = R.T
    dirs = dirs_cam @ Rt.T  # world ray directions
    origin = -Rt @ t

    img = np.zeros((h, w), np.float64)
    depth = np.full((h, w), np.inf)
    for pl in planes:
        dn = dirs @ pl.n
        safe = np.abs(dn) > 1e-9
        s = np.where(safe, (pl.p0 - origin) @ pl.n / np.where(safe, dn, 1.0),
                     -1.0)
        px = origin[None, None, :] + s[..., None] * dirs
        rel = px - pl.p0
        uu = (rel @ pl.ex) / (pl.ex @ pl.ex)
        vv = (rel @ pl.ey) / (pl.ey @ pl.ey)
        ok = (
            (s > near) & (s < depth)
            & (uu >= 0) & (uu < 1) & (vv >= 0) & (vv < 1)
        )
        res = pl.tex.shape[0]
        ui = np.clip((uu * (res - 1)).astype(np.int64), 0, res - 1)
        vi = np.clip((vv * (res - 1)).astype(np.int64), 0, res - 1)
        img = np.where(ok, pl.tex[vi, ui], img)
        depth = np.where(ok, s, depth)

    return (np.clip(img, 0, 1) * 255).astype(np.uint8)


def arc_scene(rng, n_cams):
    """Wall + floor viewed from an arc (the original smoke scene)."""
    ext = 8.0
    planes = [
        # wall z=6.8 spanning x,y in [-4, 4]
        Plane([-ext / 2, -ext / 2, 6.8], [ext, 0, 0], [0, ext, 0],
              make_texture(rng)),
        # floor y=1.8 spanning x in [-4, 4], z in [0, 8]
        Plane([-ext / 2, 1.8, 0.0], [ext, 0, 0], [0, 0, ext],
              make_texture(rng)),
    ]
    poses = []
    for i in range(n_cams):
        ang = (i / max(n_cams - 1, 1) - 0.5) * 0.9
        center = np.array(
            [3.5 * np.sin(ang), 0.25 * np.sin(2.2 * i), 3.5 * (1 - np.cos(ang))]
        )
        R = look_at_R(center, [0.0, 0.0, 6.5])
        poses.append((R, -R @ center))
    ranks = [
        [j for j in sorted(range(n_cams), key=lambda j: abs(i - j)) if j != i]
        for i in range(n_cams)
    ]
    return planes, poses, ranks


def loop_scene(rng, n_cams, room=6.0, radius=2.5, height=3.6):
    """Square room (4 walls + floor + ceiling), cameras on a circle
    looking tangentially.  The trajectory closes on itself after 360
    degrees, so sequential mapping accumulates drift that only the
    loop-closure pairs (retrieval wraparound) can correct — the image-
    level analogue of the reference's correct_pose path
    (src/geometry/error_corrector.cc)."""
    L = room
    hh = height / 2
    walls = []
    for (p0, ex) in [
        ([-L, -hh, L], [2 * L, 0, 0]),   # wall z=+L
        ([L, -hh, -L], [0, 0, 2 * L]),   # wall x=+L... ex along z
        ([L, -hh, -L], [-2 * L, 0, 0]),  # wall z=-L
        ([-L, -hh, L], [0, 0, -2 * L]),  # wall x=-L
    ]:
        walls.append(Plane(p0, ex, [0, height, 0], make_texture(rng)))
    # fix wall orientation: planes are one-sided only via uv bounds, and
    # rays hit from either side — that is fine (texture visible from both)
    floor = Plane([-L, hh, -L], [2 * L, 0, 0], [0, 0, 2 * L],
                  make_texture(rng))
    ceil = Plane([-L, -hh, -L], [2 * L, 0, 0], [0, 0, 2 * L],
                 make_texture(rng))
    planes = walls + [floor, ceil]

    poses = []
    for i in range(n_cams):
        a = 2 * np.pi * i / n_cams
        center = np.array(
            [radius * np.cos(a), 0.12 * np.sin(3 * a), radius * np.sin(a)]
        )
        # look tangentially (forward along the circle), slightly outward
        fwd = np.array([-np.sin(a), 0.0, np.cos(a)])
        out = np.array([np.cos(a), 0.0, np.sin(a)])
        target = center + 4.0 * fwd + 1.2 * out
        R = look_at_R(center, target)
        poses.append((R, -R @ center))
    # retrieval rank: circular index distance (true view-overlap order)
    def cdist(i, j):
        d = abs(i - j)
        return min(d, n_cams - d)

    ranks = [
        [j for j in sorted(range(n_cams), key=lambda j: cdist(i, j)) if j != i]
        for i in range(n_cams)
    ]
    return planes, poses, ranks


def corridor_scene(rng, n_cams, half_w=3.0, height=4.0, step=0.55):
    """KITTI-like forward motion: two side walls + floor + end wall."""
    length = n_cams * step + 14.0
    hh = height / 2
    planes = [
        Plane([-half_w, -hh, 0], [0, 0, length], [0, height, 0],
              make_texture(rng)),     # left wall x=-half_w
        Plane([half_w, -hh, 0], [0, 0, length], [0, height, 0],
              make_texture(rng)),     # right wall x=+half_w
        Plane([-half_w, hh, 0], [2 * half_w, 0, 0], [0, 0, length],
              make_texture(rng)),     # floor
        Plane([-half_w, -hh, length], [2 * half_w, 0, 0], [0, height, 0],
              make_texture(rng)),     # end wall
    ]
    poses = []
    for i in range(n_cams):
        center = np.array(
            [0.45 * np.sin(0.13 * i), 0.08 * np.sin(0.4 * i), i * step]
        )
        yaw = 0.06 * np.cos(0.13 * i)
        target = center + np.array([np.sin(yaw) * 4.0, 0.0, 4.0])
        R = look_at_R(center, target)
        poses.append((R, -R @ center))
    ranks = [
        [j for j in sorted(range(n_cams), key=lambda j: abs(i - j)) if j != i]
        for i in range(n_cams)
    ]
    return planes, poses, ranks


SCENES = {"arc": arc_scene, "loop": loop_scene, "corridor": corridor_scene}


def main(out_dir, n_cams=8, seed=3, w=512, h=384, f=450.0, scene="arc"):
    from xrsfm_tpu.utils import image_io

    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(out_dir, "images"), exist_ok=True)
    cx, cy = w / 2, h / 2
    planes, poses, ranks = SCENES[scene](rng, n_cams)

    from xrsfm_tpu.utils import geometry as G

    names = []
    quats = []
    for i, (R, t) in enumerate(poses):
        img = render_scene(planes, R, t, f, cx, cy, w, h)
        name = f"frame{i:04d}.png"
        image_io.write_image(os.path.join(out_dir, "images", name), img)
        names.append(name)
        # robust branch-free quaternion conversion (the naive
        # qw=sqrt(1+tr)/2 form divides by ~0 for 180-degree rotations);
        # numpy twin keeps dataset generation entirely off-device
        quats.append(G.rotmat_to_quat_np(R))
    with open(os.path.join(out_dir, "camera.txt"), "w") as fh:
        fh.write(f"0 PINHOLE {w} {h} {f} {f} {cx} {cy}\n")
    with open(os.path.join(out_dir, "gt_poses.txt"), "w") as fh:
        for name, q, (R, t) in zip(names, quats, poses):
            fh.write(
                f"{name} {q[0]} {q[1]} {q[2]} {q[3]} {t[0]} {t[1]} {t[2]}\n"
            )
    with open(os.path.join(out_dir, "retrieval.txt"), "w") as fh:
        for i, name in enumerate(names):
            for j in ranks[i]:
                fh.write(f"{name} {names[j]}\n")
    if scene == "corridor":
        with open(os.path.join(out_dir, "times.txt"), "w") as fh:
            for i in range(n_cams):
                fh.write(f"{i * 0.1:.6e}\n")
    print(f"wrote {n_cams} images ({scene}) to {out_dir}")


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("out_dir")
    ap.add_argument("--n_cams", type=int, default=8)
    ap.add_argument("--seed", type=int, default=3)
    ap.add_argument("--scene", default="arc", choices=sorted(SCENES))
    a = ap.parse_args()
    main(a.out_dir, a.n_cams, a.seed, scene=a.scene)
