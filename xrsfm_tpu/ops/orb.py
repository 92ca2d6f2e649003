"""Batched ORB feature extraction (XLA ops, no OpenCV).

Batched equivalent of the reference's USE_ORB path (reference:
src/feature/feature_extraction.cc:21-56 — ORB_SLAM2 OrbExtractor with
2048 features, 8 pyramid levels, scale 1.2, FAST thresholds 20/7; the
Hamming matcher counterpart is ops/matching.match_descriptors_hamming,
reference OrbMatch feature_processing.cc:156-219).

Design (mirrors the SIFT extractor's shape discipline):
  * FAST-9 corner test on the 16-pixel Bresenham circle expressed as 16
    rolled comparisons + windowed ANDs over the circular axis — pure
    elementwise ops, no per-pixel scalar code;
  * 3x3 non-max suppression with reduce_window; fixed top-k pool per
    pyramid level keeps shapes static;
  * orientation by the intensity centroid of a disk patch (one bilinear
    gather per keypoint, vmapped);
  * steered BRIEF-256: a fixed random point-pair pattern (Gaussian,
    sigma = patch/5 — the original BRIEF construction; OpenCV's learned
    table is NOT copied) rotated by the keypoint orientation, compared
    through bilinear gathers, packed to 32 uint8 bytes.

Descriptors are self-consistent (match against each other through the
Hamming matcher) but not bit-compatible with OpenCV's learned pattern.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np


@dataclasses.dataclass(frozen=True)
class OrbOptions:
    num_features: int = 2048
    num_levels: int = 8
    scale_factor: float = 1.2
    fast_threshold: float = 20.0 / 255.0  # reference initTh on [0,255]
    fast_threshold_min: float = 7.0 / 255.0
    patch_size: int = 31
    border: int = 19


# 16-pixel Bresenham circle of radius 3 (standard FAST ordering)
_CIRCLE = np.array(
    [
        (0, 3), (1, 3), (2, 2), (3, 1), (3, 0), (3, -1), (2, -2), (1, -3),
        (0, -3), (-1, -3), (-2, -2), (-3, -1), (-3, 0), (-3, 1), (-2, 2),
        (-1, 3),
    ],
    np.int32,
)  # (dy, dx)


def _fast_score(img: jax.Array, th: float):
    """FAST-9 corner mask + score for one image [H,W].

    Returns (corner [H,W] bool, score [H,W] = sum of |diff| over the
    contiguous arc's side)."""
    taps = jnp.stack(
        [jnp.roll(img, (-dy, -dx), (0, 1)) for dy, dx in _CIRCLE]
    )  # [16,H,W]
    d = taps - img[None]
    bright = d > th
    dark = d < -th

    def arc9(b):
        # contiguous run of >= 9 around the 16-cycle
        acc = b
        for k in range(1, 9):
            acc = acc & jnp.roll(b, -k, axis=0)
        return jnp.any(acc, axis=0)

    corner = arc9(bright) | arc9(dark)
    score = jnp.sum(jnp.abs(d) * ((bright | dark)), axis=0)
    return corner, score


def _nms3(score: jax.Array) -> jax.Array:
    m = jax.lax.reduce_window(
        score, -jnp.inf, jax.lax.max, (3, 3), (1, 1), "SAME"
    )
    return score >= m


def _brief_pattern(n_pairs: int = 256, patch: int = 31, seed: int = 7):
    """Gaussian point-pair pattern (original BRIEF construction)."""
    rng = np.random.default_rng(seed)
    s = patch / 5.0
    a = np.clip(rng.normal(scale=s, size=(n_pairs, 2)), -(patch // 2), patch // 2)
    b = np.clip(rng.normal(scale=s, size=(n_pairs, 2)), -(patch // 2), patch // 2)
    return a.astype(np.float32), b.astype(np.float32)


_PAT_A, _PAT_B = _brief_pattern()


def _bilinear(img, ys, xs):
    H, W = img.shape
    y0 = jnp.floor(ys).astype(jnp.int32)
    x0 = jnp.floor(xs).astype(jnp.int32)
    fy = ys - y0
    fx = xs - x0

    def tap(yy, xx):
        ok = (yy >= 0) & (yy < H) & (xx >= 0) & (xx < W)
        v = img[jnp.clip(yy, 0, H - 1), jnp.clip(xx, 0, W - 1)]
        return jnp.where(ok, v, 0.0)

    return (
        tap(y0, x0) * (1 - fy) * (1 - fx)
        + tap(y0, x0 + 1) * (1 - fy) * fx
        + tap(y0 + 1, x0) * fy * (1 - fx)
        + tap(y0 + 1, x0 + 1) * fy * fx
    )


def _orientation(img, ys, xs, radius: int = 15):
    """Intensity-centroid orientation (ORB's m10/m01 moments)."""
    off = jnp.arange(-radius, radius + 1, dtype=jnp.float32)
    oy, ox = jnp.meshgrid(off, off, indexing="ij")
    disk = (oy**2 + ox**2 <= radius**2).astype(jnp.float32)

    def one(y, x):
        v = _bilinear(img, y + oy, x + ox) * disk
        m10 = jnp.sum(v * ox)
        m01 = jnp.sum(v * oy)
        return jnp.arctan2(m01, m10)

    return jax.vmap(one)(ys, xs)


def _descriptors(img, ys, xs, thetas):
    """Steered BRIEF-256 -> [K, 32] uint8."""
    pa = jnp.asarray(_PAT_A)  # [256,2] (y,x)
    pb = jnp.asarray(_PAT_B)

    def one(y, x, th):
        ct, st = jnp.cos(th), jnp.sin(th)
        ay = ct * pa[:, 0] + st * pa[:, 1]
        ax = -st * pa[:, 0] + ct * pa[:, 1]
        by = ct * pb[:, 0] + st * pb[:, 1]
        bx = -st * pb[:, 0] + ct * pb[:, 1]
        va = _bilinear(img, y + ay, x + ax)
        vb = _bilinear(img, y + by, x + bx)
        bits = (va < vb).astype(jnp.uint8).reshape(32, 8)
        weights = jnp.asarray(
            [1, 2, 4, 8, 16, 32, 64, 128], jnp.uint8
        )
        return jnp.sum(bits * weights[None, :], axis=1).astype(jnp.uint8)

    return jax.vmap(one)(ys, xs, thetas)


@functools.partial(jax.jit, static_argnames=("opts", "h", "w", "k_pool"))
def _extract_level(img, th, opts: OrbOptions, h: int, w: int, k_pool: int):
    corner, score = _fast_score(img, th)
    b = opts.border
    mask = jnp.zeros((h, w), bool).at[b:-b, b:-b].set(True)
    sc = jnp.where(corner & _nms3(score) & mask, score, 0.0)
    vals, idx = jax.lax.top_k(sc.reshape(-1), k_pool)
    ys = (idx // w).astype(jnp.float32)
    xs = (idx % w).astype(jnp.float32)
    valid = vals > 0
    thetas = _orientation(img, ys, xs)
    descs = _descriptors(img, ys, xs, thetas)
    return xs, ys, thetas, vals, descs, valid


class OrbExtractor:
    """Host driver: pyramid loop + per-level jitted extraction."""

    def __init__(self, opts: OrbOptions = OrbOptions()):
        self.opts = opts

    def extract(self, image: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """image [H,W] float32 in [0,1] (or uint8).

        Returns (keypoints [N,4] — x, y, scale, angle — full-res pixels,
        descriptors [N,32] uint8)."""
        o = self.opts
        img = np.asarray(image)
        if img.dtype == np.uint8:
            img = img.astype(np.float32) / 255.0
        per_level = max(o.num_features // o.num_levels, 1)
        kxs, kys, kth, ksc, kd, klvl = [], [], [], [], [], []
        cur = jnp.asarray(img)
        scale = 1.0
        for lvl in range(o.num_levels):
            h, w = cur.shape
            if min(h, w) < 2 * o.border + 8:
                break
            for th in (o.fast_threshold, o.fast_threshold_min):
                xs, ys, thetas, vals, descs, valid = _extract_level(
                    cur, th, o, h, w, per_level
                )
                n_ok = int(np.count_nonzero(np.asarray(valid)))
                if n_ok >= per_level // 2 or th == o.fast_threshold_min:
                    break
            v = np.asarray(valid)
            kxs.append(np.asarray(xs)[v] * scale)
            kys.append(np.asarray(ys)[v] * scale)
            kth.append(np.asarray(thetas)[v])
            ksc.append(np.asarray(vals)[v])
            kd.append(np.asarray(descs)[v])
            klvl.append(np.full(int(v.sum()), scale, np.float32))
            nh = int(round(h / o.scale_factor))
            nw = int(round(w / o.scale_factor))
            cur = jax.image.resize(cur, (nh, nw), method="bilinear")
            scale *= o.scale_factor
        if not kxs:
            return np.zeros((0, 4), np.float32), np.zeros((0, 32), np.uint8)
        xs = np.concatenate(kxs)
        ys = np.concatenate(kys)
        thetas = np.concatenate(kth)
        scores = np.concatenate(ksc)
        descs = np.concatenate(kd)
        scales = np.concatenate(klvl)
        order = np.argsort(-scores)[: o.num_features]
        kps = np.stack(
            [xs[order], ys[order], scales[order], thetas[order]], axis=1
        ).astype(np.float32)
        return kps, descs[order]
