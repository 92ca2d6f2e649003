"""Batched SIFT feature extraction (XLA convs + vectorized gather).

Replacement for SiftGPU (reference: 3rdparty/SiftGPU —
Gaussian pyramid FilterH/FilterV ProgramCU.cu:123-233, DoG :521-590,
keypoint detection ComputeKEY_Kernel :592-756, orientation :758-1052,
descriptor ComputeDescriptor_Kernel :1054-1202; driven through
src/feature/sift_extractor.cc:11-150 with options: first octave -1
(2x upsample), 3 DoG levels/octave, peak threshold 0.02/3, edge threshold
10, one orientation per keypoint, L1-root normalization and 512*v uint8
quantization, max 8192 features).

Design (batched device kernels, not a translation of SiftGPU's CUDA):
  * the whole pyramid is built with depthwise separable
    lax.conv_general_dilated calls — XLA fuses and tiles these onto the
    convolution units; every octave level keeps static shapes;
  * extrema detection is three reduce_window max/min comparisons (no
    per-pixel scalar code); subpixel refinement solves the 3x3 quadratic
    fit with a closed-form inverse, fully vectorized over candidates;
  * a fixed-size keypoint pool per octave (top-k by |DoG|) keeps shapes
    static — the union is re-ranked to the global max_features pool;
  * orientation histograms and the 4x4x8 descriptor are computed with one
    bilinear-gather of a (2*R)^2 patch per keypoint and
    vectorized soft-binning (scatter via one-hot matmuls).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np


@dataclasses.dataclass(frozen=True)
class SiftOptions:
    num_octaves: int = 5
    levels_per_octave: int = 3  # DoG levels searched per octave
    sigma0: float = 1.6  # base blur of level 0
    init_sigma: float = 0.5  # assumed blur of the input image
    first_octave: int = -1  # -1 = 2x upsample first (SiftGPU -fo -1)
    peak_threshold: float = 0.02 / 3.0  # SiftGPU dog threshold
    edge_threshold: float = 10.0
    max_features: int = 8192
    # top-|DoG| candidate pool of octave 0; higher octaves shrink with
    # their area (pool >> o, floor 128) — detections drop ~4x per
    # octave, and orientation+descriptor work is proportional to POOL
    # slots, not to real keypoints (@480p, 4096 octave-0 slots carried
    # 1237 real keypoints)
    features_per_octave: int = 4096
    pool_floor: int = 128
    descriptor_patch: int = 16  # gradient samples per side
    ori_bins: int = 36


def _gauss_kernel1d(sigma: float) -> np.ndarray:
    r = max(1, int(math.ceil(3.0 * sigma)))
    x = np.arange(-r, r + 1)
    k = np.exp(-(x**2) / (2.0 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


def _sep_blur(img: jax.Array, k: np.ndarray) -> jax.Array:
    """img [B,H,W] -> separable gaussian blur with SAME padding."""
    kx = jnp.asarray(k)[None, None, None, :]  # OIHW-ish
    x = img[:, None, :, :]  # [B,1,H,W]
    x = jax.lax.conv_general_dilated(
        x, kx, (1, 1), [(0, 0), (len(k) // 2, len(k) // 2)],
        dimension_numbers=("NCHW", "OIHW", "NCHW"),
    )
    ky = jnp.asarray(k)[None, None, :, None]
    x = jax.lax.conv_general_dilated(
        x, ky, (1, 1), [(len(k) // 2, len(k) // 2), (0, 0)],
        dimension_numbers=("NCHW", "OIHW", "NCHW"),
    )
    return x[:, 0]


def _downsample2(img: jax.Array) -> jax.Array:
    return img[:, ::2, ::2]


def _upsample2(img: jax.Array) -> jax.Array:
    """Bilinear 2x upsample [B,H,W] -> [B,2H,2W]."""
    B, H, W = img.shape
    return jax.image.resize(img, (B, 2 * H, 2 * W), method="bilinear")


def _local_extrema(dog: jax.Array) -> Tuple[jax.Array, jax.Array]:
    """dog [B,L,H,W] -> (is_max, is_min) for interior levels [B,L-2,H,W]."""

    def pool(x, op, init):
        return jax.lax.reduce_window(
            x, init, op, (1, 1, 3, 3), (1, 1, 1, 1), "SAME"
        )

    mx = pool(dog, jax.lax.max, -jnp.inf)  # 3x3 in-plane max per level
    mn = pool(dog, jax.lax.min, jnp.inf)
    c = dog[:, 1:-1]
    # neighbors: same-level 3x3 (excluding strict self handled by >=),
    # plus full 3x3 of levels above/below
    up_mx, dn_mx = mx[:, 2:], mx[:, :-2]
    up_mn, dn_mn = mn[:, 2:], mn[:, :-2]
    same_mx, same_mn = mx[:, 1:-1], mn[:, 1:-1]
    is_max = (c >= same_mx) & (c > up_mx) & (c > dn_mx)
    is_min = (c <= same_mn) & (c < up_mn) & (c < dn_mn)
    return is_max, is_min


def _edge_response_ok(dog_c: jax.Array, edge_th: float) -> jax.Array:
    """2x2 Hessian edge test on the center level [B,H,W]."""
    dxx = (
        jnp.roll(dog_c, -1, -1) + jnp.roll(dog_c, 1, -1) - 2 * dog_c
    )
    dyy = (
        jnp.roll(dog_c, -1, -2) + jnp.roll(dog_c, 1, -2) - 2 * dog_c
    )
    dxy = 0.25 * (
        jnp.roll(jnp.roll(dog_c, -1, -1), -1, -2)
        + jnp.roll(jnp.roll(dog_c, 1, -1), 1, -2)
        - jnp.roll(jnp.roll(dog_c, -1, -1), 1, -2)
        - jnp.roll(jnp.roll(dog_c, 1, -1), -1, -2)
    )
    tr = dxx + dyy
    det = dxx * dyy - dxy * dxy
    r = edge_th
    return (det > 0) & (tr * tr * r < (r + 1) * (r + 1) * det)


def _bilinear_gather(img: jax.Array, ys: jax.Array, xs: jax.Array) -> jax.Array:
    """img [H,W]; ys, xs [...]; zero padding outside."""
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


def _extract_octave(gauss, dogs, octave_scale, opts: SiftOptions, k_pool: int):
    """One octave: gauss [B,L+3,H,W], dogs [B,L+2,H,W].

    Returns per image: xy [B,K,2] (full-res pixels), level_sigma [B,K],
    score [B,K], level_idx [B,K], valid [B,K].
    """
    B, Lp2, H, W = dogs.shape
    is_max, is_min = _local_extrema(dogs)  # [B, L, H, W]
    c = dogs[:, 1:-1]
    peak_ok = jnp.abs(c) > opts.peak_threshold
    edge_ok = jnp.stack(
        [_edge_response_ok(dogs[:, l + 1], opts.edge_threshold)
         for l in range(Lp2 - 2)],
        axis=1,
    )
    cand = (is_max | is_min) & peak_ok & edge_ok
    # kill borders
    border = 8
    mask = jnp.zeros((H, W), bool).at[border:-border, border:-border].set(True)
    cand = cand & mask[None, None]

    score = jnp.where(cand, jnp.abs(c), 0.0)  # [B, L, H, W]
    flat = score.reshape(B, -1)
    vals, idx = jax.lax.top_k(flat, k_pool)  # [B, K]
    lvl = idx // (H * W)
    rem = idx % (H * W)
    ys = (rem // W).astype(jnp.float32)
    xs = (rem % W).astype(jnp.float32)
    valid = vals > 0

    # subpixel refinement via full 3D quadratic fit over (x, y, scale) —
    # the scale-axis offset refines sigma between DoG levels (reference:
    # SiftGPU refines all three axes, ProgramCU.cu keypoint refinement;
    # x/y-only refinement was review finding r1-missing#4)
    def refine(b):
        d = dogs[b]  # [L+2, H, W]
        l_i = lvl[b] + 1
        y_i = ys[b].astype(jnp.int32)
        x_i = xs[b].astype(jnp.int32)

        def g(dl, dy, dx):
            return d[l_i + dl, jnp.clip(y_i + dy, 0, H - 1), jnp.clip(x_i + dx, 0, W - 1)]

        gx = 0.5 * (g(0, 0, 1) - g(0, 0, -1))
        gy = 0.5 * (g(0, 1, 0) - g(0, -1, 0))
        gl = 0.5 * (g(1, 0, 0) - g(-1, 0, 0))
        c0 = g(0, 0, 0)
        hxx = g(0, 0, 1) + g(0, 0, -1) - 2 * c0
        hyy = g(0, 1, 0) + g(0, -1, 0) - 2 * c0
        hll = g(1, 0, 0) + g(-1, 0, 0) - 2 * c0
        hxy = 0.25 * (g(0, 1, 1) + g(0, -1, -1) - g(0, 1, -1) - g(0, -1, 1))
        hxl = 0.25 * (g(1, 0, 1) + g(-1, 0, -1) - g(1, 0, -1) - g(-1, 0, 1))
        hyl = 0.25 * (g(1, 1, 0) + g(-1, -1, 0) - g(1, -1, 0) - g(-1, 1, 0))
        # closed-form 3x3 solve H @ o = -grad via the adjugate
        A = hyy * hll - hyl * hyl
        Bm = -(hxy * hll - hyl * hxl)
        C = hxy * hyl - hyy * hxl
        det = hxx * A + hxy * Bm + hxl * C
        det = jnp.where(jnp.abs(det) < 1e-12, 1e-12, det)
        ox = -(A * gx + Bm * gy + C * gl) / det
        oy = -(
            Bm * gx + (hxx * hll - hxl * hxl) * gy
            - (hxx * hyl - hxy * hxl) * gl
        ) / det
        ol = -(
            C * gx - (hxx * hyl - hxy * hxl) * gy
            + (hxx * hyy - hxy * hxy) * gl
        ) / det
        ox = jnp.clip(ox, -0.5, 0.5)
        oy = jnp.clip(oy, -0.5, 0.5)
        ol = jnp.clip(ol, -0.5, 0.5)
        return xs[b] + ox, ys[b] + oy, ol

    xr, yr, ol = jax.vmap(refine)(jnp.arange(B))
    sigma = opts.sigma0 * (
        2.0 ** ((lvl + 1 + ol) / opts.levels_per_octave)
    )
    xy_full = jnp.stack([xr, yr], -1) * octave_scale
    return xy_full, sigma * octave_scale, vals, lvl, valid


def _soft_onehot(vals: jax.Array, n: int, wrap: bool) -> jax.Array:
    """vals [...,] continuous bin coords -> [..., n] linear soft assignment.

    Branch-free binning: the histogram/descriptor accumulation becomes
    a matmul with these one-hot matrices instead of scatter-adds.
    """
    i = jnp.arange(n, dtype=vals.dtype)
    d = vals[..., None] - i
    if wrap:
        d = d - n * jnp.round(d / n)
    return jnp.maximum(0.0, 1.0 - jnp.abs(d))


def _patch_gradients(v: jax.Array):
    """Central-difference gradients of a [..., P, P] patch."""
    gx = 0.5 * (jnp.roll(v, -1, -1) - jnp.roll(v, 1, -1))
    gy = 0.5 * (jnp.roll(v, -1, -2) - jnp.roll(v, 1, -2))
    # zero the wrap-around borders
    P = v.shape[-1]
    edge = jnp.ones(P).at[0].set(0.0).at[-1].set(0.0)
    return gx * edge[None, :], gy * edge[:, None]


def _bilinear_gather_lvl(gstack: jax.Array, l, ys: jax.Array,
                         xs: jax.Array) -> jax.Array:
    """gstack [L,H,W]; l scalar level index; ys, xs [...]; zero padding
    outside.  One 3-index gather per tap — lets every keypoint sample its
    OWN pyramid level in a single batched call (computing all levels and
    selecting afterwards was 3x the gather traffic, and gathers dominate
    this stage's runtime)."""
    L, H, W = gstack.shape
    y0 = jnp.floor(ys).astype(jnp.int32)
    x0 = jnp.floor(xs).astype(jnp.int32)
    fy = ys - y0
    fx = xs - x0

    def tap(yy, xx):
        ok = (yy >= 0) & (yy < H) & (xx >= 0) & (xx < W)
        v = gstack[l, jnp.clip(yy, 0, H - 1), jnp.clip(xx, 0, W - 1)]
        return jnp.where(ok, v, 0.0)

    return (
        tap(y0, x0) * (1 - fy) * (1 - fx)
        + tap(y0, x0 + 1) * (1 - fy) * fx
        + tap(y0 + 1, x0) * fy * (1 - fx)
        + tap(y0 + 1, x0 + 1) * fy * fx
    )


def _nn_gather_lvl(gstack: jax.Array, l, ys: jax.Array,
                   xs: jax.Array) -> jax.Array:
    """Nearest-neighbor tap (1 gather instead of bilinear's 4).  Used by
    the DESCRIPTOR pass only: its soft spatial/angular binning absorbs
    the half-pixel sample placement (measured on the 8-image arc smoke,
    descriptor-NN with bilinear orientations is as good as all-bilinear:
    0.119% vs 0.273% ATE), while the gathers are a large part of the
    stage's cost.  The ORIENTATION pass must keep bilinear taps: r4 ran it with
    NN taps and the quantized gradient directions jittered the dominant
    orientation enough to move the descriptor grid with viewpoint —
    reprojection degraded 0.256 -> 0.393px, per-frame rotation error
    6.6x, arc-smoke ATE 0.27% -> 2.15% (r5 bisect: r3 good / r4 bad,
    isolated to this tap choice; the repeatability A/B gate did not see
    it because detection positions were unchanged)."""
    L, H, W = gstack.shape
    yy = jnp.round(ys).astype(jnp.int32)
    xx = jnp.round(xs).astype(jnp.int32)
    ok = (yy >= 0) & (yy < H) & (xx >= 0) & (xx < W)
    v = gstack[l, jnp.clip(yy, 0, H - 1), jnp.clip(xx, 0, W - 1)]
    return jnp.where(ok, v, 0.0)


def _orientation_and_descriptor(gstack, lvls, xs, ys, sigma,
                                opts: SiftOptions):
    """Compute dominant orientation + 128-d descriptor for keypoints of
    one octave.  gstack [Lg,H,W] gaussian levels; lvls [K] per-keypoint
    level index into gstack; xs, ys [K]; sigma [K] in octave coords.

    Returns (angle [K], desc [K,128], ok [K]).  All binning is expressed as
    (samples x bins) one-hot matmuls — no scatters.
    """
    P = opts.descriptor_patch  # 16
    spacing = 0.75 * sigma  # [K]

    offs = jnp.arange(P) - (P - 1) / 2.0  # [-7.5 ... 7.5]
    oy, ox = jnp.meshgrid(offs, offs, indexing="ij")  # [P,P]
    wgt = jnp.exp(-(ox**2 + oy**2) / (2 * (P / 2.0) ** 2))

    # orientation window: Lowe's sigma_w = 1.5 sigma_kp = 2 grid cells at
    # 0.75-sigma spacing, over the descriptor's full P x P grid — the
    # wider descriptor window made the estimate depend on far-field
    # content that rotates in and out of the square patch (measured ~15
    # deg orientation MAD between 45-degree-rotated views).
    wgt_ori = jnp.exp(-(ox**2 + oy**2) / (2 * 2.0**2))

    def per_kp_orient(l, x, y, sp):
        v = _bilinear_gather_lvl(gstack, l, y + oy * sp, x + ox * sp)  # [P,P]
        gx, gy = _patch_gradients(v)
        mag = jnp.sqrt(gx * gx + gy * gy + 1e-18)
        ang = jnp.arctan2(gy, gx)  # [-pi, pi]
        bins = (ang + jnp.pi) / (2 * jnp.pi) * opts.ori_bins  # [0, 36)
        oh = _soft_onehot(bins.reshape(-1), opts.ori_bins, wrap=True)
        hist = (mag * wgt_ori).reshape(-1) @ oh  # [36]
        # Lowe smooths the orientation histogram 6x; 2 passes left ~15
        # degrees of orientation MAD between matched views (measured),
        # costing matches at the ratio test
        for _ in range(6):
            hist = (jnp.roll(hist, 1) + hist + jnp.roll(hist, -1)) / 3.0
        peak = jnp.argmax(hist)
        l_ = hist[(peak - 1) % opts.ori_bins]
        c_ = hist[peak]
        r_ = hist[(peak + 1) % opts.ori_bins]
        denom = l_ - 2 * c_ + r_
        off = jnp.where(jnp.abs(denom) > 1e-12, 0.5 * (l_ - r_) / denom, 0.0)
        return ((peak + off + 0.5) / opts.ori_bins) * 2 * jnp.pi - jnp.pi

    thetas = jax.vmap(per_kp_orient)(lvls, xs, ys, spacing)

    def per_kp_desc(l, x, y, sp, theta):
        ct, st = jnp.cos(theta), jnp.sin(theta)
        rx = ct * ox - st * oy
        ry = st * ox + ct * oy
        # NN taps are safe HERE (soft binning absorbs them) but NOT in
        # the orientation pass above — see _nn_gather_lvl's docstring
        # for the measured r4 regression and the r5 bisect.
        v = _nn_gather_lvl(gstack, l, y + ry * sp, x + rx * sp)
        gx, gy = _patch_gradients(v)
        mag = jnp.sqrt(gx * gx + gy * gy + 1e-18)
        # the patch is sampled on the ROTATED grid, so finite differences
        # along the patch axes are already descriptor-frame gradients —
        # subtracting theta here again would shift the orientation bins
        # by the inter-view rotation (measured: 45-degree warp collapsed
        # verified matches 188 -> 16 vs cv2.SIFT before this fix)
        ang = jnp.arctan2(gy, gx)
        w = (mag * wgt).reshape(-1)  # [S]
        # spatial soft bins: 4x4 grid over the (unrotated) patch coords
        bx = (ox + (P - 1) / 2.0) / (P / 4.0) - 0.5  # bin coords [-0.5, 3.5)
        by = (oy + (P - 1) / 2.0) / (P / 4.0) - 0.5
        ohx = _soft_onehot(bx.reshape(-1), 4, wrap=False)  # [S,4]
        ohy = _soft_onehot(by.reshape(-1), 4, wrap=False)  # [S,4]
        spatial = (ohy[:, :, None] * ohx[:, None, :]).reshape(-1, 16)  # [S,16]
        ob = ((ang + jnp.pi) / (2 * jnp.pi) * 8.0).reshape(-1)
        oho = _soft_onehot(ob, 8, wrap=True)  # [S,8]
        desc = jnp.einsum("s,sb,so->bo", w, spatial, oho).reshape(128)
        desc = desc / jnp.maximum(jnp.linalg.norm(desc), 1e-12)
        desc = jnp.minimum(desc, 0.2)
        return desc / jnp.maximum(jnp.linalg.norm(desc), 1e-12)

    descs = jax.vmap(per_kp_desc)(lvls, xs, ys, spacing, thetas)
    ok = jnp.isfinite(thetas)
    return thetas, descs, ok


def l1_root_normalize(desc: jax.Array) -> jax.Array:
    """L1-root normalization (reference: L1RootNormalize,
    sift_extractor.cc:100-110)."""
    l1 = jnp.sum(jnp.abs(desc), axis=-1, keepdims=True)
    return jnp.sqrt(desc / jnp.maximum(l1, 1e-12))


def descs_to_uint8(desc: jax.Array) -> jax.Array:
    """512*v truncation (reference: FeatureDescriptorsToUnsignedByte,
    sift_extractor.h:22-34)."""
    return jnp.clip(512.0 * desc, 0, 255).astype(jnp.uint8)


@functools.partial(jax.jit, static_argnames=("opts", "h", "w"))
def _extract_jit(img, opts: SiftOptions, h: int, w: int):
    """img [B, h, w] float32 in [0,1].

    Returns (xy [B,K,2], sigma [B,K], angle [B,K], desc_u8 [B,K,128],
    score [B,K], valid [B,K]) with K = opts.max_features.
    """
    B = img.shape[0]
    L = opts.levels_per_octave
    k_sig = math.sqrt(2.0 ** (2.0 / L) - 1.0)

    if img.dtype == jnp.uint8:
        # callers ship uint8 and convert HERE: f32 input would quadruple
        # the host->device transfer for no precision gain (the source is
        # 8-bit)
        img = img.astype(jnp.float32) * (1.0 / 255.0)
    base = img
    octave_scale = 1.0
    if opts.first_octave == -1:
        base = _upsample2(img)
        octave_scale = 0.5
    # bring base to sigma0
    s_extra = math.sqrt(
        max(opts.sigma0**2 - (opts.init_sigma / octave_scale) ** 2, 0.01)
    )
    base = _sep_blur(base, _gauss_kernel1d(s_extra))

    all_out = []
    cur = base
    for o in range(opts.num_octaves):
        Hc, Wc = cur.shape[1], cur.shape[2]
        if min(Hc, Wc) < 32:
            break
        # build L+3 gaussian levels
        levels = [cur]
        sig_prev = opts.sigma0
        for li in range(1, L + 3):
            sig_next = opts.sigma0 * (2.0 ** (li / L))
            dsig = math.sqrt(max(sig_next**2 - sig_prev**2, 1e-6))
            levels.append(_sep_blur(levels[-1], _gauss_kernel1d(dsig)))
            sig_prev = sig_next
        gauss = jnp.stack(levels, axis=1)  # [B, L+3, H, W]
        dogs = gauss[:, 1:] - gauss[:, :-1]  # [B, L+2, H, W]
        k_pool = min(
            max(opts.features_per_octave >> o, opts.pool_floor),
            Hc * Wc // 16,
        )
        xy, sigma, score, lvl, valid = _extract_octave(
            gauss, dogs, octave_scale, opts, k_pool
        )
        # orientation + descriptor on the matching gaussian level (the
        # level below the DoG's upper image: lvl+1) — each keypoint
        # samples its OWN level through a 3-index gather (computing every
        # level for every keypoint and selecting was 3x the gather work)
        xs_all = xy[..., 0] / octave_scale  # [B, K]
        ys_all = xy[..., 1] / octave_scale
        lvl_sigmas = jnp.asarray(
            [opts.sigma0 * (2.0 ** ((li + 1) / L)) for li in range(L)],
            jnp.float32,
        )
        sig_kp = lvl_sigmas[lvl]  # [B, K] octave-coordinate sigma

        def run(g_b, lvl_b, xs_b, ys_b, sig_b):
            return _orientation_and_descriptor(
                g_b, lvl_b + 1, xs_b, ys_b, sig_b, opts
            )

        ang, desc, _ = jax.vmap(run)(gauss, lvl, xs_all, ys_all, sig_kp)
        all_out.append((xy, sigma, ang, desc, score, valid))
        cur = _downsample2(gauss[:, L])  # image with 2*sigma0 blur
        octave_scale *= 2.0

    xy = jnp.concatenate([a[0] for a in all_out], axis=1)
    sigma = jnp.concatenate([a[1] for a in all_out], axis=1)
    ang = jnp.concatenate([a[2] for a in all_out], axis=1)
    desc = jnp.concatenate([a[3] for a in all_out], axis=1)
    score = jnp.concatenate([a[4] for a in all_out], axis=1)
    valid = jnp.concatenate([a[5] for a in all_out], axis=1)

    # global top max_features by score
    K = opts.max_features
    sc = jnp.where(valid, score, -1.0)
    take = min(K, sc.shape[1])
    top_sc, top_i = jax.lax.top_k(sc, take)
    gather = lambda a: jnp.take_along_axis(
        a, top_i.reshape(B, take, *([1] * (a.ndim - 2))), axis=1
    )
    xy = jnp.take_along_axis(xy, top_i[..., None], axis=1)
    sigma = jnp.take_along_axis(sigma, top_i, axis=1)
    ang = jnp.take_along_axis(ang, top_i, axis=1)
    desc = jnp.take_along_axis(desc, top_i[..., None], axis=1)
    valid = top_sc > 0

    desc = l1_root_normalize(desc)
    desc_u8 = descs_to_uint8(desc)
    return xy, sigma, ang, desc_u8, top_sc, valid


class SiftExtractor:
    """Host-facing extractor (reference: SiftExtractor,
    src/feature/sift_extractor.cc)."""

    def __init__(self, opts: SiftOptions = SiftOptions()):
        self.opts = opts

    def extract(self, image: np.ndarray):
        """image [H,W] uint8/float grayscale -> (keypoints [N,4]
        (x, y, size, angle), descriptors [N,128] uint8)."""
        img = np.asarray(image)
        if img.ndim == 3:
            img = img.mean(axis=2)
        img = img.astype(np.float32)
        if img.max() > 1.5:
            img = img / 255.0
        h, w = img.shape
        # pad to multiples of 32 for stable shapes
        H = (h + 31) // 32 * 32
        W = (w + 31) // 32 * 32
        buf = np.zeros((1, H, W), np.float32)
        buf[0, :h, :w] = img
        xy, sigma, ang, desc, score, valid = _extract_jit(
            jnp.asarray(buf), self.opts, H, W
        )
        v = np.asarray(valid[0])
        xy = np.asarray(xy[0])[v]
        inb = (xy[:, 0] < w) & (xy[:, 1] < h)
        kps = np.zeros((int(inb.sum()), 4), np.float32)
        kps[:, :2] = xy[inb]
        kps[:, 2] = np.asarray(sigma[0])[v][inb]
        kps[:, 3] = np.asarray(ang[0])[v][inb]
        return kps, np.asarray(desc[0])[v][inb]

    def extract_batch(self, images, batch: int = 8):
        """Extract MANY images with batched dispatches (the device
        pipeline _extract_jit is natively [B,H,W]).  Images of one
        padded (H, W) group run `batch` at a
        time with ONE device fetch per group.  Returns a list of
        (keypoints [N,4], descriptors [N,128]) in input order."""
        prepped = []
        for image in images:
            img = np.asarray(image)
            if img.ndim == 3:
                img = img.mean(axis=2)
            if img.dtype != np.uint8:
                # keep uint8 sources as uint8: f32 would quadruple the
                # host->device transfer for no precision gain (the [0,1]
                # scale happens in-jit)
                img = img.astype(np.float32)
                if img.size and img.max() > 1.5:
                    img = img / 255.0
            prepped.append(img)
        groups = {}
        for i, img in enumerate(prepped):
            h, w = img.shape
            H = (h + 31) // 32 * 32
            W = (w + 31) // 32 * 32
            groups.setdefault((H, W, img.dtype == np.uint8), []).append(i)
        out = [None] * len(prepped)
        for (H, W, is_u8), idxs in groups.items():
            for s in range(0, len(idxs), batch):
                grp = idxs[s: s + batch]
                buf = np.zeros((len(grp), H, W),
                               np.uint8 if is_u8 else np.float32)
                for bi, i in enumerate(grp):
                    h, w = prepped[i].shape
                    buf[bi, :h, :w] = prepped[i]
                res = _extract_jit(jnp.asarray(buf), self.opts, H, W)
                xy, sigma, ang, desc, _score, valid = jax.device_get(res)
                for bi, i in enumerate(grp):
                    h, w = prepped[i].shape
                    v = valid[bi]
                    xyi = xy[bi][v]
                    inb = (xyi[:, 0] < w) & (xyi[:, 1] < h)
                    kps = np.zeros((int(inb.sum()), 4), np.float32)
                    kps[:, :2] = xyi[inb]
                    kps[:, 2] = sigma[bi][v][inb]
                    kps[:, 3] = ang[bi][v][inb]
                    out[i] = (kps, desc[bi][v][inb])
        return out
