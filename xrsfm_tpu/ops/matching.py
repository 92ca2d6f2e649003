"""Batched SIFT descriptor matching.

Replacement for SiftMatchGPU (reference: 3rdparty/SiftGPU/SiftMatchCU.cpp
+ ProgramCU.cu:1491-1852, consumed by src/feature/feature_processing.cc:
100-154).  The reference computes an all-pairs descriptor dot-product per
image pair on one CUDA device, then row/column mutual-best with a distance
and ratio test.  Here the per-pair statistics (row best, second best and
arg-best; column arg-best for the mutual check) come from one of two
implementations, and the accept rule follows the reference's uint8 path:
angular distance < dist_th, best/second ratio < ratio_th, mutual best
(feature_processing.cc:118-154 uses distance_th=0.7, ratio=0.8 for uint8
descriptors).

- GPU: a fused Pallas kernel (Triton route).  Each block holds a tile of
  rows and streams column tiles through the tensor cores, keeping a
  running best / second / arg-best per row in registers, so the [N, M]
  similarity never reaches device memory.  The column arg-best is a
  second launch of the same kernel with the two sides swapped.  uint8
  values are exact in bf16 and their dot products (< 2^24) are exact in
  the f32 accumulator, so the statistics equal an int64 reference.
- CPU: the plain XLA body, which materialises the similarity per pair.

Descriptors are L1-root normalized and quantized to uint8 as 512*v
(reference: FeatureDescriptorsToUnsignedByte, sift_extractor.h:22-34), so
cos(angle) = <d1, d2> / 512^2.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

_QUANT = 512.0
_BIG = 1e9  # > any raw uint8 descriptor dot product (<= 255^2 * 128)
_TN = 64  # kernel rows per block
_TM = 128  # kernel columns per inner step; N and M are padded to this


def _top2_kernel(a_ref, b_ref, bias_ref, best_ref, sec_ref, arg_ref):
    """Per-row best, second best and lowest-index arg-best of
    a_tile . b^T + bias, streaming b in _TM-row tiles."""
    a = a_ref[...]  # [TN, D] bf16
    tn = a.shape[0]

    def body(j, carry):
        best, sec, arg = carry
        cols = pl.ds(j * _TM, _TM)
        s = pl.dot(a, b_ref[cols, :], trans_b=True) + bias_ref[cols][None, :]
        ids = jax.lax.broadcasted_iota(jnp.int32, s.shape, 1)
        tmax = jnp.max(s, axis=1)
        targ = jnp.min(jnp.where(s == tmax[:, None], ids, _TM), axis=1)
        tsec = jnp.max(jnp.where(ids == targ[:, None], -_BIG, s), axis=1)
        # earlier tiles hold lower indices, so a tie keeps the old arg
        up = tmax > best
        sec = jnp.where(up, jnp.maximum(best, tsec), jnp.maximum(sec, tmax))
        arg = jnp.where(up, targ + j * _TM, arg)
        return jnp.maximum(best, tmax), sec, arg

    init = (
        jnp.full((tn,), -jnp.inf, jnp.float32),
        jnp.full((tn,), -jnp.inf, jnp.float32),
        jnp.zeros((tn,), jnp.int32),
    )
    best, sec, arg = jax.lax.fori_loop(0, b_ref.shape[0] // _TM, body, init)
    best_ref[...] = best
    sec_ref[...] = sec
    arg_ref[...] = arg


@functools.partial(jax.jit, static_argnames=("interpret",))
def _top2_pallas(a, b, bias_b, interpret=False):
    """a [B, N, D] bf16, b [B, M, D] bf16, bias_b [B, M] f32 (0 or -BIG),
    N % _TN == 0 and M % _TM == 0.  Returns raw f32 (best [B, N],
    second [B, N]) and int32 best_j [B, N]."""
    B, N, D = a.shape
    M = b.shape[1]
    row = pl.BlockSpec((None, _TN), lambda p, i: (p, i))
    return pl.pallas_call(
        _top2_kernel,
        grid=(B, N // _TN),
        in_specs=[
            pl.BlockSpec((None, _TN, D), lambda p, i: (p, i, 0)),
            pl.BlockSpec((None, M, D), lambda p, i: (p, 0, 0)),
            pl.BlockSpec((None, M), lambda p, i: (p, 0)),
        ],
        out_specs=[row, row, row],
        out_shape=[
            jax.ShapeDtypeStruct((B, N), jnp.float32),
            jax.ShapeDtypeStruct((B, N), jnp.float32),
            jax.ShapeDtypeStruct((B, N), jnp.int32),
        ],
        compiler_params=pltriton.CompilerParams(num_warps=4, num_stages=3),
        interpret=interpret,
        name="match_top2",
    )(a, b, bias_b)


def _stats_pallas(d1, d2, mask1, mask2, interpret=False):
    """Kernel statistics for a batch of pairs, padded to the tile inside.
    Returns (cos_best, cos_second, best_j, col_arg) like _stats_xla."""
    B, N, _ = d1.shape
    M = d2.shape[1]
    pn, pm = (-N) % _TM, (-M) % _TM
    a = jnp.pad(d1, ((0, 0), (0, pn), (0, 0))).astype(jnp.bfloat16)
    b = jnp.pad(d2, ((0, 0), (0, pm), (0, 0))).astype(jnp.bfloat16)
    bias1 = jnp.where(jnp.pad(mask1, ((0, 0), (0, pn))), 0.0, -_BIG)
    bias2 = jnp.where(jnp.pad(mask2, ((0, 0), (0, pm))), 0.0, -_BIG)
    best, sec, best_j = _top2_pallas(a, b, bias2, interpret=interpret)
    _, _, col_arg = _top2_pallas(b, a, bias1, interpret=interpret)
    q2 = _QUANT * _QUANT
    return best[:, :N] / q2, sec[:, :N] / q2, best_j[:, :N], col_arg[:, :M]


def _stats_xla(d1, d2, mask1, mask2):
    """Plain XLA statistics for one pair: the [N, M] similarity is built
    in f32 and kept in bf16 for the reduction passes, so arg-bests can
    differ from the exact ones at bf16 ties."""
    f1 = d1.astype(jnp.bfloat16)
    f2 = d2.astype(jnp.bfloat16)
    sim32 = jax.lax.dot_general(
        f1, f2, (((1,), (1,)), ((), ())), preferred_element_type=jnp.float32
    ) / (_QUANT * _QUANT)
    sim = jnp.where(mask1[:, None] & mask2[None, :], sim32, -2.0).astype(
        jnp.bfloat16
    )
    best_j = jnp.argmax(sim, axis=1)  # [N]
    cos_best = jnp.take_along_axis(sim32, best_j[:, None], axis=1)[:, 0]
    masked = sim.at[jnp.arange(sim.shape[0]), best_j].set(-2.0)
    cos_second = jnp.max(masked, axis=1).astype(jnp.float32)
    col_arg = jnp.argmax(sim, axis=0)  # [M]
    return cos_best, cos_second, best_j, col_arg


def _compact(ok, best_j, dist, max_matches: int):
    """First max_matches accepted rows as (matches [max_matches, 2] padded
    with -1, count, distances [max_matches])."""
    rows = jnp.argsort(~ok)[:max_matches]  # accepted rows first (stable)
    valid = ok[rows]
    matches = jnp.stack(
        [
            jnp.where(valid, rows, -1).astype(jnp.int32),
            jnp.where(valid, best_j[rows], -1).astype(jnp.int32),
        ],
        axis=-1,
    )
    return matches, jnp.sum(ok), jnp.where(valid, dist[rows], 0.0)


def _accept_compact(cos_best, cos_second, best_j, col_arg, mask1,
                    dist_th, ratio_th, max_matches: int):
    """Accept rule (distance + ratio + mutual, reference
    feature_processing.cc:118-154) for one pair, then compaction."""
    N = cos_best.shape[0]
    cos_best = jnp.where(mask1, cos_best, -2.0)
    dist_best = jnp.arccos(jnp.clip(cos_best, -1.0, 1.0))
    dist_second = jnp.arccos(jnp.clip(cos_second, -1.0, 1.0))
    ok = (
        mask1
        & (cos_best > -1.0)
        & (dist_best < dist_th)
        & (dist_best < ratio_th * dist_second)
        & (col_arg[best_j] == jnp.arange(N))
    )
    return _compact(ok, best_j, dist_best, max_matches)


@functools.partial(jax.jit, static_argnames=("max_matches", "interpret"))
def _match_batch_pallas(d1, d2, mask1, mask2, dist_th=0.7, ratio_th=0.8,
                        max_matches: int = 4096, interpret=False):
    stats = _stats_pallas(d1, d2, mask1, mask2, interpret=interpret)
    return jax.vmap(
        lambda cb, cs, bj, ca, m: _accept_compact(
            cb, cs, bj, ca, m, dist_th, ratio_th, max_matches
        )
    )(*stats, mask1)


@functools.partial(jax.jit, static_argnames=("max_matches",))
def _match_batch_xla(d1, d2, mask1, mask2, dist_th=0.7, ratio_th=0.8,
                     max_matches: int = 4096):
    def one(a, b, ma, mb):
        stats = _stats_xla(a, b, ma, mb)
        return _accept_compact(*stats, ma, dist_th, ratio_th, max_matches)

    return jax.vmap(one)(d1, d2, mask1, mask2)


def _matcher_for(backend: str):
    """One implementation per platform: the fused kernel on the GPU, the
    XLA body on the CPU."""
    if backend == "gpu":
        return _match_batch_pallas
    if backend == "cpu":
        return _match_batch_xla
    raise NotImplementedError(f"no descriptor matcher for backend {backend!r}")


def match_descriptors_batch(
    d1, d2, mask1, mask2, dist_th=0.7, ratio_th=0.8, max_matches: int = 4096
):
    """Batched pair matching: d1 [B, N, 128], d2 [B, M, 128] uint8;
    masks [B, N] / [B, M] validity.  Returns (matches [B, max_matches, 2]
    int32 padded with -1, num_matches [B], distances [B, max_matches])."""
    return _matcher_for(jax.default_backend())(
        d1, d2, mask1, mask2, dist_th, ratio_th, max_matches
    )


def match_descriptors(d1, d2, mask1, mask2, dist_th: float = 0.7,
                      ratio_th: float = 0.8, max_matches: int = 4096):
    """Match two uint8 descriptor sets: d1 [N,128], d2 [M,128], mask1 [N],
    mask2 [M].  Returns (matches [max_matches, 2] int32 (padded with -1),
    num_matches, distances [max_matches])."""
    m, c, d = match_descriptors_batch(
        d1[None], d2[None], mask1[None], mask2[None], dist_th, ratio_th,
        max_matches,
    )
    return m[0], c[0], d[0]


def match_stats_np(d1, d2, mask1, mask2):
    """int64 brute-force reference of the matcher statistics for one
    pair: raw (best [N], second [N], best_j [N], col_arg [M]), ties to
    the lowest index, masked entries at -BIG."""
    # float64 BLAS is exact here (sums < 2^24 << 2^53) and much faster
    # than numpy's integer matmul at 8,192 x 8,192
    sim = (d1.astype(np.float64) @ d2.astype(np.float64).T).astype(np.int64)
    big = np.int64(_BIG)
    simr = np.where(mask2[None, :], sim, sim - big)
    best_j = np.argmax(simr, axis=1)
    rows = np.arange(len(d1))
    best = simr[rows, best_j]
    masked = simr.copy()
    masked[rows, best_j] = -big
    second = masked.max(axis=1) if sim.shape[1] > 1 else np.full(len(d1), -big)
    col_arg = np.argmax(np.where(mask1[:, None], sim, sim - big), axis=0)
    return best, second, best_j, col_arg


def match_descriptors_np(d1, d2, mask1, mask2, dist_th=0.7, ratio_th=0.8):
    """numpy reference of the whole matcher: accepted (i, j) pairs [K, 2]
    in row order.  The accept rule is evaluated in float32, as on the
    device."""
    best, second, best_j, col_arg = match_stats_np(d1, d2, mask1, mask2)
    q2 = np.float32(_QUANT * _QUANT)
    cb = np.where(mask1, best.astype(np.float32) / q2, np.float32(-2.0))
    cs = np.clip(second.astype(np.float32) / q2, -1.0, 1.0)
    db = np.arccos(np.clip(cb, -1.0, 1.0))
    ds = np.arccos(cs)
    ok = (
        mask1 & (cb > -1.0) & (db < np.float32(dist_th))
        & (db < np.float32(ratio_th) * ds)
        & (col_arg[best_j] == np.arange(len(d1)))
    )
    rows = np.nonzero(ok)[0]
    return np.stack([rows, best_j[rows]], axis=1).astype(np.int32)


@functools.partial(jax.jit, static_argnames=("max_matches",))
def match_descriptors_hamming(
    d1,
    d2,
    mask1,
    mask2,
    dist_th: int = 80,
    ratio_th: float = 0.9,
    max_matches: int = 4096,
):
    """Match two 256-bit ORB descriptor sets (Hamming distance) with one
    matrix product.

    Replacement for the reference's CPU `OrbMatch`
    (src/feature/feature_processing.cc:156-219: SWAR-popcount all-pairs
    Hamming, accept when best <= 80, best <= 0.9 * second-best, and
    mutual best).  Instead of a popcount loop, descriptors are unpacked
    to 256 {0,1} bits and hamming(a,b) = |a| + |b| - 2 a.b, so the whole
    distance matrix is one bf16 matmul with f32 accumulation (exact:
    all values are small integers).

    d1 [N,32] uint8, d2 [M,32] uint8, mask1 [N], mask2 [M] validity.
    Returns (matches [max_matches, 2] int32 (padded with -1),
             num_matches, distances [max_matches] in bits).
    """
    shifts = jnp.arange(8, dtype=jnp.uint8)
    bits1 = ((d1[:, :, None] >> shifts) & 1).reshape(d1.shape[0], 256)
    bits2 = ((d2[:, :, None] >> shifts) & 1).reshape(d2.shape[0], 256)
    b1 = bits1.astype(jnp.bfloat16)
    b2 = bits2.astype(jnp.bfloat16)
    dot = jax.lax.dot_general(
        b1, b2, (((1,), (1,)), ((), ())), preferred_element_type=jnp.float32
    )  # [N,M]
    n1 = jnp.sum(b1, axis=1, dtype=jnp.float32)
    n2 = jnp.sum(b2, axis=1, dtype=jnp.float32)
    dist = n1[:, None] + n2[None, :] - 2.0 * dot
    big = 1024.0  # > any 256-bit hamming distance
    dist = jnp.where(mask1[:, None] & mask2[None, :], dist, big)

    # top-2 smallest per row via two min passes
    best_j = jnp.argmin(dist, axis=1)  # [N]
    d_best = jnp.take_along_axis(dist, best_j[:, None], axis=1)[:, 0]
    masked = dist.at[jnp.arange(dist.shape[0]), best_j].set(big)
    d_second = jnp.min(masked, axis=1)

    col_best_i = jnp.argmin(dist, axis=0)  # [M]
    mutual = col_best_i[best_j] == jnp.arange(dist.shape[0])

    ok = (
        mask1
        & (d_best < big)
        & (d_best <= dist_th)
        & (d_best <= ratio_th * d_second)
        & mutual
    )
    return _compact(ok, best_j, d_best, max_matches)


def _pad_host(descs1, descs2, width: int):
    """Pad two host descriptor arrays to a shared power-of-two row count
    (>= 64); returns (d1, d2, m1, m2, k)."""
    n, m_ = len(descs1), len(descs2)
    k = 1
    while k < max(n, m_, 64):
        k *= 2
    d1 = np.zeros((k, width), np.uint8)
    d2 = np.zeros((k, width), np.uint8)
    d1[:n] = descs1
    d2[:m_] = descs2
    m1 = np.arange(k) < n
    m2 = np.arange(k) < m_
    return d1, d2, m1, m2, k


def _host_result(matches, cnt, dists):
    out = np.asarray(matches)
    out = out[out[:, 0] >= 0][: int(cnt)]
    return out.astype(np.int32), np.asarray(dists)[: len(out)]


def match_pair_host_hamming(descs1, descs2, dist_th=80, ratio_th=0.9):
    """Host wrapper for ORB matching on [N,32] uint8 descriptor arrays."""
    d1, d2, m1, m2, k = _pad_host(descs1, descs2, 32)
    return _host_result(*match_descriptors_hamming(
        d1, d2, m1, m2, dist_th, ratio_th, min(k, 4096)
    ))


def match_pair_host(feats1, feats2, dist_th=0.7, ratio_th=0.8):
    """Host wrapper on two [N,128] uint8 descriptor arrays."""
    d1, d2, m1, m2, k = _pad_host(feats1, feats2, 128)
    return _host_result(*match_descriptors(
        d1, d2, m1, m2, dist_th, ratio_th, min(k, 4096)
    ))
