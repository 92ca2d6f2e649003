"""Image retrieval: VLAD over RootSIFT descriptors.

The reference does NOT ship a retrieval method — its `run_matching` consumes
a `retrieval.txt` produced by an external image-retrieval tool
(reference: src/run_matching.cc:193-207 loads it via LoadRetrievalRank,
src/utility/io_feature.hpp:180-212; docs/en/tutorial.md tells users to
bring their own ranked list).  Here retrieval is a first-class pipeline
stage so the framework is self-contained, and the formulation is built
from matrix products:

  * vocabulary: k-means over a descriptor sample, where the assignment
    step is one [N,128]x[128,K] matmul + row argmax and the update step is
    a one-hot-matmul reduction ([K,N]x[N,128]) — no scatters;
  * VLAD encoding: descriptor-to-word residual aggregation is the same
    one-hot matmul per image (batched over images with masks for padded
    descriptor slots), followed by intra-normalization, signed-sqrt (SSR)
    and global L2 — giving one [K*128] vector per image;
  * ranking: all-pairs similarity of the whole dataset is ONE
    [F, K*128]x[K*128, F] matmul; top-k along rows gives the ranked list.

Descriptors arrive as the matcher's uint8 quantization of L1-root
normalized SIFT (512*v, ops/sift.descs_to_uint8), so x/512 is unit-L2
("RootSIFT") and dot products are cosine similarities.

Output interoperates with the reference: write_retrieval_text emits the
`name_query name_match` ranked-pair lines LoadRetrievalRank parses.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np


def _bucket(n: int, lo: int = 256) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


# ---------------------------------------------------------------------------
# vocabulary (k-means, device)
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("iters",))
def _kmeans(descs, init_centers, iters: int):
    """Lloyd iterations; descs [N,128] f32 (rows may be zero-padded with
    weight 0 via `valid`), centers [K,128].  Assignment = argmin squared
    distance computed as ||c||^2 - 2 x.c (||x||^2 is constant per row);
    update = one-hot matmul; empty clusters keep their previous center."""
    valid = jnp.any(descs != 0.0, axis=1).astype(jnp.float32)  # [N]
    K = init_centers.shape[0]

    def body(_, centers):
        d2 = jnp.sum(centers * centers, axis=1)[None, :] - 2.0 * (
            descs @ centers.T
        )  # [N,K]
        assign = jnp.argmin(d2, axis=1)  # [N]
        onehot = (
            jax.nn.one_hot(assign, K, dtype=jnp.float32) * valid[:, None]
        )  # [N,K]
        sums = onehot.T @ descs  # [K,128]
        counts = jnp.sum(onehot, axis=0)  # [K]
        new = sums / jnp.maximum(counts, 1.0)[:, None]
        return jnp.where(counts[:, None] > 0, new, centers)

    centers = jax.lax.fori_loop(0, iters, body, init_centers)
    # final quantization error (for tests/diagnostics)
    d2 = jnp.sum(centers * centers, axis=1)[None, :] - 2.0 * (descs @ centers.T)
    err = jnp.sum(jnp.min(d2, axis=1) * valid) / jnp.maximum(
        jnp.sum(valid), 1.0
    ) + jnp.sum(descs * descs * valid[:, None]) / jnp.maximum(jnp.sum(valid), 1.0)
    return centers, err


def train_vocabulary(
    desc_sets: Sequence[np.ndarray],
    num_words: int = 64,
    iters: int = 15,
    max_samples: int = 65536,
    seed: int = 0,
) -> np.ndarray:
    """Train a visual vocabulary from per-image uint8 descriptor arrays.

    Returns [num_words, 128] float32 word centers in unit-RootSIFT scale.
    Sampling and init are host-side numpy; the Lloyd loop runs jitted.
    """
    rng = np.random.default_rng(seed)
    pool = [d for d in desc_sets if len(d)]
    if not pool:
        return np.zeros((num_words, 128), np.float32)
    alld = np.concatenate(pool, axis=0).astype(np.float32) / 512.0
    if len(alld) > max_samples:
        sel = rng.choice(len(alld), size=max_samples, replace=False)
        alld = alld[sel]
    n = len(alld)
    N = _bucket(n)
    sample = np.zeros((N, 128), np.float32)
    sample[:n] = alld
    # k-means++-lite init: random distinct picks (good enough at SIFT
    # descriptor dimensionality; avoids O(K*N) host passes)
    init_idx = rng.choice(n, size=min(num_words, n), replace=False)
    init = np.zeros((num_words, 128), np.float32)
    init[: len(init_idx)] = alld[init_idx]
    if len(init_idx) < num_words:  # duplicate picks for tiny samples
        extra = rng.choice(len(init_idx), num_words - len(init_idx))
        init[len(init_idx):] = alld[init_idx[extra]] + rng.normal(
            scale=1e-3, size=(num_words - len(init_idx), 128)
        ).astype(np.float32)
    centers, _ = _kmeans(sample, jnp.asarray(init), iters)
    return np.asarray(centers)


# ---------------------------------------------------------------------------
# VLAD encoding (device, batched over images)
# ---------------------------------------------------------------------------


@jax.jit
def _vlad_batch(descs, valid, vocab):
    """descs [B,N,128] f32, valid [B,N] f32, vocab [K,128] → [B, K*129].

    Hard-assignment VLAD with intra-normalization (per-word L2), SSR, and
    global L2 — the standard all-about-VLAD recipe, all matmuls — plus a
    sqrt-BoW occupancy block appended.  The occupancy block matters when
    the vocabulary is trained on the indexed images themselves (the
    self-contained pipeline here): residuals then collapse toward i.i.d.
    noise and intra-normalization turns them into near-orthogonal unit
    vectors, so WHICH words an image occupies — not the residual
    direction — carries the scene identity."""
    K = vocab.shape[0]
    d2 = jnp.sum(vocab * vocab, axis=1)[None, None, :] - 2.0 * jnp.einsum(
        "bnd,kd->bnk", descs, vocab
    )
    assign = jnp.argmin(d2, axis=2)  # [B,N]
    onehot = jax.nn.one_hot(assign, K, dtype=jnp.float32) * valid[..., None]
    # residual sum: sum_n 1[a_n=k] (x_n - c_k)
    sums = jnp.einsum("bnk,bnd->bkd", onehot, descs)  # [B,K,128]
    counts = jnp.sum(onehot, axis=1)  # [B,K]
    v = sums - counts[..., None] * vocab[None]
    # intra-normalize each word's residual block
    v = v / (jnp.linalg.norm(v, axis=2, keepdims=True) + 1e-12)
    v = v.reshape(v.shape[0], -1)
    v = jnp.sign(v) * jnp.sqrt(jnp.abs(v))  # signed square root
    v = v / (jnp.linalg.norm(v, axis=1, keepdims=True) + 1e-12)
    # sqrt-BoW occupancy histogram (tf power-law), unit-normalized
    bow = jnp.sqrt(counts)
    bow = bow / (jnp.linalg.norm(bow, axis=1, keepdims=True) + 1e-12)
    # equal-weight concat of the two unit blocks, renormalized to unit
    out = jnp.concatenate([v, bow], axis=1) / jnp.sqrt(2.0)
    # images with no descriptors stay exactly zero
    any_valid = jnp.any(valid > 0, axis=1)[:, None]
    return jnp.where(any_valid, out, 0.0)


def encode_vlad(
    desc_sets: Sequence[np.ndarray],
    vocab: np.ndarray,
    batch_size: int = 16,
) -> np.ndarray:
    """Encode every image's uint8 descriptors to a VLAD vector.

    Host driver: pads descriptor counts to a shared power-of-two bucket
    per chunk (keeps the jit cache small) and batches images.  Returns
    [F, K*129] float32 (VLAD + sqrt-BoW occupancy; zero rows for images
    with no descriptors)."""
    F = len(desc_sets)
    K = vocab.shape[0]
    out = np.zeros((F, K * 129), np.float32)
    vocab_j = jnp.asarray(vocab)
    order = np.argsort([len(d) for d in desc_sets], kind="stable")
    for s in range(0, F, batch_size):
        ids = order[s : s + batch_size]
        maxn = max(int(len(desc_sets[i])) for i in ids)
        if maxn == 0:
            continue
        N = _bucket(maxn, lo=256)
        B = len(ids)
        db = np.zeros((B, N, 128), np.float32)
        vb = np.zeros((B, N), np.float32)
        for r, i in enumerate(ids):
            d = desc_sets[i]
            db[r, : len(d)] = d.astype(np.float32) / 512.0
            vb[r, : len(d)] = 1.0
        enc = np.asarray(_vlad_batch(db, vb, vocab_j))
        out[ids] = enc
    return out


# ---------------------------------------------------------------------------
# ranking
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("topk",))
def _topk_sim(q, db, qids, topk: int):
    sim = q @ db.T  # [Bq, F] — one matrix product over the whole dataset
    F = db.shape[0]
    col = jnp.arange(F)[None, :]
    sim = jnp.where(col == qids[:, None], -jnp.inf, sim)  # mask self
    vals, idx = jax.lax.top_k(sim, min(topk, F))
    return vals, idx


def rank_images(
    vlads: np.ndarray, topk: int = 25, chunk: int = 256
) -> np.ndarray:
    """Top-k most-similar image ids per image, by VLAD cosine. [F, topk]."""
    F = len(vlads)
    k = min(topk, max(F - 1, 1))
    out = np.zeros((F, k), np.int32)
    db = jnp.asarray(vlads)
    for s in range(0, F, chunk):
        e = min(s + chunk, F)
        _, idx = _topk_sim(db[s:e], db, jnp.arange(s, e), k)
        out[s:e] = np.asarray(idx)[:, :k]
    return out


def ranks_to_id2rank(ranks: np.ndarray) -> Dict[int, List[int]]:
    """Convert [F, topk] rank matrix to the id->ranked-ids dict the
    matching pipeline consumes (same shape as load_retrieval_rank's)."""
    return {i: [int(j) for j in row] for i, row in enumerate(ranks)}


def write_retrieval_text(
    path: str, image_names: Sequence[str], ranks: np.ndarray
) -> None:
    """Write `query match` ranked lines, grouped by query in rank order —
    byte-compatible with the reference's LoadRetrievalRank parser
    (reference: src/utility/io_feature.hpp:180-212)."""
    with open(path, "w") as f:
        for i, row in enumerate(ranks):
            for j in row:
                f.write(f"{image_names[i]} {image_names[int(j)]}\n")


def build_retrieval(
    desc_sets: Sequence[np.ndarray],
    num_words: int = 64,
    topk: int = 25,
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Full pipeline: vocabulary → VLAD → ranks.  Returns (ranks, vlads)."""
    vocab = train_vocabulary(desc_sets, num_words=num_words, seed=seed)
    vlads = encode_vlad(desc_sets, vocab)
    return rank_images(vlads, topk=topk), vlads
