"""Matching stage: pair selection + descriptor matching + F verification.

(reference: src/feature/feature_processing.cc:222-308 FeatureMatching,
src/run_matching.cc pair strategies — sequential :125-151, retrieval
:66-90; geometric verification via LORANSAC<F7pt, F8pt> at 4px,
src/geometry/epipolar_geometry.hpp:10-27)

Descriptor matching is batched over pairs (ops/matching); geometric
verification runs the vectorized LO-RANSAC harness with the
7-point minimal solver and an 8-point refit, one jit per match-count
bucket.  Pairs are processed in device-sized chunks, keeping the host loop
at O(pairs) bookkeeping only.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..mapper.kernels import bucket
from ..ops import epipolar, matching as dmatch, ransac
from ..utils.io_features import FrameFeatures, FramePairData


@dataclasses.dataclass
class MatchingOptions:
    # reference: uint8 matcher thresholds (feature_processing.cc:121-123)
    dist_th: float = 0.7
    ratio_th: float = 0.8
    # reference: SolveFundamnetalCOLMAP 4px, keep if inliers >=
    # max(15, 0.25 * num_matches) (feature_processing.cc:284-289)
    f_ransac_px: float = 4.0
    min_inliers: int = 15
    min_inlier_ratio: float = 0.25
    num_hypotheses: int = 256
    # sequential strategy (run_matching.cc:125-151)
    seq_window: int = 20
    seq_loop_stride: int = 5
    # retrieval strategy (run_matching.cc:66-90)
    retrieval_topk: int = 25


@functools.partial(jax.jit, static_argnames=("mm",))
def _match_chunk_resident(descs, masks, idx, dist_th, ratio_th, mm: int):
    """One dispatch per chunk on the single-device path: the pair gather
    from the resident descriptor pool happens inside the jit."""
    i1, i2 = idx[:, 0], idx[:, 1]
    return dmatch.match_descriptors_batch(
        descs[i1], descs[i2], masks[i1], masks[i2], dist_th, ratio_th, mm
    )


@jax.jit
def _fundamental_ransac(key, x1, x2, mask, threshold):
    """LO-RANSAC fundamental: 7pt hypotheses + 8pt refit on inliers."""

    def estimate(sampled, sample_valid):
        a, b = sampled
        return epipolar.fundamental_7pt(a, b, sample_valid)

    def residual(F, data):
        a, b = data
        return epipolar.sampson_error(F, a, b)

    def refit(data, inl):
        a, b = data
        return epipolar.fundamental_8pt(a, b, inl)

    res = ransac.ransac(
        key,
        data=(x1, x2),
        mask=mask,
        estimate_fn=estimate,
        residual_fn=residual,
        sample_size=7,
        threshold=threshold,
        num_hypotheses=256,
        refit_fn=refit,
        lo_iters=2,
    )
    return res.model, res.inliers, res.num_inliers, res.success


@jax.jit
def _fundamental_ransac_batch(keys, x1, x2, mask, threshold):
    """vmapped LO-RANSAC over a batch of pairs with a shared bucket size.
    keys [B,2] uint32; x1, x2 [B, N, 2]; mask [B, N]."""
    return jax.vmap(_fundamental_ransac, in_axes=(0, 0, 0, 0, None))(
        keys, x1, x2, mask, threshold
    )


def sequential_pairs(num_frames: int, opts: MatchingOptions) -> List[Tuple[int, int]]:
    """Adjacent window + every-Nth loop-closure probes.
    (reference: MatchingSeq, run_matching.cc:125-151)."""
    pairs = []
    for i in range(num_frames):
        for k in range(1, opts.seq_window):
            j = i + k
            if j < num_frames:
                pairs.append((i, j))
    return sorted(set(pairs))


def retrieval_pairs(
    id2rank: Dict[int, List[int]], topk: int
) -> List[Tuple[int, int]]:
    """Top-k retrieval neighbors per image, deduplicated
    (reference: ExtractNearestImagePairs, run_matching.cc:66-90)."""
    seen = set()
    out = []
    for i, ranked in id2rank.items():
        for j in ranked[:topk]:
            a, b = (i, j) if i < j else (j, i)
            if a != b and (a, b) not in seen:
                seen.add((a, b))
                out.append((a, b))
    return sorted(out)


def match_and_verify_pairs(
    features: Sequence[FrameFeatures],
    pair_ids: Sequence[Tuple[int, int]],
    opts: MatchingOptions = MatchingOptions(),
    verbose: bool = True,
    mesh=None,
) -> List[FramePairData]:
    """Full matching stage over candidate pairs.  Returns verified pairs
    with inlier masks (pairs failing the inlier rule are dropped).

    mesh (jax.sharding.Mesh, optional): shard each chunk's pair batch
    over the mesh's first axis — descriptor matching (shard_map,
    parallel/dist_matching) and verification are embarrassingly
    pair-parallel, so B pairs run in B/n_dev time (the reference runs
    pairs serially through one SiftMatchGPU,
    feature_processing.cc:222-308)."""
    out: List[FramePairData] = []
    n_dev = 1
    shard = None
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec

        n_dev = int(np.prod(list(mesh.shape.values())))
        if n_dev > 1:
            shard = NamedSharding(
                mesh, PartitionSpec(tuple(mesh.axis_names)[0])
            )

    def put(a):
        return jax.device_put(jnp.asarray(a), shard) if shard is not None \
            else a

    # device-resident descriptor pool, padded per frame to a shared bucket
    kmax = max((len(f.keypoints) for f in features), default=0)
    K = bucket(kmax, lo=256)
    n_f = len(features)
    descs = np.zeros((n_f, K, 128), np.uint8)
    masks = np.zeros((n_f, K), bool)
    kps = np.zeros((n_f, K, 2), np.float32)
    for i, f in enumerate(features):
        n = len(f.keypoints)
        descs[i, :n] = f.descriptors
        masks[i, :n] = True
        kps[i, :n] = f.keypoints[:, :2]
    descs_d = jnp.asarray(descs)
    masks_d = jnp.asarray(masks)

    # pass 1: descriptor matching — pairs batched into fixed-size chunks
    # (one dispatch and one host fetch per chunk).  Chunks are
    # double-buffered: chunk k+1 is dispatched (async) before chunk k's
    # results are fetched, so the device works on k+1 while the host
    # harvests k.
    cand = []  # (i, j, matches [M,2], dists [M])
    mm = min(K, 4096)
    B = 16 * n_dev

    def _dispatch_match(s):
        grp = list(pair_ids[s : s + B])
        pad = B - len(grp)
        idx = np.asarray(grp + [grp[-1]] * pad, np.int32)  # keep B static
        if shard is None:
            # single-device: gather fused into ONE jitted dispatch
            return grp, _match_chunk_resident(
                descs_d, masks_d, idx, opts.dist_th, opts.ratio_th, mm
            )
        from ..parallel.dist_matching import match_batch_sharded

        return grp, match_batch_sharded(
            mesh, descs_d[idx[:, 0]], descs_d[idx[:, 1]],
            masks_d[idx[:, 0]], masks_d[idx[:, 1]],
            opts.dist_th, opts.ratio_th, mm,
        )

    def _harvest_match(grp, fut):
        m_np, c_np, d_np = jax.device_get(fut)
        for k, (i, j) in enumerate(grp):
            n_m = int(c_np[k])
            if n_m < max(8, opts.min_inliers):
                continue
            mnp = m_np[k]
            mnp = mnp[mnp[:, 0] >= 0][:n_m]
            cand.append((i, j, mnp, d_np[k][: len(mnp)]))

    pending = None
    for ci, s in enumerate(range(0, len(pair_ids), B)):
        nxt = _dispatch_match(s)
        if pending is not None:
            _harvest_match(*pending)
        pending = nxt
        if verbose and (ci % 16 == 0):
            print(
                f"[matching] matched {min(s + B, len(pair_ids))}"
                f"/{len(pair_ids)}",
                flush=True,
            )
    if pending is not None:
        _harvest_match(*pending)

    # pass 2: geometric verification, vmapped in bucket-grouped chunks
    by_bucket = {}
    for k, (i, j, mnp, d) in enumerate(cand):
        by_bucket.setdefault(bucket(len(mnp)), []).append(k)
    th = jnp.asarray(opts.f_ransac_px**2, jnp.float32)
    CHUNK = 16 * n_dev

    def _dispatch_verify(b, grp):
        x1 = np.zeros((CHUNK, b, 2), np.float32)
        x2 = np.zeros((CHUNK, b, 2), np.float32)
        vm = np.zeros((CHUNK, b), bool)
        keys = np.zeros((CHUNK, 2), np.uint32)
        for g, k in enumerate(grp):
            i, j, mnp, _ = cand[k]
            n_m = len(mnp)
            x1[g, :n_m] = kps[i][mnp[:, 0]]
            x2[g, :n_m] = kps[j][mnp[:, 1]]
            vm[g, :n_m] = True
            keys[g] = np.asarray(
                jax.random.PRNGKey((i * 32768 + j) & 0x7FFFFFFF)
            )
        # numpy args + one batched fetch
        return grp, _fundamental_ransac_batch(
            put(keys), put(x1), put(x2), put(vm), th
        )

    def _harvest_verify(grp, fut):
        F_b, inl_b, n_inl_b, ok_b = jax.device_get(fut)
        for g, k in enumerate(grp):
            i, j, mnp, d = cand[k]
            n_m = len(mnp)
            n_inl = int(n_inl_b[g])
            if not bool(ok_b[g]) or n_inl < max(
                opts.min_inliers, int(opts.min_inlier_ratio * n_m)
            ):
                continue
            out.append(
                FramePairData(
                    id1=i,
                    id2=j,
                    matches=mnp,
                    distances=d.astype(np.float64),
                    E=np.asarray(F_b[g], np.float64),
                    inlier_num=n_inl,
                    inlier_mask=inl_b[g][:n_m],
                )
            )

    # same double-buffering as pass 1 (note: chunks of DIFFERENT buckets
    # overlap too — the pending future is harvested after the next
    # bucket's first dispatch)
    pending = None
    for b, idxs in sorted(by_bucket.items()):
        for s in range(0, len(idxs), CHUNK):
            nxt = _dispatch_verify(b, idxs[s : s + CHUNK])
            if pending is not None:
                _harvest_verify(*pending)
            pending = nxt
    if pending is not None:
        _harvest_verify(*pending)
    if verbose:
        print(
            f"[matching] verified {len(out)}/{len(cand)} candidate pairs",
            flush=True,
        )
    return out
