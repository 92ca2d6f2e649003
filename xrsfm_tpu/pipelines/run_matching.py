"""Matching stage pipeline (reference: src/run_matching.cc:153-258).

Usage: python -m xrsfm_tpu.cli run_matching <images_dir> <retrieval_path>
       <matching_type> <output_dir>

matching_type: sequential | retrieval | covisibility
Caches ftr.bin / size.bin / fp_init.bin like the reference
(run_matching.cc:25-31,57-59).
"""

from __future__ import annotations

import os
import time
from typing import List, Optional

import numpy as np

from ..feature import matching as fmatch
from ..ops.sift import SiftExtractor, SiftOptions
from ..utils import image_io
from ..utils import io_features as IOF


# moderate default vs the reference's 8192-feature upsampled config
# (sift_extractor.h:36-107); callers can pass the full config explicitly.
DEFAULT_SIFT = SiftOptions(
    num_octaves=4, features_per_octave=1024, max_features=4096, first_octave=0
)


def _read_gray(images_dir: str, name: str):
    """[H, W] uint8, or None when the file is missing."""
    try:
        return image_io.read_gray(os.path.join(images_dir, name))
    except FileNotFoundError:
        return None


def get_features(
    images_dir: str, ftr_path: str, image_names: List[str], verbose=True,
    sift_opts: SiftOptions = DEFAULT_SIFT, feature_type: str = "sift",
) -> List[IOF.FrameFeatures]:
    """Extract (or load cached) features.  feature_type "sift" (default)
    or "orb" (reference: GetFeatures run_matching.cc:15-33; the USE_ORB
    compile-time path of feature_extraction.cc:21-56 is a runtime option
    here — ORB descriptors are 32 bytes, matched by Hamming distance)."""
    if os.path.exists(ftr_path):
        feats = IOF.read_features(ftr_path)
        if len(feats) == len(image_names):
            return feats
    t0 = time.time()
    feats = []
    if feature_type == "orb":
        from ..ops.orb import OrbExtractor

        ex = OrbExtractor()
        for i, name in enumerate(image_names):
            img = _read_gray(images_dir, name)
            if img is None:
                feats.append(
                    IOF.FrameFeatures(name, np.zeros((0, 4), np.float32),
                                      np.zeros((0, 128), np.uint8))
                )
                continue
            kps, descs = ex.extract(img)
            if descs.shape[1] == 32:
                # ftr.bin stores 128-byte rows (reference format); pad
                # ORB's 32 bytes — Hamming consumers slice [:, :32]
                descs = np.pad(descs, ((0, 0), (0, 96)))
            feats.append(IOF.FrameFeatures(name, kps, descs))
            if verbose:
                print(f"[extract] {i + 1}/{len(image_names)} {name}: "
                      f"{len(kps)} features", flush=True)
    else:
        # SIFT: one batched dispatch + one fetch per 16-image chunk
        # (ops/sift.extract_batch)
        ex = SiftExtractor(sift_opts)
        CHUNK = 16
        for s in range(0, len(image_names), CHUNK):
            grp = image_names[s: s + CHUNK]
            imgs, ok = [], []
            for name in grp:
                img = _read_gray(images_dir, name)
                ok.append(img is not None)
                imgs.append(
                    img if img is not None
                    else np.zeros((32, 32), np.uint8)
                )
            results = ex.extract_batch(imgs, batch=CHUNK)
            for name, good, (kps, descs) in zip(grp, ok, results):
                if not good:
                    feats.append(IOF.FrameFeatures(
                        name, np.zeros((0, 4), np.float32),
                        np.zeros((0, 128), np.uint8),
                    ))
                else:
                    feats.append(IOF.FrameFeatures(name, kps, descs))
            if verbose:
                print(f"[extract] {min(s + CHUNK, len(image_names))}"
                      f"/{len(image_names)}", flush=True)
    if verbose:
        print(f"[extract] total {time.time() - t0:.1f}s", flush=True)
    IOF.write_features(ftr_path, feats)
    return feats


def get_image_sizes(images_dir, size_path, image_names):
    if os.path.exists(size_path):
        sizes = IOF.read_image_size(size_path)
        if len(sizes) == len(image_names):
            return sizes
    sizes = np.zeros((len(image_names), 2), np.int32)
    for i, name in enumerate(image_names):
        img = _read_gray(images_dir, name)
        if img is not None:
            sizes[i] = [img.shape[1], img.shape[0]]
    IOF.write_image_size(size_path, sizes)
    return sizes


def main(
    images_dir: str,
    retrieval_path: str,
    matching_type: str,
    output_dir: str,
    opts: Optional[fmatch.MatchingOptions] = None,
    n_devices: int = 1,
    stats: Optional[dict] = None,
):
    """stats (optional dict) receives pairs_proposed — the number of
    candidate pairs descriptor-matched+verified, the matching stage's
    actual cost driver (benchmarks compare strategies by it) — and the
    wall seconds of feature extraction (extract_s) and of matching plus
    verification (match_s)."""
    opts = opts or fmatch.MatchingOptions()
    mesh = None
    if n_devices > 1:
        import jax
        from jax.sharding import Mesh

        devs = jax.devices()
        if len(devs) < n_devices:
            raise RuntimeError(f"n_devices={n_devices} requested, only "
                               f"{len(devs)} visible")
        mesh = Mesh(np.array(devs[:n_devices]), axis_names=("pairs",))
    os.makedirs(output_dir, exist_ok=True)
    image_names = IOF.load_image_names(images_dir)
    name_to_id = {n: i for i, n in enumerate(image_names)}

    t_ex = time.time()
    feats = get_features(images_dir, os.path.join(output_dir, "ftr.bin"), image_names)
    if stats is not None:
        stats["extract_s"] = time.time() - t_ex
    get_image_sizes(images_dir, os.path.join(output_dir, "size.bin"), image_names)

    id2rank = {}
    if retrieval_path and os.path.exists(retrieval_path):
        id2rank = IOF.load_retrieval_rank(retrieval_path, name_to_id)
    elif matching_type in ("retrieval", "covisibility"):
        # self-contained retrieval: the reference requires an externally
        # produced retrieval.txt here (run_matching.cc:193-207); we build
        # the ranks ourselves from the just-extracted descriptors
        # (feature/retrieval.py: VLAD + one similarity matmul) and
        # cache them in the reference's text format.
        from ..feature import retrieval as RET

        cache = os.path.join(output_dir, "retrieval.txt")
        if os.path.exists(cache):
            id2rank = IOF.load_retrieval_rank(cache, name_to_id)
        else:
            t_r = time.time()
            ranks, _ = RET.build_retrieval(
                [f.descriptors for f in feats], topk=opts.retrieval_topk
            )
            RET.write_retrieval_text(cache, image_names, ranks)
            id2rank = RET.ranks_to_id2rank(ranks)
            print(f"[retrieval] built in {time.time() - t_r:.1f}s -> {cache}",
                  flush=True)

    t0 = time.time()
    if matching_type == "sequential":
        pairs = fmatch.sequential_pairs(len(image_names), opts)
        # loop-closure probes every Nth frame against retrieval neighbors
        # (reference: MatchingSeq, run_matching.cc:125-151)
        for i in range(0, len(image_names), opts.seq_loop_stride):
            for j in id2rank.get(i, [])[: opts.retrieval_topk]:
                if abs(i - j) >= opts.seq_window:
                    pairs.append((min(i, j), max(i, j)))
        pairs = sorted(set(pairs))
        if stats is not None:
            stats["pairs_proposed"] = len(pairs)
        verified = fmatch.match_and_verify_pairs(feats, pairs, opts, mesh=mesh)
    elif matching_type == "retrieval":
        pairs = fmatch.retrieval_pairs(id2rank, opts.retrieval_topk)
        if stats is not None:
            stats["pairs_proposed"] = len(pairs)
        verified = fmatch.match_and_verify_pairs(feats, pairs, opts, mesh=mesh)
    elif matching_type == "covisibility":
        from ..feature.expansion import covisibility_matching

        verified = covisibility_matching(
            feats, id2rank, opts,
            init_pairs_path=os.path.join(output_dir, "fp_init.bin"),
            mesh=mesh, stats=stats,
        )
    else:
        raise ValueError(f"unknown matching type {matching_type}")

    if stats is not None:
        stats["match_s"] = time.time() - t0
    IOF.write_frame_pairs(os.path.join(output_dir, "fp.bin"), verified)
    print(
        f"[matching] {matching_type}: {len(verified)} verified pairs "
        f"in {time.time() - t0:.1f}s -> {output_dir}/fp.bin",
        flush=True,
    )
    return verified
