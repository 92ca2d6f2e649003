"""Standalone image-retrieval stage: images -> retrieval.txt.

New capability (the reference has no retrieval binary — its run_matching
consumes a retrieval.txt from an external tool, src/run_matching.cc:193-207).
Extracts (or loads cached) SIFT features, trains a VLAD vocabulary, encodes
every image, ranks by one similarity matmul, and writes the ranked-pair
text file in the exact format the reference's LoadRetrievalRank parses
(src/utility/io_feature.hpp:180-212) — so the output also drops into the
reference's own pipeline.

Usage: python -m xrsfm_tpu.cli retrieve <images_dir> <output_dir>
       [--topk 25] [--num_words 64]
"""

from __future__ import annotations

import os
import time

from ..feature import retrieval as RET
from ..utils import io_features as IOF
from .run_matching import get_features


def main(images_dir: str, output_dir: str, topk: int = 25,
         num_words: int = 64):
    os.makedirs(output_dir, exist_ok=True)
    image_names = IOF.load_image_names(images_dir)
    feats = get_features(
        images_dir, os.path.join(output_dir, "ftr.bin"), image_names
    )
    t0 = time.time()
    ranks, _ = RET.build_retrieval(
        [f.descriptors for f in feats], num_words=num_words, topk=topk
    )
    out_path = os.path.join(output_dir, "retrieval.txt")
    RET.write_retrieval_text(out_path, image_names, ranks)
    print(
        f"[retrieve] {len(image_names)} images, top-{topk} ranks in "
        f"{time.time() - t0:.1f}s -> {out_path}",
        flush=True,
    )
    return ranks
