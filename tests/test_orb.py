"""Batched ORB extractor (ops/orb.py) — reference USE_ORB path
(feature_extraction.cc:21-56) + Hamming matching (OrbMatch)."""

import numpy as np
import pytest

from xrsfm_tpu.ops.orb import OrbExtractor, OrbOptions
from test_sift import make_texture


def _ex():
    return OrbExtractor(OrbOptions(num_features=512, num_levels=4))


@pytest.mark.slow
def test_orb_detects_and_describes():
    img, _ = make_texture(h=256, w=256, seed=5, n_blobs=150)
    kps, descs = _ex().extract(img)
    assert len(kps) > 100, len(kps)
    assert descs.shape[1] == 32 and descs.dtype == np.uint8
    # descriptors are non-degenerate (not all equal)
    assert len(np.unique(descs, axis=0)) > len(descs) * 0.9


@pytest.mark.slow
def test_orb_translation_matching():
    from xrsfm_tpu.ops.matching import match_pair_host_hamming

    img, _ = make_texture(h=256, w=256, seed=6, n_blobs=150)
    dy, dx = 9, 14
    img2 = np.roll(np.roll(img, dy, axis=0), dx, axis=1)
    k1, d1 = _ex().extract(img)
    k2, d2 = _ex().extract(img2)
    assert len(k1) > 100 and len(k2) > 100
    pairs, _ = match_pair_host_hamming(d1, d2)
    assert len(pairs) > 40, len(pairs)
    delta = k2[pairs[:, 1], :2] - k1[pairs[:, 0], :2]
    err = np.linalg.norm(delta - np.array([dx, dy]), axis=-1)
    frac = np.mean(err < 2.0)
    assert frac > 0.6, frac


@pytest.mark.slow
def test_orb_rotation_matching():
    cv2 = pytest.importorskip("cv2")
    from xrsfm_tpu.ops.matching import match_pair_host_hamming

    img, _ = make_texture(h=256, w=256, seed=7, n_blobs=150)
    img8 = (img * 255).astype(np.uint8)
    M = cv2.getRotationMatrix2D((128, 128), 30.0, 1.0)
    img2 = cv2.warpAffine(img8, M, (256, 256)).astype(np.float32) / 255.0
    k1, d1 = _ex().extract(img)
    k2, d2 = _ex().extract(img2)
    pairs, _ = match_pair_host_hamming(d1, d2)
    pred = k1[pairs[:, 0], :2] @ M[:, :2].T + M[:, 2]
    err = np.linalg.norm(pred - k2[pairs[:, 1], :2], axis=-1)
    good = int(np.sum(err < 3.0))
    assert good > 25, (len(pairs), good)
