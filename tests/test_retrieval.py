"""Tests for the VLAD image retrieval (feature/retrieval.py).

The reference has no retrieval implementation to compare against (it
consumes an externally-produced retrieval.txt, run_matching.cc:193-207);
these tests validate the new capability on synthetic descriptor sets with
known scene membership, plus format interop with load_retrieval_rank.
"""

import numpy as np

from xrsfm_tpu.feature import retrieval as RET
from xrsfm_tpu.utils import io_features as IOF


def _make_scene_descs(rng, n_scenes=3, imgs_per_scene=4, words_per_scene=6,
                      descs_per_img=120, noise=0.02):
    """Each scene has its own set of RootSIFT-like word directions; each
    image draws descriptors around its scene's words."""
    desc_sets, scene_of = [], []
    for s in range(n_scenes):
        words = np.abs(rng.normal(size=(words_per_scene, 128)))
        words /= np.linalg.norm(words, axis=1, keepdims=True)
        for _ in range(imgs_per_scene):
            pick = rng.integers(0, words_per_scene, descs_per_img)
            d = words[pick] + rng.normal(scale=noise, size=(descs_per_img, 128))
            d = np.abs(d)
            d /= np.linalg.norm(d, axis=1, keepdims=True)
            desc_sets.append(np.minimum(512.0 * d, 255.0).astype(np.uint8))
            scene_of.append(s)
    return desc_sets, np.array(scene_of)


def test_kmeans_reduces_quantization_error():
    rng = np.random.default_rng(0)
    desc_sets, _ = _make_scene_descs(rng)
    import jax.numpy as jnp

    alld = np.concatenate(desc_sets).astype(np.float32) / 512.0
    N = RET._bucket(len(alld))
    sample = np.zeros((N, 128), np.float32)
    sample[: len(alld)] = alld
    init = alld[rng.choice(len(alld), 16, replace=False)]
    _, err0 = RET._kmeans(sample, jnp.asarray(init), 0)
    _, err10 = RET._kmeans(sample, jnp.asarray(init), 10)
    assert float(err10) < float(err0)
    assert float(err10) >= -1e-4  # squared distance, up to f32 rounding


def test_retrieval_ranks_same_scene_first():
    rng = np.random.default_rng(1)
    desc_sets, scene_of = _make_scene_descs(rng)
    ranks, vlads = RET.build_retrieval(desc_sets, num_words=16, topk=3)
    # VLAD vectors are unit-norm
    norms = np.linalg.norm(vlads, axis=1)
    assert np.allclose(norms, 1.0, atol=1e-4)
    # every image's top-3 neighbors are its own scene (3 same-scene images
    # exist for each query)
    for i, row in enumerate(ranks):
        assert all(scene_of[j] == scene_of[i] for j in row), (
            i, row, scene_of[row])
        assert i not in row  # self masked out


def test_vlad_invariant_to_descriptor_order_and_padding():
    rng = np.random.default_rng(2)
    desc_sets, _ = _make_scene_descs(rng, n_scenes=1, imgs_per_scene=2)
    vocab = RET.train_vocabulary(desc_sets, num_words=8, seed=0)
    d = desc_sets[0]
    v1 = RET.encode_vlad([d], vocab)
    v2 = RET.encode_vlad([d[::-1].copy()], vocab)  # permuted
    assert np.allclose(v1, v2, atol=1e-4)
    # batching with a different-length partner (forces padding) is the same
    v3 = RET.encode_vlad([d, desc_sets[1][:37]], vocab)[0]
    assert np.allclose(v1[0], v3, atol=1e-4)


def test_empty_and_tiny_inputs():
    vocab = RET.train_vocabulary([], num_words=8)
    assert vocab.shape == (8, 128)
    rng = np.random.default_rng(3)
    d = (np.abs(rng.normal(size=(5, 128))) * 40).astype(np.uint8)
    empty = np.zeros((0, 128), np.uint8)
    vocab = RET.train_vocabulary([d], num_words=8, seed=0)
    vl = RET.encode_vlad([empty, d], vocab)
    assert np.all(vl[0] == 0.0)
    ranks = RET.rank_images(vl, topk=5)
    assert ranks.shape == (2, 1)  # topk clamped to F-1


def test_retrieval_text_roundtrip(tmp_path):
    rng = np.random.default_rng(4)
    desc_sets, _ = _make_scene_descs(rng, n_scenes=2, imgs_per_scene=3)
    names = [f"img{i:03d}.png" for i in range(len(desc_sets))]
    ranks, _ = RET.build_retrieval(desc_sets, num_words=8, topk=2)
    path = str(tmp_path / "retrieval.txt")
    RET.write_retrieval_text(path, names, ranks)
    name_to_id = {n: i for i, n in enumerate(names)}
    id2rank = IOF.load_retrieval_rank(path, name_to_id)
    assert id2rank == RET.ranks_to_id2rank(ranks)
