import numpy as np
import jax.numpy as jnp
import pytest

from xrsfm_tpu.ops import matching as dmatch
from xrsfm_tpu.feature import matching as fmatch
from xrsfm_tpu.utils.io_features import FrameFeatures

from synthetic import make_scene


def quantize_desc(v):
    """float L1-root-normalized descriptor -> uint8, 512*v truncation
    (reference: FeatureDescriptorsToUnsignedByte, sift_extractor.h:22-34)."""
    return np.minimum(512.0 * v, 255.0).astype(np.uint8)


def random_descriptors(rng, n):
    d = np.abs(rng.normal(size=(n, 128))).astype(np.float32)
    d /= d.sum(-1, keepdims=True)  # L1
    d = np.sqrt(d)  # root -> L2 normalized
    return d


def test_match_descriptors_identity():
    rng = np.random.default_rng(0)
    d = random_descriptors(rng, 100)
    du = quantize_desc(d)
    perm = rng.permutation(100)
    m, dists = dmatch.match_pair_host(du, du[perm])
    # every feature should match its permuted copy
    assert len(m) == 100
    assert (perm[m[:, 0]] == perm[perm[m[:, 1]]]).all() or (
        m[:, 1] == np.argsort(perm)[m[:, 0]]
    ).all()


def test_match_descriptors_rejects_ambiguous():
    rng = np.random.default_rng(1)
    d = random_descriptors(rng, 64)
    du = quantize_desc(d)
    # second set: duplicate each descriptor twice -> ratio test must reject
    d2 = np.repeat(du, 2, axis=0)
    m, _ = dmatch.match_pair_host(du, d2)
    assert len(m) < 5  # nearly everything ambiguous


def test_match_descriptors_respects_masks():
    rng = np.random.default_rng(2)
    d1 = quantize_desc(random_descriptors(rng, 32))
    m, _ = dmatch.match_pair_host(d1, d1)
    assert len(m) == 32
    assert (m[:, 0] == m[:, 1]).all()


def _features_from_scene(s, noise=0.0, seed=0):
    """Build FrameFeatures with descriptors shared per 3D point."""
    rng = np.random.default_rng(seed)
    n_cams, n_pts = s["uv"].shape[:2]
    base = random_descriptors(rng, n_pts)
    feats = []
    perms = []
    for i in range(n_cams):
        uv_px = s["uv"][i] * 500.0 + np.array([320, 240], np.float32)
        perm = rng.permutation(n_pts)
        d = base[perm] + rng.normal(scale=noise, size=(n_pts, 128))
        d = np.abs(d)
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        kp = np.zeros((n_pts, 4), np.float32)
        kp[:, :2] = uv_px[perm]
        feats.append(
            FrameFeatures(
                name=f"im{i}.png",
                keypoints=kp,
                descriptors=quantize_desc(d),
            )
        )
        perms.append(perm)
    return feats, perms


def test_match_and_verify_pipeline():
    s = make_scene(n_cams=3, n_pts=120, seed=5)
    feats, perms = _features_from_scene(s, noise=0.01)
    pairs = fmatch.sequential_pairs(3, fmatch.MatchingOptions(seq_window=3))
    out = fmatch.match_and_verify_pairs(feats, pairs, verbose=False)
    assert len(out) >= 2
    for p in out:
        # verified pairs should have many inliers (clean synthetic data)
        assert p.inlier_num > 60
        # inlier matches must be geometrically consistent with GT
        # correspondence: feature k in frame i is 3D point perms[i][k]
        pt1 = perms[p.id1][p.matches[p.inlier_mask][:, 0]]
        pt2 = perms[p.id2][p.matches[p.inlier_mask][:, 1]]
        frac_correct = np.mean(pt1 == pt2)
        assert frac_correct > 0.95, frac_correct


def _pair_with_ties(rng, n, m, n_valid, m_valid):
    """One descriptor pair: 2/3 noisy true correspondences, exact
    duplicates in d2 (ties), masked padding rows."""
    base = random_descriptors(rng, n)
    other = random_descriptors(rng, m)
    k = 2 * min(n_valid, m_valid) // 3
    noisy = np.abs(base[:k] + rng.normal(scale=0.03, size=(k, 128)))
    other[:k] = noisy / np.linalg.norm(noisy, axis=1, keepdims=True)
    d1, d2 = quantize_desc(base), quantize_desc(other)
    d2[k: k + 4] = d2[:4]  # ties: the lowest index must win
    m1 = np.arange(n) < n_valid
    m2 = np.arange(m) < m_valid
    return d1, d2, m1, m2


def _match_set(matches, count):
    return {tuple(r) for r in np.asarray(matches)[: int(count)]}


def test_fused_pallas_matcher_matches_xla_path():
    """The fused kernel (interpret mode on the CPU) agrees exactly with
    the int64 reference: the same raw statistics and the same accepted
    set.  (It no longer compares with the XLA body, which keeps the
    similarity in bf16 and may differ at bf16 ties.)"""
    rng = np.random.default_rng(11)
    d1, d2, m1, m2 = _pair_with_ties(rng, 256, 256, 249, 253)
    stats = dmatch._stats_pallas(
        jnp.asarray(d1)[None], jnp.asarray(d2)[None],
        jnp.asarray(m1)[None], jnp.asarray(m2)[None], interpret=True,
    )
    cb, cs, bj, ca = (np.asarray(a[0]) for a in stats)
    rb, rs, rj, rc = dmatch.match_stats_np(d1, d2, m1, m2)
    q2 = dmatch._QUANT ** 2
    np.testing.assert_array_equal((cb * q2)[m1], rb[m1])
    np.testing.assert_array_equal((cs * q2)[m1], rs[m1])
    np.testing.assert_array_equal(bj[m1], rj[m1])
    np.testing.assert_array_equal(ca[m2], rc[m2])
    mf, cf, _ = dmatch._match_batch_pallas(
        d1[None], d2[None], m1[None], m2[None], 0.7, 0.8, 256,
        interpret=True,
    )
    ref = {tuple(r) for r in dmatch.match_descriptors_np(d1, d2, m1, m2)}
    assert len(ref) > 100
    assert _match_set(mf[0], cf[0]) == ref


@pytest.mark.parametrize("n,m", [(256, 256), (384, 640), (200, 130)])
def test_matcher_kernel_matches_int64_reference(n, m):
    """Padding to the tile inside the wrapper: any (N, M) gives the
    reference's match set, with masks and ties, for every pair of a
    batch."""
    rng = np.random.default_rng(n + m)
    pairs = [_pair_with_ties(rng, n, m, n - 5 * b, m - 3 * b)
             for b in range(2)]
    d1, d2, m1, m2 = (np.stack(a) for a in zip(*pairs))
    mf, cf, df = dmatch._match_batch_pallas(
        d1, d2, m1, m2, 0.7, 0.8, min(n, 256), interpret=True
    )
    for b in range(2):
        ref = dmatch.match_descriptors_np(d1[b], d2[b], m1[b], m2[b])
        assert len(ref) > 0.3 * min(n, m)
        assert _match_set(mf[b], cf[b]) == {tuple(r) for r in ref}
        # distances are the arccos of the exact cosine
        sim = d1[b].astype(np.int64) @ d2[b].astype(np.int64).T
        rows = np.asarray(mf[b])[: int(cf[b])]
        exp = np.arccos(np.clip(
            sim[rows[:, 0], rows[:, 1]] / dmatch._QUANT ** 2, -1, 1))
        np.testing.assert_allclose(np.asarray(df[b])[: len(rows)], exp,
                                   atol=1e-5)


def test_matcher_choice_by_backend():
    """One implementation per platform; an unknown backend is an error,
    not a fallback."""
    assert dmatch._matcher_for("gpu") is dmatch._match_batch_pallas
    assert dmatch._matcher_for("cpu") is dmatch._match_batch_xla
    with pytest.raises(NotImplementedError, match="rocm"):
        dmatch._matcher_for("rocm")


def test_xla_matcher_agrees_with_reference_off_ties():
    """The XLA body (the CPU path) keeps the similarity in bf16; on a
    pair without near-ties it gives the reference's set."""
    rng = np.random.default_rng(5)
    d1 = quantize_desc(random_descriptors(rng, 128))
    d2 = d1[rng.permutation(128)]
    m = np.ones(128, bool)
    mx, cx, _ = dmatch._match_batch_xla(
        d1[None], d2[None], m[None], m[None], 0.7, 0.8, 128
    )
    ref = {tuple(r) for r in dmatch.match_descriptors_np(d1, d2, m, m)}
    assert len(ref) == 128
    assert _match_set(mx[0], cx[0]) == ref


@pytest.mark.gpu
def test_matcher_kernel_on_gpu(gpu):
    """The kernel as compiled for the card equals the int64 reference at
    a production width (4,096 slots, masked padding, ties)."""
    rng = np.random.default_rng(3)
    pairs = [_pair_with_ties(rng, 4096, 4096, 4096 - 97 * b, 4096 - 31 * b)
             for b in range(2)]
    d1, d2, m1, m2 = (np.stack(a) for a in zip(*pairs))
    mf, cf, _ = dmatch.match_descriptors_batch(d1, d2, m1, m2)
    for b in range(2):
        ref = dmatch.match_descriptors_np(d1[b], d2[b], m1[b], m2[b])
        assert _match_set(mf[b], cf[b]) == {tuple(r) for r in ref}


def _hamming_brute(d1, d2):
    """Reference popcount distance matrix (numpy bit ops)."""
    b1 = np.unpackbits(d1, axis=1).astype(np.int32)  # [N,256]
    b2 = np.unpackbits(d2, axis=1).astype(np.int32)
    return (b1[:, None, :] != b2[None, :, :]).sum(-1)


def test_orb_hamming_matcher_matches_reference_semantics():
    """match_descriptors_hamming reproduces OrbMatch's accept rule
    (reference: src/feature/feature_processing.cc:171-219 — best <= 80,
    best <= 0.9 * second, mutual best)."""
    rng = np.random.default_rng(7)
    n = 120
    base = rng.integers(0, 256, size=(n, 32), dtype=np.uint8)
    # corrupt a few bits to create realistic near-matches
    perm = rng.permutation(n)
    d2 = base[perm].copy()
    flips = rng.integers(0, 2, size=d2.shape, dtype=np.uint8) & rng.integers(
        0, 2, size=d2.shape, dtype=np.uint8
    )
    d2 ^= flips & rng.integers(0, 4, size=d2.shape, dtype=np.uint8)

    got, dists = dmatch.match_pair_host_hamming(base, d2)

    # brute-force reference of the same accept rule
    D = _hamming_brute(base, d2)
    exp = []
    bj = D.argmin(1)
    bi = D.argmin(0)
    for i in range(n):
        j = bj[i]
        dsort = np.sort(D[i])
        if (
            D[i, j] <= 80
            and D[i, j] <= 0.9 * dsort[1]
            and bi[j] == i
        ):
            exp.append((i, j))
    exp = np.array(exp)
    got_set = {tuple(m) for m in got}
    exp_set = {tuple(m) for m in exp}
    assert got_set == exp_set, (len(got_set), len(exp_set))
    # distances returned in bits, exact
    Dmap = {tuple(m): D[m[0], m[1]] for m in exp}
    for m, dd in zip(got, dists):
        assert Dmap[tuple(m)] == int(round(float(dd)))
