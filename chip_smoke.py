#!/usr/bin/env python
"""On-card smoke test: drive the SfM pipeline once on one GPU.

    python chip_smoke.py              # every one-card phase
    python chip_smoke.py --cards 4    # only the four-card paths
    python chip_smoke.py --phases matcher,arc   # a subset, for debugging

Phases (one process; each prints its own lines and any failure exits
non-zero):

  guard     the default backend must be a GPU; prints the card's name and
            power limit (read by a child that stays off JAX)
  kernels   essential RANSAC -> pose from E -> triangulation -> 2-view BA,
            P3P/EPnP RANSAC and F-verification, each against a float64
            numpy reference on the same seeded data
  matcher   16 pairs x 4,096 and x 8,192 features: fused kernel and XLA
            body against the int64 brute-force reference, both timed
  arc       8-image arc scene through the CLI (run_matching ->
            run_reconstruction): 8/8 registered, ATE < 0.5% of span,
            mean reprojection error < 0.5 px
  corridor  96-image corridor scene at 512x384 through the CLI: 96/96
            registered, ATE < 3% of span; per-stage wall times, and the
            match phase re-timed with each matcher implementation
  ba        BA at 1,024 cams / 160k points (~1.1M observations), default
            and precise solves agree within 1%
  tests     the repository's `gpu`-marked tests, in this process

With --cards 4: distributed BA (pose-only and intrinsics-refining) over
a 4-card mesh against single-card solve_ba, and sharded matching
(run_matching --n_devices 4) against the single-card verified pairs.

The last line of standard output is one JSON object naming the device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import shutil
import tempfile
import time
import traceback
from unittest import mock

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
ONE_CARD_PHASES = ("kernels", "matcher", "arc", "corridor", "ba", "tests")
CARD = ""  # "<name>, <power limit>" as nvidia-smi reports it


def log(msg: str) -> None:
    print(msg, flush=True)


def on_card(msg: str) -> None:
    log(f"{msg}  [{CARD}]")


def card_name_and_power() -> str:
    """nvidia-smi's name and power limit of the first card (a child that
    stays off JAX)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0].strip()


def device_guard(n_cards: int = 1) -> dict:
    """Refuse to run anywhere but on `n_cards` GPUs."""
    import jax

    backend = jax.default_backend()
    if backend != "gpu":
        raise RuntimeError(f"no GPU: JAX's default backend is {backend!r}")
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise RuntimeError(f"device 0 is a {devs[0].platform!r} device")
    if len(devs) < n_cards:
        raise RuntimeError(f"{n_cards} GPUs needed, {len(devs)} visible")
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def _timed(fn, reps: int = 10):
    """(compile-and-first-call seconds, median steady seconds, output),
    every call synced with block_until_ready."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    first = time.perf_counter() - t0
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn())
        times.append(time.perf_counter() - t0)
    return first, float(np.median(times)), out


def _rot_deg(qa, qb) -> float:
    d = abs(float(np.dot(qa / np.linalg.norm(qa), qb / np.linalg.norm(qb))))
    return float(np.degrees(2 * np.arccos(min(1.0, d))))


def _dlt_np(Ps, uvs):
    """float64 DLT triangulation of one point from [V,3,4] and [V,2]."""
    A = np.concatenate([uvs[:, 0:1] * Ps[:, 2] - Ps[:, 0],
                        uvs[:, 1:2] * Ps[:, 2] - Ps[:, 1]])
    h = np.linalg.svd(A)[2][-1]
    return h[:3] / h[3]


# --------------------------------------------------------------- kernels
def phase_kernels() -> None:
    import jax
    import jax.numpy as jnp

    from xrsfm_tpu.feature import matching as fmatch
    from xrsfm_tpu.mapper import kernels as K
    from xrsfm_tpu.ops import epipolar as EP, triangulation as TRI
    from xrsfm_tpu.optim import ba as BA
    from xrsfm_tpu.utils import geometry as G

    prec = str(jax.config.jax_default_matmul_precision or "default")
    log(f"[kernels] process matmul precision: {prec}")
    rng = np.random.default_rng(0)
    N, f = 256, 500.0
    pts = np.stack([rng.uniform(-2, 2, N), rng.uniform(-1.5, 1.5, N),
                    rng.uniform(4, 10, N)], 1)
    th = 0.15
    q2 = np.array([np.cos(th / 2), 0.0, np.sin(th / 2), 0.0])
    t2 = np.array([-1.0, 0.05, 0.02])
    R2 = G.quat_to_rotmat_np(q2)

    def proj(R, t, p):
        Xc = p @ R.T + t
        return Xc[:, :2] / Xc[:, 2:3]

    x1 = proj(np.eye(3), np.zeros(3), pts)
    x2 = proj(R2, t2, pts)
    x1 += rng.normal(scale=0.5 / f, size=x1.shape)
    x2 += rng.normal(scale=0.5 / f, size=x2.shape)
    nout = 40
    out_idx = rng.choice(N, nout, replace=False)
    x2[out_idx] = rng.uniform(-0.5, 0.5, (nout, 2))
    mask = np.ones(N, bool)
    x1f, x2f = x1.astype(np.float32), x2.astype(np.float32)

    # essential RANSAC: E against the float64 GT essential [t]x R
    E, inl, ninl, ok = jax.device_get(K.essential_ransac(
        jax.random.PRNGKey(0), x1f, x2f, mask, (4.0 / f) ** 2))
    assert bool(ok) and int(ninl) > N - nout - 30, (int(ninl), bool(ok))
    tx = np.array([[0, -t2[2], t2[1]], [t2[2], 0, -t2[0]],
                   [-t2[1], t2[0], 0]])
    E_ref = tx @ R2
    E_ref /= np.linalg.norm(E_ref)
    En = np.asarray(E, np.float64) / np.linalg.norm(E)
    dev_e = min(np.abs(En - E_ref).max(), np.abs(En + E_ref).max())
    log(f"[kernels] essential_ransac: {int(ninl)}/{N} inliers, "
        f"max |E - E_ref| {dev_e:.3e} (unit Frobenius norm)")

    # pose from E
    q_est, t_est, _, _ = jax.device_get(
        EP.recover_pose_from_essential(E, x1f, x2f, np.asarray(inl)))
    t_est = np.asarray(t_est, np.float64).ravel()
    ang = _rot_deg(np.asarray(q_est, np.float64), q2)
    tdir = np.degrees(np.arccos(np.clip(abs(np.dot(
        t_est / np.linalg.norm(t_est), t2 / np.linalg.norm(t2))), -1, 1)))
    assert ang < 3.0 and tdir < 3.0, (ang, tdir)
    log(f"[kernels] recover_pose_from_essential: rotation {ang:.3f} deg, "
        f"translation direction {tdir:.3f} deg (gate 3 deg)")

    # triangulation with GT poses against float64 DLT on the same rays
    qs = np.stack([np.array([1.0, 0, 0, 0]), q2])
    ts = np.stack([np.zeros(3), t2])
    uv = np.stack([x1, x2], 1).astype(np.float32)
    inl_np = np.asarray(inl).astype(bool)
    vmask = np.ones((N, 2), bool) & inl_np[:, None]
    xyz = np.asarray(TRI.triangulate_multiview(
        jnp.broadcast_to(jnp.asarray(qs, jnp.float32), (N, 2, 4)),
        jnp.broadcast_to(jnp.asarray(ts, jnp.float32), (N, 2, 3)),
        jnp.asarray(uv), jnp.asarray(vmask)), np.float64)
    sel = inl_np & ~np.isin(np.arange(N), out_idx)
    Ps = np.stack([np.hstack([np.eye(3), np.zeros((3, 1))]),
                   np.hstack([R2, t2[:, None]])])
    ref = np.stack([_dlt_np(Ps, uv[i].astype(np.float64)) for i in
                    np.nonzero(sel)[0]])
    err = np.linalg.norm(xyz[sel] - pts[sel], axis=1)
    dev_t = np.abs(xyz[sel] - ref).max()
    assert np.median(err) < 0.08, np.median(err)
    log(f"[kernels] triangulate_multiview: median error {np.median(err):.4f} "
        f"m (gate 0.08), max |xyz - float64 DLT| {dev_t:.3e} m")

    # 2-view BA from perturbed points and second camera
    pid = np.nonzero(sel)[0]
    P = len(pid)
    obs_cam = np.concatenate([np.zeros(P, np.int32), np.ones(P, np.int32)])
    obs_pt = np.concatenate([np.arange(P, dtype=np.int32)] * 2)
    intr = np.zeros((2, 8))
    intr[:, 0] = intr[:, 1] = f
    uv_px = np.concatenate([x1[pid] * f, x2[pid] * f]).astype(np.float32)
    pts0 = xyz[pid] + rng.normal(scale=0.05, size=(P, 3))
    prob = BA.BAProblem(
        cam_q=jnp.asarray(qs, jnp.float32),
        cam_t=jnp.asarray(ts + [[0, 0, 0], [0.03, -0.02, 0.0]], jnp.float32),
        cam_intri=jnp.asarray(intr, jnp.float32),
        points=jnp.asarray(pts0, jnp.float32),
        obs_uv=jnp.asarray(uv_px), obs_cam=jnp.asarray(obs_cam),
        obs_pt=jnp.asarray(obs_pt), obs_w=jnp.ones(2 * P, jnp.float32),
        fix_cam=jnp.asarray([True, False]),
        fix_trans=jnp.asarray([True, True]), fix_pt=jnp.zeros(P, bool))
    prob2, ell = BA.pack_camera_major(prob)
    opts = BA.BAOptions(max_iters=10)
    solved, info = BA.solve_ba(prob2, opts, ell)
    ic, fc = float(info["initial_cost"]), float(info["final_cost"])
    # float64 Huber cost of the returned state
    sq, st = np.asarray(solved.cam_q, np.float64), np.asarray(solved.cam_t,
                                                              np.float64)
    oc, op = np.asarray(solved.obs_cam), np.asarray(solved.obs_pt)
    w = np.asarray(solved.obs_w, np.float64)
    Rs = np.stack([G.quat_to_rotmat_np(q) for q in sq])
    pc = np.einsum("nij,nj->ni", Rs[oc], np.asarray(solved.points,
                                                     np.float64)[op]) + st[oc]
    r = pc[:, :2] / pc[:, 2:3] * f - np.asarray(solved.obs_uv, np.float64)
    rn = np.linalg.norm(r, axis=1)
    hub = opts.huber_px
    c64 = float(np.sum(w * np.where(rn <= hub, rn ** 2,
                                    hub * (2 * rn - hub))))
    assert fc < 0.5 * ic, (ic, fc)
    log(f"[kernels] solve_ba 2-view: cost {ic:.4e} -> {fc:.4e} (gate < 0.5x),"
        f" float64 cost of the result {c64:.4e} "
        f"(rel dev {abs(c64 - fc) / max(c64, 1e-12):.2e})")

    # P3P/EPnP RANSAC against the float64 GT pose
    qp = np.array([0.96, 0.1, -0.2, 0.15])
    qp /= np.linalg.norm(qp)
    tp = np.array([0.3, -0.2, 5.0])
    Rp = G.quat_to_rotmat_np(qp)
    n = 128
    X = rng.uniform(-2, 2, (n, 3))
    uvp = proj(Rp, tp, X) + rng.normal(scale=0.5 / f, size=(n, 2))
    bad = rng.uniform(size=n) < 0.25
    uvp[bad] = rng.uniform(-0.6, 0.6, (int(bad.sum()), 2))
    q3, t3, _, ninl3, ok3 = jax.device_get(K.pnp_ransac(
        jax.random.PRNGKey(1), uvp.astype(np.float32), X.astype(np.float32),
        np.ones(n, bool), (6.0 / f) ** 2))
    rp = _rot_deg(np.asarray(q3, np.float64), qp)
    dtp = float(np.abs(np.asarray(t3, np.float64) - tp).max())
    assert bool(ok3) and rp < 2.0 and dtp < 0.15, (rp, dtp)
    log(f"[kernels] pnp_ransac: {int(ninl3)}/{n} inliers, rotation {rp:.3f} "
        f"deg, max |t - t_gt| {dtp:.4f} (gates 2 deg, 0.15)")

    # F-verification (the matching stage's batched LO-RANSAC), 16 pairs
    B, M = 16, 512
    Kmat = np.array([[f, 0, 256.0], [0, f, 192.0], [0, 0, 1]])
    x1b = np.zeros((B, M, 2), np.float32)
    x2b = np.zeros((B, M, 2), np.float32)
    gt_in = np.zeros((B, M), bool)
    Fs = []
    for b in range(B):
        Pw = np.stack([rng.uniform(-3, 3, M), rng.uniform(-2, 2, M),
                       rng.uniform(5, 12, M)], 1)
        a = rng.uniform(-0.2, 0.2, 3)
        Rb = G.quat_to_rotmat_np(np.r_[1.0, a / 2] / np.linalg.norm(
            np.r_[1.0, a / 2]))
        tb = np.r_[rng.uniform(-1, 1), rng.uniform(-0.2, 0.2), 0.1]
        u1 = (Pw / Pw[:, 2:3]) @ Kmat.T
        pc2 = Pw @ Rb.T + tb
        u2 = (pc2 / pc2[:, 2:3]) @ Kmat.T
        u1 = u1[:, :2] + rng.normal(scale=0.5, size=(M, 2))
        u2 = u2[:, :2] + rng.normal(scale=0.5, size=(M, 2))
        o = rng.uniform(size=M) < 0.3
        u2[o] = rng.uniform([0, 0], [512, 384], (int(o.sum()), 2))
        x1b[b], x2b[b], gt_in[b] = u1, u2, ~o
        txb = np.array([[0, -tb[2], tb[1]], [tb[2], 0, -tb[0]],
                        [-tb[1], tb[0], 0]])
        Fs.append(np.linalg.inv(Kmat).T @ txb @ Rb @ np.linalg.inv(Kmat))
    keys = np.stack([np.asarray(jax.random.PRNGKey(b)) for b in range(B)])
    Fb, inlb, _, okb = jax.device_get(fmatch._fundamental_ransac_batch(
        keys, x1b, x2b, np.ones((B, M), bool), np.float32(16.0)))
    prec_r, rec_r, dev_f = [], [], 0.0
    for b in range(B):
        got = np.asarray(inlb[b], bool)
        prec_r.append((got & gt_in[b]).sum() / max(got.sum(), 1))
        rec_r.append((got & gt_in[b]).sum() / gt_in[b].sum())
        # float64 Sampson error of the returned F on its own inliers
        Fd = np.asarray(Fb[b], np.float64)
        h1 = np.c_[x1b[b], np.ones(M)].astype(np.float64)
        h2 = np.c_[x2b[b], np.ones(M)].astype(np.float64)
        Fx1, Ftx2 = h1 @ Fd.T, h2 @ Fd
        num = np.sum(h2 * Fx1, axis=1) ** 2
        den = Fx1[:, 0] ** 2 + Fx1[:, 1] ** 2 + Ftx2[:, 0] ** 2 + \
            Ftx2[:, 1] ** 2
        dev_f = max(dev_f, float((num / den)[got].max()))
    assert bool(np.all(okb)) and min(prec_r) > 0.95 and min(rec_r) > 0.9, (
        min(prec_r), min(rec_r))
    log(f"[kernels] F-verification x{B}: inlier precision >= "
        f"{min(prec_r):.3f}, recall >= {min(rec_r):.3f}; max float64 "
        f"Sampson error of accepted inliers {dev_f:.3f} px^2 (threshold 16)")


# --------------------------------------------------------------- matcher
def _matcher_inputs(rng, B: int, K: int):
    """B pairs of K-slot uint8 descriptor sets with masked padding, 2/3
    true correspondences (noisy), and exact duplicates (ties)."""
    def rootsift(n):
        d = np.abs(rng.normal(size=(n, 128)))
        d /= d.sum(-1, keepdims=True)
        return np.sqrt(d)

    def quant(v):
        return np.minimum(512.0 * v, 255.0).astype(np.uint8)

    d1 = np.zeros((B, K, 128), np.uint8)
    d2 = np.zeros((B, K, 128), np.uint8)
    m1 = np.zeros((B, K), bool)
    m2 = np.zeros((B, K), bool)
    for b in range(B):
        n1, n2 = K - int(rng.integers(0, K // 8)), K - int(rng.integers(0, K // 8))
        base = rootsift(n1)
        other = rootsift(n2)
        k = 2 * min(n1, n2) // 3
        noisy = np.abs(base[:k] + rng.normal(scale=0.04, size=(k, 128)))
        other[:k] = noisy / np.linalg.norm(noisy, axis=1, keepdims=True)
        perm = rng.permutation(n2)
        d1[b, :n1] = quant(base)
        d2[b, :n2] = quant(other)[perm]
        dup = rng.choice(n2, 16, replace=False)
        d2[b, dup[8:]] = d2[b, dup[:8]]  # exact ties
        m1[b, :n1], m2[b, :n2] = True, True
    return d1, d2, m1, m2


def phase_matcher() -> None:
    import jax.numpy as jnp

    from xrsfm_tpu.ops import matching as dm

    rng = np.random.default_rng(1)
    B = 16
    for K in (4096, 8192):
        d1, d2, m1, m2 = _matcher_inputs(rng, B, K)
        args = [jnp.asarray(a) for a in (d1, d2, m1, m2)]
        mm = min(K, 4096)
        ck, tk, (mk, ckn, _) = _timed(
            lambda: dm._match_batch_pallas(*args, 0.7, 0.8, mm))
        cx, tx, (mx, cxn, _) = _timed(
            lambda: dm._match_batch_xla(*args, 0.7, 0.8, mm))
        stats = dm._stats_pallas(*args)
        sb, ss, sj, sc = (np.asarray(s) for s in stats)
        mk, ckn, mx, cxn = (np.asarray(a) for a in (mk, ckn, mx, cxn))
        bad_stats = bad_kernel = xla_rows = n_ref = 0
        q2 = dm._QUANT * dm._QUANT
        for b in range(len(d1)):
            rb, rs, rj, rc = dm.match_stats_np(d1[b], d2[b], m1[b], m2[b])
            v1, v2 = m1[b], m2[b]
            bad_stats += int(np.sum(
                (sb[b] * q2 != rb)[v1] | (sj[b] != rj)[v1]
                | (ss[b] * q2 != rs)[v1 & (rs > -dm._BIG / 2)]))
            bad_stats += int(np.sum((sc[b] != rc)[v2]))
            ref = {tuple(r) for r in dm.match_descriptors_np(
                d1[b], d2[b], m1[b], m2[b])}
            n_ref += len(ref)
            got = {tuple(r) for r in mk[b][: int(ckn[b])]}
            gx = {tuple(r) for r in mx[b][: int(cxn[b])]}
            bad_kernel += len(ref ^ got)
            xla_rows += len({i for i, _ in ref ^ gx})
        on_card(f"[matcher] {B} pairs x {K}: kernel {1e3 * tk:.3f} ms/chunk "
                f"(compile+first {ck:.2f} s), XLA body {1e3 * tx:.3f} "
                f"ms/chunk (compile+first {cx:.2f} s)")
        log(f"[matcher] {B} pairs x {K}: {n_ref} reference matches; kernel "
            f"statistics differing from int64: {bad_stats}, kernel matches "
            f"differing: {bad_kernel}; XLA body rows differing: {xla_rows}")
        assert bad_stats == 0 and bad_kernel == 0, (bad_stats, bad_kernel)


# -------------------------------------------------------------- pipeline
def _evaluate(ws: str) -> dict:
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    import evaluate_model

    return evaluate_model.evaluate(os.path.join(ws, "model"),
                                   os.path.join(ws, "gt_poses.txt"))


def _run_pipeline(ws: str, scene: str, n_cams: int, extra=()) -> dict:
    """Render a scene and run run_matching -> run_reconstruction through
    the CLI.  Returns evaluate_model's metrics plus stage times."""
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    import synth_dataset

    from xrsfm_tpu import cli

    t0 = time.perf_counter()
    synth_dataset.main(ws, n_cams=n_cams, scene=scene)
    t_data = time.perf_counter() - t0
    bins = os.path.join(ws, "bins")
    stats = {}
    t0 = time.perf_counter()
    cli.main(["run_matching", os.path.join(ws, "images"),
              os.path.join(ws, "retrieval.txt"), "sequential", bins,
              *extra], stats=stats)
    t_match = time.perf_counter() - t0
    t0 = time.perf_counter()
    cli.main(["run_reconstruction", bins, os.path.join(ws, "camera.txt"),
              os.path.join(ws, "model")])
    t_rec = time.perf_counter() - t0
    ev = _evaluate(ws)
    ev.update(data_s=t_data, matching_s=t_match, reconstruct_s=t_rec,
              extract_s=stats.get("extract_s", float("nan")),
              match_s=stats.get("match_s", float("nan")))
    return ev


def phase_arc(tmp: str) -> None:
    ev = _run_pipeline(os.path.join(tmp, "arc"), "arc", 8)
    log(f"[arc] registered {ev['registered']}/{ev['frames']}, ATE "
        f"{ev['ate_pct']:.3f}% of span, mean reprojection error "
        f"{ev['reproj_mean_px']:.3f} px")
    assert ev["registered"] == 8 and ev["ate_pct"] < 0.5 \
        and ev["reproj_mean_px"] < 0.5, ev


def phase_corridor(tmp: str) -> None:
    from xrsfm_tpu.feature import matching as fmatch
    from xrsfm_tpu.ops import matching as dm
    from xrsfm_tpu.utils import io_features as IOF

    ws = os.path.join(tmp, "corridor")
    n = 96
    ev = _run_pipeline(ws, "corridor", n)
    log(f"[corridor] registered {ev['registered']}/{ev['frames']}, ATE "
        f"{ev['ate_pct']:.3f}% of span, mean reprojection error "
        f"{ev['reproj_mean_px']:.3f} px (scene rendering "
        f"{ev['data_s']:.1f} s, not counted)")
    total = ev["matching_s"] + ev["reconstruct_s"]
    on_card(f"[corridor] {n} images 512x384, fresh process: extract "
            f"{ev['extract_s']:.2f} s, match+verify {ev['match_s']:.2f} s, "
            f"reconstruct {ev['reconstruct_s']:.2f} s, total {total:.2f} s, "
            f"{n / total:.3f} frames/s (compiles included)")
    assert ev["registered"] == n and ev["ate_pct"] < 3.0, ev

    # the match phase again, warm, with each matcher implementation
    feats = IOF.read_features(os.path.join(ws, "bins", "ftr.bin"))
    pairs = fmatch.sequential_pairs(n, fmatch.MatchingOptions())
    results = {}
    for name, impl in (("kernel", dm._match_batch_pallas),
                       ("xla", dm._match_batch_xla)):
        with mock.patch.object(dm, "_matcher_for", lambda _b, f=impl: f):
            fmatch._match_chunk_resident.clear_cache()
            fmatch.match_and_verify_pairs(feats, pairs[:16], verbose=False)
            t0 = time.perf_counter()
            out = fmatch.match_and_verify_pairs(feats, pairs, verbose=False)
            results[name] = (time.perf_counter() - t0, out)
        fmatch._match_chunk_resident.clear_cache()
    (tk, ok_), (tx, ox_) = results["kernel"], results["xla"]
    on_card(f"[corridor] warm match phase ({len(pairs)} pairs): kernel "
            f"{tk:.3f} s ({len(ok_)} verified), XLA body {tx:.3f} s "
            f"({len(ox_)} verified)")


# -------------------------------------------------------------------- BA
def _bench():
    sys.path.insert(0, REPO)
    import bench

    return bench


def phase_ba() -> None:
    import jax

    from xrsfm_tpu.optim import ba as BA

    prob, ell, n_obs = _bench().make_ba_problem(n_cams=1024, n_pts=160000)
    costs = {}
    for precise in (False, True):
        opts = BA.BAOptions(precise=precise)
        t0 = time.perf_counter()
        _, info = jax.block_until_ready(BA.solve_ba(prob, opts, ell))
        first = time.perf_counter() - t0
        t0 = time.perf_counter()
        _, info = jax.block_until_ready(BA.solve_ba(prob, opts, ell))
        wall = time.perf_counter() - t0
        ic, fc = float(info["initial_cost"]), float(info["final_cost"])
        costs[precise] = fc
        on_card(f"[ba] 1024 cams / 160000 pts / {n_obs} obs, precise="
                f"{precise}: cost {ic:.2f} -> {fc:.2f} in "
                f"{int(info['iters'])} iters, {wall:.3f} s "
                f"(compile+first {first:.2f} s)")
        assert np.isfinite(fc) and fc < ic, (ic, fc)
    rel = abs(costs[False] - costs[True]) / costs[True]
    peak = (jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use")
    log(f"[ba] default vs precise final cost: {100 * rel:.3f}% apart "
        f"(gate 1%); peak_bytes_in_use {peak}")
    assert rel < 0.01, rel


# ----------------------------------------------------------------- tests
def phase_tests() -> None:
    import pytest

    os.environ["XRSFM_CARD_TESTS"] = "1"
    rc = pytest.main([os.path.join(REPO, "tests"), "-q", "-m", "gpu",
                      "-p", "no:cacheprovider", "-p", "no:randomly"])
    assert rc == 0, f"gpu-marked tests failed (pytest exit {rc})"


# ------------------------------------------------------------ four cards
def phase_four_cards(tmp: str) -> None:
    import jax
    from jax.sharding import Mesh

    sys.path.insert(0, REPO)
    import __graft_entry__ as GE

    mesh = Mesh(np.array(jax.devices()[:4]), axis_names=("obs",))
    prob, _, n_obs = _bench().make_ba_problem(n_cams=1024, n_pts=160000)
    GE.distributed_parity(
        mesh, prob, log=lambda s: on_card(f"[4 cards] {s} ({n_obs} obs)"))

    from xrsfm_tpu.utils import io_features as IOF

    ws = os.path.join(tmp, "arc4")
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    import synth_dataset

    from xrsfm_tpu import cli

    synth_dataset.main(ws, n_cams=8, scene="arc")
    pairs = {}
    for n_dev in (1, 4):
        out = os.path.join(ws, f"bins{n_dev}")
        t0 = time.perf_counter()
        cli.main(["run_matching", os.path.join(ws, "images"),
                  os.path.join(ws, "retrieval.txt"), "sequential", out,
                  "--n_devices", str(n_dev)])
        wall = time.perf_counter() - t0
        fps = IOF.read_frame_pairs(os.path.join(out, "fp.bin"))
        pairs[n_dev] = {(p.id1, p.id2): (p.matches.tobytes(),
                                         p.inlier_mask.tobytes())
                        for p in fps}
        on_card(f"[4 cards] run_matching --n_devices {n_dev}: "
                f"{len(fps)} verified pairs in {wall:.2f} s")
    same = pairs[1] == pairs[4]
    log(f"[4 cards] sharded verified pairs identical to single-card: {same}")
    assert same


def main(argv=None) -> int:
    global CARD
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cards", type=int, default=1, choices=(1, 4))
    ap.add_argument("--phases", default=",".join(ONE_CARD_PHASES),
                    help="comma-separated one-card phases to run")
    a = ap.parse_args(argv)
    phases = a.phases.split(",")
    unknown = set(phases) - set(ONE_CARD_PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")

    t_start = time.perf_counter()
    device = device_guard(a.cards)
    CARD = card_name_and_power()
    log(f"[guard] {device['count']} x {device['kind']} "
        f"({device['platform']})")
    log(CARD)

    import xrsfm_tpu

    xrsfm_tpu.enable_compilation_cache()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    if a.cards == 4:
        todo = [("four_cards", lambda: phase_four_cards(tmp))]
    else:
        table = {
            "kernels": phase_kernels, "matcher": phase_matcher,
            "arc": lambda: phase_arc(tmp),
            "corridor": lambda: phase_corridor(tmp),
            "ba": phase_ba, "tests": phase_tests,
        }
        todo = [(p, table[p]) for p in ONE_CARD_PHASES if p in phases]
    failed = []
    for name, fn in todo:
        t0 = time.perf_counter()
        log(f"== {name}")
        try:
            fn()
        except Exception:  # report, run the other phases, fail at the end
            traceback.print_exc()
            failed.append(name)
            log(f"== {name} FAILED after {time.perf_counter() - t0:.1f} s")
            continue
        log(f"== {name} ok in {time.perf_counter() - t0:.1f} s")
    shutil.rmtree(tmp, ignore_errors=True)
    if failed:
        log(f"failed phases: {', '.join(failed)}")
        return 1
    log(f"all phases ok in {time.perf_counter() - t_start:.1f} s")
    log(CARD)
    print(json.dumps({"ok": True, "device": {
        "platform": device["platform"], "kind": device["kind"],
        "count": a.cards if a.cards == 4 else 1}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
