"""Benchmark driver: prints ONE JSON line, naming the device it ran on.

Headline: Schur-LM bundle-adjustment iterations/s on a KITTI-scale
synthetic problem (200 cameras, 20k points, ~140k observations) — the
dominant cost of the reference's reconstruction stage (SURVEY.md §3.2:
LBA/KGBA Ceres solves dominate; reference runs Ceres SPARSE_SCHUR with 8
CPU threads, src/optimization/ba_solver.cc:70-77).  A second size point
(~1k cameras / ~1M observations) stresses the Schur design at scale.

Also reports secondary metrics inside the JSON line: descriptor-matching
pair throughput (the matching stage's hot op), SIFT images/s, and the BA
problems' observation counts / final costs (so the headline number is
auditable — faster iterations that no longer converge would show up
here).  Every timing ends in jax.block_until_ready.  Refuses to run
without a GPU.
"""

import json
import time

import numpy as np


def make_ba_problem(n_cams=200, n_pts=20000, obs_per_pt=7, seed=0,
                    cam_width=128, pt_width=32):
    """Synthetic KITTI-scale BA problem; returns (packed problem, ell,
    n_obs).  Shared by bench_ba and scripts/profile_ba.py."""
    import jax.numpy as jnp

    from xrsfm_tpu.optim import ba as ba_mod
    from xrsfm_tpu.optim.ba import BAProblem
    from xrsfm_tpu.utils import camera as C

    rng = np.random.default_rng(seed)
    f, cx, cy = 718.0, 607.0, 185.0  # KITTI-ish intrinsics
    # forward-motion trajectory (cameras at identity rotation, Tcw t = -c)
    centers = np.cumsum(
        rng.normal(scale=[0.15, 0.02, 0.05], size=(n_cams, 3)), axis=0
    )
    centers[:, 2] += np.arange(n_cams) * 1.0
    qs = np.zeros((n_cams, 4))
    qs[:, 0] = 1.0
    ts = -centers
    # points sampled inside the anchor camera's frustum (realistic
    # conditioning: bounded FOV, positive depth)
    anchor = rng.integers(0, n_cams, n_pts)
    uv_n = rng.uniform(-0.4, 0.4, size=(n_pts, 2))
    depth = rng.uniform(5.0, 40.0, size=(n_pts, 1))
    xyz = centers[anchor] + depth * np.concatenate(
        [uv_n, np.ones((n_pts, 1))], axis=1
    )
    # observations: nearby cameras that actually see the point
    cam_list, pt_list = [], []
    for k in range(obs_per_pt):
        cams = np.clip(anchor - obs_per_pt // 2 + k, 0, n_cams - 1)
        cam_list.append(cams)
        pt_list.append(np.arange(n_pts))
    obs_cam = np.concatenate(cam_list).astype(np.int32)
    obs_pt = np.concatenate(pt_list).astype(np.int32)
    pc = xyz[obs_pt] - centers[obs_cam]
    proj = pc[:, :2] / np.maximum(pc[:, 2:3], 1e-6)
    good = (pc[:, 2] > 1.0) & (np.abs(proj) < 0.6).all(axis=1)
    obs_cam, obs_pt, pc = obs_cam[good], obs_pt[good], pc[good]
    uv = pc[:, :2] / pc[:, 2:3] * f + np.array([cx, cy])
    uv += rng.normal(scale=0.5, size=uv.shape)

    intri = np.tile(C.canonicalize_params(C.PINHOLE, [f, f, cx, cy]), (n_cams, 1))
    fix_cam = np.zeros(n_cams, bool)
    fix_cam[0] = True
    fix_trans = np.zeros(n_cams, bool)
    fix_trans[1] = True
    prob = BAProblem(
        cam_q=jnp.asarray(qs, jnp.float32),
        cam_t=jnp.asarray(ts, jnp.float32),
        cam_intri=jnp.asarray(intri, jnp.float32),
        points=jnp.asarray(xyz + rng.normal(scale=0.05, size=xyz.shape), jnp.float32),
        obs_uv=jnp.asarray(uv, jnp.float32),
        obs_cam=jnp.asarray(obs_cam),
        obs_pt=jnp.asarray(obs_pt),
        obs_w=jnp.ones(len(obs_cam), jnp.float32),
        fix_cam=jnp.asarray(fix_cam),
        fix_trans=jnp.asarray(fix_trans),
        fix_pt=jnp.zeros(n_pts, bool),
    )

    # production path: camera-major packed table (camera-side ELL rows are
    # contiguous reshapes; only the point-side transpose-gather remains)
    prob, ell = ba_mod.pack_camera_major(
        prob, cam_width=cam_width, pt_width=pt_width
    )
    return prob, ell, len(obs_cam)


def bench_ba(n_cams=200, n_pts=20000, obs_per_pt=7, iters=30, seed=0,
             cg_iters=2, cam_width=128, reps=3):
    """Best-of-reps wall time of `iters` fixed-work LM steps in one jit.
    Returns (iters/s, n_obs, final cost)."""
    import functools

    import jax
    import jax.numpy as jnp

    from xrsfm_tpu.optim import ba as ba_mod

    prob, ell, n_obs = make_ba_problem(n_cams, n_pts, obs_per_pt, seed,
                                       cam_width=cam_width)

    @jax.jit
    def lm_step(p, lam):
        """Full accept/reject LM step (fixed work per call), row-native
        layout (camera data fetched per ELL row, not per observation)."""
        w_row = p.obs_w.reshape(ell.cam.slots.shape)
        r, z, Jc, Jp = ba_mod._residuals_and_jacobians_rows(p, ell)
        cost, w = ba_mod._robust_cost_and_weight(r, z, w_row, 4.0)
        # production path (solve_ba): camera side from the row-native
        # pass; point side recomputed natively in point order — no
        # transpose gather of obs-sized Jacobians; √w-scaled Jcw shared
        # with the Schur solve (weighted-operand mode)
        U, bc, camw = ba_mod._build_normal_blocks_ell(
            p, ell, r, Jc, Jp, w, cam_only=True, return_cam_w=True
        )
        V, bp, ptg = ba_mod._build_pt_blocks_native(p, ell, 4.0)
        # truncated inexact Newton: 2 PCG iterations on the reduced camera
        # system; the LM outer loop absorbs the looser inner solves
        dx_c, dx_p = ba_mod._schur_solve_ell(
            p, ell, U, V, bc, bp, Jc, Jp, w, lam, cg_iters, 1e-2,
            pt_gathers=ptg, cam_w=camw,
        )
        cand = ba_mod._apply_step(p, dx_c, dx_p)
        r2, z2 = ba_mod._residuals_only_rows(cand, ell)
        c2, _ = ba_mod._robust_cost_and_weight(r2, z2, w_row, 4.0)
        accept = c2 < cost
        out = ba_mod._select_accept(accept, p, cand)
        lam2 = jnp.clip(jnp.where(accept, lam * 0.5, lam * 4.0), 1e-10, 1e8)
        return out, lam2, jnp.where(accept, c2, cost)

    # the LM loop runs inside one jit via lax.scan, like the production
    # solver (optim/ba.solve_ba)
    @functools.partial(jax.jit, static_argnames=("length",))
    def lm_run(p, lam, length):
        def body(carry, _):
            p_, lam_, _ = carry
            p2, lam2, cost = lm_step(p_, lam_)
            return (p2, lam2, cost), None

        (p2, lam2, cost), _ = jax.lax.scan(
            body, (p, lam, jnp.float32(0.0)), None, length=length
        )
        return p2, lam2, cost

    lam = jnp.float32(1e-4)
    _, _, cost = jax.block_until_ready(lm_run(prob, lam, iters))  # compile
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(lm_run(prob, lam, iters))
        best = min(best, time.perf_counter() - t0)
    return iters / best, n_obs, float(cost)


def bench_matching(n_feats=4096, batch=16, reps=10, seed=0):
    """Production-path matcher throughput (pairs/s), pairs batched as in
    feature/matching.match_and_verify_pairs."""
    import jax
    import jax.numpy as jnp

    from xrsfm_tpu.ops import matching as dmatch

    rng = np.random.default_rng(seed)
    d = rng.integers(0, 90, size=(2, batch, n_feats, 128), dtype=np.uint8)
    d1 = jnp.asarray(d[0])
    d2 = jnp.asarray(d[1])
    m = jnp.ones((batch, n_feats), bool)
    jax.block_until_ready(dmatch.match_descriptors_batch(d1, d2, m, m))
    t0 = time.perf_counter()
    for _ in range(reps):
        out = dmatch.match_descriptors_batch(d1, d2, m, m)
    jax.block_until_ready(out)
    return batch * reps / (time.perf_counter() - t0)


def bench_sift(size=(480, 640), reps=6, seed=0):
    """SIFT extraction throughput (images/s), host pad -> device
    pyramid/DoG/orient/describe -> host fetch, in the pipeline's 16-image
    batches (reference: SiftGPU, 3rdparty/SiftGPU/ProgramCU.cu)."""
    from xrsfm_tpu.ops.sift import SiftExtractor, SiftOptions

    rng = np.random.default_rng(seed)
    # textured synthetic image (pure noise yields few stable keypoints;
    # smoothed noise gives a realistic detection load)
    img = rng.integers(0, 255, size=size).astype(np.float32)
    k = np.ones((5, 5), np.float32) / 25.0
    from numpy.lib.stride_tricks import sliding_window_view

    sw = sliding_window_view(np.pad(img, 2, mode="edge"), (5, 5))
    img = (sw * k).sum(axis=(2, 3)).astype(np.uint8)
    ex = SiftExtractor(SiftOptions(
        num_octaves=4, features_per_octave=1024, max_features=4096,
        first_octave=0,
    ))
    B = 16
    imgs = [img] * B
    out = ex.extract_batch(imgs, batch=B)  # compile + warm (host fetch)
    kps = out[0][0]
    t0 = time.perf_counter()
    for _ in range(reps):
        ex.extract_batch(imgs, batch=B)
    dt = time.perf_counter() - t0
    return B * reps / dt, len(kps)


def main():
    import jax

    if jax.default_backend() != "gpu":
        raise SystemExit(
            f"bench.py needs a GPU; JAX's default backend is "
            f"{jax.default_backend()!r}")
    from xrsfm_tpu import enable_compilation_cache

    enable_compilation_cache()
    dev = jax.devices()[0]
    ba_iters_per_s, n_obs, cost = bench_ba()
    ba_large, n_obs_l, cost_l = bench_ba(
        n_cams=1024, n_pts=160000, obs_per_pt=7, iters=12
    )
    pairs_per_s = bench_matching()
    sift_ips, sift_nkp = bench_sift()
    result = {
        "metric": "ba_lm_iters_per_s",
        "value": ba_iters_per_s,
        "unit": "LM iters/s (200 cams, 20k pts, ~140k obs)",
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "secondary": {
            "ba_large_iters_per_s": ba_large,
            "ba_large_num_obs": int(n_obs_l),
            "ba_large_final_cost": cost_l,
            "match_pairs_per_s_4096feat": pairs_per_s,
            "sift_images_per_s_480p": sift_ips,
            "sift_keypoints_per_image": int(sift_nkp),
            "ba_num_obs": int(n_obs),
            "ba_final_cost": cost,
        },
    }
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
