"""Global rotation averaging polish.

The incremental pipeline's final GBA inherits whatever rotational drift
the growth path accumulated: BA is a local method, and on long circuits
it parks in a drift basin 1-2% ATE above what the observations support
(docs/benchmark.md "loop" analysis).  The reference has no answer to
this beyond its translation+scale pose graph (ScalePoseGraphUnorder,
src/optimization/ba_solver.cc:147-328, which never touches rotations).
This module goes further: it re-measures the relative rotation of every
verified image pair directly from the match coordinates (8-point
essential + cheirality, independent of the drifted map), then solves a
robust global rotation averaging problem (IRLS Gauss-Newton on so(3),
Chatterjee-Govindaru-style) and rewrites the frame rotations about
their camera centers.  Retriangulation + GBA afterwards converge in the
correct basin.

Design: edge measurement is ONE batched dispatch (vmapped
LO-RANSAC + pose recovery over padded [P, M, 2] match tables), and the
solver is a single jitted program — fixed edge count, lax.fori_loop
IRLS rounds, Jacobi-preconditioned CG on the 3N x 3N graph Laplacian
via segment_sum matvecs.  No per-edge host work anywhere.

Measurement quality (r3): the essential-manifold IRLS refinement
(ops/epipolar.refine_essential_manifold) removed the estimator's
systematic under-convergence in the forward-motion rotation/translation
valley — per-edge rotation error is now 0.046 deg median on the
kitti-class workspace (was 0.087 with a ~0.5 deg long-baseline bias),
which makes the averaging sound on sequential chains too.  The full
global polish (rotations + translation recovery) lives in
optim/global_pose.py and is what MapperOptions.global_polish enables;
rot_avg_polish remains as the rotation-only variant.
"""

from __future__ import annotations

from functools import partial
from typing import List, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import epipolar
from ..utils import geometry as G

__all__ = [
    "measure_pair_rotations",
    "solve_rotation_averaging",
    "rotation_averaging_polish",
]


# ---------------------------------------------------------------------------
# Edge measurement: verified matches -> relative rotation, batched
# ---------------------------------------------------------------------------


@jax.jit
def _measure_batch(keys, uv1, uv2, mask, th):
    """[P, M, 2] padded match tables -> (q_rel [P,4], t_rel [P,3],
    support [P]).

    q_rel is the cheirality-checked rotation of a 5-point-RANSAC
    essential: x2 = R x1 + t (uv in normalized camera coordinates).
    Stored "verified" match lists still carry a few percent of gross
    mismatches (imperfect geometric verification); a plain least-squares
    8pt is biased ~2.5 deg median by them (measured on the kitti-class
    workspace), which is fatal for rotation averaging — per-edge bias
    integrates around a 250-frame circuit to tens of degrees.  Full
    LO-RANSAC brings the median error to ~0.08 deg.  th is a PER-PAIR
    [P] vector of SQUARED Sampson thresholds in normalized coords
    ((px / f) ** 2, using each pair's own focals).  support = #points
    passing cheirality under the winning model's inlier set.  parallax
    [P] is the median rotation-compensated angular flow (rad): ~0 for a
    pure-rotation pair (whose translation direction is unobservable),
    large when the baseline/depth ratio — hence the direction's
    conditioning — is good.  Feeds translation-averaging edge weights."""
    from ..mapper import kernels as K

    def one(key, u1, u2, mk, th_k):
        E, inl, _n_inl, ok = K.essential_ransac(key, u1, u2, mk, th_k)
        q, t, n_good, _gm = epipolar.recover_pose_from_essential(E, u1, u2, inl)
        # manifold IRLS polish: the RANSAC winner + algebraic LO stops
        # short of the robust minimum in the rotation/lateral-translation
        # valley under forward motion (~0.5 deg systematic yaw bias on
        # long-baseline kitti-class pairs; GT-E measured DEEPER than the
        # RANSAC-E on 11/12 such pairs) — see refine_essential_manifold
        q, t = epipolar.refine_essential_manifold(q, t, u1, u2, mk, th_k)
        # graduated second stage at a 4x tighter truncation knee (2px ->
        # 1px): the ~3% of stored "verified" matches that are
        # contaminated sit in the 1-2px Sampson band where the 2px knee
        # still gives them weight 0.25-1.0, and they own ~40% of the
        # per-edge rotation bias (measured, scripts/exp_edge_bias.py:
        # median 0.0457 deg as stored vs 0.0263 with contamination
        # removed by GT identity; the annealed 1px knee recovers
        # 0.0344, and tighter knees saturate while degrading clean
        # pairs).  Wide basin first, sharp minimum second.
        q, t = epipolar.refine_essential_manifold(
            q, t, u1, u2, mk, th_k * 0.25
        )
        n_good = jnp.where(ok, n_good, 0)
        # parallax: masked median of angle(R x1, x2) over the matches
        ones = jnp.ones(u1.shape[:-1] + (1,), u1.dtype)
        x1 = jnp.concatenate([u1, ones], axis=-1)
        x2 = jnp.concatenate([u2, ones], axis=-1)
        x1 = x1 / jnp.linalg.norm(x1, axis=-1, keepdims=True)
        x2 = x2 / jnp.linalg.norm(x2, axis=-1, keepdims=True)
        rx1 = G.quat_rotate(q[None, :], x1)
        cosang = jnp.clip(jnp.sum(rx1 * x2, axis=-1), -1.0, 1.0)
        ang = jnp.where(mk, jnp.arccos(cosang), jnp.inf)
        cnt = jnp.maximum(jnp.sum(mk), 1)
        par = jnp.sort(ang)[jnp.maximum((cnt - 1) // 2, 0)]
        par = jnp.where(jnp.isfinite(par), par, 0.0)
        return q, t, n_good.astype(jnp.float32), par

    return jax.vmap(one)(keys, uv1, uv2, mask, th)


def measure_pair_rotations(
    m,
    min_inliers: int = 30,
    max_pts: int = 512,
    gate_px: float = 2.0,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Measure R_ij (x_j = R x_i + t) for every verified pair between
    registered frames, from match coordinates alone.

    Returns (ei [E], ej [E], q_meas [E,4], t_meas [E,3], support [E],
    parallax [E]) numpy arrays — t_meas is the unit relative translation
    (x_j = R x_i + t convention; feeds translation averaging,
    optim/global_pose.py), support the cheirality inlier count (edge
    weight basis), parallax the median rotation-compensated angular flow
    in radians (direction-conditioning proxy).  Pairs with fewer than
    min_inliers matches are skipped; matches beyond max_pts are strided
    down."""
    from ..mapper import kernels as K

    ei: List[int] = []
    ej: List[int] = []
    tables: List[Tuple[np.ndarray, np.ndarray]] = []
    for id1, id2, mt in m.pairs:
        if len(mt) < min_inliers:
            continue
        if not (m.registered[id1] and m.registered[id2]):
            continue
        sel = mt
        if len(sel) > max_pts:
            sel = sel[:: len(sel) // max_pts + 1][:max_pts]
        ei.append(id1)
        ej.append(id2)
        tables.append((m.kps_norm[id1][sel[:, 0]], m.kps_norm[id2][sel[:, 1]]))
    if not tables:
        return (np.zeros(0, np.int32), np.zeros(0, np.int32),
                np.zeros((0, 4), np.float32), np.zeros((0, 3), np.float32),
                np.zeros(0, np.float32), np.zeros(0, np.float32))
    P = len(tables)
    pb = K.bucket(P, lo=4)
    nb = K.bucket(max(len(a) for a, _ in tables), lo=64)
    uv1 = np.zeros((pb, nb, 2), np.float32)
    uv2 = np.zeros((pb, nb, 2), np.float32)
    mask = np.zeros((pb, nb), bool)
    for k, (a, b) in enumerate(tables):
        uv1[k, : len(a)] = a
        uv2[k, : len(b)] = b
        mask[k, : len(a)] = True
    # per-pair Sampson gate from each pair's own focals (multi-camera /
    # differing-focal scenes get per-pair thresholds like initialize.py:66)
    focals = np.asarray(
        [m.cameras[int(c)][0] for c in m.cam_of_frame[: m.num_frames]],
        np.float32,
    )
    ei_a = np.asarray(ei, np.int64)
    ej_a = np.asarray(ej, np.int64)
    th = np.ones(pb, np.float32)
    th[:P] = (gate_px / (0.5 * (focals[ei_a] + focals[ej_a]))) ** 2
    keys = jax.vmap(jax.random.PRNGKey)(
        jnp.arange(pb) * 7919 + np.int32(len(tables))
    )
    q, t, sup, par = jax.device_get(_measure_batch(keys, uv1, uv2, mask, th))
    return (np.asarray(ei, np.int32), np.asarray(ej, np.int32),
            q[:P].astype(np.float32), t[:P].astype(np.float32),
            sup[:P].astype(np.float32), par[:P].astype(np.float32))


# ---------------------------------------------------------------------------
# Robust global rotation averaging (IRLS Gauss-Newton over so(3)^N)
# ---------------------------------------------------------------------------


def _edge_residual(q, ei, ej, q_meas):
    """r_e = Log(P M^T) with P = R_j R_i^T predicted, M measured.  [E,3]."""
    pred = G.quat_mul(q[ej], G.quat_conj(q[ei]))
    return G.so3_log(G.quat_mul(pred, G.quat_conj(q_meas))), pred


def solve_rotation_averaging(
    q0: np.ndarray,
    ei: np.ndarray,
    ej: np.ndarray,
    q_meas: np.ndarray,
    w: np.ndarray,
    irls_iters: int = 12,
    cg_iters: int = 40,
    huber_rad: float = np.deg2rad(3.0),
):
    """Minimize sum_e w_e * huber(|Log(R_j R_i^T M_e^T)|) over global
    rotations, gauge-fixed at frame index 0 of the problem.

    Linearization (left perturbation R_k <- Exp(d_k) R_k):
        r' ~= r + d_j - P d_i        (P = predicted R_j R_i^T)
    giving a 3x3-block graph Laplacian solved by Jacobi-PCG.  One jitted
    program; all loops are lax.fori_loop.

    Returns (q [N,4], median residual angle [rad]) as numpy."""
    N = len(q0)
    q_new, med = _solve_ra_jit(
        jnp.asarray(q0, jnp.float32), jnp.asarray(ei), jnp.asarray(ej),
        jnp.asarray(q_meas, jnp.float32), jnp.asarray(w, jnp.float32),
        N, int(irls_iters), int(cg_iters), float(huber_rad),
    )
    q_new, med = jax.device_get((q_new, med))
    return np.asarray(q_new), float(med)


@partial(jax.jit, static_argnums=(5, 6, 7, 8))
def _solve_ra_jit(q0, ei, ej, q_meas, w, N, irls_iters, cg_iters, huber_rad):
    anchor = 0  # gauge: frame at problem index 0 stays fixed

    def gn_round(k, q):
        r, pred = _edge_residual(q, ei, ej, q_meas)
        rn = jnp.linalg.norm(r, axis=-1)
        # annealed redescending IRLS (Geman-McClure): sigma starts wide
        # so a badly drifted init does not reject its own loop edges,
        # then shrinks toward huber_rad so gross outlier edges end up
        # with ~zero influence (plain Huber left them 3+ deg of pull)
        sigma = jnp.maximum(
            huber_rad, jnp.deg2rad(45.0) * (0.5 ** k.astype(jnp.float32))
        )
        rw = w / jnp.square(1.0 + jnp.square(rn / sigma))

        def matvec(v):
            # u_e = v_j - P v_i ; scatter J^T (rw u)
            u = v[ej] - G.quat_rotate(pred, v[ei])
            u = u * rw[:, None]
            out = jnp.zeros((N, 3), jnp.float32)
            out = out.at[ej].add(u)
            out = out.at[ei].add(-G.quat_rotate(G.quat_conj(pred), u))
            # gauge: identity row for the anchor
            return out.at[anchor].set(v[anchor])

        g = jnp.zeros((N, 3), jnp.float32)
        rr = r * rw[:, None]
        g = g.at[ej].add(rr)
        g = g.at[ei].add(-G.quat_rotate(G.quat_conj(pred), rr))
        g = g.at[anchor].set(0.0)

        deg = jnp.zeros(N, jnp.float32).at[ej].add(rw).at[ei].add(rw)
        deg = jnp.maximum(deg, 1e-6).at[anchor].set(1.0)
        precond = 1.0 / deg[:, None]

        b = -g

        def cg_body(_i, st):
            x, p, res, rz = st
            Ap = matvec(p)
            alpha = rz / jnp.maximum(jnp.sum(p * Ap), 1e-20)
            x = x + alpha * p
            res = res - alpha * Ap
            z = precond * res
            rz_new = jnp.sum(res * z)
            beta = rz_new / jnp.maximum(rz, 1e-20)
            return x, z + beta * p, res, rz_new

        x0 = jnp.zeros((N, 3), jnp.float32)
        z0 = precond * b
        st = (x0, z0, b, jnp.sum(b * z0))
        x, _, _, _ = jax.lax.fori_loop(0, cg_iters, cg_body, st)
        # trust-region clip: a GN step beyond ~30 deg/node is outside the
        # linearization's validity
        step = jnp.linalg.norm(x, axis=-1, keepdims=True)
        cap = jnp.deg2rad(30.0)
        x = x * jnp.minimum(1.0, cap / jnp.maximum(step, 1e-12))
        q2 = G.quat_normalize(G.quat_mul(G.so3_exp_quat(x), q))
        return q2

    q = jax.lax.fori_loop(0, irls_iters, gn_round, q0)
    r, _ = _edge_residual(q, ei, ej, q_meas)
    med = jnp.median(jnp.linalg.norm(r, axis=-1))
    return q, med


# ---------------------------------------------------------------------------
# Map-level polish
# ---------------------------------------------------------------------------


def rotation_averaging_polish(
    m,
    min_inliers: int = 30,
    max_med_residual_deg: float = 3.0,
    min_correction_deg: float = 0.05,
    log=None,
    measurements=None,
) -> bool:
    """Re-estimate every registered frame's rotation by global rotation
    averaging over measured pairwise rotations; keep camera centers.

    Returns True if rotations were rewritten (caller must retriangulate
    and re-run GBA).  Safe-guards: requires a connected measurement set
    covering the registered frames; rejects the solution if the IRLS
    median residual stays above max_med_residual_deg (measurements
    mutually inconsistent — e.g. heavy mismatches), or applies nothing
    if the median correction is below min_correction_deg."""
    reg = np.nonzero(m.registered)[0]
    if len(reg) < 10:
        return False
    if measurements is None:
        measurements = measure_pair_rotations(m, min_inliers=min_inliers)
    ei, ej, q_meas, _t, sup = measurements[:5]
    if len(ei) == 0:
        return False
    # Gross-outlier pre-gate: drop edges whose measurement disagrees with
    # the current map by a lot AND have weak cheirality support.  The
    # angular test alone must NOT veto strong edges — on a drifted
    # circuit the loop-closure edges are exactly the ones that disagree
    # with the map, and they are the reason this solver exists; a
    # well-supported measurement is trusted regardless of map agreement
    # (IRLS handles any that are still wrong).  Measured: every edge
    # with err > 10 deg vs GT had support < min_inliers.
    q_all = np.asarray(m.q, np.float32)
    pred = G.quat_mul_np(q_all[ej], _quat_conj_np(q_all[ei]))
    dq = G.quat_mul_np(pred, _quat_conj_np(q_meas))
    ang = _quat_angle_np(dq)
    strong = sup >= 2.0 * float(min_inliers)
    keep = ((ang < np.deg2rad(25.0)) | strong) & (sup >= float(min_inliers))
    # cheirality support as weight (sqrt-damped so one giant pair does
    # not dominate)
    w = np.sqrt(sup)
    ei, ej, q_meas, w = ei[keep], ej[keep], q_meas[keep], w[keep]
    if len(ei) == 0:
        return False

    # compress to registered-frame index space; drop frames not touched
    # by any edge (their rotation cannot be averaged — keep map pose)
    remap = -np.ones(m.num_frames, np.int64)
    remap[reg] = np.arange(len(reg))
    ei_c = remap[ei].astype(np.int32)
    ej_c = remap[ej].astype(np.int32)
    touched = np.zeros(len(reg), bool)
    touched[ei_c] = True
    touched[ej_c] = True
    if not np.all(touched):
        # solve only over the touched subset
        sub = np.nonzero(touched)[0]
        remap2 = -np.ones(len(reg), np.int64)
        remap2[sub] = np.arange(len(sub))
        ei_c = remap2[ei_c].astype(np.int32)
        ej_c = remap2[ej_c].astype(np.int32)
        frames = reg[sub]
    else:
        frames = reg

    # redundancy requirement, applied to the FILTERED edge set: averaging
    # on a (near-)spanning-tree graph just integrates per-edge noise with
    # no consistency constraint — require at least one loop-closing edge
    # beyond a tree (|E| >= |V|) before trusting a global rewrite
    if len(ei_c) < len(frames):
        if log:
            log(f"rot-avg: only {len(ei_c)} usable edges for "
                f"{len(frames)} frames (no redundancy), skipping")
        return False

    # connectivity check (union-find): a disconnected component would
    # float freely relative to the anchor
    parent = np.arange(len(frames))

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for a, b in zip(ei_c, ej_c):
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[ra] = rb
    roots = {find(k) for k in range(len(frames))}
    if len(roots) > 1:
        if log:
            log(f"rot-avg: measurement graph disconnected "
                f"({len(roots)} components), skipping")
        return False

    q0 = np.asarray(m.q[frames], np.float32)
    q_new, med = solve_rotation_averaging(q0, ei_c, ej_c, q_meas, w)
    if np.rad2deg(med) > max_med_residual_deg:
        if log:
            log(f"rot-avg: rejected (median edge residual "
                f"{np.rad2deg(med):.2f} deg)")
        return False
    dq = G.quat_mul_np(q_new, _quat_conj_np(q0))
    corr = np.rad2deg(_quat_angle_np(dq))
    if float(np.median(corr)) < min_correction_deg:
        if log:
            log(f"rot-avg: correction negligible "
                f"(median {np.median(corr):.3f} deg), keeping map")
        return False
    # rewrite rotations about fixed camera centers: c = -R^T t invariant
    centers = G.pose_center_np(m.q[frames], m.t[frames])
    R_new = G.quat_to_rotmat_np(q_new)
    t_new = -np.einsum("nij,nj->ni", R_new, centers)
    m.q[frames] = q_new
    m.t[frames] = t_new.astype(np.float32)
    if log:
        log(f"rot-avg: {len(frames)} frames over {len(ei_c)} edges, "
            f"median correction {np.median(corr):.2f} deg "
            f"(max {corr.max():.2f}), median residual "
            f"{np.rad2deg(med):.3f} deg")
    return True


def _quat_conj_np(q):
    return q * np.array([1.0, -1.0, -1.0, -1.0], q.dtype)


def _quat_angle_np(q):
    w = np.clip(np.abs(q[..., 0]), 0.0, 1.0)
    return 2.0 * np.arccos(w)
