"""Closed-form N-point absolute-pose solvers: EPnP and IPPE.

Batched equivalents of the reference's EPNPEstimator — the LO-RANSAC
local refiner for registration (reference: absolute_pose.cc:188-621).
Two solvers cover the two geometric regimes:

  * epnp(): Lepetit et al.'s EPnP — 4 control points from the point
    cloud's PCA frame, a 12x12 nullspace eigenproblem, betas recovered by
    a small Gauss-Newton on the control-point distance constraints, pose
    by Kabsch.  Global (non-iterative in the pose), so it escapes the
    P3P-minimal-sample basin the LM-only refit inherits (review finding
    r1-missing#3).
  * ippe(): Collins & Bartoli's Infinitesimal Plane-based Pose
    Estimation for the (near-)planar regime where EPnP's 4th control
    point degenerates.  Returns BOTH members of the planar two-fold
    ambiguity in closed form — the "mirror pose" failure documented in
    mapper/error_correct.py is exactly the wrong member of this pair, so
    enumerating both and letting inlier support decide removes it at the
    source.

Everything is fixed-shape and mask-weighted: padded observations carry
weight 0 and vanish from every normal-equation/DLT sum.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from . import pnp as PNP
from ..utils import geometry as G


def _weighted_pca(xyz, w):
    """(centroid [3], eigvecs [3,3] ascending-eigenvalue cols, eigvals [3])."""
    wn = w / jnp.maximum(jnp.sum(w), 1e-9)
    c0 = jnp.einsum("n,ni->i", wn, xyz)
    d = xyz - c0
    cov = jnp.einsum("n,ni,nj->ij", wn, d, d)
    evals, evecs = jnp.linalg.eigh(cov)  # ascending
    return c0, evecs, evals


# ---------------------------------------------------------------------------
# EPnP
# ---------------------------------------------------------------------------


def _epnp_control_points(xyz, w):
    """4 control points: centroid + PCA axes scaled by the std dev."""
    c0, evecs, evals = _weighted_pca(xyz, w)
    s = jnp.sqrt(jnp.maximum(evals, 1e-10))
    # descending order, so cw[1] is the dominant direction
    cw = jnp.stack(
        [c0, c0 + s[2] * evecs[:, 2], c0 + s[1] * evecs[:, 1],
         c0 + s[0] * evecs[:, 0]]
    )  # [4,3]
    return cw


def _barycentric(xyz, cw):
    """alphas [N,4] with xyz = alphas @ cw, sum(alphas) = 1."""
    B = (cw[1:] - cw[0]).T  # [3,3]
    # guarded inverse (near-planar clouds have a tiny 3rd axis; IPPE
    # covers that regime, this path just needs to stay finite)
    Binv = jnp.linalg.inv(B + 1e-9 * jnp.eye(3, dtype=B.dtype))
    a123 = jnp.einsum("ij,nj->ni", Binv, xyz - cw[0])  # [N,3]
    a0 = 1.0 - jnp.sum(a123, axis=1, keepdims=True)
    return jnp.concatenate([a0, a123], axis=1)


def _epnp_M_kernel(alphas, uv, w):
    """Nullspace basis of the EPnP M matrix: 4 smallest eigvecs of MᵀM.

    M rows (2 per obs): Σ_j a_j (u) pattern; weighted by w."""
    N = uv.shape[0]
    a = alphas  # [N,4]
    u = uv[:, 0]
    v = uv[:, 1]
    # rows: for each j: [a_j, 0, -a_j*u] and [0, a_j, -a_j*v]
    zeros = jnp.zeros_like(a)
    row_u = jnp.stack([a, zeros, -a * u[:, None]], axis=2).reshape(N, 12)
    row_v = jnp.stack([zeros, a, -a * v[:, None]], axis=2).reshape(N, 12)
    # interleave into [2N,12] is unnecessary for MᵀM
    sw = jnp.sqrt(jnp.maximum(w, 0.0))[:, None]
    Mu = row_u * sw
    Mv = row_v * sw
    MtM = Mu.T @ Mu + Mv.T @ Mv  # [12,12]
    evals, evecs = jnp.linalg.eigh(MtM)
    V = evecs[:, :4]  # 4 smallest
    return V.T.reshape(4, 4, 3)  # [basis, ctrl-point, xyz] — note ordering


def _ctrl_dists2(cc):
    """Squared distances of the 6 control-point pairs.  cc [...,4,3]."""
    ii = jnp.array([0, 0, 0, 1, 1, 2])
    jj = jnp.array([1, 2, 3, 2, 3, 3])
    d = cc[..., ii, :] - cc[..., jj, :]
    return jnp.sum(d * d, axis=-1)  # [...,6]


def epnp(xyz, uv, w, gn_iters: int = 6):
    """EPnP pose from N weighted 2D-3D correspondences.

    xyz [N,3] world, uv [N,2] normalized, w [N] (0 = padded out).
    Returns (q [4], t [3]).  (reference: EPNPEstimator,
    absolute_pose.cc:188-621 — reimplemented from the paper with a
    GN-on-betas in place of the three closed-form beta cases.)
    """
    cw = _epnp_control_points(xyz, w)
    alphas = _barycentric(xyz, cw)
    V = _epnp_M_kernel(alphas, uv, w)  # [4 basis, 4 ctrl, 3]
    rho = _ctrl_dists2(cw)  # [6]

    # betas: camera control points cc(β) = Σ_k β_k V_k; enforce pairwise
    # distances == rho.  Init from the 1-vector case, refine by GN.
    v1 = V[0]
    d1 = _ctrl_dists2(v1)
    beta1 = jnp.sqrt(jnp.sum(rho * d1) / jnp.maximum(jnp.sum(d1 * d1), 1e-12))
    beta = jnp.array([beta1, 0.0, 0.0, 0.0], xyz.dtype)

    ii = jnp.array([0, 0, 0, 1, 1, 2])
    jj = jnp.array([1, 2, 3, 2, 3, 3])
    dV = V[:, ii, :] - V[:, jj, :]  # [4,6,3]

    def gn(_, b):
        dv = jnp.einsum("k,kez->ez", b, dV)  # [6,3]
        f = jnp.sum(dv * dv, axis=-1) - rho  # [6]
        J = 2.0 * jnp.einsum("ez,kez->ek", dv, dV)  # [6,4]
        H = J.T @ J + 1e-9 * jnp.eye(4, dtype=b.dtype)
        g = J.T @ f
        return b - jnp.linalg.solve(H, g)

    beta = jax.lax.fori_loop(0, gn_iters, gn, beta)

    cc = jnp.einsum("k,kcz->cz", beta, V)  # [4,3] camera control points
    # cheirality: points must be in front; flip the global sign if the
    # weighted mean depth of the reconstructed points is negative
    pc = jnp.einsum("nc,cz->nz", alphas, cc)
    sign = jnp.where(jnp.sum(w * pc[:, 2]) < 0, -1.0, 1.0)
    pc = pc * sign
    R, t = PNP.kabsch(xyz[None], pc[None], w[None])
    return G.rotmat_to_quat(R[0]), t[0]


# ---------------------------------------------------------------------------
# IPPE (planar)
# ---------------------------------------------------------------------------


def _plane_frame(xyz, w):
    """Orthonormal plane frame: (c0, M [3,3] world->plane rotation rows
    = [e1; e2; n], planarity = small/large eigenvalue ratio)."""
    c0, evecs, evals = _weighted_pca(xyz, w)
    e1 = evecs[:, 2]
    e2 = evecs[:, 1]
    n = jnp.cross(e1, e2)
    M = jnp.stack([e1, e2, n])  # rows
    planarity = evals[0] / jnp.maximum(evals[2], 1e-12)
    return c0, M, planarity


def _homography_dlt(pq, uv, w):
    """DLT homography plane-coords -> normalized image.  pq [N,2],
    uv [N,2], w [N].  Returns H [3,3] (unnormalized scale)."""
    N = pq.shape[0]
    x, y = pq[:, 0], pq[:, 1]
    u, v = uv[:, 0], uv[:, 1]
    one = jnp.ones_like(x)
    zero = jnp.zeros_like(x)
    r1 = jnp.stack(
        [x, y, one, zero, zero, zero, -u * x, -u * y, -u], axis=1
    )
    r2 = jnp.stack(
        [zero, zero, zero, x, y, one, -v * x, -v * y, -v], axis=1
    )
    sw = jnp.sqrt(jnp.maximum(w, 0.0))[:, None]
    A1 = r1 * sw
    A2 = r2 * sw
    AtA = A1.T @ A1 + A2.T @ A2
    _, evecs = jnp.linalg.eigh(AtA)
    h = evecs[:, 0]
    return h.reshape(3, 3)


def ippe(xyz, uv, w):
    """Both planar-pose solutions from N weighted correspondences.

    xyz [N,3] world (near-coplanar), uv [N,2] normalized, w [N].
    Returns (q [2,4], t [2,3]) — the two members of the planar two-fold
    ambiguity; evaluate support to pick (Collins & Bartoli, IJCV 2014).
    """
    c0, M, _ = _plane_frame(xyz, w)
    pq = jnp.einsum("ij,nj->ni", M, xyz - c0)[:, :2]  # plane coords
    H = _homography_dlt(pq, uv, w)
    Hs = H / jnp.where(jnp.abs(H[2, 2]) < 1e-12, 1e-12, H[2, 2])
    v = Hs[:2, 2]  # image of the plane origin
    # Jacobian of the homography at the plane origin
    J = jnp.array(
        [
            [Hs[0, 0] - v[0] * Hs[2, 0], Hs[0, 1] - v[0] * Hs[2, 1]],
            [Hs[1, 0] - v[1] * Hs[2, 0], Hs[1, 1] - v[1] * Hs[2, 1]],
        ]
    )
    # rotation Rv taking e3 to the bearing of v
    vb = jnp.concatenate([v, jnp.ones(1, v.dtype)])
    vb = vb / jnp.linalg.norm(vb)
    e3 = jnp.array([0.0, 0.0, 1.0], v.dtype)
    ax = jnp.cross(e3, vb)
    s = jnp.linalg.norm(ax)
    c = vb[2]
    K = G.skew(ax)
    # Rodrigues with sin/cos from the cross/dot (guard the parallel case)
    Rv = (
        jnp.eye(3, dtype=v.dtype)
        + K
        + (K @ K) * ((1.0 - c) / jnp.maximum(s * s, 1e-12))
    )
    Rv = jnp.where(s < 1e-9, jnp.eye(3, dtype=v.dtype), Rv)
    # Pv @ Rv = [A2 | 0] with Pv = [I2 | -v]
    PvRv = jnp.concatenate(
        [jnp.eye(2, dtype=v.dtype), -v[:, None]], axis=1
    ) @ Rv
    A2 = PvRv[:, :2]  # [2,2] invertible
    C = jnp.linalg.solve(A2, J)  # = (1/d) Q_top
    # d from the largest singular value of C; b (bottom row of Q12) from
    # the rank-1 completion — its sign is the two-fold ambiguity
    CtC = C.T @ C
    tr = CtC[0, 0] + CtC[1, 1]
    det = CtC[0, 0] * CtC[1, 1] - CtC[0, 1] * CtC[1, 0]
    disc = jnp.sqrt(jnp.maximum(tr * tr / 4.0 - det, 0.0))
    lam1 = tr / 2.0 + disc  # largest eigenvalue
    lam2 = jnp.maximum(tr / 2.0 - disc, 0.0)
    d = 1.0 / jnp.sqrt(jnp.maximum(lam1, 1e-12))
    gamma = jnp.sqrt(jnp.maximum(1.0 - lam2 / jnp.maximum(lam1, 1e-12), 0.0))
    # eigvec of CtC for lam2
    w2a = jnp.stack([CtC[0, 1], lam2 - CtC[0, 0]])
    w2b = jnp.stack([lam2 - CtC[1, 1], CtC[1, 0]])
    w2 = jnp.where(jnp.linalg.norm(w2a) > jnp.linalg.norm(w2b), w2a, w2b)
    w2 = w2 / jnp.maximum(jnp.linalg.norm(w2), 1e-12)

    Q_top = d * C  # [2,2]

    def build(sign):
        b = sign * gamma * w2  # [2]
        q1 = jnp.concatenate([Q_top[:, 0], b[0:1]])
        q2 = jnp.concatenate([Q_top[:, 1], b[1:2]])
        # orthonormalize defensively (noise)
        q1 = q1 / jnp.maximum(jnp.linalg.norm(q1), 1e-12)
        q2 = q2 - jnp.dot(q1, q2) * q1
        q2 = q2 / jnp.maximum(jnp.linalg.norm(q2), 1e-12)
        q3 = jnp.cross(q1, q2)
        Q = jnp.stack([q1, q2, q3], axis=1)
        R_plane = Rv @ Q  # plane-frame -> camera
        t_cam = d * jnp.concatenate([v, jnp.ones(1, v.dtype)])
        R_wc = R_plane @ M  # world -> camera (M maps world->plane coords)
        t_wc = t_cam - R_wc @ c0
        return G.rotmat_to_quat(R_wc), t_wc

    qa, ta = build(1.0)
    qb, tb = build(-1.0)
    return jnp.stack([qa, qb]), jnp.stack([ta, tb])
