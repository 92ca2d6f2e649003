"""Batched absolute-pose estimation (P3P + pose refinement).

Batched equivalents of the reference's registration kernels:
  * P3P minimal solver (reference: P3PEstimator, Gao's method,
    src/geometry/colmap/estimators/absolute_pose.cc:50-186) — implemented
    here as Grunert's distance quartic rooted with the batched
    Durand-Kerner iteration + Kabsch absolute orientation; same minimal
    problem, branch-free and vmappable.
  * pose refinement (reference: Ceres autodiff refine with Huber loss,
    src/geometry/pnp.cc:39-71, and the EPNP LO-refiner,
    absolute_pose.cc:188-621) — implemented as a fixed-iteration
    Levenberg-Marquardt on Huber-weighted normalized reprojection with an
    analytic 6-dof Jacobian.  On inlier sets this plays the role LO-RANSAC
    gives to EPnP: a least-squares refit over all inliers.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from . import poly
from ..utils import geometry as G


def kabsch(src: jax.Array, dst: jax.Array, weights: jax.Array):
    """Rigid alignment dst ~ R @ src + t (weighted).

    src, dst [..., N, 3]; weights [..., N].  Returns (R [...,3,3], t [...,3]).
    """
    w = weights[..., None]
    wsum = jnp.maximum(jnp.sum(w, axis=-2, keepdims=True), 1e-9)
    cs = jnp.sum(src * w, axis=-2, keepdims=True) / wsum
    cd = jnp.sum(dst * w, axis=-2, keepdims=True) / wsum
    H = jnp.einsum("...ni,...nj->...ij", (src - cs) * w, dst - cd)
    U, _, Vt = jnp.linalg.svd(H)
    d = jnp.linalg.det(jnp.einsum("...ji,...kj->...ik", Vt, U))
    D = jnp.stack([jnp.ones_like(d), jnp.ones_like(d), d], axis=-1)
    # R = V @ diag(1,1,d) @ U^T
    R = jnp.einsum("...ij,...j,...kj->...ik", Vt.mT, D, U)
    t = cd[..., 0, :] - jnp.einsum("...ij,...j->...i", R, cs[..., 0, :])
    return R, t


def p3p(xyz: jax.Array, uv: jax.Array):
    """Grunert P3P: 3 world points + 3 normalized image coords -> up to 4
    camera poses Tcw.

    xyz [3, 3] world points, uv [3, 2] normalized coords.
    Returns (q [4, 4], t [4, 3], valid [4]).
    """
    f = jnp.concatenate([uv, jnp.ones((3, 1), uv.dtype)], axis=-1)
    f = f / jnp.linalg.norm(f, axis=-1, keepdims=True)  # bearing vectors
    P1, P2, P3 = xyz[0], xyz[1], xyz[2]
    a2 = jnp.sum((P2 - P3) ** 2)
    b2 = jnp.sum((P1 - P3) ** 2)
    c2 = jnp.sum((P1 - P2) ** 2)
    ca = jnp.dot(f[1], f[2])  # cos(alpha): angle P2-P3
    cb = jnp.dot(f[0], f[2])  # cos(beta):  angle P1-P3
    cg = jnp.dot(f[0], f[1])  # cos(gamma): angle P1-P2

    b2s = jnp.maximum(b2, 1e-12)
    acb = (a2 - c2) / b2s
    apcb = (a2 + c2) / b2s
    bcb = (b2 - c2) / b2s
    bab = (b2 - a2) / b2s

    A4 = (acb - 1.0) ** 2 - 4.0 * (c2 / b2s) * ca**2
    A3 = 4.0 * (
        acb * (1.0 - acb) * cb
        - (1.0 - apcb) * ca * cg
        + 2.0 * (c2 / b2s) * ca**2 * cb
    )
    A2 = 2.0 * (
        acb**2
        - 1.0
        + 2.0 * acb**2 * cb**2
        + 2.0 * bcb * ca**2
        - 4.0 * apcb * ca * cb * cg
        + 2.0 * bab * cg**2
    )
    A1 = 4.0 * (
        -acb * (1.0 + acb) * cb
        + 2.0 * (a2 / b2s) * cg**2 * cb
        - (1.0 - apcb) * ca * cg
    )
    A0 = (1.0 + acb) ** 2 - 4.0 * (a2 / b2s) * cg**2

    coeffs = jnp.stack([A4, A3, A2, A1, A0])
    v, vvalid = poly.real_roots(coeffs, imag_tol=1e-3)  # [4]

    denom_u = 2.0 * (cg - v * ca)
    denom_u = jnp.where(jnp.abs(denom_u) < 1e-9, 1e-9, denom_u)
    u = ((-1.0 + acb) * v**2 - 2.0 * acb * cb * v + 1.0 + acb) / denom_u

    s1sq = b2 / jnp.maximum(1.0 + v**2 - 2.0 * v * cb, 1e-12)
    s1 = jnp.sqrt(jnp.maximum(s1sq, 0.0))
    s2 = u * s1
    s3 = v * s1
    valid = vvalid & (s1 > 0) & (s2 > 0) & (s3 > 0)

    # camera-frame points per root: [4, 3, 3]
    s = jnp.stack([s1, s2, s3], axis=-1)  # [4, 3]
    pc = s[..., None] * f[None, :, :]
    pw = jnp.broadcast_to(xyz, (4, 3, 3))
    ones = jnp.ones((4, 3), uv.dtype)
    R, t = kabsch(pw, pc, ones)  # world -> camera
    q = G.rotmat_to_quat(R)
    return q, t, valid


def pnp_residuals(q, t, uv, xyz):
    """Squared reprojection error on the normalized plane for pose batch.

    q [..., 4], t [..., 3]; uv [N, 2]; xyz [N, 3] -> [..., N].
    Cheirality failures get +inf.
    """
    pc = G.pose_apply(q[..., None, :], t[..., None, :], xyz)
    z = pc[..., 2]
    zs = jnp.where(jnp.abs(z) < 1e-9, 1e-9, z)
    proj = pc[..., :2] / zs[..., None]
    err = jnp.sum((proj - uv) ** 2, axis=-1)
    return jnp.where(z > 0, err, jnp.inf)


def refine_pose(
    q,
    t,
    uv,
    xyz,
    weights,
    iters: int = 10,
    huber_delta: float = 0.01,
    damping: float = 1e-4,
):
    """Fixed-iteration LM pose-only refinement on Huber-weighted normalized
    reprojection.  weights [N] (0 masks an observation out).

    Jacobian of the normalized projection wrt the right-multiplicative local
    pose update (dw, dt): with pc = R x + t,
      d pc / d dw = -R [x]_x   (right perturbation q <- q * exp(dw))
      d pc / d dt = I
      d proj / d pc = [[1/z, 0, -x/z^2], [0, 1/z, -y/z^2]].
    """

    def gn_step(_, carry):
        q, t = carry
        R = G.quat_to_rotmat(q)
        pc = G.pose_apply(q[None, :], t[None, :], xyz)  # [N,3]
        z = pc[..., 2]
        good = (z > 1e-6) & (weights > 0)
        zs = jnp.where(good, z, 1.0)
        proj = pc[..., :2] / zs[..., None]
        r = proj - uv  # [N,2]
        rn = jnp.linalg.norm(r, axis=-1)
        # Huber IRLS weight
        hub = jnp.where(rn > huber_delta, huber_delta / jnp.maximum(rn, 1e-12), 1.0)
        wts = jnp.where(good, weights * hub, 0.0)

        dproj_dpc = jnp.zeros(pc.shape[:-1] + (2, 3), pc.dtype)
        inv_z = 1.0 / zs
        dproj_dpc = dproj_dpc.at[..., 0, 0].set(inv_z)
        dproj_dpc = dproj_dpc.at[..., 1, 1].set(inv_z)
        dproj_dpc = dproj_dpc.at[..., 0, 2].set(-pc[..., 0] * inv_z**2)
        dproj_dpc = dproj_dpc.at[..., 1, 2].set(-pc[..., 1] * inv_z**2)

        dpc_dw = -jnp.einsum("ij,njk->nik", R, G.skew(xyz))  # [N,3,3]
        Jw = jnp.einsum("nij,njk->nik", dproj_dpc, dpc_dw)  # [N,2,3]
        Jt = dproj_dpc  # [N,2,3]
        J = jnp.concatenate([Jw, Jt], axis=-1)  # [N,2,6]

        JW = J * wts[:, None, None]
        H = jnp.einsum("nri,nrj->ij", JW, J) + damping * jnp.eye(6, dtype=q.dtype)
        g = jnp.einsum("nri,nr->i", JW, r)
        delta = -jnp.linalg.solve(H, g)
        q2, t2 = G.pose_retract(q, t, delta)

        # accept only if weighted cost decreased (cheap LM guard)
        def cost(qq, tt):
            rr = pnp_residuals(qq[None], tt[None], uv, xyz)[0]
            rr = jnp.where(jnp.isfinite(rr), rr, 1e6)
            rn_ = jnp.sqrt(rr)
            hw = jnp.where(rn_ > huber_delta, huber_delta * (2 * rn_ - huber_delta), rr)
            return jnp.sum(jnp.where(good, weights * hw, 0.0))

        better = cost(q2, t2) < cost(q, t)
        q = jnp.where(better, q2, q)
        t = jnp.where(better, t2, t)
        return q, t

    return jax.lax.fori_loop(0, iters, gn_step, (q, t))
