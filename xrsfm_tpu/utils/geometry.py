"""Batched quaternion / SO(3) / SE(3) primitives.

Equivalent of the reference's pose types and Lie helpers
(reference: src/base/types.h:14-61, src/optimization/lie_algebra.h:12-57).
All functions are pure, broadcast over arbitrary leading batch dimensions,
and are safe under jit/vmap/grad.

Conventions:
  * quaternions are stored [..., 4] as (w, x, y, z), Hamilton convention,
    matching COLMAP's on-disk order (qw qx qy qz).
  * a camera pose is Tcw: x_cam = R @ x_world + t  (world -> camera), the
    same convention as the reference's ``Pose`` (src/base/types.h:30-61).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_EPS = 1e-12


# ---------------------------------------------------------------------------
# Quaternions
# ---------------------------------------------------------------------------

def quat_normalize(q: jax.Array) -> jax.Array:
    return q / jnp.maximum(jnp.linalg.norm(q, axis=-1, keepdims=True), _EPS)


def quat_mul(a: jax.Array, b: jax.Array) -> jax.Array:
    """Hamilton product a*b, both [..., 4] (w,x,y,z)."""
    aw, ax, ay, az = jnp.moveaxis(a, -1, 0)
    bw, bx, by, bz = jnp.moveaxis(b, -1, 0)
    return jnp.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        axis=-1,
    )


def quat_conj(q: jax.Array) -> jax.Array:
    return q * jnp.array([1.0, -1.0, -1.0, -1.0], dtype=q.dtype)


def quat_rotate(q: jax.Array, v: jax.Array) -> jax.Array:
    """Rotate vectors v [..., 3] by unit quaternions q [..., 4]."""
    w = q[..., :1]
    u = q[..., 1:]
    uv = jnp.cross(u, v)
    return v + 2.0 * (w * uv + jnp.cross(u, uv))


def quat_to_rotmat(q: jax.Array) -> jax.Array:
    """Unit quaternion [..., 4] -> rotation matrix [..., 3, 3]."""
    w, x, y, z = jnp.moveaxis(q, -1, 0)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = jnp.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        axis=-1,
    )
    return m.reshape(m.shape[:-1] + (3, 3))


def quat_to_rotmat_np(q) -> "np.ndarray":
    """Numpy twin of quat_to_rotmat for host bookkeeping — calling the
    jnp version on host data places a device computation per call."""
    import numpy as np

    q = np.asarray(q, np.float64)
    w, x, y, z = np.moveaxis(q, -1, 0)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = np.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        axis=-1,
    )
    return m.reshape(m.shape[:-1] + (3, 3))


def pose_center_np(q, t) -> "np.ndarray":
    """Numpy twin of pose_center (-R^T t) for host bookkeeping."""
    import numpy as np

    R = quat_to_rotmat_np(q)
    t = np.asarray(t, np.float64)
    return -np.einsum("...ji,...j->...i", R, t)


def quat_mul_np(a, b) -> "np.ndarray":
    """Numpy twin of quat_mul for host bookkeeping."""
    import numpy as np

    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    aw, ax, ay, az = np.moveaxis(a, -1, 0)
    bw, bx, by, bz = np.moveaxis(b, -1, 0)
    return np.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        axis=-1,
    )


def pose_compose_np(qa, ta, qb, tb):
    """Numpy twin of pose_compose (Ta*Tb)."""
    import numpy as np

    Ra = quat_to_rotmat_np(qa)
    ta = np.asarray(ta, np.float64)
    tb = np.asarray(tb, np.float64)
    return quat_mul_np(qa, qb), np.einsum("...ij,...j->...i", Ra, tb) + ta


def pose_relative_np(q1, t1, q2, t2):
    """Numpy twin of pose_relative (T1 * T2^-1)."""
    import numpy as np

    qi = np.asarray(q2, np.float64) * np.array([1.0, -1.0, -1.0, -1.0])
    Ri = quat_to_rotmat_np(qi)
    ti = -np.einsum("...ij,...j->...i", Ri, np.asarray(t2, np.float64))
    return pose_compose_np(q1, t1, qi, ti)


def rotmat_to_quat_np(R) -> "np.ndarray":
    """Numpy twin of rotmat_to_quat (branch-free Shepperd) for host
    bookkeeping — e.g. dataset generation, which should not touch the
    device at all."""
    import numpy as np

    R = np.asarray(R, np.float64)
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    qw = np.stack([1 + tr, m21 - m12, m02 - m20, m10 - m01], axis=-1)
    qx = np.stack([m21 - m12, 1 + m00 - m11 - m22, m01 + m10, m02 + m20], axis=-1)
    qy = np.stack([m02 - m20, m01 + m10, 1 - m00 + m11 - m22, m12 + m21], axis=-1)
    qz = np.stack([m10 - m01, m02 + m20, m12 + m21, 1 - m00 - m11 + m22], axis=-1)
    scores = np.stack(
        [1 + tr, 1 + m00 - m11 - m22, 1 - m00 + m11 - m22, 1 - m00 - m11 + m22],
        axis=-1,
    )
    idx = np.argmax(scores, axis=-1)
    cand = np.stack([qw, qx, qy, qz], axis=-2)
    q = np.take_along_axis(cand, idx[..., None, None], axis=-2)[..., 0, :]
    q = q / np.linalg.norm(q, axis=-1, keepdims=True)
    return q * np.where(q[..., :1] < 0, -1.0, 1.0)


def rotmat_to_quat(R: jax.Array) -> jax.Array:
    """Rotation matrix [..., 3, 3] -> unit quaternion [..., 4] (w>=0).

    Branch-free Shepperd's method: compute all four candidate quaternions and
    select the numerically best by the largest diagonal combination.
    """
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    # four candidates, each scaled by 4*component^2 (always >= 0)
    qw = jnp.stack([1 + tr, m21 - m12, m02 - m20, m10 - m01], axis=-1)
    qx = jnp.stack([m21 - m12, 1 + m00 - m11 - m22, m01 + m10, m02 + m20], axis=-1)
    qy = jnp.stack([m02 - m20, m01 + m10, 1 - m00 + m11 - m22, m12 + m21], axis=-1)
    qz = jnp.stack([m10 - m01, m02 + m20, m12 + m21, 1 - m00 - m11 + m22], axis=-1)

    scores = jnp.stack(
        [1 + tr, 1 + m00 - m11 - m22, 1 - m00 + m11 - m22, 1 - m00 - m11 + m22],
        axis=-1,
    )
    idx = jnp.argmax(scores, axis=-1)
    cand = jnp.stack([qw, qx, qy, qz], axis=-2)  # [..., 4(case), 4(comp)]
    q = jnp.take_along_axis(cand, idx[..., None, None], axis=-2)[..., 0, :]
    q = quat_normalize(q)
    return q * jnp.where(q[..., :1] < 0, -1.0, 1.0)


# ---------------------------------------------------------------------------
# SO(3) exp / log and Jacobians  (reference: src/optimization/lie_algebra.h)
# ---------------------------------------------------------------------------

def skew(v: jax.Array) -> jax.Array:
    """[..., 3] -> [..., 3, 3] skew-symmetric matrix."""
    x, y, z = jnp.moveaxis(v, -1, 0)
    zero = jnp.zeros_like(x)
    m = jnp.stack([zero, -z, y, z, zero, -x, -y, x, zero], axis=-1)
    return m.reshape(m.shape[:-1] + (3, 3))


def so3_exp_quat(w: jax.Array) -> jax.Array:
    """Rotation vector [..., 3] -> unit quaternion [..., 4]. Taylor-safe at 0."""
    theta2 = jnp.sum(w * w, axis=-1, keepdims=True)
    theta = jnp.sqrt(jnp.maximum(theta2, _EPS))
    half = 0.5 * theta
    small = theta2 < 1e-8
    sinc = jnp.where(small, 0.5 - theta2 / 48.0, jnp.sin(half) / theta)
    cw = jnp.where(small, 1.0 - theta2 / 8.0, jnp.cos(half))
    return jnp.concatenate([cw, sinc * w], axis=-1)


def so3_log(q: jax.Array) -> jax.Array:
    """Unit quaternion [..., 4] -> rotation vector [..., 3]. Taylor-safe."""
    q = q * jnp.where(q[..., :1] < 0, -1.0, 1.0)  # shortest arc
    w = jnp.clip(q[..., :1], -1.0, 1.0)
    v = q[..., 1:]
    vn = jnp.linalg.norm(v, axis=-1, keepdims=True)
    theta = 2.0 * jnp.arctan2(vn, w)
    scale = jnp.where(vn < 1e-8, 2.0 / jnp.maximum(w, 0.5), theta / jnp.maximum(vn, _EPS))
    return scale * v


def so3_exp_matrix(w: jax.Array) -> jax.Array:
    return quat_to_rotmat(so3_exp_quat(w))


def so3_right_jacobian(w: jax.Array) -> jax.Array:
    """Right Jacobian Jr(w) of SO(3), [..., 3] -> [..., 3, 3]."""
    theta2 = jnp.sum(w * w, axis=-1)[..., None, None]
    theta = jnp.sqrt(jnp.maximum(theta2, _EPS))
    W = skew(w)
    W2 = W @ W
    small = theta2 < 1e-8
    a = jnp.where(small, 0.5 - theta2 / 24.0, (1 - jnp.cos(theta)) / theta2)
    b = jnp.where(small, 1.0 / 6.0 - theta2 / 120.0, (theta - jnp.sin(theta)) / (theta2 * theta))
    eye = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), W.shape)
    return eye - a * W + b * W2


def so3_right_jacobian_inv(w: jax.Array) -> jax.Array:
    """Inverse right Jacobian Jr^-1(w)."""
    theta2 = jnp.sum(w * w, axis=-1)[..., None, None]
    theta = jnp.sqrt(jnp.maximum(theta2, _EPS))
    W = skew(w)
    W2 = W @ W
    small = theta2 < 1e-8
    cot_term = jnp.where(
        small,
        1.0 / 12.0 + theta2 / 720.0,
        (1.0 / theta2) - (1 + jnp.cos(theta)) / (2.0 * theta * jnp.sin(theta)),
    )
    eye = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), W.shape)
    return eye + 0.5 * W + cot_term * W2


# ---------------------------------------------------------------------------
# SE(3) poses as (quat [...,4], t [...,3]) — Tcw convention
# ---------------------------------------------------------------------------

def pose_compose(qa, ta, qb, tb):
    """Compose Ta*Tb: x -> Ra(Rb x + tb) + ta.  (reference Pose::mul,
    src/base/types.h:54)."""
    return quat_mul(qa, qb), quat_rotate(qa, tb) + ta


def pose_inverse(q, t):
    qi = quat_conj(q)
    return qi, -quat_rotate(qi, t)


def pose_apply(q, t, x):
    """Apply Tcw to world points: x_cam = R x + t."""
    return quat_rotate(q, x) + t


def pose_center(q, t):
    """Camera center in world coordinates: -R^T t."""
    return -quat_rotate(quat_conj(q), t)


def pose_relative(q1, t1, q2, t2):
    """T12 = T1cw * T2cw^-1 (pose of cam2 in cam1 frame when both are Tcw)."""
    qi, ti = pose_inverse(q2, t2)
    return pose_compose(q1, t1, qi, ti)


def pose_retract(q, t, delta):
    """Right-multiplicative local update used by the LM solver.

    delta [..., 6] = (dw, dt); q' = q * exp(dw), t' = t + dt.
    Matches the reference's QuatParam right-expmap parameterization
    (src/optimization/cost_factor_ceres.h:262-282).
    """
    dq = so3_exp_quat(delta[..., :3])
    return quat_normalize(quat_mul(q, dq)), t + delta[..., 3:]


def angle_between_rays(d1: jax.Array, d2: jax.Array) -> jax.Array:
    """Angle (radians) between ray direction bundles [..., 3]."""
    n1 = jnp.linalg.norm(d1, axis=-1)
    n2 = jnp.linalg.norm(d2, axis=-1)
    cosang = jnp.sum(d1 * d2, axis=-1) / jnp.maximum(n1 * n2, _EPS)
    return jnp.arccos(jnp.clip(cosang, -1.0, 1.0))


# ---------------------------------------------------------------------------
# Sim(3) exp/log (host numpy, float64) — loop-closure drift interpolation
# ---------------------------------------------------------------------------


def _sim3_W_np(omega, sigma):
    """The W matrix of the Sim(3) exponential: t = W @ upsilon.

    Standard closed form (Strasdat, "Local Accuracy and Global
    Consistency for Efficient Visual SLAM", eq. 5.14; public Sophus
    implementation), with Taylor fallbacks near theta = 0 / sigma = 0."""
    import numpy as np

    theta = float(np.linalg.norm(omega))
    s = float(np.exp(sigma))
    Om = np.array([
        [0.0, -omega[2], omega[1]],
        [omega[2], 0.0, -omega[0]],
        [-omega[1], omega[0], 0.0],
    ])
    eps = 1e-8
    if abs(sigma) < eps:
        C = 1.0
        if theta < eps:
            A = 0.5
            B = 1.0 / 6.0
        else:
            A = (1.0 - np.cos(theta)) / theta**2
            B = (theta - np.sin(theta)) / theta**3
    else:
        C = (s - 1.0) / sigma
        if theta < eps:
            A = ((sigma - 1.0) * s + 1.0) / sigma**2
            B = ((0.5 * sigma**2 - sigma + 1.0) * s - 1.0) / sigma**3
        else:
            a = s * np.sin(theta)
            b = s * np.cos(theta)
            c = theta**2 + sigma**2
            A = (a * sigma + (1.0 - b) * theta) / (theta * c)
            B = (C - ((b - 1.0) * sigma + a * theta) / c) / theta**2
    return A * Om + B * (Om @ Om) + C * np.eye(3)


def sim3_log_np(s, R, t):
    """Log map of the similarity x -> s R x + t.  Returns (sigma [1],
    omega [3], upsilon [3])."""
    import numpy as np

    sigma = float(np.log(s))
    # so3 log via quaternion
    q = rotmat_to_quat_np(R)
    v = q[1:]
    nv = np.linalg.norm(v)
    ang = 2.0 * np.arctan2(nv, q[0])
    omega = (v / nv * ang) if nv > 1e-12 else np.zeros(3)
    W = _sim3_W_np(omega, sigma)
    upsilon = np.linalg.solve(W, np.asarray(t, np.float64))
    return sigma, omega, upsilon


def sim3_exp_np(sigma, omega, upsilon):
    """Exp map: returns (s, R, t) of the similarity x -> s R x + t."""
    import numpy as np

    s = float(np.exp(sigma))
    theta = float(np.linalg.norm(omega))
    if theta > 1e-12:
        axis = omega / theta
        half = 0.5 * theta
        q = np.concatenate([[np.cos(half)], np.sin(half) * axis])
    else:
        q = np.array([1.0, 0.0, 0.0, 0.0])
    R = quat_to_rotmat_np(q)
    t = _sim3_W_np(omega, sigma) @ np.asarray(upsilon, np.float64)
    return s, R, t


def sim3_pow_np(s, R, t, w):
    """Fractional power D^w of the similarity D along its one-parameter
    subgroup (screw interpolation) — the natural model for smoothly
    accumulated loop drift."""
    import numpy as np

    sigma, omega, upsilon = sim3_log_np(s, R, t)
    return sim3_exp_np(w * sigma, w * omega, w * upsilon)
