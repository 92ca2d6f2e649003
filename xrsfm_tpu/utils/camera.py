"""Batched COLMAP-compatible camera models.

Re-design of the reference's camera model layer
(reference: src/base/camera_model.hpp:93-286, src/base/camera.hpp:10-108).

The reference dispatches over 5 intrinsic models with an X-macro
(CAMERA_MODEL_CASES).  Here every model is canonicalized at load time into a
single 8-float layout ``(fx, fy, cx, cy, k1, k2, p1, p2)`` — all five COLMAP
models (SIMPLE_PINHOLE=0, PINHOLE=1, SIMPLE_RADIAL=2, RADIAL=3, OPENCV=4) are
sub-models of OPENCV — so the device code path is branch-free and batches over
thousands of per-image cameras (the 1DSfM case) with no lax.switch.

Undistortion is a fixed-iteration Newton solve with the analytic 2x2 Jacobian
(the reference uses 100 Newton steps with central differences,
camera_model.hpp:8-55; the analytic Jacobian converges in <=10).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

# COLMAP model ids
SIMPLE_PINHOLE = 0
PINHOLE = 1
SIMPLE_RADIAL = 2
RADIAL = 3
OPENCV = 4

MODEL_NUM_PARAMS = {
    SIMPLE_PINHOLE: 3,
    PINHOLE: 4,
    SIMPLE_RADIAL: 4,
    RADIAL: 5,
    OPENCV: 8,
}
MODEL_NAMES = {
    SIMPLE_PINHOLE: "SIMPLE_PINHOLE",
    PINHOLE: "PINHOLE",
    SIMPLE_RADIAL: "SIMPLE_RADIAL",
    RADIAL: "RADIAL",
    OPENCV: "OPENCV",
}
MODEL_IDS = {v: k for k, v in MODEL_NAMES.items()}


def canonicalize_params(model_id: int, params) -> np.ndarray:
    """Raw COLMAP param vector -> canonical (fx, fy, cx, cy, k1, k2, p1, p2)."""
    p = np.asarray(params, dtype=np.float64)
    out = np.zeros(8, dtype=np.float64)
    if model_id == SIMPLE_PINHOLE:
        out[:4] = [p[0], p[0], p[1], p[2]]
    elif model_id == PINHOLE:
        out[:4] = p[:4]
    elif model_id == SIMPLE_RADIAL:
        out[:4] = [p[0], p[0], p[1], p[2]]
        out[4] = p[3]
    elif model_id == RADIAL:
        out[:4] = [p[0], p[0], p[1], p[2]]
        out[4:6] = p[3:5]
    elif model_id == OPENCV:
        out[:] = p[:8]
    else:
        raise ValueError(f"unsupported camera model id {model_id}")
    return out


_FREE_ENTRIES = {
    # canonical-tangent entries the raw COLMAP model actually has
    # (reference GBA frees the model's whole param vector,
    # ba_solver.cc:330-356): 0=log fx, 1=log fy, 2=cx, 3=cy, 4..7=k1 k2 p1 p2
    SIMPLE_PINHOLE: [0, 2, 3],
    PINHOLE: [0, 1, 2, 3],
    SIMPLE_RADIAL: [0, 2, 3, 4],
    RADIAL: [0, 2, 3, 4, 5],
    OPENCV: [0, 1, 2, 3, 4, 5, 6, 7],
}
_TIED_FOCAL = {SIMPLE_PINHOLE, SIMPLE_RADIAL, RADIAL}


def intri_free_mask(model_id: int):
    """(free [8] bool, tie_f bool) for BA intrinsics refinement: which
    canonical-tangent entries are free for this COLMAP model, and whether
    fx/fy are a single tied focal."""
    free = np.zeros(8, bool)
    free[_FREE_ENTRIES[model_id]] = True
    return free, model_id in _TIED_FOCAL


def raw_params(model_id: int, canon: np.ndarray) -> np.ndarray:
    """Canonical 8-vector -> raw COLMAP param vector (for I/O round trip)."""
    c = np.asarray(canon, dtype=np.float64)
    if model_id == SIMPLE_PINHOLE:
        return np.array([c[0], c[2], c[3]])
    if model_id == PINHOLE:
        return c[:4].copy()
    if model_id == SIMPLE_RADIAL:
        return np.array([c[0], c[2], c[3], c[4]])
    if model_id == RADIAL:
        return np.array([c[0], c[2], c[3], c[4], c[5]])
    if model_id == OPENCV:
        return c[:8].copy()
    raise ValueError(f"unsupported camera model id {model_id}")


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Cameras:
    """SoA batch of cameras: canonical params [N, 8] + model ids [N]."""

    params: jax.Array  # [N, 8] (fx, fy, cx, cy, k1, k2, p1, p2)
    model_id: jax.Array  # [N] int32, kept for I/O round-trip
    width: jax.Array  # [N] int32 (0 if unknown)
    height: jax.Array  # [N] int32

    @property
    def focal(self) -> jax.Array:
        return 0.5 * (self.params[..., 0] + self.params[..., 1])


def distort(params: jax.Array, uv: jax.Array) -> jax.Array:
    """Apply (k1, k2, p1, p2) distortion to normalized coords uv [..., 2].

    params broadcasts against uv's batch shape; params[..., 4:8] are used.
    """
    k1, k2, p1, p2 = (params[..., 4], params[..., 5], params[..., 6], params[..., 7])
    u, v = uv[..., 0], uv[..., 1]
    u2, v2 = u * u, v * v
    r2 = u2 + v2
    radial = k1 * r2 + k2 * r2 * r2
    du = u * radial + 2 * p1 * u * v + p2 * (r2 + 2 * u2)
    dv = v * radial + 2 * p2 * u * v + p1 * (r2 + 2 * v2)
    return jnp.stack([u + du, v + dv], axis=-1)


def distort_jacobian(params: jax.Array, uv: jax.Array) -> jax.Array:
    """Analytic 2x2 Jacobian of `distort` wrt uv.  Returns [..., 2, 2]."""
    k1, k2, p1, p2 = (params[..., 4], params[..., 5], params[..., 6], params[..., 7])
    u, v = uv[..., 0], uv[..., 1]
    u2, v2 = u * u, v * v
    r2 = u2 + v2
    radial = k1 * r2 + k2 * r2 * r2
    drad_du = 2 * u * (k1 + 2 * k2 * r2)
    drad_dv = 2 * v * (k1 + 2 * k2 * r2)
    j00 = 1 + radial + u * drad_du + 2 * p1 * v + 6 * p2 * u
    j01 = u * drad_dv + 2 * p1 * u + 2 * p2 * v
    j10 = v * drad_du + 2 * p2 * v + 2 * p1 * u
    j11 = 1 + radial + v * drad_dv + 2 * p2 * u + 6 * p1 * v
    J = jnp.stack([j00, j01, j10, j11], axis=-1)
    return J.reshape(J.shape[:-1] + (2, 2))


def _undistort_step(xp, params, uv, x):
    """One Newton step of `undistort`, for xp in (jnp, np)."""
    k1, k2, p1, p2 = (params[..., 4], params[..., 5], params[..., 6], params[..., 7])
    u, v = x[..., 0], x[..., 1]
    u2, v2 = u * u, v * v
    r2 = u2 + v2
    r4 = r2 * r2
    radial = k1 * r2 + k2 * r4
    fu = u + u * radial + 2 * p1 * u * v + p2 * (r2 + 2 * u2) - uv[..., 0]
    fv = v + v * radial + 2 * p2 * u * v + p1 * (r2 + 2 * v2) - uv[..., 1]
    # analytic Jacobian of the distortion map
    drad_du = 2 * u * (k1 + 2 * k2 * r2)
    drad_dv = 2 * v * (k1 + 2 * k2 * r2)
    j00 = 1 + radial + u * drad_du + 2 * p1 * v + 6 * p2 * u
    j01 = u * drad_dv + 2 * p1 * u + 2 * p2 * v
    j10 = v * drad_du + 2 * p2 * v + 2 * p1 * u
    j11 = 1 + radial + v * drad_dv + 2 * p2 * u + 6 * p1 * v
    det = j00 * j11 - j01 * j10
    det = xp.where(xp.abs(det) < 1e-12, 1.0, det)
    du_ = (j11 * fu - j01 * fv) / det
    dv_ = (j00 * fv - j10 * fu) / det
    return xp.stack([x[..., 0] - du_, x[..., 1] - dv_], axis=-1)


def undistort(params: jax.Array, uv: jax.Array, iters: int = 10) -> jax.Array:
    """Invert `distort`: find x with distort(x) = uv.  Fixed-iteration Newton
    with analytic 2x2 Jacobian (reference: IterativeUndistortion,
    src/base/camera_model.hpp:8-55)."""
    return jax.lax.fori_loop(
        0, iters, lambda _, x: _undistort_step(jnp, params, uv, x), uv
    )


def normalized_to_image(params: jax.Array, uv: jax.Array) -> jax.Array:
    """Distorted projection: normalized camera coords -> pixels.
    (reference: NormalizedToImage, src/base/camera.hpp:92-108)."""
    d = distort(params, uv)
    fx, fy, cx, cy = (params[..., 0], params[..., 1], params[..., 2], params[..., 3])
    return jnp.stack([fx * d[..., 0] + cx, fy * d[..., 1] + cy], axis=-1)


def image_to_normalized(params: jax.Array, xy: jax.Array, iters: int = 10) -> jax.Array:
    """Pixels -> undistorted normalized camera coords.
    (reference: ImageToNormalized, src/base/camera.hpp:78-90)."""
    fx, fy, cx, cy = (params[..., 0], params[..., 1], params[..., 2], params[..., 3])
    uv = jnp.stack([(xy[..., 0] - cx) / fx, (xy[..., 1] - cy) / fy], axis=-1)
    return undistort(params, uv, iters=iters)


def image_to_normalized_np(params, xy, iters: int = 10) -> np.ndarray:
    """Host (numpy float32) twin of `image_to_normalized`, for map
    bookkeeping that should not dispatch device work per frame."""
    params = np.asarray(params, np.float32)
    xy = np.asarray(xy, np.float32)
    uv = np.stack([(xy[..., 0] - params[..., 2]) / params[..., 0],
                   (xy[..., 1] - params[..., 3]) / params[..., 1]], axis=-1)
    x = uv
    for _ in range(iters):
        x = _undistort_step(np, params, uv, x).astype(np.float32)
    return x


def project(params: jax.Array, q: jax.Array, t: jax.Array, xyz: jax.Array):
    """World points -> pixels through pose Tcw (q, t) and intrinsics.

    Returns (xy [..., 2], depth [...]).
    """
    from . import geometry as G

    pc = G.pose_apply(q, t, xyz)
    z = pc[..., 2]
    zsafe = jnp.where(jnp.abs(z) < 1e-9, 1e-9, z)
    uv = pc[..., :2] / zsafe[..., None]
    return normalized_to_image(params, uv), z


def make_cameras(model_ids, params_list, widths=None, heights=None) -> Cameras:
    """Host-side constructor from raw COLMAP params."""
    n = len(model_ids)
    canon = np.zeros((n, 8), dtype=np.float64)
    for i, (m, p) in enumerate(zip(model_ids, params_list)):
        canon[i] = canonicalize_params(int(m), p)
    w = np.zeros(n, np.int32) if widths is None else np.asarray(widths, np.int32)
    h = np.zeros(n, np.int32) if heights is None else np.asarray(heights, np.int32)
    return Cameras(
        params=jnp.asarray(canon, jnp.float32),
        model_id=jnp.asarray(np.asarray(model_ids, np.int32)),
        width=jnp.asarray(w),
        height=jnp.asarray(h),
    )
