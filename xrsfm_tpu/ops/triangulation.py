"""Batched DLT triangulation (2-view and N-view).

Batched equivalent of the reference's SVD triangulation
(reference: src/geometry/triangluate_svd.cc:8-73 and
src/geometry/colmap/base/triangulation.cc:40-160).  The homogeneous DLT
nullspace is found with eigh(A^T A) — symmetric eigendecomposition is
batched and fast on accelerators, unlike general SVD of tall matrices —
and N-view problems use a mask so a fixed-width observation block
triangulates variable track lengths.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..utils import geometry as G


def _dlt_point(A: jax.Array) -> jax.Array:
    """Smallest right-singular vector of A [..., m, 4] via eigh(A^T A)."""
    AtA = jnp.einsum("...mi,...mj->...ij", A, A)
    _, vecs = jnp.linalg.eigh(AtA)
    h = vecs[..., :, 0]  # eigenvector of smallest eigenvalue
    w = h[..., 3]
    w = jnp.where(jnp.abs(w) < 1e-12, jnp.where(w < 0, -1e-12, 1e-12), w)
    return h[..., :3] / w[..., None]


def _proj_rows(q, t, uv):
    """Two DLT rows for one observation: uv [..., 2] normalized coords,
    pose Tcw (q [...,4], t [...,3]).  Returns [..., 2, 4]."""
    R = G.quat_to_rotmat(q)
    P = jnp.concatenate([R, t[..., :, None]], axis=-1)  # [..., 3, 4]
    r0 = uv[..., 0:1, None] * P[..., 2:3, :] - P[..., 0:1, :]
    r1 = uv[..., 1:2, None] * P[..., 2:3, :] - P[..., 1:2, :]
    return jnp.concatenate([r0, r1], axis=-2)


def triangulate_two_view(q1, t1, uv1, q2, t2, uv2) -> jax.Array:
    """2-view DLT.  All args broadcast over leading batch dims; uv are
    undistorted normalized camera coordinates.  Returns world points [..., 3].
    (reference: triangulate_point, src/geometry/triangluate_svd.cc:32-41)."""
    A = jnp.concatenate(
        [_proj_rows(q1, t1, uv1), _proj_rows(q2, t2, uv2)], axis=-2
    )
    return _dlt_point(A)


def triangulate_multiview(q, t, uv, mask) -> jax.Array:
    """N-view DLT with observation mask.

    q [..., V, 4], t [..., V, 3], uv [..., V, 2] normalized, mask [..., V].
    Invalid observations contribute zero rows.  Returns [..., 3].
    (reference: TriangulateMultiViewPoint,
    src/geometry/colmap/base/triangulation.cc:74-87)."""
    rows = _proj_rows(q, t, uv)  # [..., V, 2, 4]
    rows = rows * mask[..., None, None]
    A = rows.reshape(rows.shape[:-3] + (-1, 4))
    return _dlt_point(A)


def reprojection_errors(q, t, uv, xyz) -> jax.Array:
    """Squared reprojection error in the normalized plane.

    q [..., 4], t [..., 3], uv [..., 2] normalized obs, xyz [..., 3] world.
    """
    pc = G.pose_apply(q, t, xyz)
    z = pc[..., 2]
    zsafe = jnp.where(jnp.abs(z) < 1e-9, 1e-9, z)
    proj = pc[..., :2] / zsafe[..., None]
    err = jnp.sum((proj - uv) ** 2, axis=-1)
    # negative depth => effectively infinite error (cheirality)
    return jnp.where(z > 0, err, jnp.inf)


def depths(q, t, xyz) -> jax.Array:
    return G.pose_apply(q, t, xyz)[..., 2]


def triangulation_angle(center1, center2, xyz) -> jax.Array:
    """Ray-ray angle at the 3D point, radians.
    (reference: CalculateTriangulationAngle,
    src/geometry/triangluate_svd.cc:8-30)."""
    return G.angle_between_rays(center1 - xyz, center2 - xyz)
