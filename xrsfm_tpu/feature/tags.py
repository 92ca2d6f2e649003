"""AprilTag detection + metric scale estimation.

(reference: src/tag/tag_extract.hpp:33-277 + src/estimate_scale.cc —
apriltag C library detection, RANSAC corner triangulation
(CreatePoint3dRAW), then two Ceres solves: per-tag similarity pose +
global scale against the canonical tag square (TagCost,
cost_factor_ceres.h:223-260), and a joint refine with projection
residuals; finally all poses/points are divided by the scale.)

Host-side detection uses cv2.aruco's AprilTag 36h11 dictionary (the
reference also treats detection as host CPU preprocessing — SURVEY.md
§2.8); corner triangulation and the scale solve run on device.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from ..base.map import SfMMap
from ..ops.umeyama import umeyama


def canonical_corners(tag_length: float) -> np.ndarray:
    """Corner layout of a tag of side `tag_length`, centered at origin,
    in detection corner order (cv2.aruco: TL, TR, BR, BL)."""
    h = tag_length / 2.0
    return np.array(
        [[-h, h, 0.0], [h, h, 0.0], [h, -h, 0.0], [-h, -h, 0.0]], np.float64
    )


def detect_tags(image) -> Dict[int, np.ndarray]:
    """Detect AprilTag 36h11 markers.  Returns tag_id -> [4, 2] pixel
    corners (reference: tag_extract, tag_extract.hpp:33-57).  Needs
    OpenCV's aruco module (cv2), which the rest of the pipeline does not."""
    try:
        import cv2
    except ImportError:
        raise ImportError(
            "AprilTag detection (estimate_scale) needs OpenCV (cv2), "
            "which is not installed") from None

    img = np.asarray(image)
    if img.ndim == 3:
        img = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)
    d = cv2.aruco.getPredefinedDictionary(cv2.aruco.DICT_APRILTAG_36h11)
    det = cv2.aruco.ArucoDetector(d, cv2.aruco.DetectorParameters())
    corners, ids, _ = det.detectMarkers(img)
    out = {}
    if ids is not None:
        for c, i in zip(corners, ids.flatten()):
            out[int(i)] = c.reshape(4, 2).astype(np.float64)
    return out


def triangulate_tag_corners(
    m: SfMMap,
    detections: Dict[int, Dict[int, np.ndarray]],
    th_px: float = 8.0,
) -> Dict[int, np.ndarray]:
    """detections: frame_id -> {tag_id -> [4,2] pixels}.

    Triangulates each observed tag corner from all registered frames
    seeing it (reference: CreatePoint3dRAW, track_processor.cc:682-730).
    Returns tag_id -> [4, 3] triangulated corners (NaN rows when a corner
    could not be triangulated)."""
    import jax.numpy as jnp

    from ..mapper import kernels
    from ..utils import camera as Cam

    # group observations per (tag, corner)
    obs: Dict[Tuple[int, int], List[Tuple[int, np.ndarray]]] = {}
    for fid, tags in detections.items():
        if not m.registered[fid]:
            continue
        for tag_id, corners in tags.items():
            for k in range(4):
                obs.setdefault((tag_id, k), []).append((fid, corners[k]))

    keys = [k for k, v in obs.items() if len(v) >= 2]
    if not keys:
        return {}
    V = max(len(obs[k]) for k in keys)
    V = min(max(V, 2), 16)
    B = kernels.bucket(len(keys), lo=8)
    q = np.zeros((B, V, 4), np.float32)
    q[..., 0] = 1.0
    t = np.zeros((B, V, 3), np.float32)
    uv = np.zeros((B, V, 2), np.float32)
    mask = np.zeros((B, V), bool)
    for i, key in enumerate(keys):
        for j, (fid, px) in enumerate(obs[key][:V]):
            params = jnp.asarray(m.cameras[int(m.cam_of_frame[fid])], jnp.float32)
            uvn = np.asarray(Cam.image_to_normalized(params, jnp.asarray(px, jnp.float32)))
            q[i, j] = m.q[fid]
            t[i, j] = m.t[fid]
            uv[i, j] = uvn
            mask[i, j] = True
    focal = float(next(iter(m.cameras.values()))[0])
    xyz, obs_ok, ok, ang = kernels.robust_triangulate(
        jnp.asarray(q), jnp.asarray(t), jnp.asarray(uv), jnp.asarray(mask),
        (th_px / focal) ** 2, 0.0,
    )
    xyz = np.asarray(xyz)
    ok = np.asarray(ok)
    out: Dict[int, np.ndarray] = {}
    for i, (tag_id, k) in enumerate(keys):
        if tag_id not in out:
            out[tag_id] = np.full((4, 3), np.nan)
        if ok[i]:
            out[tag_id][k] = xyz[i]
    return out


def estimate_scale_from_corners(
    tag_corners: Dict[int, np.ndarray], tag_length: float
) -> Tuple[float, Dict[int, Tuple[np.ndarray, np.ndarray]]]:
    """Fit per-tag similarity transforms of the canonical square to the
    triangulated corners; the shared scale s maps meters -> reconstruction
    units.  Returns (s, {tag_id: (R, t)}).

    (reference solves this jointly with Ceres, tag_extract.hpp:199-234;
    with all four corners triangulated the per-tag Umeyama fit is the
    closed-form least squares of the same residual.)"""
    canon = canonical_corners(tag_length)
    scales = []
    poses = {}
    for tag_id, corners in tag_corners.items():
        good = ~np.isnan(corners[:, 0])
        if good.sum() < 3:
            continue
        s, R, t = umeyama(canon[good], corners[good], with_scale=True)
        if s <= 0:
            continue
        scales.append(s)
        poses[tag_id] = (R, t)
    if not scales:
        return 0.0, {}
    return float(np.median(scales)), poses


def joint_refine_scale(
    m: SfMMap,
    detections: Dict[int, Dict[int, np.ndarray]],
    tag_corners: Dict[int, np.ndarray],
    scale0: float,
    poses0: Dict[int, Tuple[np.ndarray, np.ndarray]],
    tag_length: float,
    iters: int = 40,
) -> float:
    """Joint refinement pass (reference: the SECOND Ceres solve of
    tag_refine, tag_extract.hpp:237-265): with camera poses FIXED,
    jointly optimize {per-tag pose, global log-scale, tag corner world
    points} under (a) the reprojection of every corner observation and
    (b) the tag-shape residual corner - s*(R_tag c_k + t_tag).  The
    closed-form per-tag Umeyama fit reads only the triangulated corners;
    re-estimating the corners against ALL observations averages their
    triangulation noise into the scale.  Dense LM (state is tiny:
    19 dofs per tag + 1).  Returns the refined scale."""
    import jax
    import jax.numpy as jnp

    from ..utils import camera as Cam
    from ..utils import geometry as G

    tag_ids = [t for t in sorted(tag_corners) if t in poses0
               and not np.any(np.isnan(tag_corners[t]))]
    if not tag_ids:
        return scale0
    T = len(tag_ids)
    canon = canonical_corners(tag_length)  # [4,3]

    # observation table: corner world-point index [O], fixed pose [O],
    # normalized uv [O,2]
    rows_q, rows_t, rows_uv, rows_pt = [], [], [], []
    for fid, tags in detections.items():
        if not m.registered[fid]:
            continue
        params = m.cameras[int(m.cam_of_frame[fid])]
        for ti, tag_id in enumerate(tag_ids):
            if tag_id not in tags:
                continue
            uvn = np.asarray(
                Cam.image_to_normalized(
                    jnp.asarray(params, jnp.float32),
                    jnp.asarray(tags[tag_id], jnp.float32),
                )
            )
            for k in range(4):
                rows_q.append(m.q[fid])
                rows_t.append(m.t[fid])
                rows_uv.append(uvn[k])
                rows_pt.append(ti * 4 + k)
    if not rows_pt:
        return scale0
    obs_q = jnp.asarray(np.stack(rows_q), jnp.float32)
    obs_t = jnp.asarray(np.stack(rows_t), jnp.float32)
    obs_uv = jnp.asarray(np.stack(rows_uv), jnp.float32)
    obs_pt = jnp.asarray(np.asarray(rows_pt, np.int32))

    # initial state: corners from triangulation, tag poses from the
    # closed-form fit (R, t are in world units; the shape residual maps
    # canon meters through s)
    x_pts0 = np.stack([tag_corners[t] for t in tag_ids]).reshape(-1, 3)
    q_tag0 = np.stack(
        [G.rotmat_to_quat_np(poses0[t][0]) for t in tag_ids]
    )
    t_tag0 = np.stack([poses0[t][1] for t in tag_ids]) / max(scale0, 1e-9)
    canon_j = jnp.asarray(canon, jnp.float32)

    def unflatten(x):
        # [T*4*3 pts][T*3 rotvec][T*3 t][1 log_s]
        n1 = T * 12
        pts = x[:n1].reshape(T * 4, 3)
        w = x[n1: n1 + T * 3].reshape(T, 3)
        tt = x[n1 + T * 3: n1 + T * 6].reshape(T, 3)
        log_s = x[-1]
        return pts, w, tt, log_s

    q_tag0_j = jnp.asarray(q_tag0, jnp.float32)
    # shape residual is world-unit sized while reprojection is
    # normalized-plane sized; weight it in tag-size units and strongly —
    # tags are rigid, so the shape term should act near-hard and the
    # scale be driven by the reprojections through it
    w_shape = 10.0 / max(scale0 * tag_length, 1e-9)

    def residuals(x):
        pts, w, tt, log_s = unflatten(x)
        s = jnp.exp(log_s)
        # reprojection of corner world points through fixed poses
        pc = G.quat_rotate(obs_q, pts[obs_pt]) + obs_t
        z = jnp.where(jnp.abs(pc[:, 2]) < 1e-9, 1e-9, pc[:, 2])
        r_proj = pc[:, :2] / z[:, None] - obs_uv
        # tag shape: corner - s*(R c + t) for each tag/corner
        q_tag = G.quat_mul(q_tag0_j, jax.vmap(G.so3_exp_quat)(w))
        shape = s * (
            jax.vmap(
                lambda qq, ttt: G.quat_rotate(qq[None], canon_j) + ttt[None]
            )(q_tag, tt).reshape(T * 4, 3)
        )
        r_shape = (pts - shape) * w_shape
        return jnp.concatenate([r_proj.reshape(-1), r_shape.reshape(-1)])

    x0 = jnp.asarray(
        np.concatenate(
            [
                x_pts0.reshape(-1),
                np.zeros(T * 3),
                t_tag0.reshape(-1),
                [np.log(max(scale0, 0.2))],
            ]
        ),
        jnp.float32,
    )

    @jax.jit
    def solve(x0):
        def cost(x):
            r = residuals(x)
            return jnp.sum(r * r)

        def body(carry, _):
            x, lam, c = carry
            J = jax.jacfwd(residuals)(x)
            r = residuals(x)
            H = J.T @ J
            g = J.T @ r
            A = H + lam * jnp.diag(jnp.diag(H)) + 1e-9 * jnp.eye(len(x))
            dx = -jnp.linalg.solve(A, g)
            x2 = x + dx
            c2 = cost(x2)
            better = c2 < c
            return (
                jnp.where(better, x2, x),
                jnp.clip(jnp.where(better, lam * 0.5, lam * 4.0), 1e-10, 1e8),
                jnp.where(better, c2, c),
            ), None

        (x, _, c), _ = jax.lax.scan(
            body, (x0, jnp.float32(1e-4), cost(x0)), None, length=iters
        )
        return x, c

    x, _ = solve(x0)
    log_s = float(np.asarray(x)[-1])
    return float(np.exp(np.clip(log_s, np.log(0.2), 20.0)))


def apply_metric_scale(m: SfMMap, scale: float):
    """Divide all translations and points by the scale so one unit = one
    meter (reference: tag_extract.hpp:269-276)."""
    m.t /= scale
    m.track_xyz[: m.num_tracks] /= scale
