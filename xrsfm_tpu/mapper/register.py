"""Frame registration: P3P RANSAC + LM refine + track extension.

(reference: RegisterImage, src/geometry/pnp.cc:15-95)
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from . import kernels
from ..base.map import SfMMap


@dataclasses.dataclass
class RegisterOptions:
    # reference: max_error 8px/f, min 100 trials (pnp.cc:253-272)
    ransac_px: float = 8.0
    min_correspondences: int = 20
    min_inlier_ratio: float = 0.25
    num_hypotheses: int = 256
    # Multi-focal registration for per-image cameras with untrusted
    # (EXIF-grade) focals: PnP is solved at every focal scale in the SAME
    # batched dispatch (rows = frames x scales) and the best-supported
    # hypothesis wins; the winning focal is written back to the frame's
    # camera when that camera is exclusive to the frame.  The reference
    # has no counterpart — it trusts EXIF and hopes BA recovers
    # (rec_1dsfm.cc:46-55), which fails when the 8px gate rejects the
    # registration outright under a 5-10% focal error.
    focal_scales: tuple = ()


def register_frame(m: SfMMap, frame: int, opts: RegisterOptions = RegisterOptions(),
                   seed_salt: int = 0):
    """Try to register `frame`.  Returns (success, num_inliers,
    num_candidates).  seed_salt varies the RANSAC key on retries (e.g.
    after an epipolar-inconsistent pose was rejected)."""
    p2d_idx, track_ids = m.search_correspondences(frame)
    n = len(p2d_idx)
    if n < opts.min_correspondences:
        return False, 0, n
    uv = m.kps_norm[frame][p2d_idx]
    xyz = m.track_xyz[track_ids].astype(np.float32)
    b = kernels.bucket(n)
    uvp = kernels.pad_rows(uv, b)
    xyzp = kernels.pad_rows(xyz, b)
    mask = np.zeros(b, bool)
    mask[:n] = True
    focal = float(m.cameras[int(m.cam_of_frame[frame])][0])
    th = (opts.ransac_px / focal) ** 2
    key = jax.random.PRNGKey(((frame + seed_salt * 65537) * 2654435761) & 0x7FFFFFFF)
    # numpy args (the jit transfers them in one dispatch) + one batched
    # result fetch, instead of eager per-array transfers and reads
    out = kernels.pnp_ransac(
        key, uvp, xyzp, mask, th, num_hypotheses=opts.num_hypotheses
    )
    q, t, inl, n_inl, success = jax.device_get(out)
    n_inl = int(n_inl)
    if not bool(success) or n_inl < max(
        opts.min_correspondences, int(opts.min_inlier_ratio * n)
    ):
        return False, n_inl, n
    m.q[frame] = np.asarray(q, np.float64)
    m.t[frame] = np.asarray(t, np.float64)
    m.registered[frame] = True
    _extend_tracks(m, frame, p2d_idx, track_ids, np.asarray(inl)[:n])
    return True, n_inl, n


def _extend_tracks(m: SfMMap, frame: int, p2d_idx, track_ids, inl_np):
    """Attach inlier 2D-3D matches to tracks (reference: pnp.cc:74-95)."""
    ks = np.nonzero(inl_np)[0]
    ks = ks[
        (m.track_of[frame][p2d_idx[ks]] < 0) & m.track_valid[track_ids[ks]]
    ]
    sel = [k for k in ks if frame not in m.track_obs[int(track_ids[k])]]
    if sel:
        m.add_observations(track_ids[sel], frame, p2d_idx[sel])


def register_frames_batch(
    m: SfMMap,
    frames,
    opts: RegisterOptions = RegisterOptions(),
    seed_salts=None,
):
    """Register MANY frames in ONE device dispatch (SURVEY §7.3; the
    reference's loop registers exactly one frame per outer iteration).

    All frames are solved against the SAME map snapshot — correct because
    registration only reads the map; acceptance, pose write-back and
    track extension happen per frame afterwards.  Returns
    {frame: (ok, n_inliers)}."""
    frames = [int(f) for f in frames]
    seed_salts = seed_salts or {}
    corr = {}
    for f in frames:
        p2d_idx, track_ids = m.search_correspondences(f)
        corr[f] = (p2d_idx, track_ids)
    live = [f for f in frames if len(corr[f][0]) >= opts.min_correspondences]
    out = {f: (False, 0, len(corr[f][0])) for f in frames}
    if not live:
        return out
    scales = np.asarray(opts.focal_scales or (1.0,), np.float32)
    S = len(scales)
    B = len(live) * S
    N = kernels.bucket(max(len(corr[f][0]) for f in live))
    uv = np.zeros((B, N, 2), np.float32)
    xyz = np.zeros((B, N, 3), np.float32)
    mask = np.zeros((B, N), bool)
    ths = np.zeros(B, np.float32)
    keys = np.zeros((B, 2), np.uint32)
    for r0, f in enumerate(live):
        p2d_idx, track_ids = corr[f]
        n = len(p2d_idx)
        focal = float(m.cameras[int(m.cam_of_frame[f])][0])
        seed = ((f + seed_salts.get(f, 0) * 65537) * 2654435761) & 0x7FFFFFFF
        for si, s in enumerate(scales):
            r = r0 * S + si
            # focal hypothesis f' = s*f: normalized coords scale by 1/s
            # ((px-c)/f' = uv/s with k=0), and so does the pixel gate
            uv[r, :n] = m.kps_norm[f][p2d_idx] / s
            xyz[r, :n] = m.track_xyz[track_ids]
            mask[r, :n] = True
            ths[r] = (opts.ransac_px / (focal * s)) ** 2
            keys[r] = np.asarray(jax.random.PRNGKey((seed + 97 * si)
                                                    & 0x7FFFFFFF))
    q_b, t_b, inl_b, ninl_b, ok_b = jax.device_get(
        kernels.pnp_ransac_batch(
            keys, uv, xyz, mask, ths, num_hypotheses=opts.num_hypotheses
        )
    )
    for r0, f in enumerate(live):
        p2d_idx, track_ids = corr[f]
        n = len(p2d_idx)
        # winning focal hypothesis: most inliers among accepted rows.  A
        # non-unit scale must beat scale 1.0 by a clear margin (>=15%
        # more inliers): the grid is coarse (~8% steps), so a marginal
        # win would overwrite an EXIF focal that may be closer to truth
        # than the grid resolution.
        best, best_key = -1, None
        ref_inl = 0
        for si in range(S):
            if abs(float(scales[si]) - 1.0) < 1e-6:
                ref_inl = int(ninl_b[r0 * S + si]) if bool(
                    ok_b[r0 * S + si]
                ) else 0
        for si in range(S):
            r = r0 * S + si
            n_inl = int(ninl_b[r])
            acc = bool(ok_b[r]) and n_inl >= max(
                opts.min_correspondences, int(opts.min_inlier_ratio * n)
            )
            if acc and abs(float(scales[si]) - 1.0) > 1e-6:
                acc = n_inl >= 1.15 * max(ref_inl, 1)
            key = (n_inl, -abs(float(scales[si]) - 1.0))
            if acc and (best < 0 or key > best_key):
                best, best_key = r, key
        if best < 0:
            # report the scale-1 row's support for diagnostics
            r1 = r0 * S + int(np.argmin(np.abs(scales - 1.0)))
            out[f] = (False, int(ninl_b[r1]), n)
            continue
        si = best - r0 * S
        s = float(scales[si])
        if s != 1.0:
            cid = int(m.cam_of_frame[f])
            if int(np.count_nonzero(
                m.cam_of_frame[: m.num_frames] == cid
            )) == 1:
                canon = np.asarray(m.cameras[cid], np.float64).copy()
                canon[0] *= s
                canon[1] *= s
                m.update_camera(cid, canon)  # refreshes kps_norm[f]
        m.q[f] = np.asarray(q_b[best], np.float64)
        m.t[f] = np.asarray(t_b[best], np.float64)
        m.registered[f] = True
        _extend_tracks(m, f, p2d_idx, track_ids, np.asarray(inl_b[best])[:n])
        out[f] = (True, int(ninl_b[best]), n)
    return out
