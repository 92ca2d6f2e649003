"""Keyframe selection, keyframe-only global BA (KGBA), ref-frame update.

(reference: Map::KeyFrameSelection src/base/map.cc:428-640,
Map::UpdateByRefFrame :642-663, BASolver::KGBA
src/optimization/ba_solver.cc:640-678)

The reference demotes a keyframe when it is redundant — >= 200
observations of which >= 60% are seen >= 3x by other keyframes — and
re-anchors demoted frames to a covisible keyframe by a stored relative
pose; KGBA then optimizes only the keyframes and propagates.
"""

from __future__ import annotations

from typing import Optional

import jax.numpy as jnp
import numpy as np

from . import ba_glue, triangulate
from ..base.map import SfMMap
from ..optim.ba import BAOptions
from ..utils import geometry as G

# reference thresholds (base/map.cc:428-640)
_MIN_OBS_DEMOTE = 200
_REDUNDANT_RATIO = 0.6
_SEEN_BY_OTHERS = 3


def _ensure_fields(m: SfMMap):
    if not hasattr(m, "is_keyframe"):
        m.is_keyframe = np.ones(m.num_frames, bool)
        m.ref_frame = np.full(m.num_frames, -1, np.int64)
        m.ref_rel_q = np.zeros((m.num_frames, 4))
        m.ref_rel_q[:, 0] = 1.0
        m.ref_rel_t = np.zeros((m.num_frames, 3))
    elif len(m.is_keyframe) < m.num_frames:
        extra = m.num_frames - len(m.is_keyframe)
        m.is_keyframe = np.append(m.is_keyframe, np.ones(extra, bool))
        m.ref_frame = np.append(m.ref_frame, np.full(extra, -1, np.int64))
        q = np.zeros((extra, 4))
        q[:, 0] = 1.0
        m.ref_rel_q = np.vstack([m.ref_rel_q, q])
        m.ref_rel_t = np.vstack([m.ref_rel_t, np.zeros((extra, 3))])


def keyframe_selection(m: SfMMap, sequential: bool = True) -> int:
    """Demote redundant keyframes.  Returns number of demotions.

    Fully batched host path (this runs before EVERY KGBA; the previous
    per-frame loop called covisible_frames — an O(num_obs) scan — for
    every keyframe and dominated KGBA setup at the multi-thousand-frame
    regime):

      * the redundancy ratio test runs for ALL frames at once — two
        bincounts over the COO observation table per round;
      * per-frame work (straddle guard, reference pick) happens only for
        frames that PASS the vectorized test — a handful in steady state;
      * the reference's sequential-demotion semantics (each demotion
        lowers later frames' seen-by-keyframe counts, base/map.cc:428-640)
        are preserved by greedy track-disjoint rounds: within a round a
        frame is demoted only if no earlier demotion this round touched
        its tracks; deferred frames re-test next round under the updated
        counts.  Counts only decrease, so a frame that ever fails the
        ratio test can never pass later — re-testing is safe.

    Includes the reference's step-3 connectivity guard
    (base/map.cc:475-498): a frame may be demoted only if the covisible
    keyframes straddling it stay DIRECTLY connected by >= 200 shared
    observations.  Without it, cascade demotion strips 50-frame bands
    from a 250-frame circuit (measured: 4 disconnected keyframe
    components), which poisons both KGBA and the loop pose graph."""
    _ensure_fields(m)
    n = m.num_obs_slots
    ot = m.obs_track[:n]
    of = m.obs_frame[:n]
    live = (ot >= 0) & m.registered[of]
    ot_l = ot[live]
    of_l = of[live]
    kf_l = m.is_keyframe[of_l]
    per_track_kf = np.bincount(ot_l[kf_l], minlength=m.num_tracks)
    n_obs = np.bincount(of_l, minlength=m.num_frames)
    candidate = m.registered & m.is_keyframe & (n_obs >= _MIN_OBS_DEMOTE)
    for fid in (m.init_id1, m.init_id2):  # reference: map.cc:441-442
        if fid is not None and fid >= 0:
            candidate[fid] = False
    demoted = 0
    while True:
        # ratio test for every frame in one pass
        ind = (per_track_kf[ot_l] - 1) >= _SEEN_BY_OTHERS
        red_cnt = np.bincount(of_l[ind], minlength=m.num_frames)
        passing = np.nonzero(
            candidate & (red_cnt >= _REDUNDANT_RATIO * n_obs)
        )[0]
        if len(passing) == 0:
            break
        touched = np.zeros(m.num_tracks, bool)
        any_demoted = False
        for f in passing:
            f = int(f)
            t = m.track_of[f]
            tids = t[t >= 0]
            if touched[tids].any():
                continue  # counts changed this round — re-test next round
            neigh, _counts = m.covisible_frames(f)
            if sequential and not _straddle_connected(m, f, neigh):
                candidate[f] = False  # single-shot check, as the reference
                continue
            # covisible keyframe with most shared tracks as reference
            ref = -1
            for f2 in neigh:
                if m.is_keyframe[f2] and int(f2) != f:
                    ref = int(f2)
                    break
            if ref < 0:
                candidate[f] = False
                continue
            m.is_keyframe[f] = False
            candidate[f] = False
            m.ref_frame[f] = ref
            _store_rel_pose(m, f, ref)
            np.subtract.at(per_track_kf, tids, 1)
            touched[tids] = True
            demoted += 1
            any_demoted = True
        if not any_demoted:
            break
    # re-anchor existing non-keyframes to current keyframe poses (batched)
    sel = m.registered & ~m.is_keyframe & (m.ref_frame >= 0)
    idx = np.nonzero(sel)[0]
    if len(idx):
        refs = m.ref_frame[idx]
        q_rel, t_rel = G.pose_relative_np(
            m.q[idx], m.t[idx], m.q[refs], m.t[refs]
        )
        m.ref_rel_q[idx] = q_rel
        m.ref_rel_t[idx] = t_rel
    return demoted


def _straddle_connected(m: SfMMap, f: int, neigh=None) -> bool:
    """Reference step-3 guard (base/map.cc:475-498): every consecutive
    pair of covisible keyframes (id1 < f < id2) must share >=
    _MIN_OBS_DEMOTE tracks directly, or demoting f would cut the
    sequential keyframe chain."""
    if neigh is None:
        neigh, _counts = m.covisible_frames(f)
    covis_kf = sorted(
        int(f2) for f2 in neigh if m.is_keyframe[int(f2)] and int(f2) != f
    )
    for id1, id2 in zip(covis_kf, covis_kf[1:]):
        if id1 < f < id2:
            t1 = m.track_of[id1]
            t1 = t1[t1 >= 0]
            t2 = m.track_of[id2]
            t2 = t2[t2 >= 0]
            if len(np.intersect1d(t1, t2)) < _MIN_OBS_DEMOTE:
                return False
    return True


def _store_rel_pose(m: SfMMap, f: int, ref: int):
    # host numpy: no device dispatch per frame
    q_rel, t_rel = G.pose_relative_np(m.q[f], m.t[f], m.q[ref], m.t[ref])
    m.ref_rel_q[f] = q_rel
    m.ref_rel_t[f] = t_rel


def update_by_ref_frame(m: SfMMap, ref_scale=None):
    """Re-anchor non-keyframes after their reference keyframes moved
    (reference: UpdateByRefFrame, base/map.cc:642-663).

    ref_scale (optional, [num_frames]): per-keyframe local map scale
    solved by the scale pose graph (pose_graph.py residual
    r_t = (t_i - R_ij t_j) - s_i * t_hat_ij, mirroring the reference's
    ScaleCost).  The solved keyframe lattice is rescaled by s_i, so the
    stored relative translation to the ref keyframe must be rescaled the
    same way — re-anchoring with the unscaled offset leaves every
    non-keyframe at its pre-correction distance and makes the corrected
    map internally inconsistent (measured: 9.2M reprojection cost that
    120 LM iterations could not undo; the reference equivalently
    re-emits points and frames through the solved scale,
    ba_solver.cc:269-327)."""
    _ensure_fields(m)
    sel = m.registered & ~m.is_keyframe & (m.ref_frame >= 0)
    idx = np.nonzero(sel)[0]
    if len(idx) == 0:
        return
    refs = m.ref_frame[idx]
    s = (
        np.ones((len(idx), 1))
        if ref_scale is None
        else np.asarray(ref_scale)[refs][:, None]
    )
    q, t = G.pose_compose_np(
        m.ref_rel_q[idx], s * m.ref_rel_t[idx], m.q[refs], m.t[refs]
    )
    m.q[idx] = q
    m.t[idx] = t


def motion_only_refine(m: SfMMap, frames, iters: int = 10,
                       huber_px: float = 4.0) -> int:
    """Re-fit the poses of `frames` against the CURRENT structure
    (points fixed) — one vmapped device dispatch for all frames.

    The ref-frame propagation (update_by_ref_frame) re-anchors a
    non-keyframe by its stored relative pose, which is stale by exactly
    the amount KGBA moved the map between two keyframe selections;
    those poses are never in any later keyframe problem, so the error
    accumulates silently (measured: 957k reprojection cost / ~3 px RMS
    on a 247-frame circuit whose keyframe-only cost was at the noise
    floor).  The reference shares this gap (UpdateByRefFrame,
    base/map.cc:642-663); a batched motion-only solve closes it at the
    cost of one dispatch."""
    from . import kernels

    frames = [int(f) for f in frames if m.registered[f]]
    rows = []
    for f in frames:
        t_ids = m.track_of[f]
        p2d = np.nonzero(t_ids >= 0)[0]
        p2d = p2d[m.track_valid[t_ids[p2d]]]
        if len(p2d) >= 6:
            rows.append((f, p2d, t_ids[p2d]))
    if not rows:
        return 0
    B = len(rows)
    N = kernels.bucket(max(len(p) for _, p, _ in rows))
    q = np.zeros((B, 4), np.float32)
    t = np.zeros((B, 3), np.float32)
    uv = np.zeros((B, N, 2), np.float32)
    xyz = np.zeros((B, N, 3), np.float32)
    w = np.zeros((B, N), np.float32)
    hd = np.zeros(B, np.float32)
    for i, (f, p2d, tids) in enumerate(rows):
        n = len(p2d)
        q[i] = m.q[f]
        t[i] = m.t[f]
        uv[i, :n] = m.kps_norm[f][p2d]
        xyz[i, :n] = m.track_xyz[tids]
        w[i, :n] = 1.0
        hd[i] = huber_px / float(m.cameras[int(m.cam_of_frame[f])][0])
    import jax

    q2, t2 = jax.device_get(
        kernels.refine_poses_batch(q, t, uv, xyz, w, hd, iters=iters)
    )
    for i, (f, _, _) in enumerate(rows):
        m.q[f] = np.asarray(q2[i], np.float64)
        m.t[f] = np.asarray(t2[i], np.float64)
    return len(rows)


def kgba(
    m: SfMMap,
    opts: BAOptions = BAOptions(max_iters=20, huber_px=4.0),
    tri_opts: Optional[triangulate.TriOptions] = None,
    optimize_intrinsics: bool = False,
    mesh=None,
):
    """Keyframe global BA + non-keyframe propagation
    (reference: BASolver::KGBA, ba_solver.cc:640-678).  `mesh` routes
    the solve (pose-only or intrinsics-refining) through the sharded LM
    (parallel/dist_ba)."""
    _ensure_fields(m)
    keyframe_selection(m)
    keyframes = [
        f for f in range(m.num_frames) if m.registered[f] and m.is_keyframe[f]
    ]
    if len(keyframes) < 2:
        return None
    res = ba_glue.run_ba(m, keyframes, opts, obs_frames=keyframes,
                         optimize_intrinsics=optimize_intrinsics,
                         mesh=mesh)
    update_by_ref_frame(m)
    # motion-only re-fit of the propagated non-keyframes against the
    # KGBA structure (see motion_only_refine docstring)
    nonkf = [
        f for f in range(m.num_frames)
        if m.registered[f] and not m.is_keyframe[f]
    ]
    motion_only_refine(m, nonkf, huber_px=opts.huber_px)
    # continue tracks BACKWARD into older frames' untracked keypoints
    # (see continue_all_tracks — keeps loop anchors reachable and feeds
    # longer baselines to retriangulation)
    triangulate.continue_all_tracks(m)
    if tri_opts is not None:
        triangulate.filter_tracks(m, None, tri_opts)
    return res
