"""Bridge between the host-side SfMMap and the device BA solver.

Builds padded BAProblem pytrees for local / global bundle adjustment and
writes optimized poses/points back (reference equivalents:
BASolver::GBA/LBA set-up, src/optimization/ba_solver.cc:358-638).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import jax.numpy as jnp
import numpy as np

from . import kernels
from ..base.map import SfMMap
from ..optim.ba import BAOptions, BAProblem, pack_camera_major, solve_ba


@dataclasses.dataclass
class BAGlueResult:
    frame_ids: np.ndarray
    track_ids: np.ndarray
    initial_cost: float
    final_cost: float
    iters: int
    # live (non-padding) observation count of the solved problem — lets
    # callers compare robust cost ACROSS solves as cost-per-observation
    # (the trial-polish accept gate in mapper/incremental.py)
    n_obs: int = 0


def _collect(m: SfMMap, opt_frames: Sequence[int], obs_frames=None):
    """Vectorized over the map's flat COO observation table."""
    n = m.num_obs_slots
    ot = m.obs_track[:n]
    of_ = m.obs_frame[:n]
    op_ = m.obs_p2d[:n]
    live = ot >= 0
    live = live & m.track_valid[np.clip(ot, 0, None)]

    opt_mask = np.zeros(m.num_frames, bool)
    opt_mask[np.asarray(list(opt_frames), np.int64)] = True
    # tracks seen by any opt frame
    tr_mask = np.zeros(m.num_tracks, bool)
    sel = live & opt_mask[of_]
    tr_mask[ot[sel]] = True
    rows = live & tr_mask[np.clip(ot, 0, None)]
    if obs_frames is not None:
        allowed = np.zeros(m.num_frames, bool)
        allowed[np.asarray(list(obs_frames), np.int64)] = True
        rows &= allowed[of_]
    ot, of_, op_ = ot[rows], of_[rows], op_[rows]
    frames = np.unique(
        np.concatenate([of_, np.asarray(list(opt_frames), np.int64)])
    )
    tracks = np.unique(ot)
    return frames, tracks, (of_, ot, op_)


def build_problem(
    m: SfMMap,
    opt_frames: Sequence[int],
    fix_all_poses: bool = False,
    gauge_frames: Optional[Sequence[int]] = None,
    obs_frames: Optional[Sequence[int]] = None,
    freeze_tracks: Optional[np.ndarray] = None,
    freeze_rotations: bool = False,
):
    """Build a padded BAProblem.  Frames not in opt_frames (but observing
    shared tracks) enter with frozen poses — the reference holds non-local
    frames constant in LBA the same way (ba_solver.cc:358-391).
    obs_frames restricts which frames contribute observations (KGBA uses
    keyframes only, ba_solver.cc:640-678)."""
    frames, tracks, (row_f, row_t, row_p) = _collect(m, opt_frames, obs_frames)
    n_obs = len(row_f)
    if n_obs == 0:
        return None, None, None, None, 0

    C = kernels.bucket(len(frames), lo=8)
    P = kernels.bucket(len(tracks), lo=64)
    O = kernels.bucket(n_obs, lo=256)

    cam_q = np.zeros((C, 4), np.float32)
    cam_q[:, 0] = 1.0
    cam_t = np.zeros((C, 3), np.float32)
    cam_intri = np.zeros((C, 8), np.float32)
    cam_intri[:, :2] = 1.0
    fix_cam = np.ones(C, bool)  # padding cameras frozen
    fix_trans = np.zeros(C, bool)
    nf = len(frames)
    cam_q[:nf] = m.q[frames]
    cam_t[:nf] = m.t[frames]
    cam_table = {cid: p for cid, p in m.cameras.items()}
    cam_intri[:nf] = np.stack(
        [cam_table[int(m.cam_of_frame[f])] for f in frames]
    )
    opt_mask = np.zeros(m.num_frames, bool)
    opt_mask[np.asarray(list(opt_frames), np.int64)] = True
    fix_cam[:nf] = fix_all_poses | ~opt_mask[frames]

    # intrinsics metadata: intrinsic blocks shared per physical camera id
    # (reference GBA frees camera_param per Camera, ba_solver.cc:330-356);
    # padding blocks fully frozen.  Ignored by pose-only solves.
    from ..utils import camera as Cam

    cam_kam = np.arange(C, dtype=np.int32)
    fix_intri = np.ones((C, 8), bool)
    tie_f = np.zeros(C, bool)
    cam_ids_of_frames = m.cam_of_frame[frames]
    uniq_cids, kam_of_frame = np.unique(cam_ids_of_frames, return_inverse=True)
    cam_kam[:nf] = kam_of_frame
    for cid in uniq_cids:
        model_id = m.camera_models[int(cid)][0]
        free, tie = Cam.intri_free_mask(model_id)
        rows = np.nonzero(cam_ids_of_frames == cid)[0]
        fix_intri[rows] = ~free
        tie_f[rows] = tie

    points = np.zeros((P, 3), np.float32)
    fix_pt = np.ones(P, bool)
    nt = len(tracks)
    points[:nt] = m.track_xyz[tracks]
    fix_pt[:nt] = (
        freeze_tracks[tracks] if freeze_tracks is not None else False
    )

    fmap_arr = frames  # sorted unique
    obs_cam = np.zeros(O, np.int32)
    obs_pt = np.zeros(O, np.int32)
    obs_uv = np.zeros((O, 2), np.float32)
    obs_w = np.zeros(O, np.float32)
    obs_cam[:n_obs] = np.searchsorted(frames, row_f)
    obs_pt[:n_obs] = np.searchsorted(tracks, row_t)
    # gather pixel observations per frame (vectorized within each frame)
    uv = np.empty((n_obs, 2), np.float32)
    order = np.argsort(row_f, kind="stable")
    rf_s, rp_s = row_f[order], row_p[order]
    starts = np.r_[0, np.nonzero(rf_s[1:] != rf_s[:-1])[0] + 1, n_obs]
    for s, e in zip(starts[:-1], starts[1:]):
        uv[order[s:e]] = m.kps[int(rf_s[s])][rp_s[s:e]]
    obs_uv[:n_obs] = uv
    obs_w[:n_obs] = 1.0

    # gauge: if nothing is frozen yet, freeze the gauge frames' translations
    # and the first gauge frame fully (reference GBA freezes the init-pair
    # translations, ba_solver.cc:610-614)
    if not fix_all_poses and not np.any(fix_cam[:nf]):
        fidx = {int(f): i for i, f in enumerate(frames)}
        gf = [int(f) for f in (gauge_frames or []) if int(f) in fidx]
        if len(gf) < 2:
            # fall back: two frames with most observations
            cnts = np.bincount(obs_cam[:n_obs], minlength=C)
            gf = [int(frames[int(i)]) for i in np.argsort(-cnts)[:2]]
        fix_cam[fidx[gf[0]]] = True
        for f in gf[1:2]:
            fix_trans[fidx[f]] = True

    # numpy leaves throughout: the solve_ba jit transfers them in one
    # dispatch instead of one eager transfer per array
    prob = BAProblem(
        cam_q=cam_q,
        cam_t=cam_t,
        cam_intri=cam_intri,
        points=points,
        obs_uv=obs_uv,
        obs_cam=obs_cam,
        obs_pt=obs_pt,
        obs_w=obs_w,
        fix_cam=fix_cam,
        fix_trans=fix_trans,
        fix_pt=fix_pt,
        cam_kam=cam_kam,
        fix_intri=fix_intri,
        tie_f=tie_f,
        # rotation-only freeze: a settling solve can keep globally-
        # averaged rotations while translations/points re-fit
        fix_rot=np.ones(C, bool) if freeze_rotations else None,
    )
    # camera-major packing: camera-side ELL gathers become reshapes
    prob, ell = pack_camera_major(prob, n_valid=n_obs)
    return prob, frames, tracks, ell, n_obs


# per-phase wall accumulators for run_ba (read by scripts/e2e_bench.py
# and profiling experiments; reset by zeroing the dict values)
PROF = {"build": 0.0, "solve_fetch": 0.0, "writeback": 0.0, "calls": 0,
        "shapes": set()}


def run_ba(
    m: SfMMap,
    opt_frames: Sequence[int],
    opts: BAOptions = BAOptions(),
    fix_all_poses: bool = False,
    obs_frames: Optional[Sequence[int]] = None,
    optimize_intrinsics: bool = False,
    freeze_tracks: Optional[np.ndarray] = None,
    freeze_rotations: bool = False,
    mesh=None,
) -> Optional[BAGlueResult]:
    """Build, solve, write back.

    optimize_intrinsics frees the camera intrinsics (reference: GBA
    frees camera_param, ba_solver.cc:330-356; LBA pins it :389) and
    writes refined params back into the map, refreshing kps_norm.

    mesh (jax.sharding.Mesh over >1 devices): route the solve through
    the sharded observation-parallel LM (parallel/dist_ba) — the
    production scale-out path, for pose-only AND intrinsics-refining
    solves (the distributed step carries the same 14-dof tied-intrinsics
    tangent as the single-device solver)."""
    import time as _time

    gauge = [m.init_id1, m.init_id2] if m.init_id1 >= 0 else []
    _t0 = _time.time()
    prob, frames, tracks, ell, n_obs = build_problem(
        m, opt_frames, fix_all_poses=fix_all_poses, gauge_frames=gauge,
        obs_frames=obs_frames, freeze_tracks=freeze_tracks,
        freeze_rotations=freeze_rotations,
    )
    PROF["build"] += _time.time() - _t0
    PROF["calls"] += 1
    if prob is None:
        return None
    PROF["shapes"].add(
        (prob.cam_q.shape[0], prob.points.shape[0], prob.obs_uv.shape[0],
         bool(optimize_intrinsics))
    )
    _t0 = _time.time()
    if optimize_intrinsics:
        opts = dataclasses.replace(opts, optimize_intrinsics=True)
    n_mesh_dev = (
        int(np.prod(list(mesh.shape.values()))) if mesh is not None else 1
    )
    if n_mesh_dev > 1:
        from ..parallel import dist_ba

        stats: dict = {}
        sol, _ = dist_ba.solve_distributed(
            mesh, prob, max_iters=opts.max_iters, huber_px=opts.huber_px,
            stats=stats, optimize_intrinsics=optimize_intrinsics,
        )
        info = dict(
            initial_cost=stats.get("initial_cost", 0.0),
            final_cost=stats.get("final_cost", 0.0),
            iters=stats.get("iters", opts.max_iters),
        )
    else:
        sol, info = solve_ba(prob, opts, ell)
    nf, nt = len(frames), len(tracks)
    # one batched device fetch instead of one per array
    import jax

    q, t, pts, intri, ini, fin, its = jax.device_get(
        (sol.cam_q, sol.cam_t, sol.points, sol.cam_intri,
         info["initial_cost"], info["final_cost"], info["iters"])
    )
    PROF["solve_fetch"] += _time.time() - _t0
    _t0 = _time.time()
    q = np.asarray(q, np.float64)[:nf]
    t = np.asarray(t, np.float64)[:nf]
    pts = np.asarray(pts, np.float64)[:nt]
    upd = ~np.asarray(prob.fix_cam)[:nf]
    fr = np.asarray(frames)[upd]
    m.q[fr] = q[upd] / np.linalg.norm(q[upd], axis=1, keepdims=True)
    m.t[fr] = t[upd]
    m.track_xyz[np.asarray(tracks)] = pts
    if optimize_intrinsics:
        intri = np.asarray(intri, np.float64)[:nf]
        cam_ids = m.cam_of_frame[frames]
        for cid in np.unique(cam_ids):
            row = int(np.nonzero(cam_ids == cid)[0][0])
            m.update_camera(int(cid), intri[row])
    PROF["writeback"] += _time.time() - _t0
    return BAGlueResult(
        frame_ids=np.asarray(frames),
        track_ids=np.asarray(tracks),
        initial_cost=float(ini),
        final_cost=float(fin),
        iters=int(its),
        n_obs=int(n_obs),
    )
