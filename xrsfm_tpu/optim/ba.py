"""From-scratch Levenberg-Marquardt bundle adjuster with Schur complement.

This replaces the reference's Ceres dependency (reference:
src/optimization/ba_solver.cc — GBA :594-638, KGBA :640-678, LBA :523-592,
all SPARSE_SCHUR + LM with 8 CPU threads).  Design:

  * The problem is a flat COO observation table (obs_cam, obs_pt, obs_uv)
    instead of Ceres parameter blocks; residuals and Jacobians evaluate as
    one batched vmap over observations (no pointer chasing).
  * Normal equations are never materialized globally.  Per-camera 6x6
    blocks U, per-point 3x3 blocks V, and per-observation 6x3 coupling
    blocks W are built with segment_sums; the point blocks are marginalized
    in closed form (batched 3x3 inverse), and the reduced camera system
    S dx = rhs is solved matrix-free with preconditioned conjugate
    gradients (block-Jacobi preconditioner = Ceres' SCHUR_JACOBI).
  * The LM trust-region loop (lambda up/down on accept/reject) runs inside
    jit via lax.while_loop with all-branch computation.
  * Huber robustness is IRLS re-weighting; the reference's negative-depth
    guard (constant residual (12,12), cost_factor_ceres.h:29-32) maps to
    zero IRLS weight + constant cost for cheirality-violating observations.
  * Gauge freedom is fixed by masking Jacobian columns: fully-frozen
    cameras, translation-only frozen cameras (the reference freezes the
    init-pair translations, ba_solver.cc:610-614), and frozen points
    (triangulation mode, :615-622).

The same solver core scales out: every segment_sum over observations can be
sharded over a device mesh with a psum reduction of the per-camera blocks
(see xrsfm_tpu/parallel/dist_ba.py).
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp

from ..utils import camera as Cam
from ..utils import geometry as G

_BAD_RESIDUAL = 12.0  # matches reference's negative-depth guard constant


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class BAProblem:
    """Flat COO bundle-adjustment problem (all arrays fixed-shape, padded)."""

    cam_q: jax.Array  # [C, 4] Tcw quaternions
    cam_t: jax.Array  # [C, 3]
    cam_intri: jax.Array  # [C, 8] canonical intrinsics
    points: jax.Array  # [P, 3]
    obs_uv: jax.Array  # [O, 2] pixel observations
    obs_cam: jax.Array  # [O] int32
    obs_pt: jax.Array  # [O] int32
    obs_w: jax.Array  # [O] float32, 0 = padded-out observation
    fix_cam: jax.Array  # [C] bool — freeze full pose
    fix_trans: jax.Array  # [C] bool — freeze translation only
    fix_pt: jax.Array  # [P] bool — freeze point
    # --- intrinsics refinement (reference: GBA frees camera_param,
    # ba_solver.cc:330-356; LBA pins it :389).  Optional: all three may
    # be None (pose-only solves ignore them).
    # intrinsic-block id per camera: frames sharing a physical camera
    # share one block (steps are computed at block level), [C] int32
    cam_kam: jax.Array | None = None
    # per-camera frozen canonical entries (True = frozen), [C, 8] bool —
    # entries absent from the raw COLMAP model stay frozen
    fix_intri: jax.Array | None = None
    # fx/fy tied (single-focal models SIMPLE_*/RADIAL), [C] bool
    tie_f: jax.Array | None = None
    # freeze rotation only (None = none frozen), [C] bool — lets a
    # settling GBA keep globally-averaged rotations (the reliable half
    # of a pose rewrite) while translations/points re-fit the pixel
    # evidence; no reference counterpart (Ceres would use
    # SubsetParameterization)
    fix_rot: jax.Array | None = None


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class RowIndex:
    """One side (camera or point) of the gather-major observation layout.

    Observations of each segment (camera / point) are packed into rows of
    a fixed width M; heavy segments span several rows, so padding is
    bounded by M-1 per segment instead of (max-count − count).  Per-segment
    reductions become: dense gather [R, M, ...] → per-row reduce → a tiny
    segment_sum over the ~R rows.

    When `contig` is set (static), the observation table itself is stored
    in this row order with physical padding (pack_camera_major), so the
    "gather" is a free reshape: gathers of 24-48B rows run far below
    streaming bandwidth, so removing them on the heavier (camera) side
    removes the largest gather of the bandwidth-bound solver."""

    slots: jax.Array  # [R, M] int32 flat obs index, == O for padding
    seg: jax.Array  # [R] int32 segment (camera / point) id per row
    other: jax.Array  # [R, M] int32 the OTHER side's id per slot (0 pad)
    contig: bool = dataclasses.field(
        default=False, metadata=dict(static=True)
    )


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class EllIndex:
    """Gather-major (ELL) slot tables for scatter-free reductions.

    Large scatter-adds (segment_sum over the observation table) and
    max-width padding both cost real time; this layout replaces
    every observation-sized scatter with a dense gather + row reduction
    (see RowIndex).  Built on the host by build_ell.

    pt_uv/pt_w are OPTIONAL static point-major copies of the pixel
    observations and base weights (laid down by pack_camera_major).
    When present, the point-side normal blocks are recomputed natively
    in the point-major layout (_build_pt_blocks_native) instead of
    transpose-gathering per-observation Jacobians — the r3 profile's
    remaining superlinearity at 1M obs.  They mirror obs_uv/obs_w at
    pack time; callers must not mutate obs_w after packing."""

    cam: RowIndex  # camera-major rows
    pt: RowIndex  # point-major rows
    pt_uv: jax.Array | None = None  # [Rp,Lw,2] static pt-major pixels
    pt_w: jax.Array | None = None  # [Rp,Lw] static pt-major weights
    # position of each camera-major slot in the FLAT point-major order
    # (sentinel Rp*Lw for padding slots) — the reverse of pt.slots; lets
    # the Schur solve move tiny per-slot blocks computed point-major
    # (where Z's factors are row-uniform) back into camera rows at
    # 4-8 B/slot instead of gathering point-sized tables at 12-18 B/slot
    pt_pos: jax.Array | None = None  # [Rc,Mc] int32


def _build_rows(ids, other_ids, n_seg, O_full, max_width, bucket_lo):
    """Pack per-segment observation lists into fixed-width rows."""
    import numpy as np

    n = len(ids)
    counts = np.bincount(ids, minlength=n_seg)
    maxc = int(counts.max()) if n else 1
    M = min(_bucket(max(maxc, 1), bucket_lo), max_width)
    rows_per_seg = np.maximum((counts + M - 1) // M, 1)
    row_base = np.cumsum(rows_per_seg) - rows_per_seg
    n_rows = int(rows_per_seg.sum())
    # quarter-octave row bucket {2^k, 1.25, 1.5, 1.75}: multiples-of-64
    # rounding produced a long tail of distinct shapes (every distinct
    # (R, M) pair compiles a fresh LM executable), but plain
    # power-of-two wastes up to 2x — measured
    # 1.88x on the 140k-obs bench (600 rows bucketed to 1024), which
    # inflates EVERY observation-sized op in the solver.  Four buckets
    # per octave caps padding at 25% for ~2x more shapes.
    R = _bucket_quarter(n_rows, 8)

    seg = np.zeros(R, np.int32)
    seg[:n_rows] = np.repeat(np.arange(n_seg, dtype=np.int32), rows_per_seg)
    slots = np.full((R, M), O_full, np.int32)
    order = np.argsort(ids, kind="stable").astype(np.int64)
    sorted_ids = ids[order]
    seg_start = np.concatenate([[0], np.cumsum(counts)[:-1]])
    pos = np.arange(n) - seg_start[sorted_ids]
    slots[row_base[sorted_ids] + pos // M, pos % M] = order.astype(np.int32)
    other_pad = np.concatenate(
        [other_ids.astype(np.int32), np.zeros(1, np.int32)]
    )
    # numpy leaves: jit transfers numpy args in one dispatch, where an
    # eager jnp.asarray would be one transfer per array
    return RowIndex(slots=slots, seg=seg, other=other_pad[slots])


def build_ell(obs_cam, obs_pt, n_cams: int, n_pts: int, n_valid=None,
              bucket_lo: int = 8) -> EllIndex:
    """Host-side ELL table construction (numpy, vectorized).

    Only the first n_valid observations participate (the flat table is
    padded with weight-0 rows pointing at camera/point 0, which must not
    inflate slot counts)."""
    import numpy as np

    obs_cam = np.asarray(obs_cam)
    obs_pt = np.asarray(obs_pt)
    O_full = len(obs_cam)
    n = O_full if n_valid is None else int(n_valid)
    oc = obs_cam[:n].astype(np.int64)
    op = obs_pt[:n].astype(np.int64)
    # cameras see hundreds-to-thousands of observations → split into rows
    # of ≤256; tracks are short → ≤32 wide rows.  The `other` lookup spans
    # the FULL flat table (slots reference index O_full as padding).
    return EllIndex(
        cam=_build_rows(oc, obs_pt, n_cams, O_full, 256, bucket_lo),
        pt=_build_rows(op, obs_cam, n_pts, O_full, 32, bucket_lo),
    )


def _bucket(n: int, lo: int = 8) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


def _bucket_quarter(n: int, lo: int = 8) -> int:
    """Row-count bucket, granularity scaled to where the cost lives:

    * n <= 192: FULL octave (power of two).  The incremental mapper's
      many small solves are compile-bound rather than compute-bound (a
      96-image reconstruction issued 18 distinct LM shapes under the
      quarter-octave ladder); a finer ladder here buys little padding
      compute per avoided row at the price of one trace and compile per
      extra shape.
    * 192 < n < 8192: quarter-octave {2^k * m/8, m in 5..8} — plain
      power-of-two wastes up to 2x (measured 1.88x on the 140k-obs
      bench, 600 rows bucketed to 1024), which inflates EVERY
      observation-sized op in the solver.  Four buckets per octave cap
      padding at 25%.
    * n >= 8192: multiple of 64 — at 1M-observation scale a
      quarter-octave overshoot is ~10% of every observation-sized op
      (measured: 1.114M real slots bucketed to 1.31M).  Fine granularity
      costs ~one fresh compile per global solve, which problems this big
      pay anyway, and repeated solves at one map state still cache."""
    if n >= 8192:
        return (n + 63) // 64 * 64
    b = lo
    while b < n:
        b *= 2
    if b <= lo or n <= 192:
        return b
    q = b // 8
    for m in (5, 6, 7):
        if q * m >= n:
            return q * m
    return b


def pack_camera_major(p: BAProblem, n_valid=None, bucket_lo: int = 8,
                      cam_width: int = 128, pt_width: int = 32):
    """Reorder + physically pad the observation table camera-major.

    Returns (packed problem, EllIndex) where the camera-side rows are
    contiguous slices of the table (RowIndex.contig) — every camera-side
    gather in the solver becomes a reshape; only the point-side
    transpose-gather (the irreducible Schur communication between the
    camera-major and point-major orders) remains.  Padding slots carry
    obs_w = 0 and point id 0, so they vanish from every reduction.
    Host-side numpy; O(n log n)."""
    import numpy as np

    oc = np.asarray(p.obs_cam)
    op = np.asarray(p.obs_pt)
    O_full = len(oc)
    n = O_full if n_valid is None else int(n_valid)
    C = p.cam_q.shape[0]
    P = p.points.shape[0]
    # other_ids must span the FULL table: _build_rows pads slots with
    # index O_full, which its `other` lookup resolves via an appended row
    cam_rows = _build_rows(
        oc[:n].astype(np.int64), op, C, O_full, cam_width, bucket_lo
    )
    slots = np.asarray(cam_rows.slots)  # [Rc, Mc], == O_full for padding
    seg = np.asarray(cam_rows.seg)
    Rc, Mc = slots.shape
    flat = slots.reshape(-1)
    real = flat < O_full
    O2 = Rc * Mc

    def take(a, fill=0):
        a = np.asarray(a)
        out = np.full((O2,) + a.shape[1:], fill, a.dtype)
        out[real] = a[flat[real]]
        return out  # numpy: transferred by the consuming jit in one dispatch

    new_cam = np.repeat(seg, Mc).astype(np.int32)
    new_pt = np.zeros(O2, np.int32)
    new_pt[real] = op[flat[real]]
    p2 = dataclasses.replace(
        p,
        obs_uv=take(p.obs_uv),
        obs_cam=new_cam,
        obs_pt=new_pt,
        obs_w=take(p.obs_w),  # physical padding gets weight 0
    )
    cam_ri = RowIndex(
        slots=np.arange(O2, dtype=np.int32).reshape(Rc, Mc),
        seg=seg,
        other=new_pt.reshape(Rc, Mc),
        contig=True,
    )
    # point-side rows over the REAL slots of the packed table
    real_idx = np.nonzero(real)[0].astype(np.int64)
    nr = len(real_idx)
    compact = _build_rows(
        new_pt[real_idx].astype(np.int64), new_cam[real_idx], P, nr,
        pt_width, bucket_lo,
    )
    cslots = np.asarray(compact.slots)
    if nr:
        pt_slots = np.where(
            cslots < nr, real_idx[np.minimum(cslots, nr - 1)], O2
        ).astype(np.int32)
    else:
        pt_slots = np.full_like(cslots, O2)
    other = np.concatenate([new_cam, np.zeros(1, np.int32)])[pt_slots]
    pt_ri = RowIndex(slots=pt_slots, seg=compact.seg, other=other)
    # static point-major copies of (uv, w): the point-side blocks can
    # then be recomputed in place (per-slot camera params from the small
    # [C,*] tables, point row-uniform) instead of transpose-gathering
    # obs-sized Jacobians at the random-gather rate every LM iteration
    uv2 = np.asarray(p2.obs_uv)
    w2 = np.asarray(p2.obs_w)
    pvalid = pt_slots < O2
    pt_uv = np.zeros(pt_slots.shape + (2,), np.float32)
    pt_uv[pvalid] = uv2[pt_slots[pvalid]]
    pt_w = np.zeros(pt_slots.shape, np.float32)
    pt_w[pvalid] = w2[pt_slots[pvalid]]
    # reverse map: camera-major slot -> flat point-major position
    npt = pt_slots.size
    flat_pt = pt_slots.reshape(-1)
    inv = np.full(O2, npt, np.int32)  # sentinel for padding slots
    src = np.nonzero(flat_pt < O2)[0]
    inv[flat_pt[src]] = src.astype(np.int32)
    pt_pos = inv.reshape(Rc, Mc)
    return p2, EllIndex(cam=cam_ri, pt=pt_ri, pt_uv=pt_uv, pt_w=pt_w,
                        pt_pos=pt_pos)


def _gather_obs(a, slots):
    """Gather a per-observation array by an ELL slot table; dummy slots
    (index O, out of range) read as zero rows.  Implemented as a clamped
    gather + mask multiply — appending a physical pad row would copy the
    whole O-sized array per call, and these are the solver's largest
    intermediates."""
    O = a.shape[0]
    g = a[jnp.minimum(slots, O - 1)]
    valid = (slots < O).astype(a.dtype)
    return g * valid.reshape(valid.shape + (1,) * (a.ndim - 1))


def _gather_rows(a, ri: RowIndex):
    """Bring a per-observation array into ELL row layout [R, M, ...] —
    a free reshape when the table is stored in this order (contig)."""
    R, M = ri.slots.shape
    if ri.contig:
        return a.reshape((R, M) + a.shape[1:])
    return _gather_obs(a, ri.slots)


@dataclasses.dataclass(frozen=True)
class BAOptions:
    """Static solver options (hashable: used as a jit static argument)."""

    max_iters: int = 20
    cg_iters: int = 15  # truncated Newton: block-Jacobi PCG rarely needs more
    huber_px: float = 2.0
    lam_init: float = 1e-4
    lam_up: float = 4.0
    lam_down: float = 0.5
    lam_max: float = 1e8
    cg_tol: float = 1e-2  # inexact Newton: loose inner solves, LM absorbs it
    # precise=True keeps the Schur/CG products in f32 at highest matmul
    # precision instead of the default bf16 compression.  The bf16 path
    # is plenty for incremental-mapping solves, but on the ill-conditioned
    # system after a loop-closure correction CG loses orthogonality in
    # bf16 and LM stalls (measured: post-correction KGBA 5.3M -> 2.3M in
    # bf16 vs 2.4M -> 0.18M in f32 on the same scene).  Accelerator
    # matmuls may also round f32 inputs by default (TF32 on the GPU),
    # hence the explicit highest-precision scope.
    precise: bool = False
    # free the camera intrinsics (reference: GBA adds camera_param as a
    # variable block, ba_solver.cc:330-356; LBA pins it :389).  Requires
    # cam_kam/fix_intri/tie_f on the problem and an EllIndex; camera
    # tangent grows 6 -> 14 (pose + log-fx/fy, cx, cy, k1, k2, p1, p2).
    optimize_intrinsics: bool = False


# The normal-block products (U, bc, V, bp rows) run at highest precision:
# at default precision the GPU's products over the bf16 rows left the
# default-mode LM 12% above the precise solve at ~1.1M observations.
_HI = jax.lax.Precision.HIGHEST


def _obs_residual(delta9, q, t, intri, uv, xyz):
    """Residual of one observation under a 9-dof local perturbation
    (6 pose + 3 point).  Returns ([2] residual, depth)."""
    q2, t2 = G.pose_retract(q, t, delta9[:6])
    x2 = xyz + delta9[6:9]
    xy, z = Cam.project(intri, q2, t2, x2)
    return xy - uv, z


def _residuals_and_jacobians(p: BAProblem, with_intri: bool = False):
    """Batched residuals [O,2], depths [O], Jacobians Jc [O,2,6] (or
    [O,2,14] with the intrinsic tangent appended), Jp [O,2,3].

    Analytic chain (~4x cheaper than 9-tangent jacfwd):
      pc = R x + t;  proj = pc_xy / pc_z;  pix = f * distort(proj) + c
      d pix / d pc = diag(f) @ Jdist(proj) @ [[1/z, 0, -x/z^2],
                                              [0, 1/z, -y/z^2]]
      d pc / d dw = -R [x]_x   (right-multiplicative pose perturbation)
      d pc / d dt = I;  d pc / d x = R
    Verified against jax.jacfwd in tests/test_ba.py.
    """
    q = p.cam_q[p.obs_cam]
    t = p.cam_t[p.obs_cam]
    intri = p.cam_intri[p.obs_cam]
    xyz = p.points[p.obs_pt]

    # NOTE: the einsum/at-set formulation below looks less direct than a
    # closed-form stacked construction, but XLA recomputes/fuses the
    # einsum chain into the bf16 ELL consumers, while jnp.stack /
    # concatenate forms force f32 materialization of Jc/Jp in device
    # memory.  Don't "simplify" without timing both on the card.
    R = G.quat_to_rotmat(q)  # [O,3,3]
    # elementwise rotation application (a default-precision einsum may
    # round the O(100) world coordinates — see _row_project)
    pc = jnp.sum(R * xyz[..., None, :], axis=-1) + t
    z = pc[..., 2]
    zs = jnp.where(jnp.abs(z) < 1e-9, 1e-9, z)
    proj = pc[..., :2] / zs[..., None]
    pix = Cam.normalized_to_image(intri, proj)
    r = pix - p.obs_uv

    f2 = intri[..., :2]  # (fx, fy)
    Jd = Cam.distort_jacobian(intri, proj)  # [O,2,2]
    A = f2[..., :, None] * Jd  # diag(f) @ Jdist
    inv_z = 1.0 / zs
    Jproj = jnp.zeros(pc.shape[:-1] + (2, 3), pc.dtype)
    Jproj = Jproj.at[..., 0, 0].set(inv_z)
    Jproj = Jproj.at[..., 1, 1].set(inv_z)
    Jproj = Jproj.at[..., 0, 2].set(-pc[..., 0] * inv_z * inv_z)
    Jproj = Jproj.at[..., 1, 2].set(-pc[..., 1] * inv_z * inv_z)
    B = jnp.einsum("oij,ojk->oik", A, Jproj)  # [O,2,3] = d pix / d pc

    Jw = jnp.einsum("oij,ojk->oik", B, -jnp.einsum("oij,ojk->oik", R, G.skew(xyz)))
    Jc = jnp.concatenate([Jw, B], axis=-1)  # [O,2,6]
    Jp = jnp.einsum("oij,ojk->oik", B, R)  # [O,2,3]
    if not with_intri:
        return r, z, Jc, Jp
    tie = (
        p.tie_f[p.obs_cam].astype(r.dtype)
        if p.tie_f is not None
        else jnp.zeros(r.shape[:-1], r.dtype)
    )
    Ji = _intri_jacobian(intri, proj, tie)  # [O,2,8]
    return r, z, jnp.concatenate([Jc, Ji], axis=-1), Jp


def _intri_jacobian(intri, proj, tie):
    """Analytic d pix / d intrinsic-tangent, [..., 2, 8].

    Tangent layout: (dlog fx, dlog fy, dcx, dcy, dk1, dk2, dp1, dp2);
    log-focal keeps the column scale commensurate with the pose columns
    (both ~pixel-sized) for the bf16 Schur products.  When tie is 1
    (single-focal models) column 0 carries d/d log f for BOTH axes and
    column 1 is zeroed (its mask is also frozen).  intri and tie
    broadcast against proj's batch shape."""
    fx, fy = intri[..., 0], intri[..., 1]
    u, v = proj[..., 0], proj[..., 1]
    d = Cam.distort(intri, proj)  # distorted normalized coords
    u2, v2 = u * u, v * v
    r2 = u2 + v2
    r4 = r2 * r2
    zeros = jnp.zeros_like(u)
    ones = jnp.ones_like(u)
    fx = jnp.broadcast_to(fx, u.shape)
    fy = jnp.broadcast_to(fy, u.shape)
    tie = jnp.broadcast_to(tie, u.shape)
    # row-x entries per tangent column
    jx = jnp.stack(
        [
            fx * d[..., 0],          # dlog fx (and dlog f when tied)
            zeros,                   # dlog fy (x-row unaffected)
            ones, zeros,             # dcx, dcy
            fx * u * r2, fx * u * r4,            # dk1, dk2
            fx * 2 * u * v, fx * (r2 + 2 * u2),  # dp1, dp2
        ],
        axis=-1,
    )
    jy = jnp.stack(
        [
            tie * fy * d[..., 1],    # tied: y-row follows column 0
            (1.0 - tie) * fy * d[..., 1],
            zeros, ones,
            fy * v * r2, fy * v * r4,
            fy * (r2 + 2 * v2), fy * 2 * u * v,
        ],
        axis=-1,
    )
    return jnp.stack([jx, jy], axis=-2)  # [O,2,8]


def _residuals_and_jacobians_ad(p: BAProblem):
    """jacfwd reference implementation (kept for testing the analytic
    Jacobians)."""
    q = p.cam_q[p.obs_cam]
    t = p.cam_t[p.obs_cam]
    intri = p.cam_intri[p.obs_cam]
    xyz = p.points[p.obs_pt]

    def rj(q_, t_, i_, uv_, x_):
        zero = jnp.zeros(9, p.cam_q.dtype)
        r0, z0 = _obs_residual(zero, q_, t_, i_, uv_, x_)
        J = jax.jacfwd(lambda d: _obs_residual(d, q_, t_, i_, uv_, x_)[0])(zero)
        return r0, z0, J

    r, z, J = jax.vmap(rj)(q, t, intri, p.obs_uv, xyz)
    return r, z, J[..., :6], J[..., 6:9]


def _residuals_only(p: BAProblem):
    q = p.cam_q[p.obs_cam]
    t = p.cam_t[p.obs_cam]
    intri = p.cam_intri[p.obs_cam]
    xyz = p.points[p.obs_pt]
    R = G.quat_to_rotmat(q)
    # elementwise rotation application (a default-precision einsum may
    # round the O(100) world coordinates — see _row_project)
    pc = jnp.sum(R * xyz[..., None, :], axis=-1) + t
    z = pc[..., 2]
    zs = jnp.where(jnp.abs(z) < 1e-9, 1e-9, z)
    proj = pc[..., :2] / zs[..., None]
    pix = Cam.normalized_to_image(intri, proj)
    return pix - p.obs_uv, z


# ---------------------------------------------------------------------------
# Camera-row-native evaluation (requires the camera-major packed table)
# ---------------------------------------------------------------------------
#
# With pack_camera_major the observation table IS the camera-ELL row
# layout [Rc, Mc] flattened, and every slot in a row shares one camera.
# Evaluating in that layout fetches camera data (q/t/intrinsics, 15
# floats) once per ROW instead of once per OBSERVATION — on the 140k-obs
# bench that removes ~16 MB of gather traffic per pass over the table,
# and there are three such passes per LM iteration (Jacobian build,
# Schur setup, accept-test residuals).  The flat-layout twins above stay
# for the sharded path (parallel/dist_ba.py), whose local slices are not
# camera-major.


def _row_project(p: BAProblem, ell: EllIndex):
    """Shared camera-row projection chain: returns (R [Rc,3,3],
    pc [Rc,Mc,3], z, zs, proj, intri [Rc,8], r [Rc,Mc,2])."""
    Rc, Mc = ell.cam.slots.shape
    seg = ell.cam.seg  # [Rc]
    q = p.cam_q[seg]
    t = p.cam_t[seg]
    intri = p.cam_intri[seg]
    xyz = p.points[ell.cam.other]  # [Rc,Mc,3]
    uv = p.obs_uv.reshape(Rc, Mc, 2)
    R = G.quat_to_rotmat(q)  # [Rc,3,3]
    # rotation applied as broadcast multiply+reduce, NOT einsum: a
    # default-precision matrix product may round f32 inputs (bf16
    # passes, or TF32 on the GPU) — world coordinates O(100) then carry
    # ~0.5 absolute error and the residuals (hence the LM accept test)
    # are garbage.  Elementwise ops stay true f32.  (The CPU computes
    # einsums exactly, which is why unit tests cannot catch this.)
    pc = jnp.sum(R[:, None, :, :] * xyz[:, :, None, :], axis=-1) \
        + t[:, None, :]
    z = pc[..., 2]
    zs = jnp.where(jnp.abs(z) < 1e-9, 1e-9, z)
    proj = pc[..., :2] / zs[..., None]
    pix = Cam.normalized_to_image(intri[:, None, :], proj)
    return R, pc, z, zs, proj, intri, pix - uv


def _residuals_only_rows(p: BAProblem, ell: EllIndex):
    """Row-layout residuals: ([Rc,Mc,2], [Rc,Mc])."""
    _, _, z, _, _, _, r = _row_project(p, ell)
    return r, z


def _residuals_and_jacobians_rows(p: BAProblem, ell: EllIndex,
                                  with_intri: bool = False):
    """Row-layout residuals [Rc,Mc,2], depths [Rc,Mc], Jc [Rc,Mc,2,D]
    (D=6 pose, 14 with intrinsics), Jp [Rc,Mc,2,3].  Same analytic chain
    as _residuals_and_jacobians, with the per-camera factors computed at
    row rank and broadcast across slots."""
    R, pc, z, zs, proj, intri, r = _row_project(p, ell)
    xyz = p.points[ell.cam.other]
    f2 = intri[:, None, :2]  # [Rc,1,2]
    Jd = Cam.distort_jacobian(intri[:, None, :], proj)  # [Rc,Mc,2,2]
    A = f2[..., :, None] * Jd
    inv_z = 1.0 / zs
    # B = A @ Jproj with the projection Jacobian's sparsity folded in
    # (no [.,.,2,3] Jproj materialization): col j<2 = A[...,j]/z,
    # col 2 = -(A.,0 x + A.,1 y)/z^2
    B01 = A * inv_z[..., None, None]  # [Rc,Mc,2,2]
    B2 = -(
        A[..., 0] * pc[..., None, 0] + A[..., 1] * pc[..., None, 1]
    ) * (inv_z * inv_z)[..., None]  # [Rc,Mc,2]
    B = jnp.concatenate([B01, B2[..., None]], axis=-1)  # [Rc,Mc,2,3]
    Jp = jnp.einsum("rmij,rjk->rmik", B, R)  # [Rc,Mc,2,3]
    # Jw = B·(−R·skew(x)) = −(B·R)·skew(x) = −Jp·skew(x); a row vector
    # through skew(x) is a cross product (vᵀskew(x) = (v×x)ᵀ), so the
    # [Rc,Mc,3,3] R·skew(x) intermediate of the naive chain (24 MB at
    # bench size — the solver is streaming-bound) never exists
    Jw = -jnp.cross(Jp, xyz[:, :, None, :])
    Jc = jnp.concatenate([Jw, B], axis=-1)  # [Rc,Mc,2,6]
    if not with_intri:
        return r, z, Jc, Jp
    tie = (
        p.tie_f[ell.cam.seg].astype(r.dtype)[:, None]
        if p.tie_f is not None
        else jnp.zeros(r.shape[:-1], r.dtype)
    )
    Ji = _intri_jacobian(intri[:, None, :], proj, tie)  # [Rc,Mc,2,8]
    return r, z, jnp.concatenate([Jc, Ji], axis=-1), Jp


def _robust_cost_and_weight(r, z, obs_w, huber_px):
    """Huber cost + IRLS weights; cheirality violations get the reference's
    constant residual and zero weight."""
    bad = z <= 1e-3
    rn2 = jnp.sum(r * r, axis=-1)
    rn2 = jnp.where(bad, 2.0 * _BAD_RESIDUAL**2, rn2)
    rn = jnp.sqrt(jnp.maximum(rn2, 1e-18))
    in_quad = rn <= huber_px
    cost = jnp.where(in_quad, rn2, huber_px * (2.0 * rn - huber_px))
    wirls = jnp.where(in_quad, 1.0, huber_px / rn)
    wirls = jnp.where(bad, 0.0, wirls)
    total = jnp.sum(obs_w * cost)
    return total, obs_w * wirls


def _inv3x3(M):
    """Batched closed-form 3x3 inverse with damping safeguard."""
    a = M[..., 0, 0]; b = M[..., 0, 1]; c = M[..., 0, 2]
    d = M[..., 1, 0]; e = M[..., 1, 1]; f = M[..., 1, 2]
    g = M[..., 2, 0]; h = M[..., 2, 1]; i = M[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    det = jnp.where(jnp.abs(det) < 1e-12, jnp.sign(det) * 1e-12 + 1e-12, det)
    adj = jnp.stack(
        [
            A, -(b * i - c * h), (b * f - c * e),
            B, (a * i - c * g), -(a * f - c * d),
            C, -(a * h - b * g), (a * e - b * d),
        ],
        axis=-1,
    ).reshape(M.shape)
    return adj / det[..., None, None]


def _masked_jacobians(p: BAProblem, Jc, Jp):
    """Apply gauge-fix masks to Jacobian columns (frozen cameras /
    translations / points)."""
    dt = Jc.dtype
    fr = p.fix_cam if p.fix_rot is None else (p.fix_cam | p.fix_rot)
    cam_free = (~fr)[p.obs_cam].astype(dt)  # [O]
    trans_free = (~(p.fix_cam | p.fix_trans))[p.obs_cam].astype(dt)
    colmask = jnp.concatenate(
        [
            jnp.repeat(cam_free[:, None], 3, axis=1),
            jnp.repeat(trans_free[:, None], 3, axis=1),
        ],
        axis=1,
    )  # [O, 6]
    Jc = Jc * colmask[:, None, :]
    pt_free = (~p.fix_pt)[p.obs_pt].astype(dt)
    Jp = Jp * pt_free[:, None, None]
    return Jc, Jp


def _build_normal_blocks(p: BAProblem, r, Jc, Jp, w):
    """Segment-sum the damped normal-equation blocks."""
    C = p.cam_q.shape[0]
    P = p.points.shape[0]

    Jc, Jp = _masked_jacobians(p, Jc, Jp)

    wJc = Jc * w[:, None, None]
    wJp = Jp * w[:, None, None]

    U = jax.ops.segment_sum(
        jnp.einsum("ori,orj->oij", wJc, Jc), p.obs_cam, num_segments=C
    )  # [C,6,6]
    V = jax.ops.segment_sum(
        jnp.einsum("ori,orj->oij", wJp, Jp), p.obs_pt, num_segments=P
    )  # [P,3,3]
    W = jnp.einsum("ori,orj->oij", wJc, Jp)  # [O,6,3]
    bc = -jax.ops.segment_sum(
        jnp.einsum("ori,or->oi", wJc, r), p.obs_cam, num_segments=C
    )  # [C,6]
    bp = -jax.ops.segment_sum(
        jnp.einsum("ori,or->oi", wJp, r), p.obs_pt, num_segments=P
    )  # [P,3]
    return U, V, W, bc, bp


def _colmask6(p: BAProblem):
    """Per-camera 6-dim gauge mask (rotation cols free unless fix_cam or
    fix_rot, translation cols also frozen by fix_trans)."""
    fr = p.fix_cam if p.fix_rot is None else (p.fix_cam | p.fix_rot)
    rot = (~fr).astype(jnp.float32)[:, None]
    tr = (~(p.fix_cam | p.fix_trans)).astype(jnp.float32)[:, None]
    return jnp.concatenate(
        [jnp.repeat(rot, 3, axis=1), jnp.repeat(tr, 3, axis=1)], axis=1
    )  # [C, 6]


def _colmask_intri(p: BAProblem):
    """Per-camera 8-dim intrinsic-tangent mask (entry frozen by
    fix_intri; the dlog-fy column is also frozen for tied-focal models,
    whose column 0 carries both axes)."""
    im = (~p.fix_intri).astype(jnp.float32)
    if p.tie_f is not None:
        im = im.at[:, 1].multiply((~p.tie_f).astype(jnp.float32))
    return im  # [C, 8]


def _cam_colmask(p: BAProblem, with_intri: bool):
    m6 = _colmask6(p)
    if not with_intri:
        return m6
    return jnp.concatenate([m6, _colmask_intri(p)], axis=1)  # [C, 14]


def _build_normal_blocks_ell(p: BAProblem, ell: EllIndex, r, Jc, Jp, w,
                             reduce_fn=None, return_pt_gathers=False,
                             pt_dtype=jnp.bfloat16, cam_only=False,
                             return_cam_w=False):
    """Scatter-free normal-equation blocks via ELL row gathers.

    Equivalent to _build_normal_blocks; every observation-sized
    segment_sum becomes a dense gather into fixed-width rows, a per-row
    batched matmul over the fused (slot × residual-row) axis (no [*,6,6]
    per-slot intermediates), and a tiny per-row segment_sum.  Gauge masks
    are applied AFTER reduction (each camera row is mask-uniform:
    U_masked = m mᵀ ⊙ U; fixed points zero V/bp), so no masked copy of
    the O-sized Jacobians is ever materialized.

    Jacobians and packed scalars are gathered in bf16 (f32
    accumulation): the solver is gather-bandwidth-bound and the
    1e-2-tolerance inexact-Newton CG absorbs the <1% block error; the LM
    accept test stays exact f32.

    reduce_fn (e.g. a psum over the mesh's obs axis) is applied to each
    per-segment reduction so the same kernel runs sharded — each shard
    holds a slice of the observation table plus its own ELL tables
    (parallel/dist_ba.py).

    pt_dtype sets the dtype of the point-side operands (and of the
    returned pt_gathers): precise solves pass f32 so the Schur products
    built from the returned (Jpg, spg) match the f32 camera side —
    a bf16 point side makes the CG operator asymmetric and stalls LM on
    exactly the ill-conditioned polish problems precise=True exists for."""
    C = p.cam_q.shape[0]
    P = p.points.shape[0]
    red = reduce_fn if reduce_fn is not None else (lambda x: x)
    row_native = Jc.ndim == 4  # [Rc,Mc,2,D] from _*_rows (packed table)
    # packed per-obs scalars: (w, w·r0, w·r1, pad) — one gather per side
    sc_f = jnp.concatenate(
        [w[..., None], r * w[..., None], jnp.zeros_like(w)[..., None]],
        axis=-1,
    )  # [O, 4] or [Rc,Mc,4] f32
    sc = sc_f.astype(jnp.bfloat16)

    D = Jc.shape[-1]  # 6 pose-only, 14 with intrinsics
    Rc, Mc = ell.cam.slots.shape
    if row_native:
        # sqrt(w)-scaled operand: U = (√w Jc)ᵀ(√w Jc) and
        # bc = −(√w Jc)ᵀ(√w r) use ONE materialized [.,.,2,D] array
        # where the (w·Jc, Jc) pair needed two — the solver is
        # streaming-bound, and this re-read is obs-sized
        sw = jnp.sqrt(jnp.maximum(w, 0.0))
        Jcw = (Jc * sw[..., None, None]).astype(pt_dtype)
        swr = (r * sw[..., None]).astype(pt_dtype)  # [Rc,Mc,2]
        Jp16 = Jp.astype(pt_dtype).reshape(-1, 2, 3)
        sc_flat = sc_f.astype(pt_dtype).reshape(-1, 4)
        A = Jcw.reshape(Rc, Mc * 2, D)
        U_rows = jnp.einsum(
            "rki,rkj->rij", A, A, preferred_element_type=jnp.float32,
            precision=_HI,
        )
        bc_rows = -jnp.einsum(
            "rki,rk->ri", A, swr.reshape(Rc, Mc * 2),
            preferred_element_type=jnp.float32, precision=_HI,
        )
    else:
        Jc16 = Jc.astype(jnp.bfloat16)
        Jp16 = Jp.astype(pt_dtype)
        sc_flat = sc_f.astype(pt_dtype)
        Jcg = _gather_rows(Jc16, ell.cam)  # [Rc,Mc,2,D] bf16
        scg = _gather_rows(sc, ell.cam)  # [Rc,Mc,4] bf16
        A = (Jcg * scg[..., 0][..., None, None]).reshape(Rc, Mc * 2, D)
        B = Jcg.reshape(Rc, Mc * 2, D)
        U_rows = jnp.einsum(
            "rki,rkj->rij", A, B, preferred_element_type=jnp.float32,
            precision=_HI,
        )
        bc_rows = -jnp.einsum(
            "rki,rk->ri", B, scg[..., 1:3].reshape(Rc, Mc * 2),
            preferred_element_type=jnp.float32, precision=_HI,
        )
    U = red(jax.ops.segment_sum(U_rows, ell.cam.seg, num_segments=C))
    bc = red(jax.ops.segment_sum(bc_rows, ell.cam.seg, num_segments=C))
    m6 = _cam_colmask(p, D > 6)
    U = U * (m6[:, :, None] * m6[:, None, :])
    bc = bc * m6
    if cam_only:  # the point side comes from _build_pt_blocks_native
        if return_cam_w:
            # hand the √w-scaled camera Jacobian rows (pt_dtype, NO gauge
            # mask) to the Schur solve: with Z' = √w·Jp·L every factored
            # product (Yᵀx = Z'ᵀ(Jcw x), Yz = Jcwᵀ(Z'z), ΣYYᵀ =
            # Jcwᵀ(Z'Z'ᵀ)Jcw) reuses this array, so the solve never
            # re-materializes a masked Jc copy (a 24 B/slot write + a
            # 48 B/slot f32 re-read at 1M obs); gauge masks are applied
            # per-camera after each reduction instead (free at [C,D]).
            return U, bc, Jcw
        return U, bc

    Rp, Lw = ell.pt.slots.shape
    Jpg = _gather_rows(Jp16, ell.pt)  # [Rp,Lw,2,3] bf16
    spg = _gather_rows(sc_flat, ell.pt)  # [Rp,Lw,4] bf16
    A2 = (Jpg * spg[..., 0][..., None, None]).reshape(Rp, Lw * 2, 3)
    B2 = Jpg.reshape(Rp, Lw * 2, 3)
    V_rows = jnp.einsum(
        "rki,rkj->rij", A2, B2, preferred_element_type=jnp.float32,
        precision=_HI,
    )
    bp_rows = -jnp.einsum(
        "rki,rk->ri", B2, spg[..., 1:3].reshape(Rp, Lw * 2),
        preferred_element_type=jnp.float32, precision=_HI,
    )
    V = red(jax.ops.segment_sum(V_rows, ell.pt.seg, num_segments=P))
    bp = red(jax.ops.segment_sum(bp_rows, ell.pt.seg, num_segments=P))
    ptm = (~p.fix_pt).astype(V.dtype)
    V = V * ptm[:, None, None]
    bp = bp * ptm[:, None]
    if return_pt_gathers:
        # hand the point-layout copies of Jp and the packed scalars to
        # the Schur solve — it needs exactly these to build Zpt, and the
        # transpose gather is the expensive step at scale (measured: the
        # pt-side gathers dominate the jac+normal phase at 1M obs)
        return U, V, bc, bp, (Jpg, spg)
    return U, V, bc, bp


def _build_pt_blocks_native(p: BAProblem, ell: EllIndex, huber_px,
                            reduce_fn=None, pt_dtype=jnp.bfloat16):
    """Point-side normal blocks recomputed natively in the point-major
    ELL layout (requires pack_camera_major's pt_uv/pt_w static tables).

    The ~20 B/slot transpose gather of (Jp, w, w·r) from the
    camera-major table into point order is a random gather, far slower
    per byte than streaming.  This evaluates the projection chain a
    second time, directly in point order: per-slot camera parameters
    come from the small [C,*] tables (cache-resident, unlike the
    obs-sized arrays), the point position is row-uniform (each pt row
    is one point), and the pixel observation/weight are the static
    pt-major copies — zero obs-sized random gathers.  The solver is
    memory-bound, so recompute-over-gather trades cheap arithmetic for
    expensive gathers.

    Returns V [P,3,3], bp [P,3], and (Jpg, spg) satisfying
    _schur_solve_ell's pt_gathers contract (Jp rows + packed
    (w, w·r0, w·r1, 0) scalars, both pt_dtype)."""
    P = p.points.shape[0]
    red = reduce_fn if reduce_fn is not None else (lambda x: x)
    g = ell.pt.other  # [Rp,Lw] camera id per slot (0 on padding)
    seg = ell.pt.seg  # [Rp] point id per row
    # ONE fused gather of the [C,15] camera table (q, t, intrinsics)
    # instead of three — the table is KB-sized and cache-resident; the
    # per-slot traffic is the gathered result, so fuse the trips
    ctab = jnp.concatenate([p.cam_q, p.cam_t, p.cam_intri], axis=1)
    gt = ctab[g]  # [Rp,Lw,15]
    q = gt[..., :4]
    t = gt[..., 4:7]
    intri = gt[..., 7:15]
    xyz = p.points[seg]  # [Rp,3] row-uniform
    # direct quaternion rotation (elementwise chain, exact f32), NOT
    # quat_to_rotmat + contract: the per-slot [Rp,Lw,3,3] rotation
    # matrices are 36 B/slot f32 written + re-read 2x (pc and Jp), and
    # an einsum over them would hit the default-precision
    # world-coordinate hazard (see _row_project)
    pc = G.quat_rotate(q, jnp.broadcast_to(
        xyz[:, None, :], g.shape + (3,)
    )) + t
    z = pc[..., 2]
    zs = jnp.where(jnp.abs(z) < 1e-9, 1e-9, z)
    proj = pc[..., :2] / zs[..., None]
    pix = Cam.normalized_to_image(intri, proj)
    r = pix - ell.pt_uv
    _, w = _robust_cost_and_weight(r, z, ell.pt_w, huber_px)
    # same analytic chain as _residuals_and_jacobians_rows, with the
    # camera factors at slot rank (cameras differ within a pt row)
    f2 = intri[..., :2]
    Jd = Cam.distort_jacobian(intri, proj)  # [Rp,Lw,2,2]
    A = f2[..., :, None] * Jd
    inv_z = 1.0 / zs
    B01 = A * inv_z[..., None, None]
    B2 = -(
        A[..., 0] * pc[..., None, 0] + A[..., 1] * pc[..., None, 1]
    ) * (inv_z * inv_z)[..., None]
    B = jnp.concatenate([B01, B2[..., None]], axis=-1)  # [Rp,Lw,2,3]
    # Jp rows = B rows · R = R^T b = inverse-rotate(b): two quaternion
    # rotations instead of materializing R [Rp,Lw,3,3]
    qc = q[..., None, :] * jnp.array([1.0, -1.0, -1.0, -1.0], q.dtype)
    Jp = G.quat_rotate(qc, B)  # [Rp,Lw,2,3]
    Jpg = Jp.astype(pt_dtype)
    spg = jnp.concatenate(
        [w[..., None], r * w[..., None], jnp.zeros_like(w)[..., None]],
        axis=-1,
    ).astype(pt_dtype)  # [Rp,Lw,4]
    Rp, Lw = g.shape
    A2 = (Jpg * spg[..., 0][..., None, None]).reshape(Rp, Lw * 2, 3)
    B2r = Jpg.reshape(Rp, Lw * 2, 3)
    V_rows = jnp.einsum(
        "rki,rkj->rij", A2, B2r, preferred_element_type=jnp.float32,
        precision=_HI,
    )
    bp_rows = -jnp.einsum(
        "rki,rk->ri", B2r, spg[..., 1:3].reshape(Rp, Lw * 2),
        preferred_element_type=jnp.float32, precision=_HI,
    )
    V = red(jax.ops.segment_sum(V_rows, seg, num_segments=P))
    bp = red(jax.ops.segment_sum(bp_rows, seg, num_segments=P))
    ptm = (~p.fix_pt).astype(V.dtype)
    V = V * ptm[:, None, None]
    bp = bp * ptm[:, None]
    return V, bp, (Jpg, spg)


def _inv2x2(M):
    a = M[..., 0, 0]; b = M[..., 0, 1]
    c = M[..., 1, 0]; d = M[..., 1, 1]
    det = a * d - b * c
    det = jnp.where(jnp.abs(det) < 1e-12, jnp.sign(det) * 1e-12 + 1e-12, det)
    adj = jnp.stack([d, -b, -c, a], axis=-1).reshape(M.shape)
    return adj / det[..., None, None]


def _inv_spd(M):
    """Batched closed-form inverse of small SPD blocks via recursive
    block-Schur partitioning down to 2x2/3x3 closed forms (avoids XLA's
    batched-LU path, which is slow for tiny blocks).  Used at
    n = 6 (pose blocks), 8 (intrinsic blocks), 14 (pose+intrinsics)."""
    n = M.shape[-1]
    if n == 1:
        return 1.0 / jnp.where(jnp.abs(M) < 1e-12, 1e-12, M)
    if n == 2:
        return _inv2x2(M)
    if n == 3:
        return _inv3x3(M)
    k = (n + 1) // 2
    A = M[..., :k, :k]
    B = M[..., :k, k:]
    D = M[..., k:, k:]
    Ai = _inv_spd(A)
    AiB = jnp.einsum("...ij,...jk->...ik", Ai, B)
    S = D - jnp.einsum("...ji,...jk->...ik", B, AiB)
    Si = _inv_spd(S)
    TR = -jnp.einsum("...ij,...jk->...ik", AiB, Si)
    TL = Ai - jnp.einsum("...ij,...kj->...ik", TR, AiB)
    top = jnp.concatenate([TL, TR], axis=-1)
    bot = jnp.concatenate([jnp.swapaxes(TR, -1, -2), Si], axis=-1)
    return jnp.concatenate([top, bot], axis=-2)


_inv6x6_spd = _inv_spd  # historical alias (6x6 pose blocks)


def _chol3x3(M):
    """Batched closed-form lower-Cholesky of SPD 3x3 blocks (guarded)."""
    l00 = jnp.sqrt(jnp.maximum(M[..., 0, 0], 1e-12))
    l10 = M[..., 1, 0] / l00
    l20 = M[..., 2, 0] / l00
    l11 = jnp.sqrt(jnp.maximum(M[..., 1, 1] - l10 * l10, 1e-12))
    l21 = (M[..., 2, 1] - l20 * l10) / l11
    l22 = jnp.sqrt(jnp.maximum(M[..., 2, 2] - l20 * l20 - l21 * l21, 1e-12))
    zero = jnp.zeros_like(l00)
    return jnp.stack(
        [
            jnp.stack([l00, zero, zero], -1),
            jnp.stack([l10, l11, zero], -1),
            jnp.stack([l20, l21, l22], -1),
        ],
        axis=-2,
    )


def _schur_solve_ell(p: BAProblem, ell: EllIndex, U, V, bc, bp, Jc, Jp, w,
                     lam, cg_iters, cg_tol, reduce_fn=None,
                     compute_dtype=jnp.bfloat16, pt_gathers=None,
                     cam_w=None):
    """ELL-layout Schur solve: points marginalized in closed form, PCG on
    the reduced camera system with scatter-free matvecs.

    Key substitution: with L = chol(Vinv), Y_o = (w_o Jc_oᵀ Jp_o) L_p
    absorbs the point marginalization — the correction term G V⁻¹ Gᵀ
    becomes (GL)(GL)ᵀ.  Y is rank-2 (Y_o = Jc_oᵀ Z_o with Z = w·Jp·L,
    [O,2,3]) and is NEVER materialized: every product uses the factored
    forms  Yᵀx = Zᵀ(Jc x),  Y z = Jcᵀ(Z z),  Σ Y Yᵀ = Jcᵀ(Z Zᵀ)Jc.
    The explicit [O,D,3] Y of the textbook formulation costs 36-84 B/slot
    (D=6-14) to build, transpose-gather into point order, and re-stream
    every CG iteration; the factored form moves that traffic onto Z (12 B/slot) and a per-CG
    [O,2] intermediate a = Jc x (4 B/slot), which is also what the
    point-side transpose-gather (the irreducible Schur communication)
    now carries.  bf16 operands, f32 accumulation throughout."""
    C = p.cam_q.shape[0]
    P = p.points.shape[0]
    D = Jc.shape[-1]  # 6 pose-only, 14 with a tied-intrinsics tangent
    with_intri = D > 6
    red = reduce_fn if reduce_fn is not None else (lambda x: x)
    eyeD = jnp.eye(D, dtype=U.dtype)
    eye3 = jnp.eye(3, dtype=U.dtype)

    Ud = U + lam * (U * eyeD) + 1e-8 * eyeD
    Vd = V + lam * (V * eye3) + 1e-8 * eye3
    Vinv = _inv3x3(Vd)
    L = _chol3x3(Vinv)  # [P,3,3]

    cd = compute_dtype
    ptm = (~p.fix_pt).astype(w.dtype)
    Rc, Mc = ell.cam.slots.shape
    Rp, Lw = ell.pt.slots.shape
    row_native = Jc.ndim == 4
    # pt-major Z mode: Z's factors (L, the fix_pt mask, w) are all
    # row-uniform in the POINT-major layout, so Z lives only there (Zpt)
    # and the camera-side products gather tiny per-slot results
    # (b = Z·z [2], Gz = Z·Zᵀ [2,2]) back through the reverse map
    # ell.pt_pos at 4-8 B/slot — the camera-major Z build (an 18 B/slot
    # random gather of L plus a 12 B/slot Z write) and the per-matvec
    # 12 B/slot point-vector gathers disappear entirely (they were the
    # dominant Schur-setup traffic at 1M obs, r4 profile).
    pt_major = (
        row_native and pt_gathers is not None and ell.pt_pos is not None
    )
    # weighted-operand mode: reuse the normal-block build's √w-scaled Jcw
    # for every camera-side Schur product (Y = Jcwᵀ·Z' with Z' = √w·Jp·L).
    # No fresh masked Jc copy is materialized (24 B/slot write + 48 B/slot
    # f32 re-read at 1M obs); the gauge column masks are applied
    # per-camera AFTER each reduction instead, which is free at [C,D].
    # PCG stays in the masked subspace because rhs is masked, x0 = 0,
    # every matvec/precond output is masked, and the preconditioner is
    # block-diagonal per camera.
    weighted = cam_w is not None and row_native and pt_major
    m6post = _cam_colmask(p, with_intri) if weighted else None  # [C,D]
    if row_native:  # [Rc,Mc,2,D] (packed table)
        if weighted:
            Jc16 = cam_w if cam_w.dtype == cd else cam_w.astype(cd)
        else:
            m6g = _cam_colmask(p, with_intri).astype(cd)[ell.cam.seg]
            Jc16 = Jc.astype(cd) * m6g[:, None, None, :]  # [Rc,Mc,2,D]
        if pt_major:
            Z = None  # never materialized camera-major
        else:
            wm = (w * ptm[ell.cam.other]).astype(cd)  # [Rc,Mc]
            Lg = L.astype(cd)[ell.cam.other]  # [Rc,Mc,3,3]
            Z = (
                jnp.einsum("...ij,...jk->...ik", Jp.astype(cd), Lg)
                * wm[..., None, None]
            )  # [Rc,Mc,2,3]
        Zpt = None  # built below (reusing the normal-block gathers)
        Jc_flat = None
    else:
        wm = (w * ptm[p.obs_pt]).astype(cd)
        Lg = L.astype(cd)[p.obs_pt]  # [O,3,3]
        Z_flat = (
            jnp.einsum("orj,ojk->ork", Jp.astype(cd), Lg)
            * wm[:, None, None]
        )  # [O,2,3]
        m6g = _cam_colmask(p, with_intri).astype(cd)[p.obs_cam]  # [O,D]
        Jc_flat = Jc.astype(cd) * m6g[:, None, :]  # [O,2,D]
        # NOTE: in the flat layout ell.pt.slots index the ORIGINAL
        # observation order, so the point-order copies must be gathered
        # from the flat arrays (the sharded dist_ba path lands here)
        Zpt = _gather_rows(Z_flat, ell.pt)  # [Rp,Lw,2,3]
        Jc16 = _gather_rows(Jc_flat, ell.cam)  # [Rc,Mc,2,D]
        Z = _gather_rows(Z_flat, ell.cam)  # [Rc,Mc,2,3]
    if Zpt is None:
        if pt_gathers is not None:
            # reuse the normal-block build's point-layout gathers: Zpt =
            # Jp_pt · L · w, with L and the fix_pt mask ROW-uniform in the
            # point layout (each pt row is one point) — no fresh
            # transpose gather at all (the pt-side gathers are what
            # scales worst at 1M obs)
            Jpg, spg = pt_gathers
            L_row = L.astype(cd)[ell.pt.seg]  # [Rp,3,3]
            w_or_sw = (
                jnp.sqrt(jnp.maximum(spg[..., 0].astype(w.dtype), 0.0))
                if weighted else spg[..., 0].astype(w.dtype)
            )  # √w when the camera side carries the other √w (Jcw)
            wrow = (w_or_sw * ptm[ell.pt.seg][:, None]).astype(cd)
            Zpt = (
                jnp.einsum("rlij,rjk->rlik", Jpg, L_row)
                * wrow[..., None, None]
            )
        else:
            # standalone path: one 12 B/slot transpose gather (the
            # textbook Y form gathered 36-84 B/slot here)
            Zpt = _gather_obs(Z.reshape(-1, 2, 3), ell.pt.slots)
    cam_ids = ell.pt.other  # [Rp,Lw]
    pt_ids = ell.cam.other  # [Rc,Mc]

    # --- tied-intrinsics reduced space (reference: GBA frees camera_param
    # per PHYSICAL camera, ba_solver.cc:330-356).  Pose columns live per
    # camera; intrinsic columns live per intrinsic block (cam_kam maps
    # cameras to blocks; frames sharing a camera share one block).  CG
    # vectors use the replicated per-camera form [C,D] whose intrinsic
    # part is constant within a block; `_proj` re-imposes that subspace
    # (gradient summation over the block) and `_dot` counts each block
    # once (1/|block| weights).
    if with_intri:
        kam = p.cam_kam
        kam_cnt = jax.ops.segment_sum(
            jnp.ones(C, jnp.float32), kam, num_segments=C
        )
        wred = 1.0 / jnp.maximum(kam_cnt, 1.0)  # [K(=C)]

        def _proj(y):  # [C,D] cam-level gradient → tied subspace
            yi = jax.ops.segment_sum(y[:, 6:], kam, num_segments=C)
            return jnp.concatenate([y[:, :6], yi[kam]], axis=1)

        def _dot(a, b):
            return jnp.sum(a[:, :6] * b[:, :6]) + jnp.sum(
                (a[:, 6:] * b[:, 6:]) * wred[kam][:, None]
            )
    else:
        def _proj(y):
            return y

        def _dot(a, b):
            return jnp.sum(a * b)

    def _ypt_reduce(x):
        """yp[p] = Σ_{o∈p} Y_oᵀ x_{cam(o)} = Σ Z_oᵀ (Jc_o x)  → [P,3].

        a = Jc x is computed row-natively (camera data broadcast per row,
        no gather) and transpose-gathered at 4 B/slot — the only
        point-order traffic of the matvec."""
        if row_native:
            xg = x.astype(cd)[ell.cam.seg]  # [Rc,D] — row-level, free
            a = jnp.einsum("rmid,rd->rmi", Jc16, xg)  # [Rc,Mc,2] bf16
            apt = _gather_obs(a.reshape(-1, 2), ell.pt.slots)
        else:
            a = jnp.einsum(
                "oid,od->oi", Jc_flat, x.astype(cd)[p.obs_cam]
            )  # [O,2]
            apt = _gather_rows(a, ell.pt)  # [Rp,Lw,2]
        yrow = jnp.einsum(
            "rlik,rli->rk", Zpt, apt, preferred_element_type=jnp.float32
        )
        return red(jax.ops.segment_sum(yrow, ell.pt.seg, num_segments=P))

    def _ycam_reduce(zp):
        """t[c] = Σ_{o∈c} Y_o z_{pt(o)} = Σ Jc_oᵀ (Z_o z)  → [C,D]"""
        if pt_major:
            # z is ROW-uniform point-major; only the [2]-vector result
            # crosses the layouts (4 B/slot vs the 12 B/slot zp gather)
            zrow = zp[ell.pt.seg].astype(cd)  # [Rp,3]
            b_pt = jnp.einsum("rlik,rk->rli", Zpt, zrow)  # [Rp,Lw,2]
            b = _gather_obs(b_pt.reshape(-1, 2), ell.pt_pos)  # [Rc,Mc,2]
        else:
            zg = zp[pt_ids].astype(cd)  # [Rc,Mc,3]
            b = jnp.einsum("rmik,rmk->rmi", Z, zg)  # [Rc,Mc,2]
        trow = jnp.einsum(
            "rmid,rmi->rd", Jc16, b, preferred_element_type=jnp.float32
        )
        out = red(jax.ops.segment_sum(trow, ell.cam.seg, num_segments=C))
        return out * m6post if weighted else out

    def S_matvec(x):  # x [C,D] f32, intrinsic part block-replicated
        return _proj(
            jnp.einsum("cij,cj->ci", Ud, x) - _ycam_reduce(_ypt_reduce(x))
        )

    # rhs = bc - Σ_o Y_o (Lᵀ bp)_{pt(o)}; the preconditioner needs the
    # per-slot [2,2] Gram of Z.  In pt-major mode both cross to the
    # camera layout through ONE fused 6-wide payload gather (b [2] ∥
    # Gz [4]) — each tiny-row gather over the observation table pays
    # tile-granular memory traffic regardless of payload width, so fusing
    # the two trips halves that cost.
    u = jnp.einsum("pji,pj->pi", L, bp)  # Lᵀ bp  [P,3]
    if pt_major:
        zrow = u[ell.pt.seg].astype(cd)  # [Rp,3] row-uniform
        b_pt = jnp.einsum("rlik,rk->rli", Zpt, zrow)  # [Rp,Lw,2]
        Gz_pt = jnp.einsum(
            "rlik,rljk->rlij", Zpt, Zpt,
            preferred_element_type=jnp.float32,
        )  # [Rp,Lw,2,2]
        Rp_, Lw_ = ell.pt.slots.shape
        payload = jnp.concatenate(
            [b_pt.astype(cd),
             Gz_pt.astype(cd).reshape(Rp_, Lw_, 4)], axis=-1,
        )
        pay = _gather_obs(payload.reshape(-1, 6), ell.pt_pos)  # [Rc,Mc,6]
        b_rhs = pay[..., :2]
        Gz = pay[..., 2:].reshape(Rc, Mc, 2, 2)
        trow = jnp.einsum(
            "rmid,rmi->rd", Jc16, b_rhs,
            preferred_element_type=jnp.float32,
        )
        ycam_u = red(
            jax.ops.segment_sum(trow, ell.cam.seg, num_segments=C)
        )
        if weighted:
            ycam_u = ycam_u * m6post
        rhs = _proj(bc - ycam_u)
    else:
        rhs = _proj(bc - _ycam_reduce(u))
        Gz = jnp.einsum(
            "rmik,rmjk->rmij", Z, Z, preferred_element_type=jnp.float32
        )  # [Rc,Mc,2,2]
    Hz = jnp.einsum(
        "rmij,rmjd->rmid", Gz.astype(cd), Jc16,
        preferred_element_type=jnp.float32,
    ).astype(cd)  # [Rc,Mc,2,D]
    S_rows = jax.lax.dot_general(
        Jc16.reshape(Rc, Mc * 2, D), Hz.reshape(Rc, Mc * 2, D),
        (((1,), (1,)), ((0,), (0,))),
        preferred_element_type=jnp.float32,
    )  # [Rc,D,D]
    corr = red(jax.ops.segment_sum(S_rows, ell.cam.seg, num_segments=C))
    if weighted:  # keep masked blocks exactly Ud's (SPD for _inv_spd)
        corr = corr * (m6post[:, :, None] * m6post[:, None, :])
    Sdiag = Ud - corr
    Sdiag = Sdiag + 1e-7 * eyeD
    if with_intri:
        # separate pose (per camera) and intrinsic (per block) Jacobi
        # blocks — symmetric PD in the reduced metric by construction
        Minv_p = _inv_spd(Sdiag[:, :6, :6])
        Sd_i = jax.ops.segment_sum(
            Sdiag[:, 6:, 6:], kam, num_segments=C
        ) + 1e-7 * jnp.eye(8, dtype=U.dtype)
        Minv_i = _inv_spd(Sd_i)

        def precond(x):
            xp = jnp.einsum("cij,cj->ci", Minv_p, x[:, :6])
            xi_red = jax.ops.segment_sum(
                x[:, 6:] * wred[kam][:, None], kam, num_segments=C
            )  # one copy of the block value
            xi = jnp.einsum("kij,kj->ki", Minv_i, xi_red)
            return jnp.concatenate([xp, xi[kam]], axis=1)
    else:
        Minv = _inv_spd(Sdiag)

        def precond(x):
            return jnp.einsum("cij,cj->ci", Minv, x)

    x0 = jnp.zeros_like(rhs)
    r0 = rhs
    z0 = precond(r0)
    rz0 = _dot(r0, z0)
    bnorm = jnp.sqrt(_dot(rhs, rhs)) + 1e-30

    def cg_cond(carry):
        i, x, ypx, r_, z_, pk, rz = carry
        return (i < cg_iters) & (jnp.sqrt(_dot(r_, r_)) > cg_tol * bnorm)

    def cg_body(carry):
        i, x, ypx, r_, z_, pk, rz = carry
        # the matvec's inner point-side reduction IS ypt(pk); carrying
        # ypt(x) = Σ alpha_k ypt(p_k) by linearity makes the
        # back-substitution's reduction free (one fewer pass over the
        # [O,D,3] Y table per LM step)
        ypp = _ypt_reduce(pk)
        Ap = _proj(jnp.einsum("cij,cj->ci", Ud, pk) - _ycam_reduce(ypp))
        denom = _dot(pk, Ap)
        alpha = rz / jnp.where(jnp.abs(denom) < 1e-30, 1e-30, denom)
        x = x + alpha * pk
        ypx = ypx + alpha * ypp
        r_new = r_ - alpha * Ap
        z_new = precond(r_new)
        rz_new = _dot(r_new, z_new)
        beta = rz_new / jnp.where(jnp.abs(rz) < 1e-30, 1e-30, rz)
        return i + 1, x, ypx, r_new, z_new, z_new + beta * pk, rz_new

    yp0 = jnp.zeros((P, 3), rhs.dtype)
    _, dx_c, ydx, _, _, _, _ = jax.lax.while_loop(
        cg_cond, cg_body, (0, x0, yp0, r0, z0, z0, rz0)
    )

    # back-substitute: dp = Vinv bp − L (Σ_{o∈p} Y_oᵀ dx_{cam(o)});
    # ydx accumulated inside the CG loop.  NOTE: exact only while pk is
    # built from z/beta recurrences seeded at x0 = 0 (it is).
    dx_p = jnp.einsum("pij,pj->pi", Vinv, bp) - jnp.einsum(
        "pij,pj->pi", L, ydx
    )
    return dx_c, dx_p


def _schur_solve(p: BAProblem, U, V, W, bc, bp, lam, cg_iters, cg_tol):
    """Marginalize points, PCG on the reduced camera system, back-substitute."""
    C = p.cam_q.shape[0]
    P = p.points.shape[0]
    eye6 = jnp.eye(6, dtype=U.dtype)
    eye3 = jnp.eye(3, dtype=U.dtype)

    # multiplicative LM damping on the block diagonals
    Ud = U + lam * (U * eye6) + 1e-8 * eye6
    Vd = V + lam * (V * eye3) + 1e-8 * eye3
    Vinv = _inv3x3(Vd)

    def S_matvec(x):  # x [C, 6]
        Ux = jnp.einsum("cij,cj->ci", Ud, x)
        WTx = jnp.einsum("oji,oj->oi", W, x[p.obs_cam])  # [O,3]
        yp = jax.ops.segment_sum(WTx, p.obs_pt, num_segments=P)
        zp = jnp.einsum("pij,pj->pi", Vinv, yp)
        Wz = jnp.einsum("oij,oj->oi", W, zp[p.obs_pt])  # [O,6]
        t2 = jax.ops.segment_sum(Wz, p.obs_cam, num_segments=C)
        return Ux - t2

    # rhs = bc - W Vinv bp
    Wvb = jnp.einsum("oij,oj->oi", W, jnp.einsum("pij,pj->pi", Vinv, bp)[p.obs_pt])
    rhs = bc - jax.ops.segment_sum(Wvb, p.obs_cam, num_segments=C)

    # block-Jacobi preconditioner: diag blocks of S
    WVW = jnp.einsum("oij,ojk,olk->oil", W, Vinv[p.obs_pt], W)  # [O,6,6]
    Sdiag = Ud - jax.ops.segment_sum(WVW, p.obs_cam, num_segments=C)
    Sdiag = Sdiag + 1e-7 * eye6
    # 6x6 inverses via batched solve
    Minv = jnp.linalg.solve(Sdiag, jnp.broadcast_to(eye6, (C, 6, 6)))

    def precond(x):
        return jnp.einsum("cij,cj->ci", Minv, x)

    # PCG
    x0 = jnp.zeros_like(rhs)
    r0 = rhs
    z0 = precond(r0)
    p0 = z0
    rz0 = jnp.sum(r0 * z0)
    bnorm = jnp.sqrt(jnp.sum(rhs * rhs)) + 1e-30

    def cg_cond(carry):
        i, x, r_, z_, pk, rz = carry
        return (i < cg_iters) & (jnp.sqrt(jnp.sum(r_ * r_)) > cg_tol * bnorm)

    def cg_body(carry):
        i, x, r_, z_, pk, rz = carry
        Ap = S_matvec(pk)
        denom = jnp.sum(pk * Ap)
        alpha = rz / jnp.where(jnp.abs(denom) < 1e-30, 1e-30, denom)
        x = x + alpha * pk
        r_new = r_ - alpha * Ap
        z_new = precond(r_new)
        rz_new = jnp.sum(r_new * z_new)
        beta = rz_new / jnp.where(jnp.abs(rz) < 1e-30, 1e-30, rz)
        return i + 1, x, r_new, z_new, z_new + beta * pk, rz_new

    _, dx_c, _, _, _, _ = jax.lax.while_loop(
        cg_cond, cg_body, (0, x0, r0, z0, p0, rz0)
    )

    # back-substitute points: dp = Vinv (bp - W^T dx_c)
    WTdx = jax.ops.segment_sum(
        jnp.einsum("oji,oj->oi", W, dx_c[p.obs_cam]), p.obs_pt, num_segments=P
    )
    dx_p = jnp.einsum("pij,pj->pi", Vinv, bp - WTdx)
    return dx_c, dx_p


def _select_accept(accept, p: BAProblem, cand: BAProblem) -> BAProblem:
    """where(accept, cand, p) over ONLY the parameter leaves (_apply_step
    mutates cam_q/cam_t/points and possibly cam_intri)."""
    sel = lambda a, b: jnp.where(accept, b, a)  # noqa: E731
    return dataclasses.replace(
        p,
        cam_q=sel(p.cam_q, cand.cam_q),
        cam_t=sel(p.cam_t, cand.cam_t),
        cam_intri=sel(p.cam_intri, cand.cam_intri),
        points=sel(p.points, cand.points),
    )


def _apply_step(p: BAProblem, dx_c, dx_p) -> BAProblem:
    dpose = dx_c[:, :6]
    dpose = dpose * (~p.fix_cam)[:, None]
    if p.fix_rot is not None:
        dpose = dpose.at[:, :3].multiply((~p.fix_rot)[:, None])
    dpose = dpose.at[:, 3:].multiply((~p.fix_trans)[:, None])
    q2, t2 = G.pose_retract(p.cam_q, p.cam_t, dpose)
    pts2 = p.points + dx_p * (~p.fix_pt)[:, None]
    out = dataclasses.replace(p, cam_q=q2, cam_t=t2, points=pts2)
    if dx_c.shape[1] > 6:
        di = dx_c[:, 6:] * _colmask_intri(p)  # [C,8]
        intri = p.cam_intri
        tie = (
            p.tie_f.astype(intri.dtype)
            if p.tie_f is not None
            else jnp.zeros(intri.shape[0], intri.dtype)
        )
        dlogfx = di[:, 0]
        dlogfy = tie * di[:, 0] + (1.0 - tie) * di[:, 1]
        fx2 = intri[:, 0] * jnp.exp(dlogfx)
        fy2 = intri[:, 1] * jnp.exp(dlogfy)
        rest = intri[:, 2:] + di[:, 2:]
        out = dataclasses.replace(
            out,
            cam_intri=jnp.concatenate(
                [fx2[:, None], fy2[:, None], rest], axis=1
            ),
        )
    return out


@functools.partial(jax.jit, static_argnames=("opts",))
def solve_ba(p: BAProblem, opts: BAOptions = BAOptions(),
             ell: EllIndex | None = None):
    """Run LM.  Returns (solved problem, info dict).

    When an EllIndex is supplied (build_ell on the host), the scatter-free
    gather-major kernels are used — same math, much less HBM pressure."""
    import contextlib

    prec_ctx = (
        jax.default_matmul_precision("highest") if opts.precise
        else contextlib.nullcontext()
    )
    compute_dtype = jnp.float32 if opts.precise else jnp.bfloat16
    # camera-major packed tables evaluate in the row-native layout:
    # camera data fetched per row, not per observation (see _row_project)
    row_native = ell is not None and ell.cam.contig

    def cost_of(prob):
        if row_native:
            r, z = _residuals_only_rows(prob, ell)
            w_full = prob.obs_w.reshape(ell.cam.slots.shape)
        else:
            r, z = _residuals_only(prob)
            w_full = prob.obs_w
        c, _ = _robust_cost_and_weight(r, z, w_full, opts.huber_px)
        return c

    def lm_cond(carry):
        it, prob, lam, cost, done = carry
        return (it < opts.max_iters) & (~done)

    if opts.optimize_intrinsics and (
        ell is None or p.cam_kam is None or p.fix_intri is None
    ):
        raise ValueError(
            "optimize_intrinsics requires an EllIndex and "
            "cam_kam/fix_intri on the problem"
        )

    def lm_body(carry):
        it, prob, lam, cost, done = carry
        if row_native:
            r, z, Jc, Jp = _residuals_and_jacobians_rows(
                prob, ell, with_intri=opts.optimize_intrinsics
            )
            w_full = prob.obs_w.reshape(ell.cam.slots.shape)
        else:
            r, z, Jc, Jp = _residuals_and_jacobians(
                prob, with_intri=opts.optimize_intrinsics
            )
            w_full = prob.obs_w
        _, w = _robust_cost_and_weight(r, z, w_full, opts.huber_px)
        if ell is not None:
            camw = None
            if row_native and ell.pt_uv is not None:
                # camera side from the row-native pass; point side
                # recomputed natively in point order (no transpose
                # gather of obs-sized Jacobians); the √w-scaled Jcw is
                # shared with the Schur solve (weighted-operand mode)
                U, bc, camw = _build_normal_blocks_ell(
                    prob, ell, r, Jc, Jp, w, cam_only=True,
                    return_cam_w=True, pt_dtype=compute_dtype,
                )
                V, bp, ptg = _build_pt_blocks_native(
                    prob, ell, opts.huber_px, pt_dtype=compute_dtype
                )
            else:
                U, V, bc, bp, ptg = _build_normal_blocks_ell(
                    prob, ell, r, Jc, Jp, w, return_pt_gathers=True,
                    pt_dtype=compute_dtype,
                )
            dx_c, dx_p = _schur_solve_ell(
                prob, ell, U, V, bc, bp, Jc, Jp, w, lam,
                opts.cg_iters, opts.cg_tol,
                compute_dtype=compute_dtype, pt_gathers=ptg,
                cam_w=camw,
            )
        else:
            U, V, W, bc, bp = _build_normal_blocks(prob, r, Jc, Jp, w)
            dx_c, dx_p = _schur_solve(
                prob, U, V, W, bc, bp, lam, opts.cg_iters, opts.cg_tol
            )
        cand = _apply_step(prob, dx_c, dx_p)
        new_cost = cost_of(cand)
        accept = new_cost < cost
        # select only the leaves _apply_step mutates — a whole-tree
        # where() would stream the (much larger) observation table
        # through HBM every iteration for nothing
        prob = _select_accept(accept, prob, cand)
        cost2 = jnp.where(accept, new_cost, cost)
        lam2 = jnp.where(accept, lam * opts.lam_down, lam * opts.lam_up)
        lam2 = jnp.clip(lam2, 1e-10, opts.lam_max)
        rel = jnp.abs(cost - cost2) / jnp.maximum(cost, 1e-12)
        # early-stop only when damping is back near nominal: a tiny
        # accepted step at HIGH lam is an LM plateau (trust region shrunk
        # after rejections), not convergence — stopping there froze
        # post-loop-correction solves at 10x their reachable cost, with
        # escape decided by reduction-order rounding luck
        done2 = accept & (rel < 1e-6) & (lam <= 10.0 * opts.lam_init)
        return it + 1, prob, lam2, cost2, done2

    with prec_ctx:
        c0 = cost_of(p)
        it, p_out, lam, c_final, _ = jax.lax.while_loop(
            lm_cond, lm_body,
            (0, p, jnp.asarray(opts.lam_init, p.cam_q.dtype), c0,
             jnp.asarray(False)),
        )
    info = dict(initial_cost=c0, final_cost=c_final, iters=it, lam=lam)
    return p_out, info
