"""Distributed Schur-complement bundle adjustment over a device mesh.

The reference has no distributed computation at all (SURVEY.md §2.9: single
process, OpenMP pair loop, 8 Ceres threads).  This module *introduces* the
multi-device scale-out called for by BASELINE.json's north star:

  * the COO observation table is sharded over the mesh's "obs" axis —
    residual/Jacobian evaluation is embarrassingly parallel;
  * each shard owns its slice of the observation table PLUS its own ELL
    row tables (optim/ba.build_ell over the local slice), so the sharded
    solver runs the exact same scatter-free gather-major kernels as the
    single-chip path, with a lax.psum at each per-segment reduction
    (the reduce_fn hook in _build_normal_blocks_ell / _schur_solve_ell);
  * cameras/points stay replicated (tiny: 6C + 3P floats); the reduced
    camera system is solved by replicated PCG whose matvec psums local
    per-shard contributions across the mesh.

This mirrors the single-chip solver in optim/ba.py step for step, so the
two paths are testable against each other on a CPU mesh
(XLA_FLAGS=--xla_force_host_platform_device_count=8).
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..optim import ba as ba_mod
from ..optim.ba import BAProblem, EllIndex, RowIndex, build_ell


def shard_problem(p: BAProblem, n_shards: int) -> BAProblem:
    """Pad the observation table to a multiple of n_shards (weight-0 pad)."""
    O = p.obs_uv.shape[0]
    pad = (-O) % n_shards
    if pad == 0:
        return p
    def padded(a, fill=0):
        return jnp.concatenate(
            [a, jnp.full((pad,) + a.shape[1:], fill, a.dtype)], axis=0
        )
    return dataclasses.replace(
        p,
        obs_uv=padded(p.obs_uv),
        obs_cam=padded(p.obs_cam),
        obs_pt=padded(p.obs_pt),
        obs_w=padded(p.obs_w),
    )


def build_sharded_ell(p: BAProblem, n_shards: int,
                      n_valid: int | None = None) -> EllIndex:
    """Per-shard ELL tables, padded to common shapes and stacked on a
    leading device axis ([n_dev, R, M] leaves, to be sharded over "obs").

    The observation table must already be padded to a multiple of
    n_shards (shard_problem); slot padding uses the LOCAL dummy index
    (= per-shard slice length)."""
    oc = np.asarray(p.obs_cam)
    op = np.asarray(p.obs_pt)
    O = len(oc)
    per = O // n_shards
    C = p.cam_q.shape[0]
    Pn = p.points.shape[0]
    nv = O if n_valid is None else int(n_valid)
    ells = []
    for i in range(n_shards):
        lo = i * per
        local_valid = int(np.clip(nv - lo, 0, per))
        ells.append(
            build_ell(oc[lo:lo + per], op[lo:lo + per], C, Pn,
                      n_valid=local_valid)
        )

    def stack_side(sides):
        Rm = max(s.slots.shape[0] for s in sides)
        Mm = max(s.slots.shape[1] for s in sides)
        slots = np.full((n_shards, Rm, Mm), per, np.int32)
        seg = np.zeros((n_shards, Rm), np.int32)
        other = np.zeros((n_shards, Rm, Mm), np.int32)
        for i, s in enumerate(sides):
            r, m = s.slots.shape
            slots[i, :r, :m] = np.asarray(s.slots)
            seg[i, :r] = np.asarray(s.seg)
            other[i, :r, :m] = np.asarray(s.other)
        # numpy leaves: placement happens in solve_distributed via
        # _put_global (multi-process-safe)
        return RowIndex(slots=slots, seg=seg, other=other)

    return EllIndex(
        cam=stack_side([e.cam for e in ells]),
        pt=stack_side([e.pt for e in ells]),
    )


def make_distributed_lm_step(mesh: Mesh, axis="obs",
                             cg_iters: int = 50, cg_tol: float = 1e-6,
                             optimize_intrinsics: bool = False,
                             deterministic: bool = True):
    """Build a jitted distributed LM step.

    Returns step(problem, ell_stacked, lam, huber_px) ->
    (new_problem, new_lam, cost, accepted).  The observation arrays and
    the stacked ELL tables must be sharded over `axis`; cameras and
    points are replicated.

    optimize_intrinsics extends the camera tangent to 14 dof (pose +
    tied-intrinsics, reference: GBA frees camera_param per physical
    camera, ba_solver.cc:330-356) — the problem must carry
    cam_kam/fix_intri/tie_f (replicated; build_problem sets them).  The
    kam-block reductions inside the Schur solve act on the already
    psum-reduced [C,...] blocks, so the sharded path needs no extra
    collectives.

    `axis` may be a single mesh axis name or a tuple of names — passing
    ("dcn", "ici") from make_pod_mesh shards the observation table over
    the full pod and reduces the camera/point blocks with one psum over
    both axes; XLA lowers that to an intra-host reduce followed by the
    (much smaller) inter-host stage (SURVEY.md §5.8).

    deterministic=True (default) replaces every cross-shard psum with
    all_gather + a fixed-order local sum over the gathered shard axis,
    and evaluates the candidate cost through the same sharded reduction.
    The solve is then bit-identical for a given shard layout REGARDLESS
    of how shards map to processes — the r4 review measured the psum
    variant forking trajectories across process counts (Gloo vs
    in-process reduction order flipping a marginal LM accept: 4.02%
    final-cost divergence at 30 cams/2000 pts/5 iters).  The gathered
    partials are camera/point-block sized (the largest is V [P,3,3]),
    so the extra traffic vs psum is n_shards x a few MB per iteration."""
    axes = (axis,) if isinstance(axis, str) else tuple(axis)
    obs_spec = P(axes)
    rep = P()
    ell_spec = EllIndex(
        cam=RowIndex(slots=obs_spec, seg=obs_spec, other=obs_spec),
        pt=RowIndex(slots=obs_spec, seg=obs_spec, other=obs_spec),
    )

    if deterministic:
        # gather per-shard partials, then sum them locally in fixed
        # global-shard order — topology-independent f32 reduction
        def red(x):
            g = jax.lax.all_gather(x, axes, axis=0)
            if len(axes) > 1:  # gathered per-axis dims -> one shard axis
                g = g.reshape((-1,) + x.shape)
            return jnp.sum(g, axis=0)
    else:
        def red(x):
            return jax.lax.psum(x, axes)

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(rep, obs_spec, obs_spec, obs_spec, obs_spec, ell_spec,
                  rep, rep),
        out_specs=(rep, rep, rep),
        check_vma=False,
    )
    def _sharded_step(prob_rep, obs_uv, obs_cam, obs_pt, obs_w, ell_st,
                      lam, huber_px):
        # drop the leading (sharded) device axis of the ELL tables
        ell = jax.tree_util.tree_map(lambda a: a[0], ell_st)
        local = dataclasses.replace(
            prob_rep, obs_uv=obs_uv, obs_cam=obs_cam, obs_pt=obs_pt,
            obs_w=obs_w,
        )
        r, z, Jc, Jp = ba_mod._residuals_and_jacobians(
            local, with_intri=optimize_intrinsics
        )
        cost_l, w = ba_mod._robust_cost_and_weight(r, z, obs_w, huber_px)
        cost = red(cost_l)
        U, V, bc, bp = ba_mod._build_normal_blocks_ell(
            local, ell, r, Jc, Jp, w, reduce_fn=red
        )
        dx_c, dx_p = ba_mod._schur_solve_ell(
            local, ell, U, V, bc, bp, Jc, Jp, w, lam, cg_iters, cg_tol,
            reduce_fn=red,
        )
        return cost, dx_c, dx_p

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(rep, obs_spec, obs_spec, obs_spec, obs_spec, rep),
        out_specs=rep,
        check_vma=False,
    )
    def _sharded_cost(prob_rep, obs_uv, obs_cam, obs_pt, obs_w, huber_px):
        local = dataclasses.replace(
            prob_rep, obs_uv=obs_uv, obs_cam=obs_cam, obs_pt=obs_pt,
            obs_w=obs_w,
        )
        r, z = ba_mod._residuals_only(local)
        cost_l, _ = ba_mod._robust_cost_and_weight(r, z, obs_w, huber_px)
        return red(cost_l)

    @jax.jit
    def step(prob: BAProblem, ell_st: EllIndex, lam,
             huber_px=jnp.float32(4.0)):
        prob_rep = dataclasses.replace(
            prob,
            obs_uv=jnp.zeros((0, 2), prob.obs_uv.dtype),
            obs_cam=jnp.zeros(0, prob.obs_cam.dtype),
            obs_pt=jnp.zeros(0, prob.obs_pt.dtype),
            obs_w=jnp.zeros(0, prob.obs_w.dtype),
        )
        cost, dx_c, dx_p = _sharded_step(
            prob_rep, prob.obs_uv, prob.obs_cam, prob.obs_pt, prob.obs_w,
            ell_st, lam, huber_px,
        )
        cand = ba_mod._apply_step(prob, dx_c, dx_p)
        # candidate cost through the SAME sharded deterministic
        # reduction as `cost` — letting GSPMD auto-partition this sum
        # would reintroduce a topology-dependent reduction order into
        # the accept test
        cand_rep = dataclasses.replace(
            cand,
            obs_uv=prob_rep.obs_uv, obs_cam=prob_rep.obs_cam,
            obs_pt=prob_rep.obs_pt, obs_w=prob_rep.obs_w,
        )
        new_cost = _sharded_cost(
            cand_rep, prob.obs_uv, prob.obs_cam, prob.obs_pt, prob.obs_w,
            huber_px,
        )
        accept = new_cost < cost
        out = jax.tree_util.tree_map(
            lambda a, b: jnp.where(accept, b, a), prob, cand
        )
        lam2 = jnp.where(accept, lam * 0.5, lam * 4.0)
        lam2 = jnp.clip(lam2, 1e-10, 1e8)
        return out, lam2, jnp.where(accept, new_cost, cost), accept

    return step


def _put_global(a, sharding):
    """Place a host array under `sharding`, multi-process-safe.

    jax.device_put cannot target non-addressable devices; on a
    multi-process (pod) mesh each process materializes only its
    addressable shards from the (replicated-on-every-host) numpy array.
    Single-process behavior is identical to device_put."""
    a = np.asarray(a)
    return jax.make_array_from_callback(
        a.shape, sharding, lambda idx: a[idx]
    )


def solve_distributed(
    mesh: Mesh,
    prob: BAProblem,
    max_iters: int = 20,
    lam0: float = 1e-4,
    huber_px: float = 4.0,
    axis="obs",
    stats: dict | None = None,
    optimize_intrinsics: bool = False,
    deterministic: bool = True,
    tol: float = 1e-6,
):
    """Host-looped distributed LM solve (each iteration is one jitted
    distributed step).  `axis` may name one mesh axis or a tuple such as
    ("dcn", "ici") for a pod mesh (parallel/mesh.make_pod_mesh).

    Stops early on a converged problem, two criteria:
      (a) solve_ba's (optim/ba.py lm_body): an ACCEPTED step whose
          relative cost decrease is < tol while damping is back near
          nominal (lam <= 10*lam0 — a tiny accepted step at high lam is
          a shrunk trust region, not convergence);
      (b) a rejection plateau: 8 CONSECUTIVE rejections (lam grows 4x
          each, so >4.5 decades of damping explored without finding a
          descent step) — the state a fresh solve on an already-settled
          map lands in, where (a) never fires because nothing is ever
          accepted.
    The per-iteration (cost, lam, accept) fetch is one device_get
    round-trip, repaid many times over by the skipped iterations on
    settled maps.

    When `stats` is a dict it receives initial_cost/final_cost/iters
    (iters = iterations actually run, like the single-chip solver)."""
    axes = (axis,) if isinstance(axis, str) else tuple(axis)
    n_dev = int(np.prod([mesh.shape[a] for a in axes]))
    w_np = np.asarray(prob.obs_w)
    nz = np.nonzero(w_np > 0)[0]
    n_valid = int(nz[-1]) + 1 if len(nz) else 0  # trailing rows are padding
    prob = shard_problem(prob, n_dev)
    ell_st = build_sharded_ell(prob, n_dev, n_valid=n_valid)
    sharding = NamedSharding(mesh, P(axes))
    rep = NamedSharding(mesh, P())
    prob = dataclasses.replace(
        prob,
        obs_uv=_put_global(prob.obs_uv, sharding),
        obs_cam=_put_global(prob.obs_cam, sharding),
        obs_pt=_put_global(prob.obs_pt, sharding),
        obs_w=_put_global(prob.obs_w, sharding),
        cam_q=_put_global(prob.cam_q, rep),
        cam_t=_put_global(prob.cam_t, rep),
        cam_intri=_put_global(prob.cam_intri, rep),
        points=_put_global(prob.points, rep),
        fix_cam=_put_global(prob.fix_cam, rep),
        fix_trans=_put_global(prob.fix_trans, rep),
        fix_pt=_put_global(prob.fix_pt, rep),
        cam_kam=(
            _put_global(prob.cam_kam, rep)
            if prob.cam_kam is not None else None
        ),
        fix_intri=(
            _put_global(prob.fix_intri, rep)
            if prob.fix_intri is not None else None
        ),
        tie_f=(
            _put_global(prob.tie_f, rep)
            if prob.tie_f is not None else None
        ),
    )
    ell_st = jax.tree_util.tree_map(
        lambda a: _put_global(a, sharding), ell_st
    )
    if optimize_intrinsics and (
        prob.cam_kam is None or prob.fix_intri is None
    ):
        raise ValueError(
            "optimize_intrinsics requires cam_kam/fix_intri on the problem"
        )
    step = make_distributed_lm_step(
        mesh, axis=axes, optimize_intrinsics=optimize_intrinsics,
        deterministic=deterministic,
    )
    lam = jnp.asarray(lam0, jnp.float32)
    cost = None
    prev_cost = None
    iters_run = 0
    consec_rejects = 0
    for it in range(max_iters):
        lam_before = lam
        prob, lam, cost, accepted = step(prob, ell_st, lam, jnp.float32(huber_px))
        # ONE host fetch for the stop test (scalars only)
        cost_f, lam_f, acc_f = jax.device_get((cost, lam_before, accepted))
        iters_run = it + 1
        if it == 0 and stats is not None:
            stats["initial_cost"] = float(cost_f)
        if bool(acc_f):
            consec_rejects = 0
            if prev_cost is not None:
                rel = abs(prev_cost - float(cost_f)) / max(prev_cost, 1e-12)
                if rel < tol and float(lam_f) <= 10.0 * lam0:
                    prev_cost = float(cost_f)
                    break
        else:
            consec_rejects += 1
            if consec_rejects >= 8:
                prev_cost = float(cost_f)
                break
        prev_cost = float(cost_f)
    if stats is not None:
        stats["final_cost"] = float(cost)
        stats["iters"] = iters_run
    return prob, float(cost)
