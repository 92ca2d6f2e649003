"""Global pose polish: rotation averaging + robust translation recovery.

BA is a local method: on long circuits the incremental map parks in a
drift basin the observations do not actually prefer (measured on the
250-frame kitti-class circuit: the drifted basin's GBA cost is 63k vs
38.7k when the same machinery starts from ground truth — a genuinely
worse local minimum that no amount of further BA, track filtering, or
full re-triangulation escapes; all measured r3, docs/benchmark.md).
This module mounts the global escape the reference lacks entirely (its
pose graph is translation+scale only and runs only at loop-correction
time, ba_solver.cc:147-328):

  1. re-measure every verified pair's relative pose (R, t-direction)
     from match coordinates alone (rot_avg.measure_pair_rotations:
     batched 5pt LO-RANSAC + essential-manifold IRLS refinement);
  2. rotation averaging over the measured R graph (rot_avg);
  3. translation recovery: camera centers from the measured unit
     directions d_e = -R_i^T R_e^T t_e under the SOLVED rotations, by
     alternating a per-edge-scale robust least squares
         min_c sum_e w_e || (c_j - c_i) - s_e d_e ||^2
     with s_e = clip(d_e . (c_j - c_i), [0.5, 2] x current map edge
     length).  The scale clamp anchors the solution to the map's
     locally-trustworthy metric and removes the collapse degeneracy
     that kills projection-objective translation averaging on
     near-collinear sequential graphs (measured: the unclamped
     projection form collapses to 34% ATE; this form reaches 1.56%
     from a 2.30% drifted start).

Caller must retriangulate all tracks and re-run GBA afterwards (the
same contract as rotation_averaging_polish).

Device-first: measurement is one batched dispatch; both solvers are single
jitted programs (fori_loop IRLS rounds, Jacobi-preconditioned CG on
graph Laplacians via scatter-adds).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from . import rot_avg
from ..utils import geometry as G

__all__ = ["solve_translation_averaging", "global_pose_polish"]


@partial(jax.jit, static_argnums=(6, 7, 8))
def _solve_ta_jit(c0, ei, ej, d, s0, w0, N, rounds, cg_iters):
    """Alternating robust least squares for camera centers.

    c0 [N,3] initial centers (node 0 is the gauge pin), ei/ej [E] int32,
    d [E,3] unit world directions, s0 [E] initial (map) edge lengths,
    w0 [E] base weights.  Returns (c [N,3], median residual)."""

    # initial gross-outlier gate: the map is locally right even when
    # globally drifted, so a measured direction disagreeing with the
    # CURRENT map direction by >30 deg is garbage (random directions
    # pass this with probability ~7%; genuine edges under a few-percent
    # drift always pass).  IRLS handles the rest.
    dc0 = c0[ej] - c0[ei]
    dc0n = dc0 / jnp.maximum(
        jnp.linalg.norm(dc0, axis=1, keepdims=True), 1e-12
    )
    agree = jnp.sum(dc0n * d, axis=1)
    w0 = w0 * jnp.where(agree > 0.866, 1.0, 1e-3)

    def round_fn(k, carry):
        c, s, w = carry

        def matvec(x):
            u = (x[ej] - x[ei]) * w[:, None]
            out = jnp.zeros((N, 3), jnp.float32)
            out = out.at[ej].add(u).at[ei].add(-u)
            return out.at[0].set(x[0])

        be = s[:, None] * d * w[:, None]
        b = jnp.zeros((N, 3), jnp.float32)
        b = b.at[ej].add(be).at[ei].add(-be)
        b = b.at[0].set(c0[0])

        deg = jnp.zeros(N, jnp.float32).at[ej].add(w).at[ei].add(w)
        deg = jnp.maximum(deg, 1e-9).at[0].set(1.0)
        precond = 1.0 / deg[:, None]

        x = c
        r = b - matvec(x)
        z = precond * r
        p = z
        rz = jnp.sum(r * z)

        def cg_body(_i, st):
            x, p, r, rz = st
            Ap = matvec(p)
            alpha = rz / jnp.maximum(jnp.sum(p * Ap), 1e-20)
            x = x + alpha * p
            r = r - alpha * Ap
            z = precond * r
            rz_new = jnp.sum(r * z)
            beta = rz_new / jnp.maximum(rz, 1e-20)
            return x, z + beta * p, r, rz_new

        x, _, _, _ = jax.lax.fori_loop(0, cg_iters, cg_body, (x, p, r, rz))

        dc = x[ej] - x[ei]
        s_new = jnp.clip(jnp.sum(dc * d, axis=1), 0.5 * s0, 2.0 * s0)
        resid = jnp.linalg.norm(dc - s_new[:, None] * d, axis=1)
        # redescending (Geman-McClure) IRLS on the ANGULAR residual
        # (metric residual / edge length): a Huber-style 1/r weight
        # leaves gross-outlier edges with unbounded total pull (measured:
        # 10% random-direction edges held a 5% ATE floor), and a metric
        # residual scale would crush the long loop-closure edges whose
        # absolute residual is large at equal direction error — exactly
        # the edges the drift correction needs.
        rang = resid / jnp.maximum(s_new, 1e-9)
        sigma = jnp.maximum(jnp.median(rang) * 1.48, 1e-9)
        w_new = w0 / jnp.square(1.0 + jnp.square(rang / (3.0 * sigma)))
        return x, s_new, w_new

    s = s0
    c, s, w = jax.lax.fori_loop(0, rounds, round_fn, (c0, s, w0))
    dc = c[ej] - c[ei]
    resid = jnp.linalg.norm(dc - s[:, None] * d, axis=1)
    return c, jnp.median(resid)


def solve_translation_averaging(
    c0: np.ndarray,
    ei: np.ndarray,
    ej: np.ndarray,
    d: np.ndarray,
    s_init: np.ndarray,
    w: np.ndarray,
    rounds: int = 6,
    cg_iters: int = 80,
):
    """Numpy wrapper around the jitted alternation.  Returns (c, median
    residual in map units)."""
    N = len(c0)
    c, med = _solve_ta_jit(
        jnp.asarray(c0, jnp.float32), jnp.asarray(ei), jnp.asarray(ej),
        jnp.asarray(d, jnp.float32), jnp.asarray(s_init, jnp.float32),
        jnp.asarray(w, jnp.float32), N, int(rounds), int(cg_iters),
    )
    c, med = jax.device_get((c, med))
    return np.asarray(c, np.float64), float(med)


def global_pose_polish(m, min_inliers: int = 30, log=None,
                       parallax: str = "off") -> bool:
    """Measure pair poses once, run rotation averaging, then translation
    recovery; rewrite the registered frames' poses.  Returns True if the
    map was rewritten (caller must retriangulate ALL tracks + GBA).

    parallax: weight edges by their measured rotation-compensated flow
    (the translation direction's conditioning — a low-parallax pair's
    direction is mostly noise): "off" (support only), "lin" (w ∝
    parallax, the 1/sigma weighting for direction error ∝ noise/
    parallax), "sq" (w ∝ parallax², the full inverse-variance form).
    Measured on the 250-frame circuit (scripts/exp_circuit.py): the TA
    fixed point is 1.18% ATE at "off", 1.17% at "lin", 1.51% at "sq" —
    conditioning weights do not beat support weights on a sequential
    graph (the direction-noise tail is not parallax-driven there), so
    the default stays "off"."""
    reg = np.nonzero(m.registered)[0]
    if len(reg) < 10:
        return False
    meas = rot_avg.measure_pair_rotations(m, min_inliers=min_inliers)
    rotated = rot_avg.rotation_averaging_polish(
        m, min_inliers=min_inliers, log=log, measurements=meas
    )
    if not rotated:
        return False
    ei, ej, q_meas, t_meas, sup, par = meas
    keep = sup >= float(min_inliers)
    keep &= m.registered[ei] & m.registered[ej]
    ei, ej = ei[keep], ej[keep]
    q_meas, t_meas, sup, par = (
        q_meas[keep], t_meas[keep], sup[keep], par[keep]
    )
    if len(ei) < len(reg):
        if log:
            log("global-pose: too few usable edges for translation "
                "recovery, keeping rotations only")
        return True

    # world directions under the SOLVED rotations:
    # c_j - c_i = -R_i^T R_e^T t_e * |baseline|
    Ri = G.quat_to_rotmat_np(np.asarray(m.q[ei], np.float64))
    Re = G.quat_to_rotmat_np(np.asarray(q_meas, np.float64))
    v = -np.einsum("eji,ejk,ek->ei", Ri, np.transpose(Re, (0, 2, 1)),
                   np.asarray(t_meas, np.float64))
    # ^ -R_i^T (R_e^T t_e)
    nrm = np.linalg.norm(v, axis=1, keepdims=True)
    d = v / np.maximum(nrm, 1e-12)

    # compress to registered-index space (node 0 of the problem = first
    # registered frame, the gauge pin)
    remap = -np.ones(m.num_frames, np.int64)
    remap[reg] = np.arange(len(reg))
    ei_c = remap[ei].astype(np.int32)
    ej_c = remap[ej].astype(np.int32)
    c_all = G.pose_center_np(np.asarray(m.q), np.asarray(m.t))
    c0 = np.asarray(c_all[reg], np.float64)
    s_init = np.linalg.norm(c0[ej_c] - c0[ei_c], axis=1)
    usable = s_init > 1e-9
    ei_c, ej_c, d, s_init = ei_c[usable], ej_c[usable], d[usable], \
        s_init[usable]
    sup_u, par_u = sup[usable], par[usable]
    if len(ei_c) < len(reg):
        return True
    w = np.sqrt(np.minimum(sup_u, 512.0))
    if parallax != "off":
        # conditioning weight: direction error ~ match-noise / parallax,
        # so 1/sigma ~ parallax ("lin"); "sq" is inverse-variance.  The
        # reference scale is the edge-set median (scene-adaptive), capped
        # at 4x so a handful of huge-baseline edges cannot monopolize.
        p_ref = max(float(np.median(par_u)), 1e-4)
        cw = np.clip(par_u / p_ref, 0.02, 4.0)
        w = w * (cw if parallax == "lin" else cw * cw)
    c_new, med = solve_translation_averaging(c0, ei_c, ej_c, d, s_init, w)
    move = np.linalg.norm(c_new - c0, axis=1)
    if log:
        log(f"global-pose: translation recovery over {len(ei_c)} edges, "
            f"median center move {np.median(move):.3f} "
            f"(max {move.max():.3f}), median residual {med:.4f}")
    R_new = G.quat_to_rotmat_np(np.asarray(m.q[reg], np.float64))
    m.t[reg] = -np.einsum("nij,nj->ni", R_new, c_new)
    return True
