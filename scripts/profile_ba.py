"""Phase breakdown of the bench LM step on the live device.

Times jitted sub-graphs of the LM iteration, each run as a lax.scan of
`--iters` steps inside one jit and synced with jax.block_until_ready
(best of a few runs, per step):

  residuals       _residuals_only               (cost evaluation)
  jac+normal      _residuals_and_jacobians + _build_normal_blocks_ell
  full(cg=k)      whole lm_step at k inner PCG iterations

The per-CG-iteration cost is the slope of full(cg) over k; the
remainder (full(0) - jac+normal - residuals) is the Schur setup
(Y build + preconditioner) + apply/accept.  Prints one JSON dict.

Usage: python scripts/profile_ba.py [--cams N] [--pts N] [--iters N]
"""

import argparse
import json
import sys
import time
import os

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cams", type=int, default=200)
    ap.add_argument("--pts", type=int, default=20000)
    ap.add_argument("--obs_per_pt", type=int, default=7)
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--cam_width", type=int, default=128)
    ap.add_argument("--pt_width", type=int, default=32)
    ap.add_argument("--cpu", action="store_true")
    # --roofline: compile each phase once and report XLA's
    # cost-analysis "bytes accessed".  CAVEAT: this is a PRE-FUSION
    # upper bound — every instruction's operands are counted as if
    # materialized, and loop bodies are counted once regardless of trip
    # count (full_cg0 == full_cg8) — so it bounds, but does not equal,
    # real device-memory traffic.
    ap.add_argument("--roofline", action="store_true")
    args = ap.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from xrsfm_tpu import enable_compilation_cache

    enable_compilation_cache()
    import bench
    from xrsfm_tpu.optim import ba as ba_mod

    prob, ell, n_obs = bench.make_ba_problem(
        args.cams, args.pts, args.obs_per_pt,
        cam_width=args.cam_width, pt_width=args.pt_width,
    )
    print(f"device={jax.devices()[0].platform} n_obs={n_obs} "
          f"table_slots={len(prob.obs_cam)} "
          f"cam_rows={ell.cam.slots.shape} pt_rows={ell.pt.slots.shape}",
          file=sys.stderr)

    def scan_time(step_fn, length, reps=2):
        """Time `length` applications of step_fn inside one scan dispatch.

        step_fn: (p, lam, tick) -> (p2, lam2, scalar).  tick is an
        iteration-dependent scalar folded in so XLA cannot hoist the body
        out of the loop when p2 == p."""
        import functools

        @functools.partial(jax.jit, static_argnames=("n",))
        def run(p, lam, n):
            def body(carry, tick):
                p_, lam_, _ = carry
                return step_fn(p_, lam_, tick), None

            carry, _ = jax.lax.scan(
                body, (p, lam, jnp.float32(0.0)),
                jnp.arange(n, dtype=jnp.float32), length=n,
            )
            return carry[2]

        lam = jnp.float32(1e-4)
        jax.block_until_ready(run(prob, lam, length))  # compile + warm
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            jax.block_until_ready(run(prob, lam, length))
            best = min(best, time.perf_counter() - t0)
        return best / length

    def w_row(p):
        return p.obs_w.reshape(ell.cam.slots.shape)

    # --- phase: residuals only
    def res_step(p, lam, tick):
        import dataclasses

        p2 = dataclasses.replace(
            p, points=p.points + tick * 1e-12, cam_t=p.cam_t + tick * 1e-12,
        )
        r, z = ba_mod._residuals_only_rows(p2, ell)
        c, _ = ba_mod._robust_cost_and_weight(r, z, w_row(p2), 4.0)
        return p, lam, c

    # --- phase: residuals + jacobians + normal blocks
    def jn_step(p, lam, tick):
        import dataclasses

        p2 = dataclasses.replace(
            p, points=p.points + tick * 1e-12, cam_t=p.cam_t + tick * 1e-12,
        )
        r, z, Jc, Jp = ba_mod._residuals_and_jacobians_rows(p2, ell)
        c, w = ba_mod._robust_cost_and_weight(r, z, w_row(p2), 4.0)
        if ell.pt_uv is not None:  # mirror solve_ba's pt-native dispatch
            U, bc = ba_mod._build_normal_blocks_ell(
                p2, ell, r, Jc, Jp, w, cam_only=True
            )
            V, bp, _ = ba_mod._build_pt_blocks_native(p2, ell, 4.0)
        else:
            U, V, bc, bp = ba_mod._build_normal_blocks_ell(
                p2, ell, r, Jc, Jp, w
            )
        return p, lam, c + jnp.sum(bc) * 1e-30 + jnp.sum(bp) * 1e-30 + \
            jnp.sum(U) * 1e-30 + jnp.sum(V) * 1e-30

    # --- Schur setup sub-phases (mirrors the PRODUCTION pt-native +
    # weighted-operand path of solve_ba/_schur_solve_ell)
    def setup_probe(upto):
        def step(p, lam, tick):
            import dataclasses

            p2 = dataclasses.replace(
                p, points=p.points + tick * 1e-12,
                cam_t=p.cam_t + tick * 1e-12,
            )
            r, z, Jc, Jp = ba_mod._residuals_and_jacobians_rows(p2, ell)
            c, w = ba_mod._robust_cost_and_weight(r, z, w_row(p2), 4.0)
            U, bc, Jcw = ba_mod._build_normal_blocks_ell(
                p2, ell, r, Jc, Jp, w, cam_only=True, return_cam_w=True
            )
            V, bp, (Jpg, spg) = ba_mod._build_pt_blocks_native(p2, ell, 4.0)
            D = Jc.shape[-1]
            eyeD = jnp.eye(D, dtype=U.dtype)
            eye3 = jnp.eye(3, dtype=U.dtype)
            Ud = U + lam * (U * eyeD) + 1e-8 * eyeD
            Vd = V + lam * (V * eye3) + 1e-8 * eye3
            Vinv = ba_mod._inv3x3(Vd)
            L = ba_mod._chol3x3(Vinv)
            cd = jnp.bfloat16
            ptm = (~p2.fix_pt).astype(w.dtype)
            C = p2.cam_q.shape[0]
            P = p2.points.shape[0]
            L_row = L.astype(cd)[ell.pt.seg]
            sw = jnp.sqrt(jnp.maximum(spg[..., 0].astype(w.dtype), 0.0))
            wrow = (sw * ptm[ell.pt.seg][:, None]).astype(cd)
            Zpt = (jnp.einsum("rlij,rjk->rlik", Jpg, L_row)
                   * wrow[..., None, None])
            out = c + jnp.sum(Zpt.astype(jnp.float32)) * 1e-30
            if upto == "Zpt":
                return p, lam, out
            m6post = ba_mod._cam_colmask(p2, False)
            u = jnp.einsum("pji,pj->pi", L, bp)
            zrow = u[ell.pt.seg].astype(cd)
            b_pt = jnp.einsum("rlik,rk->rli", Zpt, zrow)
            b = ba_mod._gather_obs(b_pt.reshape(-1, 2), ell.pt_pos)
            trow = jnp.einsum("rmid,rmi->rd", Jcw, b,
                              preferred_element_type=jnp.float32)
            rhs = bc - jax.ops.segment_sum(
                trow, ell.cam.seg, num_segments=C
            ) * m6post
            out = out + jnp.sum(rhs) * 1e-30
            if upto == "rhs":
                return p, lam, out
            Rc, Mc = ell.cam.slots.shape
            Gz_pt = jnp.einsum("rlik,rljk->rlij", Zpt, Zpt,
                               preferred_element_type=jnp.float32)
            Gz = ba_mod._gather_obs(
                Gz_pt.astype(cd).reshape(-1, 2, 2), ell.pt_pos
            )
            Hz = jnp.einsum("rmij,rmjd->rmid", Gz.astype(cd), Jcw,
                            preferred_element_type=jnp.float32).astype(cd)
            S_rows = jax.lax.dot_general(
                Jcw.reshape(Rc, Mc * 2, D), Hz.reshape(Rc, Mc * 2, D),
                (((1,), (1,)), ((0,), (0,))),
                preferred_element_type=jnp.float32,
            )
            corr = jax.ops.segment_sum(S_rows, ell.cam.seg, num_segments=C)
            Sdiag = Ud - corr * (m6post[:, :, None] * m6post[:, None, :])
            Sdiag = Sdiag + 1e-7 * eyeD
            Minv = ba_mod._inv_spd(Sdiag)
            out = out + jnp.sum(Minv) * 1e-30
            if upto == "Sdiag":
                return p, lam, out
            return p, lam, out

        return step

    # --- full lm_step at k CG iterations
    def full_step_k(k):
        def step(p, lam, tick):
            r, z, Jc, Jp = ba_mod._residuals_and_jacobians_rows(p, ell)
            cost, w = ba_mod._robust_cost_and_weight(r, z, w_row(p), 4.0)
            camw = None
            if ell.pt_uv is not None:  # mirror solve_ba's dispatch
                U, bc, camw = ba_mod._build_normal_blocks_ell(
                    p, ell, r, Jc, Jp, w, cam_only=True, return_cam_w=True
                )
                V, bp, ptg = ba_mod._build_pt_blocks_native(p, ell, 4.0)
            else:
                U, V, bc, bp, ptg = ba_mod._build_normal_blocks_ell(
                    p, ell, r, Jc, Jp, w, return_pt_gathers=True
                )
            dx_c, dx_p = ba_mod._schur_solve_ell(
                p, ell, U, V, bc, bp, Jc, Jp, w, lam, k, 1e-20,
                pt_gathers=ptg, cam_w=camw,
            )
            cand = ba_mod._apply_step(p, dx_c, dx_p)
            r2, z2 = ba_mod._residuals_only_rows(cand, ell)
            c2, _ = ba_mod._robust_cost_and_weight(r2, z2, w_row(p), 4.0)
            accept = c2 < cost
            out = ba_mod._select_accept(accept, p, cand)
            lam2 = jnp.clip(
                jnp.where(accept, lam * 0.5, lam * 4.0), 1e-10, 1e8
            )
            return out, lam2, jnp.where(accept, c2, cost)

        return step

    def phase_bytes(step_fn):
        """XLA cost-analysis bytes accessed for one compiled application
        of the phase (read+write device-memory traffic of the graph)."""
        lam = jnp.float32(1e-4)

        def once(p, lam):
            return step_fn(p, lam, jnp.float32(1.0))[2]

        comp = jax.jit(once).lower(prob, lam).compile()
        ca = comp.cost_analysis()
        d = ca[0] if isinstance(ca, (list, tuple)) else ca
        return float(d.get("bytes accessed", float("nan")))

    N = args.iters
    out = {}
    if args.roofline:
        phases = {
            "residuals": res_step,
            "jac_normal": jn_step,
            "setup_Zpt": setup_probe("Zpt"),
            "setup_rhs": setup_probe("rhs"),
            "setup_Sdiag": setup_probe("Sdiag"),
            "full_cg0": full_step_k(0),
            "full_cg4": full_step_k(4),
            "full_cg8": full_step_k(8),
        }
        rb = {k: phase_bytes(fn) for k, fn in phases.items()}
        rb["per_cg_iter"] = (rb["full_cg8"] - rb["full_cg0"]) / 8.0
        out["xla_prefusion_bytes_upper_bound_mb"] = {
            k: round(v / 1e6, 2) for k, v in rb.items()
        }
        out["table_slots"] = int(len(prob.obs_cam))
        out["n_obs"] = int(n_obs)
        print(json.dumps(out))
        return
    out["residuals_ms"] = scan_time(res_step, N) * 1e3
    out["jac_normal_ms"] = scan_time(jn_step, N) * 1e3
    for upto in ("Zpt", "rhs", "Sdiag"):
        out[f"setup_{upto}_ms"] = scan_time(setup_probe(upto), N) * 1e3
    for k in (0, 2, 4, 8):
        out[f"full_cg{k}_ms"] = scan_time(full_step_k(k), N) * 1e3
    out["per_cg_iter_ms"] = (out["full_cg8_ms"] - out["full_cg0_ms"]) / 8.0
    out["schur_setup_apply_ms"] = (
        out["full_cg0_ms"] - out["jac_normal_ms"] - out["residuals_ms"]
    )
    out["iters_per_s_cg4"] = 1e3 / out["full_cg4_ms"]
    print(json.dumps({k: round(v, 3) for k, v in out.items()}))


if __name__ == "__main__":
    main()
