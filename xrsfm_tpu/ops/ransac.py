"""Vectorized RANSAC / LO-RANSAC harness.

Batched re-design of the reference's sequential adaptive RANSAC
(reference: src/geometry/colmap/optim/ransac.h:74-269 and loransac.h:51-243).
Instead of an adaptive trial loop with early exit, a fixed batch of B
hypotheses is sampled at once, every model is scored against every point as
one [B*M, N] residual matrix, and the argmax-support model
wins.  Support follows COLMAP's MSAC-style measurer: maximize inlier count,
tie-broken by minimal truncated residual sum
(src/geometry/colmap/optim/support_measurement.cc:44-78).

Sampling uses Gumbel top-k over the validity mask = uniform sampling without
replacement among valid entries, with a counter-based key so results are
deterministic for a given (seed, problem) — the reference pins its PRNG seed
for the same reason (src/geometry/essential.cc:393).

Local optimization (the "LO" in LO-RANSAC) is expressed as a refit callback
on the current inlier set, iterated a fixed number of times — equivalent in
role to loransac.h's LocalEstimator refit.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp


class RansacResult(NamedTuple):
    model: jax.Array  # best model parameters (estimator-specific pytree/array)
    inliers: jax.Array  # [N] bool
    num_inliers: jax.Array  # scalar int32
    score: jax.Array  # scalar float32 (truncated residual sum, lower=better)
    success: jax.Array  # scalar bool


def _sample_indices(key, mask, num_hypotheses, sample_size):
    """[B, k] indices drawn uniformly without replacement among mask==True."""
    n = mask.shape[0]
    g = jax.random.gumbel(key, (num_hypotheses, n))
    g = jnp.where(mask[None, :], g, -jnp.inf)
    _, idx = jax.lax.top_k(g, sample_size)
    return idx


def ransac(
    key: jax.Array,
    data,
    mask: jax.Array,
    estimate_fn: Callable,
    residual_fn: Callable,
    sample_size: int,
    threshold: float,
    num_hypotheses: int = 512,
    refit_fn: Callable | None = None,
    lo_iters: int = 2,
    min_inliers: int = 0,
) -> RansacResult:
    """Run batched (LO-)RANSAC.

    data: pytree whose leaves have leading dim N (padded points).
    mask: [N] bool — valid entries of the padded pool.
    estimate_fn(sampled_data, sample_valid) -> (models, model_valid)
        sampled_data: pytree sliced to [k, ...]; returns models with leading
        dim M (fixed number of candidate models per sample) and [M] bool.
    residual_fn(models, data) -> [M, N] residuals (same metric as threshold).
    refit_fn(data, weight_mask) -> (model_1, valid_1): least-squares refit on
        the weighted inlier set; model_1 has the same shape as one model.
    """
    n = mask.shape[0]
    k_sample, key = jax.random.split(key)
    idx = _sample_indices(k_sample, mask, num_hypotheses, sample_size)  # [B,k]
    sample_valid = jnp.take(mask, idx, axis=0)  # [B,k] (all True unless <k valid)

    sampled = jax.tree_util.tree_map(lambda a: jnp.take(a, idx, axis=0), data)

    models, model_valid = jax.vmap(estimate_fn)(sampled, sample_valid)
    # flatten hypothesis x models-per-sample
    flat_models = jax.tree_util.tree_map(
        lambda a: a.reshape((-1,) + a.shape[2:]), models
    )
    flat_valid = model_valid.reshape(-1)  # [B*M]

    res = jax.vmap(residual_fn, in_axes=(0, None))(flat_models, data)  # [B*M, N]
    res = jnp.where(mask[None, :], res, jnp.inf)
    res = jnp.where(flat_valid[:, None], res, jnp.inf)

    inl = res <= threshold
    counts = jnp.sum(inl, axis=-1)
    scores = jnp.sum(jnp.minimum(res, threshold), axis=-1)
    scores = jnp.where(jnp.isfinite(scores), scores, jnp.inf)
    # maximize count, tie-break by minimal truncated score
    order_key = counts.astype(jnp.float32) - scores / (
        threshold * jnp.maximum(n, 1) + 1.0
    )
    best = jnp.argmax(order_key)

    best_model = jax.tree_util.tree_map(lambda a: a[best], flat_models)
    best_inl = inl[best]
    best_count = counts[best]
    best_score = scores[best]
    success = flat_valid[best] & (best_count >= max(sample_size, min_inliers))

    if refit_fn is not None:
        def lo_step(_, carry):
            model, inliers, count, score, ok = carry
            new_model, new_valid = refit_fn(data, inliers & mask)
            r = residual_fn(
                jax.tree_util.tree_map(lambda a: a[None], new_model), data
            )[0]
            r = jnp.where(mask, r, jnp.inf)
            r = jnp.where(new_valid, r, jnp.inf)
            new_inl = r <= threshold
            new_count = jnp.sum(new_inl)
            new_score = jnp.sum(jnp.minimum(r, threshold))
            new_score = jnp.where(jnp.isfinite(new_score), new_score, jnp.inf)
            better = (new_count > count) | (
                (new_count == count) & (new_score < score)
            )
            better = better & new_valid
            model = jax.tree_util.tree_map(
                lambda old, new: jnp.where(better, new, old), model, new_model
            )
            inliers = jnp.where(better, new_inl, inliers)
            count = jnp.where(better, new_count, count)
            score = jnp.where(better, new_score, score)
            return model, inliers, count, score, ok

        best_model, best_inl, best_count, best_score, success = jax.lax.fori_loop(
            0,
            lo_iters,
            lo_step,
            (best_model, best_inl, best_count, best_score, success),
        )

    return RansacResult(
        model=best_model,
        inliers=best_inl & success,
        num_inliers=jnp.where(success, best_count, 0),
        score=best_score,
        success=success,
    )
