"""Batched polynomial root finding for minimal solvers.

XLA has no nonsymmetric eigensolver on accelerators (companion-matrix
eig is CPU-only), so roots are found with a fixed-iteration
Durand-Kerner (Weierstrass) simultaneous iteration over explicit
(re, im) float pairs — branch-free, vmappable and jit-friendly.  Used by the P3P quartic and
the 7-point cubic (reference equivalents use companion-matrix or
Eigen::EigenSolver eigenvalues:
src/geometry/colmap/estimators/absolute_pose.cc:50-186,
src/geometry/essential.cc:202-218).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def _cmul(ar, ai, br, bi):
    return ar * br - ai * bi, ar * bi + ai * br


def _cdiv(ar, ai, br, bi):
    d = br * br + bi * bi
    d = jnp.maximum(d, 1e-30)
    return (ar * br + ai * bi) / d, (ai * br - ar * bi) / d


def poly_roots(coeffs: jax.Array, iters: int = 60):
    """Roots of a real polynomial, coefficients highest-degree first.

    coeffs: [..., d+1] real; returns (re [..., d], im [..., d]).
    """
    coeffs = coeffs.astype(jnp.float32)
    lead = coeffs[..., :1]
    lead = jnp.where(jnp.abs(lead) < 1e-12, 1e-12, lead)
    c = coeffs / lead  # monic, real
    d = c.shape[-1] - 1

    # rescale the variable by the Fujiwara root bound so all roots lie in
    # ~the unit disk — float32 Durand-Kerner overflows/diverges when root
    # magnitudes are far from 1
    k1 = jnp.arange(1, d + 1, dtype=jnp.float32)
    mags = jnp.abs(c[..., 1:]) + 1e-30
    R = 2.0 * jnp.max(mags ** (1.0 / k1), axis=-1)
    R = jnp.clip(R, 1e-6, 1e6)[..., None]  # [..., 1]
    # substitute z = R * w: coefficient of w^(d-k) is c_k / R^k
    powers = R ** jnp.arange(d + 1, dtype=jnp.float32)
    c = c / powers

    # initial guesses: powers of (0.4 + 0.9i) (inside/near the unit disk)
    k = jnp.arange(d)
    ang = jnp.arctan2(0.9, 0.4) * (k + 1)
    mag = (jnp.sqrt(0.4**2 + 0.9**2)) ** ((k + 1) % 7 + 1)
    zr0 = jnp.broadcast_to(mag * jnp.cos(ang), c[..., 1:].shape)
    zi0 = jnp.broadcast_to(mag * jnp.sin(ang), c[..., 1:].shape)

    def poly_eval(zr, zi):
        def body(i, acc):
            ar, ai = acc
            ar, ai = _cmul(ar, ai, zr, zi)
            return ar + c[..., i][..., None], ai

        return jax.lax.fori_loop(1, d + 1, body, (jnp.ones_like(zr), jnp.zeros_like(zi)))

    def step(_, z):
        zr, zi = z
        # denominator prod_{j != i} (z_i - z_j) with 1 on the diagonal
        dr = zr[..., :, None] - zr[..., None, :]
        di = zi[..., :, None] - zi[..., None, :]
        eye = jnp.eye(d, dtype=zr.dtype)
        dr = dr + eye
        # batched complex product along axis -1 via scan over d
        def prod_body(j, acc):
            ar, ai = acc
            return _cmul(ar, ai, dr[..., :, j], di[..., :, j])

        denr, deni = jax.lax.fori_loop(
            0, d, prod_body, (jnp.ones_like(zr), jnp.zeros_like(zi))
        )
        pr, pi = poly_eval(zr, zi)
        qr, qi = _cdiv(pr, pi, denr, deni)
        return zr - qr, zi - qi

    zr, zi = jax.lax.fori_loop(0, iters, step, (zr0, zi0))
    return zr * R, zi * R  # undo the variable scaling


def real_roots(coeffs: jax.Array, imag_tol: float = 1e-4, iters: int = 60):
    """Return (roots_real [..., d], valid_mask [..., d]) keeping only roots
    with small imaginary part relative to magnitude."""
    zr, zi = poly_roots(coeffs, iters=iters)
    mag = jnp.maximum(jnp.sqrt(zr * zr + zi * zi), 1.0)
    valid = jnp.abs(zi) < imag_tol * mag
    return zr, valid
