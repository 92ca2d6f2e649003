"""Nister 5-point essential matrix minimal solver, accelerator-lowerable.

(reference: solve_essential_5pt, src/geometry/essential.cc:105-304 — the
reference builds the 10x20 Groebner system with a custom Polynomial class
and eigendecomposes a 10x10 action matrix.  XLA has no nonsymmetric
eig on accelerators, so this implementation follows Nister's original elimination instead:
reduce the 10x20 constraint system, form the 3x3 polynomial matrix B(z)
whose determinant is the degree-10 polynomial, root it with the batched
Durand-Kerner iteration (ops/poly.py), and back-substitute (x, y) per
root.)

All polynomial expansion happens at trace time over Python dicts of
exponent tuples; the generated computation is pure fused arithmetic —
branch-free, vmappable over RANSAC samples.
"""

from __future__ import annotations

from typing import Dict, Tuple

import jax
import jax.numpy as jnp

from . import poly as rootfind

Mono = Tuple[int, int, int]  # exponents of (x, y, z)

# column order of the 10x20 constraint matrix
_FIRST10 = [
    (3, 0, 0), (0, 3, 0), (2, 1, 0), (1, 2, 0), (2, 0, 1),
    (2, 0, 0), (0, 2, 1), (0, 2, 0), (1, 1, 1), (1, 1, 0),
]
_LAST10 = [
    (1, 0, 2), (1, 0, 1), (1, 0, 0), (0, 1, 2), (0, 1, 1),
    (0, 1, 0), (0, 0, 3), (0, 0, 2), (0, 0, 1), (0, 0, 0),
]
_COLS = {m: i for i, m in enumerate(_FIRST10 + _LAST10)}


def _pmul(a: Dict[Mono, jax.Array], b: Dict[Mono, jax.Array]):
    out: Dict[Mono, jax.Array] = {}
    for ma, ca in a.items():
        for mb, cb in b.items():
            m = (ma[0] + mb[0], ma[1] + mb[1], ma[2] + mb[2])
            v = ca * cb
            out[m] = out[m] + v if m in out else v
    return out


def _padd(a, b, sign=1.0):
    out = dict(a)
    for m, c in b.items():
        out[m] = out[m] + sign * c if m in out else sign * c
    return out


def _row(p: Dict[Mono, jax.Array]) -> jax.Array:
    """Polynomial dict -> length-20 coefficient row."""
    cols = [None] * 20
    zero = None
    for m, c in p.items():
        cols[_COLS[m]] = c
        zero = jnp.zeros_like(c)
    return jnp.stack([c if c is not None else zero for c in cols])


def _essential_constraints(E_basis: jax.Array) -> jax.Array:
    """E_basis [4, 3, 3] (E = x*B0 + y*B1 + z*B2 + B3) -> M [10, 20]."""
    # entries of E as degree-1 polynomial dicts
    ent = [[None] * 3 for _ in range(3)]
    monos = [(1, 0, 0), (0, 1, 0), (0, 0, 1), (0, 0, 0)]
    for i in range(3):
        for j in range(3):
            ent[i][j] = {m: E_basis[k, i, j] for k, m in enumerate(monos)}

    rows = []
    # det(E) = 0
    det = {}
    for (a, b, c, s) in (
        (0, 1, 2, 1.0), (1, 2, 0, 1.0), (2, 0, 1, 1.0),
        (2, 1, 0, -1.0), (1, 0, 2, -1.0), (0, 2, 1, -1.0),
    ):
        term = _pmul(_pmul(ent[0][a], ent[1][b]), ent[2][c])
        det = _padd(det, term, s)
    rows.append(_row(det))

    # E E^T E - 0.5 trace(E E^T) E = 0  (9 equations)
    # EEt[i][j] = sum_k ent[i][k] * ent[j][k]
    EEt = [[{} for _ in range(3)] for _ in range(3)]
    for i in range(3):
        for j in range(3):
            acc = {}
            for k in range(3):
                acc = _padd(acc, _pmul(ent[i][k], ent[j][k]))
            EEt[i][j] = acc
    tr = _padd(_padd(EEt[0][0], EEt[1][1]), EEt[2][2])
    for i in range(3):
        for j in range(3):
            acc = {}
            for k in range(3):
                acc = _padd(acc, _pmul(EEt[i][k], ent[k][j]))
            acc = _padd(acc, _pmul(tr, ent[i][j]), sign=-0.5)
            rows.append(_row(acc))
    return jnp.stack(rows)  # [10, 20]


def _polyz(coeffs_by_deg):
    """list indexed by degree -> fixed-length-5 array (deg 4 .. 0)."""
    out = [jnp.zeros(()) for _ in range(5)]
    for d, c in coeffs_by_deg.items():
        out[4 - d] = c
    return jnp.stack(out)


def _zmul(a: jax.Array, b: jax.Array, out_len: int) -> jax.Array:
    """Multiply z-polynomials stored highest-degree-first."""
    la, lb = a.shape[0], b.shape[0]
    out = jnp.zeros(la + lb - 1)
    for i in range(la):
        out = out.at[i : i + lb].add(a[i] * b)
    # keep trailing out_len coefficients (highest degrees are zero-padded)
    return out[-out_len:] if out.shape[0] >= out_len else jnp.concatenate(
        [jnp.zeros(out_len - out.shape[0]), out]
    )


def essential_5pt(x1: jax.Array, x2: jax.Array, mask: jax.Array):
    """Minimal 5-point solver.  x1, x2 [N>=5, 2] normalized coords,
    mask [N] (first 5 valid entries are used via weighting).

    Returns (E [10, 3, 3], valid [10]) — up to 10 essential matrices.
    """
    w = mask.astype(x1.dtype)
    u1, v1 = x1[:, 0], x1[:, 1]
    u2, v2 = x2[:, 0], x2[:, 1]
    ones = jnp.ones_like(u1)
    A = jnp.stack(
        [u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1, ones], axis=-1
    ) * w[:, None]
    AtA = A.T @ A
    _, vecs = jnp.linalg.eigh(AtA)
    basis = vecs[:, :4].T.reshape(4, 3, 3)  # x, y, z, 1 coefficients

    M = _essential_constraints(basis)  # [10, 20]
    A10 = M[:, :10]
    B10 = M[:, 10:]
    # regularized solve for robustness on degenerate samples
    Bred = jnp.linalg.solve(A10 + 1e-12 * jnp.eye(10), B10)  # [10, 10]

    # rows over last-10 monomials: [xz^2, xz, x, yz^2, yz, y, z^3, z^2, z, 1]
    def split(row):
        p = jnp.concatenate([jnp.zeros(1), row[0:3]])  # x-coeffs, deg 3..0 -> len4
        q = jnp.concatenate([jnp.zeros(1), row[3:6]])
        r = row[6:10]  # deg 3..0, len 4
        return p, q, r

    # after reduction row_k: leading_monomial_k + sum B[k, c] last10_c = 0
    # leading monomials (first10 order): x^3, y^3, x^2y, xy^2, x^2z, x^2,
    #                                    y^2z, y^2, xyz, xy
    # Nister elimination: subtract z * (lower row) to cancel the leading
    # monomials, producing equations linear in (x, y):
    #   e = <x^2z> - z <x^2>;  f = <xyz> - z <xy>;  g = <y^2z> - z <y^2>
    def minus_z(hi, lo):
        # (leading cancels); combine last-10 parts: hi + last10 coeffs,
        # z * lo shifts each z-degree up by one
        p_h, q_h, r_h = split(Bred[hi])
        p_l, q_l, r_l = split(Bred[lo])
        # multiply lo polys by z: shift left in highest-first layout
        def zshift(c, out_len):
            return jnp.concatenate([c, jnp.zeros(1)])[-out_len:] if c.shape[0] + 1 >= out_len else c
        p = jnp.concatenate([jnp.zeros(1), p_h]) - jnp.concatenate([p_l, jnp.zeros(1)])
        q = jnp.concatenate([jnp.zeros(1), q_h]) - jnp.concatenate([q_l, jnp.zeros(1)])
        r = jnp.concatenate([jnp.zeros(1), r_h]) - jnp.concatenate([r_l, jnp.zeros(1)])
        return p, q, r  # p, q len 5 (deg 4..0), r len 5 (deg 4..0)

    B1 = minus_z(4, 5)
    B2 = minus_z(8, 9)
    B3 = minus_z(6, 7)

    # det of [[p1,q1,r1],[p2,q2,r2],[p3,q3,r3]] -> degree-10 poly (len 11)
    def det3(B1, B2, B3):
        p1, q1, r1 = B1
        p2, q2, r2 = B2
        p3, q3, r3 = B3

        def m2(a, b, c, d):  # a*d - b*c, result len 9 (deg 8..0)
            return _zmul(a, d, 9) - _zmul(b, c, 9)

        t1 = _zmul(p1, m2(q2, r2, q3, r3), 11)
        t2 = _zmul(q1, m2(p2, r2, p3, r3), 11)
        t3 = _zmul(r1, m2(p2, q2, p3, q3), 11)
        return t1 - t2 + t3

    dpoly = det3(B1, B2, B3)  # [11], degree 10, highest first
    roots, rvalid = rootfind.real_roots(dpoly, imag_tol=1e-3, iters=80)  # [10]

    # back-substitute x, y per root via the cross product of two equations
    def xy_of_z(z):
        def ev(c, z):  # evaluate highest-first coeffs
            out = c[0]
            for k in range(1, c.shape[0]):
                out = out * z + c[k]
            return out

        rows = []
        for (p, q, r) in (B1, B2, B3):
            rows.append(jnp.stack([ev(p, z), ev(q, z), ev(r, z)]))
        r1, r2, r3 = rows
        # the null direction of the 3x3 (rank-2) matrix: best cross product
        c12 = jnp.cross(r1, r2)
        c13 = jnp.cross(r1, r3)
        c23 = jnp.cross(r2, r3)
        norms = jnp.stack(
            [jnp.linalg.norm(c12), jnp.linalg.norm(c13), jnp.linalg.norm(c23)]
        )
        cs = jnp.stack([c12, c13, c23])
        cbest = cs[jnp.argmax(norms)]
        wc = cbest[2]
        wc = jnp.where(jnp.abs(wc) < 1e-12, 1e-12, wc)
        return cbest[0] / wc, cbest[1] / wc

    xs, ys = jax.vmap(xy_of_z)(roots)
    Es = (
        xs[:, None, None] * basis[0]
        + ys[:, None, None] * basis[1]
        + roots[:, None, None] * basis[2]
        + basis[3]
    )
    nrm = jnp.linalg.norm(Es, axis=(-2, -1), keepdims=True)
    Es = Es / jnp.maximum(nrm, 1e-12)
    valid = rvalid & (jnp.sum(mask) >= 5)
    return Es, valid
