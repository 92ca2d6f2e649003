"""Bitwise state checksums for cross-run / cross-host determinism.

The reference has no concurrency sanitizers (SURVEY.md §5.2); its only
shared-memory parallelism is an OpenMP loop over disjoint outputs.  The
The device-side replacement for "did parallel execution change the result?"
is a deterministic checksum of (possibly sharded) device state:

  * arrays are bit-cast to uint32, weighted by a position-dependent
    multiplier, and summed mod 2^32 — uint32 addition is exactly
    associative/commutative, so the checksum is IDENTICAL no matter how
    the array is sharded over a mesh or in what order shards reduce;
  * pytrees fold leaf checksums with their path so swapped leaves with
    equal content do not collide.

Use: checksum the map/BA state after a distributed step and compare to
the single-device run (tests/test_dist_ba.py) or across hosts.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

_MULT = jnp.uint32(2654435761)  # Knuth multiplicative hash


def _as_u32(x: jax.Array) -> jax.Array:
    """Flatten any dtype to a uint32 vector, bit-exact."""
    x = jnp.ravel(x)
    if x.dtype == jnp.bool_:
        return x.astype(jnp.uint32)
    if jnp.issubdtype(x.dtype, jnp.floating):
        if x.dtype == jnp.bfloat16:
            return jax.lax.bitcast_convert_type(x, jnp.uint16).astype(
                jnp.uint32
            )
        return jax.lax.bitcast_convert_type(
            x.astype(jnp.float32), jnp.uint32
        )
    if x.dtype in (jnp.int8, jnp.uint8, jnp.int16, jnp.uint16):
        return x.astype(jnp.uint32)
    return jax.lax.bitcast_convert_type(x.astype(jnp.int32), jnp.uint32)


@jax.jit
def array_checksum(x: jax.Array) -> jax.Array:
    """Position-weighted uint32 checksum; sharding-invariant."""
    u = _as_u32(x)
    idx = jnp.arange(u.shape[0], dtype=jnp.uint32)
    w = idx * _MULT + jnp.uint32(1)
    return jnp.sum(u * w, dtype=jnp.uint32)


def pytree_checksum(tree) -> int:
    """Fold a pytree of arrays into one Python int (stable across
    processes: leaf order comes from the tree structure)."""
    leaves = jax.tree_util.tree_leaves_with_path(tree)
    acc = 0x811C9DC5  # FNV offset
    for path, leaf in leaves:
        h = functools.reduce(
            lambda a, c: ((a ^ ord(c)) * 0x01000193) & 0xFFFFFFFF,
            jax.tree_util.keystr(path),
            0x811C9DC5,
        )
        c = int(array_checksum(jnp.asarray(leaf)))
        acc = (acc * 0x01000193 ^ (c + h)) & 0xFFFFFFFF
    return acc
