"""Sharded descriptor matching over a device mesh.

The matching stage is embarrassingly parallel over image pairs (the
reference runs pairs serially through one shared SiftMatchGPU instance,
feature_processing.cc:222-308).  Here a batch of pairs is laid out
[B, K, 128] and split over the mesh's pair axis with shard_map: each
device runs the single-device matcher (ops/matching) on its B/n_devices
pairs, so B pairs match in the time of B/n_devices.
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..ops import matching as dmatch


@functools.lru_cache(maxsize=None)
def _sharded_matcher(mesh: Mesh, axis: str, max_matches: int):
    spec = P(axis)
    return jax.jit(jax.shard_map(
        lambda d1, d2, m1, m2, dist_th, ratio_th:
            dmatch.match_descriptors_batch(d1, d2, m1, m2, dist_th,
                                           ratio_th, max_matches),
        mesh=mesh,
        in_specs=(spec, spec, spec, spec, P(), P()),
        out_specs=(spec, spec, spec),
        check_vma=False,
    ))


def match_batch_sharded(mesh: Mesh, d1, d2, mask1, mask2, dist_th=0.7,
                        ratio_th=0.8, max_matches: int = 4096, axis=None):
    """match_descriptors_batch with the pair axis (B, a multiple of the
    axis size) split over `axis` (default: the mesh's first axis)."""
    axis = axis or mesh.axis_names[0]
    return _sharded_matcher(mesh, axis, max_matches)(
        d1, d2, mask1, mask2, jnp.float32(dist_th), jnp.float32(ratio_th)
    )


def match_pairs_sharded(
    mesh: Mesh,
    descs: np.ndarray,  # [F, K, 128] uint8 (padded per frame)
    masks: np.ndarray,  # [F, K] bool
    pair_ids: Sequence[Tuple[int, int]],
    dist_th: float = 0.7,
    ratio_th: float = 0.8,
    max_matches: int = 4096,
    axis: str = "pairs",
):
    """Match all pairs, sharded over the mesh.  Returns per-pair
    (matches [max_matches, 2], count, distances) as numpy arrays."""
    n_dev = mesh.shape[axis]
    B = len(pair_ids)
    pad = (-B) % n_dev
    ids = np.asarray(list(pair_ids) + [pair_ids[0]] * pad, np.int64)
    out = match_batch_sharded(
        mesh, descs[ids[:, 0]], descs[ids[:, 1]], masks[ids[:, 0]],
        masks[ids[:, 1]], dist_th, ratio_th, max_matches, axis,
    )
    return tuple(np.asarray(a)[:B] for a in jax.device_get(out))
