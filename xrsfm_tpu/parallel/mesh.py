"""Device mesh and multi-host runtime setup.

The reference is strictly single-process (SURVEY.md §2.9); this module
provides the scale-out runtime:

  * single host: a 1-D "obs"/"pairs" mesh over the local devices;
  * multi-host: jax.distributed.initialize + a 2-D (dcn, ici) mesh —
    hosts on the slow inter-host axis ("dcn"), each host's devices on the
    fast intra-host axis ("ici").  Shardings should keep collectives
    (psum of BA blocks) on the intra-host axis and only stage-boundary
    scatter/gather on the inter-host one.

Multi-host cannot be exercised in this single-host environment; the mesh
construction itself is covered by the CPU-device tests.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
):
    """Initialize the multi-host runtime (no-op when single-process).

    Mirrors jax.distributed.initialize: where a cluster environment is
    detected the arguments are discovered from it; otherwise pass the
    coordinator address, process count and process id.
    """
    import jax

    if num_processes is not None and num_processes > 1:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    return jax.process_count(), jax.process_index()


def make_mesh(axis: str = "obs"):
    """1-D mesh over all addressable devices (single-host scale-out)."""
    import jax
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()), axis_names=(axis,))


def make_pod_mesh(ici_axis: str = "ici", dcn_axis: str = "dcn"):
    """2-D (hosts x per-host devices) mesh.

    BA block psums ride the intra-host axis; the inter-host axis only
    sees stage-boundary traffic (SURVEY.md §5.8)."""
    import jax
    from jax.sharding import Mesh

    devs = jax.devices()
    n_hosts = jax.process_count()
    per_host = len(devs) // n_hosts
    arr = np.array(devs).reshape(n_hosts, per_host)
    return Mesh(arr, axis_names=(dcn_axis, ici_axis))
