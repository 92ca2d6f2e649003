#!/usr/bin/env python
"""Distributed-BA scaling shape on a virtual CPU mesh (1/2/4/8 devices).

This records the SCALING SHAPE of the sharded LM step without real
devices —
correctness (cost parity per device count) plus iters/s — on XLA's
virtual CPU devices.  Each device count needs its own process (device
count is fixed at backend init), so the parent fans out subprocesses.

Prints one JSON line: {"1": {...}, "2": {...}, ...}.
"""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHILD = r"""
import json, os, sys, time
n = int(sys.argv[1])
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + f" --xla_force_host_platform_device_count={n}"
).strip()
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
from jax.sharding import Mesh
sys.path.insert(0, %r)
import bench
from xrsfm_tpu.parallel.dist_ba import solve_distributed

prob, _ell, n_obs = bench.make_ba_problem(n_cams=200, n_pts=20000)
mesh = Mesh(np.array(jax.devices()[:n]), axis_names=("obs",))
# warm-up (compile)
solve_distributed(mesh, prob, max_iters=2)
iters = 8
t0 = time.perf_counter()
out, cost = solve_distributed(mesh, prob, max_iters=iters)
dt = time.perf_counter() - t0
print("CHILD " + json.dumps({
    "n_devices": n, "iters_per_s": round(iters / dt, 3),
    "final_cost": round(float(cost), 2), "n_obs": int(n_obs),
}))
""" % REPO


def main():
    out = {}
    for n in (1, 2, 4, 8):
        r = subprocess.run(
            [sys.executable, "-c", _CHILD, str(n)],
            capture_output=True, text=True, timeout=1800,
        )
        for line in r.stdout.splitlines():
            if line.startswith("CHILD "):
                d = json.loads(line[6:])
                out[str(n)] = d
        if str(n) not in out:
            out[str(n)] = {"error": r.stderr[-500:]}
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
