"""Tracing / profiling helpers.

The reference's observability is wall-clock timers printed at stage ends
(Timer/TimerArray/TIMING, src/utility/timer.h:12-70).  utils/timer.py
covers that; this module adds the device layer promised in SURVEY.md
§5.1: JAX profiler traces (viewable in TensorBoard / Perfetto) and
synchronized device-time measurement.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np


@contextlib.contextmanager
def maybe_trace(trace_dir):
    """Wrap a block in ``jax.profiler.trace(trace_dir)`` when a
    directory is given, else no-op.  Usage:

        with maybe_trace("/tmp/trace"):
            pipeline()
    """
    if not trace_dir:
        yield
        return
    import jax

    with jax.profiler.trace(str(trace_dir)):
        yield
    print(f"[profile] trace written to {trace_dir}", flush=True)


def device_time(fn, *args, warmup: int = 1, iters: int = 10, **kw):
    """Median wall time of ``fn(*args, **kw)``, each call ending in
    ``jax.block_until_ready`` on every leaf of its result.  Returns
    (median_seconds, last_result)."""
    import jax

    out = None
    for _ in range(max(warmup, 0)):
        out = jax.block_until_ready(fn(*args, **kw))
    times = []
    for _ in range(max(iters, 1)):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args, **kw))
        times.append(time.perf_counter() - t0)
    return float(np.median(times)), out


@contextlib.contextmanager
def annotate(name: str):
    """Named profiler span (shows up in the JAX trace viewer)."""
    import jax

    with jax.profiler.TraceAnnotation(name):
        yield
