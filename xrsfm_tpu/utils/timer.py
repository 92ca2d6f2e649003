"""Wall-clock timers (reference: src/utility/timer.h:12-70 — Timer,
TimerArray, TIMING macro).

`sync_device` waits for the device work behind a result before a
timer is read.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Optional


class Timer:
    def __init__(self, name: str = ""):
        self.name = name
        self.total = 0.0
        self._start: Optional[float] = None

    def start(self):
        self._start = time.perf_counter()
        return self

    def stop(self):
        if self._start is not None:
            self.total += time.perf_counter() - self._start
            self._start = None
        return self.total

    @contextlib.contextmanager
    def timing(self):
        self.start()
        try:
            yield self
        finally:
            self.stop()

    def print(self):
        print(f"[timer] {self.name}: {self.total:.3f}s", flush=True)


class TimerArray:
    """Named timer set, mirroring the reference's
    {tot, reg, tri, fil, merge, che, lba, gba} array."""

    def __init__(self, names=("tot", "reg", "tri", "fil", "merge", "che", "lba", "gba")):
        self.timers: Dict[str, Timer] = {n: Timer(n) for n in names}

    def __getitem__(self, name: str) -> Timer:
        if name not in self.timers:
            self.timers[name] = Timer(name)
        return self.timers[name]

    def print_all(self):
        for t in self.timers.values():
            t.print()


def sync_device(x) -> None:
    """Barrier: wait until every array in the pytree x is computed."""
    import jax

    jax.block_until_ready(x)
