"""Timing / profiling helpers.

The reference brackets every experiment with omp_get_wtime() (main.cu:929-934)
and decomposes gate time into bootstrapping / key-switch / misc (paper Table
IV, commented timers at lwe-bootstrapping-functions-fft.cu:1941-1968). This
module provides the same phase breakdown plus jax.profiler trace capture.
"""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field

import jax


@dataclass
class PhaseTimer:
    """Accumulates wall-clock per named phase (device-synchronized)."""
    totals: dict = field(default_factory=dict)
    counts: dict = field(default_factory=dict)

    @contextlib.contextmanager
    def phase(self, name: str, sync=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync is not None:
                jax.block_until_ready(sync)
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        lines = []
        for name, tot in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            n = self.counts[name]
            lines.append(f"{name:24s} total {tot*1e3:9.2f} ms   n={n}   avg {tot/n*1e3:9.3f} ms")
        return "\n".join(lines)


@contextlib.contextmanager
def device_trace(logdir: str):
    """Capture a jax.profiler trace (view with tensorboard / xprof)."""
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def timed(fn, *args, iters: int = 5, warmup: int = 1):
    """Compile, warm up, and time a jitted callable. Returns (seconds, result)."""
    out = None
    for _ in range(warmup):
        out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / iters, out
