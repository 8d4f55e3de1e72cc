"""Perf-measurement utilities (the libpmu role, ref: Makefile:24-26 +
SURVEY.md §5 tracing): wall-clock op timers, a jax.profiler trace wrapper,
and simple throughput accounting for benches."""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field


@dataclass
class Timer:
    """Accumulating named timer: with t.measure("ntt"): ..."""
    records: dict = field(default_factory=dict)

    @contextlib.contextmanager
    def measure(self, name: str, block_on=None):
        t0 = time.perf_counter()
        yield
        if block_on is not None:
            import jax
            jax.block_until_ready(block_on)
        dt = time.perf_counter() - t0
        cnt, tot = self.records.get(name, (0, 0.0))
        self.records[name] = (cnt + 1, tot + dt)

    def report(self, out=print):
        for name, (cnt, tot) in sorted(self.records.items()):
            out(f"{name:24s} {cnt:5d} calls  {tot:8.3f}s total  {tot/cnt*1e3:8.2f} ms/call")


@contextlib.contextmanager
def device_trace(logdir: str):
    """jax.profiler trace of the device timeline (view with tensorboard/xprof)."""
    import jax

    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def time_jitted(fn, args, iters: int = 10, warmup: int = 2) -> float:
    """Median-free simple timing: returns seconds per call after warmup."""
    import jax

    for _ in range(warmup):
        out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / iters


def block(out):
    """Wait for a result: arrays (any pytree), ciphertexts, or lists and
    tuples of ciphertexts.  Returns it unchanged."""
    import jax
    if isinstance(out, (list, tuple)) and any(hasattr(o, "c0") for o in out):
        for o in out:
            block(o)
    elif hasattr(out, "c0"):
        jax.block_until_ready((out.c0, out.c1))
    else:
        jax.block_until_ready(out)
    return out


def run_timed(fn, reps: int):
    """(result, seconds of the first call — compilation included when it
    is the first call of a program — and a list of `reps` per-call seconds
    of warm calls), each call waited for on the device."""
    t0 = time.perf_counter()
    out = block(fn())
    cold = time.perf_counter() - t0
    warm = []
    for _ in range(reps):
        t0 = time.perf_counter()
        block(fn())
        warm.append(time.perf_counter() - t0)
    return out, cold, warm


def quartiles(xs) -> tuple[float, float, float]:
    """(q1, median, q3) of a list of timings."""
    import numpy as np
    q1, q2, q3 = np.percentile(np.asarray(xs), [25, 50, 75])
    return float(q1), float(q2), float(q3)
