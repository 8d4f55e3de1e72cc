"""Tracing / profiling subsystem.

The reference's only instrumentation is libpmu's TEST/perf macros and printf
progress markers (SURVEY.md §5).  The JAX equivalents here:

- `op_trace()` — per-op counters: every cached jitted program invocation is
  counted and (synchronously) timed while a trace is active.  Zero overhead
  when inactive (the exact cached callable is returned untouched).
- `device_trace(logdir)` — wraps `jax.profiler.trace` for device timeline
  capture viewable in TensorBoard/Perfetto (best-effort: a no-op if the
  backend refuses).
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from dataclasses import dataclass, field

import jax

_ACTIVE: "OpTrace | None" = None


@dataclass
class OpTrace:
    """Accumulated per-op counts and wall time, keyed by the engine's
    program cache key head (e.g. 'he_mul', 'swk', 'rs', 'fwd')."""
    counts: dict = field(default_factory=dict)
    seconds: dict = field(default_factory=dict)

    def record(self, key, sec: float) -> None:
        name = key[0] if isinstance(key, tuple) else str(key)
        self.counts[name] = self.counts.get(name, 0) + 1
        self.seconds[name] = self.seconds.get(name, 0.0) + sec

    def report(self) -> str:
        lines = [f"{'op':<12} {'calls':>6} {'total ms':>10} {'ms/call':>9}"]
        for name in sorted(self.seconds, key=self.seconds.get, reverse=True):
            c = self.counts[name]
            s = self.seconds[name] * 1e3
            lines.append(f"{name:<12} {c:>6} {s:>10.2f} {s / c:>9.2f}")
        return "\n".join(lines)


@contextmanager
def op_trace():
    """Activate per-op tracing; yields the OpTrace being filled.

        with op_trace() as t:
            eng.mul(ct1, ct2, rlk)
        print(t.report())
    """
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = t = OpTrace()
    try:
        yield t
    finally:
        _ACTIVE = prev


def maybe_wrap(key, fn):
    """Hook for the engines' program caches: identity when no trace is
    active; otherwise a sync-timing wrapper (forces block_until_ready, so
    only use while profiling)."""
    if _ACTIVE is None:
        return fn
    trace_obj = _ACTIVE

    def timed(*args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        jax.block_until_ready(out)
        trace_obj.record(key, time.perf_counter() - t0)
        return out
    return timed


@contextmanager
def device_trace(logdir: str):
    """Device timeline capture (TensorBoard 'profile' plugin / Perfetto).
    Best-effort: swallows backend refusals so callers can leave it on."""
    started = False
    try:
        jax.profiler.start_trace(logdir)
        started = True
    except Exception:
        pass
    try:
        yield
    finally:
        if started:
            try:
                jax.profiler.stop_trace()
            except Exception:
                pass
