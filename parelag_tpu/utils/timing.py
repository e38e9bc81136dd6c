"""Named-timer registry and stopwatch.

Rebuild of the reference TimeManager/Timer/Watch
(src/utilities/ParELAG_TimeManager.hpp:40-146, ParELAG_Watch.hpp:33): a
global registry of named accumulating timers with RAII scopes and a pretty
summary table. On-device work is made visible by synchronizing (JAX async
dispatch) when a timer scope closes around device computations.
"""

import time
from contextlib import contextmanager


@contextmanager
def profile_trace(logdir):
    """Capture a device profile around a block (jax.profiler.trace):
    the replacement for the reference's compile-time elag_trace
    per-rank call logs (Trace.hpp:20-40) — open with TensorBoard/XProf."""
    import jax
    with jax.profiler.trace(str(logdir)):
        yield


@contextmanager
def named_scope(name):
    """Annotate device work for the profiler timeline
    (jax.profiler.TraceAnnotation)."""
    import jax
    with jax.profiler.TraceAnnotation(name):
        yield


class Watch:
    """Simple accumulating stopwatch (ParELAG_Watch.hpp:33)."""

    def __init__(self):
        self._elapsed = 0.0
        self._start = None

    def start(self):
        self._start = time.perf_counter()

    def stop(self):
        if self._start is not None:
            self._elapsed += time.perf_counter() - self._start
            self._start = None

    def reset(self):
        self._elapsed = 0.0
        self._start = None

    def elapsed(self):
        if self._start is not None:
            return self._elapsed + (time.perf_counter() - self._start)
        return self._elapsed


class TimeManager:
    """Global named-timer registry (ParELAG_TimeManager.hpp:40-146)."""

    _timers = {}

    @classmethod
    def get_timer(cls, name) -> Watch:
        if name not in cls._timers:
            cls._timers[name] = Watch()
        return cls._timers[name]

    @classmethod
    @contextmanager
    def add_timer(cls, name, sync_device=False):
        """RAII timer scope (TimeManager::AddTimer)."""
        w = cls.get_timer(name)
        w.start()
        try:
            yield w
        finally:
            if sync_device:
                try:
                    import jax
                    jax.block_until_ready(
                        jax.device_put(0.0))  # flush dispatch queue
                except Exception:
                    pass
            w.stop()

    @classmethod
    def clear(cls):
        cls._timers.clear()

    @classmethod
    def summary(cls) -> str:
        if not cls._timers:
            return "TimeManager: no timers.\n"
        width = max(len(n) for n in cls._timers) + 2
        lines = ["-" * (width + 14),
                 f"{'Timer':<{width}}{'Elapsed (s)':>12}",
                 "-" * (width + 14)]
        for name in sorted(cls._timers):
            lines.append(
                f"{name:<{width}}{cls._timers[name].elapsed():>12.6f}")
        lines.append("-" * (width + 14))
        return "\n".join(lines) + "\n"

    @classmethod
    def print_summary(cls):
        print(cls.summary(), end="")
