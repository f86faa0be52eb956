"""Phase timing and device profiling (SURVEY §5.1).

PhaseTimer mirrors the reference's shared/Timer.java usage pattern —
per-phase splits printed in the tool summary ("xtime"/"showtimes"
output of BBDuk/BBMap) — and `device_profile` wraps a block in
jax.profiler tracing (profile=t flags), writing a TensorBoard-loadable
trace directory, the device-native analog of the reference's JVM
instrumentation.
"""

from __future__ import annotations

import contextlib
import sys
import time


class PhaseTimer:
    """Named phase splits; print like the reference's timing block."""

    def __init__(self):
        self.t0 = time.perf_counter()
        self.last = self.t0
        self.phases: list[tuple[str, float]] = []

    def split(self, name: str) -> float:
        now = time.perf_counter()
        dt = now - self.last
        self.phases.append((name, dt))
        self.last = now
        return dt

    @contextlib.contextmanager
    def phase(self, name: str):
        start = time.perf_counter()
        try:
            yield
        finally:
            self.phases.append((name, time.perf_counter() - start))
            self.last = time.perf_counter()

    def total(self) -> float:
        return time.perf_counter() - self.t0

    def report(self, stream=None):
        # resolve sys.stderr at call time so stream redirection
        # (including pytest capture) is honored
        stream = stream if stream is not None else sys.stderr
        for name, dt in self.phases:
            print(f"{name+':':<22s}\t{dt:.3f} seconds.", file=stream)
        print(f"{'Total Time:':<22s}\t{self.total():.3f} seconds.",
              file=stream)


@contextlib.contextmanager
def device_profile(path: str | None):
    """jax.profiler trace around a block when `path` is set (profile=
    flag); no-op otherwise. View with TensorBoard or xprof."""
    if not path:
        yield
        return
    import jax

    with jax.profiler.trace(path):
        yield
    print(f"Device profile written to {path}", file=sys.stderr)
