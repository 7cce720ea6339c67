"""Timing / benchmark / observability.

Replaces the reference's SDL-performance-counter Timer and its F6 benchmark
mode (reference: source/Timer.{h,cpp}): per-frame elapsed/total time, 1 Hz FPS
windows, and an N-sample benchmark that records per-window decimal FPS and
writes HIGH/LOW/AVG in the same four-line format as ``benchmark.txt``
(reference: source/Timer.cpp:103-130).

Adds what the reference lacks: rays/s counters and jax.profiler trace hooks.
A native C++ monotonic timer backs FrameTimer when raytpu.native is built.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field


def _now() -> float:
    try:
        from raytpu.native import runtime as _rt

        if _rt.available():
            return _rt.monotonic()
    except Exception:
        pass
    return time.perf_counter()


class FrameTimer:
    """Frame clock with 1 Hz FPS windows (reference: source/Timer.cpp:67-132)."""

    def __init__(self, fps_window: float = 1.0, elapsed_upper_bound: float | None = None):
        """``elapsed_upper_bound``: optional per-frame dt clamp, so one hitch
        (e.g. a recompile) can't blow up dt-driven camera motion
        (reference: source/Timer.cpp:83-89 ForceElapsedUpperBound)."""
        self._window = fps_window
        self._upper = elapsed_upper_bound
        self.reset()

    def reset(self):
        self._start = _now()
        self._last = self._start
        self.elapsed = 0.0
        self.total = 0.0
        self._frames_in_window = 0
        self._window_start = self._start
        self.fps = 0.0
        self.dfps = 0.0
        self._fps_ready = False

    def tick(self) -> None:
        now = _now()
        self.elapsed = max(now - self._last, 0.0)
        if self._upper is not None and self.elapsed > self._upper:
            self.elapsed = self._upper
        self._last = now
        self.total = now - self._start
        self._frames_in_window += 1
        self._fps_ready = False
        w = now - self._window_start
        if w >= self._window:
            self.dfps = self._frames_in_window / w
            self.fps = self.dfps
            self._frames_in_window = 0
            self._window_start = now
            self._fps_ready = True

    @property
    def fps_window_closed(self) -> bool:
        return self._fps_ready


@dataclass
class Benchmark:
    """N-sample FPS benchmark (reference: source/Timer.cpp:44-65,103-130)."""

    num_samples: int = 10
    samples: list = field(default_factory=list)
    active: bool = False

    def start(self):
        self.samples = []
        self.active = True

    def record(self, dfps: float) -> bool:
        """Feed one FPS-window sample; returns True when the benchmark finishes."""
        if not self.active:
            return False
        self.samples.append(dfps)
        if len(self.samples) >= self.num_samples:
            self.active = False
            return True
        return False

    @property
    def high(self):
        return max(self.samples)

    @property
    def low(self):
        return min(self.samples)

    @property
    def avg(self):
        return sum(self.samples) / len(self.samples)

    def report(self) -> str:
        """Four-line format matching benchmark.txt (reference: source/Timer.cpp:123-128)."""
        return (
            f"FPS BENCHMARK of {len(self.samples)} frames\n"
            f"HIGH: {self.high}\n"
            f"LOW: {self.low}\n"
            f"AVERAGE: {self.avg}\n"
        )

    def write(self, path: str = "benchmark.txt"):
        with open(path, "w") as f:
            f.write(self.report())


@dataclass
class RayStats:
    """Whole-frame rays/s counters — the observability the reference lacks
    (SURVEY.md §5.1).  Counters accumulate per frame via ``add_frame``."""

    primary_rays: int = 0
    shadow_rays: int = 0
    frames: int = 0
    seconds: float = 0.0

    def add_frame(self, width: int, height: int, num_lights: int, seconds: float, shadows: bool = True):
        n = width * height
        self.primary_rays += n
        if shadows:
            self.shadow_rays += n * num_lights
        self.frames += 1
        self.seconds += seconds

    @property
    def primary_rays_per_s(self) -> float:
        return self.primary_rays / self.seconds if self.seconds else 0.0

    @property
    def total_rays_per_s(self) -> float:
        return (self.primary_rays + self.shadow_rays) / self.seconds if self.seconds else 0.0


@contextlib.contextmanager
def trace(log_dir: str):
    """jax.profiler trace context: captures the device timeline."""
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
