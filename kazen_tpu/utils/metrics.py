"""Observability: per-pass render metrics and timing (the analog of the
reference's Timer/LOG/progress stack, SURVEY §5).

The reference logs wall-clock around BVH build, mesh load, and total render
(timer.h, common.h:451-454) with an ASCII progress bar (progress.cpp). Here
each pass reports structured metrics -- rays traced, rays/s, pixel-samples/s
-- plus an ETA, and jax.profiler tracing can wrap any render for TensorBoard
inspection.
"""
from __future__ import annotations

import contextlib
import sys
import time
from dataclasses import dataclass, field
from typing import List, Optional


@dataclass
class PassMetrics:
    sample_index: int
    seconds: float
    rays: float
    lanes: int

    @property
    def rays_per_s(self) -> float:
        return self.rays / max(self.seconds, 1e-9)

    @property
    def pixel_samples_per_s(self) -> float:
        return self.lanes / max(self.seconds, 1e-9)


@dataclass
class RenderMetrics:
    passes: List[PassMetrics] = field(default_factory=list)

    def add(self, m: PassMetrics):
        self.passes.append(m)

    def summary(self) -> dict:
        if not self.passes:
            return {}
        total_s = sum(p.seconds for p in self.passes)
        total_rays = sum(p.rays for p in self.passes)
        total_ps = sum(p.lanes for p in self.passes)
        return {
            "passes": len(self.passes),
            "seconds": total_s,
            "rays": total_rays,
            "rays_per_s": total_rays / max(total_s, 1e-9),
            "pixel_samples_per_s": total_ps / max(total_s, 1e-9),
        }


class Progress:
    """ETA progress line (progress.cpp:7-57 analog), <=10 Hz updates."""

    def __init__(self, total: int, label: str = "render", stream=sys.stderr):
        self.total = total
        self.label = label
        self.stream = stream
        self.start = time.time()
        self._last = 0.0

    def update(self, done: int):
        now = time.time()
        if now - self._last < 0.1 and done < self.total:
            return
        self._last = now
        frac = done / max(self.total, 1)
        elapsed = now - self.start
        eta = elapsed / max(frac, 1e-9) * (1 - frac)
        bar = "=" * int(40 * frac) + " " * (40 - int(40 * frac))
        self.stream.write(
            f"\r[{self.label}] |{bar}| {done}/{self.total} "
            f"({elapsed:.1f}s, eta {eta:.1f}s)"
        )
        if done >= self.total:
            self.stream.write("\n")
        self.stream.flush()


@contextlib.contextmanager
def profiler_trace(log_dir: Optional[str]):
    """Wrap a render in jax.profiler tracing when log_dir is given."""
    if log_dir is None:
        yield
        return
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def LOG(msg: str, stream=sys.stderr):
    """Timestamped log line (reference LOG(), common.h:451-454)."""
    stream.write(
        f"[kazen {time.strftime('%H:%M:%S')}] {msg}\n"
    )


@contextlib.contextmanager
def timed(label: str, stream=sys.stderr):
    """Timer (timer.h) + LOG-style line."""
    t0 = time.time()
    yield
    stream.write(f"[kazen] {label}: {(time.time() - t0) * 1000:.1f} ms\n")
