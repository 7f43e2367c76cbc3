"""Frame-time and pass-time profiling (SURVEY.md §5 'tracing/profiling').

- :class:`FrameCounter` mirrors src/utils/frame_counter.rs:3-40 — accumulates
  frame time and prints the average every 100 frames; ``time_delta()`` feeds
  the global uniform like context.rs:227.
- :class:`PassTimer` is the analog of the xor demo's GPU timestamp-query pair
  (examples/xor/main.rs:120-131, 164-187): it brackets a jitted render pass
  wall-clock (device sync included) and prints 'Time on raycast shader'-style
  reports every N frames, plus a derived Mrays/s.
- :func:`trace` wraps ``jax.profiler.trace`` for full device traces.
"""

from __future__ import annotations

import contextlib
import time


class FrameCounter:
    def __init__(self, report_every: int = 100):
        self.frame_count = 0
        self.accum_time = 0.0
        self.last_frame_time = time.perf_counter()
        self.report_every = report_every
        self.last_avg_ms = 0.0

    def record(self) -> float:
        """Mark a frame boundary; returns dt seconds. Prints the average
        every ``report_every`` frames (frame_counter.rs:18-28)."""
        now = time.perf_counter()
        dt = now - self.last_frame_time
        self.last_frame_time = now
        self.accum_time += dt
        self.frame_count += 1
        if self.frame_count % self.report_every == 0:
            self.last_avg_ms = self.accum_time / self.report_every * 1000.0
            print(f"Avg frame time {self.last_avg_ms:.2f}ms")
            self.accum_time = 0.0
        return dt

    def time_delta(self) -> float:
        """Average seconds per frame over the current window
        (frame_counter.rs:14-16)."""
        if self.frame_count % self.report_every == 0:
            return self.last_avg_ms / 1000.0 if self.last_avg_ms else 1.0 / 60.0
        n = self.frame_count % self.report_every
        return self.accum_time / max(n, 1)


class PassTimer:
    """Times a named device pass; prints every ``report_every`` frames.

    The timed block must end with the pass's result ready on the device
    (``block_until_ready``), or pass ``sync`` to wait for it; otherwise the
    wall time measures only the enqueue."""

    def __init__(self, name: str = "raycast shader", report_every: int = 100):
        self.name = name
        self.report_every = report_every
        self.accum = 0.0
        self.count = 0
        self.rays = 0
        self.last_ms = 0.0

    @contextlib.contextmanager
    def measure(self, n_rays: int = 0, sync=None):
        t0 = time.perf_counter()
        yield
        if sync is not None:
            sync()
        self.accum += time.perf_counter() - t0
        self.rays += n_rays
        self.count += 1
        if self.count % self.report_every == 0:
            sec = self.accum / self.report_every
            self.last_ms = sec * 1000.0
            msg = f"Time on {self.name}: {self.last_ms:.3f}ms"
            if self.rays and sec > 0.0:
                msg += f" ({self.rays / (sec * self.report_every) / 1e6:.1f} Mrays/s)"
            print(msg)
            self.accum = 0.0
            self.rays = 0


@contextlib.contextmanager
def trace(logdir: str = "/tmp/vokselis-trace"):
    """Capture a jax.profiler device trace around a block."""
    import jax

    with jax.profiler.trace(logdir):
        yield
    print(f"profiler trace written to {logdir}")
