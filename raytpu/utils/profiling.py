"""Profiling and metrics — the observability layer.

The reference's entire instrumentation is a per-frame wall-clock print
("Render time: X ms.", `raytracer.cpp:341-343`) plus thread-count stdout
logs (SURVEY.md §5). raytpu provides:

  * FrameTimer        — the same per-frame timing, plus rays/s // Mrays/s
                        counters and aggregate stats.
  * trace             — context manager around `jax.profiler.trace` for
                        on-device traces (view in TensorBoard/xprof).
  * log_metrics       — structured one-line JSON metric records (loss,
                        grad-norm, rays/s) for training loops.
"""

from __future__ import annotations

import contextlib
import json
import sys
import time
from dataclasses import dataclass, field


@dataclass
class FrameTimer:
    """Per-frame timer with throughput accounting.

    >>> timer = FrameTimer(rays_per_frame=2 * 512 * 512)
    >>> with timer.frame():
    ...     img = render(...)  # block_until_ready inside
    >>> print(timer.summary())
    """

    rays_per_frame: int = 0
    times_s: list = field(default_factory=list)

    @contextlib.contextmanager
    def frame(self):
        t0 = time.perf_counter()
        yield
        self.times_s.append(time.perf_counter() - t0)

    @property
    def last_ms(self) -> float:
        return self.times_s[-1] * 1e3 if self.times_s else 0.0

    def mrays_per_s(self, skip_first: bool = True) -> float:
        """Mean throughput, skipping the compile-laden first frame."""
        ts = self.times_s[1:] if skip_first and len(self.times_s) > 1 \
            else self.times_s
        if not ts or not self.rays_per_frame:
            return 0.0
        return self.rays_per_frame / (sum(ts) / len(ts)) / 1e6

    def summary(self) -> str:
        if not self.times_s:
            return "no frames"
        ts = sorted(self.times_s)
        med = ts[len(ts) // 2] * 1e3
        parts = [
            f"{len(self.times_s)} frames",
            f"median {med:.2f} ms",
            f"last {self.last_ms:.2f} ms",
        ]
        if self.rays_per_frame:
            parts.append(f"{self.mrays_per_s():.1f} Mrays/s")
        return ", ".join(parts)


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a device profiler trace of the enclosed block."""
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def log_metrics(step: int, stream=None, **metrics) -> None:
    """One JSON line per step: {"step": N, "loss": ..., ...}."""
    rec = {"step": step}
    for k, v in metrics.items():
        try:
            rec[k] = float(v)
        except (TypeError, ValueError):
            rec[k] = str(v)
    print(json.dumps(rec), file=stream or sys.stderr, flush=True)


def grad_norm(grads) -> float:
    """Global L2 norm of a gradient pytree."""
    import jax
    import jax.numpy as jnp

    leaves = jax.tree_util.tree_leaves(grads)
    return float(
        jnp.sqrt(sum(jnp.sum(l.astype(jnp.float32) ** 2) for l in leaves))
    )
