"""Tracing / profiling utilities (SURVEY.md §5.1).

The reference's only progress visibility is tqdm + Streamlit writes; here:
  * StageTimer — per-stage wall-clock counters with a report table, used by
    the pipeline drivers (preprocess / extract_corpus log a stage report).
  * trace() — context manager wrapping jax.profiler.trace for TensorBoard
    profiles of the jitted hot path.
"""

from __future__ import annotations

import contextlib
import logging
import time
from collections import defaultdict

log = logging.getLogger("stutter_tpu.profiling")


class StageTimer:
    """Accumulates wall-clock per named stage; thread-unsafe by design (cheap)."""

    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1

    def report(self) -> str:
        lines = [f"{'stage':28s} {'total_s':>9s} {'calls':>6s} {'per_call_ms':>12s}"]
        for name, total in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            n = self.counts[name]
            lines.append(f"{name:28s} {total:9.3f} {n:6d} {total / n * 1000:12.2f}")
        return "\n".join(lines)

    def log_report(self):
        for line in self.report().splitlines():
            log.info(line)


@contextlib.contextmanager
def trace(logdir: str):
    """jax.profiler trace for the wrapped region (view in TensorBoard)."""
    import jax

    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
