"""Lightweight wall-clock phase timer for the encode path."""
import contextlib
import time
from collections import defaultdict


class PhaseTimer:
    """Accumulates wall-clock per named phase; cheap enough for production."""

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self):
        total = sum(self.totals.values()) or 1.0
        lines = [f"{n:24s} {t:8.3f}s {100 * t / total:5.1f}%  ({self.counts[n]}x)"
                 for n, t in sorted(self.totals.items(), key=lambda kv: -kv[1])]
        return "\n".join(lines)
