"""Lightweight wall-clock phase timer for the encode path, and a device
trace through torch.profiler."""
import contextlib
import os
import pathlib
import time
from collections import defaultdict

import torch
from torch.profiler import ProfilerActivity, profile


def keep_cupti():
    """Keep CUPTI subscribed from one profiler session to the next. Kineto
    tears CUPTI down when a session ends; in a process that has captured a
    CUDA graph, a later re-initialisation can give sessions that record no
    kernel on the card. torch.profiler sets the same variable itself when
    torch.compile uses CUDA graphs. Called before every session."""
    os.environ["TEARDOWN_CUPTI"] = "0"


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


@contextlib.contextmanager
def device_trace(logdir):
    """Trace the enclosed work with torch.profiler (CPU activity, and CUDA
    where a card is present) and write a Chrome trace (trace.json, for
    chrome://tracing or Perfetto) into `logdir`. The window opens
    utils/timing.PROFILE_PAD_S before the block runs, so that no kernel of
    it is stamped before the window. Yields the profiler, whose
    key_averages() sum the time by operator and kernel once the block ends,
    and whose `lost_launches` is then utils/timing.lost_launches of the
    trace: the port's kernels whose wrappers launched more than the trace
    recorded ({} when it holds every launch). The counterpart of
    hevce_tpu/utils/tracing.device_trace."""
    from hevce_tpu_torch.utils import timing

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    out = pathlib.Path(logdir)
    out.mkdir(parents=True, exist_ok=True)
    keep_cupti()
    before = timing.wrapper_launches()
    with profile(activities=acts) as prof:
        time.sleep(timing.PROFILE_PAD_S)
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    kernels = [(name, us, n) for name, (us, n)
               in timing.event_totals(prof).items()]
    prof.lost_launches = timing.lost_launches(kernels, before,
                                              timing.wrapper_launches())
    prof.export_chrome_trace(str(out / "trace.json"))
