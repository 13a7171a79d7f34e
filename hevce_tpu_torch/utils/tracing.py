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


# the timer total that holds the card's seconds of the fast mode's batches,
# from CUDA events (models/wavefront): card time, not a host phase
CARD = "card"


class PhaseTimer:
    """Accumulates wall-clock seconds per named phase; cheap enough for
    production. Phases nest, and report() gives each its self time: its
    seconds less those of the phases opened inside it.

    With `spans` a list, each phase is also kept there, in the order the
    phases open, as (name, start_ns, end_ns, parent, tag): the stamps are
    time.time_ns(), the clock torch.profiler puts the card's timestamps on;
    parent is the index in `spans` of the enclosing open phase (None at the
    top); tag is the timer's `tag` when the phase opened, which the caller
    sets (encode_many_fast sets one a batch, shared by all its spans)."""

    def __init__(self, spans=None):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)
        self.spans = spans
        self.tag = None
        self._inner = defaultdict(float)   # seconds of the phases inside each
        self._open = []          # a [children's seconds, span index] a phase

    @contextlib.contextmanager
    def phase(self, name):
        frame = [0.0, None]
        if self.spans is not None:
            frame[1] = len(self.spans)
            parent = self._open[-1][1] if self._open else None
            self.spans.append((name, time.time_ns(), None, parent, self.tag))
        self._open.append(frame)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self._open.pop()
            self.totals[name] += dt
            self.counts[name] += 1
            self._inner[name] += frame[0]
            if self._open:
                self._open[-1][0] += dt
            if frame[1] is not None:
                n, start, _, parent, tag = self.spans[frame[1]]
                self.spans[frame[1]] = (n, start, time.time_ns(), parent, tag)

    def self_times(self) -> dict:
        """{name: seconds of the phase outside the phases opened inside it};
        a total that no phase kept (CARD) as it is."""
        return {n: t - self._inner[n] for n, t in self.totals.items()}

    def report(self):
        own = self.self_times()
        total = sum(t for n, t in own.items() if n != CARD) or 1.0
        lines = [f"{n:24s} {t:8.3f}s "
                 + (" card " if n == CARD else f"{100 * t / total:5.1f}%")
                 + f"  ({self.counts[n]}x)"
                 for n, t in sorted(own.items(), key=lambda kv: -kv[1])]
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
