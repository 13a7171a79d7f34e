"""A profiled stretch of whole calls, reduced to card busy time, kernel
times and idle gaps.

The stretch is one torch.profiler session over a few whole calls that
records the card's activity alone: recording the host's operators as well
would slow the host path that the stretch measures. Nothing is written to
disk: the sums are taken from the profiler's raw events (key_averages()
would first build an operator tree, which takes minutes over the ~4,500
kernels of each replayed front step). The stretch's window and the host's
phases (the spans of the port's utils/tracing.PhaseTimer that the driven
program fills) are read from time.time_ns(), the clock that the profiler
puts the card's timestamps on, so that each idle gap of the card is named by
the phase open on the host during it.
"""
import contextlib
import os
import time

from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

# host idle at the start of a session before its work: the card's
# timestamps can run ahead of the host clock that opens the profiler's
# window, which then drops the first kernels (utils/timing.PROFILE_PAD_S)
PAD_S = 0.01


def _is_copy(name):
    return name.startswith(("Memcpy", "Memset"))


@contextlib.contextmanager
def session():
    """profile the card's activity in the block; yields the profiler."""
    os.environ["TEARDOWN_CUPTI"] = "0"     # keep CUPTI between sessions
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(PAD_S)
        yield prof


def _union(intervals):
    """merged [(start, end)] of sorted-or-not intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def reduce(prof, window, phases, port_kernels, top: int = 10):
    """the stretch's readings: window (w0, w1) in time.time_ns() ns, phases
    the host's PhaseTimer spans [(name, start ns, end ns, parent, tag)],
    port_kernels the port's hand-written kernels by a substring of their
    names. window_s (the stretch's length), busy_s (the union of the card's
    operations inside it), outside (the card's operations that lie wholly
    outside it: none, when the two clocks agree), kernels {name: [us, n]}
    (kernels only, copies and fills apart), the port's kernels' and the
    other kernels' card us, and the longest idle gaps [(phase, seconds)]
    and the top kernels [(name, seconds)]."""
    w0, w1 = window
    kernels, busy_iv, outside = {}, [], 0
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA:
            continue
        name = e.name()
        s = max(e.start_ns(), w0)
        t = min(e.start_ns() + e.duration_ns(), w1)
        if t <= s:
            outside += 1
            continue
        busy_iv.append((s, t))
        if _is_copy(name):
            continue
        k = kernels.setdefault(name, [0.0, 0])
        k[0] += (t - s) / 1e3
        k[1] += 1
    if not busy_iv:
        raise RuntimeError("the profiled stretch holds no card operation")
    busy = _union(busy_iv)
    busy_ns = sum(e - s for s, e in busy)
    gaps, prev = [], w0
    for s, e in busy + [[w1, w1]]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
    closed = _close_order(phases)
    labelled = [(g1 - g0, _label(g0, g1, closed)) for g0, g1 in longest]
    port_us = sum(us for n, (us, _) in kernels.items()
                  if any(p in n for p in port_kernels))
    glue_us = sum(us for n, (us, _) in kernels.items()) - port_us
    top_k = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:top]
    return {"window_s": (w1 - w0) / 1e9, "busy_s": busy_ns / 1e9,
            "outside": outside, "kernels": kernels, "port_us": port_us,
            "glue_us": glue_us, "kernel_count": sum(n for _, n in
                                                    kernels.values()),
            "device_ops": [[n[:96], us / 1e6] for n, (us, _) in top_k],
            "idle_gaps": [[lab, ns / 1e9] for ns, lab in labelled]}


def _close_order(spans):
    """spans [(name, start, end, parent, tag)], kept in the order they
    opened, in the order they closed: a phase after the phases inside it."""
    depth = []
    for _, _, _, parent, _ in spans:
        depth.append(0 if parent is None else depth[parent] + 1)
    order = sorted(range(len(spans)), key=lambda i: (spans[i][2], -depth[i]))
    return [spans[i] for i in order]


def _label(g0, g1, phases):
    """the host phase that overlaps the gap (g0, g1) most, the first in
    `phases` where several do, or "host" when none is open (the harness's
    own work between calls)."""
    best, lab = 0, "host"
    for name, s, e, *_ in phases:
        ov = min(e, g1) - max(s, g0)
        if ov > best:
            best, lab = ov, name
    return lab


def port_counts(kernels, port_kernels):
    """{substring: launches recorded} of the port's kernels."""
    return {p: sum(n for name, (_, n) in kernels.items() if p in name)
            for p in port_kernels}
