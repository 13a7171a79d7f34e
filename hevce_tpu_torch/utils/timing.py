"""Timing on the card: CUDA events, torch.profiler's kernel times, and a
host wall clock that drains the card's queue.

A time from these helpers on a CUDA device is a card measurement; on the
CPU only wall_s applies, and what it measures is the host.
"""
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile


def cuda_ms(fn, reps):
    """mean milliseconds per call of fn, host enqueue included (CUDA
    events around `reps` back-to-back calls, after two warm-up calls)."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def event_totals(prof, device_type=DeviceType.CUDA):
    """{name: [microseconds, count]} over a finished profile's events on
    device_type: on CUDA the card's kernels, copies and fills; on the CPU
    the host's operators (inclusive of the operators they call). Reads the
    profiler's raw events: key_averages() builds an operator tree first,
    which takes minutes over a few hundred thousand events."""
    agg = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == device_type:
            a = agg.setdefault(e.name(), [0.0, 0])
            a[0] += e.duration_ns() / 1e3
            a[1] += 1
    return agg


def card_kernels(fn):
    """run fn under torch.profiler: [(name, card microseconds, launches)]
    for every kernel the card ran."""
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [(name, us, n) for name, (us, n) in event_totals(prof).items()]


def card_ms(fn, reps):
    """mean card milliseconds per call of fn: the kernels' own time."""
    us = sum(t for _, t, _ in card_kernels(
        lambda: [fn() for _ in range(reps)]))
    if not us:
        raise RuntimeError("the profiler recorded no time on the card")
    return us / 1e3 / reps


def wall_s(device, fn, reps=3):
    """least host seconds of fn over `reps` calls, each ended by draining
    the card's queue when `device` is a CUDA device."""
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    best = float("inf")
    for _ in range(reps):
        sync()
        t0 = time.perf_counter()
        fn()
        sync()
        best = min(best, time.perf_counter() - t0)
    return best
