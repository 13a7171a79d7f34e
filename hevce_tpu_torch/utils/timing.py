"""Timing on the card: CUDA events, torch.profiler's kernel times, and a
host wall clock that drains the card's queue.

A time from these helpers on a CUDA device is a card measurement; on the
CPU only wall_s applies, and what it measures is the host.
"""
import sys
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from hevce_tpu_torch.utils.tracing import keep_cupti

# card_ms runs a profiler session that recorded no kernel, or lost
# launches, again, up to this many sessions in all, before it times with
# busy_events_ms instead
PROFILE_TRIES = 3
# spin cycles per second of host enqueue in busy_events_ms: the H100's
# 1.98 GHz boost clock, rounded up, so the spin outlasts the enqueue
SPIN_CYCLES_PER_S = 2e9
# card_ms's sessions that recorded no kernel or lost launches, and card_ms
# calls timed by busy_events_ms, since the process began
EMPTY_SESSIONS = 0
EVENT_TIMED = 0


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


def busy_events_ms(fn, reps):
    """mean milliseconds per call of fn from CUDA events around `reps`
    calls enqueued behind a spin kernel: the card runs them back to back,
    so the host's enqueue stays out of the time as long as fn does not wait
    for the card. The spin lasts twice a first enqueue of `reps` calls."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    host_s = time.perf_counter() - t
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2 * host_s * SPIN_CYCLES_PER_S) + 1)
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
    keep_cupti()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [(name, us, n) for name, (us, n) in event_totals(prof).items()]


def card_ms(fn, reps):
    """mean card milliseconds per call of fn: the kernels' own time, summed
    by torch.profiler over `reps` calls. Each call launches the same
    kernels, so each kernel's count in a whole session is a multiple of
    `reps`; a session where one is not lost launches (or held one-time
    work of a first call). Such a session, or one that recorded no kernel,
    is run again; after PROFILE_TRIES of them the time is busy_events_ms's,
    said on stderr and counted in EVENT_TIMED."""
    global EMPTY_SESSIONS, EVENT_TIMED
    for _ in range(PROFILE_TRIES):
        kernels = card_kernels(lambda: [fn() for _ in range(reps)])
        if kernels and all(n % reps == 0 for _, _, n in kernels):
            return sum(us for _, us, _ in kernels) / 1e3 / reps
        EMPTY_SESSIONS += 1
    EVENT_TIMED += 1
    print(f"timing.card_ms: {PROFILE_TRIES} profiler sessions recorded no "
          f"kernel or lost launches; timed with CUDA events behind a spin "
          f"kernel",
          file=sys.stderr, flush=True)
    return busy_events_ms(fn, reps)


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
