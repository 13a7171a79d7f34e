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

# a profiler session that recorded no kernel, or lost launches, is run
# again, up to this many sessions in all (card_kernels); then card_ms times
# with busy_events_ms instead, and a trace is reported as incomplete
PROFILE_TRIES = 3
# host idle at the start of every profiler session, before its work: the
# card's kernel timestamps can run ahead of the host clock that opens
# Kineto's window (by 0.4-5.7 ms in 7-15% of sessions on an H100, by more
# than 10 ms in some; tools/profiler_sessions), and Kineto drops a kernel
# stamped before the window opened ("Out-of-range"): a session lost its
# first launches. card_kernels pads a session it runs again 10 and 100
# times longer.
PROFILE_PAD_S = 0.01
# spin cycles per second of host enqueue in busy_events_ms: the H100's
# 1.98 GHz boost clock, rounded up, so the spin outlasts the enqueue
SPIN_CYCLES_PER_S = 2e9
# profiler sessions that recorded no kernel or lost launches, since the
# process began
LOST_SESSIONS = 0


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


def wrapper_launches() -> dict:
    """{a substring of a kernel's name: the launches its wrapper has
    counted} for the port's kernels (each wrapper counts a launch where it
    makes one). K1's count is the kernels the card ran also under the slice
    runner's CUDA graph (models/wavefront._SliceRunner): its capture is
    taken back and every replay adds the captured launches. The probe
    tool's P1 graph counts its capture, not its replays."""
    from hevce_tpu_torch.ops import cabac_scan, fused_eval, fused_node, probes

    return {"k1_kernel": fused_eval.LAUNCHES, "k2_kernel": cabac_scan.LAUNCHES,
            "x1_predict": fused_node.X1.LAUNCHES,
            "x2_preselect": fused_node.X2.LAUNCHES,
            "x3_rate_cost": fused_node.X3.LAUNCHES,
            "x4_pick": fused_node.X4.LAUNCHES,
            "p1_add_one": probes.LAUNCHES["add_one"],
            "p2_int8_mm": probes.LAUNCHES["int8_mm"],
            "p3_fused4": probes.LAUNCHES["fused4"]}


def lost_launches(kernels, before, after) -> dict:
    """{kernel: launches its wrapper counted between `before` and `after`
    (wrapper_launches()) minus the launches a session's `kernels` [(name,
    us, n)] record}, for the kernels the session recorded fewer of. (More is
    no loss: a tool may launch a kernel past its counting wrapper.)"""
    lost = {}
    for key in before:
        seen = sum(n for name, _, n in kernels if key in name)
        if after[key] - before[key] > seen:
            lost[key] = after[key] - before[key] - seen
    return lost


def profiled(fn, pad_s=PROFILE_PAD_S):
    """one torch.profiler session of fn, opened pad_s of host idle before
    fn and ended by draining the card's queue: ([(name, card microseconds,
    launches)] for every kernel the card ran, lost_launches() of the
    session)."""
    keep_cupti()
    before = wrapper_launches()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(pad_s)
        fn()
        torch.cuda.synchronize()
    kernels = [(name, us, n) for name, (us, n) in event_totals(prof).items()]
    return kernels, lost_launches(kernels, before, wrapper_launches())


def card_kernels(fn, whole=lambda kernels: True):
    """run fn under torch.profiler: ([(name, card microseconds, launches)]
    for every kernel the card ran, complete). A session that recorded no
    kernel, recorded fewer launches of one of the port's kernels than its
    wrapper made, or fails `whole` is run again, its window opened 10 times
    earlier each time (counted in LOST_SESSIONS); after PROFILE_TRIES such
    sessions the last one comes back with complete False. fn must be one
    that can run again."""
    global LOST_SESSIONS
    for attempt in range(PROFILE_TRIES):
        kernels, lost = profiled(fn, PROFILE_PAD_S * 10 ** attempt)
        if kernels and not lost and whole(kernels):
            return kernels, True
        LOST_SESSIONS += 1
    return kernels, False


def card_ms(fn, reps):
    """mean card milliseconds per call of fn: the kernels' own time, summed
    by torch.profiler over `reps` calls. Each call launches the same
    kernels, so each kernel's count in a whole session is a multiple of
    `reps`; a session where one is not, or where the port's wrappers
    launched more than it recorded, lost launches (or held one-time work of
    a first call) and is run again (card_kernels); after PROFILE_TRIES of
    them the time is busy_events_ms's, said on stderr."""
    kernels, complete = card_kernels(
        lambda: [fn() for _ in range(reps)],
        lambda ks: all(n % reps == 0 for _, _, n in ks))
    if complete:
        return sum(us for _, us, _ in kernels) / 1e3 / reps
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
