"""Do torch.profiler sessions on the card record every launch? A check of the
profiler against the kernel wrappers' own launch counters.

One configuration runs in one process: optionally a CUDA graph capture of
P1 first (as the probe tool makes), then --sessions sessions, each
launching --calls calls of one kernel through its wrapper and ending with a
synchronize. For every session it prints one JSON line: the profiler's count
of the kernel beside the wrapper counter's delta (their difference is the
launches lost), the profiler's counts of the launch API calls (cudaLaunch*
/ cuLaunch*) and of the kernels linked to them by correlation id, where in
the session's order the lost launches were (their correlation ids were
seen on the host but no kernel came), the session's window (the host
clock at entry and exit against the first and last kernel the card
reported, the profiler's epoch clock), and the least and the median time
from a kernel's launch call to its start on the card: a negative least is
how far the card's timestamps ran ahead of the host's. The kernels:
  k1     K1 at (4, 35), 288 lanes (fused_eval.pipeline_sse)
  p1     P1 on (8, 128) (probes.add_one)
  p2big  P2 at (4096, 4096, 4096) (probes.int8_mm): the card busy to the
         end of the session
  front  two wavefront front steps at the main path's 288 lanes (tens of
         thousands of kernels a session; K1 counted)

--matrix runs configurations one factor at a time, each in a process of its
own with KINETO_LOG_LEVEL=0, and collects each process's session lines and
Kineto's own log lines that count records it dropped or found out of the
window; it prints one JSON summary per configuration. The factors:
TEARDOWN_CUPTI 0 / 1, a graph capture first or not, the number of sessions
and of kernels a session, one session per process, host idle at the start
of each session (--pad-ms; --alternate pads every second session only, so
one process compares the two), the card busy to the session's end.

Usage: python -m hevce_tpu_torch.tools.profiler_sessions --matrix [--out F]
       python -m hevce_tpu_torch.tools.profiler_sessions [--kernel k1]
           [--sessions 40] [--calls 50] [--graph] [--teardown 0]
"""
import argparse
import json
import os
import pathlib
import re
import subprocess
import sys
import time

import numpy as np

# Kineto's own summary of a session's records (KINETO_LOG_LEVEL=0)
KINETO_LINES = re.compile(r"Record counts|[Oo]ut.of.range|[Dd]ropp|"
                          r"stopped early|[Bb]uffer|CUPTI|WARNING|ERROR")


def _kernel(torch, dev, name, rng):
    """(fn, wrapper counter reader, substring of the kernel's name)."""
    from hevce_tpu_torch.ops import fused_eval, probes

    if name == "p1":
        x = torch.zeros((8, 128), dtype=torch.int32, device=dev)
        return (lambda: probes.add_one(x),
                lambda: probes.LAUNCHES["add_one"], "p1_add_one")
    if name == "p2big":
        a = torch.ones((4096, 4096), dtype=torch.int8, device=dev)
        return (lambda: probes.int8_mm(a, a),
                lambda: probes.LAUNCHES["int8_mm"], "p2_int8_mm")
    k1_count = lambda: fused_eval.LAUNCHES
    if name == "k1":
        pred = torch.from_numpy(rng.integers(0, 256, (288, 35, 4, 4)).astype(
            np.uint8)).to(dev)
        blk = torch.from_numpy(rng.integers(0, 256, (288, 4, 4)).astype(
            np.uint8)).to(dev)
        return (lambda: fused_eval.pipeline_sse(4, 2, pred, blk), k1_count,
                "k1_kernel")
    from hevce_tpu_torch.models import wavefront as wf

    B, R, Cc = 18, 16, 24
    u8 = lambda *s: torch.from_numpy(
        rng.integers(0, 256, s).astype(np.uint8)).to(dev)
    W, O = u8(B, R, 3, 32, 32), u8(B, R, 32, 32)
    PME = torch.from_numpy(rng.integers(0, 35, (B, R, 8)).astype(
        np.int32)).to(dev)
    cv = torch.full((B * R,), wf.CTX_BIT, dtype=torch.int32, device=dev)
    sv = torch.full((B * R,), wf.SIG_ZERO, dtype=torch.int32, device=dev)

    def steps():
        with torch.no_grad():
            for d in (30, 31):
                wf.front_core(2, R, (12, 4), W, PME, O, d, Cc, cv, sv)
    return steps, k1_count, "k1_kernel"


def session_stats(prof, kernel, t_in, t_out, expected):
    """one session's counts from a finished profile (see the module doc)."""
    from torch.autograd import DeviceType

    launches, linked, kernels, names = {}, {}, [], {}
    for e in prof.profiler.kineto_results.events():
        n = e.name()
        if e.device_type() == DeviceType.CUDA:
            names[n] = names.get(n, 0) + 1
            linked[e.correlation_id()] = e.start_ns()
            if kernel in n:
                kernels.append((e.start_ns(), e.start_ns() + e.duration_ns()))
        elif "aunch" in n and ("cuda" in n or n.startswith("cu")):
            launches[e.correlation_id()] = e.start_ns()
    got = sum(v for n, v in names.items() if kernel in n)
    order = sorted(launches, key=launches.get)
    lost = [k for k, c in enumerate(order) if c not in linked]
    ks = sorted(kernels)
    # a kernel's start on the card minus its launch call's on the host: it
    # cannot be negative on one clock, so a negative least value is how far
    # the card's timestamps run ahead of the host's
    lead = sorted(linked[c] - launches[c] for c in order if c in linked)
    return {"expected": expected, "profiled": got, "lost": expected - got,
            "launch_calls": len(launches), "linked": len(order) - len(lost),
            "unlinked_pos": [round(k / max(1, len(order)), 3)
                             for k in lost[:8]],
            "n_unlinked": len(lost),
            "first_kernel_after_entry_us": (ks[0][0] - t_in) / 1e3
            if ks else None,
            "last_kernel_before_exit_us": (t_out - ks[-1][1]) / 1e3
            if ks else None,
            "trace_start_after_entry_us": (
                prof.profiler.kineto_results.trace_start_ns() - t_in) / 1e3,
            "card_events": sum(names.values()),
            "kernel_minus_launch_us": [lead[0] / 1e3, lead[len(lead) // 2]
                                       / 1e3] if lead else None}


def child(args):
    os.environ["TEARDOWN_CUPTI"] = str(args.teardown)
    import torch
    from torch.profiler import ProfilerActivity, profile

    from hevce_tpu_torch.ops import probes

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    fn, count, kernel = _kernel(torch, dev, args.kernel, rng)
    fn()
    torch.cuda.synchronize()
    if args.graph:
        x = torch.zeros((8, 128), dtype=torch.int32, device=dev)
        probes.add_one(x)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(4):
                probes.add_one(x)
        g.replay()
        torch.cuda.synchronize()
    for s in range(args.sessions):
        print(f"== session {s}", file=sys.stderr, flush=True)
        n0 = count()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t_in = time.time_ns()
            pad = args.pad_ms if not args.alternate or s % 2 else 0.0
            if pad:
                time.sleep(pad / 1e3)
            for _ in range(args.calls):
                fn()
            torch.cuda.synchronize()
            t_out = time.time_ns()
        st = session_stats(prof, kernel, t_in, t_out, count() - n0)
        print(json.dumps({"session": s, "pad_ms": pad, **st}), flush=True)


# (name, arguments): one factor changed at a time from "base"
MATRIX = [
    ("base", ["--kernel", "k1", "--sessions", "60", "--calls", "50"]),
    ("graph", ["--kernel", "k1", "--sessions", "60", "--calls", "50",
               "--graph"]),
    ("graph_teardown1", ["--kernel", "k1", "--sessions", "60", "--calls",
                         "50", "--graph", "--teardown", "1"]),
    ("teardown1", ["--kernel", "k1", "--sessions", "60", "--calls", "50",
                   "--teardown", "1"]),
    ("short_sessions", ["--kernel", "k1", "--sessions", "200", "--calls",
                        "2"]),
    ("long_sessions", ["--kernel", "k1", "--sessions", "10", "--calls",
                       "5000"]),
    ("p1", ["--kernel", "p1", "--sessions", "60", "--calls", "50",
            "--graph"]),
    ("front", ["--kernel", "front", "--sessions", "8", "--calls", "1"]),
    ("graph_long", ["--kernel", "k1", "--sessions", "400", "--calls", "50",
                    "--graph"]),
    ("graph_long_pad5", ["--kernel", "k1", "--sessions", "400", "--calls",
                         "50", "--graph", "--pad-ms", "5"]),
] + [(f"ab_pad10_{i}", ["--kernel", "k1", "--sessions", "800", "--calls",
                        "50", "--graph", "--pad-ms", "10", "--alternate"])
     for i in range(3)] + [
    ("busy", ["--kernel", "p2big", "--sessions", "200", "--calls", "20"])
] + [(f"one_per_process_{i}", ["--kernel", "k1", "--sessions", "1",
                               "--calls", "50"]) for i in range(4)]


def matrix(args):
    res = []
    env = dict(os.environ, KINETO_LOG_LEVEL="0")
    for name, extra in MATRIX:
        if args.only and name not in args.only.split(","):
            continue
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-m",
                            "hevce_tpu_torch.tools.profiler_sessions", *extra],
                           capture_output=True, text=True, env=env,
                           timeout=args.timeout)
        sessions = [json.loads(ln) for ln in r.stdout.splitlines()
                    if ln.startswith("{")]
        # Kineto's lines, by session
        kin, cur = {}, None
        for ln in r.stderr.splitlines():
            if ln.startswith("== session "):
                cur = int(ln.split()[-1])
            elif cur is not None and KINETO_LINES.search(ln):
                kin.setdefault(cur, []).append(ln.strip()[-200:])
        lost = [s for s in sessions if s["lost"]]
        leads = [s["kernel_minus_launch_us"][0] for s in sessions
                 if s["kernel_minus_launch_us"]]
        row = {"config": name, "args": extra, "rc": r.returncode,
               "least_kernel_minus_launch_us": [
                   leads[0], min(leads), leads[-1]] if leads else None,
               "seconds": time.perf_counter() - t0,
               "sessions": len(sessions), "lost_sessions": len(lost),
               "lost_sessions_by_pad_ms": {
                   str(pad): sum(1 for s in lost if s["pad_ms"] == pad)
                   for pad in sorted({s["pad_ms"] for s in sessions})},
               "sessions_with_card_ahead": sum(
                   1 for s in sessions if s["kernel_minus_launch_us"]
                   and s["kernel_minus_launch_us"][0] < 0),
               "lost_launches": sum(s["lost"] for s in sessions),
               "first_lost": [s["session"] for s in lost[:10]],
               "lost_examples": lost[:3],
               "kineto_lost_sessions": {s["session"]: kin.get(s["session"])
                                        for s in lost[:3]},
               "kineto_sample": kin.get(0, [])[:12],
               "kineto_last": kin.get(len(sessions) - 1, [])[:12],
               "stderr_tail": r.stderr[-600:] if r.returncode else ""}
        res.append(row)
        print(json.dumps(row), flush=True)
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "w") as f:
            for row in res:
                f.write(json.dumps(row) + "\n")
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--matrix", action="store_true")
    ap.add_argument("--only", default=None,
                    help="with --matrix: comma-separated configurations")
    ap.add_argument("--out", default=None)
    ap.add_argument("--timeout", type=float, default=600)
    ap.add_argument("--kernel", default="k1",
                    choices=["k1", "p1", "p2big", "front"])
    ap.add_argument("--sessions", type=int, default=40)
    ap.add_argument("--calls", type=int, default=50)
    ap.add_argument("--graph", action="store_true")
    ap.add_argument("--teardown", type=int, default=0, choices=[0, 1])
    ap.add_argument("--pad-ms", type=float, default=0.0,
                    help="host idle at the start of each session, ms")
    ap.add_argument("--alternate", action="store_true",
                    help="pad only every second session")
    args = ap.parse_args(argv)
    if args.matrix:
        matrix(args)
    else:
        child(args)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
