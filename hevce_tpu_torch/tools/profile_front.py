"""Profile front steps of the fast mode (the counterpart of
tools/profile_front.py).

Runs one models/wavefront._dispatch_batch of B images at qpd6=2 (the whole
wavefront slice, the record checksum and the copy to the host) and traces
--fronts of its front steps from the middle of the run under
utils/tracing.device_trace: each front step launches tens of thousands of
kernels, so a whole 768x512 slice (54 steps) would make a trace of millions
of events. On the card each front step is a replay of the slice runner's
CUDA graph; a warm-up dispatch of the same batch captures it first, so the
traced run replays it. Writes the Chrome trace into --logdir and prints the
top-K kernels by card time with their launch counts, the card's total, and
the window's wall time.
On the card the first line also says whether the trace holds every launch
of the port's kernels (utils/tracing.device_trace's lost_launches): a trace
that lost launches is flagged, never reported as whole.
On the CPU (--device cpu) it ranks the operators by
host time instead (inclusive of the operators they call), and says so: the
CPU has no card time.

--chains instead breaks ONE eager front step (front_core at front 30 of a
768x512 grid: 16 rows x --batch images, random canvases) down by op chain:
the tool wraps the chain functions of CHAINS in ranges of its own (the
production code is not changed), and each op or kernel belongs to the
innermost range it was issued in; the port's kernels (KERNELS) by their
names. On the card: kernels and card ms per chain (torch.profiler, each
kernel tied to its launching op by its correlation id). On the CPU: the
non-view aten ops per chain (a TorchDispatchMode), each kernel wrapper's
call counted as the one launch it makes on the card: the count predicts
the kernels, and the graph nodes, of a card step.

Images are the PGM files given (those of the first one's shape, up to B);
without files, B synthetic 768x512 images made from --seed (Kodak's
landscape shape; Kodak is not in the repository).

Usage: python -m hevce_tpu_torch.tools.profile_front [image.pgm ...]
           [--batch 18] [--fronts 2] [--top 40] [--seed 0]
           [--logdir build/trace_front] [--device cpu] [--chains [--dense]]
"""
import argparse
import bisect
import collections
import contextlib
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import record_function
from torch.utils._python_dispatch import TorchDispatchMode

from hevce_tpu_torch.models import cu_eval
from hevce_tpu_torch.models import wavefront as wf
from hevce_tpu_torch.ops import fused_eval, fused_node, intra, rdcost, satd
from hevce_tpu_torch.runtime import build
from hevce_tpu_torch.utils import device as _device
from hevce_tpu_torch.utils import timing
from hevce_tpu_torch.utils.imageio import read_pgm
from hevce_tpu_torch.utils.synth import SIGMAS, synth_image
from hevce_tpu_torch.utils.tracing import PhaseTimer, device_trace

QPD6 = 2

# the op chains of a front step: (label, [(module, function name)]); the
# rate model's pieces run inside X2's and X3's plain versions (and
# _topk_mask / _sel_i32 also in the node functions themselves), the picks
# inside X4's
CHAINS = (
    ("rate+cost", [(fused_node, "_pmode_rate"), (fused_node, "_mpm_triplet"),
                   (fused_node, "_sel_i32"), (wf, "_sel_i32"),
                   (fused_node, "_lastxy_rate"), (fused_node, "_est_rate"),
                   (rdcost, "calc_rd_cost")]),
    ("borders+predict", [(intra, "build_borders"),
                         (intra, "predict_all_modes"),
                         (intra, "predict_per_lane"),
                         (fused_node, "_select_pred"), (satd, "block_satd"),
                         (fused_node, "_compress_u8"),
                         (cu_eval, "eval_2nx2n"), (cu_eval, "eval_tusplit")]),
    ("topk", [(fused_node, "_topk_mask"), (wf, "_topk_mask")]),
    ("picks", [(fused_node, "_argmin_first"), (fused_node, "_onehot_pick")]),
    ("node (own)", [(wf, "_eval_node"), (wf, "_eval_node_rmd"),
                    (wf, "_eval_nxn")]),
)
OUTSIDE = "front_core (own)"
# the port's kernels on the step: (label, wrapper, a substring of the
# kernel's name)
KERNELS = (("K1", (fused_eval, "pipeline_sse"), "k1_kernel"),
           ("X1 predict", (fused_node, "predict"), "x1_predict"),
           ("X2 preselect", (fused_node, "preselect"), "x2_preselect"),
           ("X3 rate_cost", (fused_node, "rate_cost"), "x3_rate_cost"),
           ("X4 pick", (fused_node, "pick"), "x4_pick"))


def load_images(paths, batch, seed):
    if paths:
        imgs = [read_pgm(p) for p in paths]
        return [im for im in imgs if im.shape == imgs[0].shape][:batch]
    rng = np.random.default_rng(seed)
    return [synth_image(rng, 512, 768, SIGMAS[i % 4]) for i in range(batch)]


def report(agg, dev, fronts, wall, top_k, out=print):
    """print the window's totals and its top_k rows by time. Returns the
    total ms."""
    what = ("card time" if dev.type == "cuda"
            else "host (CPU) operator time, inclusive; no card")
    total = sum(us for us, _ in agg.values()) / 1e3
    count = sum(n for _, n in agg.values())
    out(f"{what}: {total:.3f} ms in {count} events of {len(agg)} kinds over "
        f"{fronts} front steps ({total / fronts:.3f} ms per step; window "
        f"wall {1e3 * wall / fronts:.3f} ms per step)")
    out(f"{'total_ms':>10} {'n':>7} {'us/ev':>9}  name")
    for name, (us, n) in sorted(agg.items(), key=lambda kv: -kv[1][0])[:top_k]:
        out(f"{us / 1e3:10.3f} {n:7d} {us / n:9.2f}  {name[:110]}")
    return total


@contextlib.contextmanager
def traced_fronts(logdir, first, count):
    """trace front steps first .. first + count - 1 of the runs inside the
    block (the slice runner's front wrapped: a graph replay on the card).
    Yields a dict that receives "prof" and "wall" (seconds from the window's
    start to its end, the queue drained)."""
    front, calls, got = wf._SliceRunner.front, [0], {}
    stack = contextlib.ExitStack()

    def window_front(runner, d):
        if calls[0] == first:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            got["prof"] = stack.enter_context(device_trace(logdir))
            got["t0"] = time.perf_counter()
        front(runner, d)
        calls[0] += 1
        if calls[0] == first + count:
            stack.close()
            got["wall"] = time.perf_counter() - got["t0"]

    wf._SliceRunner.front = window_front
    try:
        yield got
    finally:
        wf._SliceRunner.front = front
        stack.close()


@contextlib.contextmanager
def chain_ranges(stack, calls):
    """every function of CHAINS and every kernel wrapper of KERNELS wrapped
    in a range of its label (torch.profiler's record_function), its label
    pushed on `stack` while it runs; `calls` counts the kernel wrappers'
    calls by label."""
    saved = []
    kernels = {label for label, _, _ in KERNELS}
    wrap = [(label, f) for label, fns in CHAINS for f in fns] + \
        [(label, f) for label, f, _ in KERNELS]
    for label, (mod, name) in wrap:
        fn = getattr(mod, name)
        if (mod, name) in {s[:2] for s in saved}:
            continue

        def ranged(*a, _fn=fn, _label=label, **k):
            if _label in kernels:
                calls[_label] += 1
            stack.append(_label)
            try:
                with record_function(_label):
                    return _fn(*a, **k)
            finally:
                stack.pop()
        saved.append((mod, name, fn))
        setattr(mod, name, ranged)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


class _OpCount(TorchDispatchMode):
    """non-view aten ops by the innermost label on `stack`; the ops inside
    a kernel wrapper count as the one launch it makes on the card."""
    SKIP = {"aten::empty", "aten::empty_strided", "aten::empty_like",
            "aten::lift_fresh", "aten::_unsafe_view"}    # no kernel

    def __init__(self, stack):
        super().__init__()
        self.stack, self.ops = stack, collections.Counter()
        self.kernels = {label for label, _, _ in KERNELS}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if (func.is_view or func.name() in self.SKIP
                or func.name().startswith("profiler::")):     # the ranges
            return out
        inner = next((lb for lb in self.stack if lb in self.kernels), None)
        if inner is None:
            self.ops[self.stack[-1] if self.stack else OUTSIDE] += 1
        return out


def chain_step_inputs(dev, B, seed):
    """front 30 of a 768x512 grid of B images (R=16 rows, 24 columns):
    random canvases, originals and pmode edge, the constant prices."""
    rng = np.random.default_rng(seed)
    R = 16
    u8 = lambda *s: torch.from_numpy(
        rng.integers(0, 256, s).astype(np.uint8)).to(dev)
    W, O = u8(B, R, 3, 32, 32), u8(B, R, 32, 32)
    PME = torch.from_numpy(rng.integers(0, 35, (B, R, 8)).astype(
        np.int32)).to(dev)
    cv = torch.full((B * R,), wf.CTX_BIT, dtype=torch.int32, device=dev)
    sv = torch.full((B * R,), wf.SIG_ZERO, dtype=torch.int32, device=dev)
    return R, W, PME, O, cv, sv


def chains(dev, B, seed, rmd, out=print):
    """the chain table of one eager front step (see the module's doc).
    Returns {label: (ops or kernels, card ms or None)}."""
    R, W, PME, O, cv, sv = chain_step_inputs(dev, B, seed)

    def step():
        with torch.no_grad():
            wf.front_core(QPD6, R, rmd, W, PME, O, 30, 24, cv, sv)

    stack, calls = [], collections.Counter()
    step()                                   # tables, builds, allocator
    with chain_ranges(stack, calls):
        if dev.type == "cuda":
            torch.cuda.synchronize()
            with device_trace(build.ROOT / "build" / "trace_chains") as prof:
                step()
            rows = card_by_chain(prof)
        else:
            with _OpCount(stack) as count:
                step()
            rows = {k: (n, None) for k, n in (count.ops + calls).items()}
    what = ("kernels, card ms" if dev.type == "cuda" else
            "ops (non-view aten ops; a kernel wrapper's call is one), "
            "host only: no card time")
    n_all = sum(n for n, _ in rows.values())
    out(f"one eager front step, rmd={rmd}, {B * R} lanes, on "
        f"{torch.cuda.get_device_name(dev) if dev.type == 'cuda' else 'cpu'}"
        f": {n_all} {what.split(',')[0].split(' (')[0]} in all ({what})")
    for label, (n, ms) in sorted(rows.items(), key=lambda kv: -kv[1][0]):
        ms_s = "" if ms is None else f" {ms:10.3f} ms"
        out(f"{label:>18} {n:7d} {100 * n / max(n_all, 1):5.1f}%{ms_s}")
    return rows


def card_by_chain(prof):
    """{label: (kernels, card ms)} of a traced step: a kernel of KERNELS by
    its name, any other by the innermost chain range around the op that
    launched it (its linked correlation id), else OUTSIDE."""
    evs = list(prof.profiler.kineto_results.events())
    labels = {lb for lb, _ in CHAINS} | {lb for lb, _, _ in KERNELS}
    cpu = {e.correlation_id(): e for e in evs
           if e.device_type() == DeviceType.CPU}
    ranges = sorted((e.start_ns(), e.end_ns(), e.name()) for e in cpu.values()
                    if e.name() in labels)
    starts = [r[0] for r in ranges]
    parent, open_ = [], []
    for i, (t0, t1, _) in enumerate(ranges):
        while open_ and ranges[open_[-1]][1] <= t0:
            open_.pop()
        parent.append(open_[-1] if open_ else -1)
        open_.append(i)

    def innermost(t):
        i = bisect.bisect_right(starts, t) - 1
        while i >= 0 and not ranges[i][0] <= t < ranges[i][1]:
            i = parent[i]
        return ranges[i][2] if i >= 0 else OUTSIDE

    rows = collections.defaultdict(lambda: [0, 0.0])
    for e in evs:
        if e.device_type() != DeviceType.CUDA:
            continue
        if e.name() in labels:           # a range's span on the card's
            continue                     # timeline, not work
        label = next((lb for lb, _, key in KERNELS if key in e.name()), None)
        if label is None:
            src = cpu.get(e.linked_correlation_id())
            label = innermost(src.start_ns()) if src is not None else OUTSIDE
        rows[label][0] += 1
        rows[label][1] += e.duration_ns() / 1e6
    return {k: tuple(v) for k, v in rows.items()}


def main(argv=None, out=print):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("images", nargs="*", help="PGM files (default: synthetic)")
    ap.add_argument("--batch", type=int, default=18)
    ap.add_argument("--fronts", type=int, default=2,
                    help="front steps to trace, from the middle of the run")
    ap.add_argument("--top", type=int, default=40)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--logdir", default=str(build.ROOT / "build" /
                                            "trace_front"))
    ap.add_argument("--device", default=None,
                    help="cpu to profile the CPU run; the default is the card")
    ap.add_argument("--chains", action="store_true",
                    help="one eager front step by op chain instead")
    ap.add_argument("--dense", action="store_true",
                    help="with --chains: the dense (rmd=None) step")
    args = ap.parse_args(argv)
    dev = _device.resolve(args.device)
    if args.chains:
        chains(dev, args.batch, args.seed, None if args.dense
               else wf.RMD_DEFAULT, out)
        return 0
    imgs = load_images(args.images, args.batch, args.seed)
    h, w = imgs[0].shape
    R, Cc = -(-h // wf.CTU), -(-w // wf.CTU)
    D = 2 * (R - 1) + Cc
    fronts = max(1, min(args.fronts, D))

    def batch():
        rec, meta = wf._dispatch_batch(imgs, QPD6, device=dev)
        wf._fetch_lean(rec, meta, PhaseTimer())        # waits, checks

    # warm-up: the batch once, which builds its shape's runner (on the card
    # the eager warm-up step and the graph capture)
    batch()
    with traced_fronts(args.logdir, (D - fronts) // 2, fronts) as got:
        t0 = time.perf_counter()
        batch()
        wall = time.perf_counter() - t0
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    lost = got["prof"].lost_launches
    check = ("" if dev.type != "cuda" else
             f"; LOST LAUNCHES (wrappers' count minus the trace's): {lost}"
             if lost else "; the trace holds every launch the port's "
             "wrappers made")
    out(f"batch: B={len(imgs)} {w}x{h} qpd6={QPD6} on {name}: {D} front "
        f"steps, {wall:.3f} s wall with the trace; trace of {fronts} steps "
        f"in {args.logdir}{check}")
    kind = DeviceType.CUDA if dev.type == "cuda" else DeviceType.CPU
    report(timing.event_totals(got["prof"], kind), dev, fronts, got["wall"],
           args.top, out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
