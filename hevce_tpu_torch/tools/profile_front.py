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

Images are the PGM files given (those of the first one's shape, up to B);
without files, B synthetic 768x512 images made from --seed (Kodak's
landscape shape; Kodak is not in the repository).

Usage: python -m hevce_tpu_torch.tools.profile_front [image.pgm ...]
           [--batch 18] [--fronts 2] [--top 40] [--seed 0]
           [--logdir build/trace_front] [--device cpu]
"""
import argparse
import contextlib
import time

import numpy as np
import torch
from torch.autograd import DeviceType

from hevce_tpu_torch.models import wavefront as wf
from hevce_tpu_torch.runtime import build
from hevce_tpu_torch.utils import device as _device
from hevce_tpu_torch.utils import timing
from hevce_tpu_torch.utils.imageio import read_pgm
from hevce_tpu_torch.utils.synth import SIGMAS, synth_image
from hevce_tpu_torch.utils.tracing import PhaseTimer, device_trace

QPD6 = 2


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
    args = ap.parse_args(argv)
    dev = _device.resolve(args.device)
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
