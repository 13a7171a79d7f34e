"""K1 against its plain op pipeline (the counterpart of tools/bench_fused.py).

For each (sz, M) given (default 8,12 and 4,35) at 288 lanes (B=18 x R=16,
the fast mode's lanes for a 768x512 batch of 18), at qpd6=2:
  * K1 (ops/fused_eval.pipeline_sse) must equal its plain version
    (pipeline_sse_plain): q, recon and sse, tolerance 0;
  * the marginal us per eval of each, from two chain lengths n1 and n2:
    (t(n2) - t(n1)) / (n2 - n1). Each link is one eval on a prediction
    shifted by the previous link's result, so no eval can be skipped or
    hoisted. On the card t is CUDA-event time (the host's enqueue of each
    link included, as the fast mode pays it); on the CPU it is host time.

A disagreement exits non-zero.

Usage: python -m hevce_tpu_torch.tools.bench_fused [sz,M ...] [--n1 32]
           [--n2 160] [--device cpu]
"""
import argparse
import functools
import time

import numpy as np
import torch

from hevce_tpu_torch.ops import fused_eval
from hevce_tpu_torch.utils import device as _device

QPD6 = 2
LANES = 288


def chain_time(dev, ev, pred, blk, n, reps=3):
    """least seconds of a chain of n evals ev(pred, blk) over reps runs."""
    def run():
        c = torch.zeros((), dtype=torch.int32, device=dev)
        for _ in range(n):
            pc = torch.clamp(pred.to(torch.int32) + c, 0, 255).to(torch.uint8)
            q, _, sse = ev(pc, blk)
            c = c + 1 + (q.sum(dtype=torch.int32)
                         + sse.sum(dtype=torch.int32)) % 2
        return c

    run()                                              # warm-up
    best = float("inf")
    for _ in range(reps):
        if dev.type == "cuda":
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            t0.record()
            run()
            t1.record()
            torch.cuda.synchronize()
            best = min(best, t0.elapsed_time(t1) / 1e3)
        else:
            t0 = time.perf_counter()
            run()
            best = min(best, time.perf_counter() - t0)
    return best


def bench(dev, sz, M, n1, n2, out=print):
    """exactness and marginal us per eval of K1 and the plain pipeline at
    (sz, M). Returns {"exact": True, "k1_us", "plain_us"}; raises
    RuntimeError if K1 differs from the plain version."""
    rng = np.random.default_rng(sz + M)
    pred = torch.from_numpy(rng.integers(0, 256, (LANES, M, sz, sz))
                            .astype(np.uint8)).to(dev)
    blk = torch.from_numpy(rng.integers(0, 256, (LANES, sz, sz))
                           .astype(np.uint8)).to(dev)
    got = fused_eval.pipeline_sse(sz, QPD6, pred, blk)
    want = fused_eval.pipeline_sse_plain(sz, QPD6, pred, blk)
    oks = [torch.equal(g, w) for g, w in zip(got, want)]
    out(f"sz={sz} M={M} lanes={LANES} on {dev.type}: exactness "
        + " ".join(f"{k}={'OK' if ok else 'BAD'}"
                   for k, ok in zip(("q", "recon", "sse"), oks)))
    if not all(oks):
        raise RuntimeError(f"K1 differs from its plain version at sz={sz} "
                           f"M={M}")
    res = {"exact": True}
    clock = "card (CUDA events)" if dev.type == "cuda" else "host (CPU)"
    for name, fn in (("plain", fused_eval.pipeline_sse_plain),
                     ("k1", fused_eval.pipeline_sse)):
        ev = functools.partial(fn, sz, QPD6)
        t1 = chain_time(dev, ev, pred, blk, n1)
        t2 = chain_time(dev, ev, pred, blk, n2)
        res[f"{name}_us"] = (t2 - t1) / (n2 - n1) * 1e6
        out(f"  {name:5s}: {res[f'{name}_us']:9.2f} us/eval on the {clock} "
            f"clock (chains {1e3 * t1:.3f} / {1e3 * t2:.3f} ms at {n1} / "
            f"{n2})")
    return res


def main(argv=None, out=print):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("shapes", nargs="*", help="sz,M pairs (default 8,12 4,35)")
    ap.add_argument("--n1", type=int, default=32)
    ap.add_argument("--n2", type=int, default=160)
    ap.add_argument("--device", default=None,
                    help="cpu to run on the CPU; the default is the card")
    args = ap.parse_args(argv)
    dev = _device.resolve(args.device)
    shapes = [tuple(int(v) for v in s.split(",")) for s in args.shapes] \
        or [(8, 12), (4, 35)]
    if dev.type == "cuda":
        out(f"device: {torch.cuda.get_device_name(dev)}")
    for sz, M in shapes:
        bench(dev, sz, M, args.n1, args.n2, out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
