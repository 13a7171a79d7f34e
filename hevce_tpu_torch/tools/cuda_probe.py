"""Probes of the card for the port (the counterpart of tools/pallas_probe.py).

  P1  the cost of one launch: the trivial kernel add_one (x += 1 on an
      (8, 128) int32 buffer) iterated 64 and 1024 times, (a) as eager
      launches and (b) as one captured CUDA graph replayed (the graph is the
      counterpart of the TPU probe's lax.scan); us per launch from the
      difference of the two lengths. The same two figures for the library
      call x.add_(1).
  P2  int8 x int8 -> int32 products on the tensor cores (int8_mm, mma.sync):
      EXACT or MISMATCH against the plain version and the probe's own
      reference a.astype(int32) @ b.astype(int32), on random entries and on
      all -128; then the card time of the kernel and of torch._int_mm. On a
      card also at one busy shape, (4096, 4096, 4096): EXACT or MISMATCH
      against a float64 product (exact: |sum| < 2^26), and both card times.
  P3  the fused 4x4 eval (fused4) at 512 rows x 35 modes, qpd6=2: quant and
      sse EXACT or MISMATCH against the plain op chain and against K1 at
      (4, 35) (ops/fused_eval.pipeline_sse); then us per eval over a chain
      of 16 evals for the plain op chain, for P3 and for K1.

Each probe prints one line (P1 and P3 two, P2 two on a card). A failing
probe raises, so the tool exits non-zero. Times on the CPU (--device cpu)
are the host's; the card's numbers need a CUDA device.

Usage: python -m hevce_tpu_torch.tools.cuda_probe [--device cpu]
"""
import argparse

import numpy as np
import torch

from hevce_tpu_torch.ops import fused_eval, probes
from hevce_tpu_torch.utils import device as _device
from hevce_tpu_torch.utils import timing

P1_SHAPE = (8, 128)
P1_LENGTHS = (64, 1024)
P2_SHAPE = (512, 64, 64)             # M, K, N
P2_LARGE = (4096, 4096, 4096)
P3_ROWS, P3_MODES = 512, 35          # the TPU probe's B=32 x R=16 lanes
P3_CHAIN = 16
QPD6 = 2


class ProbeFailed(RuntimeError):
    """a probe's kernel disagreed with its reference."""


def _verdict(ok):
    return "EXACT" if ok else "MISMATCH"


# ------------------------------------------------------------------- P1

def _steps(step, x, n):
    for _ in range(n):
        step(x)


def _capture(step, x, n):
    """one CUDA graph of n launches of step(x); the launches read the
    capture stream from torch.cuda.current_stream()."""
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        _steps(step, x, n)
    return g


def probe_launch_overhead(dev, out=print):
    """P1. Returns {route: {"eager_us", "graph_us", "eager_s", "graph_s"}}
    for the kernel and the library call; graph figures only on CUDA."""
    res = {}
    routes = (("add_one", probes.add_one), ("x.add_(1)", lambda x: x.add_(1)))
    for name, step in routes:
        x = torch.zeros(P1_SHAPE, dtype=torch.int32, device=dev)
        walls = {"eager": {}, "graph": {}}
        for n in P1_LENGTHS:
            x.zero_()
            _steps(step, x, n)
            if not bool((x == n).all()):
                raise ProbeFailed(f"P1 {name}: {n} eager steps did not give "
                                  f"{n}")
            walls["eager"][n] = timing.wall_s(dev, lambda: _steps(step, x, n))
            if dev.type == "cuda":
                g = _capture(step, x, n)
                x.zero_()
                g.replay()
                if not bool((x == n).all()):
                    raise ProbeFailed(f"P1 {name}: a graph of {n} steps did "
                                      f"not give {n}")
                walls["graph"][n] = timing.wall_s(dev, g.replay)
        n1, n2 = P1_LENGTHS
        r = {}
        for kind, w in walls.items():
            if w:
                r[f"{kind}_us"] = (w[n2] - w[n1]) / (n2 - n1) * 1e6
                r[f"{kind}_s"] = [w[n1], w[n2]]
        res[name] = r
        ms = {k: " / ".join(f"{1e3 * s:.3f}" for s in r[f"{k}_s"])
              for k in walls if f"{k}_s" in r}
        graph = (f"CUDA graph {r['graph_us']:.3f} us/launch (walls "
                 f"{ms['graph']} ms)" if "graph_us" in r
                 else "CUDA graph: needs a CUDA device")
        out(f"P1 launch overhead, {name} on {dev.type}: eager "
            f"{r['eager_us']:.3f} us/launch (walls {ms['eager']} ms at {n1} "
            f"/ {n2}); {graph}")
    return res


# ------------------------------------------------------------------- P2

def p2_inputs(rng):
    """the probe's (M, K) and (K, N) int8 operands: random, and all -128
    (the largest products: |sum| = K * 2^14)."""
    M, K, N = P2_SHAPE
    rand = (rng.integers(-128, 128, (M, K)).astype(np.int8),
            rng.integers(-128, 128, (K, N)).astype(np.int8))
    low = (np.full((M, K), -128, np.int8), np.full((K, N), -128, np.int8))
    return [("random", *rand), ("all -128", *low)]


def probe_int8_matmul(dev, out=print):
    """P2. Returns {"exact": True, "card_us", "library_card_us", "large"}
    (the times and the large shape on CUDA only)."""
    cases = [(case, torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev),
              torch.from_numpy(a.astype(np.int32) @ b.astype(np.int32)))
             for case, a, b in p2_inputs(np.random.default_rng(0))]
    for case, a, b, want in cases:
        got = probes.int8_mm(a, b).cpu()
        plain = probes.int8_mm_plain(a, b).cpu()
        ok = torch.equal(got, plain) and torch.equal(got, want)
        if not ok:
            out(f"P2 int8 matmul ({case}): {_verdict(ok)}")
            raise ProbeFailed(f"P2 int8_mm differs from its references "
                              f"({case})")
    res = {"exact": True}
    _, a, b, _ = cases[0]
    M, K, N = P2_SHAPE
    if dev.type == "cuda":
        res.update(_p2_times(a, b))
        times = (f"card {res['card_us']:.3f} us, torch._int_mm "
                 f"{res['library_card_us']:.3f} us")
    else:
        times = "card times need a CUDA device"
    out(f"P2 int8 matmul ({M}, {K}) x ({K}, {N}) on {dev.type}: "
        f"{_verdict(True)} (random, all -128); {times}")
    if dev.type == "cuda":
        res["large"] = probe_int8_matmul_large(dev, out)
    return res


def _p2_times(a, b):
    return {"card_us": 1e3 * timing.card_ms(lambda: probes.int8_mm(a, b), 20),
            "library_card_us": 1e3 * timing.card_ms(
                lambda: torch._int_mm(a, b), 20)}


def probe_int8_matmul_large(dev, out=print):
    """P2 at P2_LARGE on the card, random operands: exact against a float64
    product, and the card times of the kernel and of torch._int_mm.
    Returns {"shape", "exact", "card_us", "library_card_us"}."""
    M, K, N = P2_LARGE
    g = torch.Generator(device=dev).manual_seed(2)
    a = torch.randint(-128, 128, (M, K), generator=g, device=dev,
                      dtype=torch.int8)
    b = torch.randint(-128, 128, (K, N), generator=g, device=dev,
                      dtype=torch.int8)
    want = (a.double() @ b.double()).int()
    ok = torch.equal(probes.int8_mm(a, b), want)
    del want
    if not ok:
        out(f"P2 int8 matmul {P2_LARGE}: {_verdict(ok)}")
        raise ProbeFailed(f"P2 int8_mm differs from a float64 product at "
                          f"{P2_LARGE}")
    res = dict(_p2_times(a, b), shape=list(P2_LARGE), exact=True)
    out(f"P2 int8 matmul ({M}, {K}) x ({K}, {N}) on {dev.type}: "
        f"{_verdict(ok)} (random, against float64); card "
        f"{res['card_us']:.3f} us, torch._int_mm "
        f"{res['library_card_us']:.3f} us")
    return res


# ------------------------------------------------------------------- P3

def p3_inputs(rng, rows=P3_ROWS, modes=P3_MODES):
    """pred (rows, modes * 16) and blk (rows, 16) uint8: a third random, a
    third near-perfect predictions (small residuals: zero levels, CG kills,
    the RDOQ -1/-2 candidates), a third flat predictions; lane 0 pred=0 /
    blk=255 and lane 1 the reverse (the widest residuals)."""
    blk = rng.integers(0, 256, (rows, 16)).astype(np.int32)
    pred = rng.integers(0, 256, (rows, modes, 16)).astype(np.int32)
    third = rows // 3
    pred[third:2 * third] = blk[third:2 * third, None] + rng.integers(
        -6, 7, (third, modes, 16))
    pred[2 * third:] = rng.integers(0, 256, (rows - 2 * third, modes, 1))
    pred[0], blk[0] = 0, 255
    pred[1:2], blk[1:2] = 255, 0        # (none at one row)
    u8 = lambda a: np.clip(a, 0, 255).astype(np.uint8)
    return u8(pred).reshape(rows, modes * 16), u8(blk)


def via_k1(pred, blk, qpd6):
    """K1 at (4, modes) on the probe's layout: (q int32 (rows, modes * 16),
    sse)."""
    rows, w = pred.shape
    q, _, sse = fused_eval.pipeline_sse(
        4, qpd6, pred.view(rows, w // 16, 4, 4), blk.view(rows, 4, 4))
    return q.to(torch.int32).reshape(rows, w), sse


def probe_fused_pipeline(dev, out=print):
    """P3. Returns {"exact": True, "us_per_eval": {"plain", "fused4",
    "k1"}} (host wall of a 16-eval chain, the card's queue drained)."""
    pred_np, blk_np = p3_inputs(np.random.default_rng(1))
    pred = torch.from_numpy(pred_np).to(dev)
    blk = torch.from_numpy(blk_np).to(dev)
    q, sse = probes.fused4(pred, blk, QPD6)
    verdicts = []
    for ref, (qr, sr) in (("plain", probes.fused4_plain(pred, blk, QPD6)),
                          ("K1 (4, 35)", via_k1(pred, blk, QPD6))):
        okq, oks = torch.equal(q, qr), torch.equal(sse, sr)
        verdicts.append(f"quant {_verdict(okq)}, sse {_verdict(oks)} "
                        f"against {ref}")
        if not (okq and oks):
            out(f"P3 fused 4x4 pipeline: {'; '.join(verdicts)}")
            raise ProbeFailed(f"P3 fused4 differs from {ref}")
    out(f"P3 fused 4x4 pipeline ({P3_ROWS} x {P3_MODES} blocks, qpd6="
        f"{QPD6}) on {dev.type}: {'; '.join(verdicts)}")

    def chain(ev):
        c = torch.zeros((), dtype=torch.int32, device=dev)
        for _ in range(P3_CHAIN):
            p = torch.clamp(pred.to(torch.int32) + c, 0, 255).to(torch.uint8)
            qq, ss = ev(p, blk, QPD6)
            c = c + (qq.sum(dtype=torch.int32) + ss.sum(dtype=torch.int32)) % 3
        return c

    evals = (("plain", probes.fused4_plain), ("fused4", probes.fused4),
             ("k1", via_k1))
    finals = {name: int(chain(ev)) for name, ev in evals}    # and warm-up
    if len(set(finals.values())) != 1:
        raise ProbeFailed(f"P3 chains end apart: {finals}")
    us = {name: 1e6 * timing.wall_s(dev, lambda: chain(ev)) / P3_CHAIN
          for name, ev in evals}
    out(f"P3 {P3_CHAIN}-eval chain on {dev.type} (host wall): plain op chain "
        f"{us['plain']:.1f} us/eval, fused4 {us['fused4']:.1f} us/eval, K1 "
        f"{us['k1']:.1f} us/eval")
    return {"exact": True, "us_per_eval": us}


# ------------------------------------------------------------------ main

def run(device=None, out=print):
    """all three probes on `device` (None: the card). Returns
    {"p1", "p2", "p3"} results; raises ProbeFailed on a disagreement."""
    dev = _device.resolve(device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    out(f"device: {name}")
    return {"p1": probe_launch_overhead(dev, out),
            "p2": probe_int8_matmul(dev, out),
            "p3": probe_fused_pipeline(dev, out)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="cpu to run the plain versions on the CPU; the "
                         "default is the card")
    args = ap.parse_args(argv)
    run(args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
