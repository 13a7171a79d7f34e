#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (hevce_tpu_torch) on one NVIDIA GPU.

Phases, each printed as one JSON line:

  build     compile the native host library (g++) and kernel K1 (nvcc) from
            the sources in this checkout, both at once; seconds for each.
  kernels   K1 against its plain PyTorch version on the card for the 11
            production (sz, M) shapes x qpd6 0-4 at 288 lanes (the main
            path's lane count for a 768x512 batch of 18): q, recon and sse
            must be equal (tolerance 0). Then per-shape card times of K1
            and of the plain version (torch.profiler), K1's time per call
            with the host's enqueue (CUDA events), and the least time the
            card could take.
  slice     the main path, as a user calls it: encode_many_fast on 18
            synthetic 768x512 and 6 synthetic 512x768 images (qpd6=2,
            batch=18, RMD (12, 4), 'pre' prices, lean records, host pack).
            K1 must launch exactly 169 times per front step, and every
            stream must decode, through the independent native decoder, to
            the recon returned with it.
  profile   torch.profiler over two front steps at the main path's lanes:
            wall time, the card's busy time and K1's part of it.
  identity  3 small images at qpd6 0, 2 and 4, run on the card and on the
            CPU: the lean record buffers must be byte-identical.

Then the card's name and power limit (nvidia-smi), the kernels line and, as
the last line, {"ok": true, "device": {...}}. Any failure exits non-zero.
Without CUDA, or outside a checkout of the repository, it exits non-zero
and prints no result.

Usage: python3 chip_smoke.py [--seed N]
"""
import argparse
import json
import pathlib
import subprocess
import sys
import threading
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
QPD6 = 2
BATCH = 18
LANES = 288                      # B * R for a 768x512 batch of 18 images
SHAPES = [(4, 35), (4, 4), (8, 4), (8, 12), (16, 4), (16, 12),
          (32, 4), (32, 12), (8, 35), (16, 35), (32, 35)]
# K1 launches per front step by (sz, M): 16 leaves x (8x8 2Nx2N on K=12,
# four 4x4 TU-split subs on T=4, four 4x4 NxN PUs on 35 modes), 4 quadrants
# x (16x16 2Nx2N + four 8x8 subs), the root (32x32 2Nx2N + four 16x16 subs)
PER_FRONT = {(8, 12): 16, (4, 4): 64, (4, 35): 64, (16, 12): 4, (8, 4): 16,
             (32, 12): 1, (16, 4): 4}
LAUNCHES_PER_FRONT = sum(PER_FRONT.values())            # 169
# NVIDIA H100 SXM peaks (data sheet): 3.35 TB/s of HBM; K1's arithmetic is
# int32 multiply-add on the CUDA cores, 64 lanes per SM against FP32's 128,
# so half of the 67 TFLOP/s FP32 rate (a multiply-add counts as 2 ops)
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12 / 2


def emit(obj):
    print(json.dumps(obj), flush=True)


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def cuda_ms(torch, fn, reps):
    """mean milliseconds per call of fn, host enqueue included (CUDA
    events around `reps` back-to-back calls)."""
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


def card_kernels(torch, fn):
    """run fn under torch.profiler: [(name, card microseconds, launches)]
    for every kernel the card ran."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA]


def card_ms(torch, fn, reps):
    """mean card milliseconds per call of fn: the kernels' own time."""
    us = sum(t for _, t, _ in card_kernels(
        torch, lambda: [fn() for _ in range(reps)]))
    if not us:
        fail("the profiler recorded no time on the card")
    return us / 1e3 / reps


# ------------------------------------------------------------------- build

def phase_build():
    from hevce_tpu_torch.ops import fused_eval
    from hevce_tpu_torch.runtime import native

    res, errs = {}, []

    def run(name, fn):
        t0 = time.perf_counter()
        try:
            _, log = fn(force=True)
        except Exception as e:          # reported below; the phase fails
            errs.append(f"{name}: {e}")
            return
        res[name] = (time.perf_counter() - t0, log)

    threads = [threading.Thread(target=run, args=a) for a in
               (("host", native.build), ("fused_eval", fused_eval.build))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errs:
        fail("build: " + " | ".join(errs))
    ptxas = [ln.strip() for ln in res["fused_eval"][1].splitlines()
             if "registers" in ln or "Compiling entry" in ln]
    emit({"phase": "build", "host_lib_s": res["host"][0],
          "fused_eval_s": res["fused_eval"][0], "ptxas": ptxas})


# ----------------------------------------------------------------- kernels

def k1_inputs(torch, dev, rng, sz, M, lanes):
    """noise, near-perfect predictions (small residuals: zero levels, CG
    kills, the RDOQ -1/-2 candidates) and flat predictions, plus the
    adversarial lanes pred=0/blk=255 and the reverse (clip16, escapes)."""
    blk = rng.integers(0, 256, (lanes, sz, sz)).astype(np.int32)
    pred = rng.integers(0, 256, (lanes, M, sz, sz)).astype(np.int32)
    third = lanes // 3
    near = blk[third:2 * third, None] + rng.integers(
        -6, 7, (third, M, sz, sz))
    pred[third:2 * third] = near
    pred[2 * third:] = rng.integers(0, 256, (lanes - 2 * third, M, 1, 1))
    pred[0], blk[0] = 0, 255
    pred[1], blk[1] = 255, 0
    to = lambda a: torch.from_numpy(np.clip(a, 0, 255).astype(np.uint8)).to(dev)
    return to(pred), to(blk)


def k1_cost(sz, M, lanes):
    """(bytes, int32 ops) one call must move and do: each input read once
    (pred, blk), each output written once (q i16, recon u8, sse i32); four
    sz x sz x sz transform stages per candidate, 2 ops per multiply-add."""
    n = lanes * M
    nn = sz * sz
    nbytes = n * nn + lanes * nn + n * nn * 2 + n * nn + n * 4
    ops = n * 4 * nn * sz * 2
    return nbytes, ops


def phase_kernels(torch, dev, rng):
    from hevce_tpu_torch.ops import fused_eval

    max_err, checked = 0, 0
    for qpd6 in range(5):
        for sz, M in SHAPES:
            pred, blk = k1_inputs(torch, dev, rng, sz, M, LANES)
            got = fused_eval.pipeline_sse(sz, qpd6, pred, blk)
            torch.cuda.synchronize()
            want = fused_eval.pipeline_sse_plain(sz, qpd6, pred, blk)
            for name, g, w in zip(("q", "recon", "sse"), got, want):
                if g.dtype != w.dtype or g.shape != w.shape:
                    fail(f"K1 {name} sz={sz} M={M} qpd6={qpd6}: "
                         f"{g.dtype}{tuple(g.shape)} vs {w.dtype}"
                         f"{tuple(w.shape)}")
                err = int((g.to(torch.int64) - w.to(torch.int64)).abs().max())
                max_err = max(max_err, err)
                if err:
                    fail(f"K1 {name} differs from the plain version at "
                         f"sz={sz} M={M} qpd6={qpd6}: max |err| {err}")
            checked += 1

    shapes = []
    for sz, M in SHAPES:
        pred, blk = k1_inputs(torch, dev, rng, sz, M, LANES)
        k1 = lambda: fused_eval.pipeline_sse(sz, QPD6, pred, blk)
        plain = lambda: fused_eval.pipeline_sse_plain(sz, QPD6, pred, blk)
        call_ms = cuda_ms(torch, k1, 50)
        ms, plain_ms = card_ms(torch, k1, 20), card_ms(torch, plain, 5)
        nbytes, ops = k1_cost(sz, M, LANES)
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S
        shapes.append({"sz": sz, "M": M, "lanes": LANES,
                       "per_front": PER_FRONT.get((sz, M), 0),
                       "ms": ms, "plain_ms": plain_ms, "call_ms": call_ms,
                       "bound_ms": 1e3 * max(t_bytes, t_ops),
                       "bound_by": "bytes" if t_bytes > t_ops
                       else "operations"})
    emit({"phase": "kernels", "kernel": "fused_eval",
          "checked": checked, "exact": True, "max_abs_err": max_err,
          "library_ms": None,
          "library_note": "no single PyTorch call computes this function",
          "shapes": shapes})
    return max_err, shapes


# ------------------------------------------------------------------- slice

def synth_image(rng, h, w, noise_sigma):
    """illumination gradient, flat rectangles with edges, an oriented
    texture patch and Gaussian noise: splits, TU-splits and NxN all occur."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    img = 60 + 120 * (0.5 + 0.5 * np.sin(xx / w * rng.uniform(1, 4)
                                         + rng.uniform(0, 6))) \
        * (0.5 + 0.5 * yy / h)
    for _ in range(int(rng.integers(6, 16))):
        y0, x0 = int(rng.integers(0, h)), int(rng.integers(0, w))
        hh, ww = int(rng.integers(12, h // 3)), int(rng.integers(12, w // 3))
        img[y0:y0 + hh, x0:x0 + ww] = rng.uniform(20, 235)
    fy, fx = rng.uniform(0.05, 0.7, 2)
    cy, cx = rng.uniform(0, h), rng.uniform(0, w)
    patch = ((yy - cy) / (h / 3)) ** 2 + ((xx - cx) / (w / 3)) ** 2 < 1
    img += 45 * np.sin(yy * fy + xx * fx) * patch
    img += rng.normal(0, noise_sigma, (h, w))
    return np.clip(np.rint(img), 0, 255).astype(np.uint8)


def synth_set(rng):
    """18 images of shape (512, 768) and 6 of (768, 512): Kodak's shapes."""
    sigmas = (1.5, 3.0, 6.0, 30.0)
    land = [synth_image(rng, 512, 768, sigmas[i % 4]) for i in range(18)]
    port = [synth_image(rng, 768, 512, sigmas[(i + 3) % 4]) for i in range(6)]
    return land + port


def psnr(a, b):
    m = ((a.astype(np.int64) - b.astype(np.int64)) ** 2).mean()
    return float(10 * np.log10(255 * 255 / max(m, 1e-9)))


def phase_slice(torch, dev, rng, card):
    from hevce_tpu_torch.models import wavefront as wf
    from hevce_tpu_torch.ops import fused_eval
    from hevce_tpu_torch.runtime import native
    from hevce_tpu_torch.utils.tracing import PhaseTimer

    if wf.adapt_mode() != "pre" or wf._resolve_rmd(wf._RMD_ENV) != (12, 4):
        fail("the main path runs HEVCE_ADAPT=pre and RMD (12, 4); unset "
             "HEVCE_ADAPT / HEVCE_RMD")
    imgs = synth_set(rng)
    shapes = sorted({im.shape for im in imgs})
    grads = {s: [wf._grad_energy(im) for im in imgs if im.shape == s]
             for s in shapes}
    for s, g in grads.items():
        if not any(x >= wf.ADAPT_GRAD_TRIGGER for x in g):
            fail(f"no image of shape {s} crosses the gradient trigger")

    # warm-up on small images: CUDA context, cuBLAS handles, K1's constants
    warm = [im[:64, :96] for im in imgs[:2]]
    wf.encode_many_fast(warm, QPD6, batch=2, device=dev)
    torch.cuda.synchronize()

    timer = PhaseTimer()
    fused_eval.LAUNCHES = 0
    t0 = time.perf_counter()
    streams, recons = wf.encode_many_fast(imgs, QPD6, batch=BATCH,
                                          timer=timer, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fused_eval.LAUNCHES

    fronts = 0
    for s in shapes:
        R, Cc = -(-s[0] // 32), -(-s[1] // 32)
        n = sum(1 for im in imgs if im.shape == s)
        fronts += -(-n // BATCH) * (2 * (R - 1) + Cc)
    if launches != LAUNCHES_PER_FRONT * fronts:
        fail(f"K1 launched {launches} times on the main path, expected "
             f"{LAUNCHES_PER_FRONT} x {fronts} fronts")
    bpp, quality = [], []
    for i, (s, r) in enumerate(zip(streams, recons)):
        if not np.array_equal(native.decode_stream(s), r):
            fail(f"stream {i} does not decode to its recon")
        h, w = imgs[i].shape
        quality.append(psnr(r[:h, :w], imgs[i]))
        bpp.append(8 * len(s) / (h * w))
    pixels = sum(im.size for im in imgs)
    emit({"phase": "slice", "card": card, "images": len(imgs),
          "shapes": shapes,
          "qpd6": QPD6, "batch": BATCH, "fronts": fronts,
          "k1_launches": launches, "wall_s": wall,
          "mp_per_s": pixels / wall / 1e6,
          "phases_s": dict(timer.totals),
          "grad_energy": {str(s): g for s, g in grads.items()},
          "psnr_db_mean": float(np.mean(quality)),
          "psnr_db_min": float(np.min(quality)),
          "bpp_mean": float(np.mean(bpp)), "decoded": len(streams),
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30})
    return launches


# ----------------------------------------------------------------- profile

def phase_profile(torch, dev, rng):
    """torch.profiler over two front steps at the main path's lanes (a
    768x512 batch of 18): wall time, the card's busy time and K1's part."""
    from hevce_tpu_torch.models import wavefront as wf

    B, R, C = BATCH, 16, 24
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
                wf.front_core(QPD6, R, (12, 4), W, PME, O, d, C, cv, sv)

    def timed_steps():
        t0 = time.perf_counter()
        steps()
        torch.cuda.synchronize()
        wall.append(time.perf_counter() - t0)

    steps()
    torch.cuda.synchronize()
    wall = []                  # timed inside the profiled region, so it
    ks = card_kernels(torch, timed_steps)     # leaves out the post-processing
    busy_us = sum(us for _, us, _ in ks)
    k1_us = sum(us for k, us, _ in ks if "k1_kernel" in k)
    top = sorted(ks, key=lambda k: -k[1])[:6]
    emit({"phase": "profile", "front_steps": 2, "lanes": B * R,
          "wall_ms_per_step": 1e3 * wall[0] / 2,
          "card_busy_ms_per_step": busy_us / 1e3 / 2,
          "card_busy_share": busy_us / 1e6 / wall[0],
          "k1_ms_per_step": k1_us / 1e3 / 2,
          "kernels_per_step": sum(n for _, _, n in ks) / 2,
          "top_kernels": [{"name": k[:60], "ms_per_step": us / 1e3 / 2,
                           "launches_per_step": n / 2}
                          for k, us, n in top]})


# ---------------------------------------------------------------- identity

def phase_identity(dev):
    from hevce_tpu_torch.models import wavefront as wf
    from hevce_tpu_torch.utils.tracing import PhaseTimer

    rng = np.random.default_rng(5)
    noise = rng.integers(0, 256, (64, 96)).astype(np.uint8)
    yy, xx = np.mgrid[0:64, 0:96]
    smooth = ((yy * 2 + xx) % 256).astype(np.uint8)
    odd = rng.integers(0, 256, (50, 70)).astype(np.uint8)
    compared = 0
    for qpd6 in (0, 2, 4):
        for group in ([noise, smooth], [odd]):
            prices = wf._predict_prices(group, qpd6)
            bufs = []
            for d in (dev, "cpu"):
                out, meta = wf._dispatch_batch(group, qpd6, prices=prices,
                                               device=d)
                wf._fetch_lean(out, meta, PhaseTimer())   # checksum tail
                bufs.append(out.numpy().tobytes())
            if bufs[0] != bufs[1]:
                fail(f"card and CPU records differ at qpd6={qpd6}, "
                     f"shape {group[0].shape}")
            compared += 1
    emit({"phase": "identity", "buffers_compared": compared,
          "byte_identical": True})


# -------------------------------------------------------------------- main

def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the synthetic images and kernel inputs")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if not (ROOT / "hevce_tpu_torch").is_dir():
        print("chip_smoke: run from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(args.seed)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]

    phase_build()
    max_err, shapes = phase_kernels(torch, dev, rng)
    launches = phase_slice(torch, dev, rng, card)
    phase_profile(torch, dev, rng)
    phase_identity(dev)

    print(card, flush=True)

    per_front = lambda key, keep=lambda s: True: sum(
        s["per_front"] * s[key] for s in shapes if keep(s))
    t_bound = per_front("bound_ms")
    by_ops = per_front("bound_ms", lambda s: s["bound_by"] == "operations")
    emit({"kernels": [{
        "name": "fused_eval", "route": "cuda",
        "source": "hevce_tpu_torch/csrc/fused_eval.cu",
        "replaces": "hevce_tpu/ops/fused_eval.py:255",
        "launches": launches, "max_abs_err": max_err,
        "ms": per_front("ms"), "plain_ms": per_front("plain_ms"),
        "bound_ms": t_bound,
        "bound_by": "operations" if by_ops * 2 > t_bound else "bytes",
        "library_ms": None, "call_ms": per_front("call_ms"),
        "basis": f"card time of one front step of a 768x512 batch of "
                 f"{BATCH} ({LAUNCHES_PER_FRONT} launches, {LANES} lanes); "
                 f"call_ms includes the host's enqueue"}]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
