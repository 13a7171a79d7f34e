#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (hevce_tpu_torch) on one NVIDIA GPU.

Phases, each printed as one JSON line:

  build     compile the native host library (g++), kernels K1 and K2, the
            probe kernels P1-P3 and the fused node kernels X1-X4 (nvcc)
            from the sources in this checkout, all at once; seconds for
            each, ptxas's report
            (registers and spills of every instantiation), and the IMMA
            (int8 tensor-core) instructions in each kernel's SASS (P2, P3
            and K1's sz 8, 16 and 32 instantiations must have some).
  probes    (run second, on a generator of its own, so the phases below
            see the inputs they saw without it) the probe tool as a user
            runs it (tools/cuda_probe: P1's us per launch eager and as a
            CUDA graph, P2 and P3 EXACT, P3's us per eval beside K1's);
            every probe kernel must launch there, and none on the encode
            paths below. Then P1-P3 against their plain versions on the
            card (tolerance 0; P1 also at one element; P2 also at extreme
            and ragged operands, K not a multiple of 16 among them; P3 at
            512, 480 and the ragged 1, 17 and 511 rows x qpd6 0-4, and
            against K1 at (4, 35)), and each probe's card, call, plain and
            library (x.add_(1), torch._int_mm) times beside its bound; P1
            also at one element (the card's least kernel), P3 also at 480
            rows; P2 also at (4096, 4096, 4096) beside torch._int_mm (from
            the tool).
  kernels   K1 against its plain PyTorch version on the card for the 11
            production (sz, M) shapes x qpd6 0-4 at 288 lanes (the main
            path's lane count for a 768x512 batch of 18): q, recon and sse
            must be equal (tolerance 0). Then per-shape card times of K1
            and of the plain version (torch.profiler), K1's time per call
            with the host's enqueue (CUDA events), and the least time the
            card could take, two ways: bound_ms with the transforms as
            int32 multiply-adds, tc_bound_ms with them as int8 tensor-core
            digit products beside the int32 epilogue.
            K1 again at the lockstep path's calls: 18 rows of 35 candidates
            at sz 4 / 8 / 16 / 32 x qpd6 0-4, the inputs taken from
            eval_2nx2n and the dense eval_tusplit on real requests (K1's
            last block of candidates is partial at sz 4 and 8); tolerance
            0, and the same times for each size.
            K2 against its plain version at the lockstep path's four shapes
            (PU events: 630 lanes, cap 256, a 39-slot palette; node events
            at sz 8 / 16 / 32: 1260 lanes, caps 768 / 2048 / 7168, 69 / 67 /
            59 slots), on the op strings of real candidate blocks, random
            strings and adversarial ones (0xFF / carry / 0x00 runs): the 7
            coder scalars and the palette must be equal (tolerance 0). Then
            per shape the card time of the wrapper's call (profiler; K2 and
            its stack of the scalars) and of the kernel alone, ns per op of
            the longest lane, the call time (CUDA events), the plain
            version's call time and the bound. Inputs, checks and times
            come from the K2 tool (tools/bench_k2).
  slice     the main path, as a user calls it: encode_many_fast on 18
            synthetic 768x512 and 6 synthetic 512x768 images (qpd6=2,
            batch=18, RMD (12, 4), 'pre' prices, lean records, host pack).
            Each batch runs through its shape's slice runner, whose front
            step is a CUDA graph replayed per front. A first run builds the
            two shapes' runners (an eager warm-up step and a capture each);
            the second is timed. K1 must launch exactly 169 times per front
            step (and per warm-up step), X1 148, X2 21, X3 106 and X4 85
            times,
            and every stream must decode, through the independent native
            decoder, to the recon returned with it.
  xnode     the fused node kernels X1-X4 (ops/fused_node, csrc/
            fused_node.cu: X1 intra prediction with its borders, X2 the RMD
            preselection, X3 candidate rate and RD cost, X4 a node's or NxN
            PU's pick; they stand for XLA's fusions of the JAX front step)
            against their plain versions on the card, tolerance 0 (X4's
            slots, canvas and total written in place too, each side on its
            own copies): at every call of a real RMD and a real dense front
            step (288 lanes, front 30 of the slice phase's 768x512 batch,
            qpd6 0-4; the calls per step counted), at the lockstep path's
            18-row and the spec path's one-row calls (X1, qpd6 0-4), and in
            adversarial cases (every flag combination, flat and 0 / 255
            borders, SATD ties across the K-th place, all-zero blocks,
            levels at K1's int16 extremes, SSEs at the RD cost's saturation
            edges, X4's costs tied at the minimum and at I32_MAX and totals
            at the saturation edge). Per kernel the card
            ms, call ms and plain ms of one RMD and one dense front step's
            calls (X1 also per lockstep and spec CTU) beside the bound.
  lockstep  the bit-exact lockstep engine, as a user calls it:
            encode_batch on 18 synthetic 64x96 images (6 CTUs each,
            qpd6=2), with node_rates off, on, and off with pipeline=True
            (two halves of 9). Every event replays its program (a CUDA
            graph per node / PU / winner-gather shape and slot): a first
            pass of one CTU an image through each run builds them (warm-up
            step, capture, instantiate). Every stream must equal the native
            engine's for the same image byte for byte and decode to its
            recon; K1 must launch 5 times per node event and once per PU
            event, K2 once per PU event (and once per node event with
            node_rates), plus the warm-up steps of any program built in the
            run. Per program key: warm-up, capture and instantiate seconds,
            graph nodes, pool GiB. Per event kind at B=18: the replay on
            the inputs of the program's last event against its plain step
            on the same inputs (equal, tolerance 0), ms per call of each.
            Then torch.profiler over one CTU per image (node rates on):
            wall, card busy time, K1's and K2's part.
  profile   torch.profiler over two front steps at the main path's lanes:
            wall time, the card's busy time and K1's part of it; then the
            same for two dense (rmd=None) front steps. Each window's K1
            count is held to the wrapper counter's delta (169 / 153 a step;
            utils/timing.card_kernels): a window that lost launches is run
            again, and one that lost them every time is reported with
            "complete": false, never used as whole; lost_sessions says how
            many ran again (so does the lockstep phase's one-CTU profile).
  identity  3 small images at qpd6 0, 2 and 4, run on the card and on the
            CPU: the lean record buffers must be byte-identical.
  dense     the dense fast mode (rmd=None: every node searches all 35 modes
            in both TU layouts) as a user calls it: encode_batch_fast on the
            slice phase's 18 synthetic 768x512 images (qpd6=2, one batch,
            288 lanes). K1 must launch exactly 153 times per front step,
            every stream must decode to its recon, and the identity phase's
            images must give byte-identical records on the card and the CPU
            on this path too. K1 against its plain version (tolerance 0) at
            the 153 calls of one dense front step at 288 lanes, its inputs
            taken at the wrapper. Wall s, ms per front step, K1's card ms
            per front step (from the kernels phase's (sz, 35) rows) and its
            bound.
  graph     the slice runner's CUDA graphs against the eager front step:
            on the identity phase's images at qpd6 0, 2 and 4, graph
            replays (_dispatch_batch) and the eager run_slice on the card
            must give byte-identical lean records (both shapes), full
            records with the recon, and dense records. Then the capture
            cost of the main path's three runners (the RMD keys of both
            shapes, the dense key; eager warm-up step, capture with
            instantiate, graph nodes, pool memory; a step of more than
            10,845 graph nodes fails, and each key's K1 and X1-X4 launches
            a replay are held to the step's) and, at the main path's
            288 lanes, per front step: the replay ms (CUDA events over a
            whole slice of replays), the eager step's wall ms on the same
            buffers, and a profiled pair of replayed steps (card busy share,
            complete, lost sessions); RMD and dense, the peak memory and
            the slice phase's MP/s.
  surface   the rest of the fast mode's surface, on the card: fetch_qc=True
            (full records: quant levels, int16 escape sideband, device
            recon) on the slice phase's 18 768x512 images must give the
            slice phase's streams and recons byte for byte, and a noise
            image at qpd6=0 must take the escape sideband and still equal
            the lean stream; HEVCE_ADAPT=post on the 24 images must flag at
            least one image (and says how many it kept) with every stream
            decoding to its recon; encode_many_exact on 2 of the images must
            give native.encode_image_native's streams byte for byte
            (host_rdo seconds printed). K1 launch counts on each path.
  spec      the Python spec encoder (models/encoder.encode_image) on the
            card, as a user calls it: the golden 32x32 images at qpd6 0-4
            and the golden 128x128 image at qpd6 2 (21 CTUs; cut in depth
            only: its Python trial encodes cost seconds a CTU). Every
            stream and recon must equal the golden one and the native
            engine's; K1 must launch 169 times a CTU, every call one row of
            35 candidates. K1 against its plain version (tolerance 0) at
            this path's own calls (each eval's inputs taken on the 32x32
            images and run through its plain function, K1's calls taken at
            the wrapper; each (sz, 35) at qpd6 0-4). Every eval replays its
            program (one per (fn, sz, qpd6)); K1's count adds each program's
            warm-up step, and each program's capture cost is printed. The
            wall per CTU, split into the device eval (load, replay, copy
            back) and the host's trials, and K1's card ms per CTU at one
            row beside its bound.
  cli       python -m hevce_tpu_torch in a subprocess on a PGM written from
            a golden image: the native and python engines must write the
            golden stream and recon PGM, --fast a stream that decodes to
            its recon.
  mesh      the entry surface (hevce_tpu_torch/entry): entry() on the card
            must equal the same step on the CPU; the device step at sz 8
            and 32 split over the mesh (cuda:0, cuda:0) must equal the
            unsplit step, each part replaying the rates-off node program of
            its slot (device_step s a call, split and unsplit);
            dryrun_multichip(2) on the one card: the lockstep mesh encode
            bit-exact against the native engine, the fast-mode mesh encode
            decode-verified. K1 and K2 launch counts there.

On the fast paths every K1 and X1-X4 count adds one step for each slice
runner the run builds (its eager warm-up step on the card;
runners_built()), and on the lockstep, spec and mesh paths one step for
each event program built (programs_built(), warmup_launches()); there X1
launches once before each K1 launch, and X2-X4 never.

Then the seconds each phase took, how many profiler sessions recorded no
kernel or lost launches (run again), and how many card times came from
CUDA events instead (both 0 when the profiler worked throughout,
utils/timing.card_kernels and card_ms; the reasons of the first 20 reruns),
the card's name and power limit (nvidia-smi), the kernels line and, as the
last line, {"ok": true, "device": {...}}. Any failure exits non-zero.
Without CUDA, or outside a checkout of the repository, it exits non-zero
and prints no result.

Usage: python3 chip_smoke.py [--seed N]
"""
import argparse
import contextlib
import functools
import inspect
import io
import json
import math
import os
import pathlib
import subprocess
import sys
import threading
import time

import numpy as np

# the lockstep path's batch, qpd6 and K2 launches per CTU (PU_PER_CTU, and
# NODE_PER_CTU by CU size), shared with the K2 tool; the slice phase runs
# at the same batch and qpd6. The card's peak rates for the bounds.
from hevce_tpu_torch.tools.bench_k2 import (BATCH, NODE_PER_CTU, PU_PER_CTU,
                                            QPD6)
from hevce_tpu_torch.utils.device import HBM_BYTES_PER_S, INT32_OPS_PER_S

ROOT = pathlib.Path(__file__).resolve().parent
LANES = 288                      # B * R for a 768x512 batch of 18 images
SHAPES = [(4, 35), (4, 4), (8, 4), (8, 12), (16, 4), (16, 12),
          (32, 4), (32, 12), (8, 35), (16, 35), (32, 35)]
# K1 launches per front step by (sz, M): 16 leaves x (8x8 2Nx2N on K=12,
# four 4x4 TU-split subs on T=4, four 4x4 NxN PUs on 35 modes), 4 quadrants
# x (16x16 2Nx2N + four 8x8 subs), the root (32x32 2Nx2N + four 16x16 subs)
PER_FRONT = {(8, 12): 16, (4, 4): 64, (4, 35): 64, (16, 12): 4, (8, 4): 16,
             (32, 12): 1, (16, 4): 4}
LAUNCHES_PER_FRONT = sum(PER_FRONT.values())            # 169
# K1 launches per front step of the dense path (rmd=None), all at 35
# candidates: 16 leaves x (8x8 2Nx2N, four 4x4 TU-split subs, NxN PUs 1-3:
# PU0 is the TU-split's sub0), 4 quadrants x (16x16 2Nx2N + four 8x8 subs),
# the root (32x32 2Nx2N + four 16x16 subs)
DENSE_PER_FRONT = {(4, 35): 16 * 7, (8, 35): 16 + 4 * 4, (16, 35): 4 + 4,
                   (32, 35): 1}
DENSE_LAUNCHES_PER_FRONT = sum(DENSE_PER_FRONT.values())  # 153
# the surface phase's cuts, to keep the script's wall: HEVCE_ADAPT=post on
# the 18 768x512 images cut to 512x384 (all rows, so 288 lanes; 42 front
# steps a pass), encode_many_exact on 2 of them cut to 256x384
POST_SHAPE = (512, 384)
EXACT_SHAPE = (256, 384)
# the lockstep path: a batch of 18 images 64x96 (6 CTUs)
LOCK_SHAPE = (64, 96)
# K1 launches per CTU there, all at (sz, 35) and 18 rows: a PU event's
# 2Nx2N, a node event's 2Nx2N and its four sub-TUs at sz / 2
K1_PER_CTU = {4: 128, 8: 32, 16: 8, 32: 1}


def emit(obj):
    print(json.dumps(obj), flush=True)


def runners_built():
    """slice runners built so far in this process: each ran one eager
    warm-up step on the card before its capture."""
    from hevce_tpu_torch.models import wavefront as wf

    return wf._slice_runner_cache.cache_info().currsize


# K1 and K2 launches of one step of each kind of event program (utils/
# graphs): every program built runs one eager warm-up step on the card
# before its capture, and every replay counts these again
PROGRAM_LAUNCHES = {"node": (5, 0), "node_rates": (5, 1), "pu": (1, 1),
                    "gather": (0, 0), "eval_2nx2n": (1, 0),
                    "eval_tusplit": (4, 0)}


def programs_built(since=0):
    """{kind: event programs} captured since utils/graphs.CAPTURED[since]
    (the slice runners' front steps are runners_built()'s)."""
    from hevce_tpu_torch.utils import graphs

    built = graphs.built(since)
    built.pop("front", None)
    return built


def captured():
    """how many steps this process has captured so far: the `since` of
    programs_built and warmup_launches."""
    from hevce_tpu_torch.utils import graphs

    return len(graphs.CAPTURED)


def warmup_launches(since):
    """(K1, K2) launches of the warm-up steps of the programs built since
    `since`; fails unless every one's replays count the launches its kind
    makes (PROGRAM_LAUNCHES, and an X1 launch before each K1 launch, no
    X2-X4: the event programs run cu_eval's evaluations, not the fast
    mode's node functions)."""
    from hevce_tpu_torch.utils import graphs

    for s in graphs.CAPTURED[since:]:
        if s.kind != "front" and (
                (s.launches["k1"], s.launches["k2"]) !=
                PROGRAM_LAUNCHES[s.kind] or
                (s.launches["x1"], s.launches["x2"], s.launches["x3"],
                 s.launches["x4"]) != (s.launches["k1"], 0, 0, 0)):
            fail(f"a {s.kind} program counts {s.launches} launches a "
                 f"replay, expected {PROGRAM_LAUNCHES[s.kind]} and as "
                 f"many X1 as K1")
    built = programs_built(since)
    return tuple(sum(n * PROGRAM_LAUNCHES[k][i] for k, n in built.items())
                 for i in (0, 1))


def x_only_x1(where):
    """fails unless, since reset_launches(), X1 launched once for each K1
    launch and X2-X4 never (the lockstep and spec paths evaluate
    candidates through cu_eval only)."""
    got = port_launches()
    if (got["x1"], got["x2"], got["x3"], got["x4"]) != (got["k1"], 0, 0, 0):
        fail(f"{where}: launches {got}, expected X1 = K1 and no X2-X4")


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


# ------------------------------------------------------------------- build

def phase_build():
    from hevce_tpu_torch.ops import cabac_scan, fused_eval, fused_node, probes
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
               (("host", native.build), ("fused_eval", fused_eval.build),
                ("cabac_scan", cabac_scan.build), ("probes", probes.build),
                ("fused_node", fused_node.build))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errs:
        fail("build: " + " | ".join(errs))
    ptxas = [ln.strip() for k in ("fused_eval", "cabac_scan", "probes",
                                  "fused_node")
             for ln in res[k][1].splitlines()
             if any(w in ln for w in ("registers", "spill", "Compiling entry"))]
    # P2, P3 and K1's transform stages at sz >= 8 must issue int8
    # tensor-core instructions (IMMA in the SASS)
    imma = probes.imma_counts(probes.build()[0])
    for kern in ("p2_int8_mm", "p3_fused4"):
        if not any(kern in fn and n > 0 for fn, n in imma.items()):
            fail(f"build: {kern} has no IMMA instruction in its SASS: {imma}")
    k1_imma = fused_eval.imma_by_size(
        probes.imma_counts(fused_eval.build()[0]))
    if not all(k1_imma[sz] for sz in (8, 16, 32)):
        fail(f"build: K1 at sz 8 / 16 / 32 needs IMMA instructions in its "
             f"SASS: {k1_imma}")
    emit({"phase": "build", "host_lib_s": res["host"][0],
          "fused_eval_s": res["fused_eval"][0],
          "cabac_scan_s": res["cabac_scan"][0], "probes_s": res["probes"][0],
          "fused_node_s": res["fused_node"][0],
          "ptxas": ptxas, "imma": imma, "k1_imma_by_sz": k1_imma})


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


def k1_tc_bound(sz, M, lanes):
    """(bound ms, bound_by) of one K1 call with its transforms as int8
    tensor-core products: the base-128 digit products of the four stages,
    the int32 epilogue and the bytes, whichever is largest."""
    n = lanes * M
    nbytes, _ = k1_cost(sz, M, lanes)
    return bound(nbytes, [
        (n * K1_DIGIT_PRODUCTS * sz ** 3 * 2, INT8_TC_OPS_PER_S),
        (n * sz * sz * K1_INT32_OPS_PER_COEF, INT32_OPS_PER_S)])


def k1_compare(torch, sz, qpd6, pred, blk, where):
    """K1 against its plain version on the same inputs, tolerance 0: fails
    on any difference, else returns the largest |error| (0)."""
    from hevce_tpu_torch.ops import fused_eval

    got = fused_eval.pipeline_sse(sz, qpd6, pred, blk)
    torch.cuda.synchronize()
    want = fused_eval.pipeline_sse_plain(sz, qpd6, pred, blk)
    M, rows = pred.shape[-3], pred.numel() // (pred.shape[-3] * sz * sz)
    worst = 0
    for name, g, w in zip(("q", "recon", "sse"), got, want):
        if g.dtype != w.dtype or g.shape != w.shape:
            fail(f"K1 {name} {where} sz={sz} M={M} rows={rows} qpd6={qpd6}:"
                 f" {g.dtype}{tuple(g.shape)} vs {w.dtype}{tuple(w.shape)}")
        err = int((g.to(torch.int64) - w.to(torch.int64)).abs().max())
        if err:
            fail(f"K1 {name} differs from the plain version {where} at "
                 f"sz={sz} M={M} rows={rows} qpd6={qpd6}: max |err| {err}")
        worst = max(worst, err)
    return worst


def k1_times(torch, sz, M, rows, pred, blk):
    """card ms (profiler), call ms (CUDA events), the plain version's card
    ms and the bound of one K1 call at qpd6=QPD6."""
    from hevce_tpu_torch.ops import fused_eval
    from hevce_tpu_torch.utils import timing

    k1 = lambda: fused_eval.pipeline_sse(sz, QPD6, pred, blk)
    plain = lambda: fused_eval.pipeline_sse_plain(sz, QPD6, pred, blk)
    call_ms = timing.cuda_ms(k1, 50)
    ms, plain_ms = timing.card_ms(k1, 20), timing.card_ms(plain, 5)
    nbytes, ops = k1_cost(sz, M, rows)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S
    tc_ms, tc_by = k1_tc_bound(sz, M, rows)
    return {"sz": sz, "M": M, "lanes": rows, "ms": ms, "plain_ms": plain_ms,
            "call_ms": call_ms, "bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes > t_ops else "operations",
            "tc_bound_ms": tc_ms, "tc_bound_by": tc_by}


def phase_kernels(torch, dev, rng):
    max_err, checked = 0, 0
    for qpd6 in range(5):
        for sz, M in SHAPES:
            pred, blk = k1_inputs(torch, dev, rng, sz, M, LANES)
            max_err = max(max_err, k1_compare(torch, sz, qpd6, pred, blk,
                                              "at 288 lanes"))
            checked += 1
    shapes = []
    for sz, M in SHAPES:
        pred, blk = k1_inputs(torch, dev, rng, sz, M, LANES)
        shapes.append(dict(k1_times(torch, sz, M, LANES, pred, blk),
                           per_front=PER_FRONT.get((sz, M), 0)))

    # the lockstep path's calls: 18 rows of 35 candidates (630: K1's last
    # block of candidates is partial at sz 4 and 8), on real requests and
    # K1's own recons feeding the next sub-TU
    lock_checked, lock_shapes = 0, {}
    for qpd6 in range(5):
        for sz, pred, blk in k1_lockstep_calls(torch, dev, rng, qpd6):
            if tuple(pred.shape) != (BATCH, 35, sz, sz):
                fail(f"K1 lockstep call at sz={sz}: pred {tuple(pred.shape)}"
                     f", expected ({BATCH}, 35, {sz}, {sz})")
            max_err = max(max_err, k1_compare(torch, sz, qpd6, pred, blk,
                                              "on lockstep requests"))
            lock_checked += 1
            if qpd6 == QPD6:
                lock_shapes.setdefault(sz, (pred, blk))
    lock = [dict(k1_times(torch, sz, 35, BATCH, pred, blk),
                 per_ctu=K1_PER_CTU[sz])
            for sz, (pred, blk) in sorted(lock_shapes.items())]
    emit({"phase": "kernels", "kernel": "fused_eval",
          "checked": checked, "lockstep_checked": lock_checked,
          "exact": True, "max_abs_err": max_err, "library_ms": None,
          "library_note": "no single PyTorch call computes this function",
          "shapes": shapes, "lockstep_shapes": lock})
    return max_err, shapes, lock


# ---------------------------------------------------------------- kernel K2

def k1_lockstep_calls(torch, dev, rng, qpd6):
    """K1's inputs as the lockstep path hands them over at qpd6: for each CU
    size a batch of 18 requests through eval_2nx2n and (sz > 4) the dense
    eval_tusplit, whose four sub-TU calls chain through K1's own recons.
    Returns the [(sz, pred, blk)] of every K1 call, taken at its wrapper."""
    from hevce_tpu_torch.models import cu_eval
    from hevce_tpu_torch.ops import fused_eval
    from hevce_tpu_torch.tools.bench_k2 import lock_requests

    calls, k1 = [], fused_eval.pipeline_sse

    def taken(sz, q, pred, blk):
        calls.append((sz, pred, blk))
        return k1(sz, q, pred, blk)

    fused_eval.pipeline_sse = taken
    try:
        for sz in (4, 8, 16, 32):
            req = lock_requests(dev, rng, sz)
            cu_eval.eval_2nx2n(sz, qpd6, *req)
            if sz > 4:
                cu_eval.eval_tusplit(sz, qpd6, *req)
    finally:
        fused_eval.pipeline_sse = k1
    return calls


def phase_k2(torch, dev, rng):
    """K2 against its plain version at the lockstep path's four shapes on
    real-block, random and adversarial strings (tolerance 0), then per
    shape the card ms of the wrapper's call (torch.profiler; K2 and its
    stack of the scalars) and of K2 alone, ns per op of the longest lane,
    the call ms (CUDA events, the wrapper's enqueue included), the plain
    version's call ms and the bound. The inputs, checks and card times are
    the K2 tool's (python -m hevce_tpu_torch.tools.bench_k2)."""
    from hevce_tpu_torch.ops import cabac_scan
    from hevce_tpu_torch.tools import bench_k2 as bk
    from hevce_tpu_torch.utils import timing

    max_err, checked, shapes = 0, 0, []
    for name, sz, lanes, cap, P, per_ctu in bk.k2_shapes():
        block = bk.k2_block_inputs(dev, rng, sz)
        if tuple(block[1].shape) != (lanes, cap) or \
                block[0]["ctxs"].shape[1] != P:
            fail(f"K2 {name}: path inputs {tuple(block[1].shape)} P="
                 f"{block[0]['ctxs'].shape[1]}, expected ({lanes}, {cap}) "
                 f"P={P}")
        cases = [("blocks", block),
                 ("random", bk.k2_synthetic_inputs(dev, rng, lanes, cap, P,
                                                   False)),
                 ("adversarial", bk.k2_synthetic_inputs(dev, rng, lanes,
                                                        cap, P, True))]
        for case, (state, ops, nops) in cases:
            got = cabac_scan.advance_rates(state, ops, nops, want_ctxs=True)
            torch.cuda.synchronize()
            t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in "01")
            t0.record()
            want = cabac_scan.scan_plain(state, ops, nops)
            t1.record()
            torch.cuda.synchronize()
            if case == "blocks":        # the plain version's call time
                plain_ms = t0.elapsed_time(t1)
            try:
                max_err = max(max_err, bk.compare(got, want,
                                                  f"at {name} ({case})"))
            except bk.Mismatch as e:
                fail(str(e))
            checked += 1
        state, ops, nops = block
        shapes.append(dict(
            bk.shape_row(name, per_ctu, state, ops, nops), cap=cap,
            call_ms=timing.cuda_ms(
                lambda: cabac_scan.advance_rates(state, ops, nops), 50),
            plain_ms=plain_ms))
    emit({"phase": "kernels", "kernel": "cabac_scan", "checked": checked,
          "exact": True, "max_abs_err": max_err, "library_ms": None,
          "library_note": "no single PyTorch call computes a CABAC rate scan",
          "ms_note": "ms is the card time of the wrapper's call (K2 and "
                     "its stack of the scalars), kernel_ms of K2 alone, "
                     "call_ms the call's CUDA-event time (its enqueue "
                     "included)",
          "plain_note": "plain_ms is CUDA-event time of the check's call "
                        "on the real-block strings (its thousands of small "
                        "launches included)",
          "ms_per_ctu": bk.per_ctu_ms(shapes),
          "kernel_ms_per_ctu": bk.per_ctu_ms(shapes, "kernel_ms"),
          "shapes": shapes})
    return max_err, shapes


# ------------------------------------------------------ fused node kernels

# X1-X4 (ops/fused_node, csrc/fused_node.cu): the counterparts of XLA's
# fusions of the JAX package's front step, not ports of Pallas kernels.
# name: (wrapper, plain version, kernel, the JAX function it stands for)
X_KERNELS = {
    "x1": ("predict", "predict_plain", "x1_predict",
           "hevce_tpu/models/cu_eval.py:64"),
    "x2": ("preselect", "preselect_plain", "x2_preselect",
           "hevce_tpu/models/wavefront.py:442"),
    "x3": ("rate_cost", "rate_cost_plain", "x3_rate_cost",
           "hevce_tpu/models/wavefront.py:130"),
    "x4": ("pick", "pick_plain", "x4_pick",
           "hevce_tpu/models/wavefront.py:356"),
}
# the arguments an X kernel writes in place: each side of a comparison gets
# its own copies, compared afterwards as outputs
X_INPLACE = {"x4": ("pm", "quant", "recon", "total")}
X_REPLACES = {
    "x1": "XLA's fusion of intra.build_borders + predict_all_modes "
          "(hevce_tpu/ops/intra.py:32, :261) in cu_eval.eval_2nx2n and of "
          "eval_tusplit's sub-TU borders and _select_pred (cu_eval.py:73, "
          ":84)",
    "x2": "XLA's fusion of _eval_node_rmd's front half (wavefront.py:442): "
          "predict_all_modes, satd.block_satd (hevce_tpu/ops/satd.py:37), "
          "the forced bias, _topk_mask and _compress_u8",
    "x3": "XLA's fusion of _est_rate, _pmode_rate, _lastxy_rate "
          "(wavefront.py:130, :156, :220) and rdcost.calc_rd_cost "
          "(hevce_tpu/ops/rdcost.py:10)",
    "x4": "XLA's fusion of the node functions' picks: jnp.argmin over the "
          "joined costs, the one-hot masked sums of the winner's levels and "
          "recon (wavefront.py:356, :504), and _eval_nxn's per-PU "
          "dynamic_update_slice into the canvas and saturating total "
          "(wavefront.py:568)"}
# launches per front step, by counter: K1; X1 the TU splits' 84 sub-TUs and
# the NxN PUs (RMD: all 64; dense: PUs 1-3, 48, with the 21 nodes' 2Nx2N);
# X2 one per RMD node; X3 two per node and one per NxN PU; X4 (the pick)
# one per node and per NxN PU
FRONT_LAUNCHES = {"k1": LAUNCHES_PER_FRONT, "x1": 148, "x2": 21, "x3": 106,
                  "x4": 85}
DENSE_FRONT_LAUNCHES = {"k1": DENSE_LAUNCHES_PER_FRONT, "x1": 153, "x2": 0,
                        "x3": 106, "x4": 85}
# X1 calls per CTU of the lockstep and spec paths, by (block size, sub-TU):
# a PU event's 4x4 2Nx2N, a node event's 2Nx2N and its four sub-TUs (169,
# one before each K1 launch)
X1_PER_CTU = {(4, False): 64, (8, False): 16, (8, True): 64, (16, False): 4,
              (16, True): 16, (32, False): 1, (32, True): 4}
# their arithmetic, for the bounds (int32 operations on the kernels' own
# formulation): a predicted pixel two multiply-adds, the rounding add and
# the shift (6); X2 per mode and pixel also the residual, 2 log2(sz)
# butterfly adds, |.| and the sum, and 35 x 35 rank comparisons a row; X3
# per level |q|, the rate's select and its sum, the significance test, the
# scan-index max and the CG bit (8), and ~40 a candidate
X_OPS_PER_PX = 6
X3_OPS_PER_COEF = 8
# graph nodes a captured front step may hold: a quarter of the 43,381 of the
# RMD step before X1-X3 (its eager chains' small kernels)
MAX_NODES_PER_STEP = 43381 // 4


def port_launches():
    """every port kernel's launch count (utils/graphs.COUNTERS)."""
    from hevce_tpu_torch.utils import graphs

    return {k: m.LAUNCHES for k, m in graphs.COUNTERS.items()}


def reset_launches():
    from hevce_tpu_torch.utils import graphs

    for m in graphs.COUNTERS.values():
        m.LAUNCHES = 0


def check_fronts(where, per_step, steps):
    """fails unless K1 and X1-X4 launched per_step times each of `steps`
    front steps since reset_launches(). Returns the counts."""
    got = port_launches()
    got = {k: got[k] for k in per_step}
    want = {k: n * steps for k, n in per_step.items()}
    if got != want:
        fail(f"{where}: launches {got}, expected {want} ({steps} front "
             f"steps, warm-up steps included, of {per_step})")
    return got


def front_inputs(torch, dev, imgs, d=30):
    """front d of the batch's 768x512 grid at 288 lanes: (R, C, d, W, PME,
    the originals of front d, ctx and sig prices), its three-column window
    and originals cut from the images themselves."""
    from hevce_tpu_torch.models import wavefront as wf

    yp, xp = imgs[0].shape
    R, C = yp // 32, xp // 32
    O = torch.from_numpy(wf._orig_tiles_raster(imgs, yp, xp)).to(dev)
    rr = torch.arange(R, device=dev)
    tiles = lambda back: O[:, rr, (d - back - 2 * rr).clamp(0, C - 1)]
    W = torch.stack([tiles(3), tiles(2), tiles(1)], 2)
    PME = torch.full((len(imgs), R, 8), wf.DC, dtype=torch.int32, device=dev)
    cv = torch.full((len(imgs) * R,), wf.CTX_BIT, dtype=torch.int32,
                    device=dev)
    return R, C, d, W, PME, tiles(0), cv, torch.full_like(cv, wf.SIG_ZERO)


def x_calls(torch, run):
    """every call of the fused node wrappers that run() makes, its tensors
    copied with their strides: {"x1": [(args, kwargs)], ...}."""
    from hevce_tpu_torch.ops import fused_node

    def keep(a):
        if not isinstance(a, torch.Tensor):
            return a
        return torch.empty_strided(a.shape, a.stride(), dtype=a.dtype,
                                   device=a.device).copy_(a)

    calls = {x: [] for x in X_KERNELS}
    real = {x: getattr(fused_node, w) for x, (w, _, _, _) in
            X_KERNELS.items()}

    def taker(x):
        def call(*a, **kw):
            calls[x].append(([keep(v) for v in a],
                             {k: keep(v) for k, v in kw.items()}))
            return real[x](*a, **kw)
        return call

    for x, (w, _, _, _) in X_KERNELS.items():
        setattr(fused_node, w, taker(x))
    try:
        with torch.no_grad():
            run()
    finally:
        for x, (w, _, _, _) in X_KERNELS.items():
            setattr(fused_node, w, real[x])
    return calls


def x_twins(torch, x, kw):
    """the keyword arguments of both sides of a comparison of X kernel x:
    each argument it writes in place (X_INPLACE) as the same view of a
    buffer of each side's own that spans the view, the elements between
    the view's set to one pattern on both sides, so that a write outside
    the view shows too. Returns (the kernel's kw, the plain version's kw,
    [(kernel's buffer, plain version's buffer)])."""
    sides, bufs = ({}, {}), []
    for k, v in kw.items():
        if k not in X_INPLACE.get(x, ()) or v is None:
            sides[0][k] = sides[1][k] = v
            continue
        n = 1 + sum((d - 1) * s for d, s in zip(v.shape, v.stride()))
        pair = []
        for side in sides:
            buf = (torch.arange(n, device=v.device) * 7919 % 251).to(v.dtype)
            side[k] = buf.as_strided(v.shape, v.stride()).copy_(v)
            pair.append(buf)
        bufs.append(tuple(pair))
    return sides[0], sides[1], bufs


def x_compare(torch, x, args, kw, where):
    """X kernel x on one call's inputs against its plain version on the same
    inputs (on the card), tolerance 0, what it writes in place included
    (x_twins): fails on any difference, else returns the largest |error|
    (0)."""
    from hevce_tpu_torch.ops import fused_node

    w, p, _, _ = X_KERNELS[x]
    kw_k, kw_p, bufs = x_twins(torch, x, kw)
    got = getattr(fused_node, w)(*args, **kw_k)
    torch.cuda.synchronize()
    want = getattr(fused_node, p)(*args, **kw_p)
    got = (got if isinstance(got, tuple) else (got,)) + tuple(
        b for b, _ in bufs)
    want = (want if isinstance(want, tuple) else (want,)) + tuple(
        b for _, b in bufs)
    worst = 0
    for g, v in zip(got, want):
        if g.dtype != v.dtype or g.shape != v.shape:
            fail(f"{x} {where}: {g.dtype}{tuple(g.shape)} vs "
                 f"{v.dtype}{tuple(v.shape)}")
        err = int((g.to(torch.int64) - v.to(torch.int64)).abs().max()) \
            if g.numel() else 0
        if err:
            fail(f"{x} differs from its plain version {where}: max |err| "
                 f"{err}; shapes {[tuple(getattr(a, 'shape', ())) for a in args]}"
                 f" {kw}")
        worst = max(worst, err)
    return worst


def x_border_reads(n, isub, flags):
    """(context samples over all rows, canvas bytes a lane, flag bytes a
    row) that the borders of an n x n block read: each piece only where its
    flag lets it through (a masked half is substituted, never read). isub
    None: the node's own borders from its context; 0-3: sub-TU isub of the
    TU split, whose flags follow the reference's sub-block tables and whose
    pieces past the context lie in each lane's canvas."""
    g = flags.reshape(-1, 4).long().cpu()
    bll, blb, baa, bar = g.unbind(1)
    if isub is None or isub == 0:
        if isub == 0:
            blb, bar = bll, baa
        ctx = (bll & baa) + n * (bll + blb + baa + bar)
        return int(ctx.sum()), 0, 2 if isub == 0 else 4
    if isub == 1:             # left from the canvas, bll = 1, blb = 0
        return int((baa + n * (baa + bar)).sum()), n, 2
    if isub == 2:             # top from the canvas, baa = bar = 1
        return int((bll + n * (bll + blb)).sum()), 2 * n, 2
    return 0, 2 * n + 1, 0    # all from the canvas, the flags fixed


def x_cost(x, args, kw):
    """(bytes, int32 ops) one call of X kernel x must move and do: each
    input read once where the call's data needs it (borders only where
    their flags let them through, a sub-TU's canvas only where its borders
    lie, modes only where given), each output written once."""
    if x == "x1":
        sz, top, left, flags = args[:4]
        modes = args[4] if len(args) > 4 else kw.get("modes")
        isub = args[6] if len(args) > 6 else kw.get("isub")
        rows = top.numel() // top.shape[-1]
        n = sz if isub is None else sz // 2
        M = 35 if modes is None else modes.shape[-1]
        ctx, canvas, fl = x_border_reads(n, isub, flags)
        nbytes = ctx * top.element_size() + fl * rows + canvas * rows * M \
            + (0 if modes is None else 4 * rows * M) + rows * M * n * n
        return nbytes, rows * M * n * n * X_OPS_PER_PX
    if x == "x4":
        from hevce_tpu_torch.ops import fused_node

        a = inspect.signature(fused_node.pick_plain).bind(*args, **kw)
        a.apply_defaults()
        a = a.arguments
        rows, M = a["cost1"].shape
        M += 0 if a["cost2"] is None else a["cost2"].shape[1]
        nn = math.prod(a["q1"].shape[2:])
        # every cost read; the winner's levels and recon read and written,
        # its mode read where a map gives it; cost, lay and pm written; the
        # running total read and written
        nbytes = rows * (4 * M + 6 * nn + 12 + 4 * (a["modes1"] is not None)
                         + 8 * (a["total"] is not None))
        return nbytes, rows * (2 * M + 2 * (a["total"] is not None))
    if x == "x2":
        sz, top, left, flags, blk, _, _, K = args
        rows, nn, K = blk.shape[0], sz * sz, min(K, 35)
        ctx, _, fl = x_border_reads(sz, None, flags)
        nbytes = (ctx * top.element_size() + fl * rows + rows * nn
                  + 8 * rows + rows * K * nn + 4 * rows * K)
        per_px = X_OPS_PER_PX + 3 + 2 * (sz.bit_length() - 1)
        return nbytes, rows * (35 * nn * per_px + 35 * 35)
    q = args[2]
    modes = args[9] if len(args) > 9 else kw.get("modes")
    cands = q.shape[0] * q.shape[1]
    # levels; sse, cost and (where given) modes a candidate; ctxv, sigv,
    # pml and pma a row
    nbytes = 2 * q.numel() + 4 * cands * (2 if modes is None else 3) \
        + 16 * q.shape[0]
    return nbytes, q.numel() * X3_OPS_PER_COEF + 40 * cands


def x_times(torch, x, calls, weights=None):
    """card ms (CUDA events behind a spin kernel: the calls' kernels back to
    back, the host's enqueue hidden), call ms (CUDA events, the enqueue
    included) and plain ms (the plain version on the card, profiler) of the
    calls given, each `weights[i]` times, and the bound of the same work.
    (Profiler sessions over these eager calls lost 7 X launches each,
    whatever their pad, so the card time does not come from them; the
    graph phase's profiled replays give each X kernel's time a step.)"""
    from hevce_tpu_torch.ops import fused_node
    from hevce_tpu_torch.utils import timing

    w, p, _, _ = X_KERNELS[x]
    weights = weights or [1] * len(calls)
    kern, plain = getattr(fused_node, w), getattr(fused_node, p)
    run = lambda f: [f(*a, **kw) for (a, kw), n in zip(calls, weights)
                     for _ in range(n)]
    nbytes = ops = 0
    for (a, kw), n in zip(calls, weights):
        b, o = x_cost(x, a, kw)
        nbytes, ops = nbytes + n * b, ops + n * o
    b_ms, by = bound(nbytes, [(ops, INT32_OPS_PER_S)])
    return {"ms": timing.busy_events_ms(lambda: run(kern), 5),
            "call_ms": timing.cuda_ms(lambda: run(kern), 5),
            "plain_ms": timing.card_ms(lambda: run(plain), 1),
            "bound_ms": b_ms, "bound_by": by, "bytes": nbytes, "ops": ops,
            "launches": sum(weights)}


def x_adversarial(torch, dev, rng):
    """the kernels' edge cases as calls [(x, args, kwargs, label)]: X1 on
    every flag combination with flat and 0 / 255 borders (uint8 and int32
    contexts, frac = 0 rows in every block); X2 with SATD ties across the
    K-th place (flat borders), equal and planar / DC neighbour modes at K
    1, 4, 12 and 35; X3 with all-zero blocks, levels at K1's int16
    extremes and SSEs at the RD cost's saturation edges, at qpd6 0-4."""
    import itertools

    from hevce_tpu_torch.ops import constants as C

    to = lambda a, dt=None: torch.from_numpy(
        np.ascontiguousarray(a if dt is None else a.astype(dt))).to(dev)
    fl16 = np.array(list(itertools.product([False, True], repeat=4)))
    out = []
    for sz in (4, 8, 16, 32):
        rows = 32
        top = rng.integers(0, 256, (rows, 1 + 2 * sz))
        left = rng.integers(0, 256, (rows, 2 * sz))
        top[0], left[0] = 77, 77
        top[1], left[1] = 255, 0
        top[2], left[2] = 0, 255
        fl = to(fl16[np.arange(rows) % 16])
        for dt in (np.uint8, np.int32):
            out.append(("x1", [sz, to(top, dt), to(left, dt), fl], {},
                        f"flags x borders, sz={sz} {np.dtype(dt).name}"))
        if sz >= 8:
            blk = rng.integers(0, 256, (rows, sz, sz))
            blk[3] = 200
            top[3], left[3] = 200, 200
            pml = rng.integers(0, 35, rows)
            pma = rng.integers(0, 35, rows)
            pml[:4], pma[:4] = (7, 0, 1, 30), (7, 1, 0, 30)
            for K in (1, 4, 12, 35):
                out.append(("x2", [sz, to(top, np.uint8), to(left, np.uint8),
                                   fl, to(blk, np.uint8),
                                   to(pml, np.int32), to(pma, np.int32), K],
                            {}, f"ties, sz={sz} K={K}"))
    i32max = 2**31 - 1
    for (sz, M, split, modes, hdr), qpd6 in itertools.product(
            ((8, 12, False, True, 6), (32, 12, False, True, 6),
             (16, 4, True, True, 9), (4, 35, False, False, 1),
             (16, 35, True, False, 9)), range(5)):
        rows, n = 6, sz // 2 if split else sz
        shape = (rows, M) + ((4, n, n) if split else (n, n))
        q = np.where(rng.random(shape) < 0.12,
                     rng.integers(-40, 41, shape), 0)
        q[0, 0], q[0, 1], q[0, 2] = 0, 32767, -32768
        q[1, 0] = rng.choice([-32768, -32767, 32767], shape[2:])
        lim = i32max // int(C.RDCOST_WEIGHT_DIST[qpd6])
        sse = rng.integers(0, 255 * 255 * 1024, (rows, M))
        sse.reshape(-1)[:5] = (lim - 1, lim, min(lim + 1, i32max), i32max,
                               0)
        cv = rng.integers(0, 4 << 15, rows)
        cv[0] = 4 << 15
        md = np.sort(rng.choice(35, (rows, M)), -1) if modes else None
        out.append(("x3", [sz, qpd6, to(q, np.int16), to(sse, np.int32),
                           to(cv, np.int32), to(cv[::-1], np.int32),
                           to(rng.integers(0, 35, rows), np.int32),
                           to(rng.integers(0, 35, rows), np.int32), hdr,
                           None if md is None else to(md, np.int32), split],
                    {}, f"extremes, sz={sz} M={M} split={split} "
                        f"qpd6={qpd6}"))
    out += x4_adversarial(torch, dev, rng)
    return out


def x4_adversarial(torch, dev, rng):
    """X4's edge cases as calls [("x4", args, kwargs, label)], at 1 and 37
    rows: a node's pick (RMD 12 + 4 with mode maps, dense 35 + 35, the
    split's levels as (rows, T, 4, h, h) sub-TUs) at sz 8 / 16 / 32 and an
    NxN PU's (4, 35) into its slots, a 4x4 of a canvas view and a running
    total; costs that tie at the minimum (within a set and across the two),
    all at I32_MAX, one below it, and totals at the saturation edge
    (I32_MAX - min - 1 ... + 1, I32_MAX, 0)."""
    i32max = 2**31 - 1
    to = lambda a, dt: torch.from_numpy(np.ascontiguousarray(
        a.astype(dt))).to(dev)
    blk = lambda lo, hi, dt, *s: to(rng.integers(lo, hi, s), dt)

    def costs(rows, m1, m2):
        """(rows, m1 + m2) costs: few values (ties), row 0 all I32_MAX, row
        1 one below it in both sets' first places, row 2 the minimum at the
        last of set 1 and the first of set 2, row 3 all equal."""
        c = rng.integers(5, 8, (rows, m1 + m2))
        c[0] = i32max
        if rows > 1:
            c[1], c[1, [0, m1 % (m1 + m2)]] = i32max, i32max - 1
            c[2, [m1 - 1, m1 % (m1 + m2)]] = 4
            c[3] = 6
        return c

    out = []
    for rows in (1, 37):
        for sz, rmd in ((8, True), (16, True), (32, True), (8, False),
                        (16, False), (32, False)):
            m1, m2 = (12, 4) if rmd else (35, 35)
            c, h = costs(rows, m1, m2), sz // 2
            args = [to(c[:, :m1], np.int32),
                    blk(-32768, 32768, np.int16, rows, m1, sz, sz),
                    blk(0, 256, np.uint8, rows, m1, sz, sz),
                    to(c[:, m1:], np.int32),
                    blk(-32768, 32768, np.int16, rows, m2, 4, h, h),
                    blk(0, 256, np.uint8, rows, m2, sz, sz)]
            if rmd:
                mk = np.sort(rng.choice(35, (rows, m1)), -1)
                args += [to(mk, np.int32), to(mk[:, :m2][:, ::-1], np.int32)]
            out.append(("x4", args, {}, f"{'rmd' if rmd else 'dense'} node, "
                                        f"sz={sz} rows={rows}"))
        c = costs(rows, 35, 0)
        mn = c.min(1)
        edge = np.clip(i32max - mn + rng.integers(-1, 2, rows), 0, i32max)
        edge[: min(rows, 3)] = (i32max - mn[0], i32max, 0)[: min(rows, 3)]
        canvas = blk(0, 256, np.uint8, rows, 40, 41)[:, 4:37, 5:38]
        pm4 = torch.full((rows, 4), -1, dtype=torch.int32, device=dev)
        quant = torch.full((rows, 64), 7, dtype=torch.int16, device=dev)
        q4 = blk(-32768, 32768, np.int16, rows, 35, 4, 4, 4)
        r4 = blk(0, 256, np.uint8, rows, 35, 8, 8)
        for isub, (q, r) in enumerate((
                (q4[..., 0, :, :], r4[..., 0:4, 0:4]),
                (blk(-32768, 32768, np.int16, rows, 35, 4, 4),
                 blk(0, 256, np.uint8, rows, 35, 4, 4)))):
            y, x = 8 + 4 * isub, 16 + 4 * isub
            out.append(("x4", [to(c, np.int32), q, r],
                        {"pm": pm4[:, 3 * isub],
                         "quant": quant[:, 16 * isub:16 * isub + 16],
                         "recon": canvas[:, y + 1:y + 5, x + 1:x + 5],
                         "total": to(edge, np.int32)},
                        f"NxN PU{3 * isub}, saturation edge, rows={rows}"))
    return out


def phase_xnode(torch, dev, rng, card, imgs):
    """X1-X4 against their plain versions on the card (tolerance 0; X4's
    in-place slots, canvas and total too, x_twins): at
    every call of a real RMD and a real dense front step (288 lanes, front
    30 of the slice phase's 768x512 batch, qpd6 0-4), at the lockstep
    path's 18-row calls and the spec path's one-row calls (X1, through
    eval_2nx2n and eval_tusplit on lockstep requests, qpd6 0-4), and in the
    adversarial cases (x_adversarial). Then per kernel the card ms, call ms
    and plain ms of one RMD front step's calls (and of one dense step's),
    X1's per lockstep and per spec CTU, beside their bounds."""
    from hevce_tpu_torch.models import cu_eval
    from hevce_tpu_torch.models import wavefront as wf
    from hevce_tpu_torch.tools.bench_k2 import lock_requests

    land = [im for im in imgs if im.shape == imgs[0].shape][:BATCH]
    R, C, d, W, PME, O, cv, sv = front_inputs(torch, dev, land)
    err = dict.fromkeys(X_KERNELS, 0)
    checked = dict.fromkeys(X_KERNELS, 0)

    def held(calls, where):
        for x, lst in calls.items():
            for a, kw in lst:
                err[x] = max(err[x], x_compare(torch, x, a, kw, where))
                checked[x] += 1

    steps = {}
    for rmd, per in (((12, 4), FRONT_LAUNCHES), (None, DENSE_FRONT_LAUNCHES)):
        for qpd6 in range(5):
            calls = x_calls(torch, lambda: wf.front_core(
                qpd6, R, rmd, W, PME, O, d, C, cv, sv))
            n = {x: len(v) for x, v in calls.items()}
            if n != {x: per[x] for x in X_KERNELS}:
                fail(f"one front step (rmd={rmd}, qpd6={qpd6}) called the "
                     f"fused node wrappers {n}, expected {per}")
            held(calls, f"at a front step's calls (rmd={rmd}, qpd6={qpd6})")
            if qpd6 == QPD6:
                steps["rmd" if rmd else "dense"] = calls
    lock, spec = [], []
    for qpd6 in range(5):
        for sz in (4, 8, 16, 32):
            req = lock_requests(dev, rng, sz)
            one = [t[0] for t in req]           # the spec's one-row call
            for rows, args in ((lock, req), (spec, one)):
                calls = x_calls(torch, lambda: (
                    cu_eval.eval_2nx2n(sz, qpd6, *args),
                    sz > 4 and cu_eval.eval_tusplit(sz, qpd6, *args)))
                held(calls, f"at the {'spec' if rows is spec else 'lockstep'}"
                            f" path's calls (sz={sz}, qpd6={qpd6})")
                if qpd6 == QPD6:
                    rows.extend(calls["x1"])
    for x, a, kw, label in x_adversarial(torch, dev, rng):
        err[x] = max(err[x], x_compare(torch, x, a, kw, f"({label})"))
        checked[x] += 1

    def per_ctu(calls):
        """the weights of X1's distinct calls in one CTU (X1_PER_CTU)."""
        key = lambda a: (a[0], len(a) > 6 and a[6] is not None)
        return [X1_PER_CTU[key(a)]
                // sum(1 for b, _ in calls if key(b) == key(a))
                for a, _ in calls]

    rows = {}
    for x in X_KERNELS:
        row = {"name": x, "step": x_times(torch, x, steps["rmd"][x])}
        if steps["dense"][x]:
            row["dense_step"] = x_times(torch, x, steps["dense"][x])
        rows[x] = row
    for key, calls in (("lockstep_ctu", lock), ("spec_ctu", spec)):
        rows["x1"][key] = x_times(torch, "x1", calls, per_ctu(calls))
    emit({"phase": "xnode", "card": card, "checked": checked,
          "exact": True, "max_abs_err": err, "lanes": LANES,
          "per_front": FRONT_LAUNCHES, "dense_per_front":
          DENSE_FRONT_LAUNCHES, "x1_per_ctu": sum(X1_PER_CTU.values()),
          "kernels": list(rows.values()),
          "basis": "step: the calls of one RMD front step (front 30 of an "
                   "18-image 768x512 batch, 288 lanes, qpd6 2), dense_step "
                   "of one dense step; lockstep_ctu / spec_ctu X1's 169 "
                   "calls of one CTU at 18 rows / one row (eval_2nx2n and "
                   "eval_tusplit on lockstep requests). ms: card time "
                   "(CUDA events behind a spin kernel), call_ms with the "
                   "host's enqueue (CUDA events), plain_ms the plain "
                   "version's card time (profiler); "
                   "bound_ms the larger of bytes at 3.35 TB/s and int32 "
                   "operations at 33.5 TOP/s"})
    return err, rows


# ------------------------------------------------------------------- slice

def psnr(a, b):
    m = ((a.astype(np.int64) - b.astype(np.int64)) ** 2).mean()
    return float(10 * np.log10(255 * 255 / max(m, 1e-9)))


def phase_slice(torch, dev, rng, card):
    from hevce_tpu_torch.models import wavefront as wf
    from hevce_tpu_torch.runtime import native
    from hevce_tpu_torch.utils.synth import kodak_shaped
    from hevce_tpu_torch.utils.tracing import PhaseTimer

    if wf.adapt_mode() != "pre" or wf._resolve_rmd(wf._RMD_ENV) != (12, 4):
        fail("the main path runs HEVCE_ADAPT=pre and RMD (12, 4); unset "
             "HEVCE_ADAPT / HEVCE_RMD")
    imgs = kodak_shaped(rng)
    shapes = sorted({im.shape for im in imgs})
    grads = {s: [wf._grad_energy(im) for im in imgs if im.shape == s]
             for s in shapes}
    for s, g in grads.items():
        if not any(x >= wf.ADAPT_GRAD_TRIGGER for x in g):
            fail(f"no image of shape {s} crosses the gradient trigger")

    fronts = 0
    for s in shapes:
        R, Cc = -(-s[0] // 32), -(-s[1] // 32)
        n = sum(1 for im in imgs if im.shape == s)
        fronts += -(-n // BATCH) * (2 * (R - 1) + Cc)

    # the first run builds the two shapes' slice runners (an eager warm-up
    # step and a graph capture each); the second replays them, timed
    torch.cuda.reset_peak_memory_stats()
    runs = []
    for _ in range(2):
        timer = PhaseTimer()
        reset_launches()
        built0 = runners_built()
        t0 = time.perf_counter()
        streams, recons = wf.encode_many_fast(imgs, QPD6, batch=BATCH,
                                              timer=timer, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        built = runners_built() - built0
        counts = check_fronts("the main path", FRONT_LAUNCHES,
                              fronts + built)
        launches = counts["k1"]
        runs.append((wall, counts, built, streams))
    if runs[0][2] != len(shapes) or runs[1][2]:
        fail(f"the runs built {runs[0][2]} and {runs[1][2]} slice runners, "
             f"expected {len(shapes)} and 0")
    if runs[0][3] != streams:
        fail("the second run's streams differ from the first's")
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
          "k1_launches": launches, "launches": counts,
          "launches_per_front": FRONT_LAUNCHES, "wall_s": wall,
          "mp_per_s": pixels / wall / 1e6,
          "first_run": {"wall_s": runs[0][0], "launches": runs[0][1],
                        "runners_built": runs[0][2],
                        "mp_per_s": pixels / runs[0][0] / 1e6},
          "phases_s": dict(timer.totals),
          "grad_energy": {str(s): g for s, g in grads.items()},
          "psnr_db_mean": float(np.mean(quality)),
          "psnr_db_min": float(np.min(quality)),
          "bpp_mean": float(np.mean(bpp)), "decoded": len(streams),
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
          "peak_note": "both runs, the captures included"})
    return counts, imgs, streams, recons, pixels / wall / 1e6


# ---------------------------------------------------------------- lockstep

LOCK_RUNS = ((False, False), (True, False), (False, True))  # rates, pipeline


def lockstep_programs(dev):
    """the lockstep phase's event programs by label: at B=18 in slot 0 the
    node programs (sz 8 / 16 / 32, rates off and on) and the PU program,
    at B=9 in slots 0 and 1 (the pipelined halves) the rates-off ones, and
    each one's winner gather."""
    from hevce_tpu_torch.parallel import lockstep as ls

    progs = {}
    for B, run, rates_set in ((BATCH, 0, (False, True)),
                              (BATCH // 2, 0, (False,)),
                              (BATCH // 2, 1, (False,))):
        where = f"B={B} slot={run}"
        for rates in rates_set:
            for sz in NODE_PER_CTU:
                progs[f"node{sz}{'_rates' if rates else ''} {where}"] = \
                    ls._node_program(sz, QPD6, B, rates, dev, (run, 0))
        progs[f"pu {where}"] = ls._pu_program(QPD6, B, dev, (run, 0))
    for label, p in list(progs.items()):
        progs[f"{label} gather"] = ls._gather_program(p)
    return progs


def program_row(label, prog):
    """a program's capture cost: warm-up, capture and instantiate seconds,
    graph nodes, pool GiB, launches a replay."""
    run = prog.run
    if run.graph is None:
        fail(f"the program {label} holds no graph")
    return {"key": label, "kind": prog.kind, "nodes": graph_nodes(run.graph),
            **run.stats, "pool_gib": run.stats["pool_bytes"] / 2**30,
            "launches": run.launches}


def replay_vs_plain(torch, prog, plain, reps):
    """prog replayed on the inputs it holds (its last event's) against its
    plain step on the same inputs: the outputs must be equal (tolerance 0).
    Per call: the replay's card ms (CUDA events over reps replays), its
    wall ms (host clock to a synchronize) and the plain step's wall and
    card ms (reps calls)."""
    def timed(fn):
        torch.cuda.synchronize()
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in "01")
        t0 = time.perf_counter()
        e0.record()
        for _ in range(reps):
            out = fn()
        e1.record()
        torch.cuda.synchronize()
        return out, 1e3 * (time.perf_counter() - t0) / reps, \
            e0.elapsed_time(e1) / reps

    with torch.no_grad():
        got, wall, card = timed(prog)
        got = [t.cpu().numpy().tobytes() for t in got]
        want, plain_wall, plain_card = timed(plain)
    if got != [t.cpu().numpy().tobytes() for t in want]:
        return None
    return {"replay_wall_ms": wall, "replay_card_ms": card,
            "plain_wall_ms": plain_wall, "plain_card_ms": plain_card,
            "equal": True}


def events_vs_plain(torch, progs):
    """per event kind of the main path (B=18, slot 0), the program's replay
    against its plain step (lockstep._node_step, parallel/batch.
    device_step, _pu_step, _gather_winners) on the same inputs."""
    from hevce_tpu_torch.parallel import batch as pb
    from hevce_tpu_torch.parallel import lockstep as ls

    out = {}
    for label, prog in progs.items():
        if not label.endswith(f"B={BATCH} slot=0") and not label.endswith(
                f"B={BATCH} slot=0 gather"):
            continue
        a = prog.args
        if prog.kind == "gather":
            producer = progs[label[:-len(" gather")]]
            producer()      # its outputs again, from the inputs it holds
            plain = lambda a=a, p=producer: ls._gather_winners(
                *ls._candidates(p), a[0])
        elif prog.kind == "pu":
            plain = lambda a=a: ls._pu_step(QPD6, a[0], a[1], a[2] != 0, a[3])
        else:
            sz = (a[0].shape[1] - 1) // 2
            step = (functools.partial(ls._node_step, sz, QPD6)
                    if prog.kind == "node_rates"
                    else functools.partial(pb.device_step, sz, QPD6))
            plain = lambda a=a, step=step: step(a[0], a[1], a[2] != 0,
                                                *a[3:])
        reps = 3 if prog.kind == "node_rates" else 10
        row = replay_vs_plain(torch, prog, plain, reps)
        if row is None:
            fail(f"the lockstep program {label} differs from its plain step "
                 f"on the same inputs")
        out[label.split()[0] + (" gather" if prog.kind == "gather"
                                else "")] = row
    return out


def phase_lockstep(torch, dev, rng, card):
    from hevce_tpu_torch.ops import cabac_scan, fused_eval
    from hevce_tpu_torch.parallel import lockstep
    from hevce_tpu_torch.runtime import native
    from hevce_tpu_torch.utils import timing
    from hevce_tpu_torch.utils.synth import SIGMAS, synth_image
    from hevce_tpu_torch.utils.tracing import PhaseTimer

    imgs = [synth_image(rng, *LOCK_SHAPE, SIGMAS[i % 4]) for i in range(BATCH)]
    refs = [native.encode_image_native(im, QPD6) for im in imgs]
    ctus = (LOCK_SHAPE[0] // 32) * (LOCK_SHAPE[1] // 32)
    want_node = sum(NODE_PER_CTU.values()) * ctus
    want_pu = PU_PER_CTU * ctus
    # build every run's programs: one CTU an image through each run (each
    # program's first event runs a warm-up step and captures it)
    crops = [im[:32, :32] for im in imgs]
    since = captured()
    t0 = time.perf_counter()
    for node_rates, pipeline in LOCK_RUNS:
        lockstep.encode_batch(crops, QPD6, node_rates=node_rates,
                              pipeline=pipeline, device=dev)
    torch.cuda.synchronize()
    build = {"wall_s": time.perf_counter() - t0,
             "programs": dict(programs_built(since))}

    runs, k1_total, k2_total = [], 0, 0
    for node_rates, pipeline in LOCK_RUNS:
        halves = 2 if pipeline else 1
        timer = PhaseTimer()
        reset_launches()
        since = captured()
        t0 = time.perf_counter()
        streams, rcons = lockstep.encode_batch(
            imgs, QPD6, node_rates=node_rates, pipeline=pipeline,
            timer=timer, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        k1, k2 = fused_eval.LAUNCHES, cabac_scan.LAUNCHES
        w1, w2 = warmup_launches(since)
        x_only_x1(f"the lockstep path (node_rates={node_rates}, "
                  f"pipeline={pipeline})")
        # events are counted per engine: each half runs the whole schedule
        node = sum(n for k, n in timer.counts.items()
                   if k.startswith("device_math_node"))
        pu = timer.counts["device_math_pu"]
        fetch = timer.counts["winner_fetch"] // 2
        if (node, pu) != (halves * want_node, halves * want_pu):
            fail(f"lockstep ran {node} node / {pu} PU events, expected "
                 f"{halves} x {want_node} / {want_pu}")
        if k1 != 5 * node + pu + w1:
            fail(f"K1 launched {k1} times on the lockstep path, expected "
                 f"5 x {node} node + {pu} PU events + {w1} in the warm-up "
                 f"steps of the programs built")
        if k2 != pu + (node if node_rates else 0) + w2:
            fail(f"K2 launched {k2} times on the lockstep path "
                 f"(node_rates={node_rates}), expected {pu} PU"
                 + (f" + {node} node events" if node_rates else " events")
                 + f" + {w2} in the warm-up steps of the programs built")
        for i, (s, r) in enumerate(zip(streams, rcons)):
            if s != refs[i][0] or not np.array_equal(r, refs[i][1]):
                fail(f"lockstep image {i} (node_rates={node_rates}, "
                     f"pipeline={pipeline}) differs from the native "
                     f"engine's encode")
            if not np.array_equal(native.decode_stream(s), r):
                fail(f"lockstep stream {i} does not decode to its recon")
        k1_total += k1
        k2_total += k2
        runs.append({"node_rates": node_rates, "pipeline": pipeline,
                     "wall_s": wall,
                     "events": {"node": node, "pu": pu, "fetch": fetch},
                     "events_per_s": (node + pu + fetch) / halves / wall,
                     "k1_launches": k1, "k2_launches": k2,
                     "programs_built": dict(programs_built(since)),
                     "phases_s": dict(timer.totals),
                     "byte_identical": len(streams)})
    progs = lockstep_programs(dev)
    keys = [program_row(label, p) for label, p in progs.items()]
    events = events_vs_plain(torch, progs)
    # where one CTU's time goes: torch.profiler over a batch of one-CTU
    # crops with node rates on (wall timed inside the profiled region)
    wall = []

    def one_ctu():
        t0 = time.perf_counter()
        lockstep.encode_batch(crops, QPD6, node_rates=True, device=dev)
        torch.cuda.synchronize()
        wall.append(time.perf_counter() - t0)

    lost0 = timing.LOST_SESSIONS
    ks, complete = timing.card_kernels(one_ctu)
    busy_us = sum(us for _, us, _ in ks)
    prof = {"ctus": 1, "node_rates": True, "wall_s": wall[-1],
            "complete": complete,
            "lost_sessions": timing.LOST_SESSIONS - lost0,
            "card_busy_ms": busy_us / 1e3,
            "card_busy_share": busy_us / 1e6 / wall[-1],
            "k1_ms": sum(us for k, us, _ in ks if "k1_kernel" in k) / 1e3,
            "k2_ms": sum(us for k, us, _ in ks if "k2_kernel" in k) / 1e3,
            "kernels": sum(n for _, _, n in ks)}
    emit({"phase": "lockstep", "card": card, "images": len(imgs),
          "shape": list(LOCK_SHAPE), "ctus_per_image": ctus, "qpd6": QPD6,
          "batch": BATCH, "bytes_mean": float(np.mean([len(r[0])
                                                       for r in refs])),
          "build": build, "runs": runs, "program_keys": keys,
          "events_vs_plain": events, "profile_one_ctu": prof,
          "basis": "build: one CTU an image through each run, which "
                   "builds every program the runs replay (warm-up step, "
                   "capture, instantiate: program_keys, pool_gib the "
                   "memory each capture reserved); events_vs_plain: per "
                   "event kind at B=18, the replay on the inputs of the "
                   "program's last event against its plain step on the "
                   "same inputs (equal, tolerance 0), wall ms to a "
                   "synchronize and card ms by CUDA events, per call"})
    return k1_total, k2_total


# ----------------------------------------------------------------- profile

def phase_profile(torch, dev, rng):
    """torch.profiler over two front steps at the main path's lanes (a
    768x512 batch of 18): wall time, the card's busy time and K1's part;
    then the same for two dense (rmd=None) front steps on the same inputs."""
    from hevce_tpu_torch.models import wavefront as wf
    from hevce_tpu_torch.utils import timing

    B, R, C = BATCH, 16, 24
    u8 = lambda *s: torch.from_numpy(
        rng.integers(0, 256, s).astype(np.uint8)).to(dev)
    W, O = u8(B, R, 3, 32, 32), u8(B, R, 32, 32)
    PME = torch.from_numpy(rng.integers(0, 35, (B, R, 8)).astype(
        np.int32)).to(dev)
    cv = torch.full((B * R,), wf.CTX_BIT, dtype=torch.int32, device=dev)
    sv = torch.full((B * R,), wf.SIG_ZERO, dtype=torch.int32, device=dev)

    def profiled(rmd):
        def steps():
            with torch.no_grad():
                for d in (30, 31):
                    wf.front_core(QPD6, R, rmd, W, PME, O, d, C, cv, sv)

        def timed_steps():
            t0 = time.perf_counter()
            steps()
            torch.cuda.synchronize()
            wall.append(time.perf_counter() - t0)

        steps()
        torch.cuda.synchronize()
        wall = []              # timed inside the profiled region, so it
        lost0 = timing.LOST_SESSIONS      # leaves out the post-processing
        ks, complete = timing.card_kernels(timed_steps)
        busy_us = sum(us for _, us, _ in ks)
        k1_us = sum(us for k, us, _ in ks if "k1_kernel" in k)
        port = {x: {"ms_per_step": sum(us for k, us, _ in ks if key in k)
                    / 2e3,
                    "launches_per_step": sum(n for k, _, n in ks if key in k)
                    / 2}
                for x, (_, _, key, _) in X_KERNELS.items()}
        return ks, {"wall_ms_per_step": 1e3 * wall[-1] / 2,
                    "card_busy_ms_per_step": busy_us / 1e3 / 2,
                    "card_busy_share": busy_us / 1e6 / wall[-1],
                    "k1_ms_per_step": k1_us / 1e3 / 2,
                    "k1_launches_per_step": sum(
                        n for k, _, n in ks if "k1_kernel" in k) / 2,
                    "kernels_per_step": sum(n for _, _, n in ks) / 2,
                    "x_kernels": port, "complete": complete,
                    "lost_sessions": timing.LOST_SESSIONS - lost0}

    ks, rmd_step = profiled((12, 4))
    top = sorted(ks, key=lambda k: -k[1])[:6]
    emit({"phase": "profile", "front_steps": 2, "lanes": B * R, **rmd_step,
          "top_kernels": [{"name": k[:60], "ms_per_step": us / 1e3 / 2,
                           "launches_per_step": n / 2}
                          for k, us, n in top],
          "dense": profiled(None)[1]})


# ---------------------------------------------------------------- identity

def records_identical(dev, rmd):
    """3 small images (a 64x96 batch of two, one 50x70) at qpd6 0, 2 and 4
    through _dispatch_batch on the card and on the CPU at `rmd`: fails
    unless the lean record buffers are byte-identical; returns how many
    buffers were compared."""
    from hevce_tpu_torch.models import wavefront as wf
    from hevce_tpu_torch.utils.tracing import PhaseTimer

    compared = 0
    for qpd6 in (0, 2, 4):
        for group in identity_groups():
            prices = wf._predict_prices(group, qpd6)
            bufs = []
            for d in (dev, "cpu"):
                out, meta = wf._dispatch_batch(group, qpd6, rmd, prices=prices,
                                               device=d)
                wf._fetch_lean(out, meta, PhaseTimer())   # checksum tail
                bufs.append(out.numpy().tobytes())
            if bufs[0] != bufs[1]:
                fail(f"card and CPU records differ at qpd6={qpd6}, "
                     f"shape {group[0].shape}, rmd={rmd}")
            compared += 1
    return compared


def phase_identity(dev):
    from hevce_tpu_torch.models import wavefront as wf

    emit({"phase": "identity",
          "buffers_compared": records_identical(dev, wf._RMD_ENV),
          "byte_identical": True})


# ------------------------------------------------------------------- dense

def k1_dense_calls(torch, dev, imgs):
    """K1's inputs as one dense front step hands them over (front_inputs:
    front 30 of the batch's 768x512 grid at 288 lanes). Returns the [(sz,
    pred, blk)] of every K1 call, taken at its wrapper."""
    from hevce_tpu_torch.models import wavefront as wf
    from hevce_tpu_torch.ops import fused_eval

    R, C, d, W, PME, O, cv, sv = front_inputs(torch, dev, imgs)
    calls, k1 = [], fused_eval.pipeline_sse

    def taken(sz, q, pred, blk):
        calls.append((sz, pred.clone(), blk.clone()))
        return k1(sz, q, pred, blk)

    fused_eval.pipeline_sse = taken
    try:
        with torch.no_grad():
            wf.front_core(QPD6, R, None, W, PME, O, d, C, cv, sv)
    finally:
        fused_eval.pipeline_sse = k1
    return calls


def phase_dense(torch, dev, card, imgs, shapes):
    """the dense fast mode on the slice phase's 18 768x512 images (one
    batch at 288 lanes): K1 launches, decode, card-vs-CPU records, K1 at
    one dense front step's own calls; K1's card ms per step from the
    kernels phase's rows at (sz, 35)."""
    from hevce_tpu_torch.models import wavefront as wf
    from hevce_tpu_torch.runtime import native
    from hevce_tpu_torch.utils.tracing import PhaseTimer

    land = [im for im in imgs if im.shape == imgs[0].shape]
    if len(land) != BATCH:
        fail(f"dense: expected {BATCH} images of {imgs[0].shape}, got "
             f"{len(land)}")
    R, C = -(-land[0].shape[0] // 32), -(-land[0].shape[1] // 32)
    fronts = 2 * (R - 1) + C
    torch.cuda.reset_peak_memory_stats()
    # the first run builds the batch's dense runner (an eager warm-up step
    # and a graph capture); the second replays it, timed
    runs = []
    for _ in range(2):
        timer = PhaseTimer()
        reset_launches()
        built0 = runners_built()
        t0 = time.perf_counter()
        streams, recons = wf.encode_batch_fast(land, QPD6, timer=timer,
                                               rmd=None, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        built = runners_built() - built0
        counts = check_fronts("the dense path", DENSE_FRONT_LAUNCHES,
                              fronts + built)
        launches = counts["k1"]
        runs.append((wall, launches, built))
    if (runs[0][2], runs[1][2]) != (1, 0):
        fail(f"the dense runs built {runs[0][2]} and {runs[1][2]} runners, "
             f"expected 1 and 0")
    peak = torch.cuda.max_memory_allocated() / 2**30
    t0 = time.perf_counter()
    quality, bpp = [], []
    for i, (s, r) in enumerate(zip(streams, recons)):
        if not np.array_equal(native.decode_stream(s), r):
            fail(f"dense stream {i} does not decode to its recon")
        h, w = land[i].shape
        quality.append(psnr(r[:h, :w], land[i]))
        bpp.append(8 * len(s) / land[i].size)
    decode_s, t0 = time.perf_counter() - t0, time.perf_counter()
    compared = records_identical(dev, None)
    identity_s, t0 = time.perf_counter() - t0, time.perf_counter()
    calls = k1_dense_calls(torch, dev, land)
    got = {}
    for sz, pred, blk in calls:
        key = (sz, pred.shape[-3])
        got[key] = got.get(key, 0) + 1
        if pred.shape[:-3].numel() != LANES:
            fail(f"dense K1 call at sz={sz}: pred {tuple(pred.shape)}, "
                 f"expected {LANES} lanes")
    if got != DENSE_PER_FRONT:
        fail(f"one dense front step made the K1 calls {got}, expected "
             f"{DENSE_PER_FRONT}")
    max_err = max(k1_compare(torch, sz, QPD6, pred, blk,
                             "at a dense front step's calls")
                  for sz, pred, blk in calls)
    k1_check_s = time.perf_counter() - t0
    rows = {(r["sz"], r["M"]): r for r in shapes}
    per_step = lambda key: sum(n * rows[k][key]
                               for k, n in DENSE_PER_FRONT.items())
    out = {"launches": launches, "x_launches": counts,
           "ms_per_front": per_step("ms"),
           "bound_ms_per_front": per_step("bound_ms"),
           "tc_bound_ms_per_front": per_step("tc_bound_ms"),
           "plain_ms_per_front": per_step("plain_ms"), "max_abs_err": max_err}
    emit({"phase": "dense", "card": card, "images": len(land),
          "shape": list(land[0].shape), "qpd6": QPD6, "batch": BATCH,
          "lanes": LANES,
          "fronts": fronts, "k1_launches": launches, "launches": counts,
          "launches_per_front": DENSE_FRONT_LAUNCHES, "wall_s": wall,
          "first_run": {"wall_s": runs[0][0], "k1_launches": runs[0][1],
                        "runners_built": runs[0][2]},
          "wall_ms_per_front": 1e3 * wall / fronts,
          "mp_per_s": sum(im.size for im in land) / wall / 1e6,
          "phases_s": dict(timer.totals),
          "k1_card_ms_per_front": out["ms_per_front"],
          "k1_bound_ms_per_front": out["bound_ms_per_front"],
          "k1_tc_bound_ms_per_front": out["tc_bound_ms_per_front"],
          "k1_ms_basis": "the kernels phase's card ms at (sz, 35) and 288 "
                         "lanes times the calls per dense front step",
          "k1_checked": len(calls), "k1_max_abs_err": max_err,
          "records_compared": compared, "decoded": len(streams),
          "psnr_db_mean": float(np.mean(quality)),
          "bpp_mean": float(np.mean(bpp)), "peak_mem_gib": peak,
          "parts_s": {"decode": decode_s, "identity": identity_s,
                      "k1_check": k1_check_s}})
    return out


# ------------------------------------------------------------------- graph

def identity_groups():
    """the identity phase's images: a 64x96 pair (noise, a ramp) and one
    50x70 noise image."""
    rng = np.random.default_rng(5)
    noise = rng.integers(0, 256, (64, 96)).astype(np.uint8)
    yy, xx = np.mgrid[0:64, 0:96]
    smooth = ((yy * 2 + xx) % 256).astype(np.uint8)
    odd = rng.integers(0, 256, (50, 70)).astype(np.uint8)
    return [noise, smooth], [odd]


def out_bytes(out):
    """a slice's outputs (a tensor, a _HostCopy, or a tuple of them and
    None) as bytes, read on the host."""
    if not isinstance(out, tuple):
        out = (out,)
    return [None if o is None else
            (o.cpu().numpy() if hasattr(o, "cpu") else o.numpy()).tobytes()
            for o in out]


def graph_vs_eager(torch, dev):
    """graph replays (_dispatch_batch) against the eager run_slice on the
    card, byte for byte: lean records on both identity groups, full records
    with the recon and dense records on the pair, at qpd6 0, 2 and 4 with
    the predicted prices. Returns how many slices were compared."""
    from hevce_tpu_torch.models import wavefront as wf

    pair, odd = identity_groups()
    compared = 0
    for qpd6 in (0, 2, 4):
        for group, rmd, full in ((pair, (12, 4), False), (odd, (12, 4), False),
                                 (pair, (12, 4), True), (pair, None, False)):
            prices = wf._predict_prices(group, qpd6)
            out, _ = wf._dispatch_batch(group, qpd6, rmd, prices=prices,
                                        device=dev, want_recon=full,
                                        fetch_qc=full)
            args = [torch.from_numpy(a).to(dev)
                    for a in wf._slice_inputs(group, qpd6, prices)[1]]
            with torch.no_grad():
                eager = wf.run_slice(*args, qpd6, rmd, fetch_qc=full,
                                     want_recon=full)
            if out_bytes(out) != out_bytes(eager):
                fail(f"graph replays differ from the eager step at qpd6="
                     f"{qpd6}, shape {group[0].shape}, rmd={rmd}, "
                     f"fetch_qc={full}")
            compared += 1
    return compared


def graph_nodes(graph):
    """the nodes of a captured CUDA graph (the slice runner keeps its
    cudaGraph_t: CUDAGraph(keep_graph=True)), from libcuda's
    cuGraphGetNodes."""
    import ctypes

    n = ctypes.c_size_t(0)
    rc = ctypes.CDLL("libcuda.so.1").cuGraphGetNodes(
        ctypes.c_void_p(graph.raw_cuda_graph()), None, ctypes.byref(n))
    if rc:
        fail(f"cuGraphGetNodes: CUresult {rc}")
    return n.value


def replayed_steps(torch, runner, per_step):
    """at one runner (its buffers loaded): ms per front step of a whole
    slice of replays (CUDA events, the host's wall and its enqueue), the
    host's time of one replay call with the card idle, the eager step's
    wall ms at fronts 30 and 31 on the same buffers, and a profiled pair of
    replayed steps (fronts 30, 31): card busy share, each port kernel's
    card ms and launches a step, complete, lost sessions. K1 and X1-X4
    must launch per_step {counter: n} times a replayed step."""
    from hevce_tpu_torch.utils import timing

    torch.cuda.synchronize()
    reset_launches()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in "01")
    t0 = time.perf_counter()
    e0.record()
    for d in range(runner.D):
        runner.front(d)
    e1.record()
    enqueue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    check_fronts("the replayed steps", per_step, runner.D)
    # one replay's host call with the card idle: the launch's own cost
    launch = []
    for d in (30, 31):
        torch.cuda.synchronize()
        t = time.perf_counter()
        runner.front(d)
        launch.append(time.perf_counter() - t)
        torch.cuda.synchronize()
    eager = []
    for d in (30, 31):
        runner.d.fill_(d)
        torch.cuda.synchronize()
        t = time.perf_counter()
        with torch.no_grad():
            runner.step()
        torch.cuda.synchronize()
        eager.append(time.perf_counter() - t)
    wall = []

    def two_replays():
        t = time.perf_counter()
        for d in (30, 31):
            runner.front(d)
        torch.cuda.synchronize()
        wall.append(time.perf_counter() - t)

    lost0 = timing.LOST_SESSIONS
    ks, complete = timing.card_kernels(two_replays)
    busy_us = sum(us for _, us, _ in ks)
    k1 = sum(n for k, _, n in ks if "k1_kernel" in k)
    port = {x: {"ms_per_step": sum(us for k, us, _ in ks if key in k) / 2e3,
                "launches_per_step": sum(n for k, _, n in ks if key in k) / 2}
            for x, key in (("k1", "k1_kernel"),
                           *((x, v[2]) for x, v in X_KERNELS.items()))}
    return {"fronts": runner.D,
            "replay_ms_per_step": e0.elapsed_time(e1) / runner.D,
            "replay_wall_ms_per_step": 1e3 * wall_s / runner.D,
            "replay_enqueue_ms_per_step": 1e3 * enqueue_s / runner.D,
            "idle_launch_ms": 1e3 * sum(launch) / len(launch),
            "eager_wall_ms_per_step": 1e3 * sum(eager) / len(eager),
            "profile": {"steps": 2, "wall_ms_per_step": 1e3 * wall[-1] / 2,
                        "card_busy_ms_per_step": busy_us / 1e3 / 2,
                        "card_busy_share": busy_us / 1e6 / wall[-1],
                        "kernels_per_step": sum(n for _, _, n in ks) / 2,
                        "k1_launches_per_step": k1 / 2,
                        "port_kernels": port,
                        "complete": complete,
                        "lost_sessions": timing.LOST_SESSIONS - lost0}}


def phase_graph(torch, dev, card, imgs, slice_mp_s):
    """the slice runner's graphs: graph against eager on the card (byte for
    byte), the main path's runners' capture cost, and per front step at
    288 lanes the replay against the eager step, RMD and dense."""
    from hevce_tpu_torch.models import wavefront as wf
    from hevce_tpu_torch.utils import device as _device

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    compared = graph_vs_eager(torch, dev)
    compare_s = time.perf_counter() - t0
    dev = _device.normal(dev)
    keys = {}
    for s in sorted({im.shape for im in imgs}):
        group = [im for im in imgs if im.shape == s][:BATCH]
        meta, arrays = wf._slice_inputs(group, QPD6,
                                        wf._predict_prices(group, QPD6))
        R, Cc = meta[6], meta[7]
        for rmd in ((12, 4), None) if s == imgs[0].shape else ((12, 4),):
            runner = wf._slice_runner_cache(QPD6, R, Cc, len(group), rmd,
                                            False, False, dev)
            keys[(s, rmd)] = (runner, arrays)
    rows, steps = [], {}
    for (s, rmd), (runner, arrays) in keys.items():
        if runner.graph is None:
            fail(f"the runner of {s}, rmd={rmd} holds no graph")
        per = FRONT_LAUNCHES if rmd else DENSE_FRONT_LAUNCHES
        rows.append({"shape": list(s), "B": runner.B, "R": runner.R,
                     "Cc": runner.Cc, "rmd": rmd,
                     "launches_per_step": runner.launches,
                     "nodes": graph_nodes(runner.graph), **runner.stats,
                     "pool_gib": runner.stats["pool_bytes"] / 2**30})
        if {k: runner.launches[k] for k in per} != per or \
                runner.launches["k2"]:
            fail(f"the runner of {s}, rmd={rmd} captured the launches "
                 f"{runner.launches} a step, expected {per}")
        if rows[-1]["nodes"] > MAX_NODES_PER_STEP:
            fail(f"the runner of {s}, rmd={rmd} captured {rows[-1]['nodes']}"
                 f" graph nodes a step, more than {MAX_NODES_PER_STEP}")
        if s == imgs[0].shape:
            runner.load(*(torch.from_numpy(a).to(dev) for a in arrays))
            steps["rmd" if rmd else "dense"] = replayed_steps(
                torch, runner, per)
    emit({"phase": "graph", "card": card, "compared": compared,
          "byte_identical": True, "compare_s": compare_s, "keys": rows,
          "lanes": LANES, "steps": steps,
          "runners_built": runners_built(),
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
          "reserved_gib": torch.cuda.memory_reserved() / 2**30,
          "slice_mp_per_s": slice_mp_s,
          "nodes_per_step": {("rmd" if r["rmd"] else "dense") + " "
                             + "x".join(map(str, r["shape"])): r["nodes"]
                             for r in rows},
          "basis": "warmup_s: a runner's eager warm-up step; capture_s "
                   "the capture of one front step; instantiate_s its "
                   "instantiation; nodes the graph's; pool_gib the memory "
                   "the capture reserved; replay_ms_per_step CUDA "
                   "events over a whole slice of replays at 288 lanes "
                   "(replay_enqueue_ms_per_step the host's calls, "
                   "idle_launch_ms one call with the card idle); "
                   "eager_wall_ms_per_step the same step run eagerly on "
                   "the same buffers; peak_mem_gib over this phase"})
    return steps


# ----------------------------------------------------------------- surface

def phase_surface(torch, dev, rng, card, imgs, streams, recons):
    """fetch_qc=True, HEVCE_ADAPT=post and encode_many_exact on the card,
    each against what it must equal."""
    from hevce_tpu_torch.models import wavefront as wf
    from hevce_tpu_torch.runtime import native
    from hevce_tpu_torch.utils.tracing import PhaseTimer

    fronts = lambda im: 2 * (-(-im.shape[0] // 32) - 1) + -(-im.shape[1] // 32)
    land = [i for i, im in enumerate(imgs) if im.shape == imgs[0].shape]
    res = {"phase": "surface", "card": card, "qpd6": QPD6, "batch": BATCH}

    # full records: the slice phase's streams and (host-replayed) recons
    reset_launches()
    built0 = runners_built()
    t0 = time.perf_counter()
    s_full, r_full = wf.encode_many_fast([imgs[i] for i in land], QPD6,
                                         batch=BATCH, device=dev,
                                         fetch_qc=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    built = runners_built() - built0
    k1 = check_fronts("fetch_qc=True", FRONT_LAUNCHES,
                      fronts(imgs[land[0]]) + built)["k1"]
    for j, i in enumerate(land):
        if s_full[j] != streams[i]:
            fail(f"fetch_qc=True stream {i} differs from the lean path's")
        if not np.array_equal(r_full[j], recons[i]):
            fail(f"fetch_qc=True device recon {i} differs from the host "
                 f"replay")
    noise = rng.integers(0, 256, (64, 96)).astype(np.uint8)
    out, meta = wf._dispatch_batch([noise], 0, device=dev, fetch_qc=True)
    if not out[1].numpy()[0, 1]:
        fail("a noise image at qpd6=0 did not take the int16 escape sideband")
    s_esc, r_esc = wf._finish_batch(out, meta, True, PhaseTimer(), True)
    s_lean, r_lean = wf.encode_batch_fast([noise], 0, device=dev)
    if s_esc != s_lean or not np.array_equal(r_esc[0], r_lean[0]):
        fail("the escaped image's full-record stream differs from the lean")
    res["fetch_qc"] = {"images": len(land), "wall_s": wall,
                       "k1_launches": k1, "runners_built": built,
                       "byte_identical": len(land), "escape_taken": True}

    # HEVCE_ADAPT=post: a two-pass encode whose corrections must decode,
    # on the 18 768x512 images cut to POST_SHAPE (one batch, 288 lanes)
    post = [imgs[i][:POST_SHAPE[0], :POST_SHAPE[1]] for i in land]
    saved = os.environ.get("HEVCE_ADAPT")
    os.environ["HEVCE_ADAPT"] = "post"
    try:
        timer = PhaseTimer()
        reset_launches()
        built0 = runners_built()
        t0 = time.perf_counter()
        s_post, r_post = wf.encode_many_fast(post, QPD6, batch=BATCH,
                                             timer=timer, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        if saved is None:
            os.environ.pop("HEVCE_ADAPT")
        else:
            os.environ["HEVCE_ADAPT"] = saved
    flagged, kept = timer.counts["adapt_flagged"], timer.counts["adapt_kept"]
    if not flagged:
        fail("HEVCE_ADAPT=post flagged no image")
    built = runners_built() - built0
    # a primary and a corrective pass, and the warm-up steps
    k1 = check_fronts("HEVCE_ADAPT=post", FRONT_LAUNCHES,
                      2 * fronts(post[0]) + built)["k1"]
    for i, (s, r) in enumerate(zip(s_post, r_post)):
        if not np.array_equal(native.decode_stream(s), r):
            fail(f"HEVCE_ADAPT=post stream {i} does not decode to its recon")
    res["post"] = {"images": len(post), "shape": list(post[0].shape),
                   "flagged": flagged, "kept": kept,
                   "dispatches": timer.counts["dispatch"], "wall_s": wall,
                   "k1_launches": k1, "runners_built": built, "decoded": len(s_post),
                   "phases_s": dict(timer.totals),
                   "cut": f"18 of the 24 images (the 6 768x512 ones are a "
                          f"second batch), each cut to {POST_SHAPE[0]}x"
                          f"{POST_SHAPE[1]}: 288 lanes kept, "
                          f"{fronts(post[0])} front steps a pass, not 54"}

    # encode_many_exact: hinted, byte-identical to the native engine
    two = [imgs[i][:EXACT_SHAPE[0], :EXACT_SHAPE[1]] for i in land[:2]]
    timer = PhaseTimer()
    reset_launches()
    built0 = runners_built()
    t0 = time.perf_counter()
    s_ex, r_ex = wf.encode_many_exact(two, QPD6, timer=timer, batch=BATCH,
                                      device=dev)
    wall = time.perf_counter() - t0
    built = runners_built() - built0
    k1 = check_fronts("the hints of encode_many_exact", FRONT_LAUNCHES,
                      fronts(two[0]) + built)["k1"]
    t0 = time.perf_counter()
    refs = [native.encode_image_native(im, QPD6) for im in two]
    native_s = time.perf_counter() - t0
    for i, (s, r) in enumerate(zip(s_ex, r_ex)):
        if s != refs[i][0] or not np.array_equal(r, refs[i][1]):
            fail(f"encode_many_exact image {i} differs from the native "
                 f"engine's encode")
    res["exact"] = {"images": len(two), "wall_s": wall,
                    "host_rdo_s": timer.totals["host_rdo"],
                    "phases_s": dict(timer.totals),
                    "k1_launches": k1, "runners_built": built,
                    "native_sequential_s": native_s,
                    "byte_identical": len(two), "shape": list(EXACT_SHAPE),
                    "cut": f"2 images cut to {EXACT_SHAPE[0]}x"
                           f"{EXACT_SHAPE[1]} ({fronts(two[0])} front steps "
                           f"of hints, not 54)"}
    emit(res)


# -------------------------------------------------------------------- spec

# the spec phase's golden images: the 32x32 ones at qpd6 0-4 and the
# 128x128 one at qpd6 2 (16 CTUs)
SPEC_IMAGES = (0, 1, 2, 3, 4, 22)


def spec_programs(dev):
    """the spec encoder's eval programs at QPD6 (one per (fn, sz)): warm-up,
    capture and instantiate seconds, graph nodes, pool GiB."""
    from hevce_tpu_torch.models import cu_eval, encoder

    rows = []
    for fn, sizes in ((cu_eval.eval_2nx2n, (4, 8, 16, 32)),
                      (cu_eval.eval_tusplit, (8, 16, 32))):
        for sz in sizes:
            prog = encoder._eval_program(fn, sz, QPD6, dev)
            rows.append(program_row(f"{fn.__name__} sz={sz}", prog))
    return rows


def phase_spec(torch, dev, card):
    """the Python spec encoder on the card against the golden streams and
    the native engine; K1's launches, K1 against its plain version at the
    path's own one-row calls, and its card ms per CTU."""
    from hevce_tpu_torch.models import encoder
    from hevce_tpu_torch.ops import fused_eval
    from hevce_tpu_torch.runtime import native
    from hevce_tpu_torch.utils.tracing import PhaseTimer

    g = np.load(ROOT / "tests" / "data" / "golden_images.npz")
    imgs = [(t, g[f"img_{t}"], int(g[f"qpd6_{t}"])) for t in SPEC_IMAGES]
    ctus = sum(-(-im.shape[0] // 32) * -(-im.shape[1] // 32)
               for _, im, _ in imgs)
    timer = PhaseTimer()
    reset_launches()
    since = captured()
    t0 = time.perf_counter()
    out = [encoder.encode_image(im, q, device=dev, timer=timer)
           for _, im, q in imgs]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fused_eval.LAUNCHES
    x_only_x1("the spec path")
    built = programs_built(since)
    w1 = warmup_launches(since)[0]
    if launches != sum(K1_PER_CTU.values()) * ctus + w1:
        fail(f"K1 launched {launches} times on the spec path, expected "
             f"{sum(K1_PER_CTU.values())} x {ctus} CTUs + {w1} in the "
             f"warm-up steps of the programs built ({dict(built)})")
    for (t, im, q), (s, r) in zip(imgs, out):
        if s != bytes(g[f"stream_{t}"]) or not np.array_equal(
                r, g[f"rcon_{t}"]):
            fail(f"spec encode of golden image {t} differs from the golden "
                 f"stream or recon")
        s_ref, r_ref = native.encode_image_native(im, q)
        if s != s_ref or not np.array_equal(r, r_ref):
            fail(f"spec encode of golden image {t} differs from the native "
                 f"engine's")

    # K1 at the path's own calls: each eval's inputs taken at evaluate() on
    # the 32x32 images (a replay calls no wrapper), then its plain cu_eval
    # function on them with K1's calls taken at the wrapper
    evals, evaluate = [], encoder._EncodeState.evaluate

    def taken_eval(st, fn, sz, *args):
        evals.append((fn, sz, st.qpd6, [np.array(a) for a in args]))
        return evaluate(st, fn, sz, *args)

    encoder._EncodeState.evaluate = taken_eval
    try:
        for t, im, q in imgs:
            if im.shape == (32, 32):
                encoder.encode_image(im, q, device=dev)
    finally:
        encoder._EncodeState.evaluate = evaluate
    calls, k1 = [], fused_eval.pipeline_sse

    def taken(sz, q, pred, blk):
        calls.append((sz, q, pred.clone(), blk.clone()))
        return k1(sz, q, pred, blk)

    fused_eval.pipeline_sse = taken
    try:
        with torch.no_grad():
            for fn, sz, q, args in evals:
                top, left, flags, orig = (torch.from_numpy(a).to(dev)
                                          for a in args)
                fn(sz, q, top, left, flags, orig)
    finally:
        fused_eval.pipeline_sse = k1
    seen = {}
    for sz, q, pred, blk in calls:
        seen[(sz, q)] = seen.get((sz, q), 0) + 1
        if tuple(pred.shape) != (35, sz, sz):
            fail(f"spec K1 call at sz={sz}: pred {tuple(pred.shape)}, "
                 f"expected one row (35, {sz}, {sz})")
    want = {(sz, q): n for sz, n in K1_PER_CTU.items() for q in range(5)}
    if seen != want:
        fail(f"the spec path's K1 calls on the 32x32 images were {seen}, "
             f"expected {want}")
    max_err = max(k1_compare(torch, sz, q, pred, blk, "at the spec path's "
                             "one-row calls") for sz, q, pred, blk in calls)
    rows = {}
    for sz, q, pred, blk in calls:
        if q == QPD6 and sz not in rows:
            rows[sz] = dict(k1_times(torch, sz, 35, 1, pred, blk),
                            per_ctu=K1_PER_CTU[sz])
    per_ctu = lambda key: sum(r["per_ctu"] * r[key] for r in rows.values())
    res = {"launches": launches, "ms_per_ctu": per_ctu("ms"),
           "bound_ms_per_ctu": per_ctu("bound_ms"),
           "tc_bound_ms_per_ctu": per_ctu("tc_bound_ms"),
           "call_ms_per_ctu": per_ctu("call_ms"),
           "plain_ms_per_ctu": per_ctu("plain_ms"), "max_abs_err": max_err}
    eval_s = timer.totals["device_eval"]
    emit({"phase": "spec", "card": card,
          "images": [[t, list(im.shape), q] for t, im, q in imgs],
          "ctus": ctus, "k1_launches": launches,
          "k1_launches_per_ctu": launches / ctus,
          "wall_s": wall, "wall_s_per_ctu": wall / ctus,
          "device_eval_s_per_ctu": eval_s / ctus,
          "host_trials_s_per_ctu": (wall - eval_s) / ctus,
          "device_evals": timer.counts["device_eval"],
          "programs_built": dict(built),
          "program_stats": spec_programs(dev),
          "byte_identical": len(imgs), "k1_checked": len(calls),
          "k1_max_abs_err": max_err,
          "k1_card_ms_per_ctu": res["ms_per_ctu"],
          "k1_call_ms_per_ctu": res["call_ms_per_ctu"],
          "k1_bound_ms_per_ctu": res["bound_ms_per_ctu"],
          "k1_tc_bound_ms_per_ctu": res["tc_bound_ms_per_ctu"],
          "k1_plain_ms_per_ctu": res["plain_ms_per_ctu"],
          "k1_shapes": sorted(rows.values(), key=lambda r: r["sz"]),
          "cut": "21 CTUs of the golden set in depth; the node shape is the "
                 "spec's own (one row of 35 candidates a call)"})
    return res


# --------------------------------------------------------------------- cli

def phase_cli(card):
    """python -m hevce_tpu_torch on a PGM of golden image 2, each engine."""
    from hevce_tpu_torch.runtime import native
    from hevce_tpu_torch.utils.imageio import read_pgm, write_pgm

    g = np.load(ROOT / "tests" / "data" / "golden_images.npz")
    work = ROOT / "build" / "chip_smoke_cli"
    work.mkdir(parents=True, exist_ok=True)
    src = work / "img.pgm"
    write_pgm(src, g["img_2"])
    runs = {}
    for engine in ("native", "python", "fast"):
        out, rcon = work / f"{engine}.h265", work / f"{engine}.pgm"
        for f in (out, rcon):
            f.unlink(missing_ok=True)
        flag = "--fast" if engine == "fast" else f"--engine={engine}"
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-m", "hevce_tpu_torch", str(src),
                            str(out), str(int(g["qpd6_2"])), str(rcon), flag],
                           cwd=ROOT, capture_output=True, text=True,
                           timeout=600)
        wall = time.perf_counter() - t0
        if r.returncode != 0:
            fail(f"cli --engine={engine}: rc {r.returncode}: "
                 f"{r.stdout[-1000:]} {r.stderr[-2000:]}")
        stream, recon = out.read_bytes(), read_pgm(rcon)
        if engine == "fast":
            if not np.array_equal(native.decode_stream(stream), recon):
                fail("cli --fast: the stream does not decode to its recon")
        elif stream != bytes(g["stream_2"]) or not np.array_equal(
                recon, g["rcon_2"]):
            fail(f"cli --engine={engine}: stream or recon differs from the "
                 f"golden one")
        runs[engine] = {"wall_s": wall, "bytes": len(stream),
                        "stdout": r.stdout.splitlines()}
    emit({"phase": "cli", "card": card, "image": "golden 2 (32x32, qpd6 2)",
          "runs": runs})


# -------------------------------------------------------------------- mesh

def phase_mesh(torch, dev, card):
    """entry() on the card against the CPU, the device step split over
    (dev, dev) against the unsplit step, and dryrun_multichip(2)."""
    from hevce_tpu_torch import entry
    from hevce_tpu_torch.ops import cabac_scan, fused_eval
    from hevce_tpu_torch.parallel import batch as pb

    fn, args = entry.entry()
    card_out = fn(*args)
    cpu_fn, cpu_args = entry.entry(device="cpu")
    for a, b in zip(card_out, cpu_fn(*cpu_args)):
        if not (a.is_cuda and torch.equal(a.cpu(), b)):
            fail("entry() on the card differs from the same step on the CPU")
    mesh = (dev, dev)
    step_s = {}
    for sz in (8, 32):
        nodes = pb.random_node_batch(sz, 4, seed=sz)
        got = pb.device_step_fn(sz, QPD6, mesh=mesh)(*nodes)
        want = pb.device_step_fn(sz, QPD6)(*(torch.from_numpy(a).to(dev)
                                             for a in nodes))
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            fail(f"the device step at sz={sz} over {mesh} differs from the "
                 f"unsplit step")
        # the device eval's seconds a call once its programs are built: the
        # mesh step from the host's arrays, the unsplit one from the card's
        on_card = [torch.from_numpy(a).to(dev) for a in nodes]
        for split, step, args in (
                ("mesh", pb.device_step_fn(sz, QPD6, mesh=mesh), nodes),
                ("unsplit", pb.device_step_fn(sz, QPD6), on_card)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(10):
                step(*args)
            torch.cuda.synchronize()
            step_s[f"sz{sz}_{split}"] = (time.perf_counter() - t0) / 10
    reset_launches()
    built0 = runners_built()
    since = captured()
    said = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(said):
        try:
            entry.dryrun_multichip(2)
        except AssertionError as e:
            fail(f"dryrun_multichip(2): {e}")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k1, k2 = fused_eval.LAUNCHES, cabac_scan.LAUNCHES
    built = runners_built() - built0
    w1, w2 = warmup_launches(since)
    # each of the two parts: the steps at sz 8 and 32 (5 launches each; the
    # unsplit steps they are held to 5 more each), the lockstep's 6 CTUs
    # with node rates on (21 node events of 5 K1 and one K2 launch, 64 PU
    # events of one each) and the fast mode's 12 front steps; the parts
    # share one slice runner, whose warm-up step runs once; each event
    # program built (one a part) runs its warm-up step
    want_k1 = (2 * (2 * 5 + 6 * (21 * 5 + 64) + 12 * LAUNCHES_PER_FRONT)
               + 2 * 5 + built * LAUNCHES_PER_FRONT + w1)
    want_k2 = 2 * 6 * (21 + 64) + w2
    if (k1, k2) != (want_k1, want_k2):
        fail(f"dryrun_multichip(2) launched K1 {k1} and K2 {k2} times, "
             f"expected {want_k1} and {want_k2}")
    # X1 once before each K1 launch but on the fast mode's front steps,
    # which launch X1-X4 FRONT_LAUNCHES times
    fast = 2 * 12 + built
    counts = port_launches()
    want_x = {x: FRONT_LAUNCHES[x] * fast for x in ("x2", "x3", "x4")}
    want_x["x1"] = k1 - fast * (FRONT_LAUNCHES["k1"] - FRONT_LAUNCHES["x1"])
    if {x: counts[x] for x in want_x} != want_x:
        fail(f"dryrun_multichip(2) launched {counts}, expected X1-X4 "
             f"{want_x}")
    emit({"phase": "mesh", "card": card, "mesh": [str(d) for d in mesh],
          "entry_equal_cpu": True, "steps_equal_unsplit": [8, 32],
          "dryrun_wall_s": wall, "dryrun": said.getvalue().splitlines(),
          "k1_launches": k1, "runners_built": built,
          "programs_built": dict(programs_built(since)),
          "k2_launches": k2, "launches": counts, "device_step_s": step_s,
          "device_step_basis": "host wall to a synchronize per "
                               "device_step_fn call at 4 rows, mean of 10 "
                               "(replays; mesh: two parts of 2 on one "
                               "card)"})
    return counts


# ------------------------------------------------------------------ probes

# the probes' arithmetic: P2's products and P3's transform stages run on the
# int8 tensor cores (1,979 TOP/s dense, data sheet); P3 splits each stage's
# wide operand into 2 (forward 1) or 3 (the other three) base-128 digits,
# each a 16 x 16 product per block. P3's int32 operations per coefficient
# outside the products: residual 1, four rounding shifts 8, two clip16 4,
# level0 8, three RD costs 3 x 15, two selections 4, sign 2, the kill 3,
# dequant 3, recon 3, SSE 3. K1's tensor-core floor counts the same: its
# stages' digits (2, 3, 3, 3) in sz x sz x sz products, and 84 int32
# operations per coefficient besides (the digit split's shift and mask per
# digit come on top, so the floor stays a floor).
INT8_TC_OPS_PER_S = 1979e12
P3_DIGIT_PRODUCTS = 2 + 3 + 3 + 3
P3_INT32_OPS_PER_COEF = 84
K1_DIGIT_PRODUCTS = P3_DIGIT_PRODUCTS
K1_INT32_OPS_PER_COEF = P3_INT32_OPS_PER_COEF


def bound(nbytes, ops):
    """(bound ms, bound_by): the larger of nbytes at HBM_BYTES_PER_S and
    each [(count, rate)] of operations at its rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = max(n / rate for n, rate in ops)
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def phase_probes(torch, dev, rng):
    """the probe tool as a user runs it (its launches counted from 0), then
    P1-P3 against their plain versions on the card (tolerance 0; P3 also
    against K1 at (4, 35), qpd6 0-4) and each probe's card, call, plain and
    library times beside its bound."""
    from hevce_tpu_torch.ops import fused_eval, probes
    from hevce_tpu_torch.tools import cuda_probe
    from hevce_tpu_torch.utils import timing

    for k in probes.LAUNCHES:
        probes.LAUNCHES[k] = 0
    lines = []
    t0 = time.perf_counter()
    try:
        res = cuda_probe.run(dev, out=lines.append)
    except cuda_probe.ProbeFailed as e:
        fail(f"cuda_probe: {e} ({lines})")
    tool_s = time.perf_counter() - t0
    launches = dict(probes.LAUNCHES)
    if not all(launches.values()):
        fail(f"the probe tool did not launch every probe kernel: {launches}")

    err, checked = dict.fromkeys(launches, 0), 0

    def held(name, where, got, want):
        nonlocal checked
        for g, w in zip(got, want):
            if g.dtype != w.dtype or g.shape != w.shape:
                fail(f"{name} {where}: {g.dtype}{tuple(g.shape)} vs "
                     f"{w.dtype}{tuple(w.shape)}")
            e = int((g.to(torch.int64) - w.to(torch.int64)).abs().max())
            err[name] = max(err[name], e)
            if e:
                fail(f"{name} differs {where}: max |err| {e}")
        checked += 1

    to = lambda a: torch.from_numpy(a).to(dev)
    x = to(rng.integers(-2**30, 2**30, cuda_probe.P1_SHAPE).astype(np.int32))
    want = probes.add_one_plain(x)
    held("add_one", "from its plain version", [probes.add_one(x)], [want])
    i8 = lambda v, s: np.full(s, v, np.int8)
    M, K, N = cuda_probe.P2_SHAPE
    cases = cuda_probe.p2_inputs(rng) + [
        ("127 x -128", i8(127, (M, K)), i8(-128, (K, N))),
        ("ragged (100, 48, 24)",
         rng.integers(-128, 128, (100, 48)).astype(np.int8),
         rng.integers(-128, 128, (48, 24)).astype(np.int8)),
        ("ragged (130, 33, 70)",
         rng.integers(-128, 128, (130, 33)).astype(np.int8),
         rng.integers(-128, 128, (33, 70)).astype(np.int8))]
    for case, a, b in cases:
        a, b = to(a), to(b)
        held("int8_mm", f"from its plain version ({case})",
             [probes.int8_mm(a, b)], [probes.int8_mm_plain(a, b)])
    one = to(rng.integers(-2**30, 2**30, 1).astype(np.int32))
    want = probes.add_one_plain(one)
    held("add_one", "at one element", [probes.add_one(one)], [want])
    # P3 at the probe's 512 rows, at 480 (a whole number of waves of 256
    # threads a 16-block tile, 8 tiles an SM), and at ragged tile counts:
    # 1 row (35 blocks, 3 tiles), 17 (595, the last tile 3 rows), 511
    for rows in (512, 480, 1, 17, 511):
        for qpd6 in range(5):
            pred, blk = (to(a) for a in cuda_probe.p3_inputs(rng, rows))
            got = probes.fused4(pred, blk, qpd6)
            held("fused4", f"from its plain version at {rows} rows, "
                 f"qpd6={qpd6}", got, probes.fused4_plain(pred, blk, qpd6))
            held("fused4", f"from K1 (4, 35) at {rows} rows, qpd6={qpd6}",
                 got, cuda_probe.via_k1(pred, blk, qpd6))

    x = torch.zeros(cuda_probe.P1_SHAPE, dtype=torch.int32, device=dev)
    a, b = (to(v) for v in cuda_probe.p2_inputs(rng)[0][1:])
    pred, blk = (to(v) for v in cuda_probe.p3_inputs(rng))
    coefs, nblk = pred.numel(), pred.numel() // 16
    specs = [
        ("add_one", "tools/pallas_probe.py:38", lambda: probes.add_one(x),
         lambda: probes.add_one_plain(x), lambda: x.add_(1),
         2 * 4 * x.numel(), [(x.numel(), INT32_OPS_PER_S)]),
        ("int8_mm", "tools/pallas_probe.py:76", lambda: probes.int8_mm(a, b),
         lambda: probes.int8_mm_plain(a, b), lambda: torch._int_mm(a, b),
         M * K + K * N + 4 * M * N, [(2 * M * K * N, INT8_TC_OPS_PER_S)]),
        ("fused4", "tools/pallas_probe.py:120",
         lambda: probes.fused4(pred, blk, QPD6),
         lambda: probes.fused4_plain(pred, blk, QPD6), None,
         coefs + blk.numel() + 4 * coefs + 4 * nblk,
         [(P3_DIGIT_PRODUCTS * nblk * 16 * 16 * 2, INT8_TC_OPS_PER_S),
          (P3_INT32_OPS_PER_COEF * coefs, INT32_OPS_PER_S)])]
    rows = {}
    for name, replaces, kern, plain, lib, nbytes, ops in specs:
        b_ms, by = bound(nbytes, ops)
        rows[name] = {
            "name": name, "replaces": replaces, "launches": launches[name],
            "max_abs_err": err[name], "ms": timing.card_ms(kern, 50),
            "call_ms": timing.cuda_ms(kern, 200),
            "plain_ms": timing.card_ms(plain, 5),
            "library_ms": timing.card_ms(lib, 50) if lib else None,
            "bound_ms": b_ms, "bound_by": by, "bytes": nbytes}
    p4, b4 = pred.view(-1, 35, 4, 4), blk.view(-1, 4, 4)    # K1, same inputs
    rows["fused4"]["k1_ms"] = timing.card_ms(
        lambda: fused_eval.pipeline_sse(4, QPD6, p4, b4), 50)
    p480, b480 = pred[:480].contiguous(), blk[:480].contiguous()
    rows["fused4"]["ms_480_rows"] = timing.card_ms(
        lambda: probes.fused4(p480, b480, QPD6), 50)
    # the card's least kernel: P1 at one element, one block of one thread
    one = torch.zeros(1, dtype=torch.int32, device=dev)
    rows["add_one"]["ms_one_element"] = timing.card_ms(
        lambda: probes.add_one(one), 50)
    # P2 at the busy shape, timed by the tool: tensor cores or bytes
    big = res["p2"]["large"]
    Ml, Kl, Nl = big["shape"]
    b_ms, by = bound(Ml * Kl + Kl * Nl + 4 * Ml * Nl,
                     [(2 * Ml * Kl * Nl, INT8_TC_OPS_PER_S)])
    rows["int8_mm"]["large"] = {
        "shape": big["shape"], "exact": big["exact"],
        "ms": big["card_us"] / 1e3, "library_ms": big["library_card_us"] / 1e3,
        "bound_ms": b_ms, "bound_by": by,
        "top_per_s": 2 * Ml * Kl * Nl / (big["card_us"] / 1e6) / 1e12}
    emit({"phase": "probes", "tool": lines, "tool_s": tool_s,
          "launches": launches, "checked": checked, "exact": True,
          "p1_us_per_launch": res["p1"],
          "p3_us_per_eval": res["p3"]["us_per_eval"],
          "library": {"add_one": "x.add_(1)", "int8_mm": "torch._int_mm",
                      "fused4": None},
          "kernels": list(rows.values())})
    return rows


# -------------------------------------------------------------------- main

def x_entry(x, row, err, counts, dense, mesh, lock_launches, spec_launches,
            replays):
    """X kernel x's entry of the closing kernels line: its launches on the
    main path (the slice phase's timed run), its card, call and plain ms
    and bound per RMD front step at 288 lanes (the xnode phase), its card
    ms a step in the graph phase's profiled replays, and the same for the
    dense step and, for X1, per lockstep and spec CTU."""
    _, _, kern, jax_at = X_KERNELS[x]
    st = row["step"]
    out = {"name": kern, "route": "cuda",
           "source": "hevce_tpu_torch/csrc/fused_node.cu",
           "replaces": jax_at,
           "replaces_note": X_REPLACES[x] + "; no Pallas kernel: it stands "
                            "for XLA's fusion of the JAX front step",
           "launches": counts[x], "max_abs_err": err,
           "ms": st["ms"], "plain_ms": st["plain_ms"],
           "bound_ms": st["bound_ms"], "bound_by": st["bound_by"],
           "library_ms": None, "call_ms": st["call_ms"],
           "launches_per_front": FRONT_LAUNCHES[x],
           "dense_launches": dense["x_launches"][x],
           "dense_launches_per_front": DENSE_FRONT_LAUNCHES[x],
           "mesh_launches": mesh[x],
           "replay_ms_per_front": replays["rmd"]["profile"]["port_kernels"]
           [x]["ms_per_step"],
           "dense_replay_ms_per_front": replays["dense"]["profile"]
           ["port_kernels"][x]["ms_per_step"]}
    if "dense_step" in row:
        out.update({f"dense_{k}_per_front": row["dense_step"][k]
                    for k in ("ms", "plain_ms", "bound_ms", "call_ms")})
    if x == "x1":
        out["lockstep_launches"], out["spec_launches"] = (lock_launches,
                                                          spec_launches)
        for path in ("lockstep", "spec"):
            out.update({f"{path}_{k}_per_ctu": row[f"{path}_ctu"][k]
                        for k in ("ms", "plain_ms", "bound_ms", "call_ms")})
    out["basis"] = (f"card time (CUDA events behind a spin kernel) of the "
                    f"{FRONT_LAUNCHES[x]} calls of one RMD front step of a "
                    f"768x512 batch of {BATCH} ({LANES} lanes), the plain "
                    f"version's (profiler) on the same inputs; "
                    f"call_ms includes the host's enqueue; launches count "
                    f"the slice phase's timed run, dense_* one dense step "
                    f"({DENSE_FRONT_LAUNCHES[x]} calls); replay_ms_per_front "
                    f"its card time a step in the graph phase's profiled "
                    f"replays (profiler); bound_ms the bytes and int32 "
                    f"operations each call's data needs (x_cost)"
                    + ("; lockstep_* / spec_* the 169 calls of one CTU at "
                       "18 rows / one row, launches over the lockstep runs "
                       "/ the spec phase" if x == "x1" else ""))
    return out


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

    from hevce_tpu_torch.ops import probes
    from hevce_tpu_torch.utils import timing

    took, t0 = {}, time.perf_counter()

    def timed(name, fn, *args):
        nonlocal t0
        out = fn(*args)
        took[name], t0 = time.perf_counter() - t0, time.perf_counter()
        return out

    timed("build", phase_build)
    # the probes run first, on a generator of their own: the later phases
    # see the same inputs as without them, and P1's CUDA-graph captures
    # precede every other profiler session of the process
    probe_rows = timed("probes", phase_probes, torch, dev,
                       np.random.default_rng([args.seed, 3]))
    max_err, shapes, k1_lock = timed("kernels", phase_kernels, torch, dev,
                                     rng)
    k2_err, k2_shapes_ = timed("k2", phase_k2, torch, dev, rng)
    for k in probes.LAUNCHES:          # the encode paths never run a probe
        probes.LAUNCHES[k] = 0
    counts, imgs, streams, recons, slice_mp_s = timed(
        "slice", phase_slice, torch, dev, rng, card)
    # X1-X4 on a generator of their own (the later phases' inputs stay)
    x_err, x_rows = timed("xnode", phase_xnode, torch, dev,
                          np.random.default_rng([args.seed, 13]), card, imgs)
    lock_k1, lock_k2 = timed("lockstep", phase_lockstep, torch, dev, rng,
                             card)
    timed("profile", phase_profile, torch, dev, rng)
    timed("identity", phase_identity, dev)
    dense = timed("dense", phase_dense, torch, dev, card, imgs, shapes)
    timed("surface", phase_surface, torch, dev,
          np.random.default_rng([args.seed, 7]), card, imgs, streams, recons)
    replays = timed("graph", phase_graph, torch, dev, card, imgs, slice_mp_s)
    spec = timed("spec", phase_spec, torch, dev, card)
    timed("cli", phase_cli, card)
    mesh = timed("mesh", phase_mesh, torch, dev, card)
    encode_probe_launches = dict(probes.LAUNCHES)
    emit({"phase": "seconds", **took})
    emit({"phase": "timing", "lost_profiler_sessions": timing.LOST_SESSIONS})

    print(card, flush=True)

    per_front = lambda key, keep=lambda s: True: sum(
        s["per_front"] * s[key] for s in shapes if keep(s))
    per_ctu = lambda key, keep=lambda s: True, rows=k2_shapes_: sum(
        s["per_ctu"] * s[key] for s in rows if keep(s))
    t_bound = per_front("bound_ms")
    by_ops = per_front("bound_ms", lambda s: s["bound_by"] == "operations")
    tc_bound = per_front("tc_bound_ms")
    emit({"kernels": [{
        "name": "fused_eval", "route": "cuda",
        "source": "hevce_tpu_torch/csrc/fused_eval.cu",
        "replaces": "hevce_tpu/ops/fused_eval.py:255",
        "launches": counts["k1"],
        "max_abs_err": max(max_err, dense["max_abs_err"],
                           spec["max_abs_err"]),
        "ms": per_front("ms"), "plain_ms": per_front("plain_ms"),
        "bound_ms": t_bound,
        "bound_by": "operations" if by_ops * 2 > t_bound else "bytes",
        "library_ms": None, "call_ms": per_front("call_ms"),
        "tc_bound_ms": tc_bound,
        "tc_bound_by": "operations" if per_front(
            "tc_bound_ms", lambda s: s["tc_bound_by"] == "operations") * 2
        > tc_bound else "bytes",
        "lockstep_launches": lock_k1,
        "lockstep_ms_per_ctu": per_ctu("ms", rows=k1_lock),
        "lockstep_bound_ms_per_ctu": per_ctu("bound_ms", rows=k1_lock),
        "lockstep_tc_bound_ms_per_ctu": per_ctu("tc_bound_ms", rows=k1_lock),
        "dense_launches": dense["launches"],
        "dense_ms_per_front": dense["ms_per_front"],
        "dense_bound_ms_per_front": dense["bound_ms_per_front"],
        "dense_tc_bound_ms_per_front": dense["tc_bound_ms_per_front"],
        "dense_plain_ms_per_front": dense["plain_ms_per_front"],
        "spec_launches": spec["launches"],
        "spec_ms_per_ctu": spec["ms_per_ctu"],
        "spec_bound_ms_per_ctu": spec["bound_ms_per_ctu"],
        "spec_tc_bound_ms_per_ctu": spec["tc_bound_ms_per_ctu"],
        "spec_plain_ms_per_ctu": spec["plain_ms_per_ctu"],
        "mesh_launches": mesh["k1"],
        "basis": f"card time of one front step of a 768x512 batch of "
                 f"{BATCH} ({LAUNCHES_PER_FRONT} launches, {LANES} lanes); "
                 f"call_ms includes the host's enqueue; bound_ms with the "
                 f"transforms as int32 multiply-adds, tc_bound_ms as int8 "
                 f"tensor-core digit products; lockstep_* per CTU "
                 f"of the lockstep path at {BATCH} rows, launches over its "
                 f"three runs; dense_* per front step of the dense path "
                 f"(rmd=None, {DENSE_LAUNCHES_PER_FRONT} launches at (sz, 35)"
                 f" and {LANES} lanes), launches over its run; spec_* per "
                 f"CTU of the Python spec encoder (169 launches at one row "
                 f"of 35), launches over its 21 CTUs; mesh_launches over "
                 f"dryrun_multichip(2)"}, {
        "name": "cabac_scan", "route": "cuda",
        "source": "hevce_tpu_torch/csrc/cabac_scan.cu",
        "replaces": "hevce_tpu/ops/cabac_pallas.py:190",
        "launches": lock_k2, "max_abs_err": k2_err,
        "ms": per_ctu("ms"), "plain_ms": per_ctu("plain_ms"),
        "bound_ms": per_ctu("bound_ms"),
        "bound_by": "operations" if per_ctu(
            "bound_ms", lambda s: s["bound_by"] == "operations") * 2
        > per_ctu("bound_ms") else "bytes",
        "library_ms": None, "call_ms": per_ctu("call_ms"),
        "kernel_ms": per_ctu("kernel_ms"),
        "ns_per_op": {s["shape"]: s["ns_per_op"] for s in k2_shapes_},
        "mesh_launches": mesh["k2"],
        "basis": f"one CTU of the lockstep path with node_rates on at a "
                 f"batch of {BATCH} ({PU_PER_CTU} PU launches at 630 lanes, "
                 f"21 node launches at 1260 lanes), on op strings of "
                 f"synthetic blocks; ms the wrapper's card time (K2 and its "
                 f"stack of the scalars), kernel_ms K2's alone; ns_per_op "
                 f"per call over its longest lane; launches count the three "
                 f"lockstep runs, mesh_launches the mesh lockstep encode of "
                 f"dryrun_multichip(2)"}] + [
        dict(r, route="cuda", source="hevce_tpu_torch/csrc/probes.cu",
             encode_launches=encode_probe_launches[r["name"]],
             basis="one call at the probe's shape; launches count the run "
                   "of the probe tool (python -m hevce_tpu_torch.tools."
                   "cuda_probe), this kernel's path; encode_launches its "
                   "launches on the fast and lockstep paths")
        for r in probe_rows.values()] + [
        x_entry(x, x_rows[x], x_err[x], counts, dense, mesh, lock_k1,
                spec["launches"], replays) for x in X_KERNELS]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
