"""Tests of the port that need an NVIDIA GPU. They skip without one.

This file imports neither jax nor the JAX package, so it also runs on a
machine that has only PyTorch for CUDA (tests/conftest.py imports jax, so
skip it there):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""
import json
import pathlib
import re
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from hevce_tpu_torch.models import encoder
from hevce_tpu_torch.models import wavefront as wf
from hevce_tpu_torch.ops import (cabac_scan, cabac_sim, coef_ops, fused_eval,
                                 fused_node, probes)
from hevce_tpu_torch.parallel import batch as pb
from hevce_tpu_torch.parallel import lockstep
from hevce_tpu_torch.runtime import native
from hevce_tpu_torch.tools import (bench_fused, bench_k2, cuda_probe,
                                   profile_front)
from hevce_tpu_torch.utils import graphs, timing
from hevce_tpu_torch.utils.imageio import write_pgm
from hevce_tpu_torch.utils.tracing import CARD, PhaseTimer, device_trace

ROOT = pathlib.Path(__file__).resolve().parent.parent

SHAPES = [(4, 35), (4, 4), (8, 4), (8, 12), (16, 4), (16, 12),
          (32, 4), (32, 12), (8, 35), (16, 35), (32, 35), (4, 3)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K1, K2 and P1-P3 are CUDA kernels "
                    "with no CPU mode")
    return torch.device("cuda")


# K1 and K2 launches of one step of each kind of event program: what its
# eager warm-up step launched when it was built
WARMUP = {"node": (5, 0), "node_rates": (5, 1), "pu": (1, 1), "gather": (0, 0),
          "eval_2nx2n": (1, 0), "eval_tusplit": (4, 0)}


def _warmups(since):
    """(K1, K2) launches of the warm-up steps of the programs captured
    since graphs.CAPTURED[since]."""
    steps = graphs.CAPTURED[since:]
    return (sum(WARMUP[s.kind][0] for s in steps),
            sum(WARMUP[s.kind][1] for s in steps))


def _inputs(sz, M, qpd6, lanes=37):
    rng = np.random.default_rng(sz * 100 + M + qpd6)
    pred = rng.integers(0, 256, (lanes, M, sz, sz)).astype(np.uint8)
    blk = rng.integers(0, 256, (lanes, sz, sz)).astype(np.uint8)
    pred[0], blk[0] = 0, 255
    pred[1], blk[1] = 255, 0
    near = blk[2:lanes // 2, None].astype(np.int32) + rng.integers(
        -6, 7, (lanes // 2 - 2, M, sz, sz))
    pred[2:lanes // 2] = np.clip(near, 0, 255)
    return torch.from_numpy(pred), torch.from_numpy(blk)


@pytest.mark.cuda
@pytest.mark.parametrize("qpd6", range(5))
def test_k1_kernel_matches_plain_on_card(cuda_device, qpd6):
    for sz, M in SHAPES:
        pred, blk = (t.to(cuda_device) for t in _inputs(sz, M, qpd6))
        n0 = fused_eval.LAUNCHES
        got = fused_eval.pipeline_sse(sz, qpd6, pred, blk)
        torch.cuda.synchronize()
        assert fused_eval.LAUNCHES == n0 + 1
        want = fused_eval.pipeline_sse_plain(sz, qpd6, pred, blk)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and torch.equal(g, w), (sz, M, qpd6)


@pytest.mark.cuda
def test_k1_rejects_what_it_does_not_take(cuda_device):
    pred = torch.zeros((2, 3, 8, 8), dtype=torch.uint8, device=cuda_device)
    blk = torch.zeros((2, 8, 8), dtype=torch.uint8, device=cuda_device)
    with pytest.raises(TypeError):
        fused_eval.pipeline_sse(8, 2, pred.to(torch.int32), blk)
    with pytest.raises(ValueError, match="contiguous"):
        fused_eval.pipeline_sse(8, 2, pred.transpose(-1, -2), blk)
    with pytest.raises(ValueError, match="unsupported"):
        fused_eval.pipeline_sse(8, 5, pred, blk)


def _runners():
    """slice runners built so far in this process (each on the card ran one
    eager warm-up step, and each on the CPU none)."""
    return wf._slice_runner_cache.cache_info().currsize


@pytest.mark.cuda
def test_card_records_equal_cpu_records(cuda_device):
    rng = np.random.default_rng(5)
    noise = rng.integers(0, 256, (64, 96)).astype(np.uint8)
    yy, xx = np.mgrid[0:64, 0:96]
    smooth = ((yy * 2 + xx) % 256).astype(np.uint8)
    bufs = []
    n0, built0 = fused_eval.LAUNCHES, _runners()
    for dev in (cuda_device, "cpu"):
        out, meta = wf._dispatch_batch([noise, smooth], 2, device=dev)
        wf._fetch_lean(out, meta, PhaseTimer())
        bufs.append(out.numpy().tobytes())
        if dev is cuda_device:      # a runner built here ran one eager
            warm = _runners() - built0          # warm-up step on the card
    assert fused_eval.LAUNCHES - n0 == 169 * (2 * (2 - 1) + 3 + warm)
    assert bufs[0] == bufs[1]


@pytest.mark.cuda
def test_dense_card_records_equal_cpu_records(cuda_device):
    """rmd=None: K1 launches 153 times per front step on the card, and the
    records equal the CPU's."""
    rng = np.random.default_rng(6)
    imgs = [rng.integers(0, 256, (64, 96)).astype(np.uint8),
            rng.integers(100, 140, (64, 96)).astype(np.uint8)]
    bufs = []
    n0, built0 = fused_eval.LAUNCHES, _runners()
    for dev in (cuda_device, "cpu"):
        out, meta = wf._dispatch_batch(imgs, 2, None, device=dev)
        wf._fetch_lean(out, meta, PhaseTimer())
        bufs.append(out.numpy().tobytes())
        if dev is cuda_device:      # a runner built here ran one eager
            warm = _runners() - built0          # warm-up step on the card
    assert fused_eval.LAUNCHES - n0 == 153 * (2 * (2 - 1) + 3 + warm)
    assert bufs[0] == bufs[1]


@pytest.mark.cuda
def test_full_records_on_card_equal_cpu(cuda_device):
    """fetch_qc=True at qpd6=0 (levels escape int8): the buffer, side
    array, int16 sideband and recon plane equal the CPU's, and the streams
    equal the lean path's."""
    rng = np.random.default_rng(8)
    imgs = [rng.integers(0, 256, (64, 96)).astype(np.uint8),
            rng.integers(0, 256, (64, 96)).astype(np.uint8)]
    got = []
    for dev in (cuda_device, "cpu"):
        out, meta = wf._dispatch_batch(imgs, 0, device=dev, fetch_qc=True)
        got.append([out[0].numpy(), out[1].numpy(), out[2].cpu().numpy(),
                    out[3].numpy()])
    for g, w in zip(*got):
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes()
    assert got[0][1][:, 1].all()
    full, full_r = wf.encode_batch_fast(imgs, 0, device=cuda_device,
                                        fetch_qc=True)
    lean, lean_r = wf.encode_batch_fast(imgs, 0, device=cuda_device)
    assert full == lean
    for r, lr in zip(full_r, lean_r):
        assert np.array_equal(r, lr)


@pytest.mark.cuda
def test_exact_and_post_on_card(cuda_device, monkeypatch):
    """encode_many_exact's hints from the card give the native engine's
    streams; HEVCE_ADAPT=post gives the CPU's streams."""
    rng = np.random.default_rng(9)
    yy, xx = np.mgrid[0:64, 0:96]
    imgs = [rng.integers(0, 256, (64, 96)).astype(np.uint8),
            ((yy * 2 + xx) % 256).astype(np.uint8)]
    s, r = wf.encode_many_exact(imgs, 2, device=cuda_device)
    for i, im in enumerate(imgs):
        ref = native.encode_image_native(im, 2)
        assert s[i] == ref[0] and np.array_equal(r[i], ref[1])
    monkeypatch.setenv("HEVCE_ADAPT", "post")
    timer = PhaseTimer()
    card = wf.encode_many_fast(imgs, 2, timer=timer, device=cuda_device)
    assert timer.counts["adapt_flagged"] == 1
    assert card[0] == wf.encode_many_fast(imgs, 2, device="cpu")[0]


@pytest.mark.cuda
def test_card_seconds_of_each_batch_from_cuda_events(cuda_device):
    """each fetched batch adds its card seconds (a timing event before its
    uploads to its records' copy) to the timer's CARD total: more than 0 and
    no more than the call's wall; a mesh keeps the spans and no card time."""
    rng = np.random.default_rng(15)
    imgs = [rng.integers(0, 256, (64, 96)).astype(np.uint8) for _ in range(3)]
    wf.encode_many_fast(imgs, 2, batch=2, device=cuda_device)   # captures
    torch.cuda.synchronize()
    timer = PhaseTimer(spans=[])
    t0 = time.perf_counter()
    wf.encode_many_fast(imgs, 2, batch=2, timer=timer, device=cuda_device)
    wall = time.perf_counter() - t0
    assert 0 < timer.totals[CARD] <= wall and timer.counts[CARD] == 2
    names = [s[0] for s in timer.spans]
    assert names.count("upload") == names.count("enqueue") == 2
    assert len({s[4] for s in timer.spans}) == 2
    mesh = PhaseTimer(spans=[])
    wf.encode_many_fast(imgs[:2], 2, timer=mesh,
                        mesh=(cuda_device, cuda_device))
    assert CARD not in mesh.totals and "enqueue" in mesh.totals


@pytest.mark.cuda
def test_pooled_pack_on_card_equals_serial(cuda_device, monkeypatch):
    """encode_many_fast at batch 8 on the card packs the batch's images on
    the host's pool of threads, and gives the streams and recons of a run
    forced to pack them one after another on the calling thread."""
    rng = np.random.default_rng(16)
    yy, xx = np.mgrid[0:64, 0:96]
    imgs = [rng.integers(0, 256, (64, 96)).astype(np.uint8) for _ in range(6)]
    imgs += [((yy * 3 + xx * 2) % 256).astype(np.uint8),
             np.full((64, 96), 128, np.uint8)]
    timer = PhaseTimer()
    pooled = wf.encode_many_fast(imgs, 2, batch=8, timer=timer,
                                 device=cuda_device)
    assert timer.counts["pack_pooled"] == (8 if wf._pack_width(8) > 1 else 0)
    monkeypatch.setattr(wf, "_pack_width", lambda n: 1)
    timer = PhaseTimer()
    serial = wf.encode_many_fast(imgs, 2, batch=8, timer=timer,
                                 device=cuda_device)
    assert timer.counts["pack_pooled"] == 0
    assert pooled[0] == serial[0]
    for a, b in zip(pooled[1], serial[1]):
        assert np.array_equal(a, b)


def _k2_inputs(lanes, L, P, seed, strings="mixed", qpd6=None):
    """op strings over a P-slot palette, nop-padded past each lane's count
    (lane 0 has none, lane 1 all L): "mixed" random kinds plus runs of
    all-ones and all-zero bypass chunks; "one_slot" context bins that all
    hit slot P - 1 (each forwards its new value to the next); "alternating"
    context bins on two slots in turn; "bypass" bypass runs only."""
    rng = np.random.default_rng(seed)
    kind = rng.integers(0, 3, (lanes, L))
    bins = rng.integers(0, 2, (lanes, L)) << 10
    ctx = cabac_sim.KIND_CTX | (rng.integers(0, P, (lanes, L)) << 2) | bins
    n = rng.integers(1, 9, (lanes, L))
    byp = (cabac_sim.KIND_BYPASS | (n << 2)
           | ((rng.integers(0, 256, (lanes, L)) & ((1 << n) - 1)) << 6))
    term = cabac_sim.KIND_TERM | ((rng.random((lanes, L)) < 0.05) << 10)
    if strings == "mixed":
        ops = np.where(kind == 0, ctx, np.where(kind == 1, byp, term))
        ops[:lanes // 4] = cabac_sim.pack_bypass(0xFF, 8)
        ops[lanes // 4:lanes // 2:2] = cabac_sim.pack_bypass(0, 8)
    elif strings == "one_slot":
        ops = cabac_sim.KIND_CTX | ((P - 1) << 2) | bins
    elif strings == "alternating":
        two = np.where(np.arange(L) % 2 == 0, 0, P - 1)
        ops = cabac_sim.KIND_CTX | (two[None, :] << 2) | bins
    else:
        assert strings == "bypass"
        ops = byp
    nops = rng.integers(0, L + 1, lanes)
    nops[:2] = 0, L
    ops[np.arange(L)[None, :] >= nops[:, None]] = cabac_sim.KIND_NOP
    state = cabac_sim.initial_state(
        lanes, int(seed) % 5 if qpd6 is None else qpd6)
    state["ctxs"] = state["ctxs"][:, :P].contiguous()
    return state, torch.from_numpy(ops.astype(np.int32)), \
        torch.from_numpy(nops.astype(np.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("lanes,L,P,strings,qpd6", [
    (630, 256, 39, "mixed", None), (1260, 768, 69, "mixed", None),
    (1260, 2048, 67, "mixed", None), (37, 100, 142, "mixed", None),
    (630, 256, 39, "one_slot", 0), (70, 300, 59, "one_slot", 4),
    (1260, 768, 69, "alternating", 4), (33, 200, 2, "alternating", 0),
    (70, 300, 39, "bypass", 0), (33, 64, 67, "mixed", 0),
    (95, 129, 39, "mixed", 4)])
def test_k2_kernel_matches_plain_on_card(cuda_device, lanes, L, P, strings,
                                         qpd6):
    state, ops, nops = _k2_inputs(lanes, L, P, lanes + L + P, strings, qpd6)
    dstate = {k: v.to(cuda_device) for k, v in state.items()}
    n0 = cabac_scan.LAUNCHES
    got = cabac_scan.advance_rates(dstate, ops.to(cuda_device),
                                   nops.to(cuda_device), want_ctxs=True)
    torch.cuda.synchronize()
    assert cabac_scan.LAUNCHES == n0 + 1
    want = cabac_scan.scan_plain(state, ops, nops)
    for k in cabac_sim.FIELDS + ("ctxs",):
        assert torch.equal(got[k].cpu(), want[k]), k


@pytest.mark.cuda
def test_k2_tool_on_card(cuda_device):
    """bench_k2 holds K2 against the plain version at the four lockstep
    shapes and times it (ns per op of the longest lane), and its diagnostic
    strings too. It runs as its own process, as a user runs it: its ~50
    profiler sessions stay out of this one's."""
    r = subprocess.run(
        [sys.executable, "-m", "hevce_tpu_torch.tools.bench_k2", "--diag"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    res = json.loads(r.stdout.splitlines()[-1])
    assert res["max_abs_err"] == 0
    assert res["checked"] == 4 * 3 + len(bench_k2.DIAG_KINDS)
    assert [s["shape"] for s in res["shapes"]] == ["pu", "node8", "node16",
                                                   "node32"]
    assert all(0 < s["empty_ms"] < s["ms"] and s["kernel_ms"] > 0
               and s["ns_per_op"] > 0 for s in res["shapes"])
    assert set(res["diag"]) == set(bench_k2.DIAG_KINDS)
    assert res["ptxas"] and not any(
        re.search(r"\b[1-9]\d* bytes spill", ln) for ln in res["ptxas"])
    assert res["sass"]["FLO"] > 0


@pytest.mark.cuda
def test_put_coef_rates_on_card_equal_cpu(cuda_device):
    rng = np.random.default_rng(3)
    for sz in (4, 8, 16, 32):
        blk = np.where(rng.random((70, sz, sz)) < 0.3,
                       rng.integers(-60, 61, (70, sz, sz)), 0)
        blk[0] = 32767
        pm = torch.from_numpy(rng.integers(0, 35, 70).astype(np.int32))
        cpu = coef_ops.put_coef_rates(sz, 2, pm, torch.from_numpy(blk))
        card = coef_ops.put_coef_rates(sz, 2, pm.to(cuda_device),
                                       torch.from_numpy(blk).to(cuda_device))
        for a, b in zip(card, cpu):
            assert torch.equal(a.cpu(), b), sz


@pytest.mark.cuda
@pytest.mark.parametrize("node_rates,pipeline", [(False, False), (True, True)])
def test_lockstep_on_card_matches_native(cuda_device, node_rates, pipeline):
    rng = np.random.default_rng(7)
    imgs = [rng.integers(0, 256, (32, 64)).astype(np.uint8) for _ in range(2)]
    k1, k2 = fused_eval.LAUNCHES, cabac_scan.LAUNCHES
    since = len(graphs.CAPTURED)
    streams, rcons = lockstep.encode_batch(imgs, 2, node_rates=node_rates,
                                           pipeline=pipeline,
                                           device=cuda_device)
    runs = 2 if pipeline else 1
    node, pu = 21 * 2 * runs, 64 * 2 * runs          # two CTUs per image
    w1, w2 = _warmups(since)          # the programs this call built
    assert fused_eval.LAUNCHES - k1 == 5 * node + pu + w1
    assert cabac_scan.LAUNCHES - k2 == pu + (node if node_rates else 0) + w2
    for im, s, r in zip(imgs, streams, rcons):
        s_ref, r_ref = native.encode_image_native(im, 2)
        assert s == s_ref
        assert np.array_equal(r, r_ref)


@pytest.mark.cuda
def test_lockstep_card_seconds_of_each_event_from_cuda_events(cuda_device):
    """with a timer, every node, PU, winner-gather and full-fetch event adds
    its card seconds (a timing event after its rows' load, or before a full
    fetch's copies, to one after its results' copies) to the CARD total:
    more than 0 and no more than the call's wall, the same streams as
    untimed; pipeline halves add none."""
    rng = np.random.default_rng(24)
    imgs = [rng.integers(0, 256, (32, 64)).astype(np.uint8) for _ in range(2)]
    plain, _ = lockstep.encode_batch(imgs, 2, device=cuda_device)  # builds
    timer = PhaseTimer()
    t0 = time.perf_counter()
    streams, _ = lockstep.encode_batch(imgs, 2, timer=timer,
                                       device=cuda_device)
    wall = time.perf_counter() - t0
    assert streams == plain
    assert 0 < timer.totals[CARD] <= wall
    events = 2 * (21 + 64)                               # two CTU steps
    assert timer.counts[CARD] == (events + timer.counts["fetch_winner"]
                                  + timer.counts["fetch_full"])
    assert 0 < timer.totals["card_wait"] <= timer.totals["writeback"] + \
        timer.totals["winner_fetch"]
    halves = PhaseTimer()
    lockstep.encode_batch(imgs, 2, timer=halves, pipeline=True,
                          device=cuda_device)
    assert CARD not in halves.totals and "card_wait" in halves.totals


# -------------------------------------- spec encoder, device step, mesh

@pytest.mark.cuda
def test_spec_encoder_on_card_equals_golden(cuda_device):
    g = np.load(ROOT / "tests" / "data" / "golden_images.npz")
    k1 = fused_eval.LAUNCHES
    since = len(graphs.CAPTURED)
    stream, rcon = encoder.encode_image(g["img_2"], int(g["qpd6_2"]),
                                        device=cuda_device)
    # one CTU, and a warm-up step for each program this call built
    assert fused_eval.LAUNCHES - k1 == 169 + _warmups(since)[0]
    assert stream == bytes(g["stream_2"])
    assert np.array_equal(rcon, g["rcon_2"])


@pytest.mark.cuda
@pytest.mark.parametrize("sz,n", [(8, 4), (32, 2)])
def test_device_step_on_card_equals_cpu(cuda_device, sz, n):
    args = pb.random_node_batch(sz, n, seed=sz)
    cpu = pb.device_step_fn(sz, 2)(*args)
    card = pb.device_step_fn(sz, 2)(*(torch.from_numpy(a).to(cuda_device)
                                      for a in args))
    mesh = pb.device_step_fn(sz, 2, mesh=(cuda_device, cuda_device))(*args)
    for a, b, c in zip(card, mesh, cpu):
        assert a.is_cuda and b.is_cuda
        assert torch.equal(a.cpu(), c) and torch.equal(b.cpu(), c)


# ------------------------------------------------ the lockstep event programs

def _event_arrays(sz, B, seed, rates):
    """a node (sz > 4) or PU event's request rows as the engine lays them
    out (int32; flags 0/1) and, with rates, live coder forks after random
    bins (state7, ctxs, meta)."""
    from hevce_tpu_torch.bitstream import cabac as cb

    rng = np.random.default_rng(seed)
    arrays = [rng.integers(0, 256, (B, 1 + 2 * sz)),
              rng.integers(0, 256, (B, 2 * sz)),
              (rng.random((B, 4)) < 0.6), rng.integers(0, 256, (B, sz, sz))]
    if rates:
        state, ctxs = [], []
        for _ in range(B):
            enc, c = cb.CabacEncoder(), cb.new_context_set(2)
            for _ in range(int(rng.integers(0, 300))):
                if rng.random() < 0.7:
                    enc.encode_bin(c, int(rng.integers(0, 142)),
                                   int(rng.integers(0, 2)))
                else:
                    enc.encode_bypass(int(rng.integers(0, 256)),
                                      int(rng.integers(1, 9)))
            state.append([enc.range, enc.low, enc.nbits, enc.outstanding,
                          enc.bufbyte, enc.zrun, len(enc.buf)])
            ctxs.append(np.frombuffer(bytes(c), np.uint8))
        arrays += [np.array(state), np.stack(ctxs),
                   np.stack([rng.integers(0, 35, B), rng.integers(0, 35, B),
                             rng.integers(0, 2, B), rng.integers(0, 2, B)],
                            1)]
    return [np.asarray(a).astype(np.int32) for a in arrays]


def _plain_event(sz, qpd6, rates, arrays, dev):
    """the plain step of an event on dev (flags as bool)."""
    t = [torch.from_numpy(a).to(dev) for a in arrays]
    t[2] = t[2] != 0
    with torch.no_grad():
        if sz == 4:
            return lockstep._pu_step(qpd6, *t)
        if rates:
            return lockstep._node_step(sz, qpd6, *t)
        return pb.device_step(sz, qpd6, *t)


def _replayed_event(sz, qpd6, rates, arrays, sel, dev, slot):
    """an event's program and its winner gather on dev: (outputs, gathered
    rows) as host arrays, and the two programs."""
    B = arrays[0].shape[0]
    prog = (lockstep._pu_program(qpd6, B, dev, slot) if sz == 4 else
            lockstep._node_program(sz, qpd6, B, rates, dev, slot))
    with torch.no_grad():
        prog.load(arrays)
        out = [t.cpu().numpy() for t in prog()]
        gather = lockstep._gather_program(prog)
        gather.load([sel])
        rows = [t.cpu().numpy() for t in gather()]
    return out, rows, prog, gather


EVENTS = [(sz, rates) for sz in (8, 16, 32) for rates in (False, True)] + [
    (4, False)]


@pytest.mark.cuda
def test_full_fetch_copies_candidates_into_pinned_buffers(cuda_device):
    """a full fetch (Program.start_copy of _candidate_idx) copies a node and
    a PU program's candidates into pinned buffers of their own, the same
    buffers for the next event, equal to the outputs once wait() returns."""
    dev = torch.device("cuda", torch.cuda.current_device())
    for sz in (4, 16):
        seen = None
        for event in range(2):
            arrays = _event_arrays(sz, 3, 50 * sz + event, False)
            _, _, prog, _ = _replayed_event(
                sz, 2, False, arrays, np.array([0, 1, -1], np.int32), dev,
                ("test_full", 0))
            idx = lockstep._candidate_idx(prog)
            host = prog.start_copy(idx)
            prog.wait()
            assert all(prog._copies[idx][k].is_pinned()
                       for k in range(len(idx)))
            for h, i in zip(host, idx):
                assert h.tobytes() == prog.out[i].cpu().numpy().tobytes()
            ptrs = [h.ctypes.data for h in host]
            assert seen is None or ptrs == seen
            seen = ptrs


@pytest.mark.cuda
@pytest.mark.parametrize("qpd6", [0, 2, 4])
def test_event_programs_replay_their_plain_steps(cuda_device, qpd6):
    """every node (sz 8 / 16 / 32, rates on and off) and PU program, with
    its winner gather, replayed on the card for two events with different
    inputs: byte for byte the plain step on the card and the same program
    on the CPU (tolerance 0)."""
    dev = torch.device("cuda", torch.cuda.current_device())
    cpu = torch.device("cpu")
    for sz, rates in EVENTS:
        for event in range(2):
            arrays = _event_arrays(sz, 3, 100 * sz + 10 * event + qpd6, rates)
            layouts = 1 if sz == 4 else 2
            sel = np.array([3, 35 * layouts - 1, -1 - event], np.int32)
            got, rows, prog, gather = _replayed_event(
                sz, qpd6, rates, arrays, sel, dev, ("test", 0))
            assert prog.run.graph is not None
            assert gather.run.graph is not None
            on_cpu, cpu_rows, _, _ = _replayed_event(
                sz, qpd6, rates, arrays, sel, cpu, ("test", 0))
            plain = _plain_event(sz, qpd6, rates, arrays, dev)
            qs, rs = lockstep._candidates(prog)
            want_rows = lockstep._gather_winners(
                qs, rs, torch.from_numpy(sel).to(dev))
            for g, c, p in zip(got, on_cpu, plain):
                assert g.tobytes() == c.tobytes() == p.cpu().numpy().tobytes(
                ), (sz, rates, event)
            for g, c, p in zip(rows, cpu_rows, want_rows):
                assert g.tobytes() == c.tobytes() == p.cpu().numpy().tobytes(
                ), (sz, rates, event)


@pytest.mark.cuda
def test_lockstep_counts_hold_the_kernels_the_card_ran(cuda_device):
    """once its programs are built, a one-CTU lockstep call with node rates
    replays them only: K1 and K2 count 169 and 85 launches, and a profiled
    call holds them all (complete)."""
    rng = np.random.default_rng(21)
    imgs = [rng.integers(0, 256, (32, 32)).astype(np.uint8)
            for _ in range(3)]                      # a batch of its own

    def encode():
        return lockstep.encode_batch(imgs, 2, node_rates=True,
                                     device=cuda_device)
    encode()
    since = len(graphs.CAPTURED)
    k1, k2 = fused_eval.LAUNCHES, cabac_scan.LAUNCHES
    streams, _ = encode()
    assert len(graphs.CAPTURED) == since            # replays only
    assert (fused_eval.LAUNCHES - k1, cabac_scan.LAUNCHES - k2) == (169, 85)
    kernels, complete = timing.card_kernels(encode)
    card = {tag: sum(n for k, _, n in kernels if tag in k)
            for tag in ("k1_kernel", "k2_kernel")}
    assert complete and card == {"k1_kernel": 169, "k2_kernel": 85}
    assert streams == [native.encode_image_native(im, 2)[0] for im in imgs]


@pytest.mark.cuda
def test_lockstep_pipelined_halves_of_nine(cuda_device):
    """pipeline=True at B=18: two runs of 9, each replaying the programs of
    its own slot; the streams are the native engine's."""
    rng = np.random.default_rng(22)
    imgs = [rng.integers(0, 256, (32, 32)).astype(np.uint8)
            for _ in range(18)]
    streams, rcons = lockstep.encode_batch(imgs, 2, pipeline=True,
                                           device=cuda_device)
    for im, s, r in zip(imgs, streams, rcons):
        s_ref, r_ref = native.encode_image_native(im, 2)
        assert s == s_ref and np.array_equal(r, r_ref)
    dev = torch.device("cuda", torch.cuda.current_device())
    halves = [lockstep._pu_program(2, 9, dev, (run, 0)) for run in (0, 1)]
    assert halves[0] is not halves[1]
    assert all(p.run.graph is not None for p in halves)


@pytest.mark.cuda
def test_lockstep_mesh_on_one_card(cuda_device):
    """a mesh (cuda:0, cuda:0): each part replays the programs of its own
    slot; the streams are the native engine's."""
    rng = np.random.default_rng(23)
    imgs = [rng.integers(0, 256, (32, 32)).astype(np.uint8)
            for _ in range(4)]
    dev = torch.device("cuda", torch.cuda.current_device())
    streams, rcons = lockstep.encode_batch(imgs, 3, mesh=(dev, dev))
    for im, s, r in zip(imgs, streams, rcons):
        s_ref, r_ref = native.encode_image_native(im, 3)
        assert s == s_ref and np.array_equal(r, r_ref)
    parts = [lockstep._node_program(32, 3, 2, True, dev, (0, i))
             for i in (0, 1)]
    assert parts[0] is not parts[1]
    assert all(p.run.graph is not None for p in parts)


@pytest.mark.cuda
def test_spec_encoder_and_device_step_replay_programs(cuda_device):
    """a second spec encode and a second device step build nothing: every
    eval replays its program; the device step returns fresh memory equal to
    the CPU's."""
    from hevce_tpu_torch.models import cu_eval

    g = np.load(ROOT / "tests" / "data" / "golden_images.npz")
    img, q = g["img_3"], int(g["qpd6_3"])
    first = encoder.encode_image(img, q, device=cuda_device)
    since, k1 = len(graphs.CAPTURED), fused_eval.LAUNCHES
    again = encoder.encode_image(img, q, device=cuda_device)
    assert len(graphs.CAPTURED) == since and fused_eval.LAUNCHES - k1 == 169
    assert first[0] == again[0] == bytes(g["stream_3"])
    dev = torch.device("cuda", torch.cuda.current_device())
    assert encoder._eval_program(cu_eval.eval_tusplit, 32, q,
                                 dev).run.graph is not None
    args = pb.random_node_batch(16, 3, seed=5)
    card = pb.device_step_fn(16, 2)(*(torch.from_numpy(a).to(dev)
                                      for a in args))
    since = len(graphs.CAPTURED)
    again = pb.device_step_fn(16, 2)(*(torch.from_numpy(a).to(dev)
                                       for a in args))
    assert len(graphs.CAPTURED) == since
    prog = lockstep._node_program(16, 2, 3, False, dev, (0, 0))
    held = {t.untyped_storage().data_ptr() for t in prog.out}
    cpu = pb.device_step_fn(16, 2)(*args)
    for a, b, c in zip(card, again, cpu):
        assert a.untyped_storage().data_ptr() not in held
        assert torch.equal(a, b) and torch.equal(a.cpu(), c)


# run as a process of its own: a failed capture must not leave the test
# process in a capture's state
SYNC_IN_EVENT = """
import sys
import numpy as np
from hevce_tpu_torch.parallel import lockstep

step = lockstep._pu_step

def synced(*args):
    out = step(*args)
    out[3].sum().item()                 # a host sync inside the step
    return out

lockstep._pu_step = synced
img = np.zeros((32, 32), np.uint8)
try:
    lockstep.encode_batch([img], 2, device="cuda")
except RuntimeError as e:
    print("capture raised:", str(e)[:200])
    sys.exit(0 if lockstep._pu_program.cache_info().currsize == 0 else 4)
sys.exit(3)
"""


@pytest.mark.cuda
def test_a_host_sync_in_an_event_step_fails_capture(cuda_device):
    """a PU step that waits for the card cannot be captured: encode_batch
    raises (and caches no PU program) instead of running it eagerly."""
    r = subprocess.run([sys.executable, "-c", SYNC_IN_EVENT], cwd=ROOT,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    assert "capture raised" in r.stdout


# ------------------------------------------------------------ probes P1-P3

@pytest.mark.cuda
def test_p1_add_one_matches_plain_on_card(cuda_device):
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.integers(-2**30, 2**30, (8, 128))
                         .astype(np.int32)).to(cuda_device)
    want = probes.add_one_plain(x)
    n0 = probes.LAUNCHES["add_one"]
    assert probes.add_one(x) is x
    torch.cuda.synchronize()
    assert probes.LAUNCHES["add_one"] == n0 + 1
    assert torch.equal(x, want)


@pytest.mark.cuda
@pytest.mark.parametrize("n,offset", [(1, 0), (3, 0), (1027, 0), (4098, 0),
                                      (70001, 0), (1027, 1), (5, 3)])
def test_p1_add_one_at_ragged_sizes_on_card(cuda_device, n, offset):
    """16-byte words and the scalar tail (n not a multiple of 4), more than
    one block, and a buffer that is not 16-byte aligned (offset elements
    into its allocation: all scalar)."""
    rng = np.random.default_rng(n + offset)
    base = torch.from_numpy(rng.integers(-2**30, 2**30, n + offset)
                            .astype(np.int32)).to(cuda_device)
    x = base[offset:]
    want = probes.add_one_plain(x)
    n0 = probes.LAUNCHES["add_one"]
    assert probes.add_one(x) is x
    torch.cuda.synchronize()
    assert probes.LAUNCHES["add_one"] == n0 + 1
    assert torch.equal(x, want)


@pytest.mark.cuda
def test_p1_in_a_captured_cuda_graph(cuda_device):
    x = torch.zeros((8, 128), dtype=torch.int32, device=cuda_device)
    probes.add_one(x)                      # load the library before capture
    n0 = probes.LAUNCHES["add_one"]
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(10):
            probes.add_one(x)
    assert probes.LAUNCHES["add_one"] == n0 + 10       # captures, not replays
    x.zero_()
    g.replay()
    g.replay()
    torch.cuda.synchronize()
    assert probes.LAUNCHES["add_one"] == n0 + 10
    assert bool((x == 20).all())


# the probe's shape and extremes; ragged edges (K not a multiple of 16 or
# 32, N not a multiple of 4, odd N); more than 64 blocks of the small tiling
# (1000, 96, 200), and the 128 x 128 tiling with ragged K and N
P2_CASES = [(512, 64, 64, None), (512, 64, 64, -128), (100, 48, 24, None),
            (16, 16, 8, 127), (130, 160, 72, None), (77, 40, 36, None),
            (130, 33, 70, None), (64, 200, 3, None), (1000, 96, 200, None),
            (1700, 70, 1290, None), (2100, 48, 1281, -128)]


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N,fill", P2_CASES)
def test_p2_int8_mm_matches_plain_on_card(cuda_device, M, K, N, fill):
    rng = np.random.default_rng(M + K + N)
    if fill is None:
        a = rng.integers(-128, 128, (M, K)).astype(np.int8)
        b = rng.integers(-128, 128, (K, N)).astype(np.int8)
    else:
        a, b = np.full((M, K), fill, np.int8), np.full((K, N), -128, np.int8)
    want = torch.from_numpy((a.astype(np.int64) @ b.astype(np.int64))
                            .astype(np.int32))
    a, b = torch.from_numpy(a).to(cuda_device), torch.from_numpy(b).to(cuda_device)
    n0 = probes.LAUNCHES["int8_mm"]
    got = probes.int8_mm(a, b)
    torch.cuda.synchronize()
    assert probes.LAUNCHES["int8_mm"] == n0 + 1
    assert torch.equal(got.cpu(), want)
    if M * K * N <= 2**24:              # the plain version's int64 product
        assert torch.equal(got, probes.int8_mm_plain(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("qpd6", range(5))
def test_p3_fused4_matches_plain_and_k1_on_card(cuda_device, qpd6):
    rng = np.random.default_rng(20 + qpd6)
    # ragged last warp tiles (17 x 35 = 595 blocks, 37 tiles and 3 rows;
    # 1 x 35; 511 x 35), fewer modes than a tile's rows (9 x 4)
    for rows, modes in ((512, 35), (511, 35), (17, 35), (1, 35), (37, 35),
                        (9, 4)):
        pred, blk = (torch.from_numpy(a).to(cuda_device)
                     for a in cuda_probe.p3_inputs(rng, rows, modes))
        n0 = probes.LAUNCHES["fused4"]
        got = probes.fused4(pred, blk, qpd6)
        torch.cuda.synchronize()
        assert probes.LAUNCHES["fused4"] == n0 + 1
        for want in (probes.fused4_plain(pred, blk, qpd6),
                     cuda_probe.via_k1(pred, blk, qpd6)):
            for g, w in zip(got, want):
                assert g.dtype == w.dtype and torch.equal(g, w), (rows, modes)


@pytest.mark.cuda
def test_p2_and_p3_issue_int8_tensor_core_instructions(cuda_device):
    counts = probes.imma_counts(probes.build()[0])
    for kern in ("p2_int8_mm", "p3_fused4"):
        assert any(kern in fn and n > 0 for fn, n in counts.items()), counts


@pytest.mark.cuda
def test_p3_runs_without_barriers_or_shared_memory(cuda_device):
    """one warp a tile: the stages hand over in registers (no BAR, LDS, STS
    in p3_fused4's SASS), with two products a digit and two digits a stage
    (16 IMMA)."""
    path = probes.build()[0]
    for op, want in ((" BAR.", 0), (" LDS", 0), (" STS", 0), ("IMMA", 16)):
        counts = [n for fn, n in probes.sass_counts(path, op).items()
                  if "p3_fused4" in fn]
        assert counts and all(n == want for n in counts), (op, counts)


@pytest.mark.cuda
def test_k1_transform_stages_issue_int8_tensor_core_instructions(cuda_device):
    counts = fused_eval.imma_by_size(probes.imma_counts(fused_eval.build()[0]))
    assert all(counts[sz] > 0 for sz in (8, 16, 32)), counts
    assert counts[4] == 0, counts              # 4x4 stays on the CUDA cores


@pytest.mark.cuda
def test_probe_wrappers_reject_what_they_do_not_take(cuda_device):
    a = torch.zeros((32, 16), dtype=torch.int8, device=cuda_device)
    with pytest.raises(TypeError):
        probes.int8_mm(a.to(torch.int32), a.T.contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        probes.int8_mm(a, a.T)
    pred = torch.zeros((4, 35 * 16), dtype=torch.uint8, device=cuda_device)
    blk = torch.zeros((4, 16), dtype=torch.uint8, device=cuda_device)
    with pytest.raises(ValueError):
        probes.fused4(pred[:, :-1].contiguous(), blk)
    with pytest.raises(ValueError):
        probes.fused4(pred, blk.cpu())
    flat = torch.zeros(4 * 35 * 16 + 1, dtype=torch.uint8, device=cuda_device)
    with pytest.raises(ValueError, match="aligned"):   # 4-byte loads
        probes.fused4(flat[1:].view(4, 35 * 16), blk)
    with pytest.raises(TypeError):
        probes.add_one(pred)


@pytest.mark.cuda
def test_measurement_tools_on_card(cuda_device, tmp_path):
    lines = []
    res = cuda_probe.run(cuda_device, out=lines.append)
    assert res["p1"]["add_one"]["graph_us"] > 0 and res["p2"]["exact"]
    assert res["p2"]["large"]["exact"]
    assert sum("EXACT" in ln for ln in lines) == 3
    assert not any("MISMATCH" in ln for ln in lines)
    assert bench_fused.main(["4,35", "--n1", "2", "--n2", "6"],
                            out=lines.append) == 0
    img = np.random.default_rng(3).integers(0, 256, (64, 96)).astype(np.uint8)
    write_pgm(tmp_path / "a.pgm", img)
    assert profile_front.main([str(tmp_path / "a.pgm"), "--fronts", "1",
                               "--logdir", str(tmp_path / "trace")],
                              out=lines.append) == 0
    assert (tmp_path / "trace" / "trace.json").exists()
    assert any(ln.startswith("card time:") for ln in lines)


@pytest.mark.cuda
def test_a_profiled_window_holds_every_k1_launch_or_says_so(cuda_device,
                                                            tmp_path):
    """A profiler window's K1 count is the wrapper counter's delta: a
    card_kernels session that lost launches is run again and, if every try
    lost some, comes back marked incomplete; device_trace names what it
    lost. Never a short count passed off as whole."""
    pred, blk = (t.to(cuda_device) for t in _inputs(4, 35, 2, lanes=288))
    calls = lambda: [fused_eval.pipeline_sse(4, 2, pred, blk)
                     for _ in range(20)]
    kernels, complete = timing.card_kernels(calls)
    seen = sum(n for k, _, n in kernels if "k1_kernel" in k)
    assert (seen == 20) if complete else (seen < 20)
    with device_trace(tmp_path / "t") as prof:
        calls()
    seen = sum(n for k, (_, n) in timing.event_totals(prof).items()
               if "k1_kernel" in k)
    assert prof.lost_launches == ({} if seen == 20
                                  else {"k1_kernel": 20 - seen})


@pytest.mark.cuda
def test_profiler_sessions_tool_on_card(cuda_device):
    r = subprocess.run(
        [sys.executable, "-m", "hevce_tpu_torch.tools.profiler_sessions",
         "--kernel", "k1", "--sessions", "3", "--calls", "5", "--graph"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    rows = [json.loads(ln) for ln in r.stdout.splitlines()
            if ln.startswith("{")]
    assert [row["session"] for row in rows] == [0, 1, 2]
    assert all(row["expected"] == 5 and row["profiled"] + row["lost"] == 5
               for row in rows)


# run as a process of its own (test_card_times_after_a_graph_capture), so
# that what the test process ran before cannot change it
GRAPH_SESSIONS = """
import torch
from hevce_tpu_torch.ops import probes
from hevce_tpu_torch.utils import graphs, timing

x = torch.zeros((8, 128), dtype=torch.int32, device="cuda")
step = lambda: probes.add_one(x)
step()
g = torch.cuda.CUDAGraph()
with torch.cuda.graph(g):
    step()
g.replay()
for _ in range(30):
    kernels, complete = timing.card_kernels(lambda: [step() for _ in range(5)])
    assert kernels and complete
assert timing.busy_events_ms(step, 50) < 0.5 * timing.cuda_ms(step, 50)
"""


@pytest.mark.cuda
def test_card_times_after_a_graph_capture(cuda_device):
    """After a CUDA graph capture every profiler session still records the
    card's kernels; busy_events_ms, card_ms's fallback, keeps the host's
    enqueue out: a P1 launch there is far below its call time. It runs in a
    fresh process: in one that has run many profiler sessions, sessions
    lose launches (cause open), so the outcome hung on the file's order."""
    r = subprocess.run([sys.executable, "-c", GRAPH_SESSIONS], cwd=ROOT,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]


# --------------------------------------------------- the slice runner's graph

def _identity_images():
    rng = np.random.default_rng(5)
    yy, xx = np.mgrid[0:64, 0:96]
    return [rng.integers(0, 256, (64, 96)).astype(np.uint8),
            ((yy * 2 + xx) % 256).astype(np.uint8)]


def _as_bytes(out):
    """a dispatch's output (a _HostCopy, or a tuple of them, qc16 and None)
    as bytes."""
    if isinstance(out, wf._HostCopy):
        return [out.numpy().tobytes()]
    return [None if o is None else
            (o.cpu().numpy() if isinstance(o, torch.Tensor) else o.numpy())
            .tobytes() for o in out]


GRAPH_MODES = {  # (rmd, fetch_qc, want_recon, prices)
    "lean": ((12, 4), False, False, None),
    "dense": (None, False, False, None),
    "full_recon": ((12, 4), True, True, None),
    "post_prices": ((12, 4), False, False,
                    (np.array([int(0.45 * wf.BIT), int(0.55 * wf.BIT)],
                              np.int32), np.full(2, wf.SIG_ZERO, np.int32))),
}


@pytest.mark.cuda
@pytest.mark.parametrize("qpd6", [0, 2, 4])
def test_graph_records_equal_eager_and_cpu(cuda_device, qpd6):
    """_dispatch_batch's graph replays give the records, sidebands and
    recon planes of the eager run_slice on the card and of the CPU, byte
    for byte, on every path."""
    imgs = _identity_images()
    dev = torch.device("cuda", torch.cuda.current_device())
    for mode, (rmd, fetch_qc, want_recon, prices) in GRAPH_MODES.items():
        graph = _as_bytes(wf._dispatch_batch(
            imgs, qpd6, rmd, prices=prices, device=cuda_device,
            want_recon=want_recon, fetch_qc=fetch_qc)[0])
        runner = wf._slice_runner_cache(qpd6, 2, 3, 2, rmd, fetch_qc,
                                        want_recon, dev)
        assert runner.graph is not None and runner.launches["k1"] == (
            153 if rmd is None else 169)
        cpu = _as_bytes(wf._dispatch_batch(
            imgs, qpd6, rmd, prices=prices, device="cpu",
            want_recon=want_recon, fetch_qc=fetch_qc)[0])
        O, cv, sv = (torch.from_numpy(a).to(dev)
                     for a in wf._slice_inputs(imgs, qpd6, prices)[1])
        with torch.no_grad():
            eager = wf.run_slice(O, cv, sv, qpd6, rmd, fetch_qc=fetch_qc,
                                 want_recon=want_recon)
        eager = _as_bytes(eager if fetch_qc else wf._HostCopy(eager))
        assert graph == eager == cpu, (mode, qpd6)


@pytest.mark.cuda
def test_graph_counts_k1_launches_the_card_ran(cuda_device):
    """K1's LAUNCHES: one eager warm-up step when a runner is built, none
    for the capture, 169 per replayed step; a profiled call of the runner
    holds them all."""
    rng = np.random.default_rng(11)
    imgs = [rng.integers(0, 256, (64, 64)).astype(np.uint8)
            for _ in range(3)]                      # a key of its own
    D = 2 * (2 - 1) + 2
    n0, built0 = fused_eval.LAUNCHES, _runners()
    first = wf._dispatch_batch(imgs, 2, device=cuda_device)[0].numpy()
    assert _runners() == built0 + 1
    assert fused_eval.LAUNCHES - n0 == 169 * (D + 1)
    n0 = fused_eval.LAUNCHES
    again = wf._dispatch_batch(imgs, 2, device=cuda_device)[0].numpy()
    assert fused_eval.LAUNCHES - n0 == 169 * D
    assert first.tobytes() == again.tobytes()
    runner = wf._slice_runner_cache(2, 2, 2, 3, (12, 4), False, False,
                                    torch.device("cuda",
                                                 torch.cuda.current_device()))
    O = torch.from_numpy(wf._orig_tiles_raster(imgs, 64, 64)).to(
        runner.device)
    cv, sv = (torch.full((3,), v, dtype=torch.int32, device=runner.device)
              for v in (wf._ctx_default(2), wf.SIG_ZERO))
    kernels, complete = timing.card_kernels(lambda: runner(O, cv, sv))
    k1 = sum(n for k, _, n in kernels if "k1_kernel" in k)
    assert complete and k1 == 169 * D


@pytest.mark.cuda
def test_graph_batches_in_flight(cuda_device):
    """two batches of one shape dispatched back to back before either is
    read (encode_many_fast keeps AHEAD in flight): each keeps its own
    records, qc16 sideband and recon, equal to the CPU's."""
    rng = np.random.default_rng(12)
    a = [rng.integers(0, 256, (64, 96)).astype(np.uint8) for _ in range(2)]
    b = [rng.integers(0, 256, (64, 96)).astype(np.uint8) for _ in range(2)]
    for fetch_qc in (False, True):
        outs = [wf._dispatch_batch(imgs, 0, device=cuda_device,
                                   fetch_qc=fetch_qc)[0] for imgs in (a, b)]
        got = [_as_bytes(o) for o in outs]
        want = [_as_bytes(wf._dispatch_batch(imgs, 0, device="cpu",
                                             fetch_qc=fetch_qc)[0])
                for imgs in (a, b)]
        assert got == want and got[0] != got[1]


@pytest.mark.cuda
def test_graph_over_a_mesh_on_one_card(cuda_device):
    """a mesh (cuda:0, cuda:0): each part replays its device's runner; the
    gathered records equal the unsplit CPU run's."""
    rng = np.random.default_rng(13)
    imgs = [rng.integers(0, 256, (64, 96)).astype(np.uint8) for _ in range(4)]
    dev = torch.device("cuda", torch.cuda.current_device())
    got = wf._dispatch_batch(imgs, 2, mesh=(dev, dev))[0].numpy()
    want = wf._dispatch_batch(imgs, 2, device="cpu")[0].numpy()
    assert got.tobytes() == want.tobytes()
    assert wf._slice_runner_cache(2, 2, 3, 2, (12, 4), False, False,
                                  dev).graph is not None


# run as a process of its own (test_a_host_sync_in_the_step_fails_capture):
# a failed capture must not leave the test process in a capture's state
SYNC_IN_STEP = """
import sys
import numpy as np
import torch
from hevce_tpu_torch.models import wavefront as wf

core = wf.front_core

def synced(*args, **kw):
    out = core(*args, **kw)
    out[1].sum().item()                 # a host sync inside the step
    return out

wf.front_core = synced
img = np.zeros((32, 32), np.uint8)
try:
    wf._dispatch_batch([img], 2, device="cuda")
except RuntimeError as e:
    print("capture raised:", str(e)[:200])
    sys.exit(0 if wf._slice_runner_cache.cache_info().currsize == 0 else 4)
sys.exit(3)
"""


@pytest.mark.cuda
def test_a_host_sync_in_the_step_fails_capture(cuda_device):
    """a step that waits for the card cannot be captured: the dispatch
    raises (and caches no runner) instead of running the step eagerly."""
    r = subprocess.run([sys.executable, "-c", SYNC_IN_STEP], cwd=ROOT,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    assert "capture raised" in r.stdout


# ------------------------------------------------------------ X1 - X3

FLAGS16 = np.array([[(i >> k) & 1 for k in (3, 2, 1, 0)] for i in range(16)],
                   bool)


def _x_contexts(rng, dev, sz, rows):
    """node contexts as the front step passes them: views of a canvas (a
    row of the top, a strided column of the left), every flag combination,
    flat and 0 / 255 borders."""
    A = rng.integers(0, 256, (rows, 2 * sz + 2, 2 * sz + 2)).astype(np.uint8)
    A[0], A[1, 0], A[1, 1:, 0] = 77, 255, 0
    A = torch.from_numpy(A).to(dev)
    fl = torch.from_numpy(FLAGS16[np.arange(rows) % 16]).to(dev)
    return A[:, 0, 0:1 + 2 * sz], A[:, 1:1 + 2 * sz, 0], fl


def _x_same(got, want):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("sz", [4, 8, 16, 32])
def test_x1_predict_matches_plain_on_card(cuda_device, sz):
    """X1 equals its plain version on the card, tolerance 0: all 35 modes
    at 288, 18 and one (1-D, int32) rows on strided uint8 and int32
    contexts and every flag combination; each TU-split sub-TU (sz > 4)
    from a canvas, with the lanes' modes given and lane = mode. One launch
    a call."""
    rng = np.random.default_rng(700 + sz)
    for rows in (288, 18):
        top, left, fl = _x_contexts(rng, cuda_device, sz, rows)
        for t, l in ((top, left), (top.to(torch.int32), left.to(torch.int32))):
            n0 = fused_node.X1.LAUNCHES
            got = fused_node.predict(sz, t, l, fl)
            torch.cuda.synchronize()
            assert fused_node.X1.LAUNCHES == n0 + 1
            _x_same(got, fused_node.predict_plain(sz, t, l, fl))
        if sz > 4:
            for M, modes in ((4, torch.from_numpy(rng.integers(
                    0, 35, (rows, 4)).astype(np.int32)).to(cuda_device)),
                             (35, None)):
                canvas = torch.from_numpy(rng.integers(
                    0, 256, (rows, M, sz, sz)).astype(np.uint8)).to(
                        cuda_device)
                for isub in range(4):
                    args = (sz, top, left, fl, modes, canvas, isub)
                    _x_same(fused_node.predict(*args),
                            fused_node.predict_plain(*args))
    one = [t.to(torch.int32)[5] for t in (top, left)] + [fl[5]]
    _x_same(fused_node.predict(sz, *one), fused_node.predict_plain(sz, *one))


@pytest.mark.cuda
@pytest.mark.parametrize("sz", [8, 16, 32])
def test_x2_preselect_matches_plain_on_card(cuda_device, sz):
    """X2 equals its plain version on the card at K 1, 4, 12 and 35 on 288
    rows: every flag combination, flat borders whose 35 SATDs tie across
    the K-th place, neighbour modes read through strides."""
    rng = np.random.default_rng(720 + sz)
    top, left, fl = _x_contexts(rng, cuda_device, sz, 288)
    blk = rng.integers(0, 256, (288, sz, sz)).astype(np.uint8)
    blk[0] = 77
    blk = torch.from_numpy(blk).to(cuda_device)
    P = torch.from_numpy(rng.integers(0, 35, (288, 9, 9)).astype(
        np.int32)).to(cuda_device)
    P[0, 1, 0], P[0, 0, 1] = 7, 7
    pml, pma = P[:, 1, 0], P[:, 0, 1]
    for K in (1, 4, 12, 35):
        n0 = fused_node.X2.LAUNCHES
        got = fused_node.preselect(sz, top, left, fl, blk, pml, pma, K)
        torch.cuda.synchronize()
        assert fused_node.X2.LAUNCHES == n0 + 1
        _x_same(got, fused_node.preselect_plain(sz, top, left, fl, blk, pml,
                                                pma, K))


@pytest.mark.cuda
@pytest.mark.parametrize("qpd6", range(5))
def test_x3_rate_cost_matches_plain_on_card(cuda_device, qpd6):
    """X3 equals its plain version on the card at the main path's shapes
    (RMD 2Nx2N on K=12, TU split on T=4, NxN PUs at (4, 35), the dense
    (sz, 35) in both layouts) with all-zero blocks, levels at K1's int16
    extremes and SSEs at the RD cost's saturation edges."""
    rng = np.random.default_rng(740 + qpd6)
    lim = (2**31 - 1) // int(wf.Cst.RDCOST_WEIGHT_DIST[qpd6])
    to = lambda a, dt: torch.from_numpy(np.ascontiguousarray(
        a.astype(dt))).to(cuda_device)
    for sz, M, split, with_modes, hdr in (
            (8, 12, False, True, 6), (16, 12, False, True, 6),
            (32, 12, False, True, 6), (8, 4, True, True, 9),
            (16, 4, True, True, 9), (32, 4, True, True, 9),
            (4, 35, False, False, 1), (8, 35, False, False, 6),
            (32, 35, True, False, 9)):
        rows, n = 288, sz // 2 if split else sz
        shape = (rows, M) + ((4, n, n) if split else (n, n))
        q = np.where(rng.random(shape) < 0.1, rng.integers(-40, 41, shape), 0)
        q[0, 1], q[0, 2] = 32767, -32768
        q[1, 0] = rng.choice([-32768, -32767, 32767], shape[2:])
        sse = rng.integers(0, 255 * 255 * 1024, (rows, M))
        sse.reshape(-1)[:4] = (lim - 1, lim, min(lim + 1, 2**31 - 1), 0)
        cv = rng.integers(0, 4 << 15, rows)
        modes = (to(np.sort(rng.choice(35, (rows, M)), -1), np.int32)
                 if with_modes else None)
        args = (sz, qpd6, to(q, np.int16), to(sse, np.int32),
                to(cv, np.int32), to(cv[::-1], np.int32),
                to(rng.integers(0, 35, rows), np.int32),
                to(rng.integers(0, 35, rows), np.int32), hdr, modes, split)
        n0 = fused_node.X3.LAUNCHES
        got = fused_node.rate_cost(*args)
        torch.cuda.synchronize()
        assert fused_node.X3.LAUNCHES == n0 + 1
        _x_same(got, fused_node.rate_cost_plain(*args))


@pytest.mark.cuda
def test_fused_node_wrappers_reject_what_they_do_not_take(cuda_device):
    top, left, fl = _x_contexts(np.random.default_rng(3), cuda_device, 8, 4)
    with pytest.raises(TypeError):               # mixed context types
        fused_node.predict(8, top, left.to(torch.int32), fl)
    with pytest.raises(ValueError):              # a mix of devices
        fused_node.predict(8, top, left.cpu(), fl)
    with pytest.raises(ValueError):              # no canvas for a sub-TU
        fused_node.predict(8, top, left, fl, None, None, 1)
    with pytest.raises(ValueError):              # uint8 levels
        fused_node.rate_cost(
            4, 2, torch.zeros((4, 35, 4, 4), dtype=torch.uint8,
                              device=cuda_device),
            torch.zeros((4, 35), dtype=torch.int32, device=cuda_device),
            *(torch.zeros(4, dtype=torch.int32, device=cuda_device)
              for _ in range(4)), 1)


def _x4_costs(rng, dev, kind, shape):
    """RD costs: random, few values (ties at the minimum across the sets),
    or mostly I32_MAX (the first rows all of it)."""
    if kind == "random":
        c = rng.integers(0, 1 << 24, shape)
    elif kind == "ties":
        c = rng.integers(5, 8, shape)
    else:
        c = np.where(rng.random(shape) < 0.8, 2**31 - 1,
                     rng.integers(2**31 - 65, 2**31 - 1, shape))
        c[:3] = 2**31 - 1
    return torch.from_numpy(c.astype(np.int32)).to(dev)


def _x4_node_args(rng, dev, rows, sz, rmd, kind):
    """one node's pick as the front step makes it: RMD (12 candidates and
    the TU split's top 4, with their mode maps) or dense (35 + 35), the
    split's levels as (rows, T, 4, h, h) sub-TUs."""
    M1, M2 = (12, 4) if rmd else (35, 35)
    h = sz // 2
    blk = lambda *s, lo, hi, dt: torch.from_numpy(rng.integers(
        lo, hi, s).astype(dt)).to(dev)
    args = [_x4_costs(rng, dev, kind, (rows, M1)),
            blk(rows, M1, sz, sz, lo=-32768, hi=32768, dt=np.int16),
            blk(rows, M1, sz, sz, lo=0, hi=256, dt=np.uint8),
            _x4_costs(rng, dev, kind, (rows, M2)),
            blk(rows, M2, 4, h, h, lo=-32768, hi=32768, dt=np.int16),
            blk(rows, M2, sz, sz, lo=0, hi=256, dt=np.uint8)]
    if rmd:
        modesK = np.sort(rng.choice(35, (rows, M1)), -1).astype(np.int32)
        args += [torch.from_numpy(modesK).to(dev),
                 torch.from_numpy(np.ascontiguousarray(
                     modesK[:, :M2][:, ::-1])).to(dev)]
    return args


def _x4_pu_run(fn, rng_seed, dev, rows, kind):
    """the four PUs of an NxN leaf through fn (pick or pick_plain), each
    writing its mode and levels into their slots, its recon into a canvas
    that is itself a view of a larger one, its cost into a running total
    that starts at the saturation edges; PU0 reads a dense TU split's first
    sub-TU through views. Returns what every call returned, then the
    slots, the whole canvas and the total."""
    rng = np.random.default_rng(rng_seed)
    u8 = lambda *s: torch.from_numpy(rng.integers(0, 256, s).astype(
        np.uint8)).to(dev)
    i16 = lambda *s: torch.from_numpy(rng.integers(-32768, 32768, s).astype(
        np.int16)).to(dev)
    big = u8(rows, 40, 41)
    local = big[:, 4:37, 5:38]
    total = rng.integers(0, 2**31 - 1, rows)
    total[:4] = (2**31 - 1, 2**31 - 2, 0, 2**31 - 1 - (1 << 24))[:rows]
    total = torch.from_numpy(total.astype(np.int32)).to(dev)
    pm4 = torch.full((rows, 4), -1, dtype=torch.int32, device=dev)
    quant = torch.full((rows, 64), 7, dtype=torch.int16, device=dev)
    q4, r4 = i16(rows, 35, 4, 4, 4), u8(rows, 35, 8, 8)
    outs = []
    for isub, (dy, dx) in enumerate(wf._SUB):
        y, x = 8 + 4 * dy, 16 + 4 * dx
        q, r = ((q4[..., 0, :, :], r4[..., 0:4, 0:4]) if isub == 0
                else (i16(rows, 35, 4, 4), u8(rows, 35, 4, 4)))
        cost = _x4_costs(rng, dev, kind, (rows, 35))
        outs += fn(cost, q, r, pm=pm4[:, isub],
                   quant=quant[:, 16 * isub:16 * isub + 16],
                   recon=local[:, y + 1:y + 5, x + 1:x + 5], total=total)
    return tuple(outs) + (pm4, quant, big, total)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["random", "ties", "saturated"])
def test_x4_pick_matches_plain_on_card(cuda_device, kind):
    """X4 equals its plain version on the card, tolerance 0, at every shape
    the front step gives it: RMD (8 / 16 / 32, 12 + 4) with mode maps,
    dense (8 / 16 / 32, 35 + 35) and the NxN PUs (4, 35) with their slots,
    canvas and running total; at 1, 16 and 288 lanes; costs that tie at the
    minimum or sit at I32_MAX. One launch a call."""
    for rows in (1, 16, 288):
        for sz in (8, 16, 32):
            for rmd in (True, False):
                rng = np.random.default_rng(rows * 100 + sz + 7 * rmd)
                args = _x4_node_args(rng, cuda_device, rows, sz, rmd, kind)
                n0 = fused_node.X4.LAUNCHES
                got = fused_node.pick(*args)
                torch.cuda.synchronize()
                assert fused_node.X4.LAUNCHES == n0 + 1
                _x_same(got, fused_node.pick_plain(*args))
        n0 = fused_node.X4.LAUNCHES
        got = _x4_pu_run(fused_node.pick, rows, cuda_device, rows, kind)
        torch.cuda.synchronize()
        assert fused_node.X4.LAUNCHES == n0 + 4
        _x_same(got, _x4_pu_run(fused_node.pick_plain, rows, cuda_device,
                                rows, kind))


@pytest.mark.cuda
def test_x4_pick_in_a_captured_graph_equals_eager(cuda_device):
    """a captured X4 call (a dense node's pick and a PU's, with its slots,
    canvas and total) replays what the eager call gives, on inputs
    rewritten in place between replays."""
    rng = np.random.default_rng(31)
    args = _x4_node_args(rng, cuda_device, 288, 32, False, "ties")
    pu = _x4_node_args(rng, cuda_device, 288, 8, False, "random")[:3]
    pu[1], pu[2] = pu[1][:, :, :4, :4], pu[2][:, :, :4, :4]
    canvas = torch.zeros((288, 33, 33), dtype=torch.uint8, device=cuda_device)
    total = torch.zeros(288, dtype=torch.int32, device=cuda_device)

    def step():
        total.zero_()
        return fused_node.pick(*args) + fused_node.pick(
            *pu, recon=canvas[:, 5:9, 9:13], total=total)[:4]

    captured = graphs.CapturedStep(step, cuda_device, "x4_test")
    graphs.CAPTURED.remove(captured)
    assert captured.launches["x4"] == 2
    for k in range(2):
        out = tuple(t.clone() for t in captured()) + (canvas.clone(),
                                                      total.clone())
        eager = step() + (canvas.clone(), total.clone())
        torch.cuda.synchronize()
        _x_same(out, eager)
        for t in args[:1] + args[3:4] + pu[:1]:
            t.copy_(_x4_costs(rng, cuda_device, "random", tuple(t.shape)))
        args[1].neg_()
        pu[2].add_(k + 1)


@pytest.mark.cuda
def test_x4_rejects_what_it_does_not_take(cuda_device):
    """a second set without its levels, one mode map of two, uint8 levels
    and block dims that do not merge as a view are refused."""
    args = _x4_node_args(np.random.default_rng(4), cuda_device, 4, 8, True,
                         "random")
    with pytest.raises(ValueError):
        fused_node.pick(*args[:4])
    with pytest.raises(ValueError):
        fused_node.pick(*args[:7])
    with pytest.raises(ValueError):
        fused_node.pick(args[0], args[2], args[2])
    with pytest.raises(ValueError):
        fused_node.pick(args[3], args[4].transpose(3, 4), args[5])


@pytest.mark.cuda
@pytest.mark.parametrize("rmd,per_step", [
    ((12, 4), {"k1": 169, "x1": 148, "x2": 21, "x3": 106, "x4": 85}),
    (None, {"k1": 153, "x1": 153, "x2": 0, "x3": 106, "x4": 85})])
def test_graph_counts_x_launches_the_card_ran(cuda_device, rmd, per_step):
    """X1-X4's LAUNCHES on the slice runner's graph: the warm-up step's
    (an eager front step: X4 85, one a node and an NxN PU, in both modes)
    when a runner is built, the captured step's at every replay (as for
    K1); a profiled call holds them all; the records equal the CPU's."""
    rng = np.random.default_rng(13 if rmd else 14)
    imgs = [rng.integers(0, 256, (64, 96)).astype(np.uint8)
            for _ in range(5)]                      # a key of its own
    D = 2 * (2 - 1) + 3
    counters = graphs.COUNTERS
    n0 = {k: counters[k].LAUNCHES for k in per_step}
    card = wf._dispatch_batch(imgs, 2, rmd, device=cuda_device)[0].numpy()
    assert {k: counters[k].LAUNCHES - n0[k] for k in per_step} == {
        k: n * (D + 1) for k, n in per_step.items()}
    cpu = wf._dispatch_batch(imgs, 2, rmd, device="cpu")[0].numpy()
    assert card.tobytes() == cpu.tobytes()
    runner = wf._slice_runner_cache(2, 2, 3, 5, rmd, False, False,
                                    torch.device("cuda",
                                                 torch.cuda.current_device()))
    assert {k: runner.launches[k] for k in per_step} == per_step
    O = torch.from_numpy(wf._orig_tiles_raster(imgs, 64, 96)).to(
        runner.device)
    cv, sv = (torch.full((5,), v, dtype=torch.int32, device=runner.device)
              for v in (wf._ctx_default(2), wf.SIG_ZERO))
    kernels, complete = timing.card_kernels(lambda: runner(O, cv, sv))
    seen = {x: sum(n for k, _, n in kernels if tag in k) for x, tag in (
        ("k1", "k1_kernel"), ("x1", "x1_predict"), ("x2", "x2_preselect"),
        ("x3", "x3_rate_cost"), ("x4", "x4_pick"))}
    assert complete and seen == {k: n * D for k, n in per_step.items()}
