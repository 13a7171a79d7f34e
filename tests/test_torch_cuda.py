"""Tests of the port that need an NVIDIA GPU. They skip without one.

This file imports neither jax nor the JAX package, so it also runs on a
machine that has only PyTorch for CUDA (tests/conftest.py imports jax, so
skip it there):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from hevce_tpu_torch.models import wavefront as wf
from hevce_tpu_torch.ops import cabac_scan, cabac_sim, coef_ops, fused_eval
from hevce_tpu_torch.parallel import lockstep
from hevce_tpu_torch.runtime import native
from hevce_tpu_torch.utils.tracing import PhaseTimer

SHAPES = [(4, 35), (4, 4), (8, 4), (8, 12), (16, 4), (16, 12),
          (32, 4), (32, 12), (8, 35), (16, 35), (32, 35), (4, 3)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K1 and K2 are CUDA kernels with "
                    "no CPU mode")
    return torch.device("cuda")


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


@pytest.mark.cuda
def test_card_records_equal_cpu_records(cuda_device):
    rng = np.random.default_rng(5)
    noise = rng.integers(0, 256, (64, 96)).astype(np.uint8)
    yy, xx = np.mgrid[0:64, 0:96]
    smooth = ((yy * 2 + xx) % 256).astype(np.uint8)
    bufs = []
    n0 = fused_eval.LAUNCHES
    for dev in (cuda_device, "cpu"):
        out, meta = wf._dispatch_batch([noise, smooth], 2, device=dev)
        wf._fetch_lean(out, meta, PhaseTimer())
        bufs.append(out.numpy().tobytes())
    assert fused_eval.LAUNCHES - n0 == 169 * (2 * (2 - 1) + 3)
    assert bufs[0] == bufs[1]


def _k2_inputs(lanes, L, P, seed):
    """random op strings over a P-slot palette, nop-padded past each lane's
    count, plus runs of all-ones and all-zero bypass chunks."""
    rng = np.random.default_rng(seed)
    kind = rng.integers(0, 3, (lanes, L))
    ctx = (cabac_sim.KIND_CTX | (rng.integers(0, P, (lanes, L)) << 2)
           | (rng.integers(0, 2, (lanes, L)) << 10))
    n = rng.integers(1, 9, (lanes, L))
    byp = (cabac_sim.KIND_BYPASS | (n << 2)
           | ((rng.integers(0, 256, (lanes, L)) & ((1 << n) - 1)) << 6))
    term = cabac_sim.KIND_TERM | ((rng.random((lanes, L)) < 0.05) << 10)
    ops = np.where(kind == 0, ctx, np.where(kind == 1, byp, term))
    ops[:lanes // 4] = cabac_sim.pack_bypass(0xFF, 8)
    ops[lanes // 4:lanes // 2:2] = cabac_sim.pack_bypass(0, 8)
    nops = rng.integers(0, L + 1, lanes)
    ops[np.arange(L)[None, :] >= nops[:, None]] = cabac_sim.KIND_NOP
    state = cabac_sim.initial_state(lanes, int(seed) % 5)
    state["ctxs"] = state["ctxs"][:, :P].contiguous()
    return state, torch.from_numpy(ops.astype(np.int32)), \
        torch.from_numpy(nops.astype(np.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("lanes,L,P", [(630, 256, 39), (1260, 768, 69),
                                       (1260, 2048, 67), (37, 100, 142)])
def test_k2_kernel_matches_plain_on_card(cuda_device, lanes, L, P):
    state, ops, nops = _k2_inputs(lanes, L, P, lanes + L + P)
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
    streams, rcons = lockstep.encode_batch(imgs, 2, node_rates=node_rates,
                                           pipeline=pipeline,
                                           device=cuda_device)
    runs = 2 if pipeline else 1
    node, pu = 21 * 2 * runs, 64 * 2 * runs          # two CTUs per image
    assert fused_eval.LAUNCHES - k1 == 5 * node + pu
    assert cabac_scan.LAUNCHES - k2 == pu + (node if node_rates else 0)
    for im, s, r in zip(imgs, streams, rcons):
        s_ref, r_ref = native.encode_image_native(im, 2)
        assert s == s_ref
        assert np.array_equal(r, r_ref)
