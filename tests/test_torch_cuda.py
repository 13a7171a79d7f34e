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
from hevce_tpu_torch.ops import fused_eval
from hevce_tpu_torch.utils.tracing import PhaseTimer

SHAPES = [(4, 35), (4, 4), (8, 4), (8, 12), (16, 4), (16, 12),
          (32, 4), (32, 12), (8, 35), (16, 35), (32, 35), (4, 3)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K1 is a CUDA kernel with no "
                    "CPU mode")
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
