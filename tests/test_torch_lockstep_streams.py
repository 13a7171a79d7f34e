"""The port's lockstep engine end to end on the CPU: encode_batch streams
and recons equal the native bit-exact engine's (and so the JAX package's
lockstep engine's), with and without pipelining and device trial rates;
the expected kernel-call counts per event; failures propagate without
hanging the worker threads; no silent CPU run.
"""
import threading

import numpy as np
import pytest
import torch

from hevce_tpu.runtime import native as jnative
from hevce_tpu_torch.ops import cabac_scan, fused_eval
from hevce_tpu_torch.parallel import lockstep
from hevce_tpu_torch.utils.tracing import PhaseTimer

# the test workers share the machine's cores: one intra-op thread each
torch.set_num_threads(1)

NODE_PER_CTU, PU_PER_CTU = 21, 64


def _images(golden, seed, n):
    rng = np.random.default_rng(seed)
    return [golden("images")["img_2"]] + [
        rng.integers(0, 256, (32, 32)).astype(np.uint8) for _ in range(n - 1)]


def _check(images, qpd6, streams, rcons):
    assert len(streams) == len(images)
    for i, im in enumerate(images):
        s, r = jnative.encode_image_native(im, qpd6)
        assert streams[i] == s, f"image {i}"
        np.testing.assert_array_equal(rcons[i], r)


def _count_calls(monkeypatch):
    """count the wrapper calls that launch kernels K1 / K2 on the card."""
    calls = {"k1": 0, "k2": 0}
    k1, k2 = fused_eval.pipeline_sse, cabac_scan.advance_rates

    def c1(*a, **k):
        calls["k1"] += 1
        return k1(*a, **k)

    def c2(*a, **k):
        calls["k2"] += 1
        return k2(*a, **k)
    monkeypatch.setattr(fused_eval, "pipeline_sse", c1)
    monkeypatch.setattr(cabac_scan, "advance_rates", c2)
    return calls


def _events(timer):
    node = sum(n for k, n in timer.counts.items()
               if k.startswith("device_math_node"))
    return node, timer.counts["device_math_pu"]


def test_encode_batch_matches_native_and_counts(golden, monkeypatch):
    calls = _count_calls(monkeypatch)
    images = _images(golden, 3, 2)
    timer = PhaseTimer()
    streams, rcons = lockstep.encode_batch(images, 2, timer=timer,
                                           device="cpu")
    _check(images, 2, streams, rcons)
    for phase in ("host_arbiter", "device_math_pu", "device_math_node8",
                  "device_math_node16", "device_math_node32", "writeback",
                  "winner_fetch", "finish"):
        assert timer.counts[phase] > 0, phase
    assert "host_arbiter" in timer.report()
    # one 32x32 CTU: the content-independent schedule
    node, pu = _events(timer)
    assert (node, pu) == (NODE_PER_CTU, PU_PER_CTU)
    assert timer.counts["winner_fetch"] == 2 * (node + pu)
    assert calls == {"k1": 5 * node + pu, "k2": pu}


@pytest.mark.parametrize("qpd6", (0, 4))
def test_encode_batch_qpd6(golden, monkeypatch, qpd6):
    """with the transfer checksums on (HEVCE_VERIFY_TRANSFERS=1)."""
    monkeypatch.setenv("HEVCE_VERIFY_TRANSFERS", "1")
    rng = np.random.default_rng(20 + qpd6)
    img = rng.integers(0, 256, (32, 64)).astype(np.uint8)
    img[:, 32:] = np.clip(np.add.outer(np.arange(32), np.arange(32)) * 4,
                          0, 255)                   # a smooth second CTU
    streams, rcons = lockstep.encode_batch([img], qpd6, device="cpu")
    _check([img], qpd6, streams, rcons)


def test_encode_batch_pipeline_node_rates(golden, monkeypatch):
    """two interleaved halves, device trial rates at every node event."""
    calls = _count_calls(monkeypatch)
    images = _images(golden, 7, 2)
    timer = PhaseTimer()
    streams, rcons = lockstep.encode_batch(images, 2, node_rates=True,
                                           pipeline=True, timer=timer,
                                           device="cpu")
    _check(images, 2, streams, rcons)
    node, pu = _events(timer)                # two runs of one CTU each
    assert (node, pu) == (2 * NODE_PER_CTU, 2 * PU_PER_CTU)
    assert calls == {"k1": 5 * node + pu, "k2": pu + node}


def test_step_failure_propagates_without_hanging(golden, monkeypatch):
    """an exception inside an event reaches the caller: the engine aborts
    and its worker threads are joined instead of waiting forever."""
    def boom(*a, **k):
        raise RuntimeError("injected step failure")
    monkeypatch.setattr(lockstep, "_pu_step", boom)
    images = _images(golden, 9, 3)
    result = {}

    def run():
        try:
            lockstep.encode_batch(images, 2, device="cpu", pipeline=True)
        except RuntimeError as e:
            result["error"] = str(e)
    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(120)
    assert not t.is_alive(), "encode_batch hung after a failing step"
    assert result.get("error") == "injected step failure"


def test_encode_batch_needs_cuda_unless_cpu(monkeypatch):
    img = np.zeros((32, 32), np.uint8)
    with pytest.raises(TypeError):          # a mesh is a sequence of devices
        lockstep.encode_batch([img], 2, mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="multiple of the mesh"):
        lockstep.encode_batch([img], 2, mesh=("cpu", "cpu"))
    with pytest.raises(ValueError, match="share dims"):
        lockstep.encode_batch([img, img[:, :16]], 2, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        lockstep.encode_batch([img], 2)
    s, r = lockstep.encode_batch([img], 2, device="cpu")
    assert s[0] == jnative.encode_image_native(img, 2)[0]
