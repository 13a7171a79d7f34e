"""The slice runner (models/wavefront._slice_runner_cache) on the CPU.

The runner owns static buffers and one front step that reads the front
index from a device tensor; on CUDA that step is captured as a CUDA graph
and replayed per front (the card tests hold it there). Here the same step
runs eagerly, and it must equal the eager run_slice byte for byte
(tolerance 0) on a batch of two 64x96 images made from a numpy seed. No
JAX program is compiled: the test_torch_slice_* files hold _dispatch_batch,
which runs through the runner, against the JAX package.
"""
import inspect

import numpy as np
import pytest
import torch

from hevce_tpu.models import wavefront as jwf
from hevce_tpu_torch.models import wavefront as wf
from hevce_tpu_torch.ops import fused_node, satd
from hevce_tpu_torch.utils import device as _device

# the test workers share the machine's cores: one intra-op thread each
torch.set_num_threads(1)

QPD6 = 2
CPU = torch.device("cpu")


def _batch(seed):
    """(O, cv, sv, images): two 64x96 images (noise and a ramp) as raster
    tiles, and their predicted prices (the noise image crosses the
    trigger)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:64, 0:96]
    imgs = [rng.integers(0, 256, (64, 96)).astype(np.uint8),
            ((yy * (2 + seed % 3) + xx) % 256).astype(np.uint8)]
    O = torch.from_numpy(wf._orig_tiles_raster(imgs, 64, 96))
    cv, sv = (torch.from_numpy(a) for a in wf._predict_prices(imgs, QPD6))
    return O, cv, sv, imgs


def _const_prices(B=2):
    return (torch.full((B,), wf._ctx_default(QPD6), dtype=torch.int32),
            torch.full((B,), wf.SIG_ZERO, dtype=torch.int32))


def _bytes(out):
    """an output (a tensor, or a tuple of tensors and None) as bytes."""
    if isinstance(out, torch.Tensor):
        return [out.numpy().tobytes()]
    return [None if t is None else t.numpy().tobytes() for t in out]


CASES = {  # (rmd, fetch_qc, want_recon, predicted prices)
    "lean": ((12, 4), False, False, False),
    "full_recon": ((12, 4), True, True, False),
    "dense": (None, False, False, False),
    "predicted": ((12, 4), False, False, True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_runner_equals_eager_run_slice(case):
    rmd, fetch_qc, want_recon, priced = CASES[case]
    O, cv, sv, _ = _batch(1)
    if not priced:
        cv, sv = _const_prices()
    runner = wf._slice_runner_cache(QPD6, 2, 3, 2, rmd, fetch_qc, want_recon,
                                    CPU)
    assert runner.graph is None and runner.D == 2 * (2 - 1) + 3
    got = runner(O, cv, sv)
    want = wf.run_slice(O, cv, sv, QPD6, rmd, fetch_qc=fetch_qc,
                        want_recon=want_recon)
    assert _bytes(got) == _bytes(want)
    if fetch_qc:
        assert got[3] is not None and got[3].shape == (2, 64, 96)


def test_one_runner_serves_two_batches():
    """no W / PME / d / record left over from the batch before: a reused
    runner gives each batch the records a fresh run_slice gives it."""
    runner = wf._slice_runner_cache(QPD6, 2, 3, 2, (12, 4), False, False,
                                    CPU)
    first, second = _batch(2), _batch(3)
    second = (second[0], second[1] - 4096, second[2] + 2048, second[3])
    assert not np.array_equal(first[3][0], second[3][0])
    assert not torch.equal(first[1], second[1])
    assert not torch.equal(first[2], second[2])
    outs = [runner(*b[:3]) for b in (first, second)]
    for b, out in zip((first, second), outs):
        want = wf.run_slice(*b[:3], QPD6, (12, 4))
        assert out.numpy().tobytes() == want.numpy().tobytes()
    assert outs[0].numpy().tobytes() != outs[1].numpy().tobytes()


def test_outputs_share_no_storage_with_the_runner():
    """the next call overwrites the runner's buffers: what a call returns
    (qc16 included, which stays on the device until the host reads it) is
    fresh memory."""
    O, cv, sv, _ = _batch(4)
    for fetch_qc in (False, True):
        runner = wf._slice_runner_cache(QPD6, 2, 3, 2, (12, 4), fetch_qc,
                                        fetch_qc, CPU)
        out = runner(O, cv, sv)
        outs = [out] if not fetch_qc else list(out)
        assert all(t is not None for t in outs)
        held = {b.untyped_storage().data_ptr() for b in
                [runner.Osk, runner.W, runner.PME, runner.ctx_lane,
                 runner.sig_lane, runner.d, runner.S] + runner.cols
                if b is not None}
        assert len(held) == 7 + len(runner.cols) - (not fetch_qc)
        for t in outs:
            assert t.untyped_storage().data_ptr() not in held


def test_front_core_takes_the_front_index_as_a_tensor():
    """front_core with d a 0-dim int32 tensor equals front_core with d an
    int, at every front of a slice (the carry advanced between fronts)."""
    O, cv, sv, _ = _batch(5)
    R, Cc = 2, 3
    D = 2 * (R - 1) + Cc
    ctx, sig = cv.repeat_interleave(R), sv.repeat_interleave(R)
    W = torch.zeros((2, R, 3, 32, 32), dtype=torch.uint8)
    PME = torch.zeros((2, R, 8), dtype=torch.int32)
    valid_rows = 0
    for d in range(D):
        rr = torch.arange(R)
        o_col = torch.where(((d - 2 * rr >= 0) & (d - 2 * rr < Cc))
                            [None, :, None, None],
                            O[:, rr, (d - 2 * rr).clamp(0, Cc - 1)], 0)
        want = wf.front_core(QPD6, R, (12, 4), W, PME, o_col, d, Cc, ctx,
                             sig, want_qc=True)
        got = wf.front_core(QPD6, R, (12, 4), W, PME, o_col,
                            torch.tensor(d, dtype=torch.int32), Cc, ctx,
                            sig, want_qc=True)
        assert len(got) == len(want) == 6
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and torch.equal(g, w), d
        valid_rows += int((got[1] != 0).any(-1).sum())
        W = torch.cat([W[:, :, 1:], got[0][:, :, None]], 2)
        PME = got[4]
    assert valid_rows == 2 * R * Cc      # every CTU made a decision


def test_cache_key_is_the_jax_key_with_batch_and_device():
    """hevce_tpu's _slice_runner_cache keys one program on (qpd6, R, Cc,
    want_recon, mesh, fetch_qc, rmd) and retraces per batch size; the port
    keys a runner on those, with the batch size and the device in the key
    and the mesh run as one runner per part's device."""
    jax_key = set(inspect.signature(jwf._slice_runner_cache).parameters)
    key = set(inspect.signature(wf._slice_runner_cache).parameters)
    assert key == (jax_key - {"mesh"}) | {"B", "device"}
    a = wf._slice_runner_cache(QPD6, 1, 1, 1, (12, 4), False, False, CPU)
    b = wf._slice_runner_cache(QPD6, 1, 1, 2, (12, 4), False, False, CPU)
    assert a is not b and a is wf._slice_runner_cache(
        QPD6, 1, 1, 1, (12, 4), False, False, CPU)
    assert (a.B, b.B, a.D) == (1, 2, 1)


def test_device_caches_key_on_the_normal_device(monkeypatch):
    """"cuda" names the current device: the caches see one key for "cuda"
    and "cuda:<index>" (and for "cpu" and torch.device("cpu"))."""
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 3)
    assert _device.normal("cuda") == torch.device("cuda", 3)
    assert _device.normal("cuda:1") == torch.device("cuda", 1)
    assert _device.normal("cpu") == CPU
    assert fused_node._scan_tensors(8, "cpu") is \
        fused_node._scan_tensors(8, CPU)
    assert satd._hadamard(8, "cpu") is satd._hadamard(8, CPU)
    seen = []
    built = _device.cached_per_device(lambda n, dev: seen.append(dev) or n)
    assert built(5, "cuda") == built(5, torch.device("cuda", 3)) == 5
    assert seen == [torch.device("cuda", 3)]
    assert built.cache_info().hits == 1


def test_checksum_weights_uploaded_once_per_device():
    rng = np.random.default_rng(7)
    flat = rng.integers(-128, 128, (3, 1000)).astype(np.int8)
    w = wf._dev_cksum_weights(1000, "cpu")
    assert w is wf._dev_cksum_weights(1000, CPU)
    np.testing.assert_array_equal(w.numpy(), wf._cksum_weights(1000))
    np.testing.assert_array_equal(wf._dev_cksum(torch.from_numpy(flat))
                                  .numpy(), wf._host_cksum(flat))
    assert wf._dev_cksum_weights.cache_info().hits >= 1
