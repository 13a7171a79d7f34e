"""The port's dense (rmd=None) fast mode against the JAX package's, on the
CPU.

With rmd=None every node searches all 35 modes in both TU layouts, and
each 8x8 leaf's NxN PU0 reuses its TU-split's first sub-TU eval. The lean
records and the streams must be byte-identical to hevce_tpu's for the same
images. Every JAX slice call here has B=2, R=2, Cc=2 at qpd6=2, so the file
pays one compile of the JAX dense slice program (module fixture).
"""
import numpy as np
import pytest
import torch

from hevce_tpu.models import wavefront as jwf
from hevce_tpu.utils.tracing import PhaseTimer as JTimer
from hevce_tpu_torch.models import wavefront as twf
from hevce_tpu_torch.models import cu_eval
from hevce_tpu_torch.runtime import native
from hevce_tpu_torch.utils.tracing import PhaseTimer

# the test workers share the machine's cores: one intra-op thread each
torch.set_num_threads(1)

QPD6 = 2


def _images():
    rng = np.random.default_rng(29)
    noise = rng.integers(0, 256, (64, 64)).astype(np.uint8)
    yy, xx = np.mgrid[0:64, 0:64]
    bands = (128 + 100 * np.sin(xx / 3.0) * np.cos(yy / 5.0)).astype(np.uint8)
    return [noise, bands]


@pytest.fixture(scope="module")
def jax_dense():
    """the JAX package's dense lean records and streams for _images()."""
    imgs = _images()
    out, meta = jwf._dispatch_batch(imgs, QPD6, want_recon=False, rmd=None)
    buf = np.asarray(out)
    rec = jwf._fetch_lean(out, meta, JTimer())
    streams, recons = jwf.encode_batch_fast(imgs, QPD6, rmd=None)
    return imgs, buf, rec, streams, recons


def test_dense_lean_records_match_jax(jax_dense):
    imgs, want_buf, want, _, _ = jax_dense
    out, meta = twf._dispatch_batch(imgs, QPD6, None, device="cpu")
    got_buf = out.numpy()
    assert got_buf.shape == (2, 2 * 2 * 106 + 4)
    assert got_buf.tobytes() == want_buf.tobytes()
    got = twf._fetch_lean(out, meta, PhaseTimer())
    np.testing.assert_array_equal(got, want)
    # the content drives every partition kind somewhere in the batch
    assert {0, 1, 2, 3} <= set(np.unique(got[..., twf._REC_LAY]).tolist())


def test_dense_streams_match_jax_and_decode(jax_dense, monkeypatch):
    """HEVCE_RMD=off selects the same dense path as rmd=None."""
    imgs, _, _, want, want_r = jax_dense
    monkeypatch.setenv("HEVCE_RMD", "off")
    got, got_r = twf.encode_batch_fast(imgs, QPD6, device="cpu")
    assert got == want
    for s, r, wr in zip(got, got_r, want_r):
        np.testing.assert_array_equal(r, wr)
        np.testing.assert_array_equal(native.decode_stream(s), r)


def test_full_width_rmd_equals_dense(jax_dense):
    """rmd=(35, 35) keeps every mode, so its records equal the dense ones
    although its NxN PU0 is evaluated on its own (port only)."""
    imgs, want_buf = jax_dense[:2]
    out, _ = twf._dispatch_batch(imgs, QPD6, (35, 35), device="cpu")
    assert out.numpy().tobytes() == want_buf.tobytes()


@pytest.mark.parametrize("value", ["off", "none", "0", "explicit"])
def test_rmd_off_resolves_to_dense(monkeypatch, value):
    if value == "explicit":
        monkeypatch.setenv("HEVCE_RMD", "12,4")
        assert twf._resolve_rmd(None) is None
        assert twf._resolve_rmd(twf._RMD_ENV) == (12, 4)
    else:
        monkeypatch.setenv("HEVCE_RMD", value)
        assert twf._resolve_rmd(twf._RMD_ENV) is None
        assert jwf._resolve_rmd(jwf._RMD_ENV) is None


def test_dense_leaf_sub0_is_the_nxn_pu0_eval():
    """one 8x8 leaf: the dense TU-split's sub0 equals PU0's own 35-mode
    eval, so _eval_nxn gives the same result with it as without it (port
    only; the slice tests hold the whole dense path to the JAX package)."""
    rng = np.random.default_rng(31)
    B, y0, x0 = 5, 8, 0
    t = torch.from_numpy
    A = t(rng.integers(0, 256, (B, 33, 33)).astype(np.uint8))
    orig = t(rng.integers(0, 256, (B, 32, 32)).astype(np.uint8))
    orig[1] = A[1, 1:, 1:] // 2 + 60                # smooth content
    fl = t(rng.random((B, 4)) < 0.6)
    fl[0] = True
    pm = [t(p) for p in rng.integers(0, 35, (4, B)).astype(np.int32)]
    ctx = rng.integers(int(0.4 * twf.BIT), int(0.8 * twf.BIT), B)
    prices = (t(ctx.astype(np.int32)), t(np.full(B, twf.SIG_ZERO, np.int32)))

    node, sub0 = twf._eval_node(QPD6, A, orig, fl, pm[0], pm[1], y0, x0, 8,
                                prices, return_sub0=True)
    assert [x.dtype for x in node] == [torch.int32, torch.int32, torch.int32,
                                       torch.int16, torch.uint8]
    top, left = twf._node_ctx(A, y0, x0, 4)
    f4 = twf._sub_flags(tuple(fl[:, k] for k in range(4)))[0]
    pu0 = cu_eval.eval_2nx2n(4, QPD6, top, left, torch.stack(f4, -1),
                             orig[:, y0:y0 + 4, x0:x0 + 4])
    for g, w in zip(sub0, pu0):
        assert torch.equal(g, w)
    reused = twf._eval_nxn(QPD6, A, orig, fl, *pm, y0, x0, prices, sub0=sub0)
    own = twf._eval_nxn(QPD6, A, orig, fl, *pm, y0, x0, prices)
    for g, w in zip(reused, own):
        assert torch.equal(g, w)
