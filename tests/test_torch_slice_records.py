"""The port's lean slice runner against the JAX package's, on the CPU.

The lean record buffer (per CTU [lay 21 | pm 21 | pm4 64] int8 in raster
order, plus a wrapping int32 checksum tail) must be byte-identical to
hevce_tpu's _dispatch_batch + _fetch_lean for the same images, qpd6, RMD
setting and prices. Every JAX slice call here has B=2, R=2, Cc=3, so this
file pays one compile of the JAX slice program (qpd6=2).
"""
import numpy as np
import pytest
import torch

from hevce_tpu.models import wavefront as jwf
from hevce_tpu.utils.tracing import PhaseTimer as JTimer
from hevce_tpu_torch.models import wavefront as twf
from hevce_tpu_torch.utils.tracing import PhaseTimer

# the test workers share the machine's cores: one intra-op thread each
torch.set_num_threads(1)


def _images():
    rng = np.random.default_rng(5)
    noise = rng.integers(0, 256, (64, 96)).astype(np.uint8)
    yy, xx = np.mgrid[0:64, 0:96]
    smooth = ((yy * 2 + xx) % 256).astype(np.uint8)
    return [noise, smooth]


def _both(imgs, qpd6, prices):
    out, meta = jwf._dispatch_batch(imgs, qpd6, want_recon=False,
                                    prices=prices)
    want_buf = np.asarray(out)
    want = jwf._fetch_lean(out, meta, JTimer())
    tout, tmeta = twf._dispatch_batch(imgs, qpd6, prices=prices, device="cpu")
    got_buf = tout.numpy()
    got = twf._fetch_lean(tout, tmeta, PhaseTimer())
    return want_buf, want, got_buf, got


@pytest.mark.parametrize("priced", [False, True], ids=["default", "predicted"])
def test_lean_records_match_jax(priced):
    imgs = _images()
    prices = None
    if priced:
        prices = twf._predict_prices(imgs, 2)
        want_p = jwf._predict_prices(imgs, 2)
        assert prices is not None, "the noise image must cross the trigger"
        for a, b in zip(prices, want_p):
            np.testing.assert_array_equal(a, b)
        assert prices[0][0] < twf.CTX_BIT and prices[0][1] == twf.CTX_BIT
    want_buf, want, got_buf, got = _both(imgs, 2, prices)
    assert got_buf.dtype == np.int8 and got_buf.shape == (2, 2 * 3 * 106 + 4)
    assert got_buf.tobytes() == want_buf.tobytes()
    np.testing.assert_array_equal(got, want)
    lay = got[..., twf._REC_LAY]
    # the content drives every partition kind somewhere in the batch
    assert {0, 1, 2, 3} <= set(np.unique(lay).tolist())


def test_checksum_wraps_in_int32():
    """torch sums integers in int64; the tail must carry the wrapped int32
    value that the JAX package and the host check compute."""
    rng = np.random.default_rng(9)
    flat = rng.integers(-128, 128, (3, 40_000)).astype(np.int8)
    flat[0] = 127                       # sum far past 2^31
    w = torch.from_numpy(twf._cksum_weights(flat.shape[1]))
    s64 = (torch.from_numpy(flat).to(torch.int32) * w).sum(-1,
                                                            dtype=torch.int64)
    assert int(s64[0]) > 2**31
    got = twf._wrap_i32(s64).numpy()
    np.testing.assert_array_equal(got, twf._host_cksum(flat))
    np.testing.assert_array_equal(got, jwf._host_cksum(flat))


def test_fetch_catches_corrupted_records():
    img = np.random.default_rng(3).integers(0, 256, (32, 32)).astype(np.uint8)
    out, meta = twf._dispatch_batch([img], 2, device="cpu")
    flat = out.numpy()
    flat.reshape(-1)[42] ^= 1            # inside the record, not the tail
    with pytest.raises(IOError, match="checksum mismatch"):
        twf._fetch_lean(out, meta, PhaseTimer())
