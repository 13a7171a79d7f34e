"""The port's encode_many_fast against the JAX package's, on the CPU.

Under the default HEVCE_ADAPT=pre, a mixed-shape list encoded at batch=2
(so batches queue ahead of the drain) must give streams byte-identical to
hevce_tpu's, and every stream must decode, through the port's own native
decoder, to the recon the port returns. Every JAX slice call here has B=2,
R=2, Cc=3 (64x96 and 50x70 both pad to 64x96): one compile at qpd6=2.
"""
import numpy as np
import torch

from hevce_tpu.models import wavefront as jwf
from hevce_tpu_torch.models import wavefront as twf
from hevce_tpu_torch.runtime import native

# the test workers share the machine's cores: one intra-op thread each
torch.set_num_threads(1)


def _images():
    rng = np.random.default_rng(13)
    yy, xx = np.mgrid[0:64, 0:96]
    smooth = ((yy * 2 + xx) % 256).astype(np.uint8)
    noise = rng.integers(0, 256, (64, 96)).astype(np.uint8)
    y5, x5 = np.mgrid[0:50, 0:70]
    bands = (128 + 100 * np.sin(x5 / 3.0) * np.cos(y5 / 5.0)).astype(np.uint8)
    odd_noise = rng.integers(0, 256, (50, 70)).astype(np.uint8)
    return [noise, bands, smooth, odd_noise]


def test_encode_many_fast_streams_match_jax(monkeypatch):
    monkeypatch.delenv("HEVCE_ADAPT", raising=False)
    imgs = _images()
    assert twf.adapt_mode() == "pre"
    want, want_r = jwf.encode_many_fast(imgs, 2, batch=2)
    got, got_r = twf.encode_many_fast(imgs, 2, batch=2, device="cpu")
    assert len(got) == len(imgs)
    for i, (s, r) in enumerate(zip(got, got_r)):
        assert s == want[i], f"stream {i} differs from the JAX package's"
        np.testing.assert_array_equal(r, want_r[i])
        np.testing.assert_array_equal(native.decode_stream(s), r)
        ysz, xsz = imgs[i].shape
        assert r.shape == (-(-ysz // 32) * 32, -(-xsz // 32) * 32)

    s2, r2 = twf.encode_many_fast(imgs, 2, batch=2, want_recon=False,
                                  device="cpu")
    assert s2 == got and all(r is None for r in r2)


def test_encode_batch_fast_constant_prices_match_jax():
    """encode_batch_fast runs at the constant knob prices (no adaptation)."""
    imgs = _images()[0::2]                 # the two 64x96 images
    want, want_r = jwf.encode_batch_fast(imgs, 2)
    got, got_r = twf.encode_batch_fast(imgs, 2, device="cpu")
    assert got == want
    for r, wr in zip(got_r, want_r):
        np.testing.assert_array_equal(r, wr)
