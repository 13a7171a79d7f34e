"""The port's fast mode at qpd6=4 against the JAX package's, on the CPU,
plus the degenerate CTU grids (port only).

Every JAX slice call here has B=2, R=2, Cc=3: one compile at qpd6=4.
"""
import numpy as np
import torch

from hevce_tpu.models import wavefront as jwf
from hevce_tpu.utils.tracing import PhaseTimer as JTimer
from hevce_tpu_torch.models import wavefront as twf
from hevce_tpu_torch.runtime import native
from hevce_tpu_torch.utils.tracing import PhaseTimer

# the test workers share the machine's cores: one intra-op thread each
torch.set_num_threads(1)

QPD6 = 4


def _images():
    rng = np.random.default_rng(17)
    noise = rng.integers(0, 256, (64, 96)).astype(np.uint8)
    yy, xx = np.mgrid[0:64, 0:96]
    texture = ((yy * 5 + xx * 3) % 256 ^ (xx * 7 % 64)).astype(np.uint8)
    return [noise, texture]


def test_records_and_streams_match_jax_at_qpd6_4(monkeypatch):
    monkeypatch.delenv("HEVCE_ADAPT", raising=False)
    imgs = _images()
    prices = twf._predict_prices(imgs, QPD6)
    assert prices is not None
    out, meta = jwf._dispatch_batch(imgs, QPD6, want_recon=False,
                                    prices=prices)
    want = jwf._fetch_lean(out, meta, JTimer())
    tout, tmeta = twf._dispatch_batch(imgs, QPD6, prices=prices, device="cpu")
    assert tout.numpy().tobytes() == np.asarray(out).tobytes()
    np.testing.assert_array_equal(twf._fetch_lean(tout, tmeta, PhaseTimer()),
                                  want)

    want_s, want_r = jwf.encode_many_fast(imgs, QPD6, batch=2)
    got_s, got_r = twf.encode_many_fast(imgs, QPD6, batch=2, device="cpu")
    assert got_s == want_s
    for s, r, wr in zip(got_s, got_r, want_r):
        np.testing.assert_array_equal(r, wr)
        np.testing.assert_array_equal(native.decode_stream(s), r)


def test_degenerate_grids_decode_to_recon():
    """single CTU, single row (R=1) and single column (Cc=1): the front
    core's window and flag edges (no above row, no left column)."""
    rng = np.random.default_rng(21)
    for shape in ((32, 32), (32, 96), (96, 32)):
        img = rng.integers(0, 256, shape).astype(np.uint8)
        s, r = twf.encode_image_fast(img, 2, device="cpu")
        np.testing.assert_array_equal(native.decode_stream(s), r)
