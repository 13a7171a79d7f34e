"""The port's hinted bit-exact encode and HEVCE_ADAPT=post against the JAX
package's, on the CPU.

encode_many_exact hands the fast mode's lean records to the native engine
as trial-order hints: its streams must equal hevce_tpu's and
native.encode_image_native's byte for byte. Under HEVCE_ADAPT=post the
images whose packed bits per pixel cross the trigger are re-encoded at
lower context prices and the better stream is kept: the streams must equal
hevce_tpu's. Every JAX slice call here has B=2, R=2, Cc=3 at qpd6=2 with
RMD (12, 4), the program tests/test_torch_slice_records.py compiles too.
"""
import itertools

import numpy as np
import pytest
import torch

from hevce_tpu.models import wavefront as jwf
from hevce_tpu_torch.models import wavefront as twf
from hevce_tpu_torch.runtime import native
from hevce_tpu_torch.utils.tracing import PhaseTimer

# the test workers share the machine's cores: one intra-op thread each
torch.set_num_threads(1)


def _images():
    rng = np.random.default_rng(47)
    noise = rng.integers(0, 256, (64, 96)).astype(np.uint8)
    yy, xx = np.mgrid[0:64, 0:96]
    smooth = ((yy * 2 + xx) % 256).astype(np.uint8)
    return [noise, smooth]


def test_encode_many_exact_matches_jax_and_native():
    imgs = _images()
    want, want_r = jwf.encode_many_exact(imgs, 2, nthreads=2, batch=2)
    timer = PhaseTimer()
    got, got_r = twf.encode_many_exact(imgs, 2, nthreads=2, timer=timer,
                                       batch=2, device="cpu")
    assert got == want
    assert timer.counts["host_rdo"] == 1 and timer.totals["host_rdo"] > 0
    for i, (s, r) in enumerate(zip(got, got_r)):
        ref_s, ref_r = native.encode_image_native(imgs[i], 2)
        assert s == ref_s, f"stream {i} differs from encode_image_native's"
        np.testing.assert_array_equal(r, ref_r)
        np.testing.assert_array_equal(r, want_r[i])


def test_hints_leave_native_streams_unchanged():
    imgs = _images()
    out, meta = twf._dispatch_batch(imgs, 2, device="cpu")
    hints = twf._fetch_lean(out, meta, PhaseTimer())
    plain = native.encode_many_native(imgs, 2, nthreads=2)
    hinted = native.encode_many_native(imgs, 2, nthreads=2, hints=hints)
    assert plain[0] == hinted[0]
    with pytest.raises(ValueError, match="hints"):
        native.encode_many_native(imgs, 2, hints=hints[:1])


def test_adapt_post_streams_match_jax(monkeypatch):
    monkeypatch.setenv("HEVCE_ADAPT", "post")
    imgs = _images()
    want, want_r = jwf.encode_many_fast(imgs, 2, batch=2)
    timer = PhaseTimer()
    got, got_r = twf.encode_many_fast(imgs, 2, batch=2, timer=timer,
                                      device="cpu")
    assert timer.counts["adapt_flagged"] == 1, \
        "the noise image, and only it, must cross the trigger"
    assert timer.counts["dispatch"] == 2            # the corrective batch
    assert got == want
    for s, r, wr in zip(got, got_r, want_r):
        np.testing.assert_array_equal(r, wr)
        np.testing.assert_array_equal(native.decode_stream(s), r)


def test_adapt_rule_matches_jax():
    for qpd6, npix, bits in itertools.product(
            range(5), (0, 1, 1024, 393216),
            (0, 1, 5000, 100_000, 1_000_000, 3_000_000)):
        for nctx, nbyp in ((0, 0), (bits // 2, bits // 3)):
            got = twf._adapt_rule(bits, nctx, nbyp, npix, qpd6)
            assert got == jwf._adapt_rule(bits, nctx, nbyp, npix, qpd6), (
                qpd6, npix, bits)
    assert twf.ADAPT_BPP_TRIGGER == jwf.ADAPT_BPP_TRIGGER
    assert twf.ADAPT_BPP_ALLOW == jwf.ADAPT_BPP_ALLOW
    # a flagged image's price falls with its bits per pixel, to the floor
    hi = twf._adapt_rule(6 * 1024, 0, 0, 1024, 2)
    assert hi[0] < twf.CTX_BIT and hi[1] == twf.SIG_ZERO
    assert twf._adapt_rule(60 * 1024, 0, 0, 1024, 2)[0] == twf.ADAPT_FLOOR


def test_exact_and_post_with_no_images(monkeypatch):
    monkeypatch.setenv("HEVCE_ADAPT", "post")
    assert twf.encode_many_fast([], 2, device="cpu") == ([], [])
    assert twf.encode_many_exact([], 2, device="cpu") == ([], [])
