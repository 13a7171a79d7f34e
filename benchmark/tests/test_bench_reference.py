"""The frozen reference against the port's CPU path, on tiny images under
both configurations' settings; the frozen decoder against the port's
native engine; and the lower-precision controls failing."""
import numpy as np
import pytest
import torch

from benchmark import synth
from benchmark.reference import decoder, search

SETTINGS = {"kodak24-q16-rmd": (2, (12, 4)), "ctcB-q22-dense": (3, None)}


def images(seed):
    rng = np.random.default_rng(seed)
    return [synth.synth_image(rng, 40, 96, 30.0),
            synth.synth_image(rng, 40, 96, 3.0),
            synth.synth_image(rng, 72, 40, 6.0)]


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("config", sorted(SETTINGS))
def test_reference_equals_the_port_on_the_cpu(config):
    from hevce_tpu_torch.models import wavefront
    qpd6, rmd = SETTINGS[config]
    imgs = images(11)
    streams, recons = wavefront.encode_many_fast(
        imgs, qpd6, batch=2, want_recon=True, rmd=rmd, device="cpu")
    want = search.encode_recon(imgs, qpd6, rmd, "cpu")
    for s, r, w in zip(streams, recons, want):
        assert np.array_equal(r, w)
        assert np.array_equal(decoder.decode(s), w)


def test_decoder_equals_the_native_engine():
    from hevce_tpu_torch.runtime import native
    img = images(3)[0]
    for qpd6 in (2, 3):
        s, r = native.encode_image_native(img, qpd6)
        assert np.array_equal(decoder.decode(s), r)


@pytest.mark.parametrize("config", sorted(SETTINGS))
def test_lower_precision_fails(config):
    """each control's pictures, through the harness's comparison, come out
    not correct."""
    from benchmark import check
    from benchmark.reference import xform
    qpd6, rmd = SETTINGS[config]
    imgs = images(5)
    exact = search.encode_recon(imgs, qpd6, rmd, "cpu")
    sample = list(range(len(imgs)))
    for dtype in (torch.int16, torch.bfloat16):
        with search.transform_dtype(dtype):
            ctl = search.encode_recon(imgs, qpd6, rmd, "cpu")
        readings, _ = check.run(imgs, {i: [i] for i in sample}, sample,
                                lambda _: exact, 0, sample,
                                decode=lambda i: (ctl[i], None))
        assert readings["recon_mismatch_px"] > 0, dtype
        assert not check.verdict(readings), dtype
    assert xform.DTYPE == torch.float64
