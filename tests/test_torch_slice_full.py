"""The port's full-record fast mode (fetch_qc=True) against the JAX
package's, on the CPU.

Full records are per CTU [lay 21 | pm 21 | pm4 64 | qc8 1024] int8, with
the side array [ck, esc, ckS, ck16] (int32 checksums of the buffer, the
recon plane and the int16 quant sideband, and the flag of an image whose
levels escape int8), the int16 sideband and the device recon. They must
equal hevce_tpu's, and pack to the same streams as the lean records. The
JAX slice call here has B=2, R=2, Cc=2 at qpd6=2 with RMD (12, 4) and the
recon plane: one compile (module fixture). The escape cases at qpd6=0 run
on the port only.
"""
import numpy as np
import pytest
import torch

from hevce_tpu.models import wavefront as jwf
from hevce_tpu.utils.tracing import PhaseTimer as JTimer
from hevce_tpu_torch.models import wavefront as twf
from hevce_tpu_torch.runtime import native
from hevce_tpu_torch.utils.tracing import PhaseTimer

# the test workers share the machine's cores: one intra-op thread each
torch.set_num_threads(1)


def _images():
    rng = np.random.default_rng(37)
    noise = rng.integers(0, 256, (64, 64)).astype(np.uint8)
    yy, xx = np.mgrid[0:64, 0:64]
    texture = ((yy * 5 + xx * 3) % 256 ^ (xx * 7 % 64)).astype(np.uint8)
    return [noise, texture]


@pytest.fixture(scope="module")
def jax_full():
    """the JAX package's full records (buf, side, qc16, plane) and the
    streams and recons _finish_batch packs from them."""
    imgs = _images()
    out, meta = jwf._dispatch_batch(imgs, 2, want_recon=True, fetch_qc=True)
    arrays = [np.asarray(a) for a in out]
    streams, recons = jwf._finish_batch(out, meta, True, JTimer(), True)
    return imgs, arrays, streams, recons


def test_full_records_match_jax(jax_full):
    imgs, (buf, side, qc16, plane), _, _ = jax_full
    out, meta = twf._dispatch_batch(imgs, 2, device="cpu", fetch_qc=True)
    got = [out[0].numpy(), out[1].numpy(), out[2].numpy(), out[3].numpy()]
    for name, g, w in zip(("buf", "side", "qc16", "plane"), got,
                          (buf, side, qc16, plane)):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert g.tobytes() == w.tobytes(), name
    assert buf.shape == (2, 2, 2, twf._REC_LEN)
    np.testing.assert_array_equal(side[:, 0], twf._host_cksum(
        buf.reshape(2, -1)))


def test_full_streams_match_jax_and_lean(jax_full):
    imgs, _, want, want_r = jax_full
    got, got_r = twf.encode_batch_fast(imgs, 2, device="cpu", fetch_qc=True)
    lean, lean_r = twf.encode_batch_fast(imgs, 2, device="cpu")
    assert got == want == lean
    for r, wr, lr, s in zip(got_r, want_r, lean_r, got):
        np.testing.assert_array_equal(r, wr)
        np.testing.assert_array_equal(r, lr)
        np.testing.assert_array_equal(native.decode_stream(s), r)


def _noise32(seed=41):
    return np.random.default_rng(seed).integers(0, 256, (32, 32)).astype(
        np.uint8)


def test_escapes_take_the_int16_sideband(monkeypatch):
    """at qpd6=0 noise has levels outside int8: the side flag is set, the
    int8 quant plane is clipped, and the streams still equal the lean
    path's, through encode_many_fast too (port only)."""
    monkeypatch.delenv("HEVCE_ADAPT", raising=False)
    imgs = [_noise32(), _noise32(43)]
    out, _ = twf._dispatch_batch(imgs, 0, device="cpu", fetch_qc=True)
    side, qc16 = out[1].numpy(), out[2].numpy()
    assert side[:, 1].all()
    qc8 = out[0].numpy()[..., twf._REC_QC8]
    assert (np.abs(qc16) > 127).any()
    assert not np.array_equal(qc8.astype(np.int32), qc16.astype(np.int32))
    got, got_r = twf.encode_many_fast(imgs, 0, batch=1, device="cpu",
                                      fetch_qc=True)
    lean, lean_r = twf.encode_many_fast(imgs, 0, batch=1, device="cpu")
    assert got == lean
    for r, lr in zip(got_r, lean_r):
        np.testing.assert_array_equal(r, lr)


@pytest.mark.parametrize("part", ["buf", "plane", "qc16"])
def test_finish_catches_corrupted_full_records(part):
    img = _noise32()
    out, meta = twf._dispatch_batch([img], 0, device="cpu", fetch_qc=True)
    assert out[1].numpy()[0, 1] == 1            # the sideband is read
    target = {"buf": out[0].numpy(), "plane": out[3].numpy(),
              "qc16": out[2].numpy()}[part]
    target.reshape(-1)[100] ^= 1
    with pytest.raises(IOError, match="checksum mismatch"):
        twf._finish_batch(out, meta, True, PhaseTimer(), fetch_qc=True)
