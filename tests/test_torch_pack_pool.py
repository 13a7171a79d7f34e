"""The fast mode's host pack on a pool of threads (models/wavefront
_pack_each): a batch's images packed at once give the streams, recons and
pack stats of the serial pack, in input order; a failed pack raises on the
caller; a batch of one packs inline; the timer counts the pooled images.
Records come from one CPU dispatch a shape, so no test waits on the card's
work twice.
"""
import sys
import threading

import numpy as np
import pytest
import torch

from hevce_tpu_torch.models import wavefront as wf
from hevce_tpu_torch.runtime import native
from hevce_tpu_torch.utils.tracing import PhaseTimer

# the test workers share the machine's cores: one intra-op thread each
torch.set_num_threads(1)


def _images():
    rng = np.random.default_rng(16)
    yy, xx = np.mgrid[0:64, 0:96]
    imgs = [rng.integers(0, 256, (64, 96)).astype(np.uint8),
            ((yy * 3 + xx * 2) % 256).astype(np.uint8),
            np.full((64, 96), 128, np.uint8),
            (rng.integers(0, 40, (64, 96)) + xx).astype(np.uint8),
            ((yy // 8 + xx // 8) % 2 * 200).astype(np.uint8),
            rng.integers(0, 256, (70, 100)).astype(np.uint8)]
    return imgs


@pytest.fixture(scope="module")
def batches(monkeypatch_module):
    """per shape batch: (indices, records, meta) at the pre pass's prices,
    and the serial pack's (streams, recons, stats) per image."""
    monkeypatch_module.delenv("HEVCE_ADAPT", raising=False)
    monkeypatch_module.setattr(wf, "_pack_width", lambda n: 1)
    imgs = _images()
    out, serial = [], {}
    for idx in wf._shape_batches(imgs, 8):
        sub = [imgs[i] for i in idx]
        res, meta = wf._dispatch_batch(
            sub, 2, prices=wf._predict_prices(sub, 2), device="cpu")
        rec = wf._fetch_lean(res, meta, PhaseTimer())
        st = []
        s, r = wf._pack_lean(rec, meta, True, PhaseTimer(), stats_out=st)
        for j, i in enumerate(idx):
            serial[i] = (s[j], r[j], st[j])
        out.append((idx, rec, meta))
    monkeypatch_module.undo()
    return imgs, out, serial


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


def _same_stats(a, b):
    return a[:3] == b[:3] and np.array_equal(a[3], b[3])


@pytest.mark.parametrize("width,repeat,post", [
    (None, 1, False), (None, 1, True), (2, 1, True), (3, 1, False),
    (16, 8, True)])          # more threads than cores, tasks switched often
def test_pooled_pack_equals_serial(batches, monkeypatch, width, repeat, post):
    """streams, recons and (under post) each image's pack stats, in input
    order, equal the serial pack's at any width; the timer counts every
    image packed off the calling thread."""
    imgs, out, serial = batches
    if width is not None:
        monkeypatch.setattr(wf, "_pack_width", lambda n: min(n, width))
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for idx, rec, meta in out:
            idx = idx * repeat
            rec = np.concatenate([rec] * repeat)
            meta = ([imgs[i] for i in idx],) + meta[1:]
            timer, st = PhaseTimer(), [] if post else None
            s, r = wf._pack_lean(rec, meta, True, timer, stats_out=st)
            assert s == [serial[i][0] for i in idx]
            for j, i in enumerate(idx):
                assert np.array_equal(r[j], serial[i][1])
                assert not post or _same_stats(st[j], serial[i][2])
            pooled = len(idx) if wf._pack_width(len(idx)) > 1 else 0
            assert timer.counts["pack_pooled"] == pooled
            assert timer.counts["pack"] == 1
    finally:
        sys.setswitchinterval(old)


def test_a_failed_pack_raises_on_the_caller(batches, monkeypatch):
    """one image's failed pack raises on the caller with no partial batch;
    the pool packs the next batch as before."""
    imgs, out, serial = batches
    idx, rec, meta = out[0]
    pack = native.pack_forest_img
    bad = meta[0][2]

    def fails_once(lay, pm, pm4, img, qpd6):
        if img is bad:
            raise ValueError("hevce_pack_img failed: -2")
        return pack(lay, pm, pm4, img, qpd6)
    monkeypatch.setattr(wf, "_pack_width", lambda n: min(n, 3))
    monkeypatch.setattr(native, "pack_forest_img", fails_once)
    timer = PhaseTimer()
    with pytest.raises(ValueError, match="hevce_pack_img failed"):
        wf._pack_lean(rec, meta, True, timer)
    assert timer.counts["pack_pooled"] == 0
    monkeypatch.setattr(native, "pack_forest_img", pack)
    s, _ = wf._pack_lean(rec, meta, False, timer)
    assert s == [serial[i][0] for i in idx]
    assert timer.counts["pack_pooled"] == len(idx)


def test_a_batch_of_one_packs_inline(batches, monkeypatch):
    """a batch of one image packs on the calling thread, and counts no
    pooled image; a batch of two goes to the pool."""
    imgs, out, serial = batches
    threads = []
    pack = native.pack_forest_img

    def spy(*a):
        threads.append(threading.get_ident())
        return pack(*a)
    monkeypatch.setattr(native, "pack_forest_img", spy)
    monkeypatch.setattr(wf, "_pack_width", lambda n: min(n, 2))
    (i,), rec, meta = out[1]
    timer, st = PhaseTimer(), []
    s, r = wf._pack_lean(rec, meta, False, timer, stats_out=st)
    assert threads == [threading.get_ident()] and r == [None]
    assert s == [serial[i][0]] and _same_stats(st[0], serial[i][2])
    assert timer.counts["pack_pooled"] == 0
    idx, rec, meta = out[0]
    wf._pack_lean(rec[:2], ([imgs[j] for j in idx[:2]],) + meta[1:], False,
                  timer)
    assert threading.get_ident() not in threads[1:] and len(threads) == 3
    assert timer.counts["pack_pooled"] == 2


@pytest.mark.parametrize("fetch_qc", [False, True])
def test_encode_many_fast_counts_pooled_images(batches, monkeypatch,
                                               fetch_qc):
    """encode_many_fast at batch 3: batches of 3, 2 and 1 image; the 5 of
    the first two are pooled, lean and full records alike, and the streams
    are the serial pack's."""
    imgs, out, serial = batches
    monkeypatch.delenv("HEVCE_ADAPT", raising=False)
    monkeypatch.setattr(wf, "_pack_width", lambda n: min(n, 2))
    timer = PhaseTimer()
    s, r = wf.encode_many_fast(imgs, 2, batch=3, timer=timer, device="cpu",
                               fetch_qc=fetch_qc)
    assert s == [serial[i][0] for i in range(len(imgs))]
    for i, rc in enumerate(r):
        assert np.array_equal(rc, serial[i][1])
    assert timer.counts["pack"] == 3
    assert timer.counts["pack_pooled"] == 5


def test_pack_width(monkeypatch):
    """one thread an image up to the usable cores; one while the pack's
    calibration dump (HEVCE_PACK_STATS, one file for every image) is on."""
    monkeypatch.delenv("HEVCE_PACK_STATS", raising=False)
    cores = wf._usable_cores()
    assert cores >= 1 and wf._pack_width(1) == 1
    assert wf._pack_width(8) == min(8, cores)
    monkeypatch.setenv("HEVCE_PACK_STATS", "stats.bin")
    assert wf._pack_width(8) == 1
