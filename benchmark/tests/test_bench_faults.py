"""A run with the timed path broken underneath comes out not correct.

Each test drives a whole run of a tiny cell on the CPU (harness.drive: the
harness's look for a card skipped), with one fault planted in the program
for the run: a front step that leaves its state unchanged; half of each
batch left out, its streams taken from the other half; half of each call's
streams left out of what it returns; a stream altered where the pack
produces it. (The cells run on one card, so there is no
exchange between chips to leave out.) A sound run beside them comes out
correct."""
import time

import pytest
import torch

from benchmark import harness
from benchmark.tests import helpers


def run(tmp_path):
    from hevce_tpu_torch.models import wavefront
    helpers.tiny_bench(tmp_path)
    b = harness.Bench(root=tmp_path, bench_dir=tmp_path / "bench")
    wavefront._slice_runner_cache.cache_clear()
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        return harness.drive(b, "tiny.pool", 2 ** 32 + 5, 0.2, 0,
                             time.perf_counter(), device="cpu")
    finally:
        torch.set_num_threads(n)
        wavefront._slice_runner_cache.cache_clear()


def state_unchanged(mp):
    from hevce_tpu_torch.models import wavefront
    mp.setattr(wavefront._SliceRunner, "step", lambda self: None)


def half_batch_left_out(mp):
    from hevce_tpu_torch.models import wavefront
    pack = wavefront._pack_lean

    def half(rec, meta, *a, **kw):
        streams, recons = pack(rec, meta, *a, **kw)
        keep = -(-len(streams) // 2)
        return ([streams[b % keep] for b in range(len(streams))],
                [recons[b % keep] for b in range(len(recons))])
    mp.setattr(wavefront, "_pack_lean", half)


def streams_dropped(mp):
    from hevce_tpu_torch.models import wavefront
    encode = wavefront.encode_many_fast

    def half(images, *a, **kw):
        streams, recons = encode(images, *a, **kw)
        return streams[:len(streams) // 2], recons[:len(recons) // 2]
    mp.setattr(wavefront, "encode_many_fast", half)


def answer_altered(mp):
    from hevce_tpu_torch.runtime import native
    pack = native.pack_forest_img

    def altered(*a, **kw):
        s, r = pack(*a, **kw)
        s = bytearray(s)
        s[len(s) * 3 // 4] ^= 0x24
        return bytes(s), r
    mp.setattr(native, "pack_forest_img", altered)


def test_a_sound_run_is_correct(tmp_path):
    out = run(tmp_path)
    assert out["correct"] is True
    assert all(v["value"] == 0 for v in out["compared"].values())


@pytest.mark.parametrize("fault", [state_unchanged, half_batch_left_out,
                                   streams_dropped, answer_altered])
def test_a_fault_is_not_correct(fault, tmp_path, monkeypatch):
    fault(monkeypatch)
    out = run(tmp_path)
    assert out["correct"] is False, out["compared"]
