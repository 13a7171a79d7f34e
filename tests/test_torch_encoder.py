"""The port's Python spec encoder on the CPU against the JAX package's, at
tolerance 0: headers, the CABAC encoder, the syntax writers, the op
recorder, and encode_image against the golden streams and recons and
against the JAX encode_image.
"""
import numpy as np
import pytest
import torch

from hevce_tpu.bitstream import cabac as jcb
from hevce_tpu.bitstream import headers as jheaders
from hevce_tpu.bitstream import syntax as jsyntax
from hevce_tpu.models import encoder as jencoder
from hevce_tpu.ops import cabac_sim as jsim
from hevce_tpu_torch.bitstream import cabac as cb
from hevce_tpu_torch.bitstream import headers, syntax
from hevce_tpu_torch.models import encoder
from hevce_tpu_torch.ops import cabac_sim, fused_eval

# the test workers share the machine's cores: one intra-op thread each
torch.set_num_threads(1)

SIZES = [(32, 32), (64, 96), (96, 64), (128, 128), (512, 768), (768, 512),
         (32, 8192), (8192, 8192)]


@pytest.mark.parametrize("qpd6", range(5))
def test_write_headers_equals_jax(qpd6, golden):
    for ysz, xsz in SIZES:
        assert headers.write_headers(qpd6, ysz, xsz) == \
            jheaders.write_headers(qpd6, ysz, xsz), (ysz, xsz)
    g = golden("images")
    for t in range(int(g["n"])):
        if int(g[f"qpd6_{t}"]) != qpd6:
            continue
        rcon = g[f"rcon_{t}"]
        hdr = headers.write_headers(qpd6, *rcon.shape)
        assert bytes(g[f"stream_{t}"])[:len(hdr)] == hdr, f"image {t}"


def _replay(cbmod, g, t):
    """golden CABAC trace t through cbmod's encoder: (bit_len after every
    op, bytes, contexts)."""
    enc = cbmod.CabacEncoder()
    ctxs = cbmod.new_context_set(int(g["qpd6"][t]))
    lens = []
    for op in range(g["kind"].shape[1]):
        kind = int(g["kind"][t, op])
        a, b = int(g["a"][t, op]), int(g["b"][t, op])
        if kind == 0:
            enc.encode_bin(ctxs, a, b)
        elif kind == 1:
            enc.encode_bypass(a, b)
        else:
            enc.encode_terminate(0)
        lens.append(enc.bit_len())
    enc.finish()
    return lens, bytes(enc.buf), bytes(ctxs)


def test_cabac_encoder_replays_golden_traces_as_jax(golden):
    npz = golden("cabac")
    g = {k: npz[k] for k in npz.files}     # an npz decompresses per access
    for t in range(len(g["qpd6"])):
        lens, buf, ctxs = _replay(cb, g, t)
        assert (lens, buf, ctxs) == _replay(jcb, g, t), f"trace {t}"
        assert lens == [int(v) for v in g["length"][t]]
        assert buf == bytes(g["stream"][t][:int(g["nbytes"][t])])
        assert ctxs == bytes(g["ctxs"][t])


def test_cabac_encoder_copy_is_independent():
    rng = np.random.default_rng(3)
    enc = cb.CabacEncoder()
    ctxs = cb.new_context_set(2)
    for _ in range(400):
        enc.encode_bin(ctxs, int(rng.integers(0, cb.NUM_CTX)),
                       int(rng.integers(0, 2)))
    assert len(enc.buf) > 0
    snap = (bytes(enc.buf), enc.bit_len(), enc.low, enc.range)
    trial = enc.copy()
    trial_ctxs = bytearray(ctxs)
    for _ in range(400):
        trial.encode_bypass(int(rng.integers(0, 256)), 8)
        trial.encode_bin(trial_ctxs, 7, 1)
    trial.finish()
    assert trial.buf is not enc.buf
    assert (bytes(enc.buf), enc.bit_len(), enc.low, enc.range) == snap
    assert bytes(ctxs) != bytes(trial_ctxs)
    # the original goes on as if no copy had been taken
    again = enc.copy()
    enc.encode_terminate(1)
    again.encode_terminate(1)
    enc.finish()
    again.finish()
    assert bytes(enc.buf) == bytes(again.buf)


def _written(cbmod, writer, qpd6, *args):
    enc = cbmod.CabacEncoder()
    ctxs = cbmod.new_context_set(qpd6)
    writer(enc, ctxs, *args)
    n = enc.bit_len()
    enc.finish()
    return n, bytes(enc.buf), bytes(ctxs)


def test_put_coef_equals_jax_on_golden_blocks(golden):
    npz = golden("putcoef")
    g = {k: npz[k] for k in npz.files}
    for t in range(len(g["sz"])):
        sz, q, pm = int(g["sz"][t]), int(g["qpd6"][t]), int(g["pmode"][t])
        blk = g["blk"][t][:sz, :sz]
        got = _written(cb, syntax.put_coef, q, sz, False, pm, blk)
        assert got == _written(jcb, jsyntax.put_coef, q, sz, False, pm, blk)
        assert got[0] == int(g["length"][t])
        assert got[1] == bytes(g["stream"][t][:int(g["nbytes"][t])])
        assert got[2] == bytes(g["ctxs"][t])


def _random_blocks(rng, sz, n):
    """quantized-looking blocks: mostly small levels, some escapes, some
    all-zero (cbf 0), one with every coefficient at 2^15 - 1."""
    blks = rng.integers(-3, 4, (n, sz, sz)) * (rng.random((n, sz, sz)) < 0.3)
    blks[0] = 0
    blks[1, 0, 0] = 500
    blks[2] = 32767
    blks[3, sz - 1, sz - 1] = -9
    return blks.astype(np.int16)


@pytest.mark.parametrize("form", ["2nx2n", "tusplit", "nxn", "elements"])
def test_cu_writers_equal_jax_on_random_blocks(form):
    rng = np.random.default_rng(["2nx2n", "tusplit", "nxn",
                                 "elements"].index(form))
    cases = 0
    for sz in ((8, 16, 32) if form != "nxn" else (8,)):
        for k, blk in enumerate(_random_blocks(rng, sz, 12)):
            q = k % 5
            pm = int(rng.integers(0, 35))
            pl, pa = (int(v) for v in rng.integers(0, 35, 2))
            h = sz // 2
            subs = [blk[:h, :h], blk[:h, h:], blk[h:, :h], blk[h:, h:]]
            if form == "2nx2n":
                args = ("put_cu_2nx2n", sz, pm, pl, pa, blk)
            elif form == "tusplit":
                args = ("put_cu_2nx2n_tusplit", sz, pm, pl, pa, subs)
            elif form == "nxn":
                pms = [int(v) for v in rng.integers(0, 35, 4)]
                lefts = [pl, pms[0], int(rng.integers(0, 35)), pms[2]]
                aboves = [pa, int(rng.integers(0, 35)), pms[0], pms[1]]
                args = ("put_cu_nxn", sz, pms, lefts, aboves, subs)
            else:
                split = int(rng.integers(0, 2))
                args = ("put_split_cu_flag", sz, split, pl > pa, pa > pm)
            name, rest = args[0], args[1:]
            got = _written(cb, getattr(syntax, name), q, *rest)
            assert got == _written(jcb, getattr(jsyntax, name), q, *rest), \
                (form, sz, k)
            cases += 1
            if form == "elements":
                for nm, a in (("put_part_size", (sz, k % 2)),
                              ("put_split_tu_flag", (sz, k % 2)),
                              ("put_qt_cbf", (k % 2, k % 3 == 0, k % 2)),
                              ("put_uv_pmode", ()),
                              ("put_y_pmode", ([pm], [pl], [pa]))):
                    assert _written(cb, getattr(syntax, nm), q, *a) == \
                        _written(jcb, getattr(jsyntax, nm), q, *a), (nm, a)
                for v in (0, 1, 5, 47, 3000):
                    for r in range(5):
                        w = lambda m: lambda e, c: m.put_remain_exgolomb(
                            e, v, r)
                        assert _written(cb, w(syntax), q) == \
                            _written(jcb, w(jsyntax), q)
    assert cases >= 12
    if form == "elements":
        for left in range(35):
            for above in range(35):
                assert syntax.probable_pmodes(left, above) == \
                    jsyntax.probable_pmodes(left, above)
        for sz in (4, 8, 16, 32):
            for pm in range(35):
                st, tab = syntax.get_scan(sz, pm)
                jst, jtab = jsyntax.get_scan(sz, pm)
                assert st == jst and np.array_equal(tab, jtab)


def test_record_put_coef_equals_jax(golden):
    npz = golden("putcoef")
    g = {k: npz[k] for k in npz.files}
    rng = np.random.default_rng(11)
    cases = [(int(g["sz"][t]), int(g["pmode"][t]),
              g["blk"][t][:int(g["sz"][t]), :int(g["sz"][t])])
             for t in range(len(g["sz"]))]
    for sz in (4, 8, 16, 32):
        cases += [(sz, int(rng.integers(0, 35)), b)
                  for b in _random_blocks(rng, sz, 6)[1:]]
    for sz, pm, blk in cases:
        assert cabac_sim.record_put_coef(sz, pm, blk) == \
            jsim.record_put_coef(sz, pm, blk), (sz, pm)


def _count_k1(monkeypatch):
    """the candidate counts of every call of K1's wrapper."""
    calls = []
    k1 = fused_eval.pipeline_sse

    def counted(sz, qpd6, pred, blk):
        calls.append(pred.numel() // (sz * sz))
        return k1(sz, qpd6, pred, blk)
    monkeypatch.setattr(fused_eval, "pipeline_sse", counted)
    return calls


@pytest.mark.parametrize("t", range(5))
def test_encode_image_equals_golden_32x32(t, golden, monkeypatch):
    g = golden("images")
    img, q = g[f"img_{t}"], int(g[f"qpd6_{t}"])
    calls = _count_k1(monkeypatch)
    stream, rcon = encoder.encode_image(img, q, device="cpu")
    assert stream == bytes(g[f"stream_{t}"])
    np.testing.assert_array_equal(rcon, g[f"rcon_{t}"])
    # one CTU: 21 nodes x (2Nx2N + four TU-split subs) + 64 NxN PUs, each
    # call one row of 35 candidates
    assert len(calls) == 169 and set(calls) == {35}


def test_encode_image_equals_golden_with_padding(golden):
    g = golden("images")
    t = 17                                   # 50x70 at qpd6=2: 2x3 CTUs
    assert g[f"img_{t}"].shape == (50, 70)
    stream, rcon = encoder.encode_image(g[f"img_{t}"], int(g[f"qpd6_{t}"]),
                                        device="cpu")
    assert stream == bytes(g[f"stream_{t}"])
    np.testing.assert_array_equal(rcon, g[f"rcon_{t}"])


def test_encode_image_equals_jax_on_noise():
    img = np.random.default_rng(21).integers(0, 256, (32, 32)).astype(
        np.uint8)
    s, r = encoder.encode_image(img, 1, device="cpu")
    js, jr = jencoder.encode_image(img, 1)
    assert s == js
    np.testing.assert_array_equal(r, jr)


def test_rd_cost_equals_jax():
    big = [0, 1, 7, 2**20, 195225786, 195225787, 2**31 - 1]
    for q in range(5):
        for d in big:
            for b in big:
                assert encoder.rd_cost(q, d, b) == jencoder.rd_cost(q, d, b)


def test_encode_image_rejects_bad_input():
    with pytest.raises(ValueError):
        encoder.encode_image(np.zeros((32, 32), np.int32), 2, device="cpu")
    with pytest.raises(ValueError):
        encoder.encode_image(np.zeros((32, 32), np.uint8), 5, device="cpu")
