"""Parity of the PyTorch port's ops with the JAX package's, on the CPU.

Every comparison is exact (tolerance 0): the codec is integer math, and the
port's float products (angular prediction, transforms, SATD) are exact by
their bounds. Inputs are the golden vectors in tests/data plus numpy-seeded
noise at qpd6 0-4, fed to both packages as numpy arrays.
"""
import ast
import functools
import pathlib

import jax
import numpy as np
import pytest
import torch

from hevce_tpu.models import wavefront as jwf
from hevce_tpu.ops import constants as JC
from hevce_tpu.ops import intra as jintra
from hevce_tpu.ops import quant as jquant
from hevce_tpu.ops import rdcost as jrdcost
from hevce_tpu.ops import satd as jsatd
from hevce_tpu.ops import xform as jxform
from hevce_tpu_torch import params
from hevce_tpu_torch.models import wavefront as twf
from hevce_tpu_torch.ops import constants as TC
from hevce_tpu_torch.ops import fused_eval, intra, quant, rdcost, satd, xform
from hevce_tpu_torch.runtime import native

# the test workers share the machine's cores: one intra-op thread each
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
SIZES = (4, 8, 16, 32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _groups(keys):
    out = {}
    for i in range(len(keys[0])):
        out.setdefault(tuple(int(k[i]) for k in keys), []).append(i)
    return out


# ------------------------------------------------------------------ tables

def test_constants_equal_jax_package():
    names = [n for n in dir(JC) if n.isupper()]
    assert names and sorted(names) == sorted(n for n in dir(TC) if n.isupper())
    for n in names:
        a, b = getattr(JC, n), getattr(TC, n)
        if isinstance(a, dict):
            assert a.keys() == b.keys(), n
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=n)
        else:
            np.testing.assert_array_equal(a, b, err_msg=n)


def test_tables_from_numpy_identity():
    """The JAX package's tables, run through tables_from_numpy, equal the
    port's own tensors exactly."""
    jax_tables = dict(
        transform_mat={sz: JC.TRANSFORM_MAT[sz] for sz in SIZES},
        level_rate=JC.LEVEL_RATE_TABLE,
        rd_weight_dist=JC.RDCOST_WEIGHT_DIST,
        rd_weight_bits=JC.RDCOST_WEIGHT_BITS,
        shifts={name: np.array([getattr(JC, name)[sz] for sz in SIZES],
                               np.int32)
                for name in ("FWD_SHIFT_A", "QUANT_DIST_SHIFT",
                             "QUANT_LEVEL_SHIFT", "DEQUANT_SHIFT")},
        angular={sz: jintra._angular_matrix(sz) for sz in SIZES},
        scan={sz: jwf._scan_consts(sz) for sz in SIZES},
        prices=(np.array([jwf._ctx_default(q) for q in range(5)], np.int32),
                np.full(5, jwf.SIG_ZERO, np.int32)),
    )
    got = params.tables_from_numpy(**jax_tables)
    own = params.tables("cpu")

    def same(a, b, path):
        if isinstance(a, dict):
            assert a.keys() == b.keys(), path
            for k in a:
                same(a[k], b[k], f"{path}/{k}")
        elif isinstance(a, tuple):
            assert len(a) == len(b), path
            for k, (x, y) in enumerate(zip(a, b)):
                same(x, y, f"{path}/{k}")
        else:
            assert a.dtype == b.dtype and torch.equal(a, b), path

    assert got.keys() == own.keys()
    same(got, own, "tables")


# ------------------------------------------------------------------ rdcost

def test_rd_cost_saturation_and_sse():
    big = torch.tensor([2**31 - 1], dtype=torch.int32) // 11 + 1
    assert int(rdcost.calc_rd_cost(0, big, torch.tensor([0]))[0]) == 2**31 - 1
    got = rdcost.calc_rd_cost(3, torch.tensor([10]), torch.tensor([7]))
    assert int(got[0]) == 5 * 10 + 29 * 7
    a = torch.tensor([[[1, 2], [3, 4]]], dtype=torch.int32)
    b = torch.tensor([[[2, 2], [1, 0]]], dtype=torch.int32)
    assert int(rdcost.block_sse(a, b)[0]) == 1 + 0 + 4 + 16


@pytest.mark.parametrize("qpd6", range(5))
def test_rd_cost_matches_jax(qpd6):
    rng = np.random.default_rng(40 + qpd6)
    # spans the saturation edges of both products and of their sum
    dist = np.concatenate([rng.integers(0, 2**31 - 1, 500),
                           rng.integers(0, 2**24, 500)]).astype(np.int32)
    bits = np.concatenate([rng.integers(0, 2**31 - 1, 500),
                           rng.integers(0, 2**22, 500)]).astype(np.int32)
    bits = rng.permutation(bits)
    want = np.asarray(jrdcost.calc_rd_cost(qpd6, dist, bits))
    got = rdcost.calc_rd_cost(qpd6, _t(dist), _t(bits)).numpy()
    np.testing.assert_array_equal(got, want)
    blk = rng.integers(0, 256, (6, 32, 32)).astype(np.uint8)
    rec = rng.integers(0, 256, (6, 32, 32)).astype(np.uint8)
    np.testing.assert_array_equal(
        rdcost.block_sse(_t(blk), _t(rec)).numpy(),
        np.asarray(jrdcost.block_sse(blk, rec)))


# ------------------------------------------------------------------- quant

def test_estimate_coeff_rate_golden_and_jax(golden):
    lv = np.arange(256, dtype=np.int32)
    got = quant.estimate_coeff_rate(_t(lv)).numpy()
    np.testing.assert_array_equal(got, golden("tables")["coeff_rate"])
    wide = np.arange(32768, dtype=np.int32)
    np.testing.assert_array_equal(
        quant.estimate_coeff_rate(_t(wide)).numpy(),
        np.asarray(jquant.estimate_coeff_rate(wide)))


def test_quantize_golden(golden):
    g = golden("quant")
    for (sz, q), idx in _groups([g["sz"], g["qpd6"]]).items():
        src = g["src"][idx][:, :sz, :sz]
        got = quant.quantize(sz, q, _t(src))
        assert got.dtype == torch.int16
        np.testing.assert_array_equal(got.numpy(),
                                      g["quant"][idx][:, :sz, :sz],
                                      err_msg=f"sz={sz} q={q}")
        dq = quant.dequantize(sz, q, got).numpy()
        np.testing.assert_array_equal(dq, g["dequant"][idx][:, :sz, :sz])


@pytest.mark.parametrize("qpd6", range(5))
def test_quant_matches_jax_on_noise(qpd6):
    rng = np.random.default_rng(50 + qpd6)
    for sz in SIZES:
        # transform-range coefficients, with escapes past 0x1FFFF and zeros
        coef = rng.integers(-(2**18), 2**18, (4, 3, sz, sz)).astype(np.int32)
        coef[0] = rng.integers(-40, 41, (3, sz, sz))
        coef[1, 0] = 0
        want = np.asarray(jax.jit(functools.partial(
            jquant.quantize, sz, qpd6))(coef))
        got = quant.quantize(sz, qpd6, _t(coef))
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"sz={sz}")
        want_dq = np.asarray(jquant.dequantize(sz, qpd6, want))
        np.testing.assert_array_equal(
            quant.dequantize(sz, qpd6, got).numpy(), want_dq)


# ------------------------------------------------------------------- xform

def test_transform_golden(golden):
    g = golden("xform")
    for (sz, inv), idx in _groups([g["sz"], g["inverse"]]).items():
        src = g["src"][idx][:, :sz, :sz]
        fn = xform.inverse_transform if inv else xform.forward_transform
        np.testing.assert_array_equal(fn(sz, _t(src)).numpy(),
                                      g["out"][idx][:, :sz, :sz],
                                      err_msg=f"sz={sz} inv={inv}")


def test_transform_matches_jax_on_noise():
    rng = np.random.default_rng(60)
    for sz in SIZES:
        resid = rng.integers(-255, 256, (3, 5, sz, sz)).astype(np.int32)
        resid[0, 0] = 255                        # largest stage sums
        resid[0, 1] = -255
        np.testing.assert_array_equal(
            xform.forward_transform(sz, _t(resid)).numpy(),
            np.asarray(jxform.forward_transform(sz, resid)), err_msg=sz)
        coef = rng.integers(-32768, 32768, (3, 5, sz, sz)).astype(np.int32)
        coef[0, 0] = 32767                       # clip16 in both stages
        coef[0, 1] = -32768
        got = xform.inverse_transform(sz, _t(coef))
        assert got.dtype == torch.int16
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jxform.inverse_transform(sz, coef)),
            err_msg=sz)


# ------------------------------------------------------------------- intra

def test_border_golden(golden):
    g = golden("border")
    for (sz,), idx in _groups([g["sz"]]).items():
        base = g["rcon"][idx]
        fl = _t(g["flags"][idx].astype(bool))
        S = intra.build_borders(sz, _t(base[:, 0, 0]),
                                _t(base[:, 1:1 + 2 * sz, 0]),
                                _t(base[:, 0, 1:1 + 2 * sz]),
                                fl[:, 0], fl[:, 1], fl[:, 2], fl[:, 3]).numpy()
        f = 1 + 4 * sz
        np.testing.assert_array_equal(S[:, 0], g["ubla"][idx][:, 0])
        np.testing.assert_array_equal(S[:, 1:1 + 2 * sz],
                                      g["ublb"][idx][:, :2 * sz])
        np.testing.assert_array_equal(S[:, 1 + 2 * sz:f],
                                      g["ubar"][idx][:, :2 * sz])
        np.testing.assert_array_equal(S[:, f], g["fbla"][idx][:, 0])
        np.testing.assert_array_equal(S[:, f + 1:f + 1 + 2 * sz],
                                      g["fblb"][idx][:, :2 * sz])
        np.testing.assert_array_equal(S[:, f + 1 + 2 * sz:],
                                      g["fbar"][idx][:, :2 * sz])


def test_predict_golden(golden):
    g = golden("predict")
    for (sz,), idx in _groups([g["sz"]]).items():
        S = np.concatenate([
            g["ubla"][idx], g["ublb"][idx][:, :2 * sz],
            g["ubar"][idx][:, :2 * sz], g["fbla"][idx],
            g["fblb"][idx][:, :2 * sz], g["fbar"][idx][:, :2 * sz],
        ], axis=1).astype(np.int32)
        out = intra.predict_all_modes(sz, _t(S))
        assert out.dtype == torch.uint8
        for row, i in enumerate(idx):
            pm = int(g["pmode"][i])
            np.testing.assert_array_equal(out[row, pm].numpy(),
                                          g["out"][i][:sz, :sz],
                                          err_msg=f"sz={sz} pmode={pm}")


def test_borders_and_prediction_match_jax_on_noise():
    rng = np.random.default_rng(70)
    for sz in SIZES:
        n = 12
        corner = rng.integers(0, 256, n).astype(np.int32)
        left2 = rng.integers(0, 256, (n, 2 * sz)).astype(np.int32)
        top2 = rng.integers(0, 256, (n, 2 * sz)).astype(np.int32)
        left2[:2], top2[:2], corner[:2] = 255, 255, 255    # extreme borders
        left2[2:4], top2[2:4], corner[2:4] = 0, 0, 0
        fl = rng.random((n, 4)) < 0.5
        fl[4] = True
        fl[5] = False
        want_S = np.asarray(jintra.build_borders(
            sz, corner, left2, top2, fl[:, 0], fl[:, 1], fl[:, 2], fl[:, 3]))
        tf = _t(fl)
        S = intra.build_borders(sz, _t(corner), _t(left2), _t(top2),
                                tf[:, 0], tf[:, 1], tf[:, 2], tf[:, 3])
        np.testing.assert_array_equal(S.numpy(), want_S, err_msg=sz)
        want = np.asarray(jax.jit(functools.partial(
            jintra.predict_all_modes, sz))(want_S))
        np.testing.assert_array_equal(intra.predict_all_modes(sz, S).numpy(),
                                      want, err_msg=sz)


# -------------------------------------------------------------------- satd

def test_satd_matches_jax_and_oracle():
    rng = np.random.default_rng(80)
    for sz in SIZES:
        r = rng.integers(-255, 256, (4, 3, sz, sz)).astype(np.int32)
        r[0, 0] = 255
        h = np.array([[1]], np.int64)
        while h.shape[0] < sz:
            h = np.block([[h, h], [h, -h]])
        exp = np.abs(np.einsum("ij,bmjk,kl->bmil", h, r.astype(np.int64), h)
                     ).sum((-1, -2))
        got = satd.block_satd(sz, _t(r).to(torch.int16))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), exp)
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jsatd.block_satd(sz, r)))


# ------------------------------------------------------- native binding

def test_native_binding_golden_images(golden):
    """The port's own build and binding of csrc/hevce_host.cpp: the
    bit-exact engine reproduces the reference's golden streams, and the
    independent decoder returns their recons."""
    g = golden("images")
    for i in (0, 2, 4, 15):                  # 32x32 at qpd6 0/2/4, 50x70
        img = g[f"img_{i}"]
        s, r = native.encode_image_native(img, int(g[f"qpd6_{i}"]))
        assert s == g[f"stream_{i}"].tobytes(), i
        np.testing.assert_array_equal(r, g[f"rcon_{i}"])
        np.testing.assert_array_equal(native.decode_stream(s), r)
    with pytest.raises(ValueError):
        native.encode_image_native(img.astype(np.int32), 2)


def test_pack_stats_follow_the_last_pack():
    rng = np.random.default_rng(95)
    img = rng.integers(0, 256, (32, 64)).astype(np.uint8)
    lay = np.zeros((1, 2, 21), np.int8)
    lay[..., 20] = 1                          # one 32x32 CU per CTU, planar
    zeros = np.zeros((1, 2, 21), np.int8)
    s, r = native.pack_forest_img(lay, zeros, np.zeros((1, 2, 64), np.int8),
                                  img, 2)
    bits, nctx, nbyp = native.last_pack_stats()
    assert 0 < bits <= 8 * len(s) and nctx > 0 and nbyp > 0
    np.testing.assert_array_equal(native.decode_stream(s), r)


# ---------------------------------------------------- package boundaries

def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_imports_neither_jax_nor_jax_package():
    files = sorted((ROOT / "hevce_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    for f in files:
        bad = {m for m in _imported_roots(f) if m in ("jax", "jaxlib",
                                                      "hevce_tpu")}
        assert not bad, f"{f.relative_to(ROOT)} imports {sorted(bad)}"


def test_entry_points_need_cuda_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    img = np.zeros((32, 32), np.uint8)
    calls = [lambda: twf.encode_many_fast([img], 2),
             lambda: twf.encode_batch_fast([img], 2),
             lambda: twf.encode_image_fast(img, 2),
             lambda: twf._dispatch_batch([img], 2)]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    s, r = twf.encode_image_fast(img, 2, device="cpu")
    assert isinstance(s, bytes) and r.shape == (32, 32)


def test_adapt_post_is_not_run_as_pre(monkeypatch):
    monkeypatch.setenv("HEVCE_ADAPT", "post")
    with pytest.raises(NotImplementedError):
        twf.encode_many_fast([np.zeros((32, 32), np.uint8)], 2, device="cpu")
    for v, mode in (("pre", "pre"), ("", "pre"), ("0", "0"), ("off", "0")):
        monkeypatch.setenv("HEVCE_ADAPT", v)
        assert twf.adapt_mode() == mode


def test_k1_wrapper_routes_by_device():
    """CPU tensors take the plain version and launch nothing; any other
    device is checked and then launches K1 or raises (never falls back)."""
    rng = np.random.default_rng(90)
    pred = _t(rng.integers(0, 256, (2, 3, 8, 8)).astype(np.uint8))
    blk = _t(rng.integers(0, 256, (2, 8, 8)).astype(np.uint8))
    n0 = fused_eval.LAUNCHES
    got = fused_eval.pipeline_sse(8, 2, pred, blk)
    want = fused_eval.pipeline_sse_plain(8, 2, pred, blk)
    assert fused_eval.LAUNCHES == n0
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    meta = dict(device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        fused_eval.pipeline_sse(8, 2, torch.empty(2, 3, 8, 8, dtype=torch.uint8,
                                                  **meta),
                                torch.empty(2, 8, 8, dtype=torch.uint8, **meta))
    with pytest.raises(TypeError):
        fused_eval.pipeline_sse(8, 2, torch.empty(2, 3, 8, 8, **meta),
                                torch.empty(2, 8, 8, dtype=torch.uint8, **meta))
    with pytest.raises(ValueError, match="do not fit"):
        fused_eval.pipeline_sse(8, 2, torch.empty(2, 3, 8, 8, dtype=torch.uint8,
                                                  **meta),
                                torch.empty(3, 8, 8, dtype=torch.uint8, **meta))
    assert fused_eval.LAUNCHES == n0
