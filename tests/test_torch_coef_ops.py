"""The port's residual op-string generation (ops/coef_ops) against the JAX
package's, on the CPU, exactly (tolerance 0).

Blocks: the golden putCoef blocks, numpy-seeded noise, and adversarial
blocks (all zero, +-32767 escapes, a single last coefficient in each
corner, pmodes 6 / 10 / 26 for the diagonal / vertical / horizontal scans).
"""
import numpy as np
import pytest
import torch

from hevce_tpu.ops import cabac_sim as jsim
from hevce_tpu.ops import coef_ops as jco
from hevce_tpu_torch.bitstream import syntax as tsyn
from hevce_tpu_torch.ops import coef_ops as co

# the test workers share the machine's cores: one intra-op thread each
torch.set_num_threads(1)

SIZES = (4, 8, 16, 32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _eq(got, want, msg=""):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=msg)


def _blocks(golden, sz, seed):
    """(pmode, blk) lanes for one size: golden blocks, noise, adversarial."""
    g = dict(golden("putcoef"))
    idx = [t for t in range(len(g["sz"])) if int(g["sz"][t]) == sz]
    blks = [g["blk"][t][:sz, :sz].astype(np.int32) for t in idx]
    pms = [int(g["pmode"][t]) for t in idx]
    rng = np.random.default_rng(seed)
    for pm in (6, 10, 26):                       # diagonal, vertical, horizontal
        for _ in range(2):                        # sparse noise
            b = np.where(rng.random((sz, sz)) < 0.2,
                         rng.integers(-40, 41, (sz, sz)), 0)
            blks.append(b.astype(np.int32))
            pms.append(pm)
        blks.append(np.zeros((sz, sz), np.int32))                   # all zero
        pms.append(pm)
        esc = rng.choice([-32767, 32767], (sz, sz)).astype(np.int32)
        blks.append(esc)                                            # escapes
        pms.append(pm)
        for y, x in ((0, 0), (0, sz - 1), (sz - 1, 0), (sz - 1, sz - 1)):
            b = np.zeros((sz, sz), np.int32)
            b[y, x] = int(rng.choice([-1, 1])) * int(rng.integers(1, 300))
            blks.append(b)                                          # corners
            pms.append(pm)
    return np.asarray(pms, np.int32), np.stack(blks)


def test_tables_and_palettes_equal_jax():
    for sz in SIZES:
        a, b = co._tables(sz), jco._tables(sz)
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{k} sz={sz}")
        for full in (False, True):
            for x, y in zip(co._palette(sz, full), jco._palette(sz, full)):
                np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(tsyn.MIN_IN_GROUP,
                                  jco.syn.MIN_IN_GROUP)
    assert tsyn._LAST_ADDR == jco.syn._LAST_ADDR
    assert tsyn._LAST_SFT == jco.syn._LAST_SFT
    t = np.arange(32, dtype=np.int32)
    _eq(co._group_index(_t(t)), jco._group_index(t))
    np.testing.assert_array_equal(co._group_index(_t(t)).numpy(),
                                  tsyn.GROUP_INDEX)
    g = np.arange(10, dtype=np.int32)
    _eq(co._min_in_group(_t(g)), jco._min_in_group(g))


@pytest.mark.parametrize("sz", SIZES)
def test_last_xy_ops_match_jax(sz):
    yy, xx = np.mgrid[0:sz, 0:sz]
    y, x = yy.reshape(-1).astype(np.int32), xx.reshape(-1).astype(np.int32)
    for st in (0, 1, 2) if sz <= 8 else (0,):
        s = np.full_like(y, st)
        got = co._last_xy_ops(sz, _t(s), _t(y), _t(x))
        want = jco._last_xy_ops(sz, s, y, x)
        for a, b in zip(got, want):
            _eq(a, b, f"st={st}")


@pytest.mark.parametrize("sz", SIZES)
def test_put_coef_ops_match_jax(golden, sz):
    """generate_put_coef_ops (both zero-block modes), compact_ops and
    remap_ctx_ops; and the ops equal the JAX package's recorder."""
    pms, blks = _blocks(golden, sz, 700 + sz)
    for zero_blocks in (False, True):
        ops, val = co.generate_put_coef_ops(sz, _t(pms), _t(blks), zero_blocks)
        jops, jval = jco.generate_put_coef_ops(sz, pms, blks, zero_blocks)
        assert ops.dtype == torch.int32 and val.dtype == torch.bool
        _eq(val, jval, "valid")
        _eq(ops, jops, "ops")
        cap = {4: 256, 8: 512, 16: 2048, 32: 7168}[sz] // 4   # some overflow
        for a, b in zip(co.compact_ops(ops, val, cap),
                        jco.compact_ops(jops, jval, cap)):
            _eq(a, b, f"compact cap={cap}")
    packed, ovf, n = co.compact_ops(ops, val, 16384)
    assert not ovf.any()
    for lane in range(len(pms)):
        want = jsim.record_put_coef(sz, int(pms[lane]), blks[lane])
        assert packed[lane, :int(n[lane])].tolist() == list(want), lane
    for full in (False, True):
        _, remap = co._palette(sz, full)
        _eq(co.remap_ctx_ops(ops, remap), jco.remap_ctx_ops(jops, remap))


def _cu_inputs(rng, lanes):
    pm = rng.integers(0, 35, lanes).astype(np.int32)
    pl = rng.integers(0, 35, lanes).astype(np.int32)
    pa = rng.integers(0, 35, lanes).astype(np.int32)
    pl[:4], pa[:4] = (7, 0, 1, 0), (7, 1, 1, 0)     # equal / planar / DC
    pm[:4] = (7, 0, 26, 34)
    gl = rng.integers(0, 2, lanes).astype(bool)
    ga = rng.integers(0, 2, lanes).astype(bool)
    return pm, pl, pa, gl, ga


def test_mpm_and_header_ops_match_jax():
    rng = np.random.default_rng(710)
    pm, pl, pa, gl, ga = _cu_inputs(rng, 64)
    for a, b in zip(co._mpm3(_t(pl), _t(pa)), jco._mpm3(pl, pa)):
        _eq(a, b, "mpm")
    for sz in (4, 8, 16, 32):
        for split in (False, True):
            for coded in (False, True):
                got = co.generate_cu_header_ops(sz, split, _t(pm), _t(pl),
                                                _t(pa), _t(gl), _t(ga), coded)
                want = jco.generate_cu_header_ops(sz, split, pm, pl, pa, gl,
                                                  ga, coded)
                for a, b in zip(got, want):
                    _eq(a, b, f"sz={sz} split={split} coded={coded}")


@pytest.mark.parametrize("sz", (8, 16, 32))
def test_cu_trial_ops_match_jax(golden, sz):
    pms, blks = _blocks(golden, sz, 720 + sz)
    rng = np.random.default_rng(730 + sz)
    _, pl, pa, gl, ga = _cu_inputs(rng, len(pms))
    args = (pms, pl, pa, gl, ga)
    targs = tuple(_t(a) for a in args)
    for a, b in zip(co.generate_cu_2nx2n_ops(sz, *targs, _t(blks)),
                    jco.generate_cu_2nx2n_ops(sz, *args, blks)):
        _eq(a, b, "2nx2n")
    h = sz // 2
    blk4 = np.stack([blks[:, :h, :h], blks[:, :h, h:], blks[:, h:, :h],
                     blks[:, h:, h:]], 1)
    for a, b in zip(co.generate_cu_tusplit_ops(sz, *targs, _t(blk4)),
                    jco.generate_cu_tusplit_ops(sz, *args, blk4)):
        _eq(a, b, "tusplit")


@pytest.mark.parametrize("qpd6", range(5))
def test_put_coef_rates_match_jax(golden, qpd6):
    # every size at qpd6 2; the PU size and one node size at the others
    # (each new shape costs the JAX reference seconds of compilation)
    for sz in SIZES if qpd6 == 2 else (4, 8):
        pms, blks = _blocks(golden, sz, 740 + 10 * qpd6 + sz)
        got = co.put_coef_rates(sz, qpd6, _t(pms), _t(blks))
        want = jco.put_coef_rates(sz, qpd6, pms, blks)
        for a, b in zip(got, want):
            _eq(a, b, f"sz={sz}")
        assert got[0].dtype == torch.int32
        # the PU step's cap and int16 input (kernel K1's quant type)
        if sz == 4:
            got = co.put_coef_rates(4, qpd6, _t(pms), _t(blks.astype(np.int16)),
                                    cap=256)
            for a, b in zip(got, jco.put_coef_rates(4, qpd6, pms, blks,
                                                    cap=256)):
                _eq(a, b, "cap=256")
