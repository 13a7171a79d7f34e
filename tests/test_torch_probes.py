"""The probe kernels' plain versions and the port's measurement tools, on the
CPU, against the JAX package and tools/pallas_probe.py (tolerance 0).

The kernels themselves (csrc/probes.cu) run only on a card: their checks
against these plain versions are in tests/test_torch_cuda.py.
"""
import importlib.util
import os
import pathlib
import sys
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hevce_tpu.ops import quant as jquant
from hevce_tpu.ops import xform as jxform
from hevce_tpu.utils import imageio as jimageio
from hevce_tpu_torch.ops import constants as C
from hevce_tpu_torch.ops import fused_eval, probes
from hevce_tpu_torch.tools import bench_fused, cuda_probe, profile_front
from hevce_tpu_torch.utils import imageio, timing
from hevce_tpu_torch.utils.tracing import device_trace

# the test workers share the machine's cores: one intra-op thread each
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _pallas_probe():
    spec = importlib.util.spec_from_file_location(
        "pallas_probe", ROOT / "tools" / "pallas_probe.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# --------------------------------------------------------------------- P1

@pytest.mark.parametrize("n", [64, 1024])
def test_p1_plain_gives_n_after_n_steps(n):
    x = torch.zeros(cuda_probe.P1_SHAPE, dtype=torch.int32)
    for _ in range(n):
        assert probes.add_one(x) is x
    assert bool((x == n).all())
    assert probes.LAUNCHES["add_one"] == 0            # the CPU runs no kernel


# --------------------------------------------------------------------- P2

@pytest.mark.parametrize("case", ["random", "all -128"])
def test_p2_plain_equals_the_probes_reference(case):
    inputs = dict((c, (a, b)) for c, a, b in
                  cuda_probe.p2_inputs(np.random.default_rng(0)))
    a, b = inputs[case]
    assert a.shape == (512, 64) and b.shape == (64, 64)
    want = a.astype(np.int32) @ b.astype(np.int32)      # pallas_probe.py:86
    got = probes.int8_mm(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        probes.int8_mm_plain(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        want)


@pytest.mark.parametrize("M,K,N", [(77, 40, 36), (130, 33, 70), (5, 3, 1)])
def test_p2_plain_at_ragged_shapes(M, K, N):
    rng = np.random.default_rng(M * K * N)
    a = rng.integers(-128, 128, (M, K)).astype(np.int8)
    b = rng.integers(-128, 128, (K, N)).astype(np.int8)
    got = probes.int8_mm(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int32 and got.shape == (M, N)
    np.testing.assert_array_equal(got.numpy(),
                                  a.astype(np.int64) @ b.astype(np.int64))


# --------------------------------------------------------------------- P3

@pytest.mark.parametrize("which", ["stage", "inv"])
def test_kron_matrices_equal_pallas_probe(which):
    ref = getattr(_pallas_probe(), f"_kron_{which}")(4)
    got = getattr(probes, f"kron_{which}")(4)
    for g, r in zip(got, ref):
        assert g.dtype == np.int8 and g.shape == (16, 16)
        np.testing.assert_array_equal(g, r)


def _digits(x, ndig):
    """base-128 digits of int64 x: low digits in [0, 127], the top signed."""
    return [(x >> (7 * k)) if k == ndig - 1 else (x >> (7 * k)) & 127
            for k in range(ndig)]


def _kernel_product(x, bt, ndig):
    """x (..., rows, k) @ bt^T (bt (n, k) int8) as csrc/mma_s8.cuh's users
    compute it: the depth zero-padded to a multiple of mma.sync's 16, int8
    digit products recombined by Horner's rule in an int32 accumulator."""
    pad = -x.shape[-1] % 16
    x = np.concatenate([x, np.zeros(x.shape[:-1] + (pad,), np.int64)], -1)
    bt = np.pad(bt.astype(np.int64), ((0, 0), (0, pad)))
    acc = np.zeros(x.shape[:-1] + (bt.shape[0],), np.int64)
    for d in reversed(_digits(x, ndig)):
        assert d.min() >= -128 and d.max() <= 127        # each digit is s8
        acc = acc * 128 + d @ bt.T
        assert np.abs(acc).max() < 2**31                 # int32 accumulator
    return acc


def _rnd(x, s):
    return (x + (1 << s >> 1)) >> s


def _clip16(x):
    return np.clip(x, -32768, 32767)


def _extreme_blocks(rng, sz, n, lo, hi):
    """n blocks (n, sz, sz): the constant extremes, half and half,
    checkerboards, one-hot blocks, the sign pattern of a basis function at
    full scale (the largest first-stage sums), then uniform noise."""
    x = rng.integers(lo, hi + 1, (n, sz, sz))
    ii, jj = np.mgrid[0:sz, 0:sz]
    s1 = np.sign(C.TRANSFORM_MAT[sz][1]).astype(np.int64)
    s1[s1 == 0] = 1
    edges = [np.full((sz, sz), hi), np.full((sz, sz), lo),
             np.where(jj < sz // 2, lo, hi), np.where((ii + jj) % 2, lo, hi),
             np.where((ii + jj) % 2, hi, lo),
             np.where((ii == 0) & (jj == 0), hi, 0),
             np.where((ii == sz - 1) & (jj == 1), lo, 0),
             np.where(np.outer(s1, s1) > 0, hi, lo),
             np.where(np.outer(s1, s1) > 0, lo, hi)]
    x[:len(edges)] = edges
    return x


@pytest.mark.parametrize("sz", [4, 8, 16, 32])
def test_digit_split_kron_formulation_equals_direct_transform(sz):
    """The exact int8 tensor-core transforms in int64 numpy: P3's Kronecker
    form at 4x4 (csrc/probes.cu), K1's transposed-tile form at 8-32
    (csrc/fused_eval.cu: T^T = X^T @ M^T, C = T @ M^T, U^T = Dq^T @ M,
    R = U @ M, with the rows of M and M^T of fused_eval.stage_matrices as
    the B operand), equal to the JAX transforms at the extremes and on
    noise."""
    rng = np.random.default_rng(4 + sz)
    n = {4: 2000, 8: 600, 16: 200, 32: 60}[sz]
    resid = _extreme_blocks(rng, sz, n, -255, 255)
    dq = _extreme_blocks(rng, sz, n, -32768, 32767)
    a = int(C.FWD_SHIFT_A[sz])
    swap = lambda x: np.swapaxes(x, -1, -2)
    if sz == 4:
        k1, k2 = probes.kron_stage(4)
        ik1, ik2 = probes.kron_inv(4)
        flat = lambda x: x.reshape(n, 16)
        tmp = _rnd(_kernel_product(flat(resid), k1, 2), a)
        coef = _rnd(_kernel_product(tmp, k2, 3), a + 7).reshape(n, 4, 4)
        t1 = _clip16(_rnd(_kernel_product(flat(dq), ik1, 3), 7))
        rec = _clip16(_rnd(_kernel_product(t1, ik2, 3), 12)).reshape(n, 4, 4)
    else:
        mr, mt = fused_eval.stage_matrices(sz)
        np.testing.assert_array_equal(mr, C.TRANSFORM_MAT[sz])
        tmp = _rnd(swap(_kernel_product(swap(resid), mr, 2)), a)
        assert np.abs(tmp).max() < 2**17            # 3 digits hold it
        coef = _rnd(_kernel_product(tmp, mr, 3), a + 7)
        t1 = _clip16(_rnd(swap(_kernel_product(swap(dq), mt, 3)), 7))
        rec = _clip16(_rnd(_kernel_product(t1, mt, 3), 12))
    want = jxform.forward_transform(sz, jnp.asarray(resid.astype(np.int32)))
    np.testing.assert_array_equal(coef, np.asarray(want))
    want = jxform.inverse_transform(sz, jnp.asarray(dq.astype(np.int32)))
    np.testing.assert_array_equal(rec, np.asarray(want))
    if sz == 4:
        # the matrices act from the left on flattened blocks: x_row @ K^T.
        # The Pallas probe's mm(x, kron(eye, K)) takes x_row @ K, which is
        # M^T X: the transposed transform, so P3 follows the op chain instead
        m = C.TRANSFORM_MAT[4].astype(np.int64)
        np.testing.assert_array_equal(
            (resid.reshape(n, 16) @ k1.astype(np.int64).T).reshape(n, 4, 4),
            m @ resid)
        np.testing.assert_array_equal(
            (resid.reshape(n, 16) @ k1.astype(np.int64)).reshape(n, 4, 4),
            m.T @ resid)


def _jax_p3(pred, blk, qpd6):
    """the probe's own op chain (tools/pallas_probe.py:279-288) through the
    JAX package: (q (rows, modes * 16), sse (rows, modes)) as int64 numpy."""
    rows, w = pred.shape
    modes = w // 16
    p4 = pred.reshape(rows, modes, 4, 4)
    b4 = blk.reshape(rows, 4, 4)
    resid = b4[:, None].astype(np.int16) - p4.astype(np.int16)
    coef = jxform.forward_transform(4, jnp.asarray(resid))
    q_want = np.asarray(jquant.quantize(4, qpd6, coef)).reshape(rows, w)
    dq = jquant.dequantize(4, qpd6,
                           jnp.asarray(q_want.reshape(rows, modes, 4, 4)))
    rinv = jxform.inverse_transform(4, dq)
    recon = np.clip(np.asarray(rinv).astype(np.int64) + p4, 0, 255)
    sse_want = ((b4[:, None].astype(np.int64) - recon) ** 2).sum((-1, -2))
    return q_want.astype(np.int64), sse_want


@pytest.mark.parametrize("qpd6", [0, 2, 4])
def test_p3_plain_equals_jax_op_chain(qpd6):
    pred, blk = cuda_probe.p3_inputs(np.random.default_rng(qpd6), rows=64)
    q, sse = probes.fused4(torch.from_numpy(pred), torch.from_numpy(blk),
                           qpd6)
    q_want, sse_want = _jax_p3(pred, blk, qpd6)
    assert q.dtype == torch.int32 and sse.dtype == torch.int32
    np.testing.assert_array_equal(q.numpy(), q_want)
    np.testing.assert_array_equal(sse.numpy(), sse_want)
    assert (q_want == 0).any() and (q_want != 0).any()
    k1q, k1sse = cuda_probe.via_k1(torch.from_numpy(pred),
                                   torch.from_numpy(blk), qpd6)
    assert torch.equal(k1q, q) and torch.equal(k1sse, sse)


# ----------------------------------------------- P3's warp tile, in numpy
#
# csrc/probes.cu::p3_fused4 as one warp computes it, in int64 numpy: thread
# (g, t) of a tile of 16 candidate blocks holds coefficients 4t .. 4t+3 of
# rows g and g+8 (arrays below are (tiles, g, t, row half h, j)); each
# transform stage is mma.sync m16n8k16 products (s8 or u8 A, s8 B) built
# from the 32 threads' fragments as the PTX ISA lays them out, with the
# stage matrices of probes.p3_stage_matrices().

I32_MAX = 2**31 - 1


def _warp_mma(a, b, acc, unsigned):
    """D = A @ B + acc for T warps at once from per-thread fragments:
    a (T, 8, 4, 2, 4) bytes, thread (g, t)'s A[g][4t .. 4t+3] (h=0) and
    A[g+8][4t .. 4t+3] (h=1), read as u8 (`unsigned`) or s8; b (8, 4, 4) s8,
    B[4t .. 4t+3][g]; acc (T, 8, 4, 4): D[g][2t], D[g][2t+1], D[g+8][2t],
    D[g+8][2t+1]."""
    a = a & 255 if unsigned else (a & 255) - ((a & 128) << 1)
    T = a.shape[0]
    A = np.zeros((T, 16, 16), np.int64)
    B = np.zeros((16, 8), np.int64)
    for g in range(8):
        for t in range(4):
            A[:, g, 4 * t:4 * t + 4] = a[:, g, t, 0]
            A[:, g + 8, 4 * t:4 * t + 4] = a[:, g, t, 1]
            B[4 * t:4 * t + 4, g] = b[g, t]
    D = A @ B
    out = acc.copy()
    for g in range(8):
        for t in range(4):
            out[:, g, t] += np.stack([D[:, g, 2 * t], D[:, g, 2 * t + 1],
                                      D[:, g + 8, 2 * t],
                                      D[:, g + 8, 2 * t + 1]], -1)
    assert np.abs(out).max() < 2**31                     # int32 accumulator
    return out


def _fragments(kmat):
    """thread (g, t)'s B fragments of a stage matrix: rows g and 8 + g."""
    return [np.array([[kmat[8 * h + g, 4 * t:4 * t + 4] for t in range(4)]
                      for g in range(8)]) for h in range(2)]


def _relayout(c0, c1):
    """the two products' accumulators (columns 0-7, 8-15) as the next
    stage's x: coefficients 4t .. 4t+3 of rows g (h=0) and g+8 (h=1)."""
    out = np.empty(c0.shape[:3] + (2, 4), np.int64)
    out[..., 0, :] = np.stack([c0[..., 0], c0[..., 1], c1[..., 0],
                               c1[..., 1]], -1)
    out[..., 1, :] = np.stack([c0[..., 2], c0[..., 3], c1[..., 2],
                               c1[..., 3]], -1)
    return out


def _warp_stage(x, kmat):
    """one stage on T warps: x (T, 8, 4, 2, 4), |x| < 2^15, -> x @ K^T in
    the same layout, as (hi @ K^T) * 256 + lo @ K^T with hi the s8 top byte
    and lo the u8 low byte of each value (split256)."""
    assert np.abs(x).max() < 2**15
    bf = _fragments(kmat)
    z = np.zeros(x.shape[:3] + (4,), np.int64)
    hi, lo = x >> 8, x & 255
    c0 = _warp_mma(hi, bf[0], z, False) * 256
    c1 = _warp_mma(hi, bf[1], z, False) * 256
    return _relayout(_warp_mma(lo, bf[0], c0, True),
                     _warp_mma(lo, bf[1], c1, True))


def _quad_sum(v):
    """the kernel's sum4: v + xor-1 neighbour, then + xor-2 neighbour, over
    the t axis (2) of (T, 8, 4, 2)."""
    v = v + v[:, :, [1, 0, 3, 2]]
    return v + v[:, :, [2, 3, 0, 1]]


def _rate(lv):
    bits = sum((lv - 5 >= 1 << k).astype(np.int64) for k in range(1, 16))
    small = np.asarray(C.LEVEL_RATE_TABLE, np.int64)[np.clip(lv, 0, 5)]
    return np.where(lv >= 6, 92000 + ((4 + 2 * bits) << 15), small)


def _rdoq_search(coef, qpd6):
    """RDOQ as the reference searches it (csrc/fused_eval.cu's rdoq, the
    three candidates level0, -1, -2 with saturating costs): (signed level,
    dlevel)."""
    sft = int(C.QUANT_LEVEL_SHIFT[4]) + qpd6
    add = 1 << sft >> 1
    max_dlevel = I32_MAX - add
    wd, wb = int(C.RDCOST_WEIGHT_DIST[qpd6]), int(C.RDCOST_WEIGHT_BITS[qpd6])
    absval = np.abs(coef)
    dlevel = np.where(absval > 0x1FFFF, max_dlevel,
                      np.minimum((absval & 0x1FFFF) << 14, max_dlevel))
    level0 = np.clip((dlevel + add) >> sft, -32768, 32767)

    def cost(lv):
        d1 = np.abs(dlevel - (lv << sft)) >> int(C.QUANT_DIST_SHIFT[4])
        dist = np.where(d1 < 46340, d1 * d1, I32_MAX) >> 7
        r = _rate(lv)
        c1 = np.where(I32_MAX // wd <= dist, I32_MAX, wd * dist)
        c2 = np.where(I32_MAX // wb <= r, I32_MAX, wb * r)
        return np.where(I32_MAX - c1 <= c2, I32_MAX, c1 + c2)

    best_l, best_c = level0, cost(level0)
    for dd in (1, 2):
        lv = level0 - dd
        cst = cost(np.maximum(lv, 0))
        take = (level0 >= dd) & (cst < best_c)
        best_l = np.where(take, lv, best_l)
        best_c = np.where(take, cst, best_c)
    return np.where(coef < 0, -best_l, best_l), dlevel


def _rdoq_p3(coef, qpd6):
    """csrc/probes.cu::rdoq with the wrapper's thresholds, every
    intermediate checked to stay inside int32: (signed level, dlevel)."""
    sft = int(C.QUANT_LEVEL_SHIFT[4]) + qpd6
    add = 1 << sft >> 1
    th = np.array(probes.p3_rdoq_thresholds(qpd6), np.int64)
    dlevel = np.minimum(np.minimum(np.abs(coef), 0x1FFFF) << 14,
                        I32_MAX - add)
    l0 = (dlevel + add) >> sft
    e0 = dlevel - (l0 << sft)
    k = np.where(l0 <= 6, l0, np.where(((l0 - 5) & (l0 - 6)) == 0, 7, 0))
    for v in (dlevel + add, l0 << sft, e0):
        assert np.abs(v).max() < 2**31
    lv = l0 - (e0 < th[k])
    return np.where(coef < 0, -lv, lv), dlevel


@pytest.mark.parametrize("qpd6", range(5))
def test_p3_rdoq_equals_the_three_candidate_search_for_every_coef(qpd6):
    """P3's RDOQ, a threshold on the rounding error by the class of the
    level's rate step, equals the full three-candidate search (and the
    port's plain quantize) for every |coef| up to past 0x1FFFF, both
    signs."""
    a = np.arange(0x20000 + 4096, dtype=np.int64)
    coef = np.concatenate([a, -a, [2**20, -2**20, 2**30, -2**30]])
    got, got_dl = _rdoq_p3(coef, qpd6)
    want, want_dl = _rdoq_search(coef, qpd6)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_dl, want_dl)
    from hevce_tpu_torch.ops import quant
    # the plain quantize on 4x4 blocks whose one nonzero coefficient is the
    # DC (so no kill: a CG with one large level survives), |coef| < 2^17
    small = coef[np.abs(coef) < 2**17]
    blocks = np.zeros((small.size, 4, 4), np.int64)
    blocks[:, 0, 0] = small
    q = quant.quantize(4, qpd6, torch.from_numpy(blocks.astype(np.int32)))
    thr = 9 << (int(C.QUANT_LEVEL_SHIFT[4]) + qpd6) >> 2
    kept = np.minimum(want_dl[np.abs(coef) < 2**17], thr) >= thr
    np.testing.assert_array_equal(q[:, 0, 0].numpy(),
                                  np.where(kept, want[np.abs(coef) < 2**17],
                                           0))
    assert (want != 0).any() and (np.abs(want) == 4095 >> qpd6).any()


def _p3_warp_model(pred, blk, qpd6):
    """(q (rows, modes * 16), sse (rows, modes)) as the kernel's warps
    compute them, int64."""
    rows, w = pred.shape
    modes, n = w // 16, rows * w // 16
    T = -(-n // 16)
    mats = probes.p3_stage_matrices().astype(np.int64)
    mul, shr = probes.divisor_magic(modes)
    # candidate block of (tile, g, h) and whether it is live
    b = (np.arange(T)[:, None, None] * 16 + np.arange(8)[None, :, None]
         + 8 * np.arange(2)[None, None, :])
    live = b < n
    bc = np.minimum(b, n - 1)
    brow = bc if modes == 1 else ((bc * mul) >> 32) >> shr
    coefs = 4 * np.arange(4)[:, None] + np.arange(4)[None, :]    # (t, j)
    pv = pred.reshape(n, 16).astype(np.int64)[bc[:, :, None, :, None],
                                               coefs[None, None, :, None, :]]
    bv = blk.astype(np.int64)[brow[:, :, None, :, None],
                              coefs[None, None, :, None, :]]
    m = live[:, :, None, :, None]
    pv, bv = np.where(m, pv, 0), np.where(m, bv, 0)          # masked loads
    a = int(C.FWD_SHIFT_A[4])
    # forward stage 1 on the loaded bytes: blk @ K^T + pred @ (-K)^T
    f1, nf1 = _fragments(mats[0]), _fragments(mats[1])
    z = np.zeros(pv.shape[:3] + (4,), np.int64)
    c0 = _warp_mma(pv, nf1[0], _warp_mma(bv, f1[0], z, True), True)
    c1 = _warp_mma(pv, nf1[1], _warp_mma(bv, f1[1], z, True), True)
    x = _rnd(_relayout(c0, c1), a)
    lv, dlevel = _rdoq_p3(_rnd(_warp_stage(x, mats[2]), a + 7), qpd6)
    thr = 9 << (int(C.QUANT_LEVEL_SHIFT[4]) + qpd6) >> 2
    keep = _quad_sum(np.minimum(dlevel, thr).sum(-1)) >= thr
    qv = np.where(keep[..., None], lv, 0)
    dq = _clip16(qv * (1 << (int(C.DEQUANT_SHIFT[4]) + qpd6)))
    x = _clip16(_rnd(_warp_stage(dq, mats[3]), 7))
    r = _rnd(_warp_stage(x, mats[4]), 12)
    d = bv - np.clip(r + pv, 0, 255)
    sse = _quad_sum((d * d).sum(-1))                          # (T, 8, 4, 2)
    q = np.zeros((T * 16, 16), np.int64)
    s = np.zeros(T * 16, np.int64)
    for t in range(4):
        for h in range(2):
            rr = (np.arange(T)[:, None] * 16 + np.arange(8) + 8 * h).ravel()
            q[rr, 4 * t:4 * t + 4] = qv[:, :, t, h].reshape(-1, 4)
            s[rr] = sse[:, :, t, h].ravel()      # each lane of the quad
    return q[:n].reshape(rows, w), s[:n].reshape(rows, modes)


def _p3_extreme_inputs(rng, rows, modes):
    """pred and blk of _extreme_blocks' patterns over [0, 255]: full-scale
    residuals of both signs, checkerboards, basis-function signs."""
    blk = _extreme_blocks(rng, 4, rows, 0, 255)
    pred = _extreme_blocks(rng, 4, rows * modes, 0, 255)[::-1]
    return (pred.reshape(rows, modes * 16).astype(np.uint8),
            blk.reshape(rows, 16).astype(np.uint8))


@pytest.mark.parametrize("qpd6", range(5))
def test_p3_warp_tile_model_equals_plain_and_jax(qpd6):
    """The redesigned P3's register layout (one warp a tile, the stage
    matrices' rows in P3_ORDER, each stage reading the last one's
    accumulator as it stands, quad sums for the kill and the SSE) equals
    fused4_plain and the JAX op chain on extreme blocks, on the probe's
    inputs and at ragged tile counts."""
    rng = np.random.default_rng(60 + qpd6)
    cases = [_p3_extreme_inputs(rng, 24, 35),
             cuda_probe.p3_inputs(rng, rows=48),
             cuda_probe.p3_inputs(rng, rows=17),       # 595: a partial tile
             cuda_probe.p3_inputs(rng, rows=1),
             cuda_probe.p3_inputs(rng, rows=9, modes=4)]
    for pred, blk in cases:
        q, sse = _p3_warp_model(pred, blk, qpd6)
        q_want, sse_want = _jax_p3(pred, blk, qpd6)
        np.testing.assert_array_equal(q, q_want)
        np.testing.assert_array_equal(sse, sse_want)
        qp, ssep = probes.fused4_plain(torch.from_numpy(pred),
                                       torch.from_numpy(blk), qpd6)
        np.testing.assert_array_equal(q, qp.numpy())
        np.testing.assert_array_equal(sse, ssep.numpy())
    assert (q_want != 0).any()


def test_p3_stage_matrices_put_4_consecutive_coefficients_on_a_thread():
    """the columns thread (g, t) holds after a stage's two products, 2t, 2t+1
    (first) and 2t, 2t+1 of the second (8 + 2t, 9 + 2t), compute
    coefficients 4t .. 4t+3 of the unpermuted matrices."""
    mats = probes.p3_stage_matrices()
    f1, f2 = probes.kron_stage(4)
    plain = np.stack((f1, -f1, f2) + probes.kron_inv(4))
    for t in range(4):
        cols = [2 * t, 2 * t + 1, 8 + 2 * t, 9 + 2 * t]
        np.testing.assert_array_equal(mats[:, cols],
                                      plain[:, 4 * t:4 * t + 4])
    assert sorted(probes.P3_ORDER) == list(range(16))


@pytest.mark.parametrize("d", [1, 2, 3, 4, 7, 35, 36, 1000, 2**20 + 1,
                               2**31 - 1])
def test_p3_divisor_magic_divides_exactly(d):
    mul, shr = probes.divisor_magic(d)
    assert 0 <= mul < 2**32 and 0 <= shr < 32
    n = np.concatenate([np.arange(4096), 2**31 - 1 - np.arange(4096),
                        np.random.default_rng(d).integers(0, 2**31, 4096),
                        d * np.arange(1, 64), d * np.arange(1, 64) - 1])
    n = n[(n >= 0) & (n < 2**31)].astype(object)    # exact big integers
    got = n if d == 1 else (n * mul >> 32) >> shr
    assert all(got == n // d)


# ------------------------------------------------------------ K1, build

def test_k1_imma_counts_by_size_read_the_mangled_instantiations():
    ns = "_ZN46_GLOBAL__N__9ef10734_13_fused_eval_cu_f4e2b24b"   # nvcc 12.9
    tail = "EEEvPKhS2_PKaiiNS_8K1ParamsEPsPhPi"
    counts = {ns + "10k1_kernel4EPKhS1_PKaiiNS_8K1ParamsEPsPhPi": 0,
              ns + "12k1_kernel_tcILi8" + tail: 22,
              ns + "12k1_kernel_tcILi16" + tail: 11,
              ns + "12k1_kernel_tcILi32" + tail: 33,
              "_ZN41_GLOBAL__N__fc5085c3_9_probes_cu_aa23f5889p3_fused4EPKhS1_"
              "PKaxiNS_8P3ParamsEPiS5_": 11}
    assert fused_eval.imma_by_size(counts) == {4: 0, 8: 22, 16: 11, 32: 33}


def _stand_in_build(tmp_path, monkeypatch):
    """runtime/build.build of tmp_path/k.cu with the header k.cuh, through
    a stand-in compiler that writes its output and counts its runs in
    tmp_path/log. Returns (build(flags), src, hdr, log)."""
    from hevce_tpu_torch.runtime import build as _build
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "out")
    src, hdr, log = (tmp_path / n for n in ("k.cu", "k.cuh", "log"))
    src.write_text("x")
    hdr.write_text("y")
    log.write_text("")
    cmd = [sys.executable, "-c",
           "import sys; open(sys.argv[-1], 'w').write('lib'); "
           f"open({str(log)!r}, 'a').write('.')"]
    return (lambda *flags: _build.build(src, "libk.so", cmd + list(flags),
                                        deps=[hdr]),
            src, hdr, log)


def test_build_redoes_a_library_when_its_header_changes(tmp_path,
                                                        monkeypatch):
    build, src, hdr, log = _stand_in_build(tmp_path, monkeypatch)
    out, _ = build()
    assert out.read_text() == "lib" and log.read_text() == "."
    assert out.name.startswith("libk.") and out.suffix == ".so"
    old = out.stat().st_mtime - 1000
    hdr.write_text("y2")                 # new contents, an older time
    os.utime(hdr, (old, old))
    out2, _ = build()
    assert log.read_text() == ".." and out2 != out and out2.exists()


def test_build_redoes_a_library_when_its_flags_change(tmp_path,
                                                      monkeypatch):
    build, src, hdr, log = _stand_in_build(tmp_path, monkeypatch)
    out, _ = build("-DA=1")
    out2, _ = build("-DA=2")
    assert log.read_text() == ".." and out2 != out
    assert build("-DA=1")[0] == out and log.read_text() == ".."


def test_build_keeps_the_library_of_an_untouched_tree(tmp_path,
                                                      monkeypatch):
    build, src, hdr, log = _stand_in_build(tmp_path, monkeypatch)
    out, text = build()
    later = out.stat().st_mtime + 1000
    os.utime(src, (later, later))        # touched, not changed
    os.utime(hdr, (later, later))
    assert build() == (out, "") and log.read_text() == "."
    src.write_text("x2")
    assert build()[0] != out and log.read_text() == ".."


# ------------------------------------------------------------------ tools

def test_cuda_probe_on_cpu_prints_exact_lines(capsys):
    assert cuda_probe.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert [ln[:2] for ln in out[1:]] == ["P1", "P1", "P2", "P3", "P3"]
    assert "EXACT" in out[3] and out[4].count("EXACT") == 4
    assert not any("MISMATCH" in ln for ln in out)


def test_cuda_probe_without_a_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cuda_probe.main([])


def test_device_trace_records_on_cpu(tmp_path):
    with device_trace(tmp_path / "t") as prof:
        torch.ones(64, dtype=torch.int32).cumsum(0)
    assert (tmp_path / "t" / "trace.json").stat().st_size > 0
    assert any("cumsum" in e.key for e in prof.key_averages())


def test_profiler_sessions_keep_cupti_subscribed(tmp_path, monkeypatch):
    monkeypatch.delenv("TEARDOWN_CUPTI", raising=False)
    with device_trace(tmp_path / "t"):
        pass
    assert os.environ["TEARDOWN_CUPTI"] == "0"


@pytest.mark.parametrize("short", [False, True])
@pytest.mark.parametrize("empty", [0, 1, timing.PROFILE_TRIES])
def test_card_ms_runs_an_empty_profiler_session_again(monkeypatch, capsys,
                                                      empty, short):
    """`empty` sessions record no kernel (or, `short`, one of 3 calls'
    launches of "c" is lost); then card_ms reads the profiler's 600 us over
    3 calls, or after PROFILE_TRIES such sessions the CUDA events' time,
    and says so on stderr."""
    sessions, calls = [], []
    lost = [("k", 400.0, 3), ("c", 130.0, 2)] if short else []

    def kernels(fn):
        fn()
        sessions.append(len(calls))
        return lost if len(sessions) <= empty else [("k", 400.0, 3),
                                                    ("c", 200.0, 3)]

    monkeypatch.setattr(timing, "profiled",
                        lambda fn, pad_s: (kernels(fn), {}))
    monkeypatch.setattr(timing, "busy_events_ms", lambda fn, reps: 7.0)
    monkeypatch.setattr(timing, "LOST_SESSIONS", 0)
    ms = timing.card_ms(lambda: calls.append(1), 3)
    fell_back = empty == timing.PROFILE_TRIES
    assert ms == pytest.approx(7.0 if fell_back else 0.2)
    assert len(sessions) == min(empty + 1, timing.PROFILE_TRIES)
    assert len(calls) == 3 * len(sessions)
    assert timing.LOST_SESSIONS == empty
    said = "timed with CUDA events" in capsys.readouterr().err
    assert said == fell_back


class _FakeProfile:
    """stands in for torch.profiler.profile: records nothing itself (the
    tests give its kernel totals through timing.event_totals)."""

    def __init__(self, activities):
        self.exported = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def export_chrome_trace(self, path):
        self.exported = path


def _mock_profiler(monkeypatch, short_sessions):
    """a profiler whose first `short_sessions` sessions hold one K1 launch
    fewer than fused_eval.LAUNCHES counted; returns the list of sessions."""
    from hevce_tpu_torch.utils import tracing

    class Sessions(list):
        pass

    sessions = Sessions()

    def totals(prof):
        sessions.append(prof)
        short = len(sessions) <= short_sessions
        return {"k1_kernel4": [300.0, 169 - short], "elementwise": [5.0, 40]}

    for mod in (timing, tracing):
        monkeypatch.setattr(mod, "profile", _FakeProfile)
    sessions.pads = []                   # the host idle each window took
    monkeypatch.setattr(timing.time, "sleep", sessions.pads.append)
    monkeypatch.setattr(timing, "event_totals", totals)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(fused_eval, "LAUNCHES", 0)
    monkeypatch.setattr(timing, "LOST_SESSIONS", 0)
    return sessions


def _front_step():
    fused_eval.LAUNCHES += 169      # a front step's K1 calls, as counted


@pytest.mark.parametrize("short", [0, 1, timing.PROFILE_TRIES])
def test_card_kernels_runs_a_trace_that_lost_launches_again(monkeypatch,
                                                            short):
    """A session whose K1 count is below the launches fused_eval's wrapper
    counted is run again, its window padded 10 times wider each time; after
    PROFILE_TRIES of them the last comes back marked incomplete, never as
    if whole."""
    sessions = _mock_profiler(monkeypatch, short)
    kernels, complete = timing.card_kernels(_front_step)
    tries = min(short + 1, timing.PROFILE_TRIES)
    assert sessions.pads == [timing.PROFILE_PAD_S * 10 ** k
                             for k in range(tries)]
    assert len(sessions) == tries and fused_eval.LAUNCHES == 169 * tries
    assert complete == (short < timing.PROFILE_TRIES)
    assert timing.LOST_SESSIONS == tries - complete
    assert dict((k, n) for k, _, n in kernels)["k1_kernel4"] == 169 - (
        not complete)


def test_lost_launches_counts_only_launches_a_trace_missed():
    before = dict.fromkeys(("k1_kernel", "k2_kernel"), 10)
    after = {"k1_kernel": 179, "k2_kernel": 10}
    kernels = [("k1_kernel4", 9.0, 160), ("k1_kernel_tc<8>", 1.0, 8),
               ("k2_kernel", 2.0, 4)]      # K2 launched past its wrapper
    assert timing.lost_launches(kernels, before, after) == {"k1_kernel": 1}
    kernels[0] = ("k1_kernel4", 9.0, 161)
    assert timing.lost_launches(kernels, before, after) == {}


@pytest.mark.parametrize("short", [0, 1])
def test_device_trace_flags_a_trace_that_lost_launches(monkeypatch,
                                                       tmp_path, short):
    sessions = _mock_profiler(monkeypatch, short)
    with device_trace(tmp_path / "t") as prof:
        _front_step()
    assert sessions.pads == [timing.PROFILE_PAD_S]
    assert prof.lost_launches == ({"k1_kernel": 1} if short else {})
    assert prof.exported == str(tmp_path / "t" / "trace.json")


def test_profiler_session_stats_read_a_cpu_profile():
    from torch.profiler import ProfilerActivity, profile

    from hevce_tpu_torch.tools import profiler_sessions

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        t_in = time.time_ns()
        torch.ones(8).add_(1)
        t_out = time.time_ns()
    st = profiler_sessions.session_stats(prof, "add", t_in, t_out, 1)
    assert (st["expected"], st["profiled"], st["lost"]) == (1, 0, 1)
    assert st["card_events"] == 0 and st["kernel_minus_launch_us"] is None


def test_profile_front_on_one_32x32_image_cpu(tmp_path):
    img = np.random.default_rng(6).integers(0, 256, (32, 32)).astype(np.uint8)
    imageio.write_pgm(tmp_path / "a.pgm", img)
    lines = []
    assert profile_front.main([str(tmp_path / "a.pgm"), "--device", "cpu",
                               "--top", "5", "--logdir",
                               str(tmp_path / "trace")], out=lines.append) == 0
    assert lines[0].startswith("batch: B=1 32x32 qpd6=2 on cpu: 1 front")
    assert lines[1].startswith("host (CPU) operator time")
    assert len(lines) == 3 + 5
    assert (tmp_path / "trace" / "trace.json").exists()


def test_bench_fused_on_cpu():
    lines = []
    assert bench_fused.main(["4,35", "--n1", "1", "--n2", "2", "--device",
                             "cpu"], out=lines.append) == 0
    assert lines[0] == ("sz=4 M=35 lanes=288 on cpu: exactness q=OK recon=OK "
                        "sse=OK")
    assert len(lines) == 3 and "host (CPU) clock" in lines[1]


def test_pgm_io_matches_jax_package(tmp_path):
    img = np.random.default_rng(7).integers(0, 256, (13, 21)).astype(np.uint8)
    imageio.write_pgm(tmp_path / "a.pgm", img)
    jimageio.write_pgm(tmp_path / "b.pgm", img)
    assert (tmp_path / "a.pgm").read_bytes() == (tmp_path / "b.pgm").read_bytes()
    (tmp_path / "c.pgm").write_bytes(b"P5 # comment\n21\n13 255\n" + img.tobytes())
    for p in ("a.pgm", "c.pgm"):
        np.testing.assert_array_equal(imageio.read_pgm(tmp_path / p), img)
        np.testing.assert_array_equal(imageio.read_pgm(tmp_path / p),
                                      jimageio.read_pgm(tmp_path / p))
