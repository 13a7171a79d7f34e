"""The fused node kernels' plain versions (ops/fused_node: X1 predict, X2
preselect, X3 rate_cost) against the JAX package's op chains, and numpy
models of the kernels' own formulations against the plain versions, on the
CPU, exactly (tolerance 0).

The kernels themselves run only on the card (tests/test_torch_cuda.py,
chip_smoke.py); here every wrapper takes its plain route, since its inputs
lie on the CPU. The numpy models are what csrc/fused_node.cu computes where
it differs from the op chain: the integer two-tap prediction (the chain's
float32 product), the sub-TU border assembly read from each lane's canvas,
the butterfly SATD (the chain's Hadamard product), the rank-count top-K
(the chain's sort and cumsum), and one warp's rate: the packed table by scan
index, the CG bit mask, the level rate by the leading-zero count. Inputs
are made from a seed with numpy and handed to both packages; no JAX slice
program is compiled.
"""
import functools
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hevce_tpu.models import cu_eval as jcu
from hevce_tpu.models import wavefront as jwf
from hevce_tpu.ops import intra as jintra
from hevce_tpu.ops import rdcost as jrdcost
from hevce_tpu.ops import satd as jsatd
from hevce_tpu_torch.models import cu_eval
from hevce_tpu_torch.ops import constants as C
from hevce_tpu_torch.ops import fused_node as fn
from hevce_tpu_torch.ops import intra, satd
from hevce_tpu_torch.tools import profile_front

# the test workers share the machine's cores: one intra-op thread each
torch.set_num_threads(1)

I32_MAX = 2**31 - 1
FLAGS16 = np.array(list(itertools.product([False, True], repeat=4)))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _eq(got, want, msg=""):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                  err_msg=msg)


def _contexts(rng, sz, rows, dtype=np.uint8):
    """node contexts for rows = 16 k: every flag combination k times, noise
    borders but for a flat one (every mode predicts alike: SATD ties) and
    extremes (0 / 255: the HOR / VER edge clamps)."""
    top = rng.integers(0, 256, (rows, 1 + 2 * sz))
    left = rng.integers(0, 256, (rows, 2 * sz))
    top[0], left[0] = 77, 77
    top[1], left[1] = 255, 0
    top[2], left[2] = 0, 255
    fl = FLAGS16[np.arange(rows) % 16]
    return top.astype(dtype), left.astype(dtype), fl


@functools.partial(jax.jit, static_argnums=0)
def _jax_predict(sz, corner, left2, top2, fl):
    """the JAX package's build_borders + predict_all_modes, as one program
    (one compile per shape, not one per operation)."""
    S = jintra.build_borders(sz, corner.astype(jnp.int32),
                             left2.astype(jnp.int32), top2.astype(jnp.int32),
                             fl[..., 0], fl[..., 1], fl[..., 2], fl[..., 3])
    return S, jintra.predict_all_modes(sz, S)


# ------------------------------------------------------ numpy models (X1)

def _np_border(n, corner, left2, top2, fl):
    """the kernel's build_border: S (..., 2 + 8n) int64 from the corner
    (...,), left2 / top2 (..., 2n) and flags (..., 4); reads a hi half only
    where its flag is set."""
    bll, blb, baa, bar = (fl[..., k] for k in range(4))
    corner, left2, top2 = (np.asarray(a, np.int64)
                           for a in (corner, left2, top2))
    ubla = np.where(bll & baa, corner, np.where(
        bll, left2[..., 0], np.where(baa, top2[..., 0], 128)))

    def fill(src, lo_ok, hi_ok):
        lo = np.where(lo_ok[..., None], src[..., :n], ubla[..., None])
        hi = np.where(hi_ok[..., None], src[..., n:], lo[..., n - 1:n])
        return np.concatenate([lo, hi], -1)
    ublb, ubar = fill(left2, bll, blb), fill(top2, baa, bar)

    def smooth(u):
        out = u.copy()
        out[..., 0] = (2 + 2 * u[..., 0] + u[..., 1] + ubla) >> 2
        out[..., 1:-1] = (2 + 2 * u[..., 1:-1] + u[..., :-2] + u[..., 2:]) >> 2
        return out
    fbla = (2 + ublb[..., 0] + ubar[..., 0] + 2 * ubla) >> 2
    return np.concatenate([ubla[..., None], ublb, ubar, fbla[..., None],
                           smooth(ublb), smooth(ubar)], -1)


def _np_predict(n, S, m):
    """the kernel's pred_px over a whole block: S (..., 2 + 8n) -> (..., n,
    n) in mode m; angular modes by the two-tap rule from the table, the
    second tap not read where frac = 0."""
    S = np.asarray(S, np.int64)
    ublb, ubar = S[..., 1:1 + 2 * n], S[..., 1 + 2 * n:1 + 4 * n]
    ubla = S[..., 0]
    i = np.arange(n)[:, None]
    j = np.arange(n)[None, :]
    if m == 0:
        filt = C.FILTER_BORDER_Y[n][0]
        pl = S[..., 2 + 4 * n:2 + 6 * n] if filt else ublb
        pa = S[..., 2 + 6 * n:2 + 8 * n] if filt else ubar
        return (n + (n - j - 1) * pl[..., :n, None] + (j + 1) * pa[..., n, None,
                                                                    None]
                + (n - i - 1) * pa[..., None, :n]
                + (i + 1) * pl[..., n, None, None]) // (2 * n)
    if m == 1:
        dc = (n + ublb[..., :n].sum(-1) + ubar[..., :n].sum(-1)) // (2 * n)
        out = np.broadcast_to(dc[..., None, None], dc.shape + (n, n)).copy()
        if n <= 16:
            out[..., 0, :] = (2 + 3 * dc[..., None] + ubar[..., :n]) >> 2
            out[..., :, 0] = (2 + 3 * dc[..., None] + ublb[..., :n]) >> 2
            out[..., 0, 0] = (2 + 2 * dc + ublb[..., 0] + ubar[..., 0]) >> 2
        return out
    if m == 10:
        out = np.broadcast_to(ublb[..., :n, None], ublb.shape[:-1] + (n, n))
        out = out.copy()
        if n <= 16:
            out[..., 0, :] = np.clip(((ubar[..., :n] - ubla[..., None]) >> 1)
                                     + ublb[..., 0:1], 0, 255)
        return out
    if m == 26:
        out = np.broadcast_to(ubar[..., None, :n], ubar.shape[:-1] + (n, n))
        out = out.copy()
        if n <= 16:
            out[..., :, 0] = np.clip(((ublb[..., :n] - ubla[..., None]) >> 1)
                                     + ubar[..., 0:1], 0, 255)
        return out
    idx1, idx2, frac, horiz = intra._angular_tables(n)
    f = frac[m]                                        # (n, 1)
    a = S[..., idx1[m]]
    b = S[..., np.where(f == 0, idx1[m], idx2[m])]     # frac 0: one tap
    out = np.where(f == 0, a, ((32 - f) * a + f * b + 16) >> 5)
    return np.swapaxes(out, -1, -2) if horiz[m] else out


def _np_sub_border(sz, isub, top, left, fl, canvas):
    """the kernel's Nb for sub-TU isub: (corner, left2, top2, flags) per
    lane, from the node's context (rows, ...) and each lane's canvas
    (rows, M, sz, sz); the masked halves are left at 0."""
    h = sz // 2
    rows, M = canvas.shape[:2]
    t, le = top.astype(np.int64), left.astype(np.int64)
    cv = canvas.astype(np.int64)
    z = np.zeros((rows, M, h), np.int64)
    bc = lambda a: np.broadcast_to(a[:, None], (rows, M) + a.shape[1:])
    if isub == 0:
        c, l2, t2 = bc(t[:, 0]), bc(le[:, :2 * h]), bc(t[:, 1:1 + 2 * h])
    elif isub == 1:
        c = bc(t[:, h])
        l2 = np.concatenate([cv[:, :, :h, h - 1], z], -1)
        t2 = bc(t[:, 1 + h:1 + 3 * h])
    elif isub == 2:
        c, l2, t2 = bc(le[:, h - 1]), bc(le[:, h:3 * h]), cv[:, :, h - 1, :]
    else:
        c = cv[:, :, h - 1, h - 1]
        l2 = np.concatenate([cv[:, :, h:, h - 1], z], -1)
        t2 = np.concatenate([cv[:, :, h - 1, h:], z], -1)
    bll, blb, baa, bar = (fl[:, k] for k in range(4))
    on = np.ones_like(bll)
    sub = ((bll, bll, baa, baa), (on, ~on, baa, bar), (bll, blb, on, on),
           (on, ~on, on, ~on))[isub]
    f = np.broadcast_to(np.stack(sub, -1)[:, None], (rows, M, 4))
    return c, l2, t2, f


# ------------------------------------------------------------------- X1

@pytest.mark.parametrize("sz", [4, 8, 16, 32])
def test_x1_whole_block_matches_jax(sz):
    """predict (all 35 modes from a shared border) on the CPU equals the
    JAX package's build_borders + predict_all_modes, for every flag
    combination, uint8 and int32 contexts and a single (spec) row; the
    kernel's two-tap model equals it too."""
    rng = np.random.default_rng(10 + sz)
    top, left, fl = _contexts(rng, sz, 32)
    S, want = (np.asarray(a) for a in _jax_predict(sz, top[:, 0], left,
                                                   top[:, 1:], fl))
    got = fn.predict(sz, _t(top), _t(left), _t(fl))
    assert got.dtype == torch.uint8 and got.shape == (32, 35, sz, sz)
    _eq(got, want, f"sz={sz}")
    _eq(fn.predict(sz, _t(top.astype(np.int32)), _t(left.astype(np.int32)),
                   _t(fl)), want, "int32 context")
    _eq(fn.predict(sz, _t(top[5]), _t(left[5]), _t(fl[5])), want[5],
        "one row")
    Sm = _np_border(sz, top[:, 0], left, top[:, 1:], fl)
    _eq(Sm, np.asarray(S), "border model")
    model = np.stack([_np_predict(sz, Sm, m) for m in range(35)], 1)
    _eq(model, want, "two-tap model")


def test_x1_frac0_rows_read_one_tap():
    """rows with frac = 0 exist at every size (modes 2, 18 and 34 have
    angle 32 everywhere); there the second tap may lie one past its
    segment, and the model (which never reads it) still equals the
    chain."""
    for sz in (4, 8, 16, 32):
        idx1, idx2, frac, _ = intra._angular_tables(sz)
        assert (frac[[2, 18, 34]] == 0).all()
        n_s = 2 + 8 * sz
        assert idx2[frac[..., 0] == 0].max() <= n_s
        assert idx1.max() < n_s and idx2[frac[..., 0] > 0].max() < n_s


@pytest.mark.parametrize("sz", [8, 16, 32])
def test_x1_sub_tu_matches_jax(sz):
    """predict on a TU split's sub-TU (isub 0-3; the lane's mode given, or
    lane = mode) equals JAX's build_borders + predict_all_modes at the
    lane's mode on the borders assembled by the kernel's rule from the
    context and each lane's own canvas."""
    rng = np.random.default_rng(30 + sz)
    h, rows = sz // 2, 16
    top, left, fl = _contexts(rng, sz, rows)
    # four chosen modes on every flag combination; lane = mode (35 lanes)
    # on four of them
    for M, modes, n in ((4, rng.integers(0, 35, (rows, 4)).astype(np.int32),
                         rows), (35, None, 4)):
        t, le, f_ = top[:n], left[:n], fl[:n]
        canvas = rng.integers(0, 256, (n, M, sz, sz)).astype(np.uint8)
        mode = (np.broadcast_to(np.arange(35), (n, 35)) if modes is None
                else modes)
        for isub in range(4):
            got = fn.predict(sz, _t(t), _t(le), _t(f_),
                             None if modes is None else _t(modes),
                             _t(canvas), isub)
            assert got.shape == (n, M, h, h)
            c, l2, t2, f = _np_sub_border(sz, isub, t, le, f_, canvas)
            p35 = np.asarray(_jax_predict(h, c, l2, t2, f)[1])
            want = np.take_along_axis(
                p35, mode[:, :, None, None, None], 2)[:, :, 0]
            _eq(got, want, f"sz={sz} isub={isub} M={M}")
            Sm = _np_border(h, c, l2, t2, f)
            model = np.stack([_np_predict(h, Sm, m) for m in range(35)], 2)
            _eq(np.take_along_axis(model, mode[:, :, None, None, None],
                                   2)[:, :, 0], want, "two-tap model")


@pytest.mark.parametrize("qpd6", range(5))
def test_tusplit_on_preselected_modes_matches_jax(qpd6):
    """eval_tusplit(modes=) (X1's sub-TU chain with K1's plain version)
    equals the JAX package's eval_tusplit(sel_oh=) on the same modes, at
    sz 8 on every flag combination."""
    rng = np.random.default_rng(40 + qpd6)
    sz = 8
    top, left, fl = _contexts(rng, sz, 16)
    orig = rng.integers(0, 256, (16, sz, sz)).astype(np.uint8)
    modes = np.sort(rng.choice(35, (16, 4)), -1).astype(np.int32)
    modes[0] = (0, 1, 10, 26)
    want = jcu.eval_tusplit(sz, qpd6, top.astype(np.int32),
                            left.astype(np.int32), fl, orig.astype(np.int32),
                            sel_oh=modes[..., None] == np.arange(35))
    got = cu_eval.eval_tusplit(sz, qpd6, _t(top), _t(left), _t(fl), _t(orig),
                               modes=_t(modes))
    for g, w, name in zip(got, want, ("quant", "recon", "sse")):
        _eq(g, w, name)


# ------------------------------------------------------------------- X2

def _np_satd(r):
    """the kernel's butterfly SATD: in-place Walsh-Hadamard passes over
    rows, then columns, sum of |.| (int64)."""
    x = np.asarray(r, np.int64).copy()
    n = x.shape[-1]
    for axis in (-1, -2):
        x = np.moveaxis(x, axis, -1)
        length = 1
        while length < n:
            y = x.reshape(x.shape[:-1] + (n // (2 * length), 2, length))
            a, b = y[..., 0, :].copy(), y[..., 1, :].copy()
            y[..., 0, :], y[..., 1, :] = a + b, a - b
            x = y.reshape(x.shape)
            length *= 2
        x = np.moveaxis(x, -1, axis)
    return np.abs(x).sum((-1, -2))


def _np_rank_topk(cost, K):
    """the kernel's top K: mode m is kept when fewer than K modes come
    before it in (cost, mode) order; the kept modes ascending."""
    c = np.asarray(cost, np.int64)
    M = c.shape[-1]
    j = np.arange(M)
    before = (c[..., None, :] < c[..., :, None]) | (
        (c[..., None, :] == c[..., :, None]) & (j[None, :] < j[:, None]))
    keep = before.sum(-1) < K
    return [np.flatnonzero(k) for k in keep.reshape(-1, M)]


@functools.partial(jax.jit, static_argnums=(0, 7))
def _jax_preselect(sz, top, left, fl, blk, pml, pma, K):
    """hevce_tpu/models/wavefront._eval_node_rmd's front half, on its own
    functions: (predK, the kept modes ascending, SATD, forced)."""
    pred35 = _jax_predict(sz, top[:, 0], left, top[:, 1:], fl)[1]
    resid = blk[:, None].astype(jnp.int16) - pred35.astype(jnp.int16)
    sat_d = jsatd.block_satd(sz, resid)
    m0, m1, m2 = jwf._mpm_triplet(pml, pma)
    modes = jnp.arange(35, dtype=jnp.int32)
    forced = ((modes[None, :] <= 1) | (modes[None, :] == m0[:, None])
              | (modes[None, :] == m1[:, None])
              | (modes[None, :] == m2[:, None]))
    ohK = jwf._topk_mask(sat_d - (forced.astype(jnp.int32) << 29), K)
    predK = jwf._compress_u8(ohK, pred35)
    return predK, ohK.argmax(-1).astype(jnp.int32), sat_d, forced


@pytest.mark.parametrize("sz", [8, 16, 32])
def test_x2_preselect_matches_jax(sz):
    """preselect on the CPU equals the JAX chain (build_borders,
    predict_all_modes, block_satd, the forced bias, _topk_mask,
    _compress_u8) at K 1, 4, 12 and 35, on every flag combination, with
    SATD ties across the K-th place (a flat border: every mode predicts
    alike), equal neighbour modes and planar / DC neighbours; the kernel's
    butterfly SATD and rank-count top K equal the chain's."""
    rng = np.random.default_rng(50 + sz)
    rows = 32
    top, left, fl = _contexts(rng, sz, rows)
    blk = rng.integers(0, 256, (rows, sz, sz)).astype(np.uint8)
    blk[3] = 200                     # flat borders (rows 0, 3): ties
    top[3], left[3] = 200, 200
    pml = rng.integers(0, 35, rows).astype(np.int32)
    pma = rng.integers(0, 35, rows).astype(np.int32)
    pml[:4], pma[:4] = (7, 0, 1, 30), (7, 1, 0, 30)
    for K in (1, 4, 12, 35):
        wantp, wantm, sat_d, forced = (np.asarray(a) for a in _jax_preselect(
            sz, top, left, fl, blk, pml, pma, K))
        gotp, gotm = fn.preselect(sz, _t(top), _t(left), _t(fl), _t(blk),
                                  _t(pml), _t(pma), K)
        _eq(gotm, wantm, f"modes sz={sz} K={K}")
        _eq(gotp, wantp, f"predictions sz={sz} K={K}")
        ranked = _np_rank_topk(sat_d.astype(np.int64) - (forced << 29), K)
        _eq(np.stack(ranked), wantm, "rank-count top K")
    # rows 0 and 3: every mode predicts alike, so all 35 SATDs tie
    assert len(set(sat_d[0])) == 1 and len(set(sat_d[3])) == 1
    resid = (blk[:, None].astype(np.int16)
             - np.asarray(intra.predict_all_modes(
                 sz, intra.build_borders(sz, _t(top[:, 0]), _t(left),
                                         _t(top[:, 1:]), *(_t(fl[:, k])
                                                           for k in range(4))
                                         ))).astype(np.int16))
    _eq(_np_satd(resid), satd.block_satd(sz, _t(resid)), "butterfly SATD")


def test_rank_count_topk_with_ties_matches_topk_mask():
    """the rank count keeps _topk_mask's set on costs full of ties across
    the K-th place, the forced bias included."""
    rng = np.random.default_rng(60)
    for K in (1, 2, 4, 12, 34, 35):
        cost = rng.integers(0, 4, (64, 35)).astype(np.int32)
        cost[1] = 5
        cost[2, :12] -= 1 << 29
        oh = fn._topk_mask(_t(cost), K).numpy()
        want = [np.flatnonzero(r.any(0)) for r in oh]
        for a, b in zip(_np_rank_topk(cost, K), want):
            _eq(a, b, f"K={K}")


# ------------------------------------------------------------------- X3

def _levels(rng, rows, M, shape):
    """sparse levels with adversarial candidates: all-zero blocks, K1's
    int16 extremes (+-32767, -32768), one level at the last scan position,
    dense small levels."""
    q = np.where(rng.random((rows, M) + shape) < 0.12,
                 rng.integers(-40, 41, (rows, M) + shape), 0)
    q[0, 0] = 0
    q[0, 1] = 32767
    q[0, 2] = -32768
    q[1, 0] = rng.choice([-32768, -32767, 32767], shape)
    q[1, 1] = 0
    q[1, 1].reshape(-1)[-1] = 1
    q[2, 0] = rng.integers(-3, 4, shape)
    return q.astype(np.int16)


def _sse(rng, rows, M, qpd6):
    """SSEs with the RD cost's saturation edges (I32_MAX // w and around,
    I32_MAX itself; at w = 1 the edge + 1 wraps to -2^31, whose untaken
    product wraps too)."""
    lim = I32_MAX // int(C.RDCOST_WEIGHT_DIST[qpd6])
    s = rng.integers(0, 255 * 255 * 1024, (rows, M))
    s.reshape(-1)[:5] = (lim - 1, lim, lim + 1, I32_MAX, 0)
    return s.astype(np.int32)


def _jax_rate_cost(sz, qpd6, q, sse, cv, sv, pml, pma, hdr, modes, split):
    """the JAX package's chain (_pmode_rate picked by mode, _lastxy_rate at
    the mode's scan type, _est_rate, calc_rd_cost), as its node functions
    write it; the rate is compiled once per case, not per qpd6."""
    r = _jax_rate_jit(sz, hdr, split, q, cv, sv, pml, pma, modes)
    return np.asarray(jrdcost.calc_rd_cost(qpd6, sse, (r + jwf.HALF) >> 15))


@functools.partial(jax.jit, static_argnums=(0, 1, 2))
def _jax_rate_jit(sz, hdr, split, q, cv, sv, pml, pma, modes):
    n = sz // 2 if split else sz
    pmr = jwf._pmode_rate(pml, pma, cv)
    stv = None
    if modes is not None:
        pmr = jnp.take_along_axis(pmr, modes, 1)
        if n <= 8:
            stv = jnp.asarray(jwf._scan_consts(n)[3])[modes]
    if split:
        last = sum(jwf._lastxy_rate(n, q[..., k, :, :], cv, sv, stv=stv)
                   for k in range(4))
        est = jwf._est_rate(q, (-1, -2, -3))
    else:
        last = jwf._lastxy_rate(n, q, cv, sv, stv=stv)
        est = jwf._est_rate(q, (-1, -2))
    return est + last + pmr + hdr * cv[:, None]


def _np_rate_cost(sz, qpd6, q, sse, cv, sv, pml, pma, hdr, modes, split):
    """the kernel's formulation: per candidate the level rates summed (the
    exponent by the bit length), per sub-block the last scan index, the
    packed table read by scan index, the middle CGs counted from a bit mask
    of nonzero CGs; int64 then wrapped to int32 where the chain wraps."""
    n = sz // 2 if split else sz
    nn = n * n
    inv, cnt, byp, stm = fn._scan_consts(n)
    by_scan = np.zeros_like(cnt)
    for st in range(3):
        by_scan[st, inv[st]] = byp[st] + (cnt[st] << 20)
    rows, M = q.shape[:2]
    qs = q.reshape(rows, M, -1, nn).astype(np.int64)
    a = np.where(qs == -32768, -32768, np.abs(qs))
    lvl = np.asarray(C.LEVEL_RATE_TABLE, np.int64)
    big = 92000 + ((4 + 2 * (np.frexp(np.maximum(a - 5, 1))[1] - 1)) << 15)
    rate = np.where(a < 6, lvl[np.clip(np.where(a < 0, 5, a), 0, 5)], big)
    est = rate.sum((-1, -2))
    mode = (np.broadcast_to(np.arange(M), (rows, M)) if modes is None
            else modes)
    st = stm[mode] if n <= 8 else np.zeros((rows, M), np.int64)
    last = np.zeros((rows, M), np.int64)
    for r in range(rows):
        for m in range(M):
            for s in range(qs.shape[2]):
                sig = qs[r, m, s] != 0
                if not sig.any():
                    continue
                k = inv[st[r, m]][sig]
                il, nz = int(k.max()), int(sig.sum())
                sel = int(by_scan[st[r, m], il])
                v = (sel >> 20) * cv[r] + (sel & 0xFFFFF) + (il + 1 - nz) * sv[r]
                if nn > 16:
                    mask = 0
                    for g in k >> 4:
                        mask |= 1 << int(g)
                    cg_last = il >> 4
                    n_mid = max(cg_last - 1, 0)
                    mid = ((1 << cg_last) - 1) & ~1 if cg_last >= 2 else 0
                    v += -16 * (n_mid - bin(mask & mid).count("1")) * sv[r] \
                        + n_mid * cv[r]
                last[r, m] += v
    m0, m1, m2 = (np.asarray(x) for x in jwf._mpm_triplet(
        jnp.asarray(pml), jnp.asarray(pma)))
    hits = np.full((rows, M), 5)
    hits = np.where(mode == m0[:, None], 1, hits)
    hits = np.where((mode == m1[:, None]) | (mode == m2[:, None]), 2, hits)
    rf = est + last + cv[:, None] + hits * (1 << 15) + hdr * cv[:, None]
    wrap = lambda x: (x + (1 << 31)) % (1 << 32) - (1 << 31)    # int32
    bits = wrap(wrap(rf) + (1 << 14)) >> 15
    wd, wb = int(C.RDCOST_WEIGHT_DIST[qpd6]), int(C.RDCOST_WEIGHT_BITS[qpd6])
    d = sse.astype(np.int64)
    c1 = np.where(I32_MAX // wd <= d, I32_MAX, wrap(wd * d))
    c2 = np.where(I32_MAX // wb <= bits, I32_MAX, wrap(wb * bits))
    return np.where(wrap(I32_MAX - c1) <= c2, I32_MAX, wrap(c1 + c2))


# (sz, lanes, split, modes given, header bins): the main path's X3 calls
X3_CASES = [
    (8, 12, False, True, 6), (16, 12, False, True, 6),
    (32, 12, False, True, 6),                        # RMD 2Nx2N on K
    (8, 4, True, True, 9), (16, 4, True, True, 9),
    (32, 4, True, True, 9),                          # RMD TU split on T
    (4, 35, False, False, 1),                        # NxN PUs
    (8, 35, False, False, 6), (32, 35, False, False, 6),
    (16, 35, True, False, 9),                        # dense
]


@pytest.mark.parametrize("sz,M,split,with_modes,hdr", X3_CASES)
def test_x3_rate_cost_matches_jax(sz, M, split, with_modes, hdr):
    """rate_cost on the CPU equals the JAX chain at qpd6 0-4, with all-zero
    blocks, levels at K1's int16 extremes, SSEs at the RD cost's saturation
    edges and prices up to 4 bits; the numpy model of one warp's work
    equals it too."""
    rng = np.random.default_rng(sz * 7 + M + split)
    rows = 6
    n = sz // 2 if split else sz
    shape = (4, n, n) if split else (n, n)
    cv = rng.integers(0, 4 << 15, rows).astype(np.int32)
    sv = rng.integers(0, 4 << 15, rows).astype(np.int32)
    cv[0], sv[0] = 4 << 15, 4 << 15
    pml = rng.integers(0, 35, rows).astype(np.int32)
    pma = rng.integers(0, 35, rows).astype(np.int32)
    pml[1], pma[1] = 1, 1
    modes = (np.sort(rng.choice(35, (rows, M)), -1).astype(np.int32)
             if with_modes else None)
    for qpd6 in range(5):
        q = _levels(rng, rows, M, shape)
        sse = _sse(rng, rows, M, qpd6)
        args = (sz, qpd6, q, sse, cv, sv, pml, pma, hdr, modes, split)
        want = _jax_rate_cost(*args)
        got = fn.rate_cost(sz, qpd6, _t(q), _t(sse), _t(cv), _t(sv),
                           _t(pml), _t(pma), hdr,
                           None if modes is None else _t(modes), split)
        assert got.dtype == torch.int32 and got.shape == (rows, M)
        _eq(got, want, f"qpd6={qpd6}")
        if qpd6 in (0, 4):           # the RD weights' extremes (11 / 1)
            _eq(_np_rate_cost(*args), want, f"model qpd6={qpd6}")
        assert (want == I32_MAX).any()                 # saturation taken


# --------------------------------------------------------- tables, checks

def test_kernel_tables_hold_the_chain_constants():
    """X1 / X2's angular table and X3's scan table are the chain's
    constants in the kernels' layout, built once per device."""
    for sz in (4, 8, 16, 32):
        idx1, idx2, frac, _ = intra._angular_tables(sz)
        tab = fn._angular_dev(sz, "cpu").numpy()
        k = 35 * sz * sz
        _eq(tab[:k], idx1.ravel())
        _eq(tab[k:2 * k], idx2.ravel())
        _eq(tab[2 * k:], frac.ravel())
        inv, cnt, byp, stm = fn._scan_consts(sz)
        nn = sz * sz
        st = fn._scan_dev(sz, "cpu").numpy()
        _eq(st[:3 * nn].reshape(3, nn), inv)
        by_scan = st[3 * nn:6 * nn].reshape(3, nn)
        for s in range(3):
            _eq(by_scan[s, inv[s]], byp[s] + (cnt[s] << 20))
        _eq(st[6 * nn:], stm)
        assert fn._scan_dev(sz, "cpu") is fn._scan_dev(sz, torch.device(
            "cpu"))


def test_wrappers_take_cpu_or_one_cuda_device():
    """a tensor on neither the CPU nor CUDA is refused, as is a mix."""
    meta = torch.zeros((2, 9), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="one CUDA device or on the CPU"):
        fn.predict(4, meta, meta[:, :8], torch.zeros((2, 4), dtype=torch.bool,
                                                     device="meta"))
    q = torch.zeros((2, 35, 4, 4), dtype=torch.int16)
    v = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="one CUDA device or on the CPU"):
        fn.rate_cost(4, 2, q, torch.zeros((2, 35), dtype=torch.int32,
                                          device="meta"), v, v, v, v, 1)


@pytest.mark.parametrize("rmd,counts", [
    ((12, 4), {"X1 predict": 148, "X2 preselect": 21, "X3 rate_cost": 106,
               "X4 pick": 85, "K1": 169}),
    (None, {"X1 predict": 153, "X3 rate_cost": 106, "X4 pick": 85,
            "K1": 153})])
def test_one_front_step_launches_few_kernels(rmd, counts):
    """one eager front step, counted by the chain tool on the CPU: each
    kernel wrapper is called as often as the code implies (X1: the NxN PUs
    and the TU splits' sub-TUs, with the dense 2Nx2N; X2: one per RMD node;
    X3: two per node and one per NxN PU; X4: one per node and per NxN
    PU), and the step's ops, a kernel
    each on the card, stay under a quarter of the eager step's 43,381
    graph nodes before the fused node kernels."""
    rows = profile_front.chains(torch.device("cpu"), 1, 0, rmd,
                                out=lambda *a: None)
    got = {k: n for k, (n, _) in rows.items() if k in counts}
    assert got == counts
    assert "X2 preselect" in rows or rmd is None
    assert sum(n for n, _ in rows.values()) <= 43381 // 4


class _Event:
    """a Kineto event as card_by_chain reads it."""

    def __init__(self, name, dev, t0, t1=None, corr=0, linked=0):
        self._v = (name, dev, t0, t1 if t1 is not None else t0 + 1, corr,
                   linked)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def end_ns(self):
        return self._v[3]

    def duration_ns(self):
        return (self._v[3] - self._v[2]) * 10**6

    def correlation_id(self):
        return self._v[4]

    def linked_correlation_id(self):
        return self._v[5]


def test_card_by_chain_takes_the_innermost_range():
    """the chain tool's card table: a kernel of the port's by its name, any
    other by the innermost chain range around the op that launched it
    (nested and disjoint ranges), else front_core's own; a range's own span
    on the card's timeline is not counted."""
    from torch.autograd import DeviceType

    cpu, gpu = DeviceType.CPU, DeviceType.CUDA
    evs = [_Event("node (own)", cpu, 0, 100, corr=1),
           _Event("rate+cost", cpu, 10, 30, corr=2),
           _Event("aten::add", cpu, 12, 13, corr=3),
           _Event("aten::mul", cpu, 40, 41, corr=4),
           _Event("picks", cpu, 50, 60, corr=5),
           _Event("aten::sum", cpu, 200, 201, corr=6),
           _Event("aten::eq", cpu, 55, 56, corr=7),
           _Event("elementwise_kernel", gpu, 0, 2, linked=3),
           _Event("elementwise_kernel", gpu, 2, 5, linked=4),
           _Event("reduce_kernel", gpu, 5, 6, linked=6),
           _Event("reduce_kernel", gpu, 6, 7, linked=7),
           _Event("x3_rate_cost_kernel", gpu, 7, 9, linked=1),
           _Event("rate+cost", gpu, 0, 9)]
    prof = type("P", (), {})()
    prof.profiler = type("Q", (), {})()
    prof.profiler.kineto_results = type("R", (), {"events": lambda _: evs})()
    rows = profile_front.card_by_chain(prof)
    assert rows == {"rate+cost": (1, 2.0), "node (own)": (1, 3.0),
                    profile_front.OUTSIDE: (1, 1.0), "picks": (1, 1.0),
                    "X3 rate_cost": (1, 2.0)}
