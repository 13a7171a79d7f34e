"""The port's wavefront rate model, selectors and node evaluations against
the JAX package's, on the CPU, exactly (tolerance 0).

Inputs are numpy-seeded random canvases, availability flags, neighbour
modes and per-lane bin prices, handed to both packages as numpy arrays.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hevce_tpu.models import wavefront as jwf
from hevce_tpu_torch.models import wavefront as twf

# the test workers share the machine's cores: one intra-op thread each
torch.set_num_threads(1)

BIT = twf.BIT


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _oracle_set(c, K):
    """K sequential argmin rounds, ties toward the lower index."""
    c = c.astype(np.int64).copy()
    picked = []
    for _ in range(K):
        i = int(np.argmin(c))
        picked.append(i)
        c[i] = np.iinfo(np.int64).max
    return sorted(picked)


def test_topk_mask_matches_sequential_argmin():
    cases = [(np.array([[4, 0, 2, 5, 3, 0, 4, 4, 5, 1]], np.int32), 7)]
    rng = np.random.default_rng(11)
    for K in (1, 2, 4, 5, 11, 12, 35):
        cases.append((rng.integers(0, 6, (8, 35)).astype(np.int32), K))
        cases.append((rng.integers(0, 10**6, (8, 35)).astype(np.int32), K))
    for cost, K in cases:
        oh = twf._topk_mask(_t(cost), K).numpy()
        assert oh.shape == cost.shape[:-1] + (K, cost.shape[-1])
        np.testing.assert_array_equal(
            oh, np.asarray(jwf._topk_mask(jnp.asarray(cost), K)))
        for b in range(cost.shape[0]):
            rows = [int(np.flatnonzero(oh[b, k])[0]) for k in range(K)]
            assert all(oh[b, k].sum() == 1 for k in range(K))
            assert rows == sorted(rows), "rows must ascend by index"
            assert rows == _oracle_set(cost[b], K), (cost[b], K, rows)


def test_lastxy_rate_oracle():
    """Direct numpy transcription of the model: exact last-position
    group-code rate, one SIG_ZERO per scanned zero before the last, except
    all-zero middle coefficient groups, which cost one CG_BIN (as does every
    middle group's sig_cg flag)."""
    rng = np.random.default_rng(3)
    for sz in (4, 8):
        q = np.where(rng.random((20, 35, sz, sz)) < 0.06,
                     rng.integers(-5, 6, (20, 35, sz, sz)), 0).astype(np.int16)
        cv = torch.full((20,), twf.CTX_BIT, dtype=torch.int32)
        sv = torch.full((20,), twf.SIG_ZERO, dtype=torch.int32)
        got = twf._lastxy_rate(sz, _t(q), cv, sv).numpy()
        inv, cnt, byp, stm = twf._scan_consts(sz)
        tbl = cnt * twf.CTX_BIT + byp
        exp = np.zeros((20, 35), np.int64)
        for b in range(20):
            for m in range(35):
                st = stm[m] if sz <= 8 else 0
                sig = q[b, m].reshape(-1) != 0
                if not sig.any():
                    continue
                il = (inv[st] * sig).max()
                rate = tbl[st][inv[st] == il][0]
                rate += (il + 1 - sig.sum()) * twf.SIG_ZERO
                if sz * sz > 16:
                    cg_pix = inv[st] >> 4
                    cg_last = il >> 4
                    nzero = sum(1 for c in range(1, cg_last)
                                if not sig[cg_pix == c].any())
                    rate += (-16 * nzero * twf.SIG_ZERO
                             + max(cg_last - 1, 0) * twf.CG_BIN)
                exp[b, m] = rate
        np.testing.assert_array_equal(got, exp)


@pytest.mark.parametrize("sz", [4, 8, 16, 32])
def test_rate_model_matches_jax(sz):
    """_lastxy_rate with per-lane prices and scan types, _est_rate,
    _pmode_rate / _mpm_triplet, _sel_i32 and _compress_u8."""
    rng = np.random.default_rng(100 + sz)
    B, M = 6, 12
    q = np.where(rng.random((B, M, sz, sz)) < 0.1,
                 rng.integers(-300, 301, (B, M, sz, sz)), 0).astype(np.int16)
    q[0, 0] = 0
    cv = rng.integers(int(0.4 * BIT), BIT, B).astype(np.int32)
    sv = rng.integers(0, int(0.5 * BIT), B).astype(np.int32)
    stv = rng.integers(0, 3, (B, M)).astype(np.int32)
    st_arg = (lambda f: f(stv)) if sz <= 8 else (lambda f: None)
    got = twf._lastxy_rate(sz, _t(q), _t(cv), _t(sv), stv=st_arg(_t))
    want = jwf._lastxy_rate(sz, jnp.asarray(q), jnp.asarray(cv),
                            jnp.asarray(sv), stv=st_arg(jnp.asarray))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        twf._est_rate(_t(q), (-1, -2)).numpy(),
        np.asarray(jwf._est_rate(jnp.asarray(q), (-1, -2))))

    pml = rng.integers(0, 35, B).astype(np.int32)
    pma = rng.integers(0, 35, B).astype(np.int32)
    pml[0], pma[0] = 7, 7                    # equal neighbours
    pml[1], pma[1] = 0, 1                    # planar / DC
    for a, b in zip(twf._mpm_triplet(_t(pml), _t(pma)),
                    jwf._mpm_triplet(jnp.asarray(pml), jnp.asarray(pma))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    pmr = twf._pmode_rate(_t(pml), _t(pma), _t(cv))
    np.testing.assert_array_equal(
        pmr.numpy(), np.asarray(jwf._pmode_rate(
            jnp.asarray(pml), jnp.asarray(pma), jnp.asarray(cv))))

    cost = rng.integers(0, 50, (B, 35)).astype(np.int32)
    oh = twf._topk_mask(_t(cost), M)
    ohj = jwf._topk_mask(jnp.asarray(cost), M)
    np.testing.assert_array_equal(
        twf._sel_i32(oh, pmr).numpy(),
        np.asarray(jwf._sel_i32(ohj, np.asarray(pmr.numpy()))))
    x = rng.integers(0, 256, (B, 35, sz, sz)).astype(np.uint8)
    x[0] = 255
    np.testing.assert_array_equal(
        twf._compress_u8(oh, _t(x)).numpy(),
        np.asarray(jwf._compress_u8(ohj, jnp.asarray(x))))


def _node_inputs(sz, seed, B=6):
    """a canvas with its context row/column, originals, flags, neighbour
    modes and prices, laid out as the front core hands them to a node."""
    rng = np.random.default_rng(seed)
    n = 65 if sz == 32 else 33
    A = rng.integers(0, 256, (B, n, n)).astype(np.uint8)
    A[1] = np.clip(np.add.outer(np.arange(n), np.arange(n)) * 3, 0, 255)
    orig = rng.integers(0, 256, (B, n - 1, n - 1)).astype(np.uint8)
    orig[1] = A[1, 1:, 1:] // 2 + 60          # smooth content
    fl = rng.random((B, 4)) < 0.6
    fl[0] = True
    fl[2] = False
    pm = rng.integers(0, 35, (4, B)).astype(np.int32)
    ctx = rng.integers(int(0.4 * BIT), int(0.8 * BIT), B).astype(np.int32)
    ctx[0] = twf.CTX_BIT
    sig = np.full(B, twf.SIG_ZERO, np.int32)
    return A, orig, fl, pm, (ctx, sig)


NODE_CASES = [(8, 1, 8, 0), (8, 2, 0, 8), (16, 3, 0, 0), (32, 2, 0, 0)]


@pytest.mark.parametrize("sz,qpd6,y0,x0", NODE_CASES)
def test_eval_node_rmd_matches_jax(sz, qpd6, y0, x0):
    A, orig, fl, pm, (ctx, sig) = _node_inputs(sz, 200 + sz + qpd6)
    K, T = twf.RMD_DEFAULT

    def jfn(A, orig, fl, pml, pma, ctx, sig):
        return jwf._eval_node_rmd(qpd6, A, orig, fl, pml, pma, y0, x0, sz,
                                  (ctx, sig), K, T)

    want = jax.jit(jfn)(A, orig, fl, pm[0], pm[1], ctx, sig)
    got = twf._eval_node_rmd(qpd6, _t(A), _t(orig), _t(fl), _t(pm[0]),
                             _t(pm[1]), y0, x0, sz, (_t(ctx), _t(sig)), K, T)
    names = ("cost", "lay", "pm", "quant", "recon")
    dtypes = (torch.int32, torch.int32, torch.int32, torch.int16, torch.uint8)
    for name, dt, g, w in zip(names, dtypes, got, want):
        assert g.dtype == dt, name
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    assert set(got[1].tolist()) <= {1, 2}


@pytest.mark.parametrize("qpd6,y0,x0", [(2, 0, 8), (4, 8, 0)])
def test_eval_nxn_matches_jax(qpd6, y0, x0):
    A, orig, fl, pm, (ctx, sig) = _node_inputs(8, 300 + qpd6)

    jfn = jax.jit(functools.partial(
        lambda A, orig, fl, pml, pma, lo, hi, ctx, sig: jwf._eval_nxn(
            qpd6, A, orig, fl, pml, pma, lo, hi, y0, x0, None, (ctx, sig))))
    want = jfn(A, orig, fl, *pm, ctx, sig)
    A_t = _t(A)
    got = twf._eval_nxn(qpd6, A_t, _t(orig), _t(fl), *(_t(p) for p in pm),
                        y0, x0, (_t(ctx), _t(sig)))
    assert torch.equal(A_t, _t(A)), "the canvas must not be modified"
    for name, g, w in zip(("cost", "pm4", "quant", "recon"), got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
