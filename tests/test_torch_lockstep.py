"""The lockstep engine's device steps in the port against the JAX package's,
on the CPU, exactly (tolerance 0): mode-diagonal prediction, the dense
TU-split evaluation, the node step (sz 8, with trial rates against a live
coder fork) and the 4x4 PU step, on identical numpy-seeded requests.
"""
import functools

import jax
import numpy as np
import pytest
import torch

from hevce_tpu.bitstream import cabac as jcb
from hevce_tpu.models import cu_eval as jcu
from hevce_tpu.ops import intra as jintra
from hevce_tpu.parallel import lockstep as jls
from hevce_tpu_torch.models import cu_eval
from hevce_tpu_torch.ops import intra
from hevce_tpu_torch.parallel import lockstep

# the test workers share the machine's cores: one intra-op thread each
torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a))


def _eq(got, want, msg=""):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=msg)


def _requests(sz, B, seed):
    """node/PU requests as the engine lays them out: top row (1 + 2sz),
    left column (2sz), availability flags, originals (int32 pixels)."""
    rng = np.random.default_rng(seed)
    top = rng.integers(0, 256, (B, 1 + 2 * sz)).astype(np.int32)
    left = rng.integers(0, 256, (B, 2 * sz)).astype(np.int32)
    orig = rng.integers(0, 256, (B, sz, sz)).astype(np.int32)
    orig[1] = np.clip(left[1, :sz, None] // 2 + top[1, None, 1:sz + 1] // 2
                      + rng.integers(-3, 4, (sz, sz)), 0, 255)   # smooth
    top[2], left[2] = 255, 0                                      # extremes
    fl = rng.random((B, 4)) < 0.6
    fl[0], fl[2] = True, False
    return top, left, fl, orig


@pytest.mark.parametrize("sz", (4, 8, 16))
def test_predict_per_lane_matches_jax(sz):
    rng = np.random.default_rng(800 + sz)
    B = 3
    corner = rng.integers(0, 256, (B, 35)).astype(np.int32)
    left2 = rng.integers(0, 256, (B, 35, 2 * sz)).astype(np.int32)
    top2 = rng.integers(0, 256, (B, 35, 2 * sz)).astype(np.int32)
    fl = rng.random((B, 35, 4)) < 0.5
    S = np.asarray(jintra.build_borders(sz, corner, left2, top2, fl[..., 0],
                                        fl[..., 1], fl[..., 2], fl[..., 3]))
    want = jax.jit(functools.partial(jintra.predict_per_lane, sz))(S)
    got = intra.predict_per_lane(sz, _t(S))
    assert got.dtype == torch.uint8
    _eq(got, want)


@pytest.mark.parametrize("sz,qpd6", [(8, 0), (16, 2), (32, 4)])
def test_dense_eval_tusplit_matches_jax(sz, qpd6):
    top, left, fl, orig = _requests(sz, 3, 810 + sz)
    want = jcu.jit_eval_tusplit(sz, qpd6)(top, left, fl, orig)
    got = cu_eval.eval_tusplit(sz, qpd6, _t(top), _t(left), _t(fl), _t(orig))
    for name, g, w in zip(("quant", "recon", "sse"), got, want):
        _eq(g, w, name)


def _fork(rng, qpd6, B):
    """live coder forks: the JAX package's coder after random bins."""
    state, ctxs = [], []
    for _ in range(B):
        enc, c = jcb.CabacEncoder(), jcb.new_context_set(qpd6)
        for _ in range(int(rng.integers(0, 400))):
            r = rng.integers(0, 3)
            if r == 0:
                enc.encode_bin(c, int(rng.integers(0, 142)),
                               int(rng.integers(0, 2)))
            elif r == 1:
                enc.encode_bypass(int(rng.integers(0, 256)),
                                  int(rng.integers(1, 9)))
            else:
                enc.encode_terminate(0)
        state.append([enc.range, enc.low, enc.nbits, enc.outstanding,
                      enc.bufbyte, enc.zrun, len(enc.buf)])
        ctxs.append(np.frombuffer(bytes(c), np.uint8))
    return np.asarray(state, np.int32), np.stack(ctxs).astype(np.int32)


def test_node_step_matches_jax():
    """sz 8 only: the JAX sz-32 node step takes minutes to compile."""
    sz, qpd6, B = 8, 2, 3
    top, left, fl, orig = _requests(sz, B, 820)
    rng = np.random.default_rng(821)
    state7, ctxs = _fork(rng, qpd6, B)
    meta = np.stack([rng.integers(0, 35, B), rng.integers(0, 35, B),
                     rng.integers(0, 2, B), rng.integers(0, 2, B)],
                    1).astype(np.int32)
    want = jls._jit_node_step(sz, qpd6)(top, left, fl, orig, state7, ctxs,
                                        meta)
    got = lockstep._node_step(sz, qpd6, _t(top), _t(left), _t(fl), _t(orig),
                              _t(state7), _t(ctxs), _t(meta))
    names = ("q1", "r1", "sse", "q4", "r4", "sse4", "rates2", "rates3")
    for name, g, w in zip(names, got, want):
        _eq(g, w, name)
    assert (got[6] > 0).all() and (got[7] > 0).all()


@pytest.mark.parametrize("qpd6", (0, 3))
def test_pu_step_matches_jax(qpd6):
    top, left, fl, orig = _requests(4, 4, 830 + qpd6)
    want = jls._jit_pu_step(qpd6)(top, left, fl, orig)
    got = lockstep._pu_step(qpd6, _t(top), _t(left), _t(fl), _t(orig))
    for name, g, w in zip(("q1", "r1", "sse", "rates"), got, want):
        _eq(g, w, name)


def test_winner_gather_matches_jax():
    rng = np.random.default_rng(840)
    B, sz = 5, 8
    q1 = rng.integers(-50, 50, (B, 35, sz, sz)).astype(np.int16)
    q4 = rng.integers(-50, 50, (B, 35, 4, 4, 4)).astype(np.int16)
    r1 = rng.integers(0, 256, (B, 35, sz, sz)).astype(np.uint8)
    r4 = rng.integers(0, 256, (B, 35, sz, sz)).astype(np.uint8)
    sel = np.array([3, 40, 69, 0, -2], np.int32)
    wq, wr = lockstep._gather_winners((_t(q1), _t(q4)), (_t(r1), _t(r4)),
                                      _t(sel))
    jq, jr = jls._jit_gather_node(sz)(q1, r1, q4, r4, sel)
    _eq(wq.to(torch.int32), jq)
    _eq(wr, jr)
    wq, wr = lockstep._gather_winners((_t(q1[:, :, :4, :4]),),
                                      (_t(r1[:, :, :4, :4]),),
                                      _t(np.array([3, 34, 0, 7, -2], np.int32)))
    jq, jr = jls._jit_gather_pu()(np.ascontiguousarray(q1[:, :, :4, :4]),
                                  np.ascontiguousarray(r1[:, :, :4, :4]),
                                  np.array([3, 34, 0, 7, -2], np.int32))
    _eq(wq.to(torch.int32), jq)
    _eq(wr, jr)
