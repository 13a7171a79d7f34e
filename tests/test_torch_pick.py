"""X4's plain version (ops/fused_node.pick_plain) against the node
functions' argmin and one-hot picks as models/wavefront ran them before the
pick became one kernel, and the ops one front step issues now, on the CPU,
exactly (tolerance 0).

The kernel itself runs only on the card (tests/test_torch_cuda.py); here
the wrapper takes its plain route, since its inputs lie on the CPU. Nothing
here compiles a JAX program: the node functions' parity with the JAX
package stays with tests/test_torch_nodes.py and the test_torch_slice_*
files.
"""
import numpy as np
import pytest
import torch

from hevce_tpu_torch.models import wavefront as wf
from hevce_tpu_torch.ops import fused_eval
from hevce_tpu_torch.ops import fused_node as fn
from hevce_tpu_torch.tools import profile_front

# the test workers share the machine's cores: one intra-op thread each
torch.set_num_threads(1)

I32_MAX = 2**31 - 1
MODES = 35


# ------------------------------------------- the chain before X4, verbatim

def _i32(x):
    return x.to(torch.int32)


def _argmin_first(x, dim):
    mn = x.min(dim, keepdim=True).values
    idx = torch.arange(x.shape[dim], dtype=torch.int32, device=x.device)
    idx = idx.reshape((-1,) + (1,) * (x.dim() - 1 - (dim % x.dim())))
    first = torch.where(x == mn, idx, x.shape[dim]).min(dim).values
    return mn.squeeze(dim), _i32(first)


def _onehot_pick(x, oh, dtype):
    return (_i32(x) * _i32(oh)[:, :, None]).sum(1, dtype=torch.int32) \
        .to(dtype)


def old_dense(sz, cost1, q1, r1, cost3, q4, r4):
    """_eval_node's pick."""
    cost, sel = _argmin_first(torch.cat([cost1, cost3], 1), 1)
    lay = torch.where(sel < MODES, 1, 2)
    pm = torch.where(sel < MODES, sel, sel - MODES)
    B = sel.shape[0]
    nn = sz * sz
    modes = torch.arange(MODES, dtype=torch.int32)
    oh1 = modes[None, :] == sel[:, None]
    oh3 = modes[None, :] == (sel[:, None] - MODES)
    quant = (_onehot_pick(q1.reshape(B, MODES, nn), oh1, torch.int16)
             + _onehot_pick(q4.reshape(B, MODES, nn), oh3, torch.int16))
    recon = (_onehot_pick(r1.reshape(B, MODES, nn), oh1, torch.uint8)
             + _onehot_pick(r4.reshape(B, MODES, nn), oh3, torch.uint8))
    return cost, _i32(lay), pm, quant, recon.reshape(B, sz, sz)


def old_rmd(sz, K, cost1, qK, rK, cost3, q4, r4, modesK, modesT):
    """_eval_node_rmd's pick."""
    Tn = cost3.shape[-1]
    costs = torch.cat([cost1, cost3], 1)
    cost, sel = _argmin_first(costs, 1)
    lay = torch.where(sel < K, 1, 2)
    B = costs.shape[0]
    nn = sz * sz
    oh1 = torch.arange(K, dtype=torch.int32)[None, :] == sel[:, None]
    oh3 = torch.arange(Tn, dtype=torch.int32)[None, :] == (sel[:, None] - K)
    pm = torch.cat([modesK, modesT], 1).gather(1, sel[:, None].long())[:, 0]
    quant = (_onehot_pick(qK.reshape(B, K, nn), oh1, torch.int16)
             + _onehot_pick(q4.reshape(B, Tn, nn), oh3, torch.int16))
    recon = (_onehot_pick(rK.reshape(B, K, nn), oh1, torch.uint8)
             + _onehot_pick(r4.reshape(B, Tn, nn), oh3, torch.uint8))
    return cost, _i32(lay), pm, quant, recon.reshape(B, sz, sz)


def old_pu(cost, q, r, local, y, x, total):
    """one PU of _eval_nxn: (c, sel, qw, local, total) after it."""
    c, sel = _argmin_first(cost, 1)
    B = sel.shape[0]
    oh = torch.arange(MODES, dtype=torch.int32)[None, :] == sel[:, None]
    qw = _onehot_pick(q.reshape(B, MODES, 16), oh, torch.int16)
    rw = _onehot_pick(r.reshape(B, MODES, 16), oh, torch.uint8)
    local[:, y + 1:y + 5, x + 1:x + 5] = rw.reshape(B, 4, 4)
    total = torch.where(total > I32_MAX - c, I32_MAX, total + c)
    return c, sel, qw, local, total


# ------------------------------------------------------------------ inputs

def _costs(rng, kind, shape):
    """random RD costs; "ties": few values, so the minimum ties across the
    sets; "saturated": most at I32_MAX, the first rows all of them."""
    if kind == "random":
        return torch.from_numpy(rng.integers(0, 1 << 24, shape).astype(
            np.int32))
    if kind == "ties":
        return torch.from_numpy(rng.integers(5, 8, shape).astype(np.int32))
    c = np.where(rng.random(shape) < 0.8, I32_MAX,
                 rng.integers(I32_MAX - 64, I32_MAX, shape))
    c[:3] = I32_MAX
    return torch.from_numpy(c.astype(np.int32))


def _blocks(rng, shape):
    q = torch.from_numpy(rng.integers(-32768, 32768, shape).astype(np.int16))
    r = torch.from_numpy(rng.integers(0, 256, shape).astype(np.uint8))
    return q, r


def _same(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w)


KINDS = ("random", "ties", "saturated")


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("sz", [8, 32])
def test_pick_equals_the_dense_nodes_old_pick(kind, sz):
    """dense: 35 2Nx2N candidates and the TU split's 35, its levels as the
    (B, 35, 4, h, h) sub-TUs; pm is the index in the winner's layout."""
    rng = np.random.default_rng(100 * KINDS.index(kind) + sz)
    B, h = 16, sz // 2
    q1, r1 = _blocks(rng, (B, MODES, sz, sz))
    q4, _ = _blocks(rng, (B, MODES, 4, h, h))
    _, r4 = _blocks(rng, (B, MODES, sz, sz))
    c1, c3 = _costs(rng, kind, (B, MODES)), _costs(rng, kind, (B, MODES))
    want = old_dense(sz, c1, q1, r1, c3, q4, r4)
    _same(fn.pick_plain(c1, q1, r1, c3, q4, r4), want)
    _same(fn.pick(c1, q1, r1, c3, q4, r4), want)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("sz", [8, 16])
def test_pick_equals_the_rmd_nodes_old_pick(kind, sz):
    """RMD: K = 12 2Nx2N candidates and the TU split on the top T = 4,
    their modes from the maps."""
    rng = np.random.default_rng(500 + 100 * KINDS.index(kind) + sz)
    B, K, T, h = 16, 12, 4, sz // 2
    qK, rK = _blocks(rng, (B, K, sz, sz))
    q4, _ = _blocks(rng, (B, T, 4, h, h))
    _, r4 = _blocks(rng, (B, T, sz, sz))
    c1, c3 = _costs(rng, kind, (B, K)), _costs(rng, kind, (B, T))
    modesK = torch.from_numpy(np.sort(rng.choice(MODES, (B, K)), -1).astype(
        np.int32))
    modesT = modesK[:, rng.permutation(K)[:T]].contiguous()
    want = old_rmd(sz, K, c1, qK, rK, c3, q4, r4, modesK, modesT)
    _same(fn.pick_plain(c1, qK, rK, c3, q4, r4, modesK, modesT), want)


@pytest.mark.parametrize("kind", KINDS)
def test_pick_equals_the_nxn_pus_old_pick(kind):
    """the four PUs of an NxN leaf: each pick's mode and levels into their
    slots, its recon into the leaf's canvas at the PU, its cost into the
    saturating running total; PU0 read through the views of a dense
    TU split's first sub-TU (non-contiguous levels and recon)."""
    rng = np.random.default_rng(900 + KINDS.index(kind))
    B = 16
    A = torch.from_numpy(rng.integers(0, 256, (B, 33, 33)).astype(np.uint8))
    q4, _ = _blocks(rng, (B, MODES, 4, 4, 4))
    _, r4 = _blocks(rng, (B, MODES, 8, 8))
    total0 = torch.from_numpy(rng.integers(0, I32_MAX, B).astype(np.int32))
    total0[:4] = torch.tensor((I32_MAX, I32_MAX - 1, 0,
                               I32_MAX - (1 << 24)))
    old_local, old_total = A.clone(), total0.clone()
    local, total = A.clone(), total0.clone()
    pm4 = torch.empty((B, 4), dtype=torch.int32)
    quant = torch.empty((B, 64), dtype=torch.int16)
    sels, qws = [], []
    y0, x0 = 8, 16
    for isub, (dy, dx) in enumerate(wf._SUB):
        y, x = y0 + 4 * dy, x0 + 4 * dx
        if isub == 0:
            q, r = q4[..., 0, :, :], r4[..., 0:4, 0:4]
        else:
            q, r = _blocks(rng, (B, MODES, 4, 4))
        cost = _costs(rng, kind, (B, MODES))
        c, sel, qw, old_local, old_total = old_pu(cost, q, r, old_local, y, x,
                                                  old_total)
        got = fn.pick(cost, q, r, pm=pm4[:, isub],
                      quant=quant[:, 16 * isub:16 * isub + 16],
                      recon=local[:, y + 1:y + 5, x + 1:x + 5], total=total)
        _same(got[:1] + got[2:4], (c, sel, qw))
        assert got[2].data_ptr() == pm4[:, isub].data_ptr()
        sels.append(sel)
        qws.append(qw)
    _same((pm4, quant, local, total), (torch.stack(sels, -1),
                                       torch.cat(qws, -1), old_local,
                                       old_total))


def _standins(monkeypatch, seed):
    """K1 and X1-X3 replaced by stand-ins that return what the kernels
    return, in shape and type, without their work; X4 keeps its plain
    version. The ops a front step issues outside the kernels do not depend
    on the values, so the chain tool's count is the real step's."""
    rng = torch.Generator().manual_seed(seed)

    def k1(sz, qpd6, pred, blk):
        return (torch.zeros(pred.shape, dtype=torch.int16), pred.clone(),
                torch.zeros(pred.shape[:-2], dtype=torch.int32))

    def predict(sz, top, left, flags, modes=None, canvas=None, isub=None):
        M = MODES if modes is None else modes.shape[-1]
        n = sz if isub is None else sz // 2
        return torch.zeros(top.shape[:-1] + (M, n, n), dtype=torch.uint8)

    def preselect(sz, top, left, flags, blk, pml, pma, K):
        B = blk.shape[0]
        return (torch.zeros((B, K, sz, sz), dtype=torch.uint8),
                torch.arange(K, dtype=torch.int32).repeat(B, 1))

    def rate_cost(sz, qpd6, q, sse, *a, **k):
        return torch.randint(0, 1 << 20, q.shape[:2], generator=rng,
                             dtype=torch.int32)

    monkeypatch.setattr(fused_eval, "pipeline_sse", k1)
    monkeypatch.setattr(fn, "predict", predict)
    monkeypatch.setattr(fn, "preselect", preselect)
    monkeypatch.setattr(fn, "rate_cost", rate_cost)


@pytest.mark.parametrize("rmd,most", [((12, 4), 2400), (None, 2150)])
def test_one_front_step_picks_with_x4(monkeypatch, rmd, most):
    """one eager front step, counted by the chain tool: 85 X4 picks (21
    nodes, 64 NxN PUs), no pick op outside them, and at most `most` ops in
    all (4,378 RMD and 4,116 dense before X4)."""
    _standins(monkeypatch, 5)
    rows = profile_front.chains(torch.device("cpu"), 1, 0, rmd,
                                out=lambda *a: None)
    assert rows["X4 pick"][0] == 85
    assert rows.get("picks", (0, None))[0] == 0
    assert sum(n for n, _ in rows.values()) <= most
