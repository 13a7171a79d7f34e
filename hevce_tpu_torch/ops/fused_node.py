"""Fused node kernels X1-X4 and their plain PyTorch versions.

The JAX package runs a front step as one compiled program, and XLA fuses
the element-wise and small-reduction chains of its node evaluations. Run
eagerly, the same chains are tens of thousands of small kernels a front
step. Four kernels written by hand (csrc/fused_node.cu) stand for those
fusions; none is a port of a Pallas kernel:

  X1 predict    intra prediction with its borders: ops/intra.build_borders
                with predict_all_modes (all 35 modes from one border) or,
                for a sub-TU of the TU split, the border assembled from
                each lane's own canvas and the lane's one mode
                (models/cu_eval.eval_2nx2n / eval_tusplit)
  X2 preselect  the RMD node's front half (models/wavefront._eval_node_rmd):
                the 35 predictions, SATD of their residuals, planar, DC and
                the three MPMs forced in, the top K and their predictions
  X3 rate_cost  per candidate the estimated rate (<<15: coefficient levels,
                last-XY and significance map, pmode, header bins) rounded to
                bits, and its RD cost with the candidate's SSE
  X4 pick       a node's or NxN PU's winner (models/wavefront's node
                functions): the first minimum over one or two candidate
                sets, its layout and mode, its levels and recon; for a PU,
                the recon into the leaf's canvas and the running total

Each wrapper runs its plain version, the op chain the kernel replaces, on
CPU tensors; on CUDA tensors it launches its kernel or raises, with no
fallback. Each launch adds one to its kernel's counter (X1.LAUNCHES, ...).
The rate model's pieces (_est_rate ... _compress_u8) and the picks'
(_argmin_first, _onehot_pick) live here, beside the kernels that fuse them;
models/wavefront imports them.
"""
import ctypes
import functools
import math
import pathlib
import threading
import types

import numpy as np
import torch

from hevce_tpu_torch.ops import constants as C
from hevce_tpu_torch.ops import intra, rdcost
from hevce_tpu_torch.ops import quant as qops
from hevce_tpu_torch.ops import satd as satd_ops
from hevce_tpu_torch.runtime import build as _build
from hevce_tpu_torch.utils import device as _device

SOURCE = pathlib.Path(__file__).resolve().parent.parent / "csrc" / "fused_node.cu"
LIB_NAME = "libhevce_xnode.so"

MODES = 35
BIT = 1 << 15
HALF = 1 << 14                # fixed->integer-bit rounding

# kernel launches made by the wrappers (CUDA route); utils/graphs takes a
# capture's back and adds them at every replay, as for K1
X1 = types.SimpleNamespace(LAUNCHES=0)
X2 = types.SimpleNamespace(LAUNCHES=0)
X3 = types.SimpleNamespace(LAUNCHES=0)
X4 = types.SimpleNamespace(LAUNCHES=0)

_lock = threading.Lock()
_lib = None
_LVL6 = (ctypes.c_int * 6)(*(int(v) for v in C.LEVEL_RATE_TABLE[:6]))


def _i32(x):
    return x.to(torch.int32)


# ------------------------------------------------------------- rate model

def _est_rate(q, axes):
    """coefficient-rate estimate: estimateCoeffRate summed over the block
    (<<15); at most 1024 * 1.2e6 < 2^31."""
    return _i32(qops.estimate_coeff_rate(q.abs()).sum(axes))


def _mpm_triplet(pml, pma):
    """(lanes,) neighbor pmodes -> three (lanes,) most-probable modes
    (reference MPM derivation, src/HEVCe.c:958-977)."""
    pml, pma = _i32(pml), _i32(pma)
    neq = pml != pma
    gt1 = pml > 1
    e0 = torch.where(gt1, pml, 0)
    e1 = torch.where(gt1, ((pml + 29) % 32) + 2, 1)
    e2 = torch.where(gt1, ((pml - 1) % 32) + 2, 26)
    u2 = torch.where((pml != 0) & (pma != 0), 0,
                     torch.where(pml + pma < 2, 26, 1))
    return (torch.where(neq, pml, e0), torch.where(neq, pma, e1),
            torch.where(neq, u2, e2))


def _pmode_rate(pml, pma, ctxv):
    """(lanes,) neighbor pmodes -> (lanes, 35) estimated pmode signalling
    rate (<<15): 1 context bin (per-lane price ctxv) + 1/2/5 bypass bits for
    MPM hit 0 / hits 1-2 / miss (last-match-wins, as the reference)."""
    m0, m1, m2 = _mpm_triplet(pml, pma)
    modes = torch.arange(MODES, dtype=torch.int32, device=pml.device)
    cv = ctxv[:, None]
    bits = (cv + 5 * BIT).expand(pml.shape + (MODES,))
    bits = torch.where(modes[None, :] == m0[:, None], cv + BIT, bits)
    bits = torch.where(modes[None, :] == m1[:, None], cv + 2 * BIT, bits)
    bits = torch.where(modes[None, :] == m2[:, None], cv + 2 * BIT, bits)
    return bits


def _np_group_rate(v, gmax: int):
    """H.265 last-XY coordinate code rate components (numpy): prefix
    ctx-bin COUNT and bypass suffix bits (reference put_last_xy,
    src/HEVCe.c:1046-1087); v in [0, 31]."""
    from hevce_tpu_torch.bitstream import syntax as syn
    g = syn.GROUP_INDEX[v]
    ctx = g + (g < gmax).astype(np.int32)
    byp = np.where(g > 3, (g - 2) >> 1, 0)
    return ctx, byp


@functools.lru_cache(maxsize=None)
def _scan_consts(sz: int):
    """numpy constants for the last-XY estimate, per scan type: inverse scan
    (flat pixel -> scan index), last-XY context-bin COUNT and bypass rate
    (<<15) if the last significant coefficient sits at that pixel, and the
    per-mode scan type (src/HEVCe.c:1134-1150)."""
    from hevce_tpu_torch.bitstream import syntax as syn
    nn = sz * sz
    gmax = int(syn.GROUP_INDEX[sz - 1])
    inv = np.zeros((3, nn), np.int32)
    cnt = np.zeros((3, nn), np.int32)
    byp = np.zeros((3, nn), np.int32)
    ys = (np.arange(nn) // sz).astype(np.int32)
    xs = (np.arange(nn) % sz).astype(np.int32)
    for st in range(3):
        tab = syn.scan_table(sz, st)                  # (nn, 2) of (y, x)
        inv[st, tab[:, 0] * sz + tab[:, 1]] = np.arange(nn, dtype=np.int32)
        ty, tx = (xs, ys) if st == syn.SCAN_VER else (ys, xs)
        cx, bx = _np_group_rate(tx, gmax)
        cy, by = _np_group_rate(ty, gmax)
        cnt[st] = cx + cy
        byp[st] = (bx + by) * BIT
    stm = np.zeros(MODES, np.int32)
    if sz <= 8:
        for m in range(MODES):
            if abs(m - 26) <= 4:
                stm[m] = syn.SCAN_HOR
            elif abs(m - 10) <= 4:
                stm[m] = syn.SCAN_VER
    return inv, cnt, byp, stm


@_device.cached_per_device
def _scan_tensors(sz: int, device: torch.device):
    """device tensors derived from _scan_consts: inverse scan, the packed
    (bypass rate | ctx count << 20) per-position constant, the scan-order CG
    one-hot (float32) and the per-mode scan types."""
    inv, cnt, byp, stm = _scan_consts(sz)
    nn = sz * sz
    cgm = (inv[:, :, None] >> 4) == np.arange(max(1, nn // 16))[None, None]

    def t(a, dt=torch.int32):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dt,
                               device=device)
    return (t(inv), t(byp + (cnt << 20)), t(cgm, torch.float32), t(stm))


def _lastxy_rate(sz: int, q, ctxv, sigv, stv=None):
    """(..., M, sz, sz) quant levels -> (..., M) estimated last-XY + sig-map
    rate (<<15) at per-lane context/sig-zero prices ctxv/sigv (lanes,).

    The last significant scan position is max(inv_scan * sig); the rate at
    that position is a one-hot sum against a constant packed table (ctx
    count in bits 20+, bypass rate in bits 0..19). Sizes > 4 refine per
    coefficient group: an all-zero MIDDLE group costs one sig_cg bin
    instead of 16 sig-zero charges, and every middle group pays its flag.
    Mode-dependent scan types (sz <= 8) select among three per-type results.
    All-zero blocks contribute 0. stv=None: the lane axis is all 35 modes;
    stv (..., M): per-lane scan types."""
    inv, packed, cgm, stm = _scan_tensors(sz, q.device)
    nn = sz * sz
    sig = q.reshape(q.shape[:-2] + (nn,)) != 0
    nz = sig.any(-1)
    sigi = _i32(sig)
    nnz = sigi.sum(-1, dtype=torch.int32)
    cv = ctxv.reshape(ctxv.shape + (1,) * (nz.dim() - 1))
    sv = sigv.reshape(sigv.shape + (1,) * (nz.dim() - 1))
    sts = (0, 1, 2) if sz <= 8 else (0,)
    outs = {}
    for st in sts:
        invv = inv[st]
        il = (invv * sigi).max(-1).values
        zb = il + 1 - nnz
        oh = _i32(invv == il[..., None])
        sel = (oh * packed[st]).sum(-1, dtype=torch.int32)
        rate = (sel >> 20) * cv + (sel & ((1 << 20) - 1)) + zb * sv
        if nn > 16:
            ncg = nn // 16
            # per-CG nonzero counts: float32 product, exact (counts <= 16)
            nnz_cg = _i32(torch.matmul(sigi.to(torch.float32), cgm[st]))
            cg_last = il >> 4
            cgi = torch.arange(ncg, dtype=torch.int32, device=q.device)
            mid = (cgi >= 1) & (cgi < cg_last[..., None])
            n_mid = torch.clamp(cg_last - 1, min=0)
            n_mid_zero = (mid & (nnz_cg == 0)).sum(-1, dtype=torch.int32)
            rate = rate - 16 * n_mid_zero * sv + n_mid * cv
        outs[st] = rate
    if len(outs) == 1:
        bits = outs[0]
    else:
        if stv is None:
            stv = stm
        bits = torch.where(stv == 1, outs[1],
                           torch.where(stv == 2, outs[2], outs[0]))
    return torch.where(nz, bits, 0)


# -------------------------------------------------------------- selectors

def _topk_mask(cost, K: int):
    """(..., M) int32 costs -> (..., K, M) bool top-K one-hots. The selected
    SET equals K sequential argmin rounds (ties toward lower index); row k
    enumerates that set in ascending INDEX order. Every entry strictly below
    the K-th smallest value is kept; ties at that value are admitted in index
    order up to the K-slot budget. K >= M is the identity."""
    M = cost.shape[-1]
    if K >= M:
        eye = torch.eye(M, dtype=torch.bool, device=cost.device)
        return eye.expand(cost.shape[:-1] + (M, M))
    thr = torch.sort(cost, -1).values[..., K - 1:K]    # K-th smallest value
    strict = cost < thr
    tie = cost == thr
    budget = K - strict.sum(-1, keepdim=True)          # >= 1 tie always fits
    mask = strict | (tie & (torch.cumsum(tie, -1) <= budget))
    rank = torch.cumsum(mask, -1) - 1
    ks = torch.arange(K, device=cost.device)
    return mask[..., None, :] & (rank[..., None, :] == ks[:, None])


def _sel_i32(oh, v):
    """one-hot select integer per-mode values: oh (..., K, 35) bool,
    v (35,) or (..., 35) int -> (..., K) int32 (single nonzero term)."""
    return (_i32(oh) * _i32(v)[..., None, :]).sum(-1, dtype=torch.int32)


def _compress_u8(oh, x):
    """compress the mode axis of a uint8 tensor through top-K one-hots:
    oh (B, K, 35) bool, x (B, 35, sz, sz) u8 -> (B, K, sz, sz) u8. A float32
    product, exact: one nonzero term per output, pixels <= 255."""
    B, M = x.shape[0], x.shape[1]
    nn = x.shape[-2] * x.shape[-1]
    acc = torch.matmul(oh.to(torch.float32),
                       x.reshape(B, M, nn).to(torch.float32))
    return acc.to(torch.uint8).reshape(B, oh.shape[-2], *x.shape[-2:])


def _argmin_first(x, dim):
    """(min, first index of the min) along dim — ties go to the lower index,
    as jnp.argmin's do."""
    mn = x.min(dim, keepdim=True).values
    idx = torch.arange(x.shape[dim], dtype=torch.int32, device=x.device)
    idx = idx.reshape((-1,) + (1,) * (x.dim() - 1 - (dim % x.dim())))
    first = torch.where(x == mn, idx, x.shape[dim]).min(dim).values
    return mn.squeeze(dim), _i32(first)


def _onehot_pick(x, oh, dtype):
    """(B, M, nn) values, (B, M) one-hot -> (B, nn) in `dtype` (a masked
    sum with a single nonzero term, computed in int32 and narrowed)."""
    return (_i32(x) * _i32(oh)[:, :, None]).sum(1, dtype=torch.int32) \
        .to(dtype)


# ---------------------------------------------------------- plain versions

def _sub_borders(sz, isub, ctx_top, ctx_left, flags, canvas):
    """sub-TU isub's (corner, left2, top2, flags) over the lane axis of
    `canvas` (..., M, sz, sz), in z-order (reference step 3,
    src/HEVCe.c:1455-1484): sub 0 reads the node's context, the others
    also each lane's own canvas. Flags follow the reference's sub-block
    tables (src/HEVCe.c:1376-1379)."""
    h = sz // 2
    M = canvas.shape[-3]
    bshape = canvas.shape[:-3]
    bll, blb, baa, bar = (flags[..., i] for i in range(4))
    t, f = torch.ones_like(bll), torch.zeros_like(bll)
    sub_flags = ((bll, bll, baa, baa), (t, f, baa, bar), (bll, blb, t, t),
                 (t, f, t, f))[isub]

    def bc(x):  # broadcast a shared border piece over the mode-lane axis
        return x[..., None, :].expand(x.shape[:-1] + (M,) + x.shape[-1:])

    def bc0(x):
        return x[..., None].expand(bshape + (M,))

    if isub == 0:
        corner = bc0(ctx_top[..., 0])
        left2 = bc(ctx_left[..., 0:2 * h])
        top2 = bc(ctx_top[..., 1:1 + 2 * h])
    elif isub == 1:
        corner = bc0(ctx_top[..., h])
        # left column: canvas col h-1 rows 0..2h-1 (rows >= h masked)
        left2 = canvas[..., :, 0:2 * h, h - 1]
        top2 = bc(ctx_top[..., 1 + h:1 + 3 * h])
    elif isub == 2:
        corner = bc0(ctx_left[..., h - 1])
        left2 = bc(ctx_left[..., h:3 * h])
        top2 = canvas[..., :, h - 1, 0:2 * h]
    else:
        corner = canvas[..., :, h - 1, h - 1]
        # rows/cols beyond the canvas are masked (blb=bar=0); pad by edge
        lo = canvas[..., :, h:2 * h, h - 1]
        left2 = torch.cat([lo, lo], -1)
        tp = canvas[..., :, h - 1, h:2 * h]
        top2 = torch.cat([tp, tp], -1)
    return corner, left2, top2, [bc0(x) for x in sub_flags]


def _select_pred(sz: int, S, sel_oh):
    """Per-lane selected-mode prediction: S (..., T, n) border vectors,
    sel_oh (..., T, 35) bool with exactly one True per lane. Predict all 35
    modes from each lane's own borders, then one-hot-select the lane's mode
    (masked sum with a single nonzero term — exact)."""
    p35 = intra.predict_all_modes(sz, S)              # (..., T, 35, sz, sz)
    w = sel_oh.to(torch.int32)[..., None, None]
    return (p35.to(torch.int32) * w).sum(-3).to(torch.uint8)


def predict_plain(sz, ctx_top, ctx_left, flags, modes=None, canvas=None,
                  isub=None):
    """X1's plain version (see predict)."""
    if isub is None:
        S = intra.build_borders(
            sz, ctx_top[..., 0], ctx_left, ctx_top[..., 1:],
            flags[..., 0], flags[..., 1], flags[..., 2], flags[..., 3])
        return intra.predict_all_modes(sz, S)
    h = sz // 2
    corner, left2, top2, fl = _sub_borders(sz, isub, ctx_top, ctx_left,
                                           flags, canvas)
    S = intra.build_borders(h, corner, left2, top2, *fl)
    if modes is None:
        return intra.predict_per_lane(h, S)
    sel_oh = modes[..., None] == torch.arange(MODES, device=modes.device)
    return _select_pred(h, S, sel_oh)


def preselect_plain(sz, ctx_top, ctx_left, flags, blk, pml, pma, K):
    """X2's plain version (see preselect)."""
    S = intra.build_borders(sz, ctx_top[..., 0], ctx_left, ctx_top[..., 1:],
                            flags[..., 0], flags[..., 1], flags[..., 2],
                            flags[..., 3])
    pred35 = intra.predict_all_modes(sz, S)            # (B, 35, sz, sz) u8
    resid = blk[:, None].to(torch.int16) - pred35.to(torch.int16)
    sat_d = satd_ops.block_satd(sz, resid)             # (B, 35) i32
    # forced candidates (planar, DC, the 3 MPMs) always survive: bias them
    # below any unforced SATD, preserving order among themselves
    m0, m1, m2 = _mpm_triplet(pml, pma)
    modes = torch.arange(MODES, dtype=torch.int32, device=blk.device)
    forced = ((modes[None, :] <= 1) | (modes[None, :] == m0[:, None])
              | (modes[None, :] == m1[:, None])
              | (modes[None, :] == m2[:, None]))
    ohK = _topk_mask(sat_d - (_i32(forced) << 29), K)
    return _compress_u8(ohK, pred35), _sel_i32(ohK, modes)


def rate_cost_plain(sz, qpd6, q, sse, ctxv, sigv, pml, pma, hdr_bins,
                    modes=None, split=False):
    """X3's plain version (see rate_cost)."""
    pmr = _pmode_rate(pml, pma, ctxv)                  # (B, 35)
    n = sz // 2 if split else sz
    stv = None
    if modes is not None:
        pmr = torch.gather(pmr, 1, modes.long())
        if n <= 8:
            stv = _scan_tensors(n, q.device)[3][modes.long()]
    if split:
        last = sum(_lastxy_rate(n, q[..., k, :, :], ctxv, sigv, stv=stv)
                   for k in range(4))
        est = _est_rate(q, (-1, -2, -3))
    else:
        last = _lastxy_rate(n, q, ctxv, sigv, stv=stv)
        est = _est_rate(q, (-1, -2))
    r = est + last + pmr + hdr_bins * ctxv[:, None]
    return rdcost.calc_rd_cost(qpd6, sse, (r + HALF) >> 15)


def pick_plain(cost1, q1, r1, cost2=None, q2=None, r2=None, modes1=None,
               modes2=None, pm=None, quant=None, recon=None, total=None):
    """X4's plain version (see pick): the node functions' argmin and
    one-hot picks."""
    B, M1 = cost1.shape
    nn = math.prod(q1.shape[2:])
    two = cost2 is not None
    cost, sel = _argmin_first(torch.cat([cost1, cost2], 1) if two else cost1,
                              1)
    lay = _i32(torch.where(sel < M1, 1, 2))
    if modes1 is None:
        p = torch.where(sel < M1, sel, sel - M1) if two else sel
    else:
        p = (torch.cat([modes1, modes2], 1) if two else modes1).gather(
            1, sel[:, None].long())[:, 0]
    oh1 = torch.arange(M1, dtype=torch.int32, device=sel.device)[None, :] \
        == sel[:, None]
    qw = _onehot_pick(q1.reshape(B, M1, nn), oh1, torch.int16)
    rw = _onehot_pick(r1.reshape(B, M1, nn), oh1, torch.uint8)
    if two:
        M2 = cost2.shape[1]
        oh2 = torch.arange(M2, dtype=torch.int32, device=sel.device)[
            None, :] == (sel[:, None] - M1)
        qw = qw + _onehot_pick(q2.reshape(B, M2, nn), oh2, torch.int16)
        rw = rw + _onehot_pick(r2.reshape(B, M2, nn), oh2, torch.uint8)
    rw = rw.reshape((B,) + tuple(r1.shape[2:]))
    if total is not None:
        total.copy_(torch.where(total > rdcost.I32_MAX - cost, rdcost.I32_MAX,
                                total + cost))
    return (cost, lay) + tuple(o if d is None else d.copy_(o) for d, o in
                               ((pm, p), (quant, qw), (recon, rw)))


# ------------------------------------------------------------------ kernels

def build(force: bool = False):
    """Compile csrc/fused_node.cu for sm_90a (once, or again with
    force=True; see runtime/build). Returns (library path, compiler
    output, ptxas's register and spill report included)."""
    return _build.build(SOURCE, LIB_NAME, _build.nvcc_cmd(SOURCE), force)


def _load():
    global _lib
    with _lock:
        if _lib is None:
            path, _ = build()
            lib = ctypes.CDLL(str(path))
            vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            view = [vp, i64, i64]
            lib.hevce_x1_launch.restype = i32
            lib.hevce_x1_launch.argtypes = (
                [i32] * 5 + view * 3 + [vp, vp, vp, i32, vp, vp])
            lib.hevce_x2_launch.restype = i32
            lib.hevce_x2_launch.argtypes = (
                [i32] * 3 + view * 3 + [i32, vp] + [vp, i64] * 2
                + [vp, i32, vp, vp, vp])
            lib.hevce_x3_launch.restype = i32
            lib.hevce_x3_launch.argtypes = (
                [i32] * 4 + [vp, vp] + [vp, i64] * 4
                + [vp, vp, i32, i32, i32, ctypes.POINTER(i32), vp, vp])
            lib.hevce_x4_launch.restype = i32
            lib.hevce_x4_launch.argtypes = [ctypes.POINTER(i64), i32, vp]
            _lib = lib
        return _lib


@_device.cached_per_device
def _angular_dev(sz: int, device: torch.device):
    """X1 / X2's angular table at size sz on `device`: int16 [idx1 (35, sz,
    sz) | idx2 (35, sz, sz) | frac (35, sz)], ops/intra._angular_tables in
    the table's orientation (rows of the vertical form)."""
    idx1, idx2, frac, _ = intra._angular_tables(sz)
    tab = np.concatenate([idx1.ravel(), idx2.ravel(), frac.ravel()])
    assert tab.max() < 2**15
    return torch.as_tensor(tab.astype(np.int16), device=device)


@_device.cached_per_device
def _scan_dev(sz: int, device: torch.device):
    """X3's table at block size sz on `device`: int32 [inv (3, nn) | the
    packed (bypass rate | ctx count << 20) constant by scan index (3, nn) |
    the per-mode scan types (35)]."""
    inv, cnt, byp, stm = _scan_consts(sz)
    packed = byp + (cnt << 20)
    by_scan = np.zeros_like(packed)
    for st in range(3):
        by_scan[st, inv[st]] = packed[st]
    return torch.as_tensor(np.concatenate(
        [inv.ravel(), by_scan.ravel(), stm]).astype(np.int32), device=device)


def _on_cpu(*ts):
    return all(t is None or t.device.type == "cpu" for t in ts)


def _cuda(*ts):
    """the one CUDA device of the tensors given (None skipped); raises on a
    mix or on another device type."""
    devs = {t.device for t in ts if t is not None}
    if len(devs) != 1 or next(iter(devs)).type != "cuda":
        raise ValueError(f"the fused node kernels run on one CUDA device or "
                         f"on the CPU, got {sorted(map(str, devs))}")
    return next(iter(devs))


def _rows(t, n, name):
    """t (..., n) as a (rows, n) view (a copy when the leading dims do not
    merge): (tensor, [pointer, row stride, element stride])."""
    if t.shape[-1] != n:
        raise ValueError(f"{name}: last dim {t.shape[-1]}, expected {n}")
    t = t.reshape(-1, n)
    return t, [t.data_ptr(), t.stride(0), t.stride(1)]


def _ctx(sz, ctx_top, ctx_left, flags):
    """the border context's views and type flag for a kernel: ctx_top
    (..., 1 + 2sz) and ctx_left (..., 2sz), both uint8 or both int32;
    flags (..., 4) bool."""
    if ctx_top.dtype != ctx_left.dtype or ctx_top.dtype not in (torch.uint8,
                                                                torch.int32):
        raise TypeError(f"ctx_top / ctx_left must both be uint8 or int32, "
                        f"got {ctx_top.dtype} / {ctx_left.dtype}")
    if flags.dtype != torch.bool:
        flags = flags != 0
    top, vt = _rows(ctx_top, 1 + 2 * sz, "ctx_top")
    left, vl = _rows(ctx_left, 2 * sz, "ctx_left")
    fl, vf = _rows(flags, 4, "flags")
    if not top.shape[0] == left.shape[0] == fl.shape[0]:
        raise ValueError(f"rows: ctx_top {top.shape[0]}, ctx_left "
                         f"{left.shape[0]}, flags {fl.shape[0]}")
    # the views are returned with the pointers: a reshape or a flags
    # conversion may have made a copy, which must live until the launch
    return top.shape[0], vt + vl + vf, int(ctx_top.dtype == torch.int32), \
        (top, left, fl)


def _vec(t, rows, name):
    """a (rows,) int32 vector: [pointer, stride]."""
    if t.dtype != torch.int32 or tuple(t.shape) != (rows,):
        raise ValueError(f"{name}: {t.dtype}{tuple(t.shape)}, expected "
                         f"int32 ({rows},)")
    return [t.data_ptr(), t.stride(0)]


def _launched(rc, name):
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")


def predict(sz, ctx_top, ctx_left, flags, modes=None, canvas=None,
            isub=None):
    """X1: intra prediction with its borders, over a lane axis.

    ctx_top (..., 1 + 2sz) and ctx_left (..., 2sz): the node's reconstructed
    neighbours (uint8 or int32; masked positions arbitrary), flags (..., 4)
    bool: bll / blb / baa / bar.
    isub None: the sz x sz block in all 35 modes from the shared borders
    (build_borders + predict_all_modes) -> (..., 35, sz, sz) uint8.
    isub 0-3: sub-TU isub (z-order, h = sz / 2) of the TU split, its
    borders assembled from the context and each lane's own canvas (...,
    M, sz, sz) uint8, the recon of the sub-TUs before it; lane t predicts
    with modes[..., t] (int32 (..., M)), or with mode t when modes is None
    (M = 35) -> (..., M, h, h) uint8, contiguous.
    CPU tensors run predict_plain; CUDA tensors launch X1."""
    if _on_cpu(ctx_top, ctx_left, flags, modes, canvas):
        return predict_plain(sz, ctx_top, ctx_left, flags, modes, canvas,
                             isub)
    dev = _cuda(ctx_top, ctx_left, flags, modes, canvas)
    whole = isub is None
    if sz not in ((4, 8, 16, 32) if whole else (8, 16, 32)) or \
            not (whole or 0 <= isub <= 3):
        raise ValueError(f"X1 takes sz 4-32 (a sub-TU: 8-32, isub 0-3), got "
                         f"sz={sz} isub={isub}")
    rows, views, ctx32, held = _ctx(sz, ctx_top, ctx_left, flags)
    lead = ctx_top.shape[:-1]
    n = sz if whole else sz // 2
    M = MODES if modes is None else modes.shape[-1]
    if whole:
        if modes is not None or canvas is not None:
            raise ValueError("X1 on a whole block predicts all 35 modes")
    else:
        if canvas is None or canvas.dtype != torch.uint8 or \
                tuple(canvas.shape) != tuple(lead) + (M, sz, sz) or \
                not canvas.is_contiguous():
            raise ValueError(f"X1 needs a contiguous uint8 canvas "
                             f"{tuple(lead) + (M, sz, sz)}")
        if modes is not None and (modes.dtype != torch.int32 or
                                  tuple(modes.shape) != tuple(lead) + (M,)):
            raise ValueError(f"X1 modes: {modes.dtype}{tuple(modes.shape)}")
    modes = None if modes is None else modes.contiguous()
    out = torch.empty(tuple(lead) + (M, n, n), dtype=torch.uint8, device=dev)
    if rows == 0:
        return out
    tab = _angular_dev(n, dev)
    rc = _load().hevce_x1_launch(
        sz, -1 if whole else isub, rows, M, ctx32, *views,
        None if canvas is None else canvas.data_ptr(),
        None if modes is None else modes.data_ptr(), tab.data_ptr(),
        int(C.FILTER_BORDER_Y[n][C.PMODE_PLANAR]), out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    _launched(rc, "X1")
    X1.LAUNCHES += 1
    return out


def preselect(sz, ctx_top, ctx_left, flags, blk, pml, pma, K):
    """X2: the RMD node's front half. The sz x sz block's 35 predictions
    from its borders (ctx_top (B, 1 + 2sz), ctx_left (B, 2sz), flags (B, 4),
    as predict's), the SATD of each residual against blk (B, sz, sz) uint8,
    planar, DC and the three MPMs of the neighbour modes pml / pma (B,)
    int32 forced in, and the top K by SATD. Returns (predK (B, K', sz, sz)
    uint8, modesK (B, K') int32), K' = min(K, 35): the kept modes in
    ascending order and their predictions. The kept set: every mode whose
    biased SATD is strictly below the K-th smallest, then ties at it in
    mode order (_topk_mask).
    CPU tensors run preselect_plain; CUDA tensors launch X2."""
    if _on_cpu(ctx_top, ctx_left, flags, blk, pml, pma):
        return preselect_plain(sz, ctx_top, ctx_left, flags, blk, pml, pma,
                               K)
    dev = _cuda(ctx_top, ctx_left, flags, blk, pml, pma)
    if sz not in (4, 8, 16, 32) or K < 1:
        raise ValueError(f"X2 takes sz 4-32 and K >= 1, got sz={sz} K={K}")
    rows, views, ctx32, held = _ctx(sz, ctx_top, ctx_left, flags)
    if blk.dtype != torch.uint8 or tuple(blk.shape) != (rows, sz, sz) or \
            not blk.is_contiguous():
        raise ValueError(f"X2 needs a contiguous uint8 blk ({rows}, {sz}, "
                         f"{sz}), got {blk.dtype}{tuple(blk.shape)}")
    Kc = min(K, MODES)
    predK = torch.empty((rows, Kc, sz, sz), dtype=torch.uint8, device=dev)
    modesK = torch.empty((rows, Kc), dtype=torch.int32, device=dev)
    if rows == 0:
        return predK, modesK
    rc = _load().hevce_x2_launch(
        sz, Kc, rows, *views, ctx32, blk.data_ptr(),
        *_vec(pml, rows, "pml"), *_vec(pma, rows, "pma"),
        _angular_dev(sz, dev).data_ptr(),
        int(C.FILTER_BORDER_Y[sz][C.PMODE_PLANAR]), predK.data_ptr(),
        modesK.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _launched(rc, "X2")
    X2.LAUNCHES += 1
    return predK, modesK


def rate_cost(sz, qpd6, q, sse, ctxv, sigv, pml, pma, hdr_bins, modes=None,
              split=False):
    """X3: per candidate the estimated rate (<<15) — the levels'
    estimateCoeffRate, the last-XY and significance-map estimate at the
    candidate's scan type, the pmode rate (its mode against the MPMs of
    pml / pma), hdr_bins context bins — rounded to bits, and the RD cost
    with its SSE (rdcost.calc_rd_cost, saturating).

    q (B, M, sz, sz) int16 levels (split: the TU split's four sub-TUs,
    (B, M, 4, sz/2, sz/2), their rates summed), sse (B, M) int32, ctxv /
    sigv (B,) int32 bin prices, pml / pma (B,) neighbour modes, modes
    (B, M) int32 the candidates' modes (None: lane m is mode m, M = 35).
    Returns (B, M) int32 costs.
    CPU tensors run rate_cost_plain; CUDA tensors launch X3."""
    if _on_cpu(q, sse, ctxv, sigv, pml, pma, modes):
        return rate_cost_plain(sz, qpd6, q, sse, ctxv, sigv, pml, pma,
                               hdr_bins, modes, split)
    dev = _cuda(q, sse, ctxv, sigv, pml, pma, modes)
    n = sz // 2 if split else sz
    if n not in (4, 8, 16, 32) or not 0 <= qpd6 <= 4:
        raise ValueError(f"X3 takes blocks of 4-32, qpd6 0-4, got sz={sz} "
                         f"split={split} qpd6={qpd6}")
    B, M = q.shape[:2]
    want = (B, M, 4, n, n) if split else (B, M, n, n)
    if q.dtype != torch.int16 or tuple(q.shape) != want:
        raise ValueError(f"X3 needs int16 levels {want}, got "
                         f"{q.dtype}{tuple(q.shape)}")
    if sse.dtype != torch.int32 or tuple(sse.shape) != (B, M):
        raise ValueError(f"X3 needs int32 sse ({B}, {M})")
    q, sse = q.contiguous(), sse.contiguous()
    if modes is not None and (modes.dtype != torch.int32 or
                              tuple(modes.shape) != (B, M)):
        raise ValueError(f"X3 modes: {modes.dtype}{tuple(modes.shape)}")
    if modes is None and M != MODES:
        raise ValueError(f"X3 without modes takes 35 lanes, got {M}")
    modes = None if modes is None else modes.contiguous()
    cost = torch.empty((B, M), dtype=torch.int32, device=dev)
    if B == 0:
        return cost
    rc = _load().hevce_x3_launch(
        n, 4 if split else 1, B, M, q.data_ptr(), sse.data_ptr(),
        *_vec(ctxv, B, "ctxv"), *_vec(sigv, B, "sigv"),
        *_vec(pml, B, "pml"), *_vec(pma, B, "pma"),
        None if modes is None else modes.data_ptr(),
        _scan_dev(n, dev).data_ptr(), hdr_bins,
        int(C.RDCOST_WEIGHT_DIST[qpd6]), int(C.RDCOST_WEIGHT_BITS[qpd6]),
        _LVL6, cost.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _launched(rc, "X3")
    X3.LAUNCHES += 1
    return cost


def _ivec(t, rows, n, name):
    """X4's view of int32 values (rows, n): [pointer, row stride, element
    stride]."""
    if t.dtype != torch.int32 or tuple(t.shape) != (rows, n):
        raise ValueError(f"{name}: {t.dtype}{tuple(t.shape)}, expected "
                         f"int32 ({rows}, {n})")
    return [t.data_ptr(), t.stride(0), t.stride(1)]


def _blocks(t, lead, nn, dtype, name):
    """X4's view of blocks of nn elements, t (*lead, ...): [pointer, row
    stride, candidate stride (0 without a candidate axis), block-row stride,
    element stride, block width, vec]. The block's dims merge into rows of
    its last dim as a view (a stride that does not merge raises: no copy);
    vec is 1 when every block is contiguous and 16-byte aligned."""
    if t.dtype != dtype or tuple(t.shape[:len(lead)]) != tuple(lead) or \
            math.prod(t.shape[len(lead):]) != nn:
        raise ValueError(f"{name}: {t.dtype}{tuple(t.shape)}, expected "
                         f"{dtype} {tuple(lead)} + blocks of {nn}")
    w = t.shape[-1]
    try:
        v = t.view(tuple(lead) + (-1, w))
    except RuntimeError:
        raise ValueError(f"{name}: strides {t.stride()} do not merge the "
                         f"block into rows of {w}") from None
    st = v.stride()
    size = t.element_size()
    lead_st = [s for s, d in zip(st[:len(lead)], lead) if d > 1]
    vec = int(st[-1] == 1 and (st[-2] == w or v.shape[-2] == 1)
              and t.data_ptr() % 16 == 0 and (nn * size) % 16 == 0
              and all(s * size % 16 == 0 for s in lead_st))
    ms = st[1] if len(lead) == 2 else 0
    return [t.data_ptr(), st[0], ms, st[-2], st[-1], w, vec]


def pick(cost1, q1, r1, cost2=None, q2=None, r2=None, modes1=None,
         modes2=None, pm=None, quant=None, recon=None, total=None):
    """X4: the winner of one or two candidate sets in each of B lane rows.

    A set: costs (B, M) int32, levels (B, M, ...) int16 and recon (B, M,
    ...) uint8 of nn elements a candidate (any strides whose block dims
    merge into rows, as views: a TU split's (B, T, 4, h, h) levels, a 4x4
    corner of a canvas), and optionally its mode map (B, M) int32. The
    winner is the first minimum of the sets' costs joined (ties to the
    lower index; _argmin_first's). Returns (cost (B,) int32, lay (B,)
    int32: 1 if the winner is in the first set, else 2, pm (B,) int32: its
    mode from the set's map, else its index in its set, quant (B, nn) int16
    and recon (B, *r1.shape[2:]) uint8: its levels and recon).
    pm / quant / recon given ((B,) int32, (B, nn) int16, (B, ...) uint8
    views, e.g. an NxN leaf's slots and the 4x4 of its canvas where the PU
    goes) are written in place and returned. total (B,) int32: the running
    total, in place: total > I32_MAX - cost ? I32_MAX : total + cost.
    CPU tensors run pick_plain; CUDA tensors launch X4."""
    ts = (cost1, q1, r1, cost2, q2, r2, modes1, modes2, pm, quant, recon,
          total)
    if _on_cpu(*ts):
        return pick_plain(*ts)
    dev = _cuda(*ts)
    two = cost2 is not None
    if two != (q2 is not None) or two != (r2 is not None) or \
            (modes2 is not None and not two) or \
            (two and (modes1 is None) != (modes2 is None)):
        raise ValueError("X4 takes one set, or two with a mode map for both "
                         "or neither")
    if cost1.dim() != 2:
        raise ValueError(f"X4 costs: (B, M), got {tuple(cost1.shape)}")
    B, M1 = cost1.shape
    M2 = cost2.shape[-1] if two else 0
    nn = math.prod(q1.shape[2:])
    if M1 < 1 or (two and M2 < 1):
        raise ValueError("X4 takes sets of at least one candidate")
    cost = torch.empty((B,), dtype=torch.int32, device=dev)
    lay = torch.empty((B,), dtype=torch.int32, device=dev)
    pm = torch.empty((B,), dtype=torch.int32, device=dev) if pm is None else pm
    if quant is None:
        quant = torch.empty((B, nn), dtype=torch.int16, device=dev)
    if recon is None:
        recon = torch.empty((B,) + tuple(r1.shape[2:]), dtype=torch.uint8,
                            device=dev)
    # the launch's words (csrc hevce_x4_launch): both sets' costs, mode maps,
    # levels and recons, a missing one as zeros
    sets = ((cost1, q1, r1, modes1, M1), (cost2, q2, r2, modes2, M2))
    words = [B, 1 + two, nn, M1, M2]
    for part, dtype in ((0, None), (3, None), (1, torch.int16),
                        (2, torch.uint8)):
        for k, s in enumerate(sets):
            name = f"set {k + 1}"
            if s[part] is None:
                words += [0] * (3 if dtype is None else 7)
            elif dtype is None:
                words += _ivec(s[part], B, s[4], name)
            else:
                words += _blocks(s[part], (B, s[4]), nn, dtype, name)
    words += [cost.data_ptr(), lay.data_ptr()]
    words += _vec(pm, B, "pm") + [0]
    words += [0] * 3 if total is None else _vec(total, B, "total") + [0]
    words += _blocks(quant, (B,), nn, torch.int16, "quant")
    words += _blocks(recon, (B,), nn, torch.uint8, "recon")
    if B == 0:
        return cost, lay, pm, quant, recon
    rc = _load().hevce_x4_launch((ctypes.c_longlong * len(words))(*words),
                                 len(words),
                                 torch.cuda.current_stream(dev).cuda_stream)
    _launched(rc, "X4")
    X4.LAUNCHES += 1
    return cost, lay, pm, quant, recon
