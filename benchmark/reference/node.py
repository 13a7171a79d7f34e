# Frozen copy at commit 2c4bff8 of the plain versions of the port's node
# kernels: hevce_tpu_torch/ops/fused_node.py (the rate model and X1-X3's plain
# versions), hevce_tpu_torch/ops/fused_eval.py (K1's plain version) and
# hevce_tpu_torch/models/cu_eval.py (each call routed to a plain version).
# Edit only to follow a change of what the benchmark compares.
"""Candidate evaluation and the rate model, as plain PyTorch op chains.

predict_plain (X1), preselect_plain (X2), rate_cost_plain (X3) and
pipeline_sse_plain (K1) are the op chains that the port's kernels fuse;
eval_2nx2n and eval_tusplit evaluate a node's candidates with them.
"""
import functools

import numpy as np
import torch

from benchmark.reference import constants as C
from benchmark.reference import intra, rdcost
from benchmark.reference import quant as qops
from benchmark.reference import satd as satd_ops
from benchmark.reference import syntax_tables as syn
from benchmark.reference import tables as _device
from benchmark.reference import xform

MODES = 35
BIT = 1 << 15
HALF = 1 << 14                # fixed->integer-bit rounding

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


# ------------------------------------------------ K1's plain version

def pipeline_plain(sz: int, qpd6: int, pred, blk):
    """residual -> fwd transform -> RDOQ -> dequant -> inv transform -> recon.
    pred (..., M, sz, sz) u8, blk (..., sz, sz) u8 -> (q int16, recon u8)."""
    resid = blk[..., None, :, :].to(torch.int16) - pred.to(torch.int16)
    coef = xform.forward_transform(sz, resid)
    q = qops.quantize(sz, qpd6, coef)
    dq = qops.dequantize(sz, qpd6, q)
    r = xform.inverse_transform(sz, dq)
    recon = torch.clamp(r.to(torch.int32) + pred, 0, 255).to(torch.uint8)
    return q, recon


def pipeline_sse_plain(sz: int, qpd6: int, pred, blk):
    """The plain PyTorch version of K1: (q int16 (..., M, sz, sz),
    recon uint8 (..., M, sz, sz), sse int32 (..., M))."""
    q, recon = pipeline_plain(sz, qpd6, pred, blk)
    return q, recon, rdcost.block_sse(blk[..., None, :, :], recon)


# ------------------------------------------------ candidate evaluation

def pipeline_sse(sz: int, qpd6: int, pred, blk_orig):
    """pipeline_plain + per-candidate SSE (K1's plain version)."""
    return pipeline_sse_plain(
        sz, qpd6, pred.to(torch.uint8).contiguous(),
        blk_orig.to(torch.uint8).contiguous())


def eval_2nx2n(sz: int, qpd6: int, ctx_top, ctx_left, flags, blk_orig):
    """all-35-mode single-TU evaluation (reference step 2,
    src/HEVCe.c:1422-1448): prediction and the candidate pipeline."""
    pred = predict_plain(sz, ctx_top, ctx_left, flags)
    return pipeline_sse(sz, qpd6, pred, blk_orig)


def eval_tusplit(sz: int, qpd6: int, ctx_top, ctx_left, flags, blk_orig,
                 modes=None):
    """four-TU evaluation over a mode-lane axis (reference step 3,
    src/HEVCe.c:1455-1484).

    modes=None: the lane axis is all 35 modes, lane m predicting with mode
    m; the lockstep engine's node step.
    modes (..., T) int32: T preselected lanes (RMD fast mode), lane t
    predicting with mode modes[..., t].

    Sub-TU isub order is z-order; each lane chains through its own
    reconstruction canvas, which predict_plain reads for the
    next sub-TU's borders. The SSE is the sum of the four sub-TUs'."""
    h = sz // 2
    M = 35 if modes is None else modes.shape[-1]
    canvas = torch.zeros(blk_orig.shape[:-2] + (M, sz, sz),
                         dtype=torch.uint8, device=blk_orig.device)
    quants = []
    for isub, (oy, ox) in enumerate(((0, 0), (0, h), (h, 0), (h, h))):
        pred = predict_plain(sz, ctx_top, ctx_left, flags, modes,
                             canvas, isub)
        q, recon, s = pipeline_sse(h, qpd6, pred,
                                   blk_orig[..., oy:oy + h, ox:ox + h])
        quants.append(q)
        canvas[..., :, oy:oy + h, ox:ox + h] = recon
        sse = s if isub == 0 else sse + s
    return torch.stack(quants, -3), canvas, sse
