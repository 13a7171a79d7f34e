"""Wavefront fast mode: greedy RDO over anti-diagonal CTU fronts, on tensors.

The port of hevce_tpu/models/wavefront.py's lean RMD path. The reference's RD
decisions rate candidates against the live CABAC state in raster order; the
fast mode replaces that with an estimated rate model, so whole anti-diagonal
fronts of CTUs (2r + c = d: left / above / above-right / above-left all land
on earlier fronts) are searched as one batched tensor program per front. The
host then packs an exact, standard-compliant stream from the decisions
(runtime/native.pack_forest_img), which decodes bit-exactly to the recon.

Rate model (<<15 fixed point): the reference's estimateCoeffRate for the
coefficients; MPM-aware pmode bits; exact last-significant-XY group-code
length with per-lane context-bin prices (CTX_BIT) and a sig-zero charge
(SIG_ZERO) for scanned zeros before the last coefficient, refined per
coefficient group; per-layout header constants. Every 8x8 leaf searches
2Nx2N single-TU, 2Nx2N TU-split and NxN; 16x16 and 32x32 nodes compete with
their split. Nodes preselect K of the 35 modes by SATD (RMD) and search the
TU-split on the top T.

The device output of a slice is the lean record buffer: per CTU
[lay 21 | pm 21 | pm4 64] int8 in raster order, plus a 4-byte int32
position-weighted checksum tail. Decisions are integer math, so the CUDA and
CPU runs give byte-identical records (and equal the JAX package's).
"""
import collections
import functools
import os

import numpy as np
import torch

from hevce_tpu_torch.models import cu_eval
from hevce_tpu_torch.ops import constants as Cst
from hevce_tpu_torch.ops import intra, rdcost
from hevce_tpu_torch.ops import quant as qops
from hevce_tpu_torch.ops import satd as satd_ops
from hevce_tpu_torch.runtime import native
from hevce_tpu_torch.utils import device as _device
from hevce_tpu_torch.utils.tracing import PhaseTimer

CTU = 32
MODES = 35
DC = 1
BIT = 1 << 15
I32_MAX = rdcost.I32_MAX


def _env_bits(name: str, default: int) -> int:
    """Rate-model knob override in BITS (float), e.g. HEVCE_CTX_BIT=0.80.
    Read once at import, like the JAX package's."""
    v = os.environ.get(name, "").strip()
    if not v:
        return default
    try:
        bits = float(v)
    except ValueError:
        raise ValueError(f"{name} must be a float bit count, got {v!r}") \
            from None
    if not 0.0 <= bits <= 4.0:
        raise ValueError(f"{name}={bits} outside the sane [0, 4] bit range")
    return int(round(bits * BIT))


CTX_BIT = _env_bits("HEVCE_CTX_BIT", 24576)   # 0.75 bit per context bin
SIG_ZERO = _env_bits("HEVCE_SIG_ZERO", 9830)  # 0.30 bit per pre-last zero
CG_BIN = CTX_BIT              # sig_cg flag of a middle coefficient group


def _ctx_default(qpd6: int) -> int:
    """Per-qpd6 default context-bin price (0.60 bit at qpd6=1, else
    CTX_BIT); an explicit HEVCE_CTX_BIT overrides every level."""
    if os.environ.get("HEVCE_CTX_BIT", "").strip():
        return CTX_BIT
    return int(0.60 * BIT) if qpd6 == 1 else CTX_BIT


HALF = 1 << 14                # fixed->integer-bit rounding
HDR_LAY1_BINS = 6             # flag + uv + 2 uvcbf + tusplit + 1 ycbf
HDR_LAY2_BINS = 9             # flag + uv + 2 uvcbf + tusplit + 4 ycbf
HDR_NXN_BINS = 4              # part + uv + 2 uvcbf (per-PU ycbf per PU)

_SUB = ((0, 0), (0, 1), (1, 0), (1, 1))   # z-order, units of half-size


def _i32(x):
    return x.to(torch.int32)


def _argmin_first(x, dim):
    """(min, first index of the min) along dim — ties go to the lower index,
    as jnp.argmin's do."""
    mn = x.min(dim, keepdim=True).values
    idx = torch.arange(x.shape[dim], dtype=torch.int32, device=x.device)
    idx = idx.reshape((-1,) + (1,) * (x.dim() - 1 - (dim % x.dim())))
    first = torch.where(x == mn, idx, x.shape[dim]).min(dim).values
    return mn.squeeze(dim), _i32(first)


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


@functools.lru_cache(maxsize=None)
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


def _onehot_pick(x, oh, dtype):
    """(B, M, nn) values, (B, M) one-hot -> (B, nn) in `dtype` (a masked
    sum with a single nonzero term, computed in int32 and narrowed)."""
    return (_i32(x) * _i32(oh)[:, :, None]).sum(1, dtype=torch.int32) \
        .to(dtype)


# ------------------------------------------------------------------ nodes

def _sub_flags(fl):
    """z-order sub-block border existence (reference src/HEVCe.c:1376-1379);
    fl = (bll, blb, baa, bar) bool tensors."""
    bll, blb, baa, bar = fl
    t = torch.ones_like(bll)
    f = torch.zeros_like(bll)
    return ((bll, bll, baa, baa),
            (t, f, baa, bar),
            (bll, blb, t, t),
            (t, f, t, f))


def _node_ctx(A, y0: int, x0: int, sz: int):
    """Border context for a node at (y0, x0, sz) of the augmented border
    canvas A (lanes, 1+n, 1+n): A[:, 1+y, 1+x] = plane(y, x); row 0 / col 0
    hold the outside-CTU context. Positions beyond the committed interior
    hold zeros and are masked by the availability flags."""
    top = A[:, y0, x0:x0 + 1 + 2 * sz]
    left = A[:, y0 + 1:y0 + 1 + 2 * sz, x0]
    return top, left


def _pix(P, r: int, c: int):
    """one (lanes,) cell of a small per-lane map."""
    return P[:, r, c]


def _eval_node_rmd(qpd6, A, orig, fl, pml, pma, y0, x0, sz, prices,
                   K: int, T: int):
    """RMD node evaluation: preselect K of the 35 modes by SATD (+ forced
    planar/DC/MPMs), run the candidate pipeline on K modes, and search the
    TU-split layout on the top-T of those by 2Nx2N RD cost. Returns
    (cost (B,), lay (B,) in {1, 2}, pm (B,), quant (B, sz*sz) int16,
    recon (B, sz, sz) uint8)."""
    ctxv, sigv = prices
    dev = A.device
    top, left = _node_ctx(A, y0, x0, sz)
    blk = orig[:, y0:y0 + sz, x0:x0 + sz]
    S = intra.build_borders(sz, top[..., 0], left, top[..., 1:],
                            fl[..., 0], fl[..., 1], fl[..., 2], fl[..., 3])
    pred35 = intra.predict_all_modes(sz, S)            # (B, 35, sz, sz) u8
    resid = blk[:, None].to(torch.int16) - pred35.to(torch.int16)
    sat_d = satd_ops.block_satd(sz, resid)             # (B, 35) i32
    # forced candidates (planar, DC, the 3 MPMs) always survive: bias them
    # below any unforced SATD, preserving order among themselves
    m0, m1, m2 = _mpm_triplet(pml, pma)
    modes = torch.arange(MODES, dtype=torch.int32, device=dev)
    forced = ((modes[None, :] <= 1) | (modes[None, :] == m0[:, None])
              | (modes[None, :] == m1[:, None])
              | (modes[None, :] == m2[:, None]))
    ohK = _topk_mask(sat_d - (_i32(forced) << 29), K)
    predK = _compress_u8(ohK, pred35)
    qK, rK, sseK = cu_eval.pipeline_sse(sz, qpd6, predK, blk)

    pmr35 = _pmode_rate(pml, pma, ctxv)                # (B, 35)
    stm = _scan_tensors(sz, dev)[3]
    pmrK = _sel_i32(ohK, pmr35)
    lastK = _lastxy_rate(sz, qK, ctxv, sigv,
                         stv=_sel_i32(ohK, stm) if sz <= 8 else None)
    cvc = ctxv[:, None]
    r1f = _est_rate(qK, (-1, -2)) + lastK + pmrK + HDR_LAY1_BINS * cvc
    cost1 = rdcost.calc_rd_cost(qpd6, sseK, (r1f + HALF) >> 15)   # (B, K)

    # TU-split searched only on the top-T modes by 2Nx2N RD cost
    ohT_K = _topk_mask(cost1, min(T, K))               # (B, T, K)
    ohT = (ohT_K[..., :, :, None] & ohK[..., None, :, :]).any(-2)  # (B,T,35)
    q4, r4, s4 = cu_eval.eval_tusplit(sz, qpd6, top, left, fl, blk,
                                      sel_oh=ohT)
    h = sz // 2
    stmh = _scan_tensors(h, dev)[3]
    stvT = _sel_i32(ohT, stmh) if h <= 8 else None
    last3 = sum(_lastxy_rate(h, q4[..., k, :, :], ctxv, sigv, stv=stvT)
                for k in range(4))
    pmrT = _sel_i32(ohT, pmr35)
    r3f = _est_rate(q4, (-1, -2, -3)) + last3 + pmrT + HDR_LAY2_BINS * cvc
    cost3 = rdcost.calc_rd_cost(qpd6, s4, (r3f + HALF) >> 15)     # (B, T)

    Tn = cost3.shape[-1]
    costs = torch.cat([cost1, cost3], 1)               # (B, K+T)
    cost, sel = _argmin_first(costs, 1)
    lay = torch.where(sel < K, 1, 2)
    B = costs.shape[0]
    nn = sz * sz
    oh1 = torch.arange(K, dtype=torch.int32, device=dev)[None, :] \
        == sel[:, None]
    oh3 = torch.arange(Tn, dtype=torch.int32, device=dev)[None, :] \
        == (sel[:, None] - K)
    # winner mode in 35-space through the selection one-hots
    moh = torch.where((lay == 1)[:, None],
                      (oh1[..., None] & ohK).any(-2),
                      (oh3[..., None] & ohT).any(-2))  # (B, 35)
    pm = (_i32(moh) * modes[None, :]).sum(-1, dtype=torch.int32)
    quant = (_onehot_pick(qK.reshape(B, K, nn), oh1, torch.int16)
             + _onehot_pick(q4.reshape(B, Tn, nn), oh3, torch.int16))
    recon = (_onehot_pick(rK.reshape(B, K, nn), oh1, torch.uint8)
             + _onehot_pick(r4.reshape(B, Tn, nn), oh3, torch.uint8))
    return cost, _i32(lay), pm, quant, recon.reshape(B, sz, sz)


def _eval_nxn(qpd6, A, orig, fl8, pml, pma, pl_lo, pa_hi, y0, x0, prices):
    """NxN partition of one 8x8 leaf: four 4x4 PUs, each 35-mode-searched
    against the committed recon of earlier PUs (reference step 4,
    src/HEVCe.c:1491-1557), with the reference's MPM neighbor wiring
    (src/HEVCe.c:1531-1538): pl_lo / pa_hi are the map pmodes left of PU2
    and above PU1. A is not modified. Returns (cost (B,), pm4 (B, 4),
    quant (B, 64) z-order int16, recon (B, 8, 8) uint8)."""
    ctxv, sigv = prices
    f4 = _sub_flags((fl8[:, 0], fl8[:, 1], fl8[:, 2], fl8[:, 3]))
    local = A.clone()
    hdr_bits = (HDR_NXN_BINS * ctxv + HALF) >> 15
    total = rdcost.calc_rd_cost(qpd6, torch.zeros_like(_i32(pml)), hdr_bits)
    sub_pm, quants = [], []
    for isub, (dy, dx) in enumerate(_SUB):
        y, x = y0 + 4 * dy, x0 + 4 * dx
        top, left = _node_ctx(local, y, x, 4)
        blk = orig[:, y:y + 4, x:x + 4]
        q, r, s = cu_eval.eval_2nx2n(4, qpd6, top, left,
                                     torch.stack(f4[isub], -1), blk)
        if isub == 0:
            pl, pa = pml, pma
        elif isub == 1:
            pl, pa = sub_pm[0], pa_hi
        elif isub == 2:
            pl, pa = pl_lo, sub_pm[0]
        else:
            pl, pa = sub_pm[2], sub_pm[1]
        rf = (_pmode_rate(pl, pa, ctxv) + _lastxy_rate(4, q, ctxv, sigv)
              + _est_rate(q, (-1, -2)) + ctxv[:, None])  # +ctx: per-PU Y cbf
        cost = rdcost.calc_rd_cost(qpd6, s, (rf + HALF) >> 15)   # (B, 35)
        c, sel = _argmin_first(cost, 1)
        B = sel.shape[0]
        oh = torch.arange(MODES, dtype=torch.int32, device=A.device)[None, :] \
            == sel[:, None]
        qw = _onehot_pick(q.reshape(B, MODES, 16), oh, torch.int16)
        rw = _onehot_pick(r.reshape(B, MODES, 16), oh, torch.uint8)
        local[:, y + 1:y + 5, x + 1:x + 5] = rw.reshape(B, 4, 4)
        total = torch.where(total > I32_MAX - c, I32_MAX, total + c)
        sub_pm.append(sel)
        quants.append(qw)
    recon = local[:, y0 + 1:y0 + 9, x0 + 1:x0 + 9]
    return total, torch.stack(sub_pm, -1), torch.cat(quants, -1), recon


# ------------------------------------------------------------- front core

def _sat_add(a, c):
    """saturating int32 add of non-negative costs."""
    return torch.where(a > I32_MAX - c, I32_MAX, a + c)


def front_core(qpd6: int, R: int, rmd, W, PME, o_col, d: int, C: int,
               ctx_lane, sig_lane):
    """One wavefront front step for an R-row CTU grid (the lean outputs of
    hevce_tpu's _make_front_core core).

    W (B, R, 3, 32, 32) u8: the previous three committed front columns
    (W[:, :, 0] is front d-3, 1 is d-2, 2 is d-1): left = same row col d-1,
    above = row-1 col d-2, above-right = row-1 col d-1, above-left = row-1
    col d-3. PME (B, R, 8) i32: front d-1's committed right-edge pmode column
    at 4-pel granularity. o_col (B, R, 32, 32) u8: original tiles of front d.
    ctx_lane / sig_lane (B*R,) i32 per-lane bin prices.

    Returns (S_col (B, R, 32, 32) u8 committed recon, lay_col / pm_col
    (B, R, 21), pm4_col (B, R, 64), pme_col (B, R, 8)); invalid rows are
    zero. Node order in lay/pm: leaves 0..15 (quadrant*4 + leaf), quadrants
    16..19, root 20."""
    Bb = W.shape[0]
    dev = W.device
    rr = torch.arange(R, dtype=torch.int32, device=dev)
    cc = d - 2 * rr                                    # CTU col per lane
    valid = (cc >= 0) & (cc < C)                       # (R,)

    def shift_down(t):
        """tile row r -> r-1 view: out[:, r] = t[:, r-1] (row 0 zero)."""
        return torch.cat([torch.zeros_like(t[:, :1]), t[:, :-1]], 1)

    left_t = W[:, :, 2]
    above_t = shift_down(W[:, :, 1])
    abr_t = shift_down(W[:, :, 2])
    abl_t = shift_down(W[:, :, 0])

    # CTU-level border context with clamped-plane semantics
    corner = torch.where((cc > 0)[None, :], abl_t[:, :, CTU - 1, CTU - 1],
                         above_t[:, :, CTU - 1, 0])
    top_mid = above_t[:, :, CTU - 1, :]                # (B, R, 32)
    top_right = torch.where(
        (cc + 1 < C)[None, :, None], abr_t[:, :, CTU - 1, :],
        above_t[:, :, CTU - 1, CTU - 1:].expand(Bb, R, CTU))
    ctop = torch.cat([corner[:, :, None], top_mid, top_right], 2)
    lcol = left_t[:, :, :, CTU - 1]                    # (B, R, 32)
    cleft = torch.cat([lcol, lcol[:, :, CTU - 1:].expand(Bb, R, CTU)], 2)

    BR = Bb * R
    orig = o_col.reshape(BR, CTU, CTU)
    bll = (cc > 0).repeat(Bb)
    blb = torch.zeros_like(bll)
    baa = (rr > 0).repeat(Bb)
    bar = baa & (cc + 1 < C).repeat(Bb)

    # augmented border canvas: row 0 / col 0 = outside-CTU context,
    # interior filled with committed recon as the walk proceeds
    A = torch.zeros((BR, 65, 65), dtype=torch.uint8, device=dev)
    A[:, 0, :] = ctop.reshape(BR, 1 + 2 * CTU)
    A[:, 1:, 0] = cleft.reshape(BR, 2 * CTU)
    # augmented pmode map at 4-pel granularity: row 0 = DC (the reference's
    # map_pmode line buffer never scrolls across CTU rows), col 0 = the
    # left-CTU edge from the carry
    P = torch.full((BR, 9, 9), DC, dtype=torch.int32, device=dev)
    P[:, 1:, 0] = torch.where(bll[:, None], PME.reshape(BR, 8), DC)

    # parent's split_cu=1 context bin, priced sub-bit in cost units
    w_bits = int(Cst.RDCOST_WEIGHT_BITS[qpd6])
    split_bit = (w_bits * ctx_lane + HALF) >> 15
    prices = (ctx_lane, sig_lane)

    leaf_la, leaf_pm, leaf_pm4 = [], [], []
    la16s, pm16s, cost16s = [], [], []
    for qi in range(4):
        # quadrant flags: the _sub_flags rule specialized to row qi
        odd, hi = qi & 1 == 1, qi >= 2
        qbll = torch.ones_like(bll) if odd else bll
        qblb = torch.zeros_like(bll) if odd else (blb if hi else bll)
        qbaa = torch.ones_like(bll) if hi else baa
        if odd:
            qbar = torch.zeros_like(bll) if hi else bar
        else:
            qbar = torch.ones_like(bll) if hi else baa
        qf = torch.stack([qbll, qblb, qbaa, qbar], -1)
        lf = [torch.stack(t, -1) for t in _sub_flags((qbll, qblb, qbaa, qbar))]
        y16, x16 = 16 * (qi >> 1), 16 * (qi & 1)
        cy, cx = y16 // 4, x16 // 4
        WQ = A[:, y16:y16 + 33, x16:x16 + 33].clone()
        OQ = orig[:, y16:y16 + 16, x16:x16 + 16]
        PW = P[:, cy:cy + 5, cx:cx + 5].clone()

        lsum = torch.zeros((BR,), dtype=torch.int32, device=dev)
        for li, (ldy, ldx) in enumerate(_SUB):
            y8, x8 = 8 * ldy, 8 * ldx
            lcy, lcx = y8 // 4, x8 // 4
            pml_n = _pix(PW, lcy + 1, lcx)
            pma_n = _pix(PW, lcy, lcx + 1)
            c12, la12, p12, _, rc12 = _eval_node_rmd(
                qpd6, WQ, OQ, lf[li], pml_n, pma_n, y8, x8, 8, prices, *rmd)
            cN, pm4_i, _, rcN = _eval_nxn(
                qpd6, WQ, OQ, lf[li], pml_n, pma_n, _pix(PW, lcy + 2, lcx),
                _pix(PW, lcy, lcx + 2), y8, x8, prices)
            nxn = cN <= c12        # tie -> NxN (reference tries it last)
            c = torch.where(nxn, cN, c12)
            leaf_la.append(torch.where(nxn, 3, la12))
            leaf_pm.append(p12)
            leaf_pm4.append(pm4_i)
            WQ[:, y8 + 1:y8 + 9, x8 + 1:x8 + 9] = torch.where(
                nxn[:, None, None], rcN, rc12)
            PW[:, lcy + 1:lcy + 3, lcx + 1:lcx + 3] = torch.where(
                nxn[:, None, None], pm4_i.reshape(-1, 2, 2),
                p12[:, None, None])
            lsum = _sat_add(lsum, c)

        # the 16x16 alternative reads only the window's context row/col,
        # which the leaf commits never touch
        c, la, p, _, rc = _eval_node_rmd(
            qpd6, WQ, OQ, qf, _pix(PW, 1, 0), _pix(PW, 0, 1), 0, 0, 16,
            prices, *rmd)
        split_c = _sat_add(lsum, split_bit)
        own = c < split_c
        A[:, y16 + 1:y16 + 17, x16 + 1:x16 + 17] = torch.where(
            own[:, None, None], rc, WQ[:, 1:17, 1:17])
        P[:, cy + 1:cy + 5, cx + 1:cx + 5] = torch.where(
            own[:, None, None], p[:, None, None], PW[:, 1:5, 1:5])
        la16s.append(torch.where(own, la, 0))
        pm16s.append(p)
        cost16s.append(torch.where(own, c, split_c))

    fl32 = torch.stack((bll, blb, baa, bar), -1)
    c, la, p, _, rc = _eval_node_rmd(
        qpd6, A, orig, fl32, _pix(P, 1, 0), _pix(P, 0, 1), 0, 0, 32, prices,
        *rmd)
    split_cost = cost16s[0]
    for t in cost16s[1:]:
        split_cost = _sat_add(split_cost, t)
    split_cost = _sat_add(split_cost, split_bit)
    own = c < split_cost
    la32 = torch.where(own, la, 0)
    canvas = torch.where(own[:, None, None], rc, A[:, 1:33, 1:33])
    P[:, 1:, 1:] = torch.where(own[:, None, None], p[:, None, None],
                               P[:, 1:, 1:])

    lay_all = torch.stack(leaf_la + la16s + [la32], 1)          # (BR, 21)
    pm_all = torch.stack(leaf_pm + pm16s + [p], 1)
    pm4_all = torch.stack(leaf_pm4, 1).reshape(BR, 64)

    def msk(a):
        vm = valid.reshape((1, R) + (1,) * (a.dim() - 2))
        return torch.where(vm, a, torch.zeros((), dtype=a.dtype, device=dev))

    return (msk(canvas.reshape(Bb, R, CTU, CTU)),
            msk(lay_all.reshape(Bb, R, 21)), msk(pm_all.reshape(Bb, R, 21)),
            msk(pm4_all.reshape(Bb, R, 64)),
            msk(P[:, 1:9, 8].reshape(Bb, R, 8)))


# ------------------------------------------------------------ slice runner

_REC_LAY = slice(0, 21)
_REC_PM = slice(21, 42)
_REC_PM4 = slice(42, 106)
_REC_DEC = 106                    # decision-only (lean) record length


@functools.lru_cache(maxsize=None)
def _cksum_weights(n: int):
    """position-sensitive checksum weights (catch reordered corruption)."""
    return (np.arange(n, dtype=np.int32) % 8191) + 1


def _host_cksum(flat):
    """int32 wrap-around weighted checksum of a (B, n) host array."""
    w = _cksum_weights(flat.shape[-1])
    return (flat.astype(np.int32) * w).sum(axis=-1, dtype=np.int32)


def _wrap_i32(x):
    """int64 tensor -> int32 with two's-complement wrap (the JAX package
    sums the checksum in wrapping int32; torch sums integers in int64)."""
    return _i32(((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31))


def run_slice(O, cv, sv, qpd6: int, rmd):
    """Whole-slice lean runner: skew the raster input tiles into fronts, run
    the D = 2(R-1) + Cc front steps with a 3-column recon window and the
    pmode edge carry, unskew, and append the checksum tail.

    O (B, R, Cc, 32, 32) uint8 tiles; cv / sv (B,) int32 per-image context /
    sig-zero bin prices (<<15). Returns (B, R*Cc*106 + 4) int8 records."""
    B, R, Cc = O.shape[:3]
    dev = O.device
    D = 2 * (R - 1) + Cc
    ctx_lane = cv.repeat_interleave(R)  # lane b*R + r -> image b
    sig_lane = sv.repeat_interleave(R)
    # skew: Osk[b, r, d] = O[b, r, d - 2r] (zeros elsewhere)
    Osk = torch.zeros((B, R, D, CTU, CTU), dtype=torch.uint8, device=dev)
    for r in range(R):
        Osk[:, r, 2 * r:2 * r + Cc] = O[:, r]

    W = torch.zeros((B, R, 3, CTU, CTU), dtype=torch.uint8, device=dev)
    PME = torch.zeros((B, R, 8), dtype=torch.int32, device=dev)
    lay = torch.empty((D, B, R, 21), dtype=torch.int8, device=dev)
    pm = torch.empty((D, B, R, 21), dtype=torch.int8, device=dev)
    pm4 = torch.empty((D, B, R, 64), dtype=torch.int8, device=dev)
    for d in range(D):
        S_col, lay[d], pm[d], pm4[d], PME = front_core(
            qpd6, R, rmd, W, PME, Osk[:, :, d], d, Cc, ctx_lane, sig_lane)
        W = torch.cat([W[:, :, 1:], S_col[:, :, None]], 2)

    def unskew(a):                    # (D, B, R, ...) -> (B, R, Cc, ...)
        return torch.stack([a[2 * r:2 * r + Cc, :, r] for r in range(R)],
                           0).movedim(2, 0)

    n = R * Cc * _REC_DEC
    rec = torch.cat([unskew(lay), unskew(pm), unskew(pm4)], -1).reshape(B, n)
    w = torch.as_tensor(_cksum_weights(n), device=dev)
    ck = _wrap_i32((_i32(rec) * w).sum(-1, dtype=torch.int64))      # (B,)
    tail = torch.stack([(ck >> (8 * k)) & 0xFF for k in range(4)], -1)
    tail = torch.where(tail > 127, tail - 256, tail).to(torch.int8)
    return torch.cat([rec, tail], -1)


def _orig_tiles_raster(imgs, yp, xp):
    """(B, R, Cc, 32, 32) uint8 original tiles in raster CTU order,
    edge-replicated from the UNPADDED dims (reference src/HEVCe.c:1620-1622)."""
    B = len(imgs)
    ysz, xsz = imgs[0].shape
    R, Cc = yp // CTU, xp // CTU
    yy = np.clip(np.arange(yp), 0, ysz - 1)
    xx = np.clip(np.arange(xp), 0, xsz - 1)
    O = np.empty((B, R, Cc, CTU, CTU), np.uint8)
    for b, im in enumerate(imgs):
        plane = im[np.ix_(yy, xx)]
        O[b] = plane.reshape(R, CTU, Cc, CTU).transpose(0, 2, 1, 3)
    return O


# Production default for the RMD preselection (override per call via rmd=,
# or globally via HEVCE_RMD="K,T"; "off" selects the dense path, which this
# port does not carry yet).
RMD_DEFAULT = (12, 4)
_RMD_ENV = object()                    # sentinel: resolve from env/default


def _resolve_rmd(rmd):
    if rmd is _RMD_ENV:
        v = os.environ.get("HEVCE_RMD", "").strip().lower()
        if not v:
            rmd = RMD_DEFAULT
        elif v in ("off", "none", "0"):
            rmd = None
        else:
            try:
                ks, ts = v.split(",")
                k, t = int(ks), int(ts)
            except ValueError:
                raise ValueError(
                    f"HEVCE_RMD must be 'K,T' (e.g. '12,4'), 'off', or unset; "
                    f"got {v!r}") from None
            k = max(1, min(k, MODES))       # clamp K first, then T against it
            rmd = (k, max(1, min(t, k)))
    if rmd is None:
        raise NotImplementedError("the dense (rmd=None) fast mode is not "
                                  "ported yet")
    return tuple(rmd)


class _HostCopy:
    """Device->host copy of one lean record buffer, started without blocking
    (into pinned memory on CUDA); numpy() waits for it."""

    def __init__(self, out: torch.Tensor):
        if out.is_cuda:
            self.host = torch.empty(out.shape, dtype=out.dtype,
                                    pin_memory=True)
            self.host.copy_(out, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host, self.event = out, None

    def numpy(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy()


def _dispatch_batch(images, qpd6: int, rmd=_RMD_ENV, prices=None,
                    device=None):
    """Upload + run the slice for one same-shaped batch. Launches are
    queued on the current stream and the record copy to the host starts
    without blocking. Returns (out, meta); _fetch_lean reads out.
    prices: optional (ctx, sig) per-image arrays (B,) of <<15 bin prices;
    None = the constant knobs."""
    dev = _device.resolve(device)
    images = [native._clip_dims(im) for im in images]
    shape = images[0].shape
    if any(im.shape != shape for im in images):
        raise ValueError("batch must share dims")
    ysz, xsz = shape
    yp, xp = -(-ysz // CTU) * CTU, -(-xsz // CTU) * CTU
    R, Cc = yp // CTU, xp // CTU
    B = len(images)
    if prices is None:
        cv = np.full(B, _ctx_default(qpd6), np.int32)
        sv = np.full(B, SIG_ZERO, np.int32)
    else:
        cv = np.asarray(prices[0], np.int32).reshape(B)
        sv = np.asarray(prices[1], np.int32).reshape(B)
    O = torch.from_numpy(_orig_tiles_raster(images, yp, xp)).to(dev)
    with torch.no_grad():
        out = run_slice(O, torch.from_numpy(cv).to(dev),
                        torch.from_numpy(sv).to(dev), qpd6,
                        _resolve_rmd(rmd))
    return _HostCopy(out), (images, qpd6, ysz, xsz, yp, xp, R, Cc)


def _fetch_lean(out, meta, timer):
    """Wait for one batch's records on the host and verify the checksum
    tail. Returns the (B, R, Cc, 106) int8 record array."""
    images, qpd6, ysz, xsz, yp, xp, R, Cc = meta
    B = len(images)
    with timer.phase("fetch"):
        flat = out.numpy()                           # (B, n + 4) int8
    n = R * Cc * _REC_DEC
    rec = flat[:, :n]
    t = flat[:, n:].astype(np.int64) & 0xFF
    ck_dev = ((t[:, 0] | (t[:, 1] << 8) | (t[:, 2] << 16) | (t[:, 3] << 24))
              .astype(np.uint32).view(np.int32))
    got = _host_cksum(rec)
    if not np.array_equal(got, ck_dev):
        raise IOError("fast-mode record transfer checksum mismatch: "
                      f"{got} != {ck_dev}")
    return rec.reshape(B, R, Cc, _REC_DEC)


def _pack_lean(rec, meta, want_recon, timer):
    """Host pack from decision records (native.pack_forest_img recomputes
    quant levels + recon from the original images)."""
    images, qpd6 = meta[0], meta[1]
    streams, recons = [], []
    with timer.phase("pack"):
        for b in range(len(images)):
            s, r = native.pack_forest_img(
                rec[b, :, :, _REC_LAY], rec[b, :, :, _REC_PM],
                rec[b, :, :, _REC_PM4], images[b], qpd6)
            streams.append(s)
            recons.append(r if want_recon else None)
    return streams, recons


# ---------------------------------------------------------------- drivers

def encode_batch_fast(images, qpd6: int, timer=None, want_recon=True,
                      rmd=_RMD_ENV, device=None):
    """Wavefront fast mode: encode B same-shaped uint8 grayscale images.

    Returns (streams, recons). Streams are standard-compliant HEVC (exact
    CABAC pack of the chosen forest) but not bit-identical to the reference
    encoder: decisions use the estimated rate model. The recon is exactly
    what a decoder reconstructs; want_recon=False returns None recons.
    Constant bin prices (no adaptation). device=None runs on the card."""
    timer = timer if timer is not None else PhaseTimer()
    with timer.phase("dispatch"):
        out, meta = _dispatch_batch(images, qpd6, rmd, device=device)
    rec = _fetch_lean(out, meta, timer)
    return _pack_lean(rec, meta, want_recon, timer)


def adapt_mode() -> str:
    """Per-image rate-price adaptation (HEVCE_ADAPT): 'pre' (default) —
    predict prices from image gradients before encoding; '0' — off. 'post'
    (the measured two-pass) is not ported yet and raises."""
    v = os.environ.get("HEVCE_ADAPT", "pre").strip().lower()
    if v in ("1", "on", "pre", ""):
        return "pre"
    if v == "post":
        raise NotImplementedError("HEVCE_ADAPT=post is not ported yet")
    return "0"


# pre-pass predictor (calibrated on Kodak-24 @ qpd6=2 in the JAX package):
# mean |horizontal| + |vertical| pixel gradient >= 25 flags the rate-dense
# images, which get a context price scaled down by trigger / gradient.
ADAPT_GRAD_TRIGGER = 25.0
ADAPT_PRICE_AT_TRIGGER = 0.60 * BIT   # price (<<15) at the trigger
ADAPT_FLOOR = int(0.40 * BIT)         # price floor


def _grad_energy(img) -> float:
    im = img.astype(np.int32)
    return float(np.abs(np.diff(im, axis=1)).mean()
                 + np.abs(np.diff(im, axis=0)).mean())


def _predict_prices(imgs, qpd6: int):
    """per-image (ctx, sig) price arrays for one batch, or None if every
    image is below the trigger (qpd6=0 is never adapted)."""
    if qpd6 == 0:
        return None
    base = _ctx_default(qpd6)
    cv = np.full(len(imgs), base, np.int32)
    hit = False
    for k, im in enumerate(imgs):
        g = _grad_energy(im)
        if g >= ADAPT_GRAD_TRIGGER:
            ctx = int(ADAPT_PRICE_AT_TRIGGER * ADAPT_GRAD_TRIGGER / g)
            cv[k] = max(ADAPT_FLOOR, min(ctx, base))
            hit = True
    if not hit:
        return None
    return cv, np.full(len(imgs), SIG_ZERO, np.int32)


AHEAD = 4                             # batches in flight ahead of the drain


def encode_many_fast(images, qpd6: int, batch: int = 8, timer=None,
                     want_recon=True, rmd=_RMD_ENV, device=None):
    """Throughput-oriented fast-mode encode of a mixed-shape image list.

    Groups images by shape into batches of `batch` and keeps up to AHEAD
    batches dispatched ahead of the fetch+pack drain: the card runs queued
    batches while the host packs earlier ones, and each batch's record copy
    to pinned host memory starts at dispatch. Under HEVCE_ADAPT=pre (the
    default) each batch runs at prices predicted from image content.
    Returns (streams, recons) in input order; recons are None when
    want_recon=False. device=None runs on the card."""
    timer = timer if timer is not None else PhaseTimer()
    mode = adapt_mode()
    groups = {}
    for i, im in enumerate(images):
        groups.setdefault(im.shape, []).append(i)
    batches = []
    for shape in sorted(groups, key=str):
        idx = groups[shape]
        for k in range(0, len(idx), batch):
            batches.append(idx[k:k + batch])
    streams = [None] * len(images)
    recons = [None] * len(images)

    def dispatch(idx):
        batch_imgs = [images[i] for i in idx]
        pr = _predict_prices(batch_imgs, qpd6) if mode == "pre" else None
        with timer.phase("dispatch"):
            out, meta = _dispatch_batch(batch_imgs, qpd6, rmd, prices=pr,
                                        device=device)
        return out, meta, idx

    def drain_one():
        out, meta, idx = inflight.popleft()
        rec = _fetch_lean(out, meta, timer)
        s, r = _pack_lean(rec, meta, want_recon, timer)
        for j, i in enumerate(idx):
            streams[i], recons[i] = s[j], r[j]

    inflight = collections.deque()
    for idx in batches:
        if len(inflight) >= AHEAD:
            drain_one()
        inflight.append(dispatch(idx))
    while inflight:
        drain_one()
    return streams, recons


def encode_image_fast(img, qpd6: int, device=None):
    """single-image wavefront fast encode (no price adaptation); returns
    (stream bytes, recon)."""
    s, r = encode_batch_fast([img], qpd6, device=device)
    return s[0], r[0]
