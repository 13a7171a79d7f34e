# Frozen copy at commit 2c4bff8 of the fast mode's front step in
# hevce_tpu_torch/models/wavefront.py (front_core and its node functions,
# the raster tiles and the HEVCE_ADAPT=pre price predictor), each kernel
# call routed to its plain version (node.py). The slice runner below is the
# port's _SliceRunner without its kernels' counters.
# Edit only to follow a change of what the benchmark compares.
"""The fast mode's search, in plain PyTorch: the benchmark's reference.

encode_recon(images, qpd6, rmd) works out, from the images alone, the
reconstruction that the wavefront fast mode (HEVCE_ADAPT=pre, lean records)
commits for each image: the prices predicted from the image, the greedy
RDO over anti-diagonal CTU fronts, every candidate through the plain op
chains. A stream that the program packs for an image decodes to exactly
this reconstruction. On CUDA each shape's front step is captured once as a
CUDA graph and replayed per front; on the CPU it runs eagerly.
"""
import contextlib

import numpy as np
import torch

from benchmark.reference import constants as Cst
from benchmark.reference import node, rdcost, xform
from benchmark.reference.node import (BIT, HALF, MODES, _i32, _sel_i32,
                                      _topk_mask)

CTU = 32
DC = 1
I32_MAX = rdcost.I32_MAX


CTX_BIT = 24576               # 0.75 bit per context bin
SIG_ZERO = 9830               # 0.30 bit per pre-last zero
CG_BIN = CTX_BIT              # sig_cg flag of a middle coefficient group


def _ctx_default(qpd6: int) -> int:
    """Per-qpd6 default context-bin price (0.60 bit at qpd6=1, else
    CTX_BIT)."""
    return int(0.60 * BIT) if qpd6 == 1 else CTX_BIT


HDR_LAY1_BINS = 6             # flag + uv + 2 uvcbf + tusplit + 1 ycbf
HDR_LAY2_BINS = 9             # flag + uv + 2 uvcbf + tusplit + 4 ycbf
HDR_NXN_BINS = 4              # part + uv + 2 uvcbf (per-PU ycbf per PU)

_SUB = ((0, 0), (0, 1), (1, 0), (1, 1))   # z-order, units of half-size


def _argmin_first(x, dim):
    """(min, first index of the min) along dim — ties go to the lower index,
    as jnp.argmin's do."""
    mn = x.min(dim, keepdim=True).values
    idx = torch.arange(x.shape[dim], dtype=torch.int32, device=x.device)
    idx = idx.reshape((-1,) + (1,) * (x.dim() - 1 - (dim % x.dim())))
    first = torch.where(x == mn, idx, x.shape[dim]).min(dim).values
    return mn.squeeze(dim), _i32(first)


# ------------------------------------------------------------- selectors

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


def _eval_node(qpd6, A, orig, fl, pml, pma, y0, x0, sz, prices,
               return_sub0=False):
    """Dense node evaluation: both 2Nx2N TU layouts x all 35 modes. Returns
    (cost (B,), lay (B,) in {1, 2}, pm (B,), quant (B, sz*sz) int16,
    recon (B, sz, sz) uint8). return_sub0=True also returns the TU-split's
    first sub-TU eval (quant, recon, sse over the 35 modes): it is exactly
    the NxN partition's PU0 eval (same borders, flags and modes), which
    _eval_nxn then does not repeat."""
    ctxv, sigv = prices
    dev = A.device
    top, left = _node_ctx(A, y0, x0, sz)
    blk = orig[:, y0:y0 + sz, x0:x0 + sz]
    q1, r1, s1 = node.eval_2nx2n(sz, qpd6, top, left, fl, blk)
    q4, r4, s4 = node.eval_tusplit(sz, qpd6, top, left, fl, blk)

    h = sz // 2
    cost1 = node.rate_cost_plain(sz, qpd6, q1, s1, ctxv, sigv, pml, pma,
                                 HDR_LAY1_BINS)                 # (B, 35)
    cost3 = node.rate_cost_plain(sz, qpd6, q4, s4, ctxv, sigv, pml, pma,
                                 HDR_LAY2_BINS, split=True)
    cost, sel = _argmin_first(torch.cat([cost1, cost3], 1), 1)
    lay = torch.where(sel < MODES, 1, 2)
    pm = torch.where(sel < MODES, sel, sel - MODES)

    B = sel.shape[0]
    nn = sz * sz
    modes = torch.arange(MODES, dtype=torch.int32, device=dev)
    oh1 = modes[None, :] == sel[:, None]
    oh3 = modes[None, :] == (sel[:, None] - MODES)
    quant = (_onehot_pick(q1.reshape(B, MODES, nn), oh1, torch.int16)
             + _onehot_pick(q4.reshape(B, MODES, nn), oh3, torch.int16))
    recon = (_onehot_pick(r1.reshape(B, MODES, nn), oh1, torch.uint8)
             + _onehot_pick(r4.reshape(B, MODES, nn), oh3, torch.uint8))
    out = cost, _i32(lay), pm, quant, recon.reshape(B, sz, sz)
    if not return_sub0:
        return out
    r0 = r4[..., 0:h, 0:h]
    return out, (q4[..., 0, :, :], r0,
                 rdcost.block_sse(blk[:, None, 0:h, 0:h], r0))


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
    blk = orig[:, y0:y0 + sz, x0:x0 + sz].contiguous()
    # the K kept modes (ascending) and their predictions (X2 on the card)
    predK, modesK = node.preselect_plain(sz, top, left, fl, blk, pml, pma, K)
    qK, rK, sseK = node.pipeline_sse(sz, qpd6, predK, blk)
    cost1 = node.rate_cost_plain(sz, qpd6, qK, sseK, ctxv, sigv, pml, pma,
                                 HDR_LAY1_BINS, modesK)         # (B, K)

    # TU-split searched only on the top-T modes by 2Nx2N RD cost
    modesT = _sel_i32(_topk_mask(cost1, min(T, K)), modesK)     # (B, T)
    q4, r4, s4 = node.eval_tusplit(sz, qpd6, top, left, fl, blk,
                                      modes=modesT)
    cost3 = node.rate_cost_plain(sz, qpd6, q4, s4, ctxv, sigv, pml, pma,
                                 HDR_LAY2_BINS, modesT, split=True)

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
    pm = torch.cat([modesK, modesT], 1).gather(1, sel[:, None].long())[:, 0]
    quant = (_onehot_pick(qK.reshape(B, K, nn), oh1, torch.int16)
             + _onehot_pick(q4.reshape(B, Tn, nn), oh3, torch.int16))
    recon = (_onehot_pick(rK.reshape(B, K, nn), oh1, torch.uint8)
             + _onehot_pick(r4.reshape(B, Tn, nn), oh3, torch.uint8))
    return cost, _i32(lay), pm, quant, recon.reshape(B, sz, sz)


def _eval_nxn(qpd6, A, orig, fl8, pml, pma, pl_lo, pa_hi, y0, x0, prices,
              sub0=None):
    """NxN partition of one 8x8 leaf: four 4x4 PUs, each 35-mode-searched
    against the committed recon of earlier PUs (reference step 4,
    src/HEVCe.c:1491-1557), with the reference's MPM neighbor wiring
    (src/HEVCe.c:1531-1538): pl_lo / pa_hi are the map pmodes left of PU2
    and above PU1. sub0: PU0's eval when the caller has it (the dense
    TU-split's sub0, _eval_node(return_sub0=True)); None evaluates it here.
    A is not modified. Returns (cost (B,), pm4 (B, 4), quant (B, 64) z-order
    int16, recon (B, 8, 8) uint8)."""
    ctxv, sigv = prices
    f4 = _sub_flags((fl8[:, 0], fl8[:, 1], fl8[:, 2], fl8[:, 3]))
    local = A.clone()
    hdr_bits = (HDR_NXN_BINS * ctxv + HALF) >> 15
    total = rdcost.calc_rd_cost(qpd6, torch.zeros_like(_i32(pml)), hdr_bits)
    sub_pm, quants = [], []
    for isub, (dy, dx) in enumerate(_SUB):
        y, x = y0 + 4 * dy, x0 + 4 * dx
        if isub == 0 and sub0 is not None:
            q, r, s = sub0
        else:
            top, left = _node_ctx(local, y, x, 4)
            blk = orig[:, y:y + 4, x:x + 4]
            q, r, s = node.eval_2nx2n(4, qpd6, top, left,
                                         torch.stack(f4[isub], -1), blk)
        if isub == 0:
            pl, pa = pml, pma
        elif isub == 1:
            pl, pa = sub_pm[0], pa_hi
        elif isub == 2:
            pl, pa = pl_lo, sub_pm[0]
        else:
            pl, pa = sub_pm[2], sub_pm[1]
        # one header bin: the PU's Y cbf
        cost = node.rate_cost_plain(4, qpd6, q, s, ctxv, sigv, pl, pa, 1)
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
               ctx_lane, sig_lane, want_qc=False):
    """One wavefront front step for an R-row CTU grid (hevce_tpu's
    _make_front_core core). rmd=(K, T) evaluates every node on K
    SATD-preselected modes (_eval_node_rmd); rmd=None densely on all 35
    (_eval_node), with each leaf's NxN PU0 taken from its TU-split sub0.

    W (B, R, 3, 32, 32) u8: the previous three committed front columns
    (W[:, :, 0] is front d-3, 1 is d-2, 2 is d-1): left = same row col d-1,
    above = row-1 col d-2, above-right = row-1 col d-1, above-left = row-1
    col d-3. PME (B, R, 8) i32: front d-1's committed right-edge pmode column
    at 4-pel granularity. o_col (B, R, 32, 32) u8: original tiles of front d.
    ctx_lane / sig_lane (B*R,) i32 per-lane bin prices.

    Returns (S_col (B, R, 32, 32) u8 committed recon, lay_col / pm_col
    (B, R, 21), pm4_col (B, R, 64), pme_col (B, R, 8)); invalid rows are
    zero. Node order in lay/pm: leaves 0..15 (quadrant*4 + leaf), quadrants
    16..19, root 20. want_qc=True appends qc_col (B, R, 1024) int16, the
    chosen forest's quant leaves composed in z-order (the full records);
    the lean path builds none of it."""
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

    def node(A_, O_, fl, pml, pma, y, x, sz, sub0=False):
        """one node's eval; sub0=True also returns the dense TU-split's
        sub0 for the NxN PU0 (None on the RMD path, where it does not span
        all 35 modes)."""
        if rmd is None:
            return _eval_node(qpd6, A_, O_, fl, pml, pma, y, x, sz, prices,
                              return_sub0=sub0)
        out = _eval_node_rmd(qpd6, A_, O_, fl, pml, pma, y, x, sz, prices,
                             *rmd)
        return (out, None) if sub0 else out

    leaf_la, leaf_pm, leaf_pm4, leaf_qb = [], [], [], []
    la16s, pm16s, cost16s, q16s = [], [], [], []
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
            (c12, la12, p12, qb12, rc12), sub0 = node(
                WQ, OQ, lf[li], pml_n, pma_n, y8, x8, 8, sub0=True)
            cN, pm4_i, qbN, rcN = _eval_nxn(
                qpd6, WQ, OQ, lf[li], pml_n, pma_n, _pix(PW, lcy + 2, lcx),
                _pix(PW, lcy, lcx + 2), y8, x8, prices, sub0=sub0)
            nxn = cN <= c12        # tie -> NxN (reference tries it last)
            c = torch.where(nxn, cN, c12)
            leaf_la.append(torch.where(nxn, 3, la12))
            leaf_pm.append(p12)
            leaf_pm4.append(pm4_i)
            if want_qc:
                leaf_qb.append(torch.where(nxn[:, None], qbN, qb12))
            WQ[:, y8 + 1:y8 + 9, x8 + 1:x8 + 9] = torch.where(
                nxn[:, None, None], rcN, rc12)
            PW[:, lcy + 1:lcy + 3, lcx + 1:lcx + 3] = torch.where(
                nxn[:, None, None], pm4_i.reshape(-1, 2, 2),
                p12[:, None, None])
            lsum = _sat_add(lsum, c)

        # the 16x16 alternative reads only the window's context row/col,
        # which the leaf commits never touch
        c, la, p, qb, rc = node(WQ, OQ, qf, _pix(PW, 1, 0), _pix(PW, 0, 1),
                                0, 0, 16)
        split_c = _sat_add(lsum, split_bit)
        own = c < split_c
        A[:, y16 + 1:y16 + 17, x16 + 1:x16 + 17] = torch.where(
            own[:, None, None], rc, WQ[:, 1:17, 1:17])
        P[:, cy + 1:cy + 5, cx + 1:cx + 5] = torch.where(
            own[:, None, None], p[:, None, None], PW[:, 1:5, 1:5])
        la16s.append(torch.where(own, la, 0))
        pm16s.append(p)
        cost16s.append(torch.where(own, c, split_c))
        q16s.append(qb)

    fl32 = torch.stack((bll, blb, baa, bar), -1)
    c, la, p, qb, rc = node(A, orig, fl32, _pix(P, 1, 0), _pix(P, 0, 1),
                            0, 0, 32)
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

    cols = (msk(canvas.reshape(Bb, R, CTU, CTU)),
            msk(lay_all.reshape(Bb, R, 21)), msk(pm_all.reshape(Bb, R, 21)),
            msk(pm4_all.reshape(Bb, R, 64)),
            msk(P[:, 1:9, 8].reshape(Bb, R, 8)))
    if not want_qc:
        return cols
    # the chosen forest's quant leaves in the z-order the host pack reads
    # (csrc PackRec): the leaves partition the CTU, a 16x16 or the 32x32
    # node that owns its area replaces them
    q8cat = torch.stack(leaf_qb, 1).reshape(BR, 4, 256)
    own16 = torch.stack(la16s, 1) != 0                          # (BR, 4)
    qc = torch.where(own16[:, :, None], torch.stack(q16s, 1), q8cat)
    qc = torch.where((la32 != 0)[:, None], qb, qc.reshape(BR, 1024))
    return cols + (msk(qc.reshape(Bb, R, 1024)),)


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


# ------------------------------------------------------------ slice runner

class PlainRunner:
    """One slice shape's front step over static buffers (the port's
    _SliceRunner, lean records): the skewed original tiles Osk, the carry
    W / PME, the per-lane prices, the front index d as a tensor and the
    committed recon columns S (D, B, R, 32, 32). step() is one front_core
    call at front d. On CUDA the step is captured once as a CUDA graph
    (after an eager warm-up step on a side stream) and every front replays
    it; on the CPU it runs eagerly."""

    def __init__(self, qpd6: int, R: int, Cc: int, B: int, rmd,
                 device: torch.device):
        self.qpd6, self.R, self.Cc, self.B, self.rmd = qpd6, R, Cc, B, rmd
        self.D = D = 2 * (R - 1) + Cc

        def z(shape, dtype):
            return torch.zeros(shape, dtype=dtype, device=device)
        self.Osk = z((B, R, D, CTU, CTU), torch.uint8)
        self.W = z((B, R, 3, CTU, CTU), torch.uint8)
        self.PME = z((B, R, 8), torch.int32)
        self.ctx_lane = z((B * R,), torch.int32)
        self.sig_lane = z((B * R,), torch.int32)
        self.d = z((), torch.int32)
        self.S = z((D, B, R, CTU, CTU), torch.uint8)
        self.graph = None
        if device.type == "cuda":
            stream = torch.cuda.Stream(device)
            stream.wait_stream(torch.cuda.current_stream(device))
            with torch.no_grad(), torch.cuda.stream(stream):
                self.step()
            stream.synchronize()
            self.graph = torch.cuda.CUDAGraph()
            with torch.no_grad(), torch.cuda.graph(self.graph, stream=stream):
                self.step()

    def step(self):
        """front step d, in place."""
        di = self.d.to(torch.int64).reshape(1)
        o_col = self.Osk.index_select(2, di).squeeze(2)
        out = front_core(self.qpd6, self.R, self.rmd, self.W, self.PME,
                         o_col, self.d, self.Cc, self.ctx_lane,
                         self.sig_lane)
        S_col, pme_col = out[0], out[4]
        self.S.index_copy_(0, di, S_col[None])
        self.W.copy_(torch.cat([self.W[:, :, 1:], S_col[:, :, None]], 2))
        self.PME.copy_(pme_col)

    def __call__(self, O, cv, sv):
        """(B, R*32, Cc*32) uint8 recon planes of one batch: O (B, R, Cc,
        32, 32) u8 raster tiles, cv / sv (B,) int32 prices."""
        for r in range(self.R):
            self.Osk[:, r, 2 * r:2 * r + self.Cc].copy_(O[:, r])
        self.ctx_lane.copy_(cv.repeat_interleave(self.R))
        self.sig_lane.copy_(sv.repeat_interleave(self.R))
        self.W.zero_()
        self.PME.zero_()
        with torch.no_grad():
            for d in range(self.D):
                self.d.fill_(d)
                if self.graph is None:
                    self.step()
                else:
                    self.graph.replay()
        B, R, Cc = self.B, self.R, self.Cc
        cols = torch.stack([self.S[2 * r:2 * r + Cc, :, r] for r in range(R)],
                           0).movedim(2, 0)          # (B, R, Cc, 32, 32)
        return cols.permute(0, 1, 3, 2, 4).reshape(B, R * CTU, Cc * CTU)


@contextlib.contextmanager
def transform_dtype(dtype):
    """run the transform products in `dtype` (float64 is exact; the
    lower-precision controls run int16 or bfloat16) inside the block."""
    old = xform.DTYPE
    xform.DTYPE = dtype
    try:
        yield
    finally:
        xform.DTYPE = old


def encode_recon(images, qpd6: int, rmd, device):
    """the fast mode's reconstruction of each image (HEVCE_ADAPT=pre),
    worked out from the images: a list of (yp, xp) uint8 arrays, the image
    planes padded up to whole CTUs. Images of one shape run as one batch;
    rmd (K, T) or None (dense)."""
    dev = torch.device(device)
    out = [None] * len(images)
    groups = {}
    for i, im in enumerate(images):
        groups.setdefault(im.shape, []).append(i)
    for (ysz, xsz), idx in groups.items():
        imgs = [np.ascontiguousarray(images[i], np.uint8) for i in idx]
        yp, xp = -(-ysz // CTU) * CTU, -(-xsz // CTU) * CTU
        pr = _predict_prices(imgs, qpd6)
        B = len(imgs)
        if pr is None:
            pr = (np.full(B, _ctx_default(qpd6), np.int32),
                  np.full(B, SIG_ZERO, np.int32))
        runner = PlainRunner(qpd6, yp // CTU, xp // CTU, B,
                             None if rmd is None else tuple(rmd), dev)
        O = torch.from_numpy(_orig_tiles_raster(imgs, yp, xp)).to(dev)
        planes = runner(O, torch.from_numpy(pr[0]).to(dev),
                        torch.from_numpy(pr[1]).to(dev)).cpu().numpy()
        del runner
        for j, i in enumerate(idx):
            out[i] = planes[j]
    return out
