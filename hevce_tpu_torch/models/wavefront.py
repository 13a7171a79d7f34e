"""Wavefront fast mode: greedy RDO over anti-diagonal CTU fronts, on tensors.

The port of hevce_tpu/models/wavefront.py. The reference's RD
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
their split. Nodes preselect K of the 35 modes by SATD (RMD, the default)
and search the TU-split on the top T, or (rmd=None) search all 35 modes in
both TU layouts. Every node and NxN PU takes its winner with one X4 pick
(ops/fused_node.pick).

A slice runs through its shape's runner (_slice_runner_cache, the JAX
package's one compiled program per slice): on CUDA the front step is
captured once as a CUDA graph and replayed for every front.

The device output of a slice is the lean record buffer: per CTU
[lay 21 | pm 21 | pm4 64] int8 in raster order, plus a 4-byte int32
position-weighted checksum tail. fetch_qc=True ships the full records
instead: [lay | pm | pm4 | qc8 1024] per CTU, an int16 sideband for the
images whose levels escape int8, the device recon and their checksums.
Decisions are integer math, so the CUDA and CPU runs give byte-identical
records (and equal the JAX package's). With a mesh (parallel/batch) a
batch's slice runs once per mesh device on its part of the images: fronts
have no dependency across images, so the streams do not change.
"""
import collections
import concurrent.futures
import functools
import itertools
import os
import queue
import threading

import numpy as np
import torch

from hevce_tpu_torch.models import cu_eval
from hevce_tpu_torch.ops import constants as Cst
from hevce_tpu_torch.ops import fused_node, rdcost
# the rate model's units and the selectors the node functions still run
# (the rest of the rate model lives beside the kernels that fuse it, X2, X3,
# and the picks beside X4)
from hevce_tpu_torch.ops.fused_node import (BIT, HALF, MODES, _i32, _sel_i32,
                                            _topk_mask)
from hevce_tpu_torch.parallel import batch as pb
from hevce_tpu_torch.runtime import native
from hevce_tpu_torch.utils import device as _device
from hevce_tpu_torch.utils import graphs
from hevce_tpu_torch.utils.tracing import CARD, PhaseTimer

CTU = 32
DC = 1
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


HDR_LAY1_BINS = 6             # flag + uv + 2 uvcbf + tusplit + 1 ycbf
HDR_LAY2_BINS = 9             # flag + uv + 2 uvcbf + tusplit + 4 ycbf
HDR_NXN_BINS = 4              # part + uv + 2 uvcbf (per-PU ycbf per PU)

_SUB = ((0, 0), (0, 1), (1, 0), (1, 1))   # z-order, units of half-size


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
    top, left = _node_ctx(A, y0, x0, sz)
    blk = orig[:, y0:y0 + sz, x0:x0 + sz]
    q1, r1, s1 = cu_eval.eval_2nx2n(sz, qpd6, top, left, fl, blk)
    q4, r4, s4 = cu_eval.eval_tusplit(sz, qpd6, top, left, fl, blk)

    h = sz // 2
    cost1 = fused_node.rate_cost(sz, qpd6, q1, s1, ctxv, sigv, pml, pma,
                                 HDR_LAY1_BINS)                 # (B, 35)
    cost3 = fused_node.rate_cost(sz, qpd6, q4, s4, ctxv, sigv, pml, pma,
                                 HDR_LAY2_BINS, split=True)
    # pm: the winner's index in its layout's 35
    out = fused_node.pick(cost1, q1, r1, cost3, q4, r4)
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
    top, left = _node_ctx(A, y0, x0, sz)
    blk = orig[:, y0:y0 + sz, x0:x0 + sz].contiguous()
    # the K kept modes (ascending) and their predictions (X2 on the card)
    predK, modesK = fused_node.preselect(sz, top, left, fl, blk, pml, pma,
                                         K)
    qK, rK, sseK = cu_eval.pipeline_sse(sz, qpd6, predK, blk)
    cost1 = fused_node.rate_cost(sz, qpd6, qK, sseK, ctxv, sigv, pml, pma,
                                 HDR_LAY1_BINS, modesK)         # (B, K)

    # TU-split searched only on the top-T modes by 2Nx2N RD cost
    modesT = _sel_i32(_topk_mask(cost1, min(T, K)), modesK)     # (B, T)
    q4, r4, s4 = cu_eval.eval_tusplit(sz, qpd6, top, left, fl, blk,
                                      modes=modesT)
    cost3 = fused_node.rate_cost(sz, qpd6, q4, s4, ctxv, sigv, pml, pma,
                                 HDR_LAY2_BINS, modesT, split=True)
    return fused_node.pick(cost1, qK, rK, cost3, q4, r4, modesK, modesT)


def _eval_nxn(qpd6, A, orig, fl8, pml, pma, pl_lo, pa_hi, y0, x0, prices,
              sub0=None):
    """NxN partition of one 8x8 leaf: four 4x4 PUs, each 35-mode-searched
    against the committed recon of earlier PUs (reference step 4,
    src/HEVCe.c:1491-1557), with the reference's MPM neighbor wiring
    (src/HEVCe.c:1531-1538): pl_lo / pa_hi are the map pmodes left of PU2
    and above PU1. sub0: PU0's eval when the caller has it (the dense
    TU-split's sub0, _eval_node(return_sub0=True)); None evaluates it here.
    A is not modified. Returns (cost (B,), pm4 (B, 4), quant (B, 64) z-order
    int16, recon (B, 8, 8) uint8). Each PU's X4 pick writes its mode and
    levels into their slots of pm4 and quant, its recon into the leaf's
    canvas and its cost into the running total."""
    ctxv, sigv = prices
    f4 = _sub_flags((fl8[:, 0], fl8[:, 1], fl8[:, 2], fl8[:, 3]))
    local = A.clone()
    hdr_bits = (HDR_NXN_BINS * ctxv + HALF) >> 15
    total = rdcost.calc_rd_cost(qpd6, torch.zeros_like(_i32(pml)), hdr_bits)
    B = pml.shape[0]
    pm4 = torch.empty((B, 4), dtype=torch.int32, device=A.device)
    quant = torch.empty((B, 64), dtype=torch.int16, device=A.device)
    for isub, (dy, dx) in enumerate(_SUB):
        y, x = y0 + 4 * dy, x0 + 4 * dx
        if isub == 0 and sub0 is not None:
            q, r, s = sub0
        else:
            top, left = _node_ctx(local, y, x, 4)
            blk = orig[:, y:y + 4, x:x + 4]
            q, r, s = cu_eval.eval_2nx2n(4, qpd6, top, left,
                                         torch.stack(f4[isub], -1), blk)
        if isub == 0:
            pl, pa = pml, pma
        elif isub == 1:
            pl, pa = pm4[:, 0], pa_hi
        elif isub == 2:
            pl, pa = pl_lo, pm4[:, 0]
        else:
            pl, pa = pm4[:, 2], pm4[:, 1]
        # one header bin: the PU's Y cbf
        cost = fused_node.rate_cost(4, qpd6, q, s, ctxv, sigv, pl, pa, 1)
        fused_node.pick(cost, q, r, pm=pm4[:, isub],
                        quant=quant[:, 16 * isub:16 * isub + 16],
                        recon=local[:, y + 1:y + 5, x + 1:x + 5], total=total)
    recon = local[:, y0 + 1:y0 + 9, x0 + 1:x0 + 9]
    return total, pm4, quant, recon


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


# ------------------------------------------------------------ slice runner

_REC_LAY = slice(0, 21)
_REC_PM = slice(21, 42)
_REC_PM4 = slice(42, 106)
_REC_QC8 = slice(106, 1130)
_REC_DEC = 106                    # decision-only (lean) record length
_REC_LEN = 1130                   # full record: decisions + int8 quant


@functools.lru_cache(maxsize=None)
def _cksum_weights(n: int):
    """position-sensitive checksum weights (catch reordered corruption)."""
    return (np.arange(n, dtype=np.int32) % 8191) + 1


def _host_cksum(flat):
    """int32 wrap-around weighted checksum of a (B, n) host array (signed
    types sign-extend, uint8 zero-extends, as on the device)."""
    w = _cksum_weights(flat.shape[-1])
    return (flat.astype(np.int32) * w).sum(axis=-1, dtype=np.int32)


def _wrap_i32(x):
    """int64 tensor -> int32 with two's-complement wrap (the JAX package
    sums the checksum in wrapping int32; torch sums integers in int64)."""
    return _i32(((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31))


@_device.cached_per_device
def _dev_cksum_weights(n: int, device: torch.device):
    """_cksum_weights(n) on `device`, uploaded once."""
    return torch.as_tensor(_cksum_weights(n), device=device)


def _dev_cksum(flat):
    """_host_cksum of a (B, n) integer tensor, on its device: (B,) int32."""
    w = _dev_cksum_weights(flat.shape[-1], flat.device)
    return _wrap_i32((_i32(flat) * w).sum(-1, dtype=torch.int64))


class _SliceRunner:
    """One slice shape's runner (hevce_tpu's _slice_runner_cache entry):
    static device buffers and the front step that reads and writes them.

    Buffers: the skewed original tiles Osk (B, R, D, 32, 32) u8, the carry
    (W, the last three committed front columns, and PME, the pmode edge),
    the per-lane bin prices, the front index d (a 0-dim int32 tensor) and
    the per-front record columns lay / pm / pm4 (D, B, R, n) int8, plus
    qc16 (D, B, R, 1024) int16 for full records and S (D, B, R, 32, 32) u8
    for the recon. step() is one front_core call at front d: it reads its
    original column from Osk by the tensor d, writes its record columns at
    index d and shifts W and PME in place, so it takes no value from the
    host. capture() records it once as a CUDA graph; front(d) then sets d
    and replays it. A call loads a batch, runs the D fronts and returns
    fresh tensors from tail(): nothing returned is a view of a buffer that
    the next call overwrites. On the CPU the same step runs eagerly."""

    def __init__(self, qpd6: int, R: int, Cc: int, B: int, rmd,
                 fetch_qc: bool, want_recon: bool, device: torch.device):
        self.qpd6, self.R, self.Cc, self.B, self.rmd = qpd6, R, Cc, B, rmd
        self.fetch_qc, self.want_recon = fetch_qc, want_recon
        self.device = device
        self.D = D = 2 * (R - 1) + Cc

        def z(shape, dtype):
            return torch.zeros(shape, dtype=dtype, device=device)
        self.Osk = z((B, R, D, CTU, CTU), torch.uint8)
        self.W = z((B, R, 3, CTU, CTU), torch.uint8)
        self.PME = z((B, R, 8), torch.int32)
        self.ctx_lane = z((B * R,), torch.int32)
        self.sig_lane = z((B * R,), torch.int32)
        self.d = z((), torch.int32)
        self.cols = [z((D, B, R, 21), torch.int8), z((D, B, R, 21), torch.int8),
                     z((D, B, R, 64), torch.int8)]       # lay, pm, pm4
        if fetch_qc:
            self.cols.append(z((D, B, R, 1024), torch.int16))
        self.S = z((D, B, R, CTU, CTU), torch.uint8) if want_recon else None
        self.run = self.step          # capture() replaces it by its replay
        self.graph = None
        self.launches = {}
        self.stats = {}

    def load(self, O, cv, sv):
        """a batch in: skew O (B, R, Cc, 32, 32) u8 into Osk (Osk[b, r,
        2r + c] = O[b, r, c]; the rest stays zero), the per-image prices cv /
        sv (B,) int32 into the lanes (lane b*R + r -> image b), and reset
        the carry."""
        for r in range(self.R):
            self.Osk[:, r, 2 * r:2 * r + self.Cc].copy_(O[:, r])
        self.ctx_lane.copy_(cv.repeat_interleave(self.R))
        self.sig_lane.copy_(sv.repeat_interleave(self.R))
        self.W.zero_()
        self.PME.zero_()

    def step(self):
        """front step d, in place (the body of hevce_tpu's lax.scan)."""
        di = self.d.to(torch.int64).reshape(1)
        o_col = self.Osk.index_select(2, di).squeeze(2)
        out = front_core(self.qpd6, self.R, self.rmd, self.W, self.PME,
                         o_col, self.d, self.Cc, self.ctx_lane,
                         self.sig_lane, want_qc=self.fetch_qc)
        S_col, pme_col = out[0], out[4]
        for buf, col in zip(self.cols, out[1:4] + out[5:]):
            buf.index_copy_(0, di, col[None].to(buf.dtype))
        if self.S is not None:
            self.S.index_copy_(0, di, S_col[None])
        self.W.copy_(torch.cat([self.W[:, :, 1:], S_col[:, :, None]], 2))
        self.PME.copy_(pme_col)

    def capture(self):
        """CUDA: capture the step (utils/graphs.CapturedStep: one eager
        warm-up step on a side stream, the capture into a graph with a
        private pool, its instantiation; a failed capture raises). The
        kernels' launch counters keep counting the kernels the card runs:
        the warm-up's count stays, the capture's is added again at every
        replay. graph, launches (each kernel's launches a replay) and
        stats (the warm-up, capture and instantiate seconds, the pool's
        bytes) are the captured step's."""
        self.run = graphs.CapturedStep(self.step, self.device, "front")
        self.graph, self.stats = self.run.graph, self.run.stats
        self.launches = dict(self.run.launches)

    def front(self, d: int):
        """front step d: a replay of the captured step, or (not captured)
        the step itself."""
        self.d.fill_(d)
        self.run()

    def tail(self):
        """unskew the record columns into raster order and checksum them:
        the slice's outputs (run_slice's), in fresh tensors."""
        B, R, Cc = self.B, self.R, self.Cc

        def unskew(a):                # (D, B, R, ...) -> (B, R, Cc, ...)
            return torch.stack([a[2 * r:2 * r + Cc, :, r] for r in range(R)],
                               0).movedim(2, 0)

        dec = [unskew(a) for a in self.cols[:3]]
        if not self.fetch_qc:
            rec = torch.cat(dec, -1).reshape(B, R * Cc * _REC_DEC)
            ck = _dev_cksum(rec)                                    # (B,)
            tail = torch.stack([(ck >> (8 * k)) & 0xFF for k in range(4)], -1)
            tail = torch.where(tail > 127, tail - 256, tail).to(torch.int8)
            return torch.cat([rec, tail], -1)

        qc16_u = unskew(self.cols[3])                     # (B, R, Cc, 1024)
        esc = ((qc16_u < -128) | (qc16_u > 127)).reshape(B, -1).any(-1)
        buf = torch.cat(dec + [qc16_u.clamp(-128, 127).to(torch.int8)], -1)
        plane = None
        ckS = torch.zeros((B,), dtype=torch.int32, device=self.device)
        if self.want_recon:
            plane = unskew(self.S).permute(0, 1, 3, 2, 4).reshape(
                B, R * CTU, Cc * CTU)
            ckS = _dev_cksum(plane.reshape(B, -1))
        side = torch.stack([_dev_cksum(buf.reshape(B, -1)), _i32(esc), ckS,
                            _dev_cksum(qc16_u.reshape(B, -1))], -1)
        return buf, side, qc16_u, plane

    def __call__(self, O, cv, sv):
        """the slice of one batch: run_slice's outputs."""
        self.load(O, cv, sv)
        for d in range(self.D):
            self.front(d)
        return self.tail()


@functools.lru_cache(maxsize=None)
def _slice_runner_cache(qpd6: int, R: int, Cc: int, B: int, rmd,
                        fetch_qc: bool, want_recon: bool,
                        device: torch.device) -> _SliceRunner:
    """The runner of one slice shape (hevce_tpu's _slice_runner_cache, which
    jits one program per (qpd6, R, Cc, want_recon, mesh, fetch_qc, rmd) and
    retraces per batch size; here B and the device are in the key, and a
    mesh runs one runner per part's device). On CUDA its front step is
    captured as a CUDA graph here, once, and every front of every later
    call is one replay of it; a failed capture raises, and nothing runs the
    step eagerly on CUDA after it. On the CPU the step runs eagerly.
    device must carry its index (utils/device.normal)."""
    runner = _SliceRunner(qpd6, R, Cc, B, rmd, fetch_qc, want_recon, device)
    if device.type == "cuda":
        runner.capture()
    return runner


def run_slice(O, cv, sv, qpd6: int, rmd, fetch_qc=False, want_recon=False):
    """Whole-slice runner, eager: skew the raster input tiles into fronts,
    run the D = 2(R-1) + Cc front steps with a 3-column recon window and the
    pmode edge carry, unskew, and checksum the output. The plain version of
    _slice_runner_cache's runner: a fresh runner, never captured, runs the
    same skew, step and tail; for the tests and chip_smoke.py.

    O (B, R, Cc, 32, 32) uint8 tiles; cv / sv (B,) int32 per-image context /
    sig-zero bin prices (<<15); rmd (K, T) or None (dense).
    Lean (fetch_qc=False): (B, R*Cc*106 + 4) int8 records + checksum tail.
    Full: (buf (B, R, Cc, 1130) int8 [lay|pm|pm4|qc8], side (B, 4) int32
    [ck, esc, ckS, ck16], qc16 (B, R, Cc, 1024) int16, plane (B, R*32,
    Cc*32) uint8 recon or None unless want_recon); esc flags an image with a
    level outside int8, whose exact levels the host then reads from qc16."""
    B, R, Cc = O.shape[:3]
    return _SliceRunner(qpd6, R, Cc, B, rmd, fetch_qc, want_recon,
                        O.device)(O, cv, sv)


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
# or globally via HEVCE_RMD="K,T"; rmd=None or HEVCE_RMD=off selects the
# dense 35-mode search).
RMD_DEFAULT = (12, 4)
_RMD_ENV = object()                    # sentinel: resolve from env/default


def _resolve_rmd(rmd):
    if rmd is not _RMD_ENV:
        return None if rmd is None else tuple(rmd)
    v = os.environ.get("HEVCE_RMD", "").strip().lower()
    if not v:
        return RMD_DEFAULT
    if v in ("off", "none", "0"):
        return None
    try:
        ks, ts = v.split(",")
        k, t = int(ks), int(ts)
    except ValueError:
        raise ValueError(
            f"HEVCE_RMD must be 'K,T' (e.g. '12,4'), 'off', or unset; "
            f"got {v!r}") from None
    k = max(1, min(k, MODES))           # clamp K first, then T against it
    return (k, max(1, min(t, k)))


class _HostCopy:
    """Device->host copy of one output tensor, started without blocking
    (into pinned memory on CUDA); numpy() waits for it. start: a timing
    event recorded on the stream before the batch's uploads, which makes
    the copy's own event a timing event too: card_s() is then the batch's
    card seconds."""

    def __init__(self, out: torch.Tensor, start=None):
        self.start = start
        if out.is_cuda:
            self.host = torch.empty(out.shape, dtype=out.dtype,
                                    pin_memory=True)
            self.host.copy_(out, non_blocking=True)
            self.event = torch.cuda.Event(enable_timing=start is not None)
            self.event.record()
        else:
            self.host, self.event = out, None

    def numpy(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy()

    def card_s(self):
        """seconds on the card from `start` to the end of this copy (CUDA
        events, read once the copy is waited for), or None untimed."""
        if self.start is None:
            return None
        self.event.synchronize()
        return self.start.elapsed_time(self.event) / 1e3


def _add_card(timer, copy):
    """add a fetched batch's card seconds (the card_s of its last
    _HostCopy) to the timer's CARD total; untimed batches (CPU, mesh) add
    nothing."""
    s = copy.card_s()
    if s is not None:
        timer.totals[CARD] += s
        timer.counts[CARD] += 1


def _dispatch_batch(images, qpd6: int, rmd=_RMD_ENV, prices=None,
                    device=None, want_recon=True, fetch_qc=False, mesh=None,
                    timer=None):
    """Upload + run the slice for one same-shaped batch through its shape's
    runner (_slice_runner_cache: on CUDA one graph replay per front step).
    Launches are queued on the current stream and the copies to the host
    start without blocking. Returns (out, meta) for _finish_batch (or
    _fetch_lean). timer's phases: "tile" (_slice_inputs), "upload" (the
    copies to the device, with their wait behind work already queued) and
    "enqueue" (the runner call and the start of the copies to the host). On
    one CUDA device a timing event before the uploads and the last copy's
    event time the batch on the card (_HostCopy.card_s).
    prices: optional (ctx, sig) per-image arrays (B,) of <<15 bin prices;
    None = the constant knobs. fetch_qc=False: out is the lean records'
    _HostCopy; True: (buf, side, plane) _HostCopys with qc16 left on the
    device between side and plane (plane None unless want_recon).
    mesh: a sequence of devices (parallel/batch.make_mesh) that the batch
    is split over, one runner call per device, the outputs gathered on the
    first; B must be a multiple of its size, and device is not used."""
    timer = timer if timer is not None else PhaseTimer()
    if mesh is None:
        dev = _device.resolve(device)
    else:
        mesh = pb.make_mesh(mesh)
        pb.check_split(len(images), mesh)
        dev = mesh[0]
    with timer.phase("tile"):
        meta, arrays = _slice_inputs(images, qpd6, prices)
    R, Cc = meta[6:]
    start = None
    if mesh is None and dev.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        start.record()
    with timer.phase("upload"):
        args = [torch.from_numpy(a).to(dev) for a in arrays]
    rmd = _resolve_rmd(rmd)

    def run(part, O, cv, sv):
        return _slice_runner_cache(qpd6, R, Cc, O.shape[0], rmd, fetch_qc,
                                   want_recon and fetch_qc,
                                   _device.normal(O.device))(O, cv, sv)
    with timer.phase("enqueue"), torch.no_grad():
        out = pb.sharded(run, mesh, *args)
        if fetch_qc:        # side's copy last: its event ends the batch
            buf, side, qc16, plane = out
            buf = _HostCopy(buf)
            plane = None if plane is None else _HostCopy(plane)
            out = (buf, _HostCopy(side, start), qc16, plane)
        else:
            out = _HostCopy(out, start)
    return out, meta


def _slice_inputs(images, qpd6: int, prices=None):
    """One same-shaped batch as a slice's host inputs: (meta, (O, cv, sv)),
    meta = (images, qpd6, ysz, xsz, yp, xp, R, Cc) for _finish_batch, O the
    (B, R, Cc, 32, 32) uint8 raster tiles and cv / sv the (B,) int32 bin
    prices (prices, or the constant knobs when None)."""
    images = [native._clip_dims(im) for im in images]
    shape = images[0].shape
    if any(im.shape != shape for im in images):
        raise ValueError("batch must share dims")
    ysz, xsz = shape
    yp, xp = -(-ysz // CTU) * CTU, -(-xsz // CTU) * CTU
    B = len(images)
    if prices is None:
        cv = np.full(B, _ctx_default(qpd6), np.int32)
        sv = np.full(B, SIG_ZERO, np.int32)
    else:
        cv = np.asarray(prices[0], np.int32).reshape(B)
        sv = np.asarray(prices[1], np.int32).reshape(B)
    return ((images, qpd6, ysz, xsz, yp, xp, yp // CTU, xp // CTU),
            (_orig_tiles_raster(images, yp, xp), cv, sv))


def _fetch_lean(out, meta, timer):
    """Wait for one batch's records on the host ("fetch"; then the batch's
    card seconds go to the timer's CARD total) and verify the checksum
    tail ("verify"). Returns the (B, R, Cc, 106) int8 record array."""
    images, qpd6, ysz, xsz, yp, xp, R, Cc = meta
    B = len(images)
    with timer.phase("fetch"):
        flat = out.numpy()                           # (B, n + 4) int8
    _add_card(timer, out)
    n = R * Cc * _REC_DEC
    with timer.phase("verify"):
        rec = flat[:, :n]
        t = flat[:, n:].astype(np.int64) & 0xFF
        ck_dev = ((t[:, 0] | (t[:, 1] << 8) | (t[:, 2] << 16)
                   | (t[:, 3] << 24)).astype(np.uint32).view(np.int32))
        got = _host_cksum(rec)
        if not np.array_equal(got, ck_dev):
            raise IOError("fast-mode record transfer checksum mismatch: "
                          f"{got} != {ck_dev}")
    return rec.reshape(B, R, Cc, _REC_DEC)


# the process's host threads that pack a batch's images at once
# (_pack_each): (pid, executor), made on first use; a forked child makes its
# own, since the parent's threads are not in it
_pack_pool = None
_pack_pool_lock = threading.Lock()


def _usable_cores() -> int:
    try:
        return len(os.sched_getaffinity(0))
    except AttributeError:                # no affinity on this platform
        return os.cpu_count() or 1


def _pack_width(n: int) -> int:
    """threads that pack a batch of n images: one an image, up to the
    usable cores. One while HEVCE_PACK_STATS is set: the pack's calibration
    dump appends a frame per image to one file."""
    if os.environ.get("HEVCE_PACK_STATS"):
        return 1
    return min(n, _usable_cores())


def _pack_executor():
    global _pack_pool
    with _pack_pool_lock:
        if _pack_pool is None or _pack_pool[0] != os.getpid():
            _pack_pool = (os.getpid(), concurrent.futures.ThreadPoolExecutor(
                _usable_cores(), thread_name_prefix="hevce-pack"))
        return _pack_pool[1]


def _pack_each(pack, n: int, timer):
    """[pack(b) for b in range(n)], in that order, packed at once on
    _pack_width(n) threads of the pool: native's packs drop the GIL and keep
    their state thread_local. Width 1 packs inline on the calling thread.
    The pool's threads never touch the timer; it counts the images they
    pack as 'pack_pooled'. A pack's exception is raised here once every
    thread has stopped, and nothing is returned."""
    width = _pack_width(n)
    if width <= 1:
        return [pack(b) for b in range(n)]
    todo = queue.SimpleQueue()
    for b in range(n):
        todo.put(b)
    out = [None] * n

    def work():
        while True:
            try:
                b = todo.get_nowait()
            except queue.Empty:
                return
            out[b] = pack(b)
    pool = _pack_executor()
    futures = [pool.submit(work) for _ in range(width)]
    concurrent.futures.wait(futures)
    for f in futures:
        f.result()
    timer.counts["pack_pooled"] += n
    return out


def _pack_lean(rec, meta, want_recon, timer, stats_out=None):
    """Host pack from decision records (native.pack_forest_img recomputes
    quant levels + recon from the original images), the batch's images at
    once (_pack_each); the "pack" phase is the batch's wall. stats_out:
    optional list that receives one (payload bits, context bins, bypass
    bins, recon) per image in input order (native.last_pack_stats, read on
    the thread that packed; the HEVCE_ADAPT=post pass reads the bits and
    needs the recon even when the caller asked for none)."""
    images, qpd6 = meta[0], meta[1]

    def pack(b):
        s, r = native.pack_forest_img(
            rec[b, :, :, _REC_LAY], rec[b, :, :, _REC_PM],
            rec[b, :, :, _REC_PM4], images[b], qpd6)
        st = None if stats_out is None else native.last_pack_stats() + (r,)
        return s, (r if want_recon else None), st
    with timer.phase("pack"):
        packed = _pack_each(pack, len(images), timer)
    if stats_out is not None:
        stats_out.extend(p[2] for p in packed)
    return [p[0] for p in packed], [p[1] for p in packed]


def _finish_batch(out, meta, want_recon, timer, fetch_qc=False,
                  stats_out=None):
    """Fetch one dispatched batch's results, verify the transfer checksums
    and pack the streams on the host (stats_out: _pack_lean's, lean records
    only). fetch_qc must match the dispatch; the full records are packed
    from their quant levels (native.pack_forest), and the recon is the
    device's."""
    if not fetch_qc:
        return _pack_lean(_fetch_lean(out, meta, timer), meta, want_recon,
                          timer, stats_out)
    images, qpd6, ysz, xsz, yp, xp, R, Cc = meta
    B = len(images)
    buf_c, side_c, qc16, plane_c = out
    with timer.phase("fetch"):
        side = side_c.numpy()
        buf = buf_c.numpy()
        hS = plane_c.numpy() if want_recon else None
    _add_card(timer, side_c)
    with timer.phase("verify"):
        got = _host_cksum(buf.reshape(B, -1))
        if not np.array_equal(got, side[:, 0]):
            raise IOError("fast-mode record transfer checksum mismatch: "
                          f"{got} != {side[:, 0]}")
        if want_recon:
            gotS = _host_cksum(hS.reshape(B, -1))
            if not np.array_equal(gotS, side[:, 2]):
                raise IOError("fast-mode recon transfer checksum mismatch: "
                              f"{gotS} != {side[:, 2]}")
    qc_exact = {}
    with timer.phase("fetch"):           # rare |level| > 127 escapes
        for b in np.flatnonzero(side[:, 1]):
            q16 = qc16[int(b)].cpu().numpy()
            if _host_cksum(q16.reshape(1, -1))[0] != side[b, 3]:
                raise IOError("fast-mode qc16 transfer checksum mismatch "
                              f"on image {b}")
            qc_exact[int(b)] = q16.astype(np.int32)

    def pack(b):
        return native.pack_forest(
            buf[b, :, :, _REC_LAY], buf[b, :, :, _REC_PM],
            buf[b, :, :, _REC_PM4], qc_exact.get(b, buf[b, :, :, _REC_QC8]),
            ysz, xsz, qpd6)
    with timer.phase("pack"):
        streams = _pack_each(pack, B, timer)
    return streams, [hS[b] if want_recon else None for b in range(B)]


# ---------------------------------------------------------------- drivers

def encode_batch_fast(images, qpd6: int, timer=None, want_recon=True,
                      rmd=_RMD_ENV, device=None, fetch_qc=False, mesh=None):
    """Wavefront fast mode: encode B same-shaped uint8 grayscale images.

    Returns (streams, recons). Streams are standard-compliant HEVC (exact
    CABAC pack of the chosen forest) but not bit-identical to the reference
    encoder: decisions use the estimated rate model. The recon is exactly
    what a decoder reconstructs; want_recon=False returns None recons.
    fetch_qc=True ships the full records (quant levels, device recon)
    instead of the lean ones; streams and recons are the same. Constant bin
    prices (no adaptation). device=None runs on the card. mesh: a sequence
    of devices the batch is split over (_dispatch_batch); the batch must be
    a multiple of its size, and the streams are the unsplit ones."""
    timer = timer if timer is not None else PhaseTimer()
    timer.tag = next(_BATCH_TAGS)
    with timer.phase("dispatch"):
        out, meta = _dispatch_batch(images, qpd6, rmd, device=device,
                                    want_recon=want_recon, fetch_qc=fetch_qc,
                                    mesh=mesh, timer=timer)
    return _finish_batch(out, meta, want_recon, timer, fetch_qc)


def adapt_mode() -> str:
    """Per-image rate-price adaptation (HEVCE_ADAPT): 'pre' (default) —
    predict prices from image gradients before encoding; 'post' — encode,
    re-encode the images whose packed bits per pixel cross a trigger at a
    lower context price, keep the better stream (encode_many_fast's lean
    path); '0' — off."""
    v = os.environ.get("HEVCE_ADAPT", "pre").strip().lower()
    if v in ("1", "on", "pre", ""):
        return "pre"
    if v == "post":
        return "post"
    return "0"


# pre-pass predictor (calibrated on Kodak-24 @ qpd6=2 in the JAX package):
# mean |horizontal| + |vertical| pixel gradient >= 25 flags the rate-dense
# images, which get a context price scaled down by trigger / gradient.
ADAPT_GRAD_TRIGGER = 25.0
ADAPT_PRICE_AT_TRIGGER = 0.60 * BIT   # price (<<15) at the trigger
ADAPT_FLOOR = int(0.40 * BIT)         # price floor
# post pass (calibrated on Kodak-24 in the JAX package): per-qpd6 packed
# bits per pixel that flag an image (1.25x the exact streams' median), and
# the extra bits per pixel a corrected stream may cost if its SSE improves
ADAPT_BPP_TRIGGER = {0: 5.9, 1: 4.2, 2: 3.0, 3: 1.7, 4: 1.0}
ADAPT_BPP_ALLOW = 0.02


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


def _adapt_rule(bits: int, nctx: int, nbyp: int, npix: int, qpd6: int = 2):
    """(realized pack stats, pixel count, qpd6) -> corrected (ctx, sig)
    prices for the post pass, or None: the context price scales down with
    the packed bits per pixel past the trigger; the sig-zero price stays."""
    if npix <= 0 or bits <= 0:
        return None
    trigger = ADAPT_BPP_TRIGGER[qpd6]
    bpp = bits / npix
    if bpp < trigger:
        return None
    ctx = int(ADAPT_PRICE_AT_TRIGGER * trigger / bpp)
    return max(ADAPT_FLOOR, min(ctx, _ctx_default(qpd6))), SIG_ZERO


def _sse(img, rcon) -> int:
    h, w = img.shape
    d = img.astype(np.int64) - rcon[:h, :w].astype(np.int64)
    return int((d * d).sum())


def _shape_batches(images, batch: int):
    """index lists of at most `batch` same-shaped images, shapes in order."""
    groups = {}
    for i, im in enumerate(images):
        groups.setdefault(im.shape, []).append(i)
    return [groups[s][k:k + batch] for s in sorted(groups, key=str)
            for k in range(0, len(groups[s]), batch)]


AHEAD = 4                             # batches in flight ahead of the drain
# a batch's tag: the timer's `tag` while its phases run (utils/tracing)
_BATCH_TAGS = itertools.count(1)


def encode_many_fast(images, qpd6: int, batch: int = 8, timer=None,
                     want_recon=True, rmd=_RMD_ENV, device=None,
                     fetch_qc=False, mesh=None):
    """Throughput-oriented fast-mode encode of a mixed-shape image list.

    Groups images by shape into batches of `batch` and keeps up to AHEAD
    batches dispatched ahead of the fetch+pack drain: the card runs queued
    batches while the host packs earlier ones, and each batch's record copy
    to pinned host memory starts at dispatch. Under HEVCE_ADAPT=pre (the
    default) each batch runs at prices predicted from image content. Under
    HEVCE_ADAPT=post (lean records only) each batch runs at the constant
    prices; the images whose packed bits per pixel cross ADAPT_BPP_TRIGGER
    are re-encoded at _adapt_rule's prices in a corrective batch padded to
    the source batch's size, queued with the others, and the corrected
    stream is kept if its SSE is lower at no more than ADAPT_BPP_ALLOW extra
    bits per pixel (or no higher at fewer bits); the timer counts
    'adapt_flagged' and 'adapt_kept' images. The timer's phases: "prices"
    (the pre pass's prediction), "dispatch" (_dispatch_batch: "tile",
    "upload", "enqueue"), "fetch", "verify" and "pack" (the wall of a
    batch's images packed at once on host threads, _pack_each, which counts
    them as 'pack_pooled'; a batch of one packs inline); each batch's phases
    share a tag (the timer's `tag`), and on one CUDA device each fetched
    batch adds its card seconds to the CARD total. fetch_qc=True ships the
    full records (encode_batch_fast). Returns (streams, recons) in input
    order; recons are None when want_recon=False. device=None runs on the
    card. mesh: a sequence of devices each batch is split over
    (_dispatch_batch); a batch is padded up to a multiple of its size by
    repeating its last image, whose copies' outputs are dropped, and
    HEVCE_ADAPT=post stays single-pass."""
    timer = timer if timer is not None else PhaseTimer()
    if mesh is not None:
        mesh = pb.make_mesh(mesh)
    mode = adapt_mode()
    adapt = mode == "post" and not fetch_qc and mesh is None
    streams = [None] * len(images)
    recons = [None] * len(images)
    inflight = collections.deque()  # (out, meta, tag, idx, flags or None)

    def dispatch(idx, prices, tag, want_recon=want_recon):
        timer.tag = tag
        with timer.phase("dispatch"):
            out, meta = _dispatch_batch([images[i] for i in idx], qpd6, rmd,
                                        prices=prices, device=device,
                                        want_recon=want_recon,
                                        fetch_qc=fetch_qc, mesh=mesh,
                                        timer=timer)
        return out, meta, tag

    def flag_and_redispatch(idx, st):
        flags = []                     # (image index, pass-1 SSE, prices)
        for j, i in enumerate(idx):
            bits, nctx, nbyp, r1 = st[j]
            corr = _adapt_rule(bits, nctx, nbyp, int(images[i].size), qpd6)
            if corr is not None:
                flags.append((i, _sse(images[i], r1), corr))
        timer.counts["adapt_flagged"] += len(flags)
        if not flags:
            return
        rows = flags + [flags[-1]] * (len(idx) - len(flags))
        prices = tuple(np.array([f[2][k] for f in rows], np.int32)
                       for k in (0, 1))
        inflight.append(dispatch([f[0] for f in rows], prices,
                                 next(_BATCH_TAGS), False)
                        + ([f[0] for f in rows], flags))

    def drain_one():
        out, meta, tag, idx, flags = inflight.popleft()
        timer.tag = tag
        if flags is None:              # a primary batch
            st = [] if adapt else None
            s, r = _finish_batch(out, meta, want_recon, timer, fetch_qc, st)
            for j, i in enumerate(idx):
                streams[i], recons[i] = s[j], r[j]
            if adapt:
                flag_and_redispatch(idx, st)
            return
        st2 = []                       # a corrective batch
        s2, _ = _finish_batch(out, meta, False, timer, stats_out=st2)
        for j, (i, sse1, _) in enumerate(flags):
            sse2 = _sse(images[i], st2[j][3])
            dbits = (len(s2[j]) - len(streams[i])) * 8
            allow = int(ADAPT_BPP_ALLOW * images[i].size)
            if (sse2 < sse1 and dbits <= allow) or \
                    (sse2 <= sse1 and dbits < 0):
                streams[i] = s2[j]
                timer.counts["adapt_kept"] += 1
                if want_recon:
                    recons[i] = st2[j][3]

    for idx in _shape_batches(images, batch):
        if len(inflight) >= AHEAD:
            drain_one()
        padded = idx if mesh is None else idx + [idx[-1]] * (-len(idx)
                                                             % len(mesh))
        timer.tag = tag = next(_BATCH_TAGS)
        pr = None
        if mode == "pre":
            with timer.phase("prices"):
                pr = _predict_prices([images[i] for i in padded], qpd6)
        inflight.append(dispatch(padded, pr, tag) + (idx, None))
    while inflight:
        drain_one()
    return streams, recons


def encode_image_fast(img, qpd6: int, device=None):
    """single-image wavefront fast encode (no price adaptation); returns
    (stream bytes, recon)."""
    s, r = encode_batch_fast([img], qpd6, device=device)
    return s[0], r[0]


def encode_many_exact(images, qpd6: int, nthreads: int = 0, timer=None,
                      batch: int = 8, device=None):
    """Bit-exact batch encode, hinted by the fast mode.

    Every batch's lean decision records (lay / pm / pm4) are computed on the
    card first; then the native engine re-runs the exact reference RDO with
    each node's hinted candidate tried first (native.encode_many_native).
    Trial order cannot change a decision (the arbiter's tie-break follows
    the reference's indices), so the streams are byte-identical to
    native.encode_image_native's; the hints let the provable prunes bite
    early. All batches are dispatched before the first is drained, so the
    card runs ahead of the host RDO (the 'host_rdo' phase of the timer).
    Returns (streams, recons). device=None runs the hints on the card."""
    timer = timer if timer is not None else PhaseTimer()
    streams = [None] * len(images)
    recons = [None] * len(images)
    pending = []
    for idx in _shape_batches(images, batch):
        timer.tag = tag = next(_BATCH_TAGS)
        with timer.phase("dispatch"):
            out, meta = _dispatch_batch([images[i] for i in idx], qpd6,
                                        device=device, timer=timer)
        pending.append((out, meta, tag, idx))
    for out, meta, tag, idx in pending:
        timer.tag = tag
        hints = np.ascontiguousarray(_fetch_lean(out, meta, timer))
        with timer.phase("host_rdo"):
            s, r = native.encode_many_native(
                [images[i] for i in idx], qpd6, nthreads, hints=hints)
        for j, i in enumerate(idx):
            streams[i], recons[i] = s[j], r[j]
    return streams, recons

