# Frozen copy of hevce_tpu_torch/ops/intra.py at commit 2c4bff8; imports point at the frozen copies.
# Edit only to follow a change of what the benchmark compares.
"""35-mode HEVC intra prediction, evaluated densely for all modes at once.

Reference semantics: getBorder / predict at reference src/HEVCe.c:196-381.

Every angular prediction is two constant 5-bit-weighted taps of the
concatenated border vector S = [ubla | ublb | ubar | fbla | fblb | fbar], so
all 33 angular modes are one CONSTANT matrix applied to S (built once per
size in numpy). The product runs in float32: pixels <= 255, weights <= 32,
two taps per row, so every sum is an integer below 2^24 and exact (TF32 is
off, utils/device.resolve). Planar / DC / pure-H / pure-V rows (modes 0, 1,
10, 26) are closed-form and overwrite their rows, including the sz <= 16
luma edge filters (src/HEVCe.c:302-340).
"""
import functools

import numpy as np
import torch

from benchmark.reference import tables as params
from benchmark.reference import constants as C


# ---------------------------------------------------------------------------
# border construction (reference src/HEVCe.c:196-257)
# ---------------------------------------------------------------------------

def build_borders(sz: int, corner, left2, top2, bll, blb, baa, bar):
    """Construct unfiltered + filtered borders.

    corner: (...,) value at rcon[-1][-1]; left2: (..., 2*sz) rcon[i][-1];
    top2: (..., 2*sz) rcon[-1][i]. Flags are broadcastable bool tensors.
    Returns S: (..., 2 + 8*sz) int32 concatenated border vector
    [ubla(1), ublb(2sz), ubar(2sz), fbla(1), fblb(2sz), fbar(2sz)].
    """
    corner = corner.to(torch.int32)
    left2 = left2.to(torch.int32)
    top2 = top2.to(torch.int32)
    bll, blb, baa, bar = (f.to(torch.bool) for f in (bll, blb, baa, bar))

    ubla = torch.where(bll & baa, corner,
                       torch.where(bll, left2[..., 0],
                                   torch.where(baa, top2[..., 0], 128)))

    def fill(src2, exist_lo, exist_hi):
        lo = torch.where(exist_lo[..., None], src2[..., :sz], ubla[..., None])
        hi = torch.where(exist_hi[..., None], src2[..., sz:],
                         lo[..., sz - 1:sz])
        return torch.cat([lo, hi], -1)

    ublb = fill(left2, bll, blb)
    ubar = fill(top2, baa, bar)

    fbla = (2 + ublb[..., 0] + ubar[..., 0] + 2 * ubla) >> 2

    def smooth(u):
        f0 = (2 + 2 * u[..., 0] + u[..., 1] + ubla) >> 2
        mid = (2 + 2 * u[..., 1:-1] + u[..., :-2] + u[..., 2:]) >> 2
        return torch.cat([f0[..., None], mid[..., :2 * sz - 2],
                          u[..., 2 * sz - 1:2 * sz]], -1)

    return torch.cat([ubla[..., None], ublb, ubar, fbla[..., None],
                      smooth(ublb), smooth(ubar)], -1)


# ---------------------------------------------------------------------------
# constant angular matrix (numpy, built once per size)
# ---------------------------------------------------------------------------

def _ref_index(sz, mode, p, base, main_off, side_off):
    """Map conceptual ref_buff position p to an index in the S vector
    (reference src/HEVCe.c:350-364)."""
    if p == 0:
        return base
    if p > 0:
        return main_off + p - 1
    inv = int(C.ABS_INV_ANGLE_TABLE[mode])
    j = (128 - inv * p) >> 8
    if j < 1:
        raise AssertionError(f"side index {j} for sz={sz} mode={mode}")
    return side_off + j - 1


@functools.lru_cache(maxsize=None)
def _angular_tables(sz: int):
    """Returns (idx1, idx2, frac, horiz) numpy tables of shape (35, sz, sz),
    (35, sz, sz), (35, sz, 1), (35,). Rows 0/1 are placeholders."""
    idx1 = np.zeros((35, sz, sz), np.int32)
    idx2 = np.zeros((35, sz, sz), np.int32)
    frac = np.zeros((35, sz, 1), np.int32)
    horiz = np.zeros(35, bool)
    for m in range(2, 35):
        filt = bool(C.FILTER_BORDER_Y[sz][m])
        base = (1 + 4 * sz) if filt else 0
        blb_off, bar_off = base + 1, base + 1 + 2 * sz
        is_h = m < C.PMODE_DEG135
        horiz[m] = is_h
        main_off = blb_off if is_h else bar_off
        side_off = bar_off if is_h else blb_off
        angle = int(C.ANGLE_TABLE[m])
        for i in range(sz):
            off = angle * (i + 1)
            off_i, off_f = off >> 5, off & 31
            frac[m, i, 0] = off_f
            for j in range(sz):
                idx1[m, i, j] = _ref_index(sz, m, off_i + j + 1, base,
                                           main_off, side_off)
                idx2[m, i, j] = _ref_index(sz, m, off_i + j + 2, base,
                                           main_off, side_off)
    return idx1, idx2, frac, horiz


@functools.lru_cache(maxsize=None)
def _angular_matrix(sz: int):
    """(35, sz*sz, 2+8*sz) float32 constant: out[m, p] = W[m, p] . S, before
    the shared (+16) >> 5 rounding. The horizontal-mode transpose
    (src/HEVCe.c:374-377) is baked into the pixel index, and each row has
    exactly two taps summing to 32. Rows 0/1/10/26 are zero (closed-form)."""
    idx1, idx2, frac, horiz = _angular_tables(sz)
    n = 2 + 8 * sz
    W = np.zeros((35, sz, sz, n), np.float32)
    for m in range(2, 35):
        for i in range(sz):
            f = int(frac[m, i, 0])
            for j in range(sz):
                oi, oj = (j, i) if horiz[m] else (i, j)
                W[m, oi, oj, idx1[m, i, j]] += 32 - f
                # idx2 can point one past the border segment when f == 0
                # (angle-32 rows); the tap has zero weight there
                if f:
                    W[m, oi, oj, idx2[m, i, j]] += f
    return W.reshape(35, sz * sz, n)


# ---------------------------------------------------------------------------
# dense 35-mode prediction
# ---------------------------------------------------------------------------

def _angular_mm(sz, S):
    """All angular modes as one float32 product: (..., n) -> (..., 35, sz, sz)."""
    wt = params.tables(S.device)["angular_t"][sz]          # (n, 35*sz*sz)
    acc = torch.matmul(S.to(torch.float32), wt)
    ang = (acc.to(torch.int32) + 16) >> 5
    return ang.reshape(S.shape[:-1] + (35, sz, sz))


def _angular_mm_per_lane(sz, S):
    """Mode-diagonal variant: S (..., 35, n), lane m predicted with mode m
    only -> (..., 35, sz, sz). One mode-batched float32 product, exact for
    the same reason as _angular_mm (TF32 off, sums below 2^24)."""
    w = params.tables(S.device)["angular"][sz]             # (35, nn, n)
    lead = S.shape[:-2]
    Sm = S.to(torch.float32).reshape(-1, 35, S.shape[-1]).transpose(0, 1)
    acc = torch.bmm(Sm, w.transpose(1, 2))                 # (35, batch, nn)
    ang = (acc.to(torch.int32) + 16) >> 5
    return ang.transpose(0, 1).reshape(lead + (35, sz, sz))


def predict_per_lane(sz: int, S: torch.Tensor) -> torch.Tensor:
    """Mode-diagonal prediction: lane m of S predicts with mode m only.

    S: (..., 35, 2+8*sz) int32 border vectors, one per mode lane (they
    differ when sub-TU chaining gives each mode its own reconstruction).
    Returns (..., 35, sz, sz) uint8. Used by the dense TU-split evaluation;
    predict_all_modes covers the shared-border case."""
    out = _angular_mm_per_lane(sz, S)
    # closed-form rows use each lane's own border vector
    out[..., C.PMODE_PLANAR, :, :] = _planar_block(sz, S[..., C.PMODE_PLANAR, :])
    out[..., C.PMODE_DC, :, :] = _dc_block(sz, S[..., C.PMODE_DC, :])
    out[..., C.PMODE_HOR, :, :] = _hor_block(sz, S[..., C.PMODE_HOR, :])
    out[..., C.PMODE_VER, :, :] = _ver_block(sz, S[..., C.PMODE_VER, :])
    return out.to(torch.uint8)


def _split_S(sz, S):
    ubla = S[..., 0]
    ublb = S[..., 1:1 + 2 * sz]
    ubar = S[..., 1 + 2 * sz:1 + 4 * sz]
    foff = 1 + 4 * sz
    fblb = S[..., foff + 1:foff + 1 + 2 * sz]
    fbar = S[..., foff + 1 + 2 * sz:foff + 1 + 4 * sz]
    return ubla, ublb, ubar, fblb, fbar


def _planar_block(sz, S):
    ubla, ublb, ubar, fblb, fbar = _split_S(sz, S)
    pblb, pbar = (fblb, fbar) if C.FILTER_BORDER_Y[sz][0] else (ublb, ubar)
    jj = torch.arange(sz, dtype=torch.int32, device=S.device)
    ii = jj[:, None]
    hor_pred = (sz - jj - 1)[None, :] * pblb[..., :sz][..., :, None] \
        + (jj + 1)[None, :] * pbar[..., sz][..., None, None]
    ver_pred = (sz - ii - 1) * pbar[..., :sz][..., None, :] \
        + (ii + 1) * pblb[..., sz][..., None, None]
    return (sz + hor_pred + ver_pred) // (sz * 2)


def _dc_block(sz, S):
    ubla, ublb, ubar, _, _ = _split_S(sz, S)
    dc = (sz + ublb[..., :sz].sum(-1, dtype=torch.int32)
          + ubar[..., :sz].sum(-1, dtype=torch.int32)) // (2 * sz)
    dcb = dc[..., None, None].expand(dc.shape + (sz, sz)).clone()
    if sz <= 16:
        dcb[..., 0, :] = (2 + 3 * dc[..., None] + ubar[..., :sz]) >> 2
        dcb[..., :, 0] = (2 + 3 * dc[..., None] + ublb[..., :sz]) >> 2
        dcb[..., 0, 0] = (2 + 2 * dc + ublb[..., 0] + ubar[..., 0]) >> 2
    return dcb


def _hor_block(sz, S):
    ubla, ublb, ubar, _, _ = _split_S(sz, S)
    horb = ublb[..., :sz, None].expand(ublb.shape[:-1] + (sz, sz)).clone()
    if sz <= 16:
        bias = (ubar[..., :sz] - ubla[..., None]) >> 1
        horb[..., 0, :] = torch.clamp(bias + horb[..., 0, :], 0, 255)
    return horb


def _ver_block(sz, S):
    ubla, ublb, ubar, _, _ = _split_S(sz, S)
    verb = ubar[..., None, :sz].expand(ubar.shape[:-1] + (sz, sz)).clone()
    if sz <= 16:
        bias = (ublb[..., :sz] - ubla[..., None]) >> 1
        verb[..., :, 0] = torch.clamp(bias + verb[..., :, 0], 0, 255)
    return verb


def predict_all_modes(sz: int, S: torch.Tensor) -> torch.Tensor:
    """All 35 predicted blocks from border vector S (..., 2+8*sz) int32.

    Returns (..., 35, sz, sz) uint8."""
    out = _angular_mm(sz, S)
    out[..., C.PMODE_PLANAR, :, :] = _planar_block(sz, S)
    out[..., C.PMODE_DC, :, :] = _dc_block(sz, S)
    out[..., C.PMODE_HOR, :, :] = _hor_block(sz, S)
    out[..., C.PMODE_VER, :, :] = _ver_block(sz, S)
    return out.to(torch.uint8)
