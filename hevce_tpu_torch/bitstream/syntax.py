"""HEVC syntax-element serialization for a monochrome intra slice (numpy).

The tables: CG-major diagonal / horizontal / vertical scan orders, the
H.265 last-significant group index and group base, the last-XY context rows
and shifts, and the significance-flag context index (H.265 9.3.4.2;
reference src/HEVCe.c:1046-1150), which the wavefront rate model
(ops/fused_node._scan_consts) and the residual op-string generator
(ops/coef_ops) also read. The writers (reference src/HEVCe.c:939-1340):
split_cu_flag, part_mode, the intra pmode with its 3-entry MPM list, rqt
split, cbf, last-significant-XY, the significance map, greater1/greater2,
sign bypass and escape Golomb-Rice residual coding, and the three CU
serializers. A writer drives any object with CabacEncoder's encode_bin /
encode_bypass (bitstream/cabac), or ops/cabac_sim.OpRecorder.
"""
import functools

import numpy as np

from hevce_tpu_torch.bitstream import cabac as cb

PMODE_PLANAR, PMODE_DC, PMODE_HOR, PMODE_VER = 0, 1, 10, 26
SCAN_DIAG, SCAN_HOR, SCAN_VER = 0, 1, 2
CG = 4


def _diag_order(n):
    """anti-diagonal order over an n x n grid: d = y+x ascending, y descending."""
    out = []
    for d in range(2 * n - 1):
        for y in range(min(d, n - 1), -1, -1):
            x = d - y
            if x < n:
                out.append((y, x))
    return out


@functools.lru_cache(maxsize=None)
def scan_table(sz: int, scan_type: int) -> np.ndarray:
    """(sz*sz, 2) array of (y, x), CG-major: CGs ordered by scan_type, pixels
    within each 4x4 CG likewise."""
    ncg = sz // CG
    if scan_type == SCAN_DIAG:
        cg_order = _diag_order(ncg)
        in_order = _diag_order(CG)
    elif scan_type == SCAN_HOR:
        cg_order = [(y, x) for y in range(ncg) for x in range(ncg)]
        in_order = [(y, x) for y in range(CG) for x in range(CG)]
    else:
        cg_order = [(y, x) for x in range(ncg) for y in range(ncg)]
        in_order = [(y, x) for x in range(CG) for y in range(CG)]
    out = [(cy * CG + py, cx * CG + px)
           for (cy, cx) in cg_order for (py, px) in in_order]
    return np.array(out, np.int32)


def get_scan(sz: int, pmode: int):
    """mode-dependent scan selection (src/HEVCe.c:1127-1151)."""
    if sz <= 8:
        if abs(pmode - PMODE_VER) <= 4:
            return SCAN_HOR, scan_table(sz, SCAN_HOR)
        if abs(pmode - PMODE_HOR) <= 4:
            return SCAN_VER, scan_table(sz, SCAN_VER)
    return SCAN_DIAG, scan_table(sz, SCAN_DIAG)


# last-significant group index / base (H.265 9.3.4.2.3)
GROUP_INDEX = np.array([0, 1, 2, 3, 4, 4, 5, 5] + [6] * 4 + [7] * 4
                       + [8] * 8 + [9] * 8, np.int32)
MIN_IN_GROUP = np.array([0, 1, 2, 3, 4, 6, 8, 12, 16, 24], np.int32)

# last_x/last_y context row + shift per (is_chroma, sz//8)
_LAST_ADDR = ((0, 1, 2, 0, 3), (4, 4, 4, 0, 4))
_LAST_SFT = ((0, 1, 1, 0, 1), (0, 1, 2, 0, 3))

# 4x4 significance ctx offsets (H.265 table 9-43)
_SIG4 = ((0, 1, 4, 5), (2, 3, 4, 5), (6, 6, 8, 8), (7, 7, 8, 8))
_SIG_POS = (2, 1, 1, 0, 0, 0, 0)


def sig_ctx_idx(sz, is_chroma, scan_type, y, x, sig_ctx):
    """context index of a significance flag (src/HEVCe.c:1092-1122)."""
    base = 28 if is_chroma else 0
    if y == 0 and x == 0:
        return base
    if sz == 4:
        return base + _SIG4[y][x]
    base += 9
    if not is_chroma:
        if sz >= 16:
            base += 12
        if sz == 8 and scan_type != SCAN_DIAG:
            base += 6
        if (y >> 2) or (x >> 2):
            base += 3
    elif sz >= 16:
        base += 3
    if sig_ctx == 0:
        return base + _SIG_POS[(y & 3) + (x & 3)]
    if sig_ctx == 1:
        return base + _SIG_POS[(y & 3) << 1]
    if sig_ctx == 2:
        return base + _SIG_POS[(x & 3) << 1]
    return base + 2


# ----------------------------------------------------------- element writers

def put_split_cu_flag(enc, ctxs, sz, split, larger_than_left,
                      larger_than_above):
    if sz >= 16:
        idx = (cb.CTX_SPLIT_CU + int(bool(larger_than_left))
               + int(bool(larger_than_above)))
        enc.encode_bin(ctxs, idx, int(split))


def put_part_size(enc, ctxs, sz, part_nxn):
    if sz == 8:
        enc.encode_bin(ctxs, cb.CTX_PARTSIZE, 0 if part_nxn else 1)


def probable_pmodes(left: int, above: int):
    """3-entry MPM list (H.265 8.4.2; src/HEVCe.c:958-977)."""
    if left != above:
        third = (PMODE_PLANAR if (left != PMODE_PLANAR
                                  and above != PMODE_PLANAR)
                 else (PMODE_VER if left + above < 2 else PMODE_DC))
        return [left, above, third]
    if left > PMODE_DC:
        return [left, ((left + 29) % 32) + 2, ((left - 1) % 32) + 2]
    return [PMODE_PLANAR, PMODE_DC, PMODE_VER]


def put_y_pmode(enc, ctxs, pmodes, lefts, aboves):
    """luma pmode(s): lists of length 1 (2Nx2N) or 4 (NxN)
    (src/HEVCe.c:985-1018)."""
    mpms = [probable_pmodes(l, a) for l, a in zip(lefts, aboves)]
    hits = []
    for pm, mpm in zip(pmodes, mpms):
        hit = mpm.index(pm) if pm in mpm else -1
        hits.append(hit)
        enc.encode_bin(ctxs, cb.CTX_Y_PMODE, int(hit >= 0))
    for pm, mpm, hit in zip(pmodes, mpms, hits):
        if hit >= 0:
            enc.encode_bypass(int(hit > 0), 1)
            if hit > 0:
                enc.encode_bypass(hit - 1, 1)
        else:
            rem = pm - sum(1 for m in mpm if pm > m)
            enc.encode_bypass(rem, 5)


def put_uv_pmode(enc, ctxs):
    # chroma follows luma; monochrome output (src/HEVCe.c:1021-1023)
    enc.encode_bin(ctxs, cb.CTX_UV_PMODE, 0)


def put_split_tu_flag(enc, ctxs, sz, split):
    if sz in (32, 16, 8):
        idx = cb.CTX_SPLIT_TU + {32: 0, 16: 1, 8: 2}[sz]
        enc.encode_bin(ctxs, idx, int(split))


def put_qt_cbf(enc, ctxs, tu_depth_in_cu, is_chroma, cbf):
    if is_chroma:
        enc.encode_bin(ctxs, cb.CTX_UV_QT_CBF + tu_depth_in_cu, int(cbf))
    else:
        enc.encode_bin(ctxs, cb.CTX_Y_QT_CBF + (0 if tu_depth_in_cu else 1),
                       int(cbf))


def put_last_significant_xy(enc, ctxs, sz, is_chroma, scan_type, y, x):
    """(src/HEVCe.c:1046-1087)"""
    addr = _LAST_ADDR[is_chroma][sz // 8]
    sft = _LAST_SFT[is_chroma][sz // 8]
    ty, tx = (x, y) if scan_type == SCAN_VER else (y, x)
    gy, gx = int(GROUP_INDEX[ty]), int(GROUP_INDEX[tx])
    gmax = int(GROUP_INDEX[sz - 1])
    for i in range(gx):
        enc.encode_bin(ctxs, cb.CTX_LAST_X + 5 * addr + (i >> sft), 1)
    if gx < gmax:
        enc.encode_bin(ctxs, cb.CTX_LAST_X + 5 * addr + (gx >> sft), 0)
    for i in range(gy):
        enc.encode_bin(ctxs, cb.CTX_LAST_Y + 5 * addr + (i >> sft), 1)
    if gy < gmax:
        enc.encode_bin(ctxs, cb.CTX_LAST_Y + 5 * addr + (gy >> sft), 0)
    if gx > 3:
        tx -= int(MIN_IN_GROUP[gx])
        for i in range(((gx - 2) >> 1) - 1, -1, -1):
            enc.encode_bypass((tx >> i) & 1, 1)
    if gy > 3:
        ty -= int(MIN_IN_GROUP[gy])
        for i in range(((gy - 2) >> 1) - 1, -1, -1):
            enc.encode_bypass((ty >> i) & 1, 1)


def put_remain_exgolomb(enc, value, rparam):
    """escape value, Golomb-Rice with an Exp-Golomb tail
    (src/HEVCe.c:1154-1169)."""
    if value < (3 << rparam):
        length = value >> rparam
        enc.encode_bypass((1 << (length + 1)) - 2, length + 1)
        enc.encode_bypass(value % (1 << rparam), rparam)
    else:
        length = rparam
        value -= 3 << rparam
        while value >= (1 << length):
            value -= 1 << length
            length += 1
        pre = 4 + length - rparam
        enc.encode_bypass((1 << pre) - 2, pre)
        enc.encode_bypass(value, length)


def put_coef(enc, ctxs, sz, is_chroma, pmode, blk):
    """full residual coding of a quantized TU (src/HEVCe.c:1173-1269).

    blk: (sz, sz) integer array with at least one nonzero (cbf == 1)."""
    scan_type, scan = get_scan(sz, pmode)
    ncg = sz // CG

    vals = np.asarray(blk)[scan[:, 0], scan[:, 1]]
    nz = np.nonzero(vals)[0]
    i_last = int(nz[-1]) if len(nz) else 0
    sig_map = np.zeros((ncg, ncg), bool)
    yx_nz = scan[nz]
    sig_map[yx_nz[:, 0] // CG, yx_nz[:, 1] // CG] = True

    put_last_significant_xy(enc, ctxs, sz, is_chroma, scan_type,
                            int(scan[i_last, 0]), int(scan[i_last, 1]))

    sig_ctx = 0
    c1 = 1
    abs_nz = []
    signs = 0
    for i in range(i_last, -1, -1):
        y, x = int(scan[i, 0]), int(scan[i, 1])
        ycg, xcg = y >> 2, x >> 2
        sig_cg = bool(sig_map[ycg, xcg])
        v = int(blk[y][x])
        is_final = i == i_last
        first_cg = ycg == 0 and xcg == 0
        first_in_cg = (i & 15) == 0
        final_in_cg = (i & 15) == 15 or is_final

        if final_in_cg:
            right = xcg < ncg - 1 and bool(sig_map[ycg, xcg + 1])
            below = ycg < ncg - 1 and bool(sig_map[ycg + 1, xcg])
            sig_ctx = (int(below) << 1) | int(right)
            abs_nz = []
            signs = 0
            if not first_cg and not is_final:
                enc.encode_bin(ctxs, cb.CTX_SIG_MAP + int(sig_ctx != 0),
                               int(sig_cg))

        if not is_final and (first_cg or (sig_cg and (not first_in_cg
                                                      or abs_nz))):
            idx = sig_ctx_idx(sz, is_chroma, scan_type, y, x, sig_ctx)
            enc.encode_bin(ctxs, cb.CTX_SIG_SC + idx, int(v != 0))

        if v != 0:
            abs_nz.append(abs(v))
            signs = (signs << 1) | (v < 0)

        if first_in_cg and abs_nz:
            ctx_set = ((0 if not is_chroma else 4)
                       + (2 if (not is_chroma and not first_cg) else 0)
                       + (1 if c1 == 0 else 0))
            escape = len(abs_nz) > 8
            c2_flag = -1
            c1 = 1
            for a in abs_nz[:8]:
                enc.encode_bin(ctxs, cb.CTX_ONE_SC + 4 * ctx_set + c1,
                               int(a > 1))
                if a > 1:
                    c1 = 0
                    if c2_flag < 0:
                        c2_flag = int(a > 2)
                    else:
                        escape = True
                elif 0 < c1 < 3:
                    c1 += 1
            if c1 == 0 and c2_flag >= 0:
                enc.encode_bin(ctxs, cb.CTX_ABS_SC + ctx_set, c2_flag)
                escape = escape or bool(c2_flag)
            enc.encode_bypass(signs, len(abs_nz))
            if escape:
                first_coeff2, rparam = 3, 0
                for j, a in enumerate(abs_nz):
                    esc = a - (first_coeff2 if j < 8 else 1)
                    if esc >= 0:
                        put_remain_exgolomb(enc, esc, rparam)
                        if a > (3 << rparam):
                            rparam = min(rparam + 1, 4)
                    if a >= 2:
                        first_coeff2 = 2


# ------------------------------------- CU-level serializers (src/HEVCe.c:1272-1340)

def put_cu_2nx2n(enc, ctxs, sz, pmode, pmode_left, pmode_above, blk):
    """part2Nx2N, single TU."""
    cbf = bool(np.any(np.asarray(blk)[:sz, :sz]))
    put_part_size(enc, ctxs, sz, False)
    put_y_pmode(enc, ctxs, [pmode], [pmode_left], [pmode_above])
    put_uv_pmode(enc, ctxs)
    put_split_tu_flag(enc, ctxs, sz, False)
    put_qt_cbf(enc, ctxs, 0, True, 0)
    put_qt_cbf(enc, ctxs, 0, True, 0)
    put_qt_cbf(enc, ctxs, 0, False, cbf)
    if cbf:
        put_coef(enc, ctxs, sz, False, pmode, blk)


def put_cu_2nx2n_tusplit(enc, ctxs, sz, pmode, pmode_left, pmode_above,
                         sub_blks):
    """part2Nx2N, split into 4 TUs."""
    put_part_size(enc, ctxs, sz, False)
    put_y_pmode(enc, ctxs, [pmode], [pmode_left], [pmode_above])
    put_uv_pmode(enc, ctxs)
    put_split_tu_flag(enc, ctxs, sz, True)
    put_qt_cbf(enc, ctxs, 0, True, 0)
    put_qt_cbf(enc, ctxs, 0, True, 0)
    h = sz // 2
    for sub in sub_blks:
        cbf = bool(np.any(np.asarray(sub)[:h, :h]))
        put_qt_cbf(enc, ctxs, 1, False, cbf)
        if cbf:
            put_coef(enc, ctxs, h, False, pmode, sub)


def put_cu_nxn(enc, ctxs, sz, pmodes, lefts, aboves, sub_blks):
    """partNxN (8x8 CU only): 4 PUs with their own modes."""
    put_part_size(enc, ctxs, sz, True)
    put_y_pmode(enc, ctxs, pmodes, lefts, aboves)
    put_uv_pmode(enc, ctxs)
    put_qt_cbf(enc, ctxs, 0, True, 0)
    put_qt_cbf(enc, ctxs, 0, True, 0)
    h = sz // 2
    for pm, sub in zip(pmodes, sub_blks):
        cbf = bool(np.any(np.asarray(sub)[:h, :h]))
        put_qt_cbf(enc, ctxs, 1, False, cbf)
        if cbf:
            put_coef(enc, ctxs, h, False, pm, sub)
