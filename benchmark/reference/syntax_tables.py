# Frozen copy of hevce_tpu/bitstream/syntax.py at commit 2c4bff8; its tables, scan orders, significance contexts and MPM list only (the writers are left out).
# Edit only to follow a change of what the benchmark compares.
"""HEVC syntax-element serialization for a monochrome intra slice.

Clean-room equivalents of the reference writers (reference src/HEVCe.c:939-1340):
split_cu_flag, part_mode, intra pmode with 3-entry MPM, rqt split, cbf,
last-significant-XY, significance map, greater1/greater2, sign bypass and
escape Golomb-Rice residual coding. Scan tables are generated programmatically
(CG-major diagonal / horizontal / vertical) instead of being embedded.
"""
import functools

import numpy as np

from benchmark.reference import cabac_tables as cb

PMODE_PLANAR, PMODE_DC, PMODE_HOR, PMODE_VER = 0, 1, 10, 26
SCAN_DIAG, SCAN_HOR, SCAN_VER = 0, 1, 2
CG = 4


# --- scan order generation ------------------------------------------------------

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


# --- small fixed tables ----------------------------------------------------------

# last-significant group index / base (H.265 9.3.4.2.3)
GROUP_INDEX = np.array([0, 1, 2, 3, 4, 4, 5, 5] + [6] * 4 + [7] * 4 + [8] * 8 + [9] * 8, np.int32)
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


def probable_pmodes(left: int, above: int):
    """3-entry MPM list (H.265 8.4.2; src/HEVCe.c:958-977)."""
    if left != above:
        third = (PMODE_PLANAR if (left != PMODE_PLANAR and above != PMODE_PLANAR)
                 else (PMODE_VER if left + above < 2 else PMODE_DC))
        return [left, above, third]
    if left > PMODE_DC:
        return [left, ((left + 29) % 32) + 2, ((left - 1) % 32) + 2]
    return [PMODE_PLANAR, PMODE_DC, PMODE_VER]
