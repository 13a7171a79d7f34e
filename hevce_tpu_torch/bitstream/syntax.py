"""Coefficient scan tables and the last-XY group index (numpy).

The part of the JAX package's bitstream/syntax.py that the wavefront rate
model needs (models/wavefront._scan_consts): CG-major diagonal / horizontal /
vertical scan orders and the H.265 last-significant group index
(H.265 9.3.4.2.3; reference src/HEVCe.c:1046-1150).
"""
import functools

import numpy as np

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


# last-significant group index (H.265 9.3.4.2.3)
GROUP_INDEX = np.array([0, 1, 2, 3, 4, 4, 5, 5] + [6] * 4 + [7] * 4
                       + [8] * 8 + [9] * 8, np.int32)
