# Frozen copy of hevce_tpu_torch/ops/quant.py at commit 2c4bff8; imports point at the frozen copies.
# Edit only to follow a change of what the benchmark compares.
"""Simplified RDOQ quantization + dequantization, bit-exact int32.

Reference: quantize / estimateCoeffRate / deQuantize at src/HEVCe.c:526-615.
The per-coefficient 3-candidate level search and the per-CG kill rule are
data-parallel closed-form selections over (..., sz, sz) blocks.
"""
import torch

from benchmark.reference import constants as C
from benchmark.reference.rdcost import calc_rd_cost

I32_MAX = int(C.I32_MAX)


def estimate_coeff_rate(level: torch.Tensor) -> torch.Tensor:
    """Vectorized estimateCoeffRate (src/HEVCe.c:526-535).

    For level >= 6 the reference's subtract-powers loop computes
    i = floor(log2(level-6+1)); rate = 92000 + ((4 + 2*i) << 15). The
    int->f32 conversion is exact below 2^24 (levels <= 32767), so the biased
    float32 exponent IS floor(log2)."""
    lvl = level.to(torch.int32)
    small = torch.full_like(lvl, int(C.LEVEL_RATE_TABLE[5]))
    for k in range(5):
        small = torch.where(lvl == k, int(C.LEVEL_RATE_TABLE[k]), small)
    vp1 = torch.clamp(lvl - 5, min=1).to(torch.float32)
    i = (vp1.view(torch.int32) >> 23) - 127
    big = 92000 + ((4 + 2 * i) << 15)
    return torch.where(lvl < 6, small, big)


def quantize(sz: int, qpd6: int, coef: torch.Tensor) -> torch.Tensor:
    """RDOQ-quantize coefficient blocks (..., sz, sz) int32 -> int16 levels."""
    dist_sft = int(C.QUANT_DIST_SHIFT[sz])
    sft = int(C.QUANT_LEVEL_SHIFT[sz]) + qpd6
    add = 1 << sft >> 1
    max_dlevel = I32_MAX - add
    thr = 9 << sft >> 2

    src = coef.to(torch.int32)
    absval = src.abs()
    dlevel = torch.where(absval > 0x1FFFF, max_dlevel,
                         torch.clamp((absval & 0x1FFFF) << 14, max=max_dlevel))
    level0 = torch.clamp((dlevel + add) >> sft, C.COEF_MIN, C.COEF_MAX)

    def cost_of(lv):
        # lv <= level0 <= I32_MAX >> sft, so lv << sft cannot overflow
        dist1 = (dlevel - (lv << sft)).abs() >> dist_sft
        dist = torch.where(dist1 < 46340, dist1 * dist1, I32_MAX) >> 7
        return calc_rd_cost(qpd6, dist, estimate_coeff_rate(lv))

    # candidates level0, level0-1, level0-2 evaluated high->low with strict <
    # (src/HEVCe.c:571-580): ties keep the higher level.
    best_l = level0
    best_c = cost_of(level0)
    for d in (1, 2):
        lv = level0 - d
        valid = level0 >= d
        cst = cost_of(torch.clamp(lv, min=0))
        take = valid & (cst < best_c)
        best_l = torch.where(take, lv, best_l)
        best_c = torch.where(take, cst, best_c)

    signed = torch.where(src < 0, -best_l, best_l)

    # per-4x4-CG kill rule (src/HEVCe.c:555, :585-592); a CG sum is at most
    # 16 * thr < 2^29
    ncg = sz // C.CG_SZ
    dl = torch.clamp(dlevel, max=thr)
    shape = dl.shape[:-2] + (ncg, C.CG_SZ, ncg, C.CG_SZ)
    cg_sum = dl.reshape(shape).sum((-3, -1), dtype=torch.int32)
    keep = cg_sum >= thr
    keep_full = keep.repeat_interleave(C.CG_SZ, -1).repeat_interleave(
        C.CG_SZ, -2)
    return torch.where(keep_full, signed, 0).to(torch.int16)


def dequantize(sz: int, qpd6: int, levels: torch.Tensor) -> torch.Tensor:
    """dst = clip16(level << (Q_SHIFT_TABLE[sz] + qpd6)) (src/HEVCe.c:600-615),
    written as a multiply so negative levels need no left shift
    (|level| << 9 < 2^24: no overflow). int16 out."""
    q_sft = int(C.DEQUANT_SHIFT[sz]) + qpd6
    return torch.clamp(levels.to(torch.int32) * (1 << q_sft),
                       C.COEF_MIN, C.COEF_MAX).to(torch.int16)
