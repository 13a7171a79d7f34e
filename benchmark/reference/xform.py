# Frozen copy of hevce_tpu_torch/ops/xform.py at commit 2c4bff8; imports point at the frozen copies.
# Edit only to follow a change of what the benchmark compares.
"""HEVC core transforms (DST4 / DCT8 / DCT16 / DCT32), forward and inverse.

Bit-exact int32 semantics of the reference separable transform
(reference src/HEVCe.c:469-516):

  forward:  tmp = (M  @ x   + 2^(a-1)) >> a          a = log2(sz) - 1
            y   = (tmp @ M^T + 2^(b-1)) >> b         b = a + 7
  inverse:  tmp = clip16((M^T @ x   + 2^6 ) >> 7)
            y   = clip16((tmp @ M   + 2^11) >> 12)

CUDA has no int32 matmul, so the products run in float64, exact below 2^53:
stage sums reach 2^21 (forward 1), 2^30 (forward 2) and 2^27 (inverse).
float32 would NOT be exact (24-bit mantissa).

DTYPE is the dtype of the products: float64, exact. The benchmark's
lower-precision controls set another (search.transform_dtype): int16, the
integer type below the int32 that the configurations state (each stage's
sum wraps as a 16-bit accumulator's would), or a float type, in which the
products are rounded as that type rounds them.
"""
import torch

from benchmark.reference import constants as C
from benchmark.reference import tables as params

DTYPE = torch.float64


def _rshift_round(x: torch.Tensor, sft: int) -> torch.Tensor:
    # matches C `(x + (1<<sft>>1)) >> sft` with arithmetic shift
    return (x + (1 << sft >> 1)) >> sft


def _clip16(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x, C.COEF_MIN, C.COEF_MAX)


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """integer product of integer-valued DTYPE operands -> int32 (exact
    in float64; under int16 the exact sum wrapped to 16 bits)."""
    if DTYPE == torch.int16:
        s = torch.matmul(a.to(torch.float64), b.to(torch.float64))
        return ((s.to(torch.int64) + 2 ** 15) % 2 ** 16 - 2 ** 15).to(
            torch.int32)
    return torch.matmul(a, b).to(torch.int32)


def _table(sz, device):
    return params.transform(sz, DTYPE if DTYPE.is_floating_point
                            else torch.float64, device)


def forward_transform(sz: int, residual: torch.Tensor) -> torch.Tensor:
    """Forward DST/DCT of residual blocks (..., sz, sz) (|r| <= 255) ->
    int32 coefficients."""
    m = _table(sz, residual.device)
    a = int(C.FWD_SHIFT_A[sz])
    tmp = _rshift_round(_mm(m, residual.to(DTYPE)), a)
    out = _mm(tmp.to(DTYPE), m.T)
    return _rshift_round(out, a + 7)


def inverse_transform(sz: int, coef: torch.Tensor) -> torch.Tensor:
    """Inverse DST/DCT of coefficient blocks (..., sz, sz), |c| <= 32767.
    Returns int16 (both stages are clip16-bounded)."""
    m = _table(sz, coef.device)
    tmp = _clip16(_rshift_round(_mm(m.T, coef.to(DTYPE)), 7))
    out = _mm(tmp.to(DTYPE), m)
    return _clip16(_rshift_round(out, 12)).to(torch.int16)
