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
"""
import torch

from hevce_tpu_torch.ops import constants as C
from hevce_tpu_torch import params


def _rshift_round(x: torch.Tensor, sft: int) -> torch.Tensor:
    # matches C `(x + (1<<sft>>1)) >> sft` with arithmetic shift
    return (x + (1 << sft >> 1)) >> sft


def _clip16(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x, C.COEF_MIN, C.COEF_MAX)


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """exact integer product of integer-valued float64 operands -> int32."""
    return torch.matmul(a, b).to(torch.int32)


def forward_transform(sz: int, residual: torch.Tensor) -> torch.Tensor:
    """Forward DST/DCT of residual blocks (..., sz, sz) (|r| <= 255) ->
    int32 coefficients."""
    m = params.tables(residual.device)["transform_f64"][sz]
    a = int(C.FWD_SHIFT_A[sz])
    tmp = _rshift_round(_mm(m, residual.to(torch.float64)), a)
    out = _mm(tmp.to(torch.float64), m.T)
    return _rshift_round(out, a + 7)


def inverse_transform(sz: int, coef: torch.Tensor) -> torch.Tensor:
    """Inverse DST/DCT of coefficient blocks (..., sz, sz), |c| <= 32767.
    Returns int16 (both stages are clip16-bounded)."""
    m = params.tables(coef.device)["transform_f64"][sz]
    tmp = _clip16(_rshift_round(_mm(m.T, coef.to(torch.float64)), 7))
    out = _mm(tmp.to(torch.float64), m)
    return _clip16(_rshift_round(out, 12)).to(torch.int16)
