"""RD cost and distortion, with the reference's int32 saturation semantics
(reference src/HEVCe.c:165-185)."""
import torch

from hevce_tpu_torch.ops import constants as C

I32_MAX = int(C.I32_MAX)


def calc_rd_cost(qpd6: int, dist: torch.Tensor, bits) -> torch.Tensor:
    """weighted cost = w_dist*dist + w_bits*bits with overflow saturation.
    The products in the untaken branches may wrap; they are discarded."""
    w1 = int(C.RDCOST_WEIGHT_DIST[qpd6])
    w2 = int(C.RDCOST_WEIGHT_BITS[qpd6])
    dist = dist.to(torch.int32)
    bits = torch.as_tensor(bits, dtype=torch.int32, device=dist.device)
    cost1 = torch.where(I32_MAX // w1 <= dist, I32_MAX, w1 * dist)
    cost2 = torch.where(I32_MAX // w2 <= bits, I32_MAX, w2 * bits)
    return torch.where(I32_MAX - cost1 <= cost2, I32_MAX, cost1 + cost2)


def block_sse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Sum of squared error over the last two axes (src/HEVCe.c:165-174).
    At most 255^2 * 1024 < 2^26, so the int32 result is exact."""
    d = a.to(torch.int32) - b.to(torch.int32)
    return (d * d).sum((-1, -2), dtype=torch.int32)
