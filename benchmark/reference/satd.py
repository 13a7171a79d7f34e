# Frozen copy of hevce_tpu_torch/ops/satd.py at commit 2c4bff8; imports point at the frozen copies.
# Edit only to follow a change of what the benchmark compares.
"""SATD — sum of absolute Walsh-Hadamard-transformed differences.

The metric of the fast mode's RMD candidate preselection
(models/wavefront._eval_node_rmd). Unnormalized (no >> log2(sz)):
preselection only compares SATDs of the same block size.

Exact in float64: |stage1| <= 255 * 32, |stage2| <= 255 * 32^2, and the
absolute-value sum over sz^2 terms <= 2.7e8 < 2^31.
"""
import functools

import numpy as np
import torch

from benchmark.reference import tables as _device


@functools.lru_cache(maxsize=None)
def _hadamard_np(sz: int) -> np.ndarray:
    """Sylvester-construction Walsh-Hadamard matrix (sz power of two),
    entries +-1, symmetric."""
    h = np.array([[1]], np.int32)
    while h.shape[0] < sz:
        h = np.block([[h, h], [h, -h]]).astype(np.int32)
    return h


@_device.cached_per_device
def _hadamard(sz: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_hadamard_np(sz).astype(np.float64)).to(device)


def block_satd(sz: int, resid: torch.Tensor) -> torch.Tensor:
    """(..., sz, sz) integer residual (|r| <= 255) -> (...,) int32 SATD:
    sum |H @ r @ H|."""
    h = _hadamard(sz, resid.device)
    out = torch.matmul(torch.matmul(h, resid.to(torch.float64)), h)
    return out.abs().sum((-1, -2)).to(torch.int32)
