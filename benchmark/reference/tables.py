"""The reference's constant tables as device tensors, built once per device.

A plain stand-in for the port's params.tables and utils/device's per-device
cache: the transform matrices (in the dtype the transform products run in)
and the angular prediction matrices, from the frozen numpy tables beside
this file.
"""
import functools

import numpy as np
import torch

from benchmark.reference import constants as C

SIZES = (4, 8, 16, 32)


def normal(device) -> torch.device:
    """`device` with its index ("cuda" -> "cuda:<current>")."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def cached_per_device(fn):
    """functools.lru_cache of fn(*args, device), keyed on normal(device)."""
    cached = functools.lru_cache(maxsize=None)(fn)

    @functools.wraps(fn)
    def call(*args):
        return cached(*args[:-1], normal(args[-1]))
    call.cache_clear = cached.cache_clear
    return call


@cached_per_device
def transform(sz: int, dtype: torch.dtype, device) -> torch.Tensor:
    """TRANSFORM_MAT[sz] as `dtype` on `device`."""
    return torch.as_tensor(C.TRANSFORM_MAT[sz], dtype=dtype, device=device)


@cached_per_device
def tables(device) -> dict:
    """the angular prediction matrices on `device` (the keys the frozen
    ops/intra reads)."""
    from benchmark.reference import intra

    dev = normal(device)
    ang = {sz: intra._angular_matrix(sz) for sz in SIZES}

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float32,
                               device=dev)
    return {"angular": {sz: t(w) for sz, w in ang.items()},
            "angular_t": {sz: t(np.asarray(w, np.float32).reshape(
                -1, w.shape[-1]).T) for sz, w in ang.items()}}
