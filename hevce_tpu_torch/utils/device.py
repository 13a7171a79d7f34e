"""Device selection for the port's entry points, and caches per device."""
import functools

import torch

# NVIDIA H100 SXM peaks (data sheet), for the bounds the tools state:
# 3.35 TB/s of HBM; int32 arithmetic on the CUDA cores, 64 lanes per SM
# against FP32's 128, so half of the 67 TFLOP/s FP32 rate (a multiply-add
# counts as 2 ops)
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12 / 2


def resolve(device=None) -> torch.device:
    """None means the card. Without CUDA that raises: only an explicit
    device="cpu" runs an entry point on the CPU.

    Also pins the float policy. The codec is integer math; its three float
    products (angular prediction, top-K compress, CG nonzero count) are exact
    only in full float32, so TF32 stays off for matmuls and convolutions."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dev


def normal(device) -> torch.device:
    """`device` as a torch.device with its index: "cuda" names the current
    CUDA device, so "cuda" and "cuda:0" are one key of a cache (a tensor's
    .device always carries its index)."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def cached_per_device(fn):
    """functools.lru_cache of fn(*args, device), keyed on normal(device):
    a table built for a device once, whichever way the device is named.
    The cache's cache_info / cache_clear are the wrapper's."""
    cached = functools.lru_cache(maxsize=None)(fn)

    @functools.wraps(fn)
    def call(*args):
        return cached(*args[:-1], normal(args[-1]))
    call.cache_info, call.cache_clear = cached.cache_info, cached.cache_clear
    return call
