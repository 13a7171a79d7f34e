"""Device selection for the port's entry points."""
import torch


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
