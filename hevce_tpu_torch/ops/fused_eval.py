"""Fused CU-candidate evaluation: kernel K1 and its plain PyTorch version.

One pass per candidate block: residual -> forward DST/DCT -> RDOQ quantize
-> per-CG kill -> dequant -> inverse transform -> reconstruct -> SSE
(reference per-candidate loop src/HEVCe.c:1422-1448).

pipeline_sse() is the wrapper every candidate evaluation goes through
(models/cu_eval.pipeline_sse). On CUDA tensors it launches the hand-written
kernel csrc/fused_eval.cu (the port of hevce_tpu/ops/fused_eval.py::
_make_kernel); on CPU tensors it runs pipeline_sse_plain(), the op pipeline
of ops/xform + ops/quant + ops/rdcost. There is no fallback between the two:
a CUDA tensor launches the kernel or raises.
"""
import ctypes
import pathlib
import threading

import numpy as np
import torch

from hevce_tpu_torch.ops import constants as C
from hevce_tpu_torch.ops import quant, rdcost, xform
from hevce_tpu_torch.runtime import build as _build

SOURCE = pathlib.Path(__file__).resolve().parent.parent / "csrc" / "fused_eval.cu"
LIB_NAME = "libhevce_k1.so"
SIZES = (4, 8, 16, 32)

LAUNCHES = 0          # kernel launches made by pipeline_sse (CUDA route)

_lock = threading.Lock()
_lib = None
_init_devices = set()


# ------------------------------------------------------------ plain version

def pipeline_plain(sz: int, qpd6: int, pred, blk):
    """residual -> fwd transform -> RDOQ -> dequant -> inv transform -> recon.
    pred (..., M, sz, sz) u8, blk (..., sz, sz) u8 -> (q int16, recon u8)."""
    resid = blk[..., None, :, :].to(torch.int16) - pred.to(torch.int16)
    coef = xform.forward_transform(sz, resid)
    q = quant.quantize(sz, qpd6, coef)
    dq = quant.dequantize(sz, qpd6, q)
    r = xform.inverse_transform(sz, dq)
    recon = torch.clamp(r.to(torch.int32) + pred, 0, 255).to(torch.uint8)
    return q, recon


def pipeline_sse_plain(sz: int, qpd6: int, pred, blk):
    """The plain PyTorch version of K1: (q int16 (..., M, sz, sz),
    recon uint8 (..., M, sz, sz), sse int32 (..., M))."""
    q, recon = pipeline_plain(sz, qpd6, pred, blk)
    return q, recon, rdcost.block_sse(blk[..., None, :, :], recon)


# ------------------------------------------------------------------ kernel

def build(force: bool = False):
    """Compile csrc/fused_eval.cu for sm_90a (once, or again with
    force=True; see runtime/build). Returns (library path, compiler output,
    which holds ptxas's register and shared-memory report)."""
    return _build.build(SOURCE, LIB_NAME, [
        _build.nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
        "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
        "-Xptxas", "-v", str(SOURCE)], force)


def _load():
    global _lib
    with _lock:
        if _lib is None:
            path, _ = build()
            lib = ctypes.CDLL(str(path))
            lib.hevce_k1_init.restype = ctypes.c_int
            lib.hevce_k1_init.argtypes = [ctypes.c_void_p] * 5
            lib.hevce_k1_launch.restype = ctypes.c_int
            lib.hevce_k1_launch.argtypes = (
                [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                 ctypes.c_longlong] + [ctypes.c_int] * 8
                + [ctypes.c_void_p] * 4)
            _lib = lib
        return _lib


def _init_device(lib, device: torch.device):
    """upload the constant tables to this device's constant memory once."""
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    with _lock:
        if idx in _init_devices:
            return
        arrs = [np.ascontiguousarray(C.TRANSFORM_MAT[sz], np.int32)
                for sz in SIZES]
        arrs.append(np.ascontiguousarray(C.LEVEL_RATE_TABLE[:6], np.int32))
        with torch.cuda.device(idx):
            rc = lib.hevce_k1_init(*(a.ctypes.data for a in arrs))
        if rc != 0:
            raise RuntimeError(f"K1 constant upload failed: cudaError {rc}")
        _init_devices.add(idx)


def _check(sz, qpd6, pred, blk):
    if sz not in SIZES or not 0 <= qpd6 <= 4:
        raise ValueError(f"unsupported sz={sz} qpd6={qpd6}")
    if pred.device != blk.device:
        raise ValueError(f"pred on {pred.device}, blk on {blk.device}")
    if pred.dtype != torch.uint8 or blk.dtype != torch.uint8:
        raise TypeError(f"K1 takes uint8 pred/blk, got {pred.dtype}/"
                        f"{blk.dtype}")
    if (pred.dim() < 3 or tuple(pred.shape[-2:]) != (sz, sz)
            or tuple(blk.shape) != tuple(pred.shape[:-3]) + (sz, sz)):
        raise ValueError(f"shapes pred {tuple(pred.shape)} / blk "
                         f"{tuple(blk.shape)} do not fit sz={sz}")
    if not (pred.is_contiguous() and blk.is_contiguous()):
        raise ValueError("K1 takes contiguous pred/blk")


def pipeline_sse(sz: int, qpd6: int, pred, blk):
    """K1 on CUDA tensors, pipeline_sse_plain on CPU tensors.

    pred (..., M, sz, sz) uint8 candidate predictions, blk (..., sz, sz)
    uint8 originals. Returns (q int16 (..., M, sz, sz), recon uint8
    (..., M, sz, sz), sse int32 (..., M)), bit-identical either way."""
    global LAUNCHES
    if pred.device.type == "cpu" and blk.device.type == "cpu":
        return pipeline_sse_plain(sz, qpd6, pred, blk)
    _check(sz, qpd6, pred, blk)
    if pred.device.type != "cuda":
        raise ValueError(f"K1 runs on CUDA or CPU tensors, not {pred.device}")
    lib = _load()
    _init_device(lib, pred.device)
    q = torch.empty(pred.shape, dtype=torch.int16, device=pred.device)
    rec = torch.empty_like(pred)
    sse = torch.empty(pred.shape[:-2], dtype=torch.int32, device=pred.device)
    n_cand = pred.numel() // (sz * sz)
    if n_cand == 0:
        return q, rec, sse
    stream = torch.cuda.current_stream(pred.device).cuda_stream
    rc = lib.hevce_k1_launch(
        sz, pred.data_ptr(), blk.data_ptr(), n_cand, int(pred.shape[-3]),
        int(C.FWD_SHIFT_A[sz]), int(C.QUANT_DIST_SHIFT[sz]),
        int(C.QUANT_LEVEL_SHIFT[sz]), int(C.DEQUANT_SHIFT[sz]), qpd6,
        int(C.RDCOST_WEIGHT_DIST[qpd6]), int(C.RDCOST_WEIGHT_BITS[qpd6]),
        q.data_ptr(), rec.data_ptr(), sse.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"K1 launch failed: cudaError {rc}")
    LAUNCHES += 1
    return q, rec, sse
