"""Exact CABAC rate scan: kernel K2 and its plain PyTorch version.

The counterpart of hevce_tpu/ops/cabac_pallas.py. advance_rates() advances
many independent coder lanes through their packed op strings (format of
ops/cabac_sim) and returns the final coder scalars; the rate of a lane is
bit_len(final) - bit_len(initial). Every rate the encoder computes goes
through it (ops/coef_ops.put_coef_rates, parallel/lockstep's node step).

On CUDA tensors it launches the hand-written kernel csrc/cabac_scan.cu (the
port of cabac_pallas.py::_kernel); on CPU tensors it runs scan_plain(), the
op-by-op simulation of ops/cabac_sim. There is no fallback between the two:
a CUDA tensor launches the kernel or raises.
"""
import ctypes
import pathlib
import threading

import numpy as np
import torch

from hevce_tpu_torch.bitstream import cabac as cb
from hevce_tpu_torch.ops import cabac_sim as sim
from hevce_tpu_torch.runtime import build as _build
from hevce_tpu_torch.utils import device as _device

SOURCE = pathlib.Path(__file__).resolve().parent.parent / "csrc" / "cabac_scan.cu"
LIB_NAME = "libhevce_k2.so"
MAX_P = 256           # palette slots a context op can address (8-bit index)

LAUNCHES = 0          # kernel launches made by advance_rates (CUDA route)

_lock = threading.Lock()
_lib = None


def scan_plain(state, ops, nops):
    """The plain PyTorch version of K2 (= cabac_sim.simulate_chunked).
    Returns the final state, ctxs included."""
    return sim.simulate_chunked(state, ops, nops)


# ------------------------------------------------------------------ kernel

@_device.cached_per_device
def kernel_tables(device: torch.device):
    """The int32 table tensor K2 takes: the 64x4 LPS range table packed as
    64 words, byte q of word s = LPS_TABLE[s, q] (every value fits a byte),
    then the 128-entry LPS next-state table."""
    lps = cb.LPS_TABLE.astype(np.uint32)
    packed = lps[:, 0] | lps[:, 1] << 8 | lps[:, 2] << 16 | lps[:, 3] << 24
    return torch.as_tensor(np.concatenate(
        [packed.view(np.int32), cb.NEXT_STATE_LPS.astype(np.int32)]),
        device=device)


def build(force: bool = False):
    """Compile csrc/cabac_scan.cu for sm_90a (once, or again with
    force=True; see runtime/build). Returns (library path, compiler output,
    which holds ptxas's register and shared-memory report)."""
    return _build.build(SOURCE, LIB_NAME, _build.nvcc_cmd(SOURCE), force)


def load():
    """The built library, its launch function typed."""
    global _lib
    with _lock:
        if _lib is None:
            path, _ = build()
            lib = ctypes.CDLL(str(path))
            lib.hevce_k2_launch.restype = ctypes.c_int
            lib.hevce_k2_launch.argtypes = (
                [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
                + [ctypes.c_void_p] * 3 + [ctypes.c_int]
                + [ctypes.c_void_p] * 4)
            _lib = lib
        return _lib


def launch(st_in, ctxs, ops, nops, ctx_out=None):
    """Launch K2 on the current stream: st_in (7, lanes) int32 coder
    scalars, ctxs (lanes, P), ops (lanes, L), nops (lanes,), all on one
    CUDA device and checked by the caller; ctx_out (lanes, P) receives the
    final palette, or None. Returns st_out (7, lanes). Not counted in
    LAUNCHES: advance_rates counts its own launches."""
    lanes, L = ops.shape
    st_out = torch.empty_like(st_in)
    tables = kernel_tables(ops.device)
    with torch.cuda.device(ops.device):
        rc = load().hevce_k2_launch(
            ops.data_ptr(), lanes, L, nops.data_ptr(), st_in.data_ptr(),
            ctxs.data_ptr(), ctxs.shape[1], tables.data_ptr(),
            st_out.data_ptr(),
            None if ctx_out is None else ctx_out.data_ptr(),
            torch.cuda.current_stream(ops.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"K2 launch failed: cudaError {rc}")
    return st_out


def _check(state, ops, nops):
    lanes = ops.shape[0] if ops.dim() == 2 else -1
    ctxs = state["ctxs"]
    tensors = [ops, nops, ctxs] + [state[f] for f in sim.FIELDS]
    if any(t.device != ops.device for t in tensors):
        raise ValueError("K2 takes all of state, ops and nops on one device")
    if any(t.dtype != torch.int32 for t in tensors):
        raise TypeError("K2 takes int32 state, ops and nops, got "
                        f"{sorted({str(t.dtype) for t in tensors})}")
    if (lanes < 0 or tuple(nops.shape) != (lanes,) or ctxs.dim() != 2
            or ctxs.shape[0] != lanes or not 1 <= ctxs.shape[1] <= MAX_P
            or any(tuple(state[f].shape) != (lanes,) for f in sim.FIELDS)):
        raise ValueError(
            f"shapes ops {tuple(ops.shape)} / nops {tuple(nops.shape)} / "
            f"ctxs {tuple(ctxs.shape)} do not fit K2 (lanes, L) / (lanes,) "
            f"/ (lanes, P <= {MAX_P})")
    if not (ops.is_contiguous() and ctxs.is_contiguous()
            and nops.is_contiguous()):
        raise ValueError("K2 takes contiguous ops, nops and ctxs")


def advance_rates(state, ops, nops, want_ctxs: bool = False):
    """K2 on CUDA tensors, scan_plain on CPU tensors.

    state: dict of the 7 (lanes,) int32 coder scalars (cabac_sim.FIELDS)
    and ctxs (lanes, P) int32; ops: (lanes, L) int32, nop-padded past each
    lane's count; nops: (lanes,) int32 op counts. Returns the advanced state
    dict: the 7 scalars, plus ctxs from the plain version, and from the
    kernel only when want_ctxs=True (the encoder needs only the scalars)."""
    global LAUNCHES
    _check(state, ops, nops)
    if ops.device.type == "cpu":
        return scan_plain(state, ops, nops)
    if ops.device.type != "cuda":
        raise ValueError(f"K2 runs on CUDA or CPU tensors, not {ops.device}")
    st_in = torch.stack([state[f] for f in sim.FIELDS])
    ctx_out = torch.empty_like(state["ctxs"]) if want_ctxs else None
    if ops.shape[0] == 0:
        st_out = torch.empty_like(st_in)
    else:
        st_out = launch(st_in, state["ctxs"], ops, nops, ctx_out)
        LAUNCHES += 1
    out = {f: st_out[i] for i, f in enumerate(sim.FIELDS)}
    if want_ctxs:
        out["ctxs"] = ctx_out
    return out
