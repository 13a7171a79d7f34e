"""Probe kernels P1-P3 and their plain PyTorch versions.

The counterparts of the three Pallas probes of tools/pallas_probe.py, with
the kernels written by hand in csrc/probes.cu:

  P1 add_one   x += 1 on an (8, 128) int32 buffer: the cost of one launch
  P2 int8_mm   int8 x int8 -> int32 product on the tensor cores (mma.sync)
  P3 fused4    the 4x4 candidate eval (residual -> DST4 -> RDOQ -> dequant
               -> inverse -> recon -> per-mode SSE), one warp a tile of 16
               candidate blocks, its transform stages as mma.sync products
               of base-256 digits (u8 low, s8 high)

Each wrapper launches its kernel for CUDA tensors and counts the launch in
LAUNCHES[name]; CPU tensors take the plain version. There is no fallback
between the two: a CUDA tensor launches the kernel or raises. The probes
are measurement tools (tools/cuda_probe.py); no encode path calls them.
"""
import ctypes
import functools
import pathlib
import shutil
import subprocess
import threading

import numpy as np
import torch

from hevce_tpu_torch.ops import constants as C
from hevce_tpu_torch.ops import quant, rdcost, xform
from hevce_tpu_torch.runtime import build as _build

SOURCE = pathlib.Path(__file__).resolve().parent.parent / "csrc" / "probes.cu"
HEADER = SOURCE.parent / "mma_s8.cuh"
LIB_NAME = "libhevce_probes.so"
SZ = 4                # P3's block size
NN = SZ * SZ
# the rows of P3's stage matrices in the kernel's order: after a stage's two
# m16n8k16 products thread (g, t) holds output columns 2t, 2t+1, 8+2t, 9+2t,
# and P3_ORDER[n] is the coefficient (raster index) computed in column n,
# so those are coefficients 4t .. 4t+3, the next stage's A fragment
P3_ORDER = np.array([0, 1, 4, 5, 8, 9, 12, 13, 2, 3, 6, 7, 10, 11, 14, 15])

# kernel launches made by the wrappers (CUDA route); a captured CUDA graph
# counts its launches once, at capture
LAUNCHES = {"add_one": 0, "int8_mm": 0, "fused4": 0}

_lock = threading.Lock()
_lib = None
_kron_cache = {}


# ------------------------------------------------------ Kronecker operators

@functools.lru_cache(maxsize=None)
def kron_stage(sz: int):
    """(sz^2, sz^2) int8 constants of the forward stages as operators on
    row-major flattened blocks x: stage 1 out[(i,j)] = sum_k M[i,k] x[(k,j)]
    (M @ x), stage 2 out[(i,j)] = sum_l t[(i,l)] M[j,l] (t @ M^T)."""
    m = C.TRANSFORM_MAT[sz]
    k1 = np.zeros((sz * sz, sz * sz), np.int64)
    k2 = np.zeros((sz * sz, sz * sz), np.int64)
    for i in range(sz):
        for j in range(sz):
            for k in range(sz):
                k1[i * sz + j, k * sz + j] = m[i, k]
                k2[i * sz + j, i * sz + k] = m[j, k]
    return k1.astype(np.int8), k2.astype(np.int8)


@functools.lru_cache(maxsize=None)
def kron_inv(sz: int):
    """the inverse stages likewise: stage 1 out[(i,j)] = sum_k M[k,i]
    x[(k,j)] (M^T @ x), stage 2 out[(i,j)] = sum_l t[(i,l)] M[l,j] (t @ M)."""
    m = C.TRANSFORM_MAT[sz]
    a = np.zeros((sz * sz, sz * sz), np.int64)
    b = np.zeros((sz * sz, sz * sz), np.int64)
    for i in range(sz):
        for j in range(sz):
            for k in range(sz):
                a[i * sz + j, k * sz + j] = m[k, i]
                b[i * sz + j, i * sz + k] = m[k, j]
    return a.astype(np.int8), b.astype(np.int8)


def p3_stage_matrices():
    """P3's five stage matrices as the kernel reads them: (5, 16, 16) int8,
    forward 1 (for blk), forward 1 negated (for pred), forward 2, inverse 1
    and 2, each row-major with its rows (output coefficients) in P3_ORDER
    and its columns (input coefficients) in raster order."""
    f1, f2 = kron_stage(SZ)
    return np.stack((f1, -f1, f2) + kron_inv(SZ))[:, P3_ORDER]


def divisor_magic(d: int):
    """(mul, shr) with n // d == (n * mul >> 32) >> shr for 0 <= n < 2^31
    and 2 <= d < 2^31 (Granlund and Montgomery's round-up method, as
    CUTLASS's FastDivmod: p = 31 + ceil(log2 d), mul = ceil(2^p / d)); d = 1
    gives (0, 0), which P3 reads as n itself."""
    if not 1 <= d < 2**31:
        raise ValueError(f"divisor {d} outside [1, 2^31)")
    if d == 1:
        return 0, 0
    p = 31 + (d - 1).bit_length()
    return -(-(1 << p) // d), p - 32


@functools.lru_cache(maxsize=None)
def p3_rdoq_thresholds(qpd6: int):
    """P3's RDOQ at 4x4 as 8 thresholds on e0 = dlevel - (level0 << sft)
    (csrc/probes.cu::rdoq): the level goes down by one iff e0 < th[k], k
    the class of level0's rate step (level0 for 0 .. 6; 7 above, where
    level0 - 5 is a power of two; 0 where the rate does not step). Made
    from the costs of the two top candidates, wd * (dist1 - dist0) < wb *
    (rate(level0) - rate(level0 - 1)), over every e0 a |coef| can give;
    raises unless that choice is e0 below one threshold for each class (it
    is, at every qpd6: the difference rises with e0 wherever it decides)."""
    sft = int(C.QUANT_LEVEL_SHIFT[SZ]) + qpd6
    i32_max, step = 2**31 - 1, 1 << sft
    dl = np.minimum(np.arange(0x20000, dtype=np.int64) << 14,
                    i32_max - (step >> 1))
    e0 = np.unique(dl - ((dl + (step >> 1)) >> sft << sft))
    d0 = np.abs(e0) >> int(C.QUANT_DIST_SHIFT[SZ])
    d1 = (e0 + step) >> int(C.QUANT_DIST_SHIFT[SZ])
    dist = lambda d: np.where(d < 46340, d * d, i32_max) >> 7
    f = int(C.RDCOST_WEIGHT_DIST[qpd6]) * (dist(d1) - dist(d0))
    lvl = [int(v) for v in C.LEVEL_RATE_TABLE[:6]]
    # rate(l) - rate(l - 1): none, the table's steps, its last entry to
    # the rate of level 6 (92000 + (4 << 15)), 2^16 at a power of two
    steps = ([0] + [lvl[k] - lvl[k - 1] for k in range(1, 6)]
             + [92000 + (4 << 15) - lvl[5], 1 << 16])
    th = []
    for dr in steps:
        down = f < int(C.RDCOST_WEIGHT_BITS[qpd6]) * dr
        t = int(e0[~down].min()) if (~down).any() else int(e0.max()) + 1
        if not np.array_equal(down, e0 < t):
            raise ValueError(f"P3's RDOQ is no threshold at qpd6={qpd6}, "
                             f"rate step {dr}")
        th.append(t)
    return tuple(th)


# ----------------------------------------------------------- plain versions

def add_one_plain(x):
    """P1's plain version: x + 1."""
    return x + 1


def int8_mm_plain(a, b):
    """P2's plain version: (M, K) int8 @ (K, N) int8 -> (M, N) int32, exact
    (torch.matmul takes no integer CUDA tensors)."""
    return (a.long()[:, :, None] * b.long()[None]).sum(1).int()


def fused4_plain(pred, blk, qpd6: int = 2):
    """P3's plain version, the op chain of ops/xform + ops/quant in the
    probe's layout: pred (rows, modes * 16) u8, blk (rows, 16) u8 ->
    (q (rows, modes * 16) int32, sse (rows, modes) int32)."""
    rows, w = pred.shape
    p = pred.reshape(rows, w // NN, SZ, SZ)
    b = blk.reshape(rows, 1, SZ, SZ)
    resid = b.to(torch.int16) - p.to(torch.int16)
    coef = xform.forward_transform(SZ, resid)
    q = quant.quantize(SZ, qpd6, coef)
    dq = quant.dequantize(SZ, qpd6, q)
    r = xform.inverse_transform(SZ, dq)
    recon = torch.clamp(r.to(torch.int32) + p, 0, 255)
    return (q.to(torch.int32).reshape(rows, w), rdcost.block_sse(b, recon))


# ------------------------------------------------------------------ kernels

def build(force: bool = False):
    """Compile csrc/probes.cu for sm_90a (once, or again with force=True;
    see runtime/build). Returns (library path, compiler output, which holds
    ptxas's register, shared-memory and spill report)."""
    return _build.build(SOURCE, LIB_NAME, _build.nvcc_cmd(SOURCE), force,
                        deps=[HEADER])


def sass_counts(path, opcode) -> dict:
    """instructions whose text holds `opcode`, per kernel, in the built
    library's SASS, read with cuobjdump: {kernel symbol: count}."""
    tool = shutil.which("cuobjdump") or str(
        pathlib.Path(_build.nvcc()).parent / "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(path)], capture_output=True,
                          text=True, check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            counts[fn] = 0
        elif fn is not None and opcode in line:
            counts[fn] += 1
    return counts


def imma_counts(path) -> dict:
    """IMMA (integer tensor-core) instructions per kernel in the built
    library's SASS: {kernel symbol: count}."""
    return sass_counts(path, "IMMA")


def _load():
    global _lib
    with _lock:
        if _lib is None:
            path, _ = build()
            lib = ctypes.CDLL(str(path))
            vp, i32 = ctypes.c_void_p, ctypes.c_int
            lib.hevce_p1_add_one.restype = i32
            lib.hevce_p1_add_one.argtypes = [vp, i32, vp]
            lib.hevce_p2_int8_mm.restype = i32
            lib.hevce_p2_int8_mm.argtypes = [vp, vp, vp, i32, i32, i32, vp]
            lib.hevce_p3_fused4.restype = i32
            u32 = ctypes.c_uint
            lib.hevce_p3_fused4.argtypes = (
                [vp, vp, vp, i32, i32, u32, u32] + [i32] * 4
                + [ctypes.POINTER(i32), vp, vp, vp])
            _lib = lib
        return _lib


def _kron_device(device: torch.device):
    """p3_stage_matrices() as one (5, 16, 16) int8 tensor on `device`,
    uploaded once."""
    with _lock:
        if device not in _kron_cache:
            _kron_cache[device] = torch.from_numpy(
                np.ascontiguousarray(p3_stage_matrices())).to(device)
        return _kron_cache[device]


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _launched(name, rc):
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")
    LAUNCHES[name] += 1


def _on_cuda(name, *ts):
    if any(t.device != ts[0].device for t in ts):
        raise ValueError(f"{name} takes its tensors on one device")
    if ts[0].device.type != "cuda":
        raise ValueError(f"{name} runs on CUDA or CPU tensors, not "
                         f"{ts[0].device}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError(f"{name} takes contiguous tensors")


def add_one(x):
    """P1: x += 1 in place (int32); returns x."""
    if x.device.type == "cpu":
        return x.copy_(add_one_plain(x))
    _on_cuda("add_one", x)
    if x.dtype != torch.int32:
        raise TypeError(f"add_one takes int32, got {x.dtype}")
    if x.numel() >= 2**31:
        raise ValueError(f"add_one takes fewer than 2^31 elements, got "
                         f"{x.numel()}")
    lib = _load()
    _launched("add_one", lib.hevce_p1_add_one(x.data_ptr(), x.numel(),
                                              _stream(x)))
    return x


def int8_mm(a, b):
    """P2: (M, K) int8 @ (K, N) int8 -> (M, N) int32, exact."""
    if a.device.type == "cpu" and b.device.type == "cpu":
        return int8_mm_plain(a, b)
    _on_cuda("int8_mm", a, b)
    if a.dtype != torch.int8 or b.dtype != torch.int8:
        raise TypeError(f"int8_mm takes int8, got {a.dtype}/{b.dtype}")
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"shapes {tuple(a.shape)} @ {tuple(b.shape)} do not "
                         f"fit (M, K) @ (K, N)")
    M, K = a.shape
    N = b.shape[1]
    out = torch.empty((M, N), dtype=torch.int32, device=a.device)
    lib = _load()
    _launched("int8_mm", lib.hevce_p2_int8_mm(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), M, K, N, _stream(a)))
    return out


def fused4(pred, blk, qpd6: int = 2):
    """P3: pred (rows, modes * 16) u8, blk (rows, 16) u8 -> (q (rows,
    modes * 16) int32, sse (rows, modes) int32), equal to fused4_plain."""
    if pred.device.type == "cpu" and blk.device.type == "cpu":
        return fused4_plain(pred, blk, qpd6)
    _on_cuda("fused4", pred, blk)
    if pred.dtype != torch.uint8 or blk.dtype != torch.uint8:
        raise TypeError(f"fused4 takes uint8, got {pred.dtype}/{blk.dtype}")
    if (pred.dim() != 2 or blk.dim() != 2 or pred.shape[1] % NN
            or tuple(blk.shape) != (pred.shape[0], NN)
            or not 0 <= qpd6 <= 4):
        raise ValueError(f"shapes pred {tuple(pred.shape)} / blk "
                         f"{tuple(blk.shape)} / qpd6={qpd6} do not fit "
                         f"(rows, modes * 16) / (rows, 16) / 0-4")
    rows, w = pred.shape
    modes = w // NN
    if rows * modes >= 2**31:
        raise ValueError(f"fused4 takes fewer than 2^31 candidate blocks, "
                         f"got {rows} x {modes}")
    if pred.data_ptr() % 4 or blk.data_ptr() % 4:
        raise ValueError("fused4 takes pred and blk 4-byte aligned (it loads "
                         "4 bytes of a block at a time)")
    q = torch.empty((rows, w), dtype=torch.int32, device=pred.device)
    sse = torch.empty((rows, modes), dtype=torch.int32, device=pred.device)
    if modes == 0:
        return q, sse
    lib = _load()
    kron = _kron_device(pred.device)
    th = (ctypes.c_int * 8)(*p3_rdoq_thresholds(qpd6))
    _launched("fused4", lib.hevce_p3_fused4(
        pred.data_ptr(), blk.data_ptr(), kron.data_ptr(), rows * modes, modes,
        *divisor_magic(modes), int(C.FWD_SHIFT_A[SZ]),
        int(C.QUANT_LEVEL_SHIFT[SZ]), int(C.DEQUANT_SHIFT[SZ]), qpd6, th,
        q.data_ptr(), sse.data_ptr(), _stream(pred)))
    return q, sse
