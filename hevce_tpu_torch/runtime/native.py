"""ctypes binding to the native host engine, built by the port itself.

csrc/hevce_host.cpp (at the repository root) holds the sequential exact
encoder, the decision-record pack (pack_forest_img: it replays the quant
levels and recon from the decisions and the original image, then runs the
real CABAC) and an independent decoder. The port compiles it at first use
with the same g++ flags as tools/build_native.py into build/hevce_tpu_torch/
(runtime/build), and binds the functions the wavefront fast mode needs.
"""
import ctypes
import threading

import numpy as np

from hevce_tpu_torch.runtime import build as _build

SOURCE = _build.ROOT / "csrc" / "hevce_host.cpp"
LIB_NAME = "libhevce_host.so"
GXX_FLAGS = ["-std=c++17", "-shared", "-fPIC", "-pthread", "-Wall",
             "-Wextra", "-Wno-unused-parameter", "-O3", "-march=native",
             "-funroll-loops", "-fopenmp-simd"]

_U8P = ctypes.POINTER(ctypes.c_uint8)
_I32P = ctypes.POINTER(ctypes.c_int32)
_lock = threading.Lock()
_lib = None


def build(force: bool = False):
    """Compile csrc/hevce_host.cpp (once, or again with force=True).
    Returns (path, compiler output)."""
    return _build.build(SOURCE, LIB_NAME, ["g++", *GXX_FLAGS, str(SOURCE)],
                        force)


def _load():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path, _ = build()
        lib = ctypes.CDLL(str(path))
        lib.hevce_encode.restype = ctypes.c_longlong
        lib.hevce_encode.argtypes = [
            _U8P, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
            ctypes.c_int, _U8P, ctypes.c_longlong, _U8P]
        lib.hevce_stream_capacity.restype = ctypes.c_longlong
        lib.hevce_stream_capacity.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.hevce_pack_img.restype = ctypes.c_longlong
        lib.hevce_pack_img.argtypes = [_I32P] * 3 + [
            _U8P, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            _U8P, ctypes.c_longlong, _U8P]
        lib.hevce_last_pack_stats.restype = None
        lib.hevce_last_pack_stats.argtypes = [ctypes.POINTER(ctypes.c_longlong)]
        lib.hevce_decode.restype = ctypes.c_longlong
        lib.hevce_decode.argtypes = [
            _U8P, ctypes.c_longlong, ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int), _U8P]
        _lib = lib
        return lib


def stream_capacity(ysz: int, xsz: int) -> int:
    """Worst-case stream bytes for one image: the reference bounds each CTU's
    entropy payload by 3*CTU^2+128 B (reference src/HEVCe.c:795-806), plus
    headers."""
    yp, xp = -(-ysz // 32) * 32, -(-xsz // 32) * 32
    return 3 * yp * xp + yp * xp // 8 + (1 << 16)


def _clip_dims(img: np.ndarray) -> np.ndarray:
    """Clamp to the 8192x8192 engine maximum BEFORE handing the buffer to C:
    the native engine indexes with its clamped xsz as the row stride."""
    if img.shape[0] > 8192 or img.shape[1] > 8192:
        img = img[:8192, :8192]
    return np.ascontiguousarray(img, np.uint8)


def _u8(a):
    return a.ctypes.data_as(_U8P)


def pack_forest_img(lay, pm, pm4, img: np.ndarray, qpd6: int):
    """Pack a pre-decided CU forest from DECISIONS ONLY (per-CTU lay/pm 21
    nodes, pm4 64 NxN PU modes, raster CTU order): quant levels are
    recomputed on the host from the decisions + the original image (csrc
    replay_cu). Returns (stream bytes, recon with CTU-padded dims); the
    recon equals what a decoder reconstructs from the stream."""
    lib = _load()
    img = _clip_dims(img)
    ysz, xsz = img.shape
    yp, xp = -(-ysz // 32) * 32, -(-xsz // 32) * 32
    cap = int(lib.hevce_stream_capacity(ysz, xsz))
    buf = np.empty(cap, np.uint8)
    rcon = np.empty((yp, xp), np.uint8)
    arrs = [np.ascontiguousarray(a, np.int32).reshape(-1)
            for a in (lay, pm, pm4)]
    n = lib.hevce_pack_img(*(a.ctypes.data_as(_I32P) for a in arrs),
                           _u8(img), ysz, xsz, qpd6, _u8(buf), cap,
                           _u8(rcon))
    if n <= 0:
        raise ValueError(f"hevce_pack_img failed: {n}")
    return bytes(buf[:n]), rcon


def last_pack_stats():
    """Realized CABAC stats of this thread's LAST pack_forest_img call:
    (payload_bits, n_context_bins, n_bypass_bins)."""
    lib = _load()
    out = (ctypes.c_longlong * 3)()
    lib.hevce_last_pack_stats(out)
    return int(out[0]), int(out[1]), int(out[2])


def decode_stream(stream: bytes) -> np.ndarray:
    """Decode a stream of this encoder subset with the independent native
    decoder. Returns the luma plane with the padded stream dimensions."""
    lib = _load()
    buf = np.frombuffer(bytes(stream), np.uint8)
    y, x = ctypes.c_int(0), ctypes.c_int(0)
    rc = lib.hevce_decode(_u8(buf), len(buf), ctypes.byref(y),
                          ctypes.byref(x), None)
    if rc < 0:
        raise ValueError(f"hevce_decode: malformed/unsupported stream ({rc})")
    luma = np.empty((y.value, x.value), np.uint8)
    rc = lib.hevce_decode(_u8(buf), len(buf), ctypes.byref(y),
                          ctypes.byref(x), _u8(luma))
    if rc != luma.size:
        raise ValueError(f"hevce_decode: decode failed ({rc})")
    return luma


def encode_image_native(img: np.ndarray, qpd6: int):
    """Encode one 8-bit grayscale image with the bit-exact native engine.
    Returns (stream bytes, recon with CTU-padded dims)."""
    if img.dtype != np.uint8 or img.ndim != 2:
        raise ValueError("expected a 2-D uint8 image")
    if not 0 <= qpd6 <= 4:
        raise ValueError(f"qpd6={qpd6} outside 0..4")
    lib = _load()
    img = _clip_dims(img)
    ysz, xsz = ctypes.c_int(img.shape[0]), ctypes.c_int(img.shape[1])
    yp, xp = -(-img.shape[0] // 32) * 32, -(-img.shape[1] // 32) * 32
    cap = stream_capacity(img.shape[0], img.shape[1])
    stream = np.empty(cap, np.uint8)
    rcon = np.empty((yp, xp), np.uint8)
    n = lib.hevce_encode(_u8(img), ctypes.byref(ysz), ctypes.byref(xsz),
                         qpd6, _u8(stream), cap, _u8(rcon))
    if n < 0:
        raise ValueError("hevce_encode failed")
    return bytes(stream[:n]), rcon
