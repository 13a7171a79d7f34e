# Frozen copy at commit 0c580e1 of the port's readable specification of the
# reference encoder's exhaustive search: hevce_tpu_torch/models/encoder.py
# (rd_cost, _EncodeState, _process_cu, encode_image), the CABAC encoder of
# hevce_tpu_torch/bitstream/cabac.py (CabacEncoder), the writers of
# hevce_tpu_torch/bitstream/syntax.py and hevce_tpu_torch/bitstream/
# headers.py. The tables come from cabac_tables.py and syntax_tables.py;
# every candidate evaluation goes to the plain op chains node.eval_2nx2n and
# node.eval_tusplit. put_coef reads its scan from per-(sz, scan) lists and a
# fresh context set is copied from a per-qpd6 cache: the same bins, fewer
# Python calls.
# Edit only to follow a change of what the benchmark compares.
"""The reference encoder's exact RDO, in plain PyTorch and numpy: the
benchmark's reference for the bit-exact lockstep engine.

encode_streams(images, qpd6, device) encodes each image alone, as the
reference encoder does (lidongxuan/HEVC-image-encoder-lite, processCURecurs,
src/HEVCe.c:1346-1560): every CU node's split, 2Nx2N, 2Nx2N with four TUs
and (at 8x8) NxN candidates over all 35 modes, each priced by a trial encode
on a copy of the live CABAC coder and contexts, the cheapest committed.
It returns each image's stream and reconstruction (the image plane padded
up to whole CTUs); encode_recon returns the reconstructions alone.

Nothing here is the code under test (the C++ arbiters of
csrc/hevce_host.cpp, the lockstep's batched event programs, the kernels K1,
X1 and K2). On CUDA each (eval function, sz) step is captured once as a CUDA
graph and replayed per evaluation, with TF32 off; images of one call encode
at once, one spawned process each.

Two controls put lower precision in the exact path's place: transform_dtype
(int16 transform sums, as search.transform_dtype) and
initial_context_rates (every trial priced from the slice's initial context
states instead of the live ones).
"""
import contextlib
import functools
import multiprocessing
import os

import numpy as np
import torch

from benchmark.reference import cabac_tables as cb
from benchmark.reference import constants as C
from benchmark.reference import node, xform
from benchmark.reference import syntax_tables as syn
from benchmark.reference.tables import normal

I32_MAX = 2 ** 31 - 1
_WDIST = [11, 11, 11, 5, 1]
_WBITS = [1, 4, 16, 29, 23]
# True: each trial encode starts from the live contexts (the reference);
# False: from the slice's initial ones (initial_context_rates, a control)
LIVE_CONTEXTS = True


# ------------------------------------------------------------------ CABAC

@functools.lru_cache(maxsize=None)
def _fresh_contexts(qpd6: int) -> bytes:
    return bytes(cb.new_context_set(qpd6))


def new_context_set(qpd6: int) -> bytearray:
    """a fresh 142-entry packed context vector at qpd6."""
    return bytearray(_fresh_contexts(qpd6))


_LPS = cb.LPS_TABLE.tolist()
_RENORM = cb.RENORM_TABLE.tolist()
_NEXT_MPS = cb.NEXT_STATE_MPS.tolist()
_NEXT_LPS = cb.NEXT_STATE_LPS.tolist()


class CabacEncoder:
    """HEVC binary arithmetic encoder with the exact bit-length oracle
    (reference src/HEVCe.c:791-933): a 9-bit range and 32-bit low with
    deferred carries through an outstanding-byte count, emulation
    prevention (0x03 insertion) in the byte sink, and bit_len(), the
    length every RD decision uses. copy() snapshots a coder for a trial."""

    __slots__ = ("range", "low", "nbits", "outstanding", "bufbyte", "buf",
                 "zrun")

    def __init__(self):
        self.range = 510
        self.low = 0
        self.nbits = 23
        self.outstanding = 0
        self.bufbyte = 0xFF
        self.buf = bytearray()
        self.zrun = 0

    def copy(self) -> "CabacEncoder":
        c = CabacEncoder.__new__(CabacEncoder)
        c.range, c.low, c.nbits = self.range, self.low, self.nbits
        c.outstanding, c.bufbyte = self.outstanding, self.bufbyte
        c.buf = bytearray(self.buf)
        c.zrun = self.zrun
        return c

    def _emit(self, byte: int) -> None:
        """byte sink with emulation prevention (src/HEVCe.c:821-832)."""
        byte &= 0xFF
        if self.zrun >= 2 and byte <= 0x03:
            self.buf.append(0x03)
            self.zrun = 0
        self.buf.append(byte)
        self.zrun = self.zrun + 1 if byte == 0 else 0

    def _refill(self) -> None:
        """low-register refill and carry resolution (src/HEVCe.c:859-879)."""
        if self.nbits >= 12:
            return
        lead = self.low >> (24 - self.nbits)
        self.nbits += 8
        self.low &= (0xFFFFFFFF >> self.nbits)
        if lead == 0xFF:
            self.outstanding += 1
        elif self.outstanding > 0:
            carry = lead >> 8
            self._emit(self.bufbyte + carry)
            self.bufbyte = lead & 0xFF
            fill = (0xFF + carry) & 0xFF
            for _ in range(self.outstanding - 1):
                self._emit(fill)
            self.outstanding = 1
        else:
            self.outstanding = 1
            self.bufbyte = lead

    def encode_bin(self, ctxs: bytearray, idx: int, binval: int) -> None:
        """context-coded bin (src/HEVCe.c:914-933)."""
        v = ctxs[idx]
        lps = _LPS[v >> 1][(self.range >> 6) & 3]
        self.range -= lps
        if binval != (v & 1):
            nbit = _RENORM[lps >> 3]
            ctxs[idx] = _NEXT_LPS[v]
            self.low = (self.low + self.range) << nbit
            self.range = lps << nbit
            self.nbits -= nbit
        else:
            ctxs[idx] = _NEXT_MPS[v]
            if self.range < 256:
                self.low <<= 1
                self.range <<= 1
                self.nbits -= 1
        if self.nbits < 12:
            self._refill()

    def encode_bypass(self, bins: int, length: int) -> None:
        """bypass bins, MSB first, in chunks of 8 (src/HEVCe.c:899-911)."""
        bins &= (1 << length) - 1
        while length > 0:
            cur = min(length, 8)
            length -= cur
            chunk = (bins >> length) & ((1 << cur) - 1)
            self.low = (self.low << cur) + self.range * chunk
            self.nbits -= cur
            if self.nbits < 12:
                self._refill()

    def encode_terminate(self, binval: int) -> None:
        """end_of_slice / terminate bin (src/HEVCe.c:882-896)."""
        self.range -= 2
        if binval:
            self.low = (self.low + self.range) << 7
            self.range = 2 << 7
            self.nbits -= 7
        elif self.range < 256:
            self.low <<= 1
            self.range <<= 1
            self.nbits -= 1
        self._refill()

    def bit_len(self) -> int:
        """exact fractional length oracle (src/HEVCe.c:835-837)."""
        return 8 * (len(self.buf) + self.outstanding) + 23 - self.nbits

    def finish(self) -> None:
        """flush (src/HEVCe.c:840-856)."""
        if (self.low >> (32 - self.nbits)) > 0:
            self._emit(self.bufbyte + 1)
            self.low -= 1 << (32 - self.nbits)
            fill = 0x00
        else:
            if self.outstanding > 0:
                self._emit(self.bufbyte)
            fill = 0xFF
        for _ in range(max(self.outstanding - 1, 0)):
            self._emit(fill)
        self.outstanding = 0
        tail = ((self.low >> 8) << self.nbits) & 0xFFFFFFFF
        self._emit(tail >> 16)
        self._emit(tail >> 8)
        self._emit(tail)


# ---------------------------------------------------------------- headers

VPS = bytes([0x00, 0x00, 0x01, 0x40, 0x01, 0x0C, 0x01, 0xFF, 0xFF, 0x03, 0x10,
             0x00, 0x00, 0x03, 0x00, 0x00, 0x03, 0x00, 0x00, 0x03, 0x00, 0x00,
             0x03, 0x00, 0xB4, 0xF0, 0x24])
SPS_PREFIX = bytes([0x00, 0x00, 0x01, 0x42, 0x01, 0x01, 0x03, 0x10, 0x00, 0x00,
                    0x03, 0x00, 0x00, 0x03, 0x00, 0x00, 0x03, 0x00, 0x00, 0x03,
                    0x00, 0xB4])
PPS = bytes([0x00, 0x00, 0x01, 0x44, 0x01, 0xC0, 0x90, 0x91, 0x81, 0xD9, 0x20])
SLICE_HEADER = {
    0: bytes([0x00, 0x00, 0x01, 0x26, 0x01, 0xAC, 0x16, 0xDE]),
    1: bytes([0x00, 0x00, 0x01, 0x26, 0x01, 0xAC, 0x10, 0xDE]),
    2: bytes([0x00, 0x00, 0x01, 0x26, 0x01, 0xAC, 0x2B, 0x78]),
    3: bytes([0x00, 0x00, 0x01, 0x26, 0x01, 0xAC, 0x4D, 0xE0]),
    4: bytes([0x00, 0x00, 0x01, 0x26, 0x01, 0xAC, 0x97, 0x80]),
}
# SPS bit runs around the picture-size fields (src/HEVCe.c:682-687)
_SPS_LEAD_BITS = (0x0A, 4)
_SPS_MID_BITS = (0x197EE4, 22)
_SPS_TAIL_BITS = (0x681ED1, 24)


class BitWriter:
    """MSB-first bit accumulator flushed to bytes with zero padding."""

    def __init__(self):
        self.out = bytearray()
        self.acc = 0
        self.nacc = 0

    def bits(self, value: int, length: int) -> None:
        self.acc = (self.acc << length) | (value & ((1 << length) - 1))
        self.nacc += length
        while self.nacc >= 8:
            self.nacc -= 8
            self.out.append((self.acc >> self.nacc) & 0xFF)
        self.acc &= (1 << self.nacc) - 1

    def uvlc(self, value: int) -> None:
        """unsigned Exp-Golomb with the reference's length derivation
        (src/HEVCe.c:642-648)."""
        v = value + 1
        half = (v + 1).bit_length() - 1
        self.bits(0, half)
        self.bits(v & ((1 << (half + 1)) - 1), half + 1)

    def align(self) -> None:
        if self.nacc:
            self.bits(0, 8 - self.nacc)


def write_headers(qpd6: int, ysz: int, xsz: int) -> bytes:
    """the NAL headers before the slice data, for the padded size."""
    bw = BitWriter()
    bw.bits(*_SPS_LEAD_BITS)
    bw.uvlc(xsz)
    bw.uvlc(ysz)
    bw.bits(*_SPS_MID_BITS)
    bw.bits(*_SPS_TAIL_BITS)
    bw.align()
    return VPS + SPS_PREFIX + bytes(bw.out) + PPS + SLICE_HEADER[qpd6]


# ---------------------------------------------------------------- writers

PMODE_PLANAR, PMODE_DC = syn.PMODE_PLANAR, syn.PMODE_DC
CG = syn.CG


def put_split_cu_flag(enc, ctxs, sz, split, larger_than_left,
                      larger_than_above):
    if sz >= 16:
        idx = (cb.CTX_SPLIT_CU + int(bool(larger_than_left))
               + int(bool(larger_than_above)))
        enc.encode_bin(ctxs, idx, int(split))


def put_part_size(enc, ctxs, sz, part_nxn):
    if sz == 8:
        enc.encode_bin(ctxs, cb.CTX_PARTSIZE, 0 if part_nxn else 1)


def put_y_pmode(enc, ctxs, pmodes, lefts, aboves):
    """luma pmode(s): lists of length 1 (2Nx2N) or 4 (NxN)
    (src/HEVCe.c:985-1018)."""
    mpms = [syn.probable_pmodes(l, a) for l, a in zip(lefts, aboves)]
    hits = []
    for pm, mpm in zip(pmodes, mpms):
        hit = mpm.index(pm) if pm in mpm else -1
        hits.append(hit)
        enc.encode_bin(ctxs, cb.CTX_Y_PMODE, int(hit >= 0))
    for pm, mpm, hit in zip(pmodes, mpms, hits):
        if hit >= 0:
            enc.encode_bypass(int(hit > 0), 1)
            if hit > 0:
                enc.encode_bypass(hit - 1, 1)
        else:
            rem = pm - sum(1 for m in mpm if pm > m)
            enc.encode_bypass(rem, 5)


def put_uv_pmode(enc, ctxs):
    # chroma follows luma; monochrome output (src/HEVCe.c:1021-1023)
    enc.encode_bin(ctxs, cb.CTX_UV_PMODE, 0)


def put_split_tu_flag(enc, ctxs, sz, split):
    if sz in (32, 16, 8):
        idx = cb.CTX_SPLIT_TU + {32: 0, 16: 1, 8: 2}[sz]
        enc.encode_bin(ctxs, idx, int(split))


def put_qt_cbf(enc, ctxs, tu_depth_in_cu, is_chroma, cbf):
    if is_chroma:
        enc.encode_bin(ctxs, cb.CTX_UV_QT_CBF + tu_depth_in_cu, int(cbf))
    else:
        enc.encode_bin(ctxs, cb.CTX_Y_QT_CBF + (0 if tu_depth_in_cu else 1),
                       int(cbf))


def put_last_significant_xy(enc, ctxs, sz, is_chroma, scan_type, y, x):
    """(src/HEVCe.c:1046-1087)"""
    addr = syn._LAST_ADDR[is_chroma][sz // 8]
    sft = syn._LAST_SFT[is_chroma][sz // 8]
    ty, tx = (x, y) if scan_type == syn.SCAN_VER else (y, x)
    gy, gx = int(syn.GROUP_INDEX[ty]), int(syn.GROUP_INDEX[tx])
    gmax = int(syn.GROUP_INDEX[sz - 1])
    for i in range(gx):
        enc.encode_bin(ctxs, cb.CTX_LAST_X + 5 * addr + (i >> sft), 1)
    if gx < gmax:
        enc.encode_bin(ctxs, cb.CTX_LAST_X + 5 * addr + (gx >> sft), 0)
    for i in range(gy):
        enc.encode_bin(ctxs, cb.CTX_LAST_Y + 5 * addr + (i >> sft), 1)
    if gy < gmax:
        enc.encode_bin(ctxs, cb.CTX_LAST_Y + 5 * addr + (gy >> sft), 0)
    if gx > 3:
        tx -= int(syn.MIN_IN_GROUP[gx])
        for i in range(((gx - 2) >> 1) - 1, -1, -1):
            enc.encode_bypass((tx >> i) & 1, 1)
    if gy > 3:
        ty -= int(syn.MIN_IN_GROUP[gy])
        for i in range(((gy - 2) >> 1) - 1, -1, -1):
            enc.encode_bypass((ty >> i) & 1, 1)


def put_remain_exgolomb(enc, value, rparam):
    """escape value, Golomb-Rice with an Exp-Golomb tail
    (src/HEVCe.c:1154-1169)."""
    if value < (3 << rparam):
        length = value >> rparam
        enc.encode_bypass((1 << (length + 1)) - 2, length + 1)
        enc.encode_bypass(value % (1 << rparam), rparam)
    else:
        length = rparam
        value -= 3 << rparam
        while value >= (1 << length):
            value -= 1 << length
            length += 1
        pre = 4 + length - rparam
        enc.encode_bypass((1 << pre) - 2, pre)
        enc.encode_bypass(value, length)


@functools.lru_cache(maxsize=None)
def _scan_lists(sz: int, scan_type: int):
    """the scan's (y list, x list, flat index list) and, per sig_ctx 0-3,
    each position's luma significance context (syn.sig_ctx_idx)."""
    scan = syn.scan_table(sz, scan_type)
    ys, xs = scan[:, 0].tolist(), scan[:, 1].tolist()
    flat = (scan[:, 0] * sz + scan[:, 1]).tolist()
    sig = [[syn.sig_ctx_idx(sz, False, scan_type, y, x, s)
            for y, x in zip(ys, xs)] for s in range(4)]
    return ys, xs, flat, sig


def put_coef(enc, ctxs, sz, is_chroma, pmode, blk):
    """full residual coding of a quantized luma TU (src/HEVCe.c:1173-1269).

    blk: (sz, sz) integer array with at least one nonzero (cbf == 1)."""
    assert not is_chroma            # the encoder codes luma only
    scan_type, _ = syn.get_scan(sz, pmode)
    ys, xs, flat, sig_idx = _scan_lists(sz, scan_type)
    ncg = sz // CG

    vals = np.asarray(blk).reshape(-1)[flat]
    nz = np.nonzero(vals)[0]
    i_last = int(nz[-1]) if len(nz) else 0
    sig_map = [[False] * ncg for _ in range(ncg)]
    for i in nz.tolist():
        sig_map[ys[i] >> 2][xs[i] >> 2] = True
    vals = vals.tolist()

    put_last_significant_xy(enc, ctxs, sz, is_chroma, scan_type,
                            ys[i_last], xs[i_last])

    encode_bin = enc.encode_bin
    sig_ctx = 0
    c1 = 1
    abs_nz = []
    signs = 0
    sig_row = sig_idx[0]
    for i in range(i_last, -1, -1):
        y, x = ys[i], xs[i]
        ycg, xcg = y >> 2, x >> 2
        sig_cg = sig_map[ycg][xcg]
        v = vals[i]
        is_final = i == i_last
        first_cg = ycg == 0 and xcg == 0
        first_in_cg = (i & 15) == 0

        if (i & 15) == 15 or is_final:
            right = xcg < ncg - 1 and sig_map[ycg][xcg + 1]
            below = ycg < ncg - 1 and sig_map[ycg + 1][xcg]
            sig_ctx = (int(below) << 1) | int(right)
            sig_row = sig_idx[sig_ctx]
            abs_nz = []
            signs = 0
            if not first_cg and not is_final:
                encode_bin(ctxs, cb.CTX_SIG_MAP + int(sig_ctx != 0),
                           int(sig_cg))

        if not is_final and (first_cg or (sig_cg and (not first_in_cg
                                                      or abs_nz))):
            encode_bin(ctxs, cb.CTX_SIG_SC + sig_row[i], int(v != 0))

        if v != 0:
            abs_nz.append(abs(v))
            signs = (signs << 1) | (v < 0)

        if first_in_cg and abs_nz:
            ctx_set = (2 if not first_cg else 0) + (1 if c1 == 0 else 0)
            escape = len(abs_nz) > 8
            c2_flag = -1
            c1 = 1
            for a in abs_nz[:8]:
                encode_bin(ctxs, cb.CTX_ONE_SC + 4 * ctx_set + c1,
                           int(a > 1))
                if a > 1:
                    c1 = 0
                    if c2_flag < 0:
                        c2_flag = int(a > 2)
                    else:
                        escape = True
                elif 0 < c1 < 3:
                    c1 += 1
            if c1 == 0 and c2_flag >= 0:
                encode_bin(ctxs, cb.CTX_ABS_SC + ctx_set, c2_flag)
                escape = escape or bool(c2_flag)
            enc.encode_bypass(signs, len(abs_nz))
            if escape:
                first_coeff2, rparam = 3, 0
                for j, a in enumerate(abs_nz):
                    esc = a - (first_coeff2 if j < 8 else 1)
                    if esc >= 0:
                        put_remain_exgolomb(enc, esc, rparam)
                        if a > (3 << rparam):
                            rparam = min(rparam + 1, 4)
                    if a >= 2:
                        first_coeff2 = 2


# CU serializers (src/HEVCe.c:1272-1340)

def put_cu_2nx2n(enc, ctxs, sz, pmode, pmode_left, pmode_above, blk):
    """part2Nx2N, single TU."""
    cbf = bool(np.any(np.asarray(blk)[:sz, :sz]))
    put_part_size(enc, ctxs, sz, False)
    put_y_pmode(enc, ctxs, [pmode], [pmode_left], [pmode_above])
    put_uv_pmode(enc, ctxs)
    put_split_tu_flag(enc, ctxs, sz, False)
    put_qt_cbf(enc, ctxs, 0, True, 0)
    put_qt_cbf(enc, ctxs, 0, True, 0)
    put_qt_cbf(enc, ctxs, 0, False, cbf)
    if cbf:
        put_coef(enc, ctxs, sz, False, pmode, blk)


def put_cu_2nx2n_tusplit(enc, ctxs, sz, pmode, pmode_left, pmode_above,
                         sub_blks):
    """part2Nx2N, split into 4 TUs."""
    put_part_size(enc, ctxs, sz, False)
    put_y_pmode(enc, ctxs, [pmode], [pmode_left], [pmode_above])
    put_uv_pmode(enc, ctxs)
    put_split_tu_flag(enc, ctxs, sz, True)
    put_qt_cbf(enc, ctxs, 0, True, 0)
    put_qt_cbf(enc, ctxs, 0, True, 0)
    h = sz // 2
    for sub in sub_blks:
        cbf = bool(np.any(np.asarray(sub)[:h, :h]))
        put_qt_cbf(enc, ctxs, 1, False, cbf)
        if cbf:
            put_coef(enc, ctxs, h, False, pmode, sub)


def put_cu_nxn(enc, ctxs, sz, pmodes, lefts, aboves, sub_blks):
    """partNxN (8x8 CU only): 4 PUs with their own modes."""
    put_part_size(enc, ctxs, sz, True)
    put_y_pmode(enc, ctxs, pmodes, lefts, aboves)
    put_uv_pmode(enc, ctxs)
    put_qt_cbf(enc, ctxs, 0, True, 0)
    put_qt_cbf(enc, ctxs, 0, True, 0)
    h = sz // 2
    for pm, sub in zip(pmodes, sub_blks):
        cbf = bool(np.any(np.asarray(sub)[:h, :h]))
        put_qt_cbf(enc, ctxs, 1, False, cbf)
        if cbf:
            put_coef(enc, ctxs, h, False, pm, sub)


# ------------------------------------------------------ candidate evaluation

class _EvalStep:
    """fn (node.eval_2nx2n or node.eval_tusplit) of one node at (sz, qpd6)
    over static inputs: ctx_top (1 + 2sz), ctx_left (2sz), the four flags
    and the originals (sz, sz), one row. On CUDA the step is captured once
    as a CUDA graph (after an eager warm-up step on a side stream) and every
    call replays it; on the CPU it runs at every call. A call returns its
    (quant, recon, sse) on the host."""

    def __init__(self, fn, sz: int, qpd6: int, device: torch.device):
        self.fn, self.sz, self.qpd6 = fn, sz, qpd6
        self.top = torch.zeros(1 + 2 * sz, dtype=torch.int32, device=device)
        self.left = torch.zeros(2 * sz, dtype=torch.int32, device=device)
        self.flags = torch.zeros(4, dtype=torch.bool, device=device)
        self.orig = torch.zeros(sz, sz, dtype=torch.int32, device=device)
        self.graph = self.out = None
        if device.type == "cuda":
            stream = torch.cuda.Stream(device)
            stream.wait_stream(torch.cuda.current_stream(device))
            with torch.no_grad(), torch.cuda.stream(stream):
                self.step()
            stream.synchronize()
            self.graph = torch.cuda.CUDAGraph()
            with torch.no_grad(), torch.cuda.graph(self.graph, stream=stream):
                self.out = self.step()

    def step(self):
        return self.fn(self.sz, self.qpd6, self.top, self.left, self.flags,
                       self.orig)

    def __call__(self, ctx_top, ctx_left, flags, blk_orig):
        with torch.no_grad():
            self.top.copy_(torch.from_numpy(ctx_top))
            self.left.copy_(torch.from_numpy(ctx_left))
            self.flags.copy_(torch.from_numpy(flags))
            self.orig.copy_(torch.from_numpy(blk_orig))
            if self.graph is None:
                out = self.step()
            else:
                self.graph.replay()
                out = self.out
            return [t.cpu().numpy() for t in out]


@functools.lru_cache(maxsize=None)
def _eval_step(fn, sz: int, qpd6: int, device: torch.device, dtype):
    """the _EvalStep of (fn, sz, qpd6) on device, for the transform dtype
    that a capture holds."""
    return _EvalStep(fn, sz, qpd6, device)


# ------------------------------------------------------------------ arbiter

def rd_cost(qpd6: int, dist: int, bits: int) -> int:
    """saturating RD cost on host ints (reference src/HEVCe.c:177-185)."""
    w1, w2 = _WDIST[qpd6], _WBITS[qpd6]
    c1 = I32_MAX if I32_MAX // w1 <= dist else w1 * dist
    c2 = I32_MAX if I32_MAX // w2 <= bits else w2 * bits
    return I32_MAX if I32_MAX - c1 <= c2 else c1 + c2


def _sse(a, b) -> int:
    d = a.astype(np.int64) - b.astype(np.int64)
    return int((d * d).sum())


class _EncodeState:
    """Per-image mutable encode state owned by the arbiter."""

    def __init__(self, img, qpd6, dev):
        self.qpd6 = qpd6
        self.dev = dev
        ysz0, xsz0 = img.shape
        ysz0, xsz0 = min(ysz0, C.MAX_YSZ), min(xsz0, C.MAX_XSZ)
        self.ysz0, self.xsz0 = ysz0, xsz0
        self.yszn = -(-ysz0 // C.CTU_SZ) * C.CTU_SZ
        self.xszn = -(-xsz0 // C.CTU_SZ) * C.CTU_SZ
        self.img = np.ascontiguousarray(img[:ysz0, :xsz0])
        self.rcon = np.zeros((self.yszn, self.xszn), np.uint8)
        # context line buffers (1 row above + the CTU's rows, in 4px units)
        ntu_x = 1 + self.xszn // C.MIN_TU_SZ
        self.map_cu_sz = np.full((1 + 8, ntu_x), C.CTU_SZ, np.uint8)
        self.map_pmode = np.full((1 + 8, ntu_x), C.PMODE_DC, np.uint8)
        self.enc = CabacEncoder()
        self.ctxs = new_context_set(qpd6)
        self.ctu_y = 0  # global y of the current CTU row (map row indexing)

    def evaluate(self, fn, sz, ctx_top, ctx_left, flags, blk_orig):
        """fn's (quant, recon, sse) over the 35 modes of one node."""
        return _eval_step(fn, sz, self.qpd6, self.dev, xform.DTYPE)(
            ctx_top, ctx_left, flags, blk_orig)

    def trial_contexts(self, o_ctxs):
        """the contexts a trial encode starts from: the live ones, or under
        initial_context_rates the slice's initial ones."""
        if LIVE_CONTEXTS:
            return bytearray(o_ctxs)
        return new_context_set(self.qpd6)

    # clamped reads (GET2D semantics, reference src/HEVCe.c:119)

    def orig_block(self, y, x, sz):
        """original pixels with edge replication from the UNPADDED dims
        (reference src/HEVCe.c:1620-1622)."""
        yy = np.clip(np.arange(y, y + sz), 0, self.ysz0 - 1)
        xx = np.clip(np.arange(x, x + sz), 0, self.xsz0 - 1)
        return self.img[np.ix_(yy, xx)].astype(np.int32)

    def ctx_slices(self, y, x, sz):
        """(ctx_top (1+2sz), ctx_left (2sz)) reconstructed-neighbour reads
        clamped to the PADDED plane (src/HEVCe.c:1614-1618)."""
        tx = np.clip(np.arange(x - 1, x + 2 * sz), 0, self.xszn - 1)
        ty = max(min(y - 1, self.yszn - 1), 0)
        ctx_top = self.rcon[ty, tx].astype(np.int32)
        ly = np.clip(np.arange(y, y + 2 * sz), 0, self.yszn - 1)
        lx = max(min(x - 1, self.xszn - 1), 0)
        ctx_left = self.rcon[ly, lx].astype(np.int32)
        return ctx_top, ctx_left

    # context-map accessors (line buffers, src/HEVCe.c:1592-1600)

    def _map_rc(self, y, x):
        return 1 + (y - self.ctu_y) // 4, 1 + x // 4

    def left_cu_sz(self, y, x):
        r, c = self._map_rc(y, x)
        return int(self.map_cu_sz[r, c - 1])

    def above_cu_sz(self, y, x):
        r, c = self._map_rc(y, x)
        return int(self.map_cu_sz[r - 1, c])

    def left_pmode(self, y, x):
        r, c = self._map_rc(y, x)
        return int(self.map_pmode[r, c - 1])

    def above_pmode(self, y, x):
        r, c = self._map_rc(y, x)
        return int(self.map_pmode[r - 1, c])

    def fill_maps(self, y, x, sz, cu_sz, pmode):
        r, c = self._map_rc(y, x)
        n = sz // 4
        self.map_cu_sz[r:r + n, c:c + n] = cu_sz
        self.map_pmode[r:r + n, c:c + n] = pmode

    def fill_pmode(self, y, x, sz, pmode):
        r, c = self._map_rc(y, x)
        n = sz // 4
        self.map_pmode[r:r + n, c:c + n] = pmode

    def scroll_maps(self):
        # only cu_sz scrolls across CTU rows; the above-CTU pmode stays DC
        # (reference src/HEVCe.c:1634-1637)
        self.map_cu_sz[0, 1:] = self.map_cu_sz[8, 1:]


_SUB_OFFS = ((0, 0), (0, 1), (1, 0), (1, 1))


def _sub_flags(bll, blb, baa, bar):
    """border existence of z-order sub-blocks (src/HEVCe.c:1376-1379)."""
    return ((bll, bll, baa, baa),
            (True, False, baa, bar),
            (bll, blb, True, True),
            (True, False, True, False))


def _process_cu(st: _EncodeState, y, x, sz, bll, blb, baa, bar):
    """RD search over {split, 2Nx2N, 2Nx2N+TUsplit, NxN}
    (src/HEVCe.c:1350-1560). A later candidate wins a tie (best >= cost)."""
    q = st.qpd6
    o_enc = st.enc.copy()
    o_ctxs = bytes(st.ctxs)
    o_len = o_enc.bit_len()

    larger_left = sz > st.left_cu_sz(y, x)
    larger_above = sz > st.above_cu_sz(y, x)
    pmode_left = st.left_pmode(y, x)
    pmode_above = st.above_pmode(y, x)

    blk_orig = st.orig_block(y, x, sz)
    best = I32_MAX
    best_rcon = None

    # ---- step 1: split into 4 sub-CUs (evaluated on the live coder) ----
    if sz > C.MIN_CU_SZ:
        put_split_cu_flag(st.enc, st.ctxs, sz, 1, larger_left, larger_above)
        sf = _sub_flags(bll, blb, baa, bar)
        h = sz // 2
        for isub, (oy, ox) in enumerate(_SUB_OFFS):
            _process_cu(st, y + oy * h, x + ox * h, h, *sf[isub])
        dist = _sse(blk_orig, st.rcon[y:y + sz, x:x + sz])
        best = rd_cost(q, dist, st.enc.bit_len() - o_len)
        best_rcon = st.rcon[y:y + sz, x:x + sz].copy()

    # ---- step 2: 2Nx2N single TU, all 35 modes ----
    ctx_top, ctx_left = st.ctx_slices(y, x, sz)
    flags = np.array([bll, blb, baa, bar], bool)
    q35, r35, sse35 = st.evaluate(node.eval_2nx2n, sz, ctx_top, ctx_left,
                                  flags, blk_orig)
    for pm in range(35):
        t_enc = o_enc.copy()
        t_ctxs = st.trial_contexts(o_ctxs)
        put_split_cu_flag(t_enc, t_ctxs, sz, 0, larger_left, larger_above)
        put_cu_2nx2n(t_enc, t_ctxs, sz, pm, pmode_left, pmode_above, q35[pm])
        cost = rd_cost(q, int(sse35[pm]), t_enc.bit_len() - o_len)
        if best >= cost:
            best = cost
            st.enc, st.ctxs = t_enc, t_ctxs
            best_rcon = r35[pm]
            st.fill_maps(y, x, sz, sz, pm)

    # ---- step 3: 2Nx2N with 4 TUs, all 35 modes ----
    q4, r35s, sse35s = st.evaluate(node.eval_tusplit, sz, ctx_top,
                                   ctx_left, flags, blk_orig)
    for pm in range(35):
        t_enc = o_enc.copy()
        t_ctxs = st.trial_contexts(o_ctxs)
        put_split_cu_flag(t_enc, t_ctxs, sz, 0, larger_left, larger_above)
        put_cu_2nx2n_tusplit(t_enc, t_ctxs, sz, pm, pmode_left, pmode_above,
                             q4[pm])
        cost = rd_cost(q, int(sse35s[pm]), t_enc.bit_len() - o_len)
        if best >= cost:
            best = cost
            st.enc, st.ctxs = t_enc, t_ctxs
            best_rcon = r35s[pm]
            st.fill_maps(y, x, sz, sz, pm)

    # ---- step 4: NxN: 4 PUs, each 35-mode searched at a fresh-coder rate,
    #      then rated jointly (src/HEVCe.c:1491-1557). Each PU's recon is
    #      written into the plane before the decision: the next PU's
    #      borders read it ----
    if sz == C.MIN_CU_SZ:
        h = sz // 2
        sf = _sub_flags(bll, blb, baa, bar)
        sub_pmodes = [0] * 4
        sub_quants = [None] * 4
        for isub, (oy, ox) in enumerate(_SUB_OFFS):
            py, px = y + oy * h, x + ox * h
            ctx_t, ctx_l = st.ctx_slices(py, px, h)
            fl = np.array(sf[isub], bool)
            qq, rr, ss = st.evaluate(node.eval_2nx2n, h, ctx_t, ctx_l, fl,
                                     st.orig_block(py, px, h))
            sub_best = I32_MAX
            for pm in range(35):
                n_enc = CabacEncoder()
                n_ctxs = new_context_set(q)
                put_coef(n_enc, n_ctxs, h, False, pm, qq[pm])
                cost = rd_cost(q, int(ss[pm]), n_enc.bit_len())
                if sub_best >= cost:
                    sub_best = cost
                    sub_pmodes[isub] = pm
                    sub_quants[isub] = qq[pm]
                    st.rcon[py:py + h, px:px + h] = rr[pm]
        # MPM neighbour wiring of the 4 PUs (src/HEVCe.c:1531-1538)
        lefts = [pmode_left, sub_pmodes[0],
                 st.left_pmode(y + h, x), sub_pmodes[2]]
        aboves = [pmode_above, st.above_pmode(y, x + h),
                  sub_pmodes[0], sub_pmodes[1]]
        t_enc = o_enc.copy()
        t_ctxs = st.trial_contexts(o_ctxs)
        put_split_cu_flag(t_enc, t_ctxs, sz, 0, larger_left, larger_above)
        put_cu_nxn(t_enc, t_ctxs, sz, sub_pmodes, lefts, aboves, sub_quants)
        dist = _sse(blk_orig, st.rcon[y:y + sz, x:x + sz])
        cost = rd_cost(q, dist, t_enc.bit_len() - o_len)
        if best >= cost:
            st.enc, st.ctxs = t_enc, t_ctxs
            st.fill_maps(y, x, sz, sz, 0)
            for isub, (oy, ox) in enumerate(_SUB_OFFS):
                st.fill_pmode(y + oy * h, x + ox * h, h, sub_pmodes[isub])
            return  # the PU recons are already in the plane

    st.rcon[y:y + sz, x:x + sz] = best_rcon


def encode_image(img: np.ndarray, qpd6: int, device="cpu"):
    """(stream bytes, recon (CTU-padded dims)) of one 8-bit grayscale image,
    as the reference encoder makes them."""
    dev = normal(device)
    st = _EncodeState(np.ascontiguousarray(img, np.uint8), qpd6, dev)
    out = bytearray(write_headers(qpd6, st.yszn, st.xszn))
    for y in range(0, st.yszn, C.CTU_SZ):
        st.ctu_y = y
        for x in range(0, st.xszn, C.CTU_SZ):
            bll = x > 0
            baa = y > 0
            bar = baa and (x + C.CTU_SZ < st.xszn)
            _process_cu(st, y, x, C.CTU_SZ, bll, False, baa, bar)
            last = (y + C.CTU_SZ >= st.yszn) and (x + C.CTU_SZ >= st.xszn)
            st.enc.encode_terminate(int(last))
            out += st.enc.buf           # drain per CTU (src/HEVCe.c:1631)
            st.enc.buf = bytearray()
        st.scroll_maps()
    st.enc.finish()
    out += st.enc.buf
    return bytes(out), st.rcon


# ------------------------------------------------------------------ entries

@contextlib.contextmanager
def transform_dtype(dtype):
    """run the transform products in `dtype` (float64 is exact; the
    lower-precision control runs int16) inside the block."""
    old = xform.DTYPE
    xform.DTYPE = dtype
    try:
        yield
    finally:
        xform.DTYPE = old


@contextlib.contextmanager
def initial_context_rates():
    """price every trial encode from the slice's initial context states
    instead of the live ones inside the block (a control: the committed
    coder then carries those states on)."""
    global LIVE_CONTEXTS
    old = LIVE_CONTEXTS
    LIVE_CONTEXTS = False
    try:
        yield
    finally:
        LIVE_CONTEXTS = old


def _encode_one(args):
    """encode_image in a worker process, under the caller's knobs."""
    img, qpd6, device, dtype, live, threads = args
    global LIVE_CONTEXTS
    torch.set_num_threads(threads)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    xform.DTYPE, LIVE_CONTEXTS = dtype, live
    return encode_image(img, qpd6, device)


def encode_streams(images, qpd6: int, device):
    """[(stream, recon)] of each image, each encoded alone: one image in
    this process, several at once in spawned worker processes, one an
    image."""
    images = [np.ascontiguousarray(im, np.uint8) for im in images]
    device = str(normal(device))
    if len(images) == 1:
        old = (torch.backends.cuda.matmul.allow_tf32,
               torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        try:
            return [encode_image(images[0], qpd6, device)]
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = old
    threads = max(1, min(4, (os.cpu_count() or 1) // len(images)))
    jobs = [(im, qpd6, device, xform.DTYPE, LIVE_CONTEXTS, threads)
            for im in images]
    with multiprocessing.get_context("spawn").Pool(len(images)) as pool:
        return pool.map(_encode_one, jobs, chunksize=1)


def encode_recon(images, qpd6: int, device):
    """the reference encoder's reconstruction of each image: a list of
    (yp, xp) uint8 arrays, the image planes padded up to whole CTUs."""
    return [r for _, r in encode_streams(images, qpd6, device)]
