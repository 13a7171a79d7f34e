"""Reference-exact image encoder: host RD arbiter + candidate evaluation on
the device.

The sequential (per-image) encode path and the readable specification of
the reference search (processCURecurs, reference src/HEVCe.c:1346-1560, and
the CTU raster loop :1566-1647): this arbiter owns the live CABAC coder and
contexts, runs the speculative trial encodes and commits the winners, so
its streams are bit-identical to the reference encoder's. Each CU node's
35-mode candidates come from models/cu_eval: eval_2nx2n (one K1 launch on
the card) and the dense eval_tusplit (four) per node, and eval_2nx2n per
NxN PU, 169 K1 launches per CTU at one row of 35 candidates each. Each
evaluation replays a program of its (fn, sz, qpd6, device) (_eval_program,
a CUDA graph on the card).

The batched production paths are parallel/lockstep (bit-exact) and the
native C++ engine (runtime/native), which runs this same algorithm.
"""
import functools

import numpy as np
import torch

from hevce_tpu_torch.bitstream import cabac as cb
from hevce_tpu_torch.bitstream import headers, syntax
from hevce_tpu_torch.models import cu_eval
from hevce_tpu_torch.ops import constants as C
from hevce_tpu_torch.utils import device as _device
from hevce_tpu_torch.utils import graphs
from hevce_tpu_torch.utils.tracing import PhaseTimer

I32_MAX = 2 ** 31 - 1
_WDIST = [11, 11, 11, 5, 1]
_WBITS = [1, 4, 16, 29, 23]


def rd_cost(qpd6: int, dist: int, bits: int) -> int:
    """saturating RD cost on host ints (reference src/HEVCe.c:177-185)."""
    w1, w2 = _WDIST[qpd6], _WBITS[qpd6]
    c1 = I32_MAX if I32_MAX // w1 <= dist else w1 * dist
    c2 = I32_MAX if I32_MAX // w2 <= bits else w2 * bits
    return I32_MAX if I32_MAX - c1 <= c2 else c1 + c2


def _sse(a, b) -> int:
    d = a.astype(np.int64) - b.astype(np.int64)
    return int((d * d).sum())


@functools.lru_cache(maxsize=None)
def _eval_program(fn, sz: int, qpd6: int,
                  device: torch.device) -> graphs.Program:
    """fn (cu_eval.eval_2nx2n or eval_tusplit) of one node at (sz, qpd6) as a
    program (utils/graphs.Program; the JAX package's jit_eval_2nx2n(sz, qpd6)
    / jit_eval_tusplit(sz, qpd6)): inputs ctx_top (1 + 2sz), ctx_left (2sz),
    the four flags and the originals (sz, sz), one row; outputs and fetched
    its (quant, recon, sse). On the card a replay launches K1 once
    (eval_2nx2n) or four times (eval_tusplit). device must carry its index
    (utils/device.normal)."""
    def step(top, left, flags, orig):
        return fn(sz, qpd6, top, left, flags != 0, orig)
    return graphs.Program(fn.__name__, [(1 + 2 * sz,), (2 * sz,), (4,),
                                        (sz, sz)], step, device,
                          fetch=(0, 1, 2))


class _EncodeState:
    """Per-image mutable encode state owned by the arbiter."""

    def __init__(self, img, qpd6, dev, timer):
        self.qpd6 = qpd6
        self.dev = _device.normal(dev)
        self.timer = timer
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
        self.enc = cb.CabacEncoder()
        self.ctxs = cb.new_context_set(qpd6)
        self.ctu_y = 0  # global y of the current CTU row (map row indexing)

    # --- candidate evaluation on the device ---

    def evaluate(self, fn, sz, ctx_top, ctx_left, flags, blk_orig):
        """cu_eval.eval_2nx2n or the dense eval_tusplit of one node on the
        device, as a replay of its program (_eval_program); its (quant,
        recon, sse) come back to the host in arrays of their own."""
        prog = _eval_program(fn, sz, self.qpd6, self.dev)
        with self.timer.phase("device_eval"), torch.no_grad():
            prog.load([ctx_top, ctx_left, flags, blk_orig])
            prog()
            return [h.copy() for h in prog.fetched()]

    # --- clamped-read helpers (GET2D semantics, reference src/HEVCe.c:119) ---

    def orig_block(self, y, x, sz):
        """original pixels with edge replication from the UNPADDED dims
        (reference src/HEVCe.c:1620-1622)."""
        yy = np.clip(np.arange(y, y + sz), 0, self.ysz0 - 1)
        xx = np.clip(np.arange(x, x + sz), 0, self.xsz0 - 1)
        return self.img[np.ix_(yy, xx)].astype(np.int32)

    def ctx_slices(self, y, x, sz):
        """(ctx_top (1+2sz), ctx_left (2sz)) reconstructed-neighbour reads
        clamped to the PADDED plane (src/HEVCe.c:1614-1618); values at
        masked positions are arbitrary by construction."""
        tx = np.clip(np.arange(x - 1, x + 2 * sz), 0, self.xszn - 1)
        ty = max(min(y - 1, self.yszn - 1), 0)
        ctx_top = self.rcon[ty, tx].astype(np.int32)
        ly = np.clip(np.arange(y, y + 2 * sz), 0, self.yszn - 1)
        lx = max(min(x - 1, self.xszn - 1), 0)
        ctx_left = self.rcon[ly, lx].astype(np.int32)
        return ctx_top, ctx_left

    # --- context-map accessors (line buffers, src/HEVCe.c:1592-1600) ---

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
        syntax.put_split_cu_flag(st.enc, st.ctxs, sz, 1, larger_left,
                                 larger_above)
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
    q35, r35, sse35 = st.evaluate(cu_eval.eval_2nx2n, sz, ctx_top, ctx_left,
                                  flags, blk_orig)
    for pm in range(35):
        t_enc = o_enc.copy()
        t_ctxs = bytearray(o_ctxs)
        syntax.put_split_cu_flag(t_enc, t_ctxs, sz, 0, larger_left,
                                 larger_above)
        syntax.put_cu_2nx2n(t_enc, t_ctxs, sz, pm, pmode_left, pmode_above,
                            q35[pm])
        cost = rd_cost(q, int(sse35[pm]), t_enc.bit_len() - o_len)
        if best >= cost:
            best = cost
            st.enc, st.ctxs = t_enc, t_ctxs
            best_rcon = r35[pm]
            st.fill_maps(y, x, sz, sz, pm)

    # ---- step 3: 2Nx2N with 4 TUs, all 35 modes ----
    q4, r35s, sse35s = st.evaluate(cu_eval.eval_tusplit, sz, ctx_top,
                                   ctx_left, flags, blk_orig)
    for pm in range(35):
        t_enc = o_enc.copy()
        t_ctxs = bytearray(o_ctxs)
        syntax.put_split_cu_flag(t_enc, t_ctxs, sz, 0, larger_left,
                                 larger_above)
        syntax.put_cu_2nx2n_tusplit(t_enc, t_ctxs, sz, pm, pmode_left,
                                    pmode_above, q4[pm])
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
            qq, rr, ss = st.evaluate(cu_eval.eval_2nx2n, h, ctx_t, ctx_l, fl,
                                     st.orig_block(py, px, h))
            sub_best = I32_MAX
            for pm in range(35):
                n_enc = cb.CabacEncoder()
                n_ctxs = cb.new_context_set(q)
                syntax.put_coef(n_enc, n_ctxs, h, False, pm, qq[pm])
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
        t_ctxs = bytearray(o_ctxs)
        syntax.put_split_cu_flag(t_enc, t_ctxs, sz, 0, larger_left,
                                 larger_above)
        syntax.put_cu_nxn(t_enc, t_ctxs, sz, sub_pmodes, lefts, aboves,
                          sub_quants)
        dist = _sse(blk_orig, st.rcon[y:y + sz, x:x + sz])
        cost = rd_cost(q, dist, t_enc.bit_len() - o_len)
        if best >= cost:
            st.enc, st.ctxs = t_enc, t_ctxs
            st.fill_maps(y, x, sz, sz, 0)
            for isub, (oy, ox) in enumerate(_SUB_OFFS):
                st.fill_pmode(y + oy * h, x + ox * h, h, sub_pmodes[isub])
            return  # the PU recons are already in the plane

    st.rcon[y:y + sz, x:x + sz] = best_rcon


def encode_image(img: np.ndarray, qpd6: int, device=None, timer=None):
    """Encode one 8-bit grayscale image; the reference's HEVCImageEncoder
    contract (reference src/HEVCe.h:5-12): returns (stream bytes, recon
    (CTU-padded dims)), byte-identical to runtime/native's
    encode_image_native.

    device=None evaluates the candidates on the card (kernel K1) and raises
    without CUDA; "cpu" runs K1's plain version. timer: optional
    utils.tracing.PhaseTimer; its 'device_eval' phase holds the candidate
    evaluation (enqueue and copy back), the rest of the wall is the host's
    trial encodes."""
    if not (isinstance(img, np.ndarray) and img.dtype == np.uint8
            and img.ndim == 2):
        raise ValueError("encode_image takes a 2-D uint8 image")
    if not 0 <= qpd6 <= 4:
        raise ValueError(f"qpd6 must be 0-4, got {qpd6}")
    dev = _device.resolve(device)
    st = _EncodeState(img, qpd6, dev, timer if timer is not None
                      else PhaseTimer())
    out = bytearray(headers.write_headers(qpd6, st.yszn, st.xszn))

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
