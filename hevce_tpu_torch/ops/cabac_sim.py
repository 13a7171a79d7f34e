"""Exact CABAC rate simulation over many independent lanes (plain PyTorch).

Simulates the reference arithmetic coder (reference src/HEVCe.c:791-933) for
many candidates at once: lanes = candidates, one step advances every lane by
one packed op. State per lane is 7 int32 scalars plus a context vector (the
full 142 entries, or a palette of them); the byte sink is simulated by
COUNTING bytes, start-code emulation-prevention 0x03 insertions included,
without materialising them, which is all CABAClen needs
(src/HEVCe.c:835-837).

  * Bypass runs advance up to 8 bins per op with the reference's own
    CABACputBins chunking, so low/nbits evolve chunk for chunk.
  * Emulation-prevention counting over a run of k identical carry-fill
    bytes uses a closed form of the zero-run automaton (z in {0,1,2}).
  * int32 arithmetic wraps exactly as the reference's (PyTorch's int32
    shifts and sums wrap; >> is arithmetic).

This is the plain version of kernel K2 (ops/cabac_scan). Op encoding
(int32), kind = op & 3:
  0 context-coded bin: ctx_idx << 2 | bin << 10
  1 bypass RUN of 1..8 bins (src/HEVCe.c:899-911): len << 2 | value << 6
  2 terminate bin: bin << 10
  3 nop (padding)
"""
import numpy as np
import torch

from hevce_tpu_torch.bitstream import cabac as cb
from hevce_tpu_torch.bitstream import syntax
from hevce_tpu_torch.utils import device as _device

NUM_CTX = cb.NUM_CTX
KIND_CTX, KIND_BYPASS, KIND_TERM, KIND_NOP = 0, 1, 2, 3
# the 7 coder scalars of a lane, in the order kernel K2 stores them
FIELDS = ("rng", "low", "nbits", "outstanding", "bufbyte", "zrun", "nbytes")


def pack_op(kind, ctx_idx=0, binval=0):
    return kind | (ctx_idx << 2) | (binval << 10)


def pack_bypass(value, length):
    """one bypass run op (1 <= length <= 8)."""
    assert 1 <= length <= 8
    return KIND_BYPASS | (length << 2) | ((value & 0xFF) << 6)


def split_bypass(value, length):
    """(value, len) chunks of <= 8 bins, MSB first: the reference's
    CABACputBins split (src/HEVCe.c:899-911)."""
    value &= (1 << length) - 1
    out = []
    while length > 0:
        cur = min(length, 8)
        length -= cur
        out.append(((value >> length) & ((1 << cur) - 1), cur))
    return out


@_device.cached_per_device
def _context_row(qpd6: int, device: torch.device):
    """the initial context states at qpd6 as an int32 row on `device`,
    uploaded once."""
    return torch.as_tensor(
        np.frombuffer(bytes(cb.new_context_set(qpd6)), np.uint8).astype(
            np.int32), device=device)


def initial_state(lanes: int, qpd6: int, device="cpu"):
    """fresh coder + contexts per lane (src/HEVCe.c:809-812, :762-785)."""
    dev = torch.device(device)
    ctxs = _context_row(qpd6, dev).repeat(lanes, 1)
    z = torch.zeros((lanes,), dtype=torch.int32, device=dev)
    return dict(rng=z + 510, low=z, nbits=z + 23, outstanding=z,
                bufbyte=z + 0xFF, zrun=z, nbytes=z, ctxs=ctxs)


def bit_len(state):
    """exact fractional bit count (src/HEVCe.c:835-837)."""
    return 8 * (state["nbytes"] + state["outstanding"]) + 23 - state["nbits"]


@_device.cached_per_device
def _tables(device: torch.device):
    """int32 tensors on `device`: the LPS range table (flat, index
    4*state + q), the LPS and MPS next-state tables and the single-shot
    renorm shift per (lps >> 3). (Kernel K2 takes its own packed form,
    ops/cabac_scan.kernel_tables.)"""
    return tuple(torch.as_tensor(np.asarray(p, np.int32), device=device)
                 for p in (cb.LPS_TABLE.reshape(-1), cb.NEXT_STATE_LPS,
                           cb.NEXT_STATE_MPS, cb.RENORM_TABLE))


def _emit_run(nbytes, zrun, byte, k):
    """count k emitted copies of `byte` through the emulation-prevention sink
    (src/HEVCe.c:821-832); returns (nbytes', zrun'). k >= 0 per lane."""
    is_zero = byte == 0
    has = k > 0
    # single-insert case (nonzero byte <= 3): one 0x03 iff zrun >= 2
    ins_nonzero = (has & (byte <= 3) & ~is_zero & (zrun >= 2)).to(torch.int32)
    # zero-byte run: automaton z in {0,1,2}: pre-state 2 -> insert, z<-1;
    # else z+1. first = byte index of the first insert.
    first = torch.where(zrun >= 2, 1, 3 - zrun)
    ins_zero = torch.where(k >= first, 1 + (k - first) // 2, 0)
    zrun_zero = torch.where(ins_zero > 0, 1 + (k - first) % 2, zrun + k)
    inserts = torch.where(is_zero, ins_zero, ins_nonzero)
    nbytes2 = nbytes + k + torch.where(has, inserts, 0)
    zrun2 = torch.where(has, torch.where(is_zero, zrun_zero, 0), zrun)
    return nbytes2, zrun2


def _refill(rng, low, nbits, outstanding, bufbyte, zrun, nbytes):
    """carry resolution + byte extraction (src/HEVCe.c:859-879), per lane."""
    need = nbits < 12
    lead = low >> torch.clamp(24 - nbits, 0, 31)
    nbits2 = torch.where(need, nbits + 8, nbits)
    one = torch.ones_like(low)
    mask = (one << torch.clamp(32 - nbits2, 0, 31)) - 1
    low2 = torch.where(need, low & mask, low)

    is_ff = lead == 0xFF
    flush = need & ~is_ff & (outstanding > 0)
    fresh = need & ~is_ff & (outstanding == 0)

    carry = lead >> 8
    b1 = (bufbyte + carry) & 0xFF
    fill = (0xFF + carry) & 0xFF
    # emit b1 then (outstanding-1) copies of fill, only on flush lanes
    n_a, z_a = _emit_run(nbytes, zrun, b1, flush.to(torch.int32))
    n_b, z_b = _emit_run(n_a, z_a, fill,
                         torch.where(flush, outstanding - 1, 0))
    outstanding2 = torch.where(need & is_ff, outstanding + 1,
                               torch.where(flush | fresh, 1, outstanding))
    bufbyte2 = torch.where(flush | fresh, lead & 0xFF, bufbyte)
    return rng, low2, nbits2, outstanding2, bufbyte2, z_b, n_b


def _step(state, op):
    """advance every lane by one op (lanes,) int32."""
    rng, low, nbits = state["rng"], state["low"], state["nbits"]
    outstanding, bufbyte = state["outstanding"], state["bufbyte"]
    zrun, nbytes, ctxs = state["zrun"], state["nbytes"], state["ctxs"]
    lps_tab, next_lps, next_mps, renorm = _tables(op.device)

    kind = op & 3
    b = (op >> 10) & 1
    byp_len = (op >> 2) & 0xF
    byp_val = (op >> 6) & 0xFF
    is_ctx = kind == KIND_CTX
    is_byp = kind == KIND_BYPASS
    is_term = kind == KIND_TERM
    active = kind != KIND_NOP

    # --- context-coded bin (src/HEVCe.c:914-933): an indexed load and
    # store of the lane's context; other kinds read slot 0 and write it back
    cidx = torch.where(is_ctx, (op >> 2) & 0xFF, 0).long()[:, None]
    v = ctxs.gather(1, cidx)[:, 0]
    lps = lps_tab[(v >> 1) * 4 + ((rng >> 6) & 3)]
    r1 = rng - lps
    is_lps = b != (v & 1)
    nbit = renorm[lps >> 3]
    mps_renorm = r1 < 256
    ctx_low = torch.where(is_lps, (low + r1) << nbit,
                          torch.where(mps_renorm, low << 1, low))
    ctx_rng = torch.where(is_lps, lps << nbit,
                          torch.where(mps_renorm, r1 << 1, r1))
    ctx_nbits = nbits - torch.where(is_lps, nbit,
                                    mps_renorm.to(torch.int32))
    newv = torch.where(is_ctx, torch.where(is_lps, next_lps[v], next_mps[v]),
                       v)

    # --- bypass run of 1..8 bins (src/HEVCe.c:899-911, chunk-exact)
    byp_low = (low << byp_len) + rng * byp_val
    byp_nbits = nbits - byp_len

    # --- terminate bin (src/HEVCe.c:882-896)
    r2 = rng - 2
    term_renorm = (r2 < 256) & (b == 0)
    term_low = torch.where(b == 1, (low + r2) << 7,
                           torch.where(term_renorm, low << 1, low))
    term_rng = torch.where(b == 1, 2 << 7,
                           torch.where(term_renorm, r2 << 1, r2))
    term_nbits = nbits - torch.where(b == 1, 7,
                                     term_renorm.to(torch.int32))

    low2 = torch.where(is_ctx, ctx_low, torch.where(
        is_byp, byp_low, torch.where(is_term, term_low, low)))
    rng2 = torch.where(is_ctx, ctx_rng, torch.where(is_term, term_rng, rng))
    nbits2 = torch.where(is_ctx, ctx_nbits, torch.where(
        is_byp, byp_nbits, torch.where(is_term, term_nbits, nbits)))
    ctxs2 = ctxs.scatter(1, cidx, newv[:, None])

    # nop lanes keep everything (the refill included)
    rng3, low3, nbits3, out3, buf3, zrun3, nbytes3 = _refill(
        rng2, low2, nbits2, outstanding, bufbyte, zrun, nbytes)
    keep = lambda new, old: torch.where(active, new, old)
    return dict(rng=keep(rng3, rng), low=keep(low3, low),
                nbits=keep(nbits3, nbits), outstanding=keep(out3, outstanding),
                bufbyte=keep(buf3, bufbyte), zrun=keep(zrun3, zrun),
                nbytes=keep(nbytes3, nbytes), ctxs=ctxs2)


def simulate(state, ops):
    """Advance all lanes through their op strings.

    state: dict from initial_state() (lanes,) / (lanes, P) int32;
    ops: (lanes, L) int32 packed ops, nop-padded.
    Returns the final state; bit_len(final) - bit_len(initial) is each
    lane's exact rate in bits (the reference CABAClen unit)."""
    for t in range(ops.shape[1]):
        state = _step(state, ops[:, t])
    return state


def simulate_chunked(state, ops, nops):
    """simulate() that stops after the last real op across all lanes.

    ops: (lanes, L), nop-padded past each lane's count; nops: (lanes,)
    actual op counts. Only columns below max(nops) run: the padded cap
    bounds memory, not work."""
    n = int(nops.max()) if nops.numel() else 0
    return simulate(state, ops[:, :min(n, ops.shape[1])])


class OpRecorder:
    """Drop-in 'encoder' for syntax writers that records packed ops instead
    of doing arithmetic coding: builds op strings for the simulation."""

    def __init__(self):
        self.ops = []

    def encode_bin(self, ctxs, idx, binval):
        # context values evolve in the simulation; the recorder only notes
        # the index
        self.ops.append(pack_op(KIND_CTX, idx, int(bool(binval))))

    def encode_bypass(self, bins, length):
        for v, n in split_bypass(bins, length):
            self.ops.append(pack_bypass(v, n))

    def encode_terminate(self, binval):
        self.ops.append(pack_op(KIND_TERM, 0, int(bool(binval))))


def record_put_coef(sz, pmode, blk):
    """Op string of a fresh-coder putCoef rate (the reference's step-4 PU
    rate, src/HEVCe.c:1505-1519). The writer branches only on the data,
    never on context values, so a dummy context vector serves."""
    rec = OpRecorder()
    syntax.put_coef(rec, bytearray(cb.NUM_CTX), sz, False, pmode, blk)
    return rec.ops
