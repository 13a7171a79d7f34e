"""The port's CABAC rate simulation and K2's plain version against the JAX
package's, on the CPU, exactly (tolerance 0).

Op strings come from the golden traces, from the JAX package's
record_put_coef, from numpy-seeded random draws, and from adversarial
generators (long LPS runs that build up outstanding bytes, carries into
0xFF runs, 0x00 runs that force emulation-prevention bytes). The Pallas
kernel runs in interpret mode, as the JAX package's own tests run it.
"""
import numpy as np
import pytest
import torch

from hevce_tpu.bitstream import cabac as jcb
from hevce_tpu.ops import cabac_pallas as jcp
from hevce_tpu.ops import cabac_sim as jsim
from hevce_tpu_torch.bitstream import cabac as tcb
from hevce_tpu_torch.ops import cabac_scan
from hevce_tpu_torch.ops import cabac_sim as sim
from hevce_tpu_torch.tools import bench_k2

# the test workers share the machine's cores: one intra-op thread each
torch.set_num_threads(1)

FIELDS = sim.FIELDS


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _ctxs_for(qpd6_list):
    return np.stack([
        np.frombuffer(bytes(tcb.new_context_set(int(q))), np.uint8).astype(
            np.int32) for q in qpd6_list])


def _pad(strings):
    L = max(len(o) for o in strings)
    ops = np.full((len(strings), L), sim.KIND_NOP, np.int32)
    for i, o in enumerate(strings):
        ops[i, :len(o)] = o
    return ops, np.array([len(o) for o in strings], np.int32)


def _port_state(lanes, qpd6, ctxs=None):
    st = sim.initial_state(lanes, qpd6)
    if ctxs is not None:
        st["ctxs"] = _t(ctxs)
    return st


def _jax_state(lanes, qpd6, ctxs=None):
    st = {k: np.asarray(v) for k, v in jsim.initial_state(lanes, qpd6).items()}
    if ctxs is not None:
        st["ctxs"] = ctxs
    return st


def _assert_same(got, want, keys=FIELDS + ("ctxs",)):
    for k in keys:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)


def test_tables_equal_jax_package():
    for name in ("LPS_TABLE", "NEXT_STATE_MPS", "NEXT_STATE_LPS",
                 "CTX_INIT_VALUES"):
        np.testing.assert_array_equal(getattr(tcb, name), getattr(jcb, name))
    for name in [n for n in dir(jcb) if n.startswith("CTX_")] + ["NUM_CTX"]:
        if name != "CTX_INIT_VALUES":
            assert getattr(tcb, name) == getattr(jcb, name), name
    for q in range(5):
        assert tcb.new_context_set(q) == jcb.new_context_set(q)
    assert sim.split_bypass(0x1ABCD, 17) == jsim.split_bypass(0x1ABCD, 17)
    assert sim.pack_bypass(200, 8) == jsim.pack_bypass(200, 8)
    assert sim.pack_op(sim.KIND_CTX, 141, 1) == jsim.pack_op(jsim.KIND_CTX, 141, 1)


def test_k2_table_tensor_layout():
    """K2 reads the LPS range table packed as 64 little-endian words (byte q
    of word s = LPS_TABLE[s, q]) at 0 and the LPS next-state table at 64
    (csrc/cabac_scan.cu): unpacked, they are the JAX package's tables."""
    tab = cabac_scan.kernel_tables(torch.device("cpu"))
    assert tab.dtype == torch.int32 and tab.shape == (64 + 128,)
    words = tab[:64].numpy().view(np.uint32)
    unpacked = np.stack([(words >> (8 * q)) & 0xFF for q in range(4)], 1)
    np.testing.assert_array_equal(unpacked, jcb.LPS_TABLE)
    np.testing.assert_array_equal(tab[64:].numpy(), jcb.NEXT_STATE_LPS)
    # every LPS range fits the byte it is packed in
    assert 2 <= jcb.LPS_TABLE.min() and jcb.LPS_TABLE.max() <= 255


def test_k2_shift_count_from_clz_equals_the_reference():
    """K2's renormalisation shift min(clz(lps) - 23, 6), clz of a 32-bit
    word, equals the JAX kernel's five-compare count on every table value."""
    for lps in np.unique(jcb.LPS_TABLE):
        li = int(lps) >> 3
        want = 6 - ((li >= 1) + (li >= 2) + (li >= 4) + (li >= 8)
                    + (li >= 16))
        clz = 32 - int(lps).bit_length()
        assert min(clz - 23, 6) == want, lps
    np.testing.assert_array_equal(
        sim._tables(torch.device("cpu"))[3].numpy()[jcb.LPS_TABLE >> 3],
        np.minimum(32 - np.vectorize(int.bit_length)(
            jcb.LPS_TABLE.astype(object)) - 23, 6))


def test_k2_mps_next_state_arithmetic_equals_the_table():
    """K2's MPS next state: state s = v >> 1 steps to s + (s < 62), the MPS
    bit kept, over all 128 packed values (126 / 127 stay put)."""
    v = np.arange(128)
    s = v >> 1
    np.testing.assert_array_equal(((s + (s < 62)) << 1) | (v & 1),
                                  jcb.NEXT_STATE_MPS)
    np.testing.assert_array_equal(v + 2 * (s < 62), jcb.NEXT_STATE_MPS)


@pytest.mark.parametrize("kind", bench_k2.DIAG_KINDS + ("random",
                                                        "adversarial"))
def test_k2_tool_strings_are_nop_padded(kind):
    """the K2 tool's strings keep K2's contract: nops past each lane's
    count, real ops before it; the plain version runs them."""
    rng = np.random.default_rng(3)
    dev = torch.device("cpu")
    if kind in bench_k2.DIAG_KINDS:
        state, ops, nops = bench_k2.k2_diag_inputs(dev, rng, kind, 5, 24, 9,
                                                   17)
        assert (nops == 17).all()
    else:
        state, ops, nops = bench_k2.k2_synthetic_inputs(
            dev, rng, 5, 24, 9, kind == "adversarial")
    past = torch.arange(24)[None, :] >= nops[:, None]
    assert ((ops & 3) == sim.KIND_NOP)[past].all()
    assert ((ops & 3) != sim.KIND_NOP)[~past].all()
    assert state["ctxs"].shape == (5, 9)
    ctx = (ops & 3) == sim.KIND_CTX
    assert (((ops >> 2) & 0xFF)[ctx] < 9).all()
    if kind == "one_slot":
        assert (((ops >> 2) & 0xFF)[ctx] == 0).all()
    got = cabac_scan.scan_plain(state, ops, nops)
    assert (sim.bit_len(got) > sim.bit_len(state)).all()


def test_k2_tool_compare_raises_on_a_difference():
    state = sim.initial_state(3, 2)
    assert bench_k2.compare(state, dict(state), "here") == 0
    bad = dict(state, nbytes=state["nbytes"] + torch.tensor([0, 0, 2],
                                                            dtype=torch.int32))
    with pytest.raises(bench_k2.Mismatch, match="nbytes .* max \\|err\\| 2"):
        bench_k2.compare(bad, state, "here")


def test_k2_tool_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the tool runs there")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench_k2.main([])


# ------------------------------------------------------------------ golden

def _trace_ops(g, t):
    """pack one golden op trace (bypass runs chunked by 8, like the coder)."""
    ops = []
    for i in range(g["kind"].shape[1]):
        kind = int(g["kind"][t, i])
        a, b = int(g["a"][t, i]), int(g["b"][t, i])
        if kind == 0:
            ops.append(sim.pack_op(sim.KIND_CTX, a, b))
        elif kind == 1:
            ops += [sim.pack_bypass(v, n) for v, n in sim.split_bypass(a, b)]
        else:
            ops.append(sim.pack_op(sim.KIND_TERM, 0, 0))
    return ops


def test_simulate_matches_golden_cabac(golden):
    g = dict(golden("cabac"))          # read each array once
    ops, nops = _pad([_trace_ops(g, t) for t in range(len(g["qpd6"]))])
    final = sim.simulate(_port_state(len(ops), 0, _ctxs_for(g["qpd6"])),
                         _t(ops))
    np.testing.assert_array_equal(sim.bit_len(final).numpy(),
                                  g["length"][:, -1])
    np.testing.assert_array_equal(final["ctxs"].numpy(),
                                  g["ctxs"].astype(np.int32))


def test_simulate_matches_golden_putcoef(golden):
    """op strings from the JAX package's record_put_coef."""
    g = dict(golden("putcoef"))
    strings = [jsim.record_put_coef(int(sz), int(pm), blk[:sz, :sz])
               for sz, pm, blk in zip(g["sz"], g["pmode"], g["blk"])]
    ops, nops = _pad(strings)
    final = sim.simulate(_port_state(len(ops), 0, _ctxs_for(g["qpd6"])),
                         _t(ops))
    np.testing.assert_array_equal(sim.bit_len(final).numpy(), g["length"])
    np.testing.assert_array_equal(final["ctxs"].numpy(),
                                  g["ctxs"].astype(np.int32))
    # K2's plain version, with per-lane counts, gives the same
    plain = cabac_scan.scan_plain(
        _port_state(len(ops), 0, _ctxs_for(g["qpd6"])), _t(ops), _t(nops))
    np.testing.assert_array_equal(sim.bit_len(plain).numpy(), g["length"])


# ------------------------------------------------------------------ random

def _random_ops(rng, lanes, L, P=tcb.NUM_CTX):
    ops = np.full((lanes, L), sim.KIND_NOP, np.int32)
    nops = rng.integers(1, L + 1, lanes).astype(np.int32)
    for lane in range(lanes):
        for t in range(int(nops[lane])):
            k = rng.integers(0, 3)
            if k == 0:
                ops[lane, t] = sim.pack_op(sim.KIND_CTX, int(rng.integers(0, P)),
                                           int(rng.integers(0, 2)))
            elif k == 1:
                n = int(rng.integers(1, 9))
                ops[lane, t] = sim.pack_bypass(int(rng.integers(0, 1 << n)), n)
            else:
                ops[lane, t] = sim.pack_op(sim.KIND_TERM, 0,
                                           int(rng.random() < 0.1))
    return ops, nops


@pytest.mark.parametrize("qpd6", range(5))
def test_simulate_matches_jax_on_random_ops(qpd6):
    rng = np.random.default_rng(600 + qpd6)
    ops, _ = _random_ops(rng, 48, 160)
    want = jsim.simulate(_jax_state(48, qpd6), ops)
    got = sim.simulate(_port_state(48, qpd6), _t(ops))
    _assert_same(got, want)


@pytest.mark.parametrize("with_nops", [False, True])
def test_scan_plain_matches_pallas_interpret(with_nops):
    """K2's plain version against the Pallas kernel in interpret mode (on a
    39-slot palette, the PU step's), with and without per-lane counts."""
    rng = np.random.default_rng(11 + with_nops)
    lanes, L, P = jcp.TILE, 32, 39
    ops, nops = _random_ops(rng, lanes, L, P)
    if not with_nops:
        nops[:] = L
    ctxs = np.tile(_ctxs_for([2])[:, :P], (lanes, 1))
    want = jcp.simulate_pallas(_jax_state(lanes, 2, ctxs), ops,
                               nops=nops if with_nops else None,
                               interpret=True)
    got = cabac_scan.scan_plain(_port_state(lanes, 2, ctxs), _t(ops),
                                _t(nops))
    _assert_same(got, want, FIELDS)
    # and the JAX package's own plain scan, contexts included
    _assert_same(got, jsim.simulate_chunked(_jax_state(lanes, 2, ctxs), ops,
                                            nops))


# ------------------------------------------------------------- adversarial

class _Probe(jcb.CabacEncoder):
    """the JAX package's byte-emitting coder, counting what the adversarial
    strings are meant to exercise."""

    def __init__(self):
        super().__init__()
        self.max_outstanding = self.carries = self.emitted = 0

    def _emit(self, byte):
        self.emitted += 1
        super()._emit(byte)

    def _refill(self):
        if self.nbits < 12 and self.outstanding > 1:   # into 0xFF bytes
            self.carries += (self.low >> (24 - self.nbits)) >> 8
        super()._refill()
        self.max_outstanding = max(self.max_outstanding, self.outstanding)

    @property
    def inserts(self):
        return len(self.buf) - self.emitted


def _adversarial(rng, kind, n_ops, qpd6):
    """one op string, and the probe that coded it. 'lps': all-ones bypass
    runs between LPS bins, which build long runs of outstanding 0xFF bytes;
    'carry': runs of seven 1-bins between single random bins, whose
    additions carry into outstanding 0xFF runs; 'zero': all-zero bypass runs
    (0x00 bytes, emulation-prevention inserts) between LPS bins."""
    enc, ctxs = _Probe(), jcb.new_context_set(qpd6)
    ops = []

    def bypass(v, n):
        enc.encode_bypass(v, n)
        ops.append(sim.pack_bypass(v, n))

    def ctx_bin(lps):
        idx = 68 + int(rng.integers(0, 4))
        b = 1 - (ctxs[idx] & 1) if lps else ctxs[idx] & 1
        enc.encode_bin(ctxs, idx, b)
        ops.append(sim.pack_op(sim.KIND_CTX, idx, b))

    for _ in range(n_ops):
        r = rng.random()
        if kind == "lps":
            bypass(0xFF, 8) if r < 0.5 else ctx_bin(True)
        elif kind == "carry":
            bypass(0x7F, 7) if r < 0.5 else bypass(int(rng.integers(0, 2)), 1)
        else:
            bypass(0, 8) if r < 0.9 else ctx_bin(True)
    return ops, enc, ctxs


def test_adversarial_strings_match_jax_and_the_coder():
    rng = np.random.default_rng(77)
    strings, probes, ctx_end, qs = [], [], [], []
    for kind, count in (("lps", 6), ("carry", 12), ("zero", 6)):
        for i in range(count):
            q = i % 5
            ops, enc, ctxs = _adversarial(rng, kind, 300, q)
            strings.append(ops)
            probes.append(enc)
            ctx_end.append(np.frombuffer(bytes(ctxs), np.uint8))
            qs.append(q)
    # the strings reach what they are meant to reach
    assert max(p.max_outstanding for p in probes) >= 4
    assert sum(p.carries for p in probes) >= 3
    assert max(p.inserts for p in probes) >= 10
    ops, nops = _pad(strings)
    init = _ctxs_for(qs)
    got = cabac_scan.scan_plain(_port_state(len(ops), 0, init), _t(ops),
                                _t(nops))
    want = jsim.simulate_chunked(_jax_state(len(ops), 0, init), ops, nops)
    _assert_same(got, want)
    np.testing.assert_array_equal(sim.bit_len(got).numpy(),
                                  [p.bit_len() for p in probes])
    np.testing.assert_array_equal(got["ctxs"].numpy(),
                                  np.stack(ctx_end).astype(np.int32))
    np.testing.assert_array_equal(got["nbytes"].numpy(),
                                  [len(p.buf) for p in probes])


def test_recorder_matches_jax_recorder():
    rec, jrec = sim.OpRecorder(), jsim.OpRecorder()
    for r in (rec, jrec):
        r.encode_bin(None, 70, 1)
        r.encode_bypass(0x2345, 14)
        r.encode_terminate(1)
        r.encode_bin(None, 3, 0)
    assert rec.ops == jrec.ops
