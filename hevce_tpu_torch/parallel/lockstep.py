"""Lockstep batched encoding: card math + C++ host arbiters, bit-exact.

B same-sized images are encoded in parallel: B C++ worker threads walk the
content-independent CU search schedule; at every schedule event their
35-mode candidate requests rendezvous into ONE batch, which runs as tensor
work on the device (kernel K1 for every candidate evaluation, kernel K2 for
every trial rate), and the workers' RD arbiters (live CABAC state, trial
encodes) consume the results. Streams are identical to the sequential
reference encoder (runtime/native.encode_image_native).

Events, per CTU (csrc/hevce_host.cpp:2411-2416): 21 node events (one 32x32,
four 16x16, sixteen 8x8) and 64 PU events (four 4x4 PUs per 8x8), each
followed by a fetch event that returns only the winning lanes' quant and
recon. A node event runs eval_2nx2n and the dense eval_tusplit (5 K1
launches) and, with node_rates, the step-2/3 trial rates (one K2 launch);
a PU event runs eval_2nx2n(4) and put_coef_rates (one K1, one K2 launch).

With pipeline=True the batch is split into two halves, each its own
engine. Every round completes both halves, then dispatches both, so each
half's C++ arbiters run on their worker threads while the Python thread
serves the other half. Each half runs a whole event's kernels, thousands
of small ones, and they bound the path on the card, so there the split is
slower (PERF.md); it is kept for parity with the JAX package's API.
Bit-exact either way.

With a mesh (parallel/batch) every node and PU step splits its batch over
the mesh's devices, one equal part each; each part's results come back to
the host on their own, and the arbitration stays per image, so the streams
do not change.

Event programs (the JAX package's lru-cached jits _jit_node_step,
_jit_pu_step, _jit_gather_*): each event's step runs as a program over
static buffers (utils/graphs.Program), one per (event shape, B, device,
slot). On the card its first build runs an eager warm-up step and captures
the step as a CUDA graph; every event then loads its request rows (one host
copy into a pinned staging buffer, one copy to the card), replays the graph
and fetches its results into pinned host buffers. _node_step, _pu_step and
_gather_winners are the plain versions, what the programs capture.

A program's outputs are rewritten by its next replay. A run's node or PU
outputs stay on the device until its next event, the fetch, reads them, and
a run never dispatches its next event before it has completed the one
before, so what one run holds is safe from its own replays; every run of a
pipelined call and every mesh part has a slot of its own, (run, part), so
no run or part replays a program whose outputs another still holds.
HEVCE_ASYNC_FETCH=1 starts the copies to the host at dispatch (behind a
CUDA event that complete() waits on) instead of at complete().

A full fetch copies every candidate's quant and recon into pinned host
buffers of the producer program's own (graphs.Program.start_copy).

Tracing (a caller's PhaseTimer): host_arbiter, device_math_* (each event's
row load and replay), writeback and winner_fetch (the copies of the
results into the engine's buffers), and inside those two card_wait, the
host's wait for the card; each fetch event's mode counts as fetch_winner,
fetch_full or fetch_none. On one CUDA device without pipeline halves each
event's card time, from a timing event after its rows' load (for a full
fetch, before its copies) to one after its results' copies, goes to the
timer's CARD total. Without a timer nothing is timed and no event is
recorded.
"""
import ctypes
import functools
import os
import sys

import numpy as np
import torch

from hevce_tpu_torch.models import cu_eval
from hevce_tpu_torch.ops import cabac_scan
from hevce_tpu_torch.ops import cabac_sim as sim
from hevce_tpu_torch.ops import coef_ops as co
from hevce_tpu_torch.parallel import batch as pb
from hevce_tpu_torch.runtime import native
from hevce_tpu_torch.utils import device as _device
from hevce_tpu_torch.utils import graphs
from hevce_tpu_torch.utils.tracing import CARD, PhaseTimer

MODES = 35
KIND_NODE, KIND_PU, KIND_DONE, KIND_NODE_FETCH, KIND_PU_FETCH = 0, 1, 2, 3, 4

# worst-case op counts per trial (chunked bypass format): overflow-free
_NODE_CAPS = {8: 768, 16: 2048, 32: 7168}
PU_CAP = 256


def _view(lib, handle, which, dtype, count):
    """numpy view of one of the engine's shared buffers (hevce_batch_buf)."""
    ptr = lib.hevce_batch_buf(handle, which)
    ctype = ctypes.c_int32 if dtype == np.int32 else ctypes.c_uint8
    return np.ctypeslib.as_array(ctypes.cast(ptr, ctypes.POINTER(ctype)),
                                 shape=(count,))


def _node_trials(sz: int, q1, q4, state7, fctxs, meta):
    """the rate scan's inputs for a node event's step-2 / step-3 trials:
    every mode of both TU layouts coded from the uploaded fork (7 coder
    scalars + 142 contexts per image, on the size's palette).

    Returns (fork state (2*B*35 lanes: 2Nx2N lanes, then TU-split lanes),
    packed ops, op counts, overflow flags of the two layouts)."""
    cap = _NODE_CAPS[sz]
    B = q1.shape[0]
    dev = q1.device

    def rep(v):
        return v.repeat_interleave(MODES, dim=0)

    pm = torch.arange(MODES, dtype=torch.int32, device=dev).repeat(B)
    pml, pma = rep(meta[:, 0]), rep(meta[:, 1])
    gl, ga = rep(meta[:, 2]).bool(), rep(meta[:, 3]).bool()
    palette, remap = co._palette_tensors(sz, True, dev)
    fork = {f: rep(state7[:, i]) for i, f in enumerate(sim.FIELDS)}
    fork["ctxs"] = rep(fctxs)[:, palette]

    ops2, val2 = co.generate_cu_2nx2n_ops(
        sz, pm, pml, pma, gl, ga, q1.reshape(B * MODES, sz, sz))
    packed2, ovf2, n2 = co.compact_ops(co.remap_ctx_ops(ops2, remap), val2,
                                       cap)
    h = sz // 2
    ops3, val3 = co.generate_cu_tusplit_ops(
        sz, pm, pml, pma, gl, ga, q4.reshape(B * MODES, 4, h, h))
    packed3, ovf3, n3 = co.compact_ops(co.remap_ctx_ops(ops3, remap), val3,
                                       cap)
    fork2 = {k: torch.cat([v, v]).contiguous() for k, v in fork.items()}
    return (fork2, torch.cat([packed2, packed3]), torch.cat([n2, n3]),
            ovf2, ovf3)


def _node_step(sz: int, qpd6: int, top, left, flags, orig, state7, fctxs,
               meta):
    """node event: candidate math for both TU layouts + trial rates against
    the uploaded fork state.

    Lanes whose op count overflows the cap return rate -1, and the C++
    arbiter trial-encodes those on the host: exactness is unconditional."""
    q1, r1, s1 = cu_eval.eval_2nx2n(sz, qpd6, top, left, flags, orig)
    q4, r4, s4 = cu_eval.eval_tusplit(sz, qpd6, top, left, flags, orig)
    B = q1.shape[0]
    fork, ops, nops, ovf2, ovf3 = _node_trials(sz, q1, q4, state7, fctxs,
                                               meta)
    # both layouts' trials in ONE rate scan (kernel K2 on the card)
    final = cabac_scan.advance_rates(fork, ops, nops)
    rates = sim.bit_len(final) - sim.bit_len(fork)
    rates2 = torch.where(ovf2, -1, rates[:B * MODES]).to(torch.int32)
    rates3 = torch.where(ovf3, -1, rates[B * MODES:]).to(torch.int32)
    return (q1, r1, s1, q4, r4, s4,
            rates2.reshape(B, MODES), rates3.reshape(B, MODES))


def _pu_step(qpd6: int, top, left, flags, orig):
    """4x4 PU event: candidate math + fresh-coder putCoef rates (the
    reference's step-4 PU rate, src/HEVCe.c:1505-1519). Overflowing lanes
    get rate -1 and the host falls back to its own trial encode."""
    q1, r1, s1 = cu_eval.eval_2nx2n(4, qpd6, top, left, flags, orig)
    B = q1.shape[0]
    pms = torch.arange(MODES, dtype=torch.int32, device=q1.device).repeat(B)
    rates, overflow = co.put_coef_rates(4, qpd6, pms,
                                        q1.reshape(B * MODES, 4, 4), cap=PU_CAP)
    rates = torch.where(overflow, -1, rates).reshape(B, MODES)
    return q1, r1, s1, rates


def _gather_winners(qs, rs, sel):
    """winner-lane gather: qs / rs the candidate quant / recon of each
    layout, (B, 35, ...) each; sel (B,) flat lane layout*35 + mode, or < 0
    for none. Returns (B, nn) quant and recon rows (zero where sel < 0)."""
    B = sel.shape[0]
    q = torch.cat([x.reshape(B, MODES, -1) for x in qs], 1)
    r = torch.cat([x.reshape(B, MODES, -1) for x in rs], 1)
    rows = torch.arange(B, device=q.device)
    lane = sel.clamp(min=0).long()
    keep = (sel >= 0)[:, None]
    return (torch.where(keep, q[rows, lane], 0),
            torch.where(keep, r[rows, lane], 0))


# a fresh coder's 7 scalars (cabac_sim.FIELDS order): the fork of a node
# program's warm-up step
_FRESH_CODER = (510, 0, 23, 0, 0xFF, 0, 0)


def _request_fields(sz: int, B: int):
    """a node / PU event's request rows: the top row (1 + 2sz), the left
    column (2sz), the four border flags, the originals (sz, sz)."""
    return [(B, 1 + 2 * sz), (B, 2 * sz), (B, 4), (B, sz, sz)]


@functools.lru_cache(maxsize=None)
def _node_program(sz: int, qpd6: int, B: int, node_rates: bool,
                  device: torch.device, slot) -> graphs.Program:
    """A node event's program: hevce_tpu's _jit_node_step(sz, qpd6, mesh)
    with node_rates, its jit_eval_2nx2n + jit_eval_tusplit without. Inputs:
    the request rows and, with node_rates, the coder fork (state7 (B, 7),
    ctxs (B, 142), meta (B, 4)); outputs: _node_step's (q1, r1, s1, q4, r4,
    s4, rates2, rates3), or parallel/batch.device_step's first six; fetched:
    the rates and the SSEs. On the card K1 launches 5 times a replay, and K2
    once with node_rates. B, the device (with its index, utils/device.
    normal) and the slot (run, part) are in the key (module docstring)."""
    fields = _request_fields(sz, B)
    if node_rates:
        fields += [(B, 7), (B, 142), (B, 4)]

    def step(top, left, flags, orig, *fork):
        if node_rates:
            return _node_step(sz, qpd6, top, left, flags != 0, orig, *fork)
        return pb.device_step(sz, qpd6, top, left, flags != 0, orig)

    def fresh_fork(*inputs):
        inputs[4][:] = torch.tensor(_FRESH_CODER, dtype=torch.int32)
    return graphs.Program("node_rates" if node_rates else "node", fields,
                          step, device,
                          fetch=(6, 7, 2, 5) if node_rates else (2, 5),
                          fill=fresh_fork if node_rates else None)


@functools.lru_cache(maxsize=None)
def _pu_program(qpd6: int, B: int, device: torch.device,
                slot) -> graphs.Program:
    """A PU event's program (hevce_tpu's _jit_pu_step(qpd6, mesh)): inputs
    the request rows at sz 4; outputs _pu_step's (q1, r1, s1, rates);
    fetched: s1 and the rates. K1 and K2 launch once a replay."""
    def step(top, left, flags, orig):
        return _pu_step(qpd6, top, left, flags != 0, orig)
    return graphs.Program("pu", _request_fields(4, B), step, device,
                          fetch=(2, 3))


def _candidate_idx(prog: graphs.Program):
    """the indices of each TU layout's quants, then recons, in a node or PU
    program's outputs."""
    return (0, 1) if prog.kind == "pu" else (0, 3, 1, 4)


def _candidates(prog: graphs.Program):
    """(quants, recons) of each TU layout in a node or PU program's last
    outputs."""
    out = [prog.out[i] for i in _candidate_idx(prog)]
    n = len(out) // 2
    return tuple(out[:n]), tuple(out[n:])


@functools.lru_cache(maxsize=None)
def _gather_program(producer: graphs.Program) -> graphs.Program:
    """The winner gather of a node or PU program's candidates (hevce_tpu's
    _jit_gather_node(sz) / _jit_gather_pu()): input sel (B,); outputs and
    fetched: _gather_winners' quant and recon rows. It reads the producer's
    outputs where they lie, so there is one per producer, whose key holds
    the layout count, sz, B, the device and the slot."""
    B = producer.args[0].shape[0]
    return graphs.Program(
        "gather", [(B,)],
        lambda sel: _gather_winners(*_candidates(producer), sel),
        producer.device, fetch=(0, 1))


def _wrap32(x: int) -> int:
    return (x + (1 << 31)) % (1 << 32) - (1 << 31)


def _check_transfer(tensors, host):
    """HEVCE_VERIFY_TRANSFERS=1: each array's int32 wrap-around sum is also
    computed on the device and compared with the host copy's, so a
    corrupted transfer fails loudly instead of producing a wrong stream; it
    costs one more round trip per fetch, so it is opt-in."""
    want = [_wrap32(int(v)) for v in torch.stack(
        [t.to(torch.int64).sum() for t in tensors]).tolist()]
    got = [_wrap32(int(h.astype(np.int64).sum())) for h in host]
    if got != want:
        raise IOError("device->host transfer checksum mismatch: "
                      f"expected {want}, got {got}")


class _Run:
    """One lockstep engine instance (one C++ BatchEngine and its device
    state), with the per-event work split into next / dispatch / complete
    so a caller can keep two instances in flight (pipelined halves). slot
    tells the programs of two runs of one call apart."""

    def __init__(self, lib, images, qpd6, node_rates, device, verify, timer,
                 mesh=None, slot=0, async_fetch=False, card=False):
        self.lib = lib
        self.qpd6 = qpd6
        self.node_rates = node_rates
        self.mesh = mesh
        self.devs = tuple(_device.normal(d) for d in (mesh or (device,)))
        self.slot = slot
        self.verify = verify
        self.async_fetch = async_fetch
        self.timer = timer
        self.card = card    # time each event on the card (module docstring)
        self._start = None  # the timing event that opens the event's card time
        self.B = B = len(images)
        self.ysz, self.xsz = images[0].shape
        self.yp = -(-self.ysz // 32) * 32
        self.xp = -(-self.xsz // 32) * 32
        # the engine reads the images from this buffer until destroy()
        self.blob = np.concatenate([im.reshape(-1) for im in images])
        self.handle = lib.hevce_batch_create(
            self.blob.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            B, self.ysz, self.xsz, qpd6)
        if not self.handle:
            raise RuntimeError("hevce_batch_create failed")
        v = lambda which, dtype, n: _view(lib, self.handle, which, dtype, n)
        self.req_top = v(0, np.int32, B * 65).reshape(B, 65)
        self.req_left = v(1, np.int32, B * 64).reshape(B, 64)
        self.req_flags = v(2, np.uint8, B * 4).reshape(B, 4)
        self.req_orig = v(3, np.int32, B * 1024).reshape(B, 1024)
        self.res_quant = v(4, np.int32, B * MODES * 1024)
        self.res_recon = v(5, np.uint8, B * MODES * 1024)
        self.res_sse = v(6, np.int32, B * MODES)
        self.res_quant4 = v(7, np.int32, B * MODES * 1024)
        self.res_recon4 = v(8, np.uint8, B * MODES * 1024)
        self.res_sse4 = v(9, np.int32, B * MODES)
        self.res_rates = v(10, np.int32, B * MODES)
        self.res_rates2 = v(11, np.int32, B * MODES)
        self.res_rates3 = v(12, np.int32, B * MODES)
        self.req_state = v(13, np.int32, B * 7).reshape(B, 7)
        self.req_ctxs = v(14, np.int32, B * 142).reshape(B, 142)
        self.req_meta = v(15, np.int32, B * 4).reshape(B, 4)
        self.req_fetch = v(16, np.int32, B)
        self._szv = ctypes.c_int(0)
        self.kind = None
        self.sz = 0
        self.progs = ()     # the node / PU event's program of each part,
        #                     whose candidates the fetch event reads
        self._out = None    # the fetch event's mode, sel and programs
        self.done = False

    # -- event machinery ----------------------------------------------------
    def next(self):
        """Block until all workers rendezvous at the next schedule event."""
        with self.timer.phase("host_arbiter"):
            self.kind = self.lib.hevce_batch_next(self.handle,
                                                  ctypes.byref(self._szv))
        self.sz = self._szv.value
        if self.kind == KIND_DONE:
            self.done = True
        return self.kind

    def _card_event(self):
        """a timing event recorded on the current stream, or None where
        events are not timed."""
        if not self.card:
            return None
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def _add_card(self, start, end):
        """the card seconds from start to end into the timer's CARD total."""
        end.synchronize()
        self.timer.totals[CARD] += start.elapsed_time(end) / 1e3
        self.timer.counts[CARD] += 1

    def _replay(self, program, reqs):
        """Each part's rows into its program, and its replay: program(i, k)
        is part i's program for k rows. The rows are copied before this
        returns (the engine rewrites its request buffers once complete()
        resupplies it). With HEVCE_ASYNC_FETCH=1 the fetches start too.
        A timed event's card time opens after the load. Returns the parts'
        programs."""
        def part(i, *rows):
            prog = program(i, rows[0].shape[0])
            prog.load(rows)
            self._start = self._card_event()
            prog()
            if self.async_fetch:
                prog.start_fetch()
            return prog
        return pb.sharded(part, self.mesh, *reqs, gather=False)

    def dispatch(self):
        """Queue this event's device work (it does not wait for results).
        The request buffers are fully consumed here."""
        kind, sz = self.kind, self.sz
        if kind in (KIND_NODE, KIND_PU):
            reqs = [self.req_top[:, :1 + 2 * sz], self.req_left[:, :2 * sz],
                    self.req_flags, self.req_orig[:, :sz * sz]]
        if kind == KIND_NODE:
            if self.node_rates:
                reqs += [self.req_state, self.req_ctxs, self.req_meta]
            with self.timer.phase(f"device_math_node{sz}"):
                self.progs = self._replay(
                    lambda i, k: _node_program(sz, self.qpd6, k,
                                               self.node_rates, self.devs[i],
                                               (self.slot, i)), reqs)
        elif kind == KIND_PU:
            with self.timer.phase("device_math_pu"):
                self.progs = self._replay(
                    lambda i, k: _pu_program(self.qpd6, k, self.devs[i],
                                             (self.slot, i)), reqs)
        else:   # KIND_NODE_FETCH / KIND_PU_FETCH
            sel = self.req_fetch.copy()
            with self.timer.phase("winner_fetch"):
                if (sel == -1).any():
                    self._out = ("full", sel, ())
                elif (sel >= 0).any():
                    self._out = ("winner", sel, self._replay(
                        lambda i, k: _gather_program(self.progs[i]), [sel]))
                else:
                    self._out = ("none", sel, ())
            self.timer.counts[f"fetch_{self._out[0]}"] += 1

    def _host(self, progs, full=False):
        """the programs' fetched outputs on the host (full: their
        candidates, _candidate_idx), each part's rows in mesh order: views
        that the next fetch overwrites. The host's wait for them is the
        card_wait phase; a timed event's card seconds go to the CARD
        total."""
        if full:
            self._start = self._card_event()
            idx = [_candidate_idx(p) for p in progs]
            parts = [p.start_copy(i) for p, i in zip(progs, idx)]
        else:
            idx = [p.fetch for p in progs]
            if not self.async_fetch:
                for p in progs:
                    p.start_fetch()
        end = self._card_event() if self._start is not None else None
        with self.timer.phase("card_wait"):
            for p in progs:
                p.wait()
        if end is not None:
            self._add_card(self._start, end)
        self._start = None
        if not full:
            parts = [p.fetched() for p in progs]
        if self.verify:
            for p, i, host in zip(progs, idx, parts):
                _check_transfer([p.out[k] for k in i], host)
        if len(parts) == 1:
            return parts[0]
        return [np.concatenate(a) for a in zip(*parts)]

    def complete(self):
        """Copy the dispatched results to the host, write them into the
        engine's result buffers, and release the workers into the next
        arbitration."""
        kind, sz, B = self.kind, self.sz, self.B
        nn = sz * sz
        if kind == KIND_NODE:
            with self.timer.phase("writeback"):
                host = self._host(self.progs)
                if self.node_rates:
                    h2, h3, hs1, hs4 = host
                    self.res_rates2[:] = h2.reshape(-1)
                    self.res_rates3[:] = h3.reshape(-1)
                else:
                    self.res_rates2[:] = -1
                    self.res_rates3[:] = -1
                    hs1, hs4 = host
                self.res_sse[:] = hs1.reshape(-1)
                self.res_sse4[:] = hs4.reshape(-1)
        elif kind == KIND_PU:
            with self.timer.phase("writeback"):
                hs1, hr = self._host(self.progs)
                self.res_sse[:] = hs1.reshape(-1)
                self.res_rates[:] = hr.reshape(-1)
        else:   # fetch events; K1's int16 quant widens into the int32 buffers
            mode, sel, gathers = self._out
            quant = (self.res_quant, self.res_quant4)
            recon = (self.res_recon, self.res_recon4)
            with self.timer.phase("winner_fetch"):
                if mode == "full":
                    host = self._host(self.progs, full=True)
                    nl = len(host) // 2
                    for layout in range(nl):
                        quant[layout][:B * MODES * nn] = host[layout].reshape(-1)
                        recon[layout][:B * MODES * nn] = host[nl + layout].reshape(-1)
                elif mode == "winner":
                    wq, wr = self._host(gathers)
                    for i in np.nonzero(sel >= 0)[0]:
                        layout, pm = divmod(int(sel[i]), MODES)
                        off = (i * MODES + pm) * nn
                        quant[layout][off:off + nn] = wq[i]
                        recon[layout][off:off + nn] = wr[i]
            self.progs = ()
        self._out = None
        self.lib.hevce_batch_supply(self.handle)

    # -- teardown / results -------------------------------------------------
    def collect(self):
        streams, rcons = [], []
        u8p = ctypes.POINTER(ctypes.c_uint8)
        for s in range(self.B):
            n = self.lib.hevce_batch_stream(self.handle, s, None)
            buf = np.empty(n, np.uint8)
            self.lib.hevce_batch_stream(self.handle, s,
                                        buf.ctypes.data_as(u8p))
            streams.append(bytes(buf))
            rc = np.empty((self.yp, self.xp), np.uint8)
            self.lib.hevce_batch_rcon(self.handle, s, rc.ctypes.data_as(u8p))
            rcons.append(rc)
        return streams, rcons

    def destroy(self, ok):
        if not ok:
            # free-run the blocked workers so destroy can join them; their
            # output is discarded with the exception
            self.lib.hevce_batch_abort(self.handle)
        self.lib.hevce_batch_destroy(self.handle)


def encode_batch(images, qpd6: int, node_rates: bool = None, timer=None,
                 mesh=None, pipeline: bool = None, device=None):
    """Encode a list of same-shaped uint8 grayscale images bit-exactly.

    Returns (list of stream bytes, list of recon arrays (CTU-padded dims)),
    identical to runtime/native.encode_image_native of each image.

    node_rates: also compute the step-2/3 trial rates of every node event
    on the device (op generation + kernel K2) instead of the host arbiter's
    trial encodes. Bit-exact either way. Default: HEVCE_NODE_RATES=1, else
    off.
    pipeline: split the batch into two interleaved halves, so one half's
    arbiters run while the other half's work is enqueued (slower on the
    card, see the module docstring). Bit-exact. Default: HEVCE_PIPELINE=1,
    else off.
    timer: optional utils.tracing.PhaseTimer accumulating host_arbiter /
    device_math_node{sz} / device_math_pu / writeback / winner_fetch /
    finish (device phases time the host's enqueue; the wait for the card
    is card_wait, inside writeback and winner_fetch), the fetch_winner /
    fetch_full / fetch_none counts and, on one CUDA device without
    pipeline halves, each event's card seconds in its CARD total (module
    docstring). HEVCE_TRACE=1 prints the breakdown to stderr on return.
    mesh: a sequence of devices (parallel/batch.make_mesh); every node and
    PU step splits its batch over them, each part replaying the program of
    its device and batch. A mesh turns node_rates on, and the batch must be
    a multiple of its size; device is then not used.
    device: None runs on the card (and raises without CUDA); "cpu" runs
    every kernel's plain version.
    Every event replays its program (module docstring): the first event of
    a key builds it (on the card a warm-up step and a capture, which raises
    if it fails). HEVCE_ASYNC_FETCH=1 starts each event's copies to the host
    when it is dispatched; HEVCE_VERIFY_TRANSFERS=1 checks them.
    """
    if mesh is not None:
        mesh = pb.make_mesh(mesh)
        pb.check_split(len(images), mesh)
        node_rates = True   # the mesh splits the whole device data path
        dev = mesh[0]
    else:
        dev = _device.resolve(device)
    if node_rates is None:
        node_rates = os.environ.get("HEVCE_NODE_RATES") == "1"
    if pipeline is None:
        pipeline = os.environ.get("HEVCE_PIPELINE", "0") == "1"
    verify = os.environ.get("HEVCE_VERIFY_TRANSFERS", "0") == "1"
    async_fetch = os.environ.get("HEVCE_ASYNC_FETCH", "0") == "1"
    trace_env = timer is None and os.environ.get("HEVCE_TRACE", "0") == "1"
    timed = timer is not None or trace_env
    timer = timer if timer is not None else PhaseTimer()
    images = [native._clip_dims(im) for im in images]
    if any(im.shape != images[0].shape for im in images):
        raise ValueError("batch must share dims")
    B = len(images)
    parts = [images]
    cut = B // 2 if mesh is None else B // 2 // len(mesh) * len(mesh)
    if pipeline and 0 < cut < B:    # halves the mesh divides
        parts = [images[:cut], images[cut:]]
    # events one after another on one stream: each event's card time
    card = timed and mesh is None and dev.type == "cuda" and len(parts) == 1

    lib = native._load()
    runs = []
    ok = False
    try:
        with torch.no_grad():
            for part in parts:
                runs.append(_Run(lib, part, qpd6, node_rates, dev, verify,
                                 timer, mesh, slot=len(runs),
                                 async_fetch=async_fetch, card=card))
            live = runs
            for r in live:
                if r.next() != KIND_DONE:
                    r.dispatch()
            # complete (and so resupply) every run before any waits for its
            # next event: a run's workers arbitrate while the Python thread
            # serves the other run
            while live := [r for r in live if not r.done]:
                for r in live:
                    r.complete()
                for r in live:
                    if r.next() != KIND_DONE:
                        r.dispatch()
        with timer.phase("finish"):
            streams, rcons = [], []
            for r in runs:
                s, rc = r.collect()
                streams += s
                rcons += rc
        ok = True
        if trace_env:
            print("lockstep phase breakdown:\n" + timer.report(),
                  file=sys.stderr)
        return streams, rcons
    finally:
        for r in runs:
            r.destroy(ok)
