"""The lockstep engine's event programs (parallel/lockstep._node_program,
_pu_program, _gather_program) and the spec encoder's eval programs on the
CPU, where each runs its step eagerly on its static buffers: tolerance 0
against the plain steps (_node_step, parallel/batch.device_step, _pu_step,
_gather_winners, cu_eval.eval_*) and the JAX package's jitted programs, on
numpy-seeded requests. On the card the same programs replay CUDA graphs
(tests/test_torch_cuda.py holds them there). No JAX slice program is
compiled; the JAX node step with rates compiles once per (sz, qpd6), about
30 s each, so it is held at one qpd6 per size.
"""
import inspect

import numpy as np
import pytest
import torch

from hevce_tpu.bitstream import cabac as jcb
from hevce_tpu.models import cu_eval as jcu
from hevce_tpu.parallel import batch as jbatch
from hevce_tpu.parallel import lockstep as jls
from hevce_tpu_torch.models import cu_eval, encoder
from hevce_tpu_torch.parallel import batch as pb
from hevce_tpu_torch.parallel import lockstep
from hevce_tpu_torch.runtime import native
from hevce_tpu_torch.utils import graphs

# the test workers share the machine's cores: one intra-op thread each
torch.set_num_threads(1)

CPU = torch.device("cpu")
B = 3


def _requests(sz, seed):
    """a node / PU event's request rows as the engine lays them out (int32,
    flags 0/1): random pixels, one smooth block, one block at the
    extremes."""
    rng = np.random.default_rng(seed)
    top = rng.integers(0, 256, (B, 1 + 2 * sz))
    left = rng.integers(0, 256, (B, 2 * sz))
    orig = rng.integers(0, 256, (B, sz, sz))
    orig[1] = np.clip(left[1, :sz, None] // 2 + top[1, None, 1:sz + 1] // 2
                      + rng.integers(-3, 4, (sz, sz)), 0, 255)
    top[2], left[2] = 255, 0
    flags = rng.random((B, 4)) < 0.6
    flags[0], flags[2] = True, False
    return [a.astype(np.int32) for a in (top, left, flags, orig)]


def _fork(sz, qpd6, seed):
    """live coder forks (the JAX package's coder after random bins):
    state7 (B, 7), ctxs (B, 142), meta (B, 4)."""
    rng = np.random.default_rng(seed)
    state, ctxs = [], []
    for _ in range(B):
        enc, c = jcb.CabacEncoder(), jcb.new_context_set(qpd6)
        for _ in range(int(rng.integers(0, 400))):
            r = rng.integers(0, 3)
            if r == 0:
                enc.encode_bin(c, int(rng.integers(0, 142)),
                               int(rng.integers(0, 2)))
            elif r == 1:
                enc.encode_bypass(int(rng.integers(0, 256)),
                                  int(rng.integers(1, 9)))
            else:
                enc.encode_terminate(0)
        state.append([enc.range, enc.low, enc.nbits, enc.outstanding,
                      enc.bufbyte, enc.zrun, len(enc.buf)])
        ctxs.append(np.frombuffer(bytes(c), np.uint8))
    meta = np.stack([rng.integers(0, 35, B), rng.integers(0, 35, B),
                     rng.integers(0, 2, B), rng.integers(0, 2, B)], 1)
    return [np.asarray(state, np.int32), np.stack(ctxs).astype(np.int32),
            meta.astype(np.int32)]


def _event(sz, qpd6, rates, seed):
    """an event's inputs in the program's field order."""
    arrays = _requests(sz, seed)
    return arrays + (_fork(sz, qpd6, seed + 1) if rates else [])


def _program(sz, qpd6, rates, slot=("test", 0)):
    if sz == 4:
        return lockstep._pu_program(qpd6, B, CPU, slot)
    return lockstep._node_program(sz, qpd6, B, rates, CPU, slot)


def _plain(sz, qpd6, rates, arrays):
    t = [torch.from_numpy(a) for a in arrays]
    t[2] = t[2] != 0
    if sz == 4:
        return lockstep._pu_step(qpd6, *t)
    if rates:
        return lockstep._node_step(sz, qpd6, *t)
    return pb.device_step(sz, qpd6, *t)


def _jax(sz, qpd6, rates, arrays):
    """the JAX package's program of the event (flags as bool)."""
    a = list(arrays)
    a[2] = a[2] != 0
    if sz == 4:
        return jls._jit_pu_step(qpd6)(*a)
    if rates:
        return jls._jit_node_step(sz, qpd6)(*a)
    return jbatch.jit_device_step(sz, qpd6)(*a)


def _eq(got, want, msg):
    assert len(got) == len(want), msg
    for i, (g, w) in enumerate(zip(got, want)):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        w = w.numpy() if isinstance(w, torch.Tensor) else np.asarray(w)
        np.testing.assert_array_equal(g, w, err_msg=f"{msg} output {i}")


def _sel(sz, event):
    """winner lanes: layout * 35 + mode, one row without a winner."""
    layouts = 1 if sz == 4 else 2
    return np.array([3 + event, 35 * layouts - 1, -1], np.int32)


EVENTS = [(sz, rates) for sz in (8, 16, 32) for rates in (False, True)] + [
    (4, False)]


# the node step with rates at sz 32 runs K2's plain version for ~15 s on
# one thread: at one qpd6
PLAIN_EVENTS = [(sz, rates, q) for sz, rates in EVENTS for q in (0, 2, 4)
                if (sz, rates) != (32, True) or q == 4]


@pytest.mark.parametrize("sz,rates,qpd6", PLAIN_EVENTS)
def test_program_equals_its_plain_step(sz, rates, qpd6):
    """one program serves two events with different inputs; each time its
    outputs, fetched outputs and winner gather equal the plain step's."""
    prog = _program(sz, qpd6, rates)
    assert prog.run.graph is None          # the CPU runs the step eagerly
    for event in range(2):
        arrays = _event(sz, qpd6, rates, 1000 * sz + 10 * qpd6 + event)
        prog.load(arrays)
        got = prog()
        want = _plain(sz, qpd6, rates, arrays)
        _eq(got, want, f"sz={sz} rates={rates} event {event}")
        _eq(prog.fetched(), [want[i] for i in prog.fetch], "fetched")
        gather = lockstep._gather_program(prog)
        sel = _sel(sz, event)
        gather.load([sel])
        qs, rs = lockstep._candidates(prog)
        _eq(gather(), lockstep._gather_winners(qs, rs, torch.from_numpy(sel)),
            f"gather sz={sz} event {event}")
        _eq(gather.fetched(), gather.out, "gather fetched")


# the JAX node step with rates at one qpd6 per size (a compile each)
JAX_EVENTS = [(8, False, q) for q in (0, 2, 4)] + [
    (16, False, 2), (32, False, 4), (8, True, 2), (16, True, 0),
    (32, True, 4)] + [(4, False, q) for q in (0, 2, 4)]


@pytest.mark.parametrize("sz,rates,qpd6", JAX_EVENTS)
def test_program_equals_jax_program(sz, rates, qpd6):
    arrays = _event(sz, qpd6, rates, 2000 * sz + qpd6)
    prog = _program(sz, qpd6, rates)
    prog.load(arrays)
    got = prog()
    want = _jax(sz, qpd6, rates, arrays)
    _eq(got, want, f"sz={sz} rates={rates} qpd6={qpd6}")
    if rates:
        assert (got[6] > 0).all() and (got[7] > 0).all()


@pytest.mark.parametrize("sz", [4, 8, 16, 32])
def test_gather_programs_equal_jax(sz):
    """the node gather (two layouts) and the PU gather (one) against
    _jit_gather_node(sz) / _jit_gather_pu()."""
    arrays = _event(sz, 2, False, 3000 + sz)
    prog = _program(sz, 2, False)
    prog.load(arrays)
    prog()
    gather = lockstep._gather_program(prog)
    sel = _sel(sz, 1)
    gather.load([sel])
    wq, wr = gather()
    out = [o.numpy() for o in prog.out]
    if sz == 4:
        want = jls._jit_gather_pu()(out[0], out[1], sel)
    else:
        want = jls._jit_gather_node(sz)(out[0], out[1], out[3], out[4], sel)
    _eq([wq.to(torch.int32), wr], want, f"gather sz={sz}")


@pytest.mark.parametrize("fn,sz,qpd6", [("eval_2nx2n", 4, 0),
                                        ("eval_2nx2n", 32, 2),
                                        ("eval_tusplit", 16, 4)])
def test_eval_program_equals_plain_and_jax(fn, sz, qpd6):
    """the spec encoder's program of one node at one row against the plain
    cu_eval function and the JAX package's jit_eval_*."""
    arrays = [a[0] for a in _requests(sz, 4000 + sz)]
    prog = encoder._eval_program(getattr(cu_eval, fn), sz, qpd6, CPU)
    prog.load(arrays)
    got = prog()
    t = [torch.from_numpy(a) for a in arrays]
    plain = getattr(cu_eval, fn)(sz, qpd6, t[0], t[1], t[2] != 0, t[3])
    jax_fn = getattr(jcu, f"jit_{fn}")(sz, qpd6)
    _eq(got, plain, f"{fn} plain")
    _eq(got, jax_fn(arrays[0], arrays[1], arrays[2] != 0, arrays[3]),
        f"{fn} jax")
    _eq(prog.fetched(), got, f"{fn} fetched")


def test_program_keys_are_the_jax_keys_with_batch_device_and_slot():
    """hevce_tpu's lru-cached jits key on (sz, qpd6, mesh) (node step with
    rates), (qpd6, mesh) (PU step), (sz) / () (gathers), (sz, qpd6) (the
    evals and, with the mesh, the device step); the port keys a program on
    those, with the batch size, the device and the slot (run, part) in the
    key, the rates-off node step in the node key (node_rates), a gather on
    its producer and an eval on its function."""
    params = lambda f: set(inspect.signature(f).parameters)
    extra = {"B", "device", "slot"}
    assert params(lockstep._node_program) == (
        params(jls._jit_node_step) - {"mesh"}) | extra | {"node_rates"}
    assert params(lockstep._pu_program) == (
        params(jls._jit_pu_step) - {"mesh"}) | extra
    assert params(lockstep._gather_program) == {"producer"}
    assert params(encoder._eval_program) == params(
        jcu.jit_eval_2nx2n) | {"fn", "device"}
    assert params(jbatch.jit_device_step) - {"mesh", "axis"} == {"sz",
                                                                 "qpd6"}
    a = _program(8, 2, True, (0, 0))
    assert a is _program(8, 2, True, (0, 0))
    assert a is not _program(8, 2, True, (1, 0))
    assert a is not _program(8, 2, True, (0, 1))
    assert a is not _program(8, 2, False, (0, 0))
    assert lockstep._gather_program(a) is lockstep._gather_program(a)
    assert graphs.built() == {}           # the CPU captures nothing


def _images(n, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:32, 0:32]
    return [rng.integers(0, 256, (32, 32)).astype(np.uint8),
            ((yy * 3 + xx * 2) % 256).astype(np.uint8)][:n]


def test_pipelined_runs_of_equal_batch_give_native_streams():
    """pipeline=True at B=2: two runs of one image each, the same program
    shapes in two slots; the streams and recons are the native engine's."""
    imgs = _images(2, 50)
    streams, rcons = lockstep.encode_batch(imgs, 2, pipeline=True,
                                           device="cpu")
    for im, s, r in zip(imgs, streams, rcons):
        s_ref, r_ref = native.encode_image_native(im, 2)
        assert s == s_ref and np.array_equal(r, r_ref)
    runs = [lockstep._pu_program(2, 1, CPU, (run, 0)) for run in (0, 1)]
    assert runs[0] is not runs[1]


def test_async_fetch_gives_the_same_streams(monkeypatch):
    """HEVCE_ASYNC_FETCH=1 starts each event's fetch at dispatch; the
    streams do not change."""
    monkeypatch.setenv("HEVCE_ASYNC_FETCH", "1")
    imgs = _images(1, 51)
    starts = []
    start = graphs.Program.start_fetch

    def counted(self):
        starts.append(self.kind)
        return start(self)
    monkeypatch.setattr(graphs.Program, "start_fetch", counted)
    streams, rcons = lockstep.encode_batch(imgs, 3, device="cpu")
    s_ref, r_ref = native.encode_image_native(imgs[0], 3)
    assert streams[0] == s_ref and np.array_equal(rcons[0], r_ref)
    # every node and PU event of the CTU started its fetch at dispatch
    assert starts.count("node") == 21 and starts.count("pu") == 64


def test_step_tables_are_uploaded_once_per_device():
    """the tables a step uploads on first use (its warm-up fills them, so
    its capture uploads nothing) key on the normal device."""
    from hevce_tpu_torch.ops import cabac_sim, coef_ops

    for fn, args in ((coef_ops._palette_tensors, (8, True)),
                     (cabac_sim._context_row, (2,))):
        assert fn(*args, "cpu") is fn(*args, CPU)
        assert fn.cache_info().hits >= 1
    palette, remap = coef_ops._palette_tensors(16, False, CPU)
    want = coef_ops._palette(16, False)
    np.testing.assert_array_equal(palette.numpy(), want[0])
    np.testing.assert_array_equal(remap.numpy(), want[1])


def test_a_captured_step_runs_eagerly_on_the_cpu():
    """on the CPU a CapturedStep is its step at every call and captures
    nothing."""
    calls = []
    step = graphs.CapturedStep(lambda: calls.append(1) or len(calls), CPU,
                               "test")
    assert (step(), step(), step.graph, step.launches) == (1, 2, None, {})
    assert len(graphs.CAPTURED) == 0
