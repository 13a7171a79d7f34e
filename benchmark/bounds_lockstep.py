"""Roofline bounds of the lockstep engine's kernels K1, X1 and K2.

K1's and X1's bounds are bounds.py's (k1_call_ms, x_call_ms). k2_cost and
K2_OPS_PER_OP are frozen copies of hevce_tpu_torch/tools/bench_k2.py at
commit 0c580e1 (chip_smoke.py's kernels line reads the same): each op (4
bytes) and op count, the 7 coder scalars in and out and the context palette
moved once at the HBM rate, or 30 int32 operations an op, whichever is
longer. The op strings are data made on the card inside a replay, which the
host does not see, so a K2 call is bounded with none of its ops: what every
call moves whatever its strings. The bound is a floor.

An event program's replay does not pass through the kernels' Python
wrappers, so Recorder wraps them while the program's first step runs
eagerly (the warm-up before its capture) and keeps each call's bound under
the program's key, ("node", sz, B) or ("pu", B); a replay of that program is
bounded by the sum over those calls.
"""
import contextlib

import torch

from benchmark import bounds

# K2's work per op: decoding the op word, the bin update and the refill
K2_OPS_PER_OP = 30
# the lockstep's schedule a CTU step (csrc/hevce_host.cpp): node events by
# CU size and PU events, each one replay of its program
NODE_EVENTS = {32: 1, 16: 4, 8: 16}
PU_EVENTS = 64


def k2_cost(lanes: int, P: int, n: int):
    """(bytes, int32 ops) one K2 call must move and do: n real ops (4 B
    each), the op counts, the 7 scalars in and out, the palette of P
    contexts in."""
    return (4 * n + 4 * lanes + 2 * 7 * 4 * lanes + 4 * lanes * P,
            K2_OPS_PER_OP * n)


def k2_call_ms(args):
    """bound ms of one K2 call, advance_rates(state, ops, nops), counted
    with none of its ops (module docstring)."""
    lanes, P = args[0]["ctxs"].shape
    nbytes, ops = k2_cost(lanes, P, 0)
    return bounds.bound(nbytes, [(ops, bounds.INT32_OPS_PER_S)])[0]


class Recorder:
    """Wraps K1's fused_eval.pipeline_sse, X1's fused_node.predict and K2's
    cabac_scan.advance_rates, and the lockstep's program factories
    (_node_program, _pu_program) while installed. Each kernel call made
    eagerly while a factory builds its program (the warm-up step; the
    capture's own pass records nothing) adds its bound to the program's
    key: step_ms[key] is then the bound of one replay."""

    KERNELS = (("fused_eval", "pipeline_sse", "k1"),
               ("fused_node", "predict", "x1"),
               ("cabac_scan", "advance_rates", "k2"))

    def __init__(self, modules, lockstep):
        """modules maps "fused_eval", "fused_node" and "cabac_scan" to the
        port's modules, lockstep is parallel/lockstep."""
        self.modules, self.lockstep = modules, lockstep
        self.step_ms = {}
        self._key = None

    def _record(self, name, args, kw):
        if self._key is None or torch.cuda.is_current_stream_capturing():
            return
        if name == "k1":
            ms = bounds.k1_call_ms(args)
        elif name == "k2":
            ms = k2_call_ms(args)
        else:
            ms = bounds.x_call_ms(name, args, kw)
        self._sum += ms

    @contextlib.contextmanager
    def installed(self):
        """record while the block runs."""
        saved = []

        def wrap(obj, attr, make):
            fn = getattr(obj, attr)
            saved.append((obj, attr, fn))
            setattr(obj, attr, make(fn))

        def kernel(name):
            def make(fn):
                def recorded(*args, **kw):
                    self._record(name, args, kw)
                    return fn(*args, **kw)
                return recorded
            return make

        def factory(key_of):
            def make(fn):
                def keyed(*args):
                    if self._key is not None:
                        return fn(*args)
                    self._key, self._sum = key_of(*args), 0.0
                    try:
                        prog = fn(*args)
                        if self._sum:           # built now, not cached
                            self.step_ms[self._key] = self._sum
                        return prog
                    finally:
                        self._key = None
                return keyed
            return make

        for mod, attr, name in self.KERNELS:
            wrap(self.modules[mod], attr, kernel(name))
        wrap(self.lockstep, "_node_program",
             factory(lambda sz, qpd6, B, *_: ("node", sz, B)))
        wrap(self.lockstep, "_pu_program",
             factory(lambda qpd6, B, *_: ("pu", B)))
        try:
            yield self
        finally:
            for obj, attr, fn in reversed(saved):
                setattr(obj, attr, fn)

    def ctu_step_ms(self, B: int):
        """the bound of one CTU step of a batch of B, or None where one of
        its programs was not recorded."""
        keys = [(("node", sz, B), n) for sz, n in NODE_EVENTS.items()]
        keys.append((("pu", B), PU_EVENTS))
        if any(k not in self.step_ms for k, _ in keys):
            return None
        return sum(n * self.step_ms[k] for k, n in keys)
