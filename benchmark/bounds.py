"""Roofline bounds of the port's kernels K1 and X1-X3.

k1_cost, k1_tc_bound, x_border_reads, x_cost, bound and the constants below
are frozen copies of chip_smoke.py at commit 2c4bff8 (there: the kernels
line and the xnode phase). A bound is the least time the H100 could take for
one call: the larger of its bytes at the HBM rate and each count of
operations at its rate (NVIDIA H100 SXM data sheet, dense, 700 W).

A replayed front step does not pass through the kernels' Python wrappers, so
Recorder wraps them while the slice runner's first step runs eagerly (the
warm-up before its capture) and keeps each call's bound; a replay of that
runner's step is bounded by the sum over those calls.
"""
import contextlib

import torch

HBM_BYTES_PER_S = 3.35e12          # HBM3
INT32_OPS_PER_S = 67e12 / 2        # int32 on the CUDA cores: half FP32's rate
INT8_TC_OPS_PER_S = 1979e12        # int8 tensor cores

# K1's tensor-core floor: its stages' base-128 digits (2, 3, 3, 3) in
# sz x sz x sz products, and 84 int32 operations per coefficient besides
P3_DIGIT_PRODUCTS = 2 + 3 + 3 + 3
P3_INT32_OPS_PER_COEF = 84
K1_DIGIT_PRODUCTS = P3_DIGIT_PRODUCTS
K1_INT32_OPS_PER_COEF = P3_INT32_OPS_PER_COEF
# X1-X3's arithmetic (int32 operations on the kernels' own formulation): a
# predicted pixel two multiply-adds, the rounding add and the shift (6); X2
# per mode and pixel also the residual, 2 log2(sz) butterfly adds, |.| and
# the sum, and 35 x 35 rank comparisons a row; X3 per level 8, and ~40 a
# candidate
X_OPS_PER_PX = 6
X3_OPS_PER_COEF = 8


def bound(nbytes, ops):
    """(bound ms, bound_by): the larger of nbytes at HBM_BYTES_PER_S and
    each [(count, rate)] of operations at its rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = max(n / rate for n, rate in ops)
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def k1_cost(sz, M, lanes):
    """(bytes, int32 ops) one call must move and do: each input read once
    (pred, blk), each output written once (q i16, recon u8, sse i32); four
    sz x sz x sz transform stages per candidate, 2 ops per multiply-add."""
    n = lanes * M
    nn = sz * sz
    nbytes = n * nn + lanes * nn + n * nn * 2 + n * nn + n * 4
    ops = n * 4 * nn * sz * 2
    return nbytes, ops


def k1_tc_bound(sz, M, lanes):
    """(bound ms, bound_by) of one K1 call with its transforms as int8
    tensor-core products: the base-128 digit products of the four stages,
    the int32 epilogue and the bytes, whichever is largest."""
    n = lanes * M
    nbytes, _ = k1_cost(sz, M, lanes)
    return bound(nbytes, [
        (n * K1_DIGIT_PRODUCTS * sz ** 3 * 2, INT8_TC_OPS_PER_S),
        (n * sz * sz * K1_INT32_OPS_PER_COEF, INT32_OPS_PER_S)])


def x_border_reads(n, isub, flags):
    """(context samples over all rows, canvas bytes a lane, flag bytes a
    row) that the borders of an n x n block read: each piece only where its
    flag lets it through (a masked half is substituted, never read). isub
    None: the node's own borders from its context; 0-3: sub-TU isub of the
    TU split, whose flags follow the reference's sub-block tables and whose
    pieces past the context lie in each lane's canvas."""
    g = flags.reshape(-1, 4).long().cpu()
    bll, blb, baa, bar = g.unbind(1)
    if isub is None or isub == 0:
        if isub == 0:
            blb, bar = bll, baa
        ctx = (bll & baa) + n * (bll + blb + baa + bar)
        return int(ctx.sum()), 0, 2 if isub == 0 else 4
    if isub == 1:             # left from the canvas, bll = 1, blb = 0
        return int((baa + n * (baa + bar)).sum()), n, 2
    if isub == 2:             # top from the canvas, baa = bar = 1
        return int((bll + n * (bll + blb)).sum()), 2 * n, 2
    return 0, 2 * n + 1, 0    # all from the canvas, the flags fixed


def x_cost(x, args, kw):
    """(bytes, int32 ops) one call of X kernel x must move and do: each
    input read once where the call's data needs it (borders only where
    their flags let them through, a sub-TU's canvas only where its borders
    lie, modes only where given), each output written once."""
    if x == "x1":
        sz, top, left, flags = args[:4]
        modes = args[4] if len(args) > 4 else kw.get("modes")
        isub = args[6] if len(args) > 6 else kw.get("isub")
        rows = top.numel() // top.shape[-1]
        n = sz if isub is None else sz // 2
        M = 35 if modes is None else modes.shape[-1]
        ctx, canvas, fl = x_border_reads(n, isub, flags)
        nbytes = ctx * top.element_size() + fl * rows + canvas * rows * M \
            + (0 if modes is None else 4 * rows * M) + rows * M * n * n
        return nbytes, rows * M * n * n * X_OPS_PER_PX
    if x == "x2":
        sz, top, left, flags, blk, _, _, K = args
        rows, nn, K = blk.shape[0], sz * sz, min(K, 35)
        ctx, _, fl = x_border_reads(sz, None, flags)
        nbytes = (ctx * top.element_size() + fl * rows + rows * nn
                  + 8 * rows + rows * K * nn + 4 * rows * K)
        per_px = X_OPS_PER_PX + 3 + 2 * (sz.bit_length() - 1)
        return nbytes, rows * (35 * nn * per_px + 35 * 35)
    q = args[2]
    modes = args[9] if len(args) > 9 else kw.get("modes")
    cands = q.shape[0] * q.shape[1]
    # levels; sse, cost and (where given) modes a candidate; ctxv, sigv,
    # pml and pma a row
    nbytes = 2 * q.numel() + 4 * cands * (2 if modes is None else 3) \
        + 16 * q.shape[0]
    return nbytes, q.numel() * X3_OPS_PER_COEF + 40 * cands


# ------------------------------------------------------------ the recorder

def k1_call_ms(args):
    """bound ms of one K1 call, pipeline_sse(sz, qpd6, pred, blk)."""
    sz, _, pred = args[:3]
    M = pred.shape[-3]
    lanes = pred.numel() // (M * sz * sz)
    return k1_tc_bound(sz, M, lanes)[0]


def x_call_ms(x, args, kw):
    """bound ms of one call of X kernel x."""
    nbytes, ops = x_cost(x, args, kw)
    return bound(nbytes, [(ops, INT32_OPS_PER_S)])[0]


class Recorder:
    """Wraps the port's kernel wrappers (K1's fused_eval.pipeline_sse, X1-X3's
    fused_node.predict / preselect / rate_cost) and the slice runner's
    capture while installed. Each kernel call made eagerly during a capture
    (the warm-up step; the capture's own pass records nothing) adds its
    bound to the runner's key: step_ms[key] is then the bound of one replay
    of that runner's step."""

    KERNELS = (("fused_eval", "pipeline_sse", "k1"),
               ("fused_node", "predict", "x1"),
               ("fused_node", "preselect", "x2"),
               ("fused_node", "rate_cost", "x3"))

    def __init__(self, modules, runner_cls):
        """modules maps "fused_eval" and "fused_node" to the port's modules,
        runner_cls is its _SliceRunner."""
        self.modules, self.runner_cls = modules, runner_cls
        self.step_ms = {}
        self._key = None

    def _record(self, name, args, kw):
        if self._key is None or torch.cuda.is_current_stream_capturing():
            return
        ms = k1_call_ms(args) if name == "k1" else x_call_ms(name, args, kw)
        self.step_ms[self._key] = self.step_ms.get(self._key, 0.0) + ms

    @contextlib.contextmanager
    def installed(self):
        """record while the block runs."""
        modules, runner_cls = self.modules, self.runner_cls
        saved = []

        def wrap(mod, attr, name):
            fn = getattr(mod, attr)

            def recorded(*args, **kw):
                self._record(name, args, kw)
                return fn(*args, **kw)
            saved.append((mod, attr, fn))
            setattr(mod, attr, recorded)

        for mod, attr, name in self.KERNELS:
            wrap(modules[mod], attr, name)
        capture = runner_cls.capture

        def keyed_capture(runner):
            self._key = runner_key(runner)
            try:
                return capture(runner)
            finally:
                self._key = None
        saved.append((runner_cls, "capture", capture))
        runner_cls.capture = keyed_capture
        try:
            yield self
        finally:
            for obj, attr, fn in reversed(saved):
                setattr(obj, attr, fn)


def runner_key(runner):
    """a slice runner's shape key: (qpd6, R, Cc, B, rmd)."""
    return (runner.qpd6, runner.R, runner.Cc, runner.B, runner.rmd)
