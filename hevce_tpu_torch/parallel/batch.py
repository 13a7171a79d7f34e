"""Batched CU candidate evaluation, split over a mesh of devices.

The encoder's device work is embarrassingly parallel over images (and over
CTUs in a wavefront): one device step evaluates all 35 modes x {1-TU, 4-TU}
candidates for a batch of CU nodes. A mesh is a sequence of torch.device;
sharded() cuts a batch axis into one equal contiguous part per mesh entry,
issues each part's work on its device and gathers the results in order on
the first. This is data parallelism over images with no collectives, as
the JAX package's 'img' mesh axis is. A device may appear more than once
(two parts on one card).
"""
import contextlib

import numpy as np
import torch

from hevce_tpu_torch.models import cu_eval
from hevce_tpu_torch.utils import device as _device


def make_mesh(devices=None):
    """The mesh over `devices` (each resolved as utils/device.resolve does),
    or over every CUDA device; raises without CUDA unless the devices are
    "cpu"."""
    if devices is None:
        _device.resolve(None)
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    mesh = tuple(_device.resolve(d) for d in devices)
    if not mesh:
        raise ValueError("a mesh needs at least one device")
    return mesh


def check_split(n: int, mesh) -> None:
    if n % len(mesh):
        raise ValueError(f"a batch of {n} is not a multiple of the mesh "
                         f"size {len(mesh)}")


def _gather(outs, dev):
    """the parts' outputs (tensors, None, or tuples / lists of them)
    concatenated in mesh order on dev."""
    first = outs[0]
    if first is None:
        return None
    if isinstance(first, torch.Tensor):
        return torch.cat([o.to(dev) for o in outs])
    return type(first)(_gather([o[j] for o in outs], dev)
                       for j in range(len(first)))


def sharded(fn, mesh, *args, gather=True):
    """fn(*args) split over mesh: every argument's leading axis is cut into
    len(mesh) equal contiguous parts, and part i runs fn(i, *its rows) with
    mesh[i] the current device (a tensor's rows moved there first; numpy
    rows passed as they are, for fn to load). The outputs are gathered in
    order on mesh[0], or with gather=False returned as the list of the
    parts'. The batch must be a multiple of the mesh size. mesh=None:
    fn(0, *args) as they lie (in a list of one with gather=False)."""
    if mesh is None:
        out = fn(0, *args)
        return out if gather else [out]
    n = args[0].shape[0]
    check_split(n, mesh)
    k = n // len(mesh)
    outs = []
    for i, dev in enumerate(mesh):
        on = (torch.cuda.device(dev) if dev.type == "cuda"
              else contextlib.nullcontext())
        rows = [a[i * k:(i + 1) * k] for a in args]
        with on:
            outs.append(fn(i, *(r.to(dev) if isinstance(r, torch.Tensor)
                                else r for r in rows)))
    return _gather(outs, mesh[0]) if gather else outs


def device_step(sz: int, qpd6: int, ctx_top, ctx_left, flags, blk_orig):
    """One batched node evaluation: both TU layouts for B nodes.

    ctx_top (B, 1+2sz), ctx_left (B, 2sz), flags (B, 4) bool, blk_orig
    (B, sz, sz). Returns (q1 (B,35,sz,sz), r1, sse1, q4 (B,35,4,h,h), r4,
    sse4). Five K1 launches on the card."""
    q1, r1, s1 = cu_eval.eval_2nx2n(sz, qpd6, ctx_top, ctx_left, flags,
                                    blk_orig)
    q4, r4, s4 = cu_eval.eval_tusplit(sz, qpd6, ctx_top, ctx_left, flags,
                                      blk_orig)
    return q1, r1, s1, q4, r4, s4


def device_step_fn(sz: int, qpd6: int, mesh=None):
    """device_step at (sz, qpd6) as a function of its four inputs (the JAX
    package's jit_device_step): on the inputs' own device, or split over
    `mesh` (make_mesh) with the outputs gathered on its first device. The
    inputs are tensors or numpy arrays. Each part replays the rates-off
    node program of its device and batch (parallel/lockstep._node_program,
    part i in slot (0, i)); what it returns is fresh memory."""
    # lockstep imports this module: the program cache is looked up at call
    from hevce_tpu_torch.parallel import lockstep

    mesh = None if mesh is None else make_mesh(mesh)

    def run(*args):
        args = [a if isinstance(a, torch.Tensor) else np.asarray(a)
                for a in args]
        first = args[0]
        devs = mesh or (first.device if isinstance(first, torch.Tensor)
                        else torch.device("cpu"),)

        def part(i, *rows):
            prog = lockstep._node_program(sz, qpd6, rows[0].shape[0], False,
                                          _device.normal(devs[i]), (0, i))
            prog.load(rows)
            return prog()
        with torch.no_grad():
            out = sharded(part, mesh, *args)
            if mesh is None:      # the program's own outputs: copy them out
                out = tuple(t.clone() for t in out)
        return out
    return run


def random_node_batch(sz: int, batch: int, seed=0):
    """synthetic node inputs (numpy) for compile checks and benchmarks; the
    same generator and draws as the JAX package's, so a seed gives both
    packages the same batch."""
    rng = np.random.default_rng(seed)
    ctx_top = rng.integers(0, 256, (batch, 1 + 2 * sz)).astype(np.int32)
    ctx_left = rng.integers(0, 256, (batch, 2 * sz)).astype(np.int32)
    flags = np.ones((batch, 4), bool)
    blk = rng.integers(0, 256, (batch, sz, sz)).astype(np.int32)
    return ctx_top, ctx_left, flags, blk
