"""Captured steps: the port's counterpart of the JAX package's jitted
programs.

The JAX package runs each device step as one compiled program per shape
(a jax.jit, lru-cached per key). Here a step is a function over static
device buffers; CapturedStep records it once as a CUDA graph and every
call replays it. On the CPU the same step runs eagerly at every call.

Capture (CUDA): one eager warm-up step on a side stream (cuBLAS's handle and
workspace for that stream, the per-device tables each step uploads on first
use, the kernels' modules), then the capture of the step on that stream into
a graph with a private memory pool (CUDAGraph(keep_graph=True)), with host
syncs raised as errors (torch.cuda.set_sync_debug_mode), and its
instantiation. A failed capture raises; nothing runs the step eagerly on
CUDA after it. The kernel counters (COUNTERS: K1's fused_eval.LAUNCHES,
K2's cabac_scan.LAUNCHES, X1-X4's fused_node.X1.LAUNCHES ...) keep counting
the kernels the card runs: the warm-up's launches stay, the capture's (no
kernel runs) are taken back and added again at every replay.

Program: a step whose inputs are views of one int32 device buffer, loaded
from the host with one copy, and whose outputs are static: a replay
overwrites the outputs of the call before, so a caller copies out (or
consumes) whatever must outlive the next call of the same program.
"""
import collections
import math
import time

import numpy as np
import torch

from hevce_tpu_torch.ops import cabac_scan, fused_eval, fused_node

# the kernel wrappers whose LAUNCHES count launches on the card
COUNTERS = {"k1": fused_eval, "k2": cabac_scan, "x1": fused_node.X1,
            "x2": fused_node.X2, "x3": fused_node.X3, "x4": fused_node.X4}
# every step captured in this process, in order (what the count checks of
# chip_smoke.py add: one warm-up step per capture)
CAPTURED = []


def built(since: int = 0):
    """{kind: steps captured} over CAPTURED[since:]."""
    return collections.Counter(s.kind for s in CAPTURED[since:])


class CapturedStep:
    """step() captured on `device` (CUDA) at construction, or run eagerly
    at every call (CPU). kind names the step for built().

    Attributes after a capture: graph (the CUDAGraph; None on the CPU), out
    (what the captured step returned: the tensors every replay rewrites),
    launches ({"k1": n, "k2": n, "x1": n, ...} a replay adds to the
    counters), stats (the seconds of the warm-up step, the capture and the
    instantiation, and the bytes the capture reserved: its pool)."""

    def __init__(self, step, device: torch.device, kind: str):
        self.step, self.device, self.kind = step, device, kind
        self.graph, self.out, self.launches, self.stats = None, None, {}, {}
        if device.type == "cuda":
            self._capture()
            CAPTURED.append(self)

    def _capture(self):
        stream = torch.cuda.Stream(self.device)
        stream.wait_stream(torch.cuda.current_stream(self.device))
        t0 = time.perf_counter()
        with torch.no_grad(), torch.cuda.stream(stream):
            self.step()
        stream.synchronize()
        t1 = time.perf_counter()
        torch.cuda.empty_cache()       # as the capture does first: the pool
        mem0 = torch.cuda.memory_reserved(self.device)    # is what it adds
        n0 = {k: m.LAUNCHES for k, m in COUNTERS.items()}
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        try:
            with torch.no_grad(), torch.cuda.graph(graph, stream=stream):
                mode = torch.cuda.get_sync_debug_mode()
                torch.cuda.set_sync_debug_mode("error")
                try:
                    out = self.step()
                finally:
                    torch.cuda.set_sync_debug_mode(mode)
        finally:
            for k, m in COUNTERS.items():
                self.launches[k] = m.LAUNCHES - n0[k]
                m.LAUNCHES = n0[k]
        t2 = time.perf_counter()
        graph.instantiate()
        self.stats = {"warmup_s": t1 - t0, "capture_s": t2 - t1,
                      "instantiate_s": time.perf_counter() - t2,
                      "pool_bytes": torch.cuda.memory_reserved(self.device)
                      - mem0}
        self.graph, self.out = graph, out

    def __call__(self):
        """one replay of the captured step (its outputs: self.out), or on
        the CPU the step itself."""
        if self.graph is None:
            return self.step()
        self.graph.replay()
        for k, n in self.launches.items():
            COUNTERS[k].LAUNCHES += n
        return self.out


class Program:
    """step(*inputs) as a CapturedStep over static inputs.

    fields: the input shapes, each an int32 view of one device buffer inp
    (a step takes flags as int32 and compares them with 0 itself); fill: an
    optional fill(*inputs) giving the warm-up step a valid request (inputs
    are zero otherwise); fetch: the indices of the outputs that fetched()
    copies to the host.

    A call returns the step's outputs: on CUDA the captured ones, which the
    next call of this program overwrites. load() takes its arrays before it
    returns (numpy arrays through one pinned staging buffer, reused only by
    the next load(), which follows this call's fetch). fetched() copies
    into pinned host buffers and waits for them (wait() alone waits): numpy
    views that the next fetch overwrites. start_copy(idx) does the same for
    other outputs, into pinned buffers of their own."""

    def __init__(self, kind, fields, step, device: torch.device,
                 fetch=(), fill=None):
        sizes = [math.prod(shape) for shape in fields]
        self.kind, self.device = kind, device
        self.inp = torch.zeros(sum(sizes), dtype=torch.int32, device=device)
        self.args = [v.view(shape) for v, shape
                     in zip(self.inp.split(sizes), fields)]
        cuda = device.type == "cuda"
        self.stage = torch.empty(sum(sizes), dtype=torch.int32,
                                 pin_memory=cuda)
        if fill is not None:
            fill(*self.args)
        self.fetch = fetch
        self.out = None
        self._host, self._ready = None, None
        self._copies = {}   # start_copy's pinned buffers, by indices
        self._started = False
        self.run = CapturedStep(lambda: step(*self.args), device, kind)

    def load(self, arrays):
        """the inputs, in field order: numpy arrays (staged on the host and
        copied to the device with one non-blocking copy) or tensors (copied
        one by one)."""
        if any(isinstance(a, torch.Tensor) for a in arrays):
            for v, a in zip(self.args, arrays):
                v.copy_(torch.as_tensor(a).reshape(v.shape))
            return
        stage = self.stage.numpy()
        off = 0
        for v, a in zip(self.args, arrays):
            n = v.numel()
            np.copyto(stage[off:off + n].reshape(v.shape),
                      np.reshape(a, v.shape), casting="unsafe")
            off += n
        self.inp.copy_(self.stage, non_blocking=True)

    def __call__(self):
        self.out = self.run()
        self._started = False
        return self.out

    def start_fetch(self):
        """queue the copies of the fetched outputs to the host (CUDA: into
        pinned buffers, behind an event) without waiting."""
        outs = [self.out[i] for i in self.fetch]
        self._started = True
        if self.device.type != "cuda":
            self._host = outs
            return
        if self._host is None:
            self._host = [torch.empty(t.shape, dtype=t.dtype,
                                      pin_memory=True) for t in outs]
            self._ready = torch.cuda.Event()
        for h, t in zip(self._host, outs):
            h.copy_(t, non_blocking=True)
        self._ready.record(torch.cuda.current_stream(self.device))

    def start_copy(self, idx):
        """queue copies of the outputs idx (a tuple) of the last call to the
        host, which wait() then waits for too, and return their numpy
        views: on CUDA pinned buffers of these indices, which the next
        start_copy(idx) overwrites; on the CPU the outputs themselves."""
        outs = [self.out[i] for i in idx]
        if self.device.type != "cuda":
            return [t.numpy() for t in outs]
        bufs = self._copies.get(idx)
        if bufs is None:
            bufs = self._copies[idx] = [
                torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                for t in outs]
        for h, t in zip(bufs, outs):
            h.copy_(t, non_blocking=True)
        if self._ready is None:
            self._ready = torch.cuda.Event()
        self._ready.record(torch.cuda.current_stream(self.device))
        return [h.numpy() for h in bufs]

    def wait(self):
        """start the copies of the fetched outputs unless start_fetch() did,
        and wait for them (CUDA: the host's wait for the card)."""
        if not self._started:
            self.start_fetch()
        if self._ready is not None:
            self._ready.synchronize()

    def fetched(self):
        """the fetched outputs of the last call on the host (starting their
        copies now unless start_fetch() did)."""
        self.wait()
        return [h.numpy() for h in self._host]
