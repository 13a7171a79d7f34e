"""K2, the CABAC rate scan, at the lockstep path's four shapes on the card.

The shapes (k2_shapes): PU events, 630 lanes (a batch of 18 x 35 modes),
cap 256, a 39-slot palette; node events at CU size 8 / 16 / 32, 1260
lanes, caps 768 / 2048 / 7168, 69 / 67 / 59 slots. For each:
  * K2 (ops/cabac_scan) must equal its plain version (scan_plain) on the op
    strings of real candidate blocks (a lockstep event's requests through
    K1 and the op generation), on random strings and on adversarial ones
    (0xFF / carry / 0x00 runs): the 7 coder scalars and the palette,
    tolerance 0;
  * on the real strings, the card ms (torch.profiler) of one advance_rates
    call as the encoder makes it (K2 and the wrapper's stack of the
    scalars), and beside it of K2 alone; ns per op of the longest lane
    (the call's ms / max_nops) and the bound (each op and scalar moved
    once at 3.35 TB/s, or 30 int32 operations an op at 33.5 TOP/s,
    whichever is longer);
  * the same call with no op to run (its launches, prologue and epilogue),
    and the rest of its time over max_nops: the marginal ns of an op;
then ms per lockstep CTU with node rates on (64 PU, 16 node8, 4 node16 and
1 node32 call), of the calls and of the kernel alone.

--diag also times, at the node32 shape and the real strings' longest count,
strings of context bins only, bypass runs only, and context bins that all
hit one slot, each held against the plain version: their gap to the real
strings shows what the mix of kinds and the context chain cost.

Each result is a line; the last line is one JSON object of them all. A
difference from the plain version exits non-zero. It needs a CUDA device.

Usage: python -m hevce_tpu_torch.tools.bench_k2 [--diag] [--seed N]
"""
import argparse
import json

import numpy as np
import torch

from hevce_tpu_torch.ops import cabac_scan
from hevce_tpu_torch.ops import cabac_sim as cs
from hevce_tpu_torch.utils import device as _device
from hevce_tpu_torch.utils import timing
from hevce_tpu_torch.utils.device import HBM_BYTES_PER_S, INT32_OPS_PER_S

# the lockstep path as chip_smoke.py drives it: a batch of 18 images at
# qpd6 2; per CTU 64 PU events and, with node rates, 21 node events (sz 32:
# 1, 16: 4, 8: 16), each one K2 launch (csrc/hevce_host.cpp)
QPD6 = 2
BATCH = 18
PU_PER_CTU = 64
NODE_PER_CTU = {32: 1, 16: 4, 8: 16}
# K2's work per op: decoding the op word, the bin update and the refill
# are at least 30 int32 operations
K2_OPS_PER_OP = 30
REPS = 20


class Mismatch(RuntimeError):
    """K2 disagreed with its plain version."""


# ------------------------------------------------------------------ inputs

def k2_shapes():
    """the lockstep path's K2 shapes: (name, sz, lanes, cap, palette P,
    launches per CTU with node_rates on)."""
    from hevce_tpu_torch.ops import coef_ops
    from hevce_tpu_torch.parallel import lockstep

    shapes = [("pu", 4, BATCH * 35, lockstep.PU_CAP,
               len(coef_ops._palette(4, False)[0]), PU_PER_CTU)]
    for sz in (8, 16, 32):
        shapes.append((f"node{sz}", sz, 2 * BATCH * 35,
                       lockstep._NODE_CAPS[sz],
                       len(coef_ops._palette(sz, True)[0]), NODE_PER_CTU[sz]))
    return shapes


def lock_requests(dev, rng, sz):
    """a lockstep event's requests at CU size sz: a batch of 18 CUs cut from
    synthetic images (clamped neighbour reads, all borders present)."""
    from hevce_tpu_torch.utils.synth import synth_image

    tops, lefts, origs = [], [], []
    for b in range(BATCH):
        img = synth_image(rng, 96, 128, (1.5, 6.0, 30.0)[b % 3])
        y, x = int(rng.integers(1, 96 - sz)), int(rng.integers(1, 128 - sz))
        cols = np.clip(np.arange(x - 1, x + 2 * sz), 0, 127)
        rows = np.clip(np.arange(y, y + 2 * sz), 0, 95)
        tops.append(img[y - 1, cols])
        lefts.append(img[rows, x - 1])
        origs.append(img[y:y + sz, x:x + sz])
    to = lambda a: torch.from_numpy(np.stack(a).astype(np.int32)).to(dev)
    fl = torch.ones((BATCH, 4), dtype=torch.bool, device=dev)
    return to(tops), to(lefts), fl, to(origs)


def k2_block_inputs(dev, rng, sz):
    """K2's inputs as a lockstep event at sz hands them over: a batch of 18
    requests (lock_requests), candidate blocks from K1, op generation
    (ops/coef_ops), a fresh coder fork."""
    from hevce_tpu_torch.bitstream import cabac as cb
    from hevce_tpu_torch.models import cu_eval
    from hevce_tpu_torch.ops import coef_ops
    from hevce_tpu_torch.parallel import lockstep

    top, left, fl, orig = lock_requests(dev, rng, sz)
    q1, _, _ = cu_eval.eval_2nx2n(sz, QPD6, top, left, fl, orig)
    if sz == 4:
        pm = torch.arange(35, dtype=torch.int32, device=dev).repeat(BATCH)
        state, ops, nops, _ = coef_ops.put_coef_trials(
            4, QPD6, pm, q1.reshape(-1, 4, 4), cap=lockstep.PU_CAP)
        return state, ops, nops
    q4, _, _ = cu_eval.eval_tusplit(sz, QPD6, top, left, fl, orig)
    st = cs.initial_state(BATCH, QPD6, dev)
    state7 = torch.stack([st[f] for f in cs.FIELDS], 1)
    fctxs = torch.as_tensor(np.frombuffer(bytes(cb.new_context_set(QPD6)),
                                          np.uint8).astype(np.int32),
                            device=dev).repeat(BATCH, 1)
    meta = torch.from_numpy(np.stack(
        [rng.integers(0, 35, BATCH), rng.integers(0, 35, BATCH),
         rng.integers(0, 2, BATCH), rng.integers(0, 2, BATCH)],
        1).astype(np.int32)).to(dev)
    fork, ops, nops, _, _ = lockstep._node_trials(sz, q1, q4, state7, fctxs,
                                                  meta)
    return fork, ops, nops


def _state(dev, lanes, P, qpd6):
    state = cs.initial_state(lanes, qpd6, dev)
    state["ctxs"] = state["ctxs"][:, :P].contiguous()
    return state


def _padded(dev, ops, nops):
    """int32 tensors of ops, nop-padded past each lane's count, and nops."""
    ops[np.arange(ops.shape[1])[None, :] >= nops[:, None]] = cs.KIND_NOP
    return (torch.from_numpy(ops.astype(np.int32)).to(dev),
            torch.from_numpy(nops.astype(np.int32)).to(dev))


def k2_synthetic_inputs(dev, rng, lanes, cap, P, adversarial):
    """random op strings over a P-slot palette, or adversarial ones: a
    third all-ones bypass runs between bins (outstanding 0xFF bytes), a
    third runs of seven 1-bins between single bins (carries into them), a
    third all-zero runs (emulation-prevention bytes). Nop-padded past each
    lane's random count."""
    shape = (lanes, cap)
    ctx = (cs.KIND_CTX | (rng.integers(0, P, shape) << 2)
           | (rng.integers(0, 2, shape) << 10))
    n = rng.integers(1, 9, shape)
    byp = (cs.KIND_BYPASS | (n << 2)
           | ((rng.integers(0, 256, shape) & ((1 << n) - 1)) << 6))
    term = cs.KIND_TERM | ((rng.random(shape) < 0.02) << 10)
    r = rng.random(shape)
    if adversarial:
        third = np.arange(lanes)[:, None] * 3 // lanes
        bit = cs.KIND_BYPASS | (1 << 2) | (rng.integers(0, 2, shape) << 6)
        ops = np.where(
            third == 0, np.where(r < 0.5, cs.pack_bypass(0xFF, 8), ctx),
            np.where(third == 1,
                     np.where(r < 0.5, cs.pack_bypass(0x7F, 7), bit),
                     np.where(r < 0.9, cs.pack_bypass(0, 8), ctx)))
    else:
        ops = np.where(r < 0.45, ctx, np.where(r < 0.9, byp, term))
    nops = rng.integers(cap // 2, cap + 1, lanes)
    state = _state(dev, lanes, P, int(rng.integers(0, 5)))
    return (state, *_padded(dev, ops, nops))


DIAG_KINDS = ("context", "bypass", "one_slot")


def k2_diag_inputs(dev, rng, kind, lanes, cap, P, count):
    """`count` ops a lane (nop-padded to cap) of one kind: context bins on
    random slots and bins ("context"), bypass runs of random length and
    value ("bypass"), or context bins on slot 0 ("one_slot": every op waits
    for the one before it through the palette)."""
    shape = (lanes, cap)
    bins = rng.integers(0, 2, shape) << 10
    if kind == "context":
        ops = cs.KIND_CTX | (rng.integers(0, P, shape) << 2) | bins
    elif kind == "one_slot":
        ops = cs.KIND_CTX | bins
    elif kind == "bypass":
        n = rng.integers(1, 9, shape)
        ops = (cs.KIND_BYPASS | (n << 2)
               | ((rng.integers(0, 256, shape) & ((1 << n) - 1)) << 6))
    else:
        raise ValueError(f"no diagnostic string {kind!r}: {DIAG_KINDS}")
    nops = np.full(lanes, count)
    state = _state(dev, lanes, P, QPD6)
    return (state, *_padded(dev, ops, nops))


def k2_cost(state, nops):
    """(bytes, int32 ops) one call must move and do: the real ops (4 B
    each), the op counts, the 7 scalars in and out, the palette in."""
    lanes, P = state["ctxs"].shape
    n = int(nops.sum())
    return (4 * n + 4 * lanes + 2 * 7 * 4 * lanes + 4 * lanes * P,
            K2_OPS_PER_OP * n)


def k2_bound(state, nops):
    """(bound ms, bound_by) of one K2 call on these inputs."""
    nbytes, n_ops = k2_cost(state, nops)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, n_ops / INT32_OPS_PER_S
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


# ------------------------------------------------------------------ checks

def compare(got, want, where):
    """the 7 scalars and the palette of `got` against `want`, tolerance 0:
    raises Mismatch on a difference, else returns the largest |error| (0)."""
    worst = 0
    for k in cs.FIELDS + ("ctxs",):
        err = int((got[k].to(torch.int64)
                   - want[k].to(torch.int64)).abs().max())
        if err:
            raise Mismatch(f"K2 {k} differs from the plain version {where}: "
                           f"max |err| {err}")
        worst = max(worst, err)
    return worst


SASS_OPCODES = ("BSSY", "BRA", "FLO")


def sass_stats(path):
    """instructions of k2_kernel in the library at `path`, by opcode: BSSY
    opens a region where the warp's lanes may branch apart, BRA is any
    branch (loops included), FLO the count of leading zeros."""
    from hevce_tpu_torch.ops import probes

    return {op: sum(n for fn, n in probes.sass_counts(path, op).items()
                    if "k2_kernel" in fn) for op in SASS_OPCODES}


def call_ms(state, ops, nops):
    """card ms of one advance_rates call: K2 and the wrapper's stack of the
    7 scalars, as the encoder calls it."""
    return timing.card_ms(
        lambda: cabac_scan.advance_rates(state, ops, nops), REPS)


def kernel_ms(state, ops, nops):
    """card ms of K2 alone: its scalars stacked once, outside the timed
    launches."""
    st_in = torch.stack([state[f] for f in cs.FIELDS])
    return timing.card_ms(
        lambda: cabac_scan.launch(st_in, state["ctxs"], ops, nops), REPS)


def shape_row(name, per_ctu, state, ops, nops):
    """one shape's times on these inputs: ms (the advance_rates call's card
    time), kernel_ms (K2 alone), ns_per_op (ms over the longest lane's
    count) and the bound."""
    b_ms, by = k2_bound(state, nops)
    max_nops = int(nops.max())
    ms = call_ms(state, ops, nops)
    return {"shape": name, "lanes": int(nops.numel()),
            "P": int(state["ctxs"].shape[1]), "per_ctu": per_ctu,
            "sum_nops": int(nops.sum()), "max_nops": max_nops, "ms": ms,
            "kernel_ms": kernel_ms(state, ops, nops),
            "ns_per_op": 1e6 * ms / max(max_nops, 1), "bound_ms": b_ms,
            "bound_by": by}


def per_ctu_ms(rows, key="ms"):
    return sum(r["per_ctu"] * r[key] for r in rows)


# --------------------------------------------------------------------- run

def run(dev, out=print, diag=False, seed=0):
    """the checks and times above; returns the dict of the last line.
    Raises Mismatch if K2 differs from its plain version."""
    rng = np.random.default_rng(seed)
    path, log = cabac_scan.build(force=True)     # for ptxas's report
    res = {"ptxas": [ln.strip() for ln in log.splitlines()
                     if "registers" in ln or "spill" in ln],
           "sass": sass_stats(path), "max_abs_err": 0, "checked": 0}
    out(f"K2 on {torch.cuda.get_device_name(dev)}; ptxas: "
        f"{json.dumps(res['ptxas'])}; SASS: {json.dumps(res['sass'])}")

    def check(inputs, where):
        want = cabac_scan.scan_plain(*inputs)
        got = cabac_scan.advance_rates(*inputs, want_ctxs=True)
        torch.cuda.synchronize()
        res["max_abs_err"] = max(res["max_abs_err"],
                                 compare(got, want, where))
        res["checked"] += 1

    rows, longest = [], 0
    for name, sz, lanes, cap, P, per_ctu in k2_shapes():
        block = k2_block_inputs(dev, rng, sz)
        if tuple(block[1].shape) != (lanes, cap) or \
                block[0]["ctxs"].shape[1] != P:
            raise RuntimeError(
                f"K2 {name}: path inputs {tuple(block[1].shape)} P="
                f"{block[0]['ctxs'].shape[1]}, expected ({lanes}, {cap}) "
                f"P={P}")
        check(block, f"at {name} (blocks)")
        for case in ("random", "adversarial"):
            check(k2_synthetic_inputs(dev, rng, lanes, cap, P,
                                      case == "adversarial"),
                  f"at {name} ({case})")
        r = shape_row(name, per_ctu, *block)
        # the same call with no op to run: its launch, prologue and
        # epilogue; the rest of its time over max_nops is the marginal
        # time of one op
        r["empty_ms"] = call_ms(block[0], block[1],
                                torch.zeros_like(block[2]))
        r["marginal_ns_per_op"] = (1e6 * (r["ms"] - r["empty_ms"])
                                   / max(r["max_nops"], 1))
        rows.append(r)
        longest = r["max_nops"]
        out(f"{name:6s} lanes={r['lanes']} P={r['P']} "
            f"max_nops={r['max_nops']}: {r['ms']:.4f} ms a call "
            f"({r['kernel_ms']:.4f} the kernel alone), "
            f"{r['ns_per_op']:.1f} ns/op, with no op {r['empty_ms']:.4f} ms, "
            f"{r['marginal_ns_per_op']:.1f} ns a further op (bound "
            f"{r['bound_ms']:.5f} ms, {r['bound_by']}) EXACT")
    res.update(shapes=rows, ms_per_ctu=per_ctu_ms(rows),
               kernel_ms_per_ctu=per_ctu_ms(rows, "kernel_ms"))
    out(f"per lockstep CTU: {res['ms_per_ctu']:.4f} ms "
        f"({res['kernel_ms_per_ctu']:.4f} the kernel alone)")
    if diag:
        name, sz, lanes, cap, P, _ = k2_shapes()[-1]
        res["diag"] = {}
        for kind in DIAG_KINDS:
            inputs = k2_diag_inputs(dev, rng, kind, lanes, cap, P, longest)
            check(inputs, f"at {name} ({kind})")
            ms = call_ms(*inputs)
            res["diag"][kind] = {"ms": ms, "ns_per_op": 1e6 * ms / longest}
            out(f"diag   {name} {kind:8s} {longest} ops a lane: {ms:.4f} "
                f"ms, {1e6 * ms / longest:.1f} ns/op EXACT")
    out(json.dumps(res))
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--diag", action="store_true",
                    help="also time one-kind strings at the node32 shape")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    dev = _device.resolve(None)
    try:
        run(dev, diag=args.diag, seed=args.seed)
    except Mismatch as e:
        print(f"MISMATCH: {e}", flush=True)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
