"""The bit-exact lockstep engine's driver: what the harness calls to run a
cell of `parallel/lockstep.encode_batch` (pipeline off, node rates as the
configuration says), to bound its kernels K1, X1 and K2
(bounds_lockstep.py), and to work its images out again with the reference
encoder's exact RDO in plain PyTorch (reference/exact.py). A configuration
names it with "driver": "lockstep"; drivers/fast.py lists the interface.

A call's images are grouped by shape into batches of the configuration's
"batch", each one encode_batch: its C++ arbiters walk the CU search
schedule, and every node and PU event of a CTU step replays an event
program on the card for all the batch's images at once.
"""
import types

from benchmark import devtrace, harness

PORT_KERNELS = ("k1_kernel", "k2_kernel", "x1_predict")
CTU = 32
# schedule events a CTU step: 21 node events (one 32x32, four 16x16,
# sixteen 8x8) and 64 PU events, each followed by its fetch event
EVENTS_PER_STEP = 21 + 64


def prepare(config):
    """{"qpd6", "node_rates"}."""
    return {"qpd6": int(config["qpd6"]),
            "node_rates": bool(config["node_rates"])}


def import_program():
    """the lockstep engine and the modules of its kernels' wrappers
    (fused_eval, fused_node, cabac_scan)."""
    port = harness.import_port
    return types.SimpleNamespace(
        lockstep=port("hevce_tpu_torch.parallel.lockstep"),
        fused_eval=port("hevce_tpu_torch.ops.fused_eval"),
        fused_node=port("hevce_tpu_torch.ops.fused_node"),
        cabac_scan=port("hevce_tpu_torch.ops.cabac_scan"))


def _batches(load, idx):
    """positions in idx of the call's batches: same-shaped images in groups
    of at most load.batch, in the order of loadgen.batches."""
    by_shape = {}
    for k, i in enumerate(idx):
        by_shape.setdefault(load.pool[i].shape, []).append(k)
    return [ks[j:j + load.batch] for ks in by_shape.values()
            for j in range(0, len(ks), load.batch)]


def encode(run, idx, timer):
    out = [None] * len(idx)
    for ks in _batches(run.load, idx):
        streams, _ = run.program.lockstep.encode_batch(
            [run.load.pool[idx[k]] for k in ks], run.opts["qpd6"],
            node_rates=run.opts["node_rates"], timer=timer, pipeline=False,
            device=run.device)
        for k, s in zip(ks, streams):
            out[k] = s
    return out


def work(load, idx):
    """CTUs encoded, CTU steps (a batch steps once a CTU of its shape,
    whatever its size) and schedule events (EVENTS_PER_STEP a step)."""
    ctus = steps = 0
    for h, w, B in load.shape_batches(idx):
        n = -(-h // CTU) * -(-w // CTU)
        ctus += n * B
        steps += n
    return {"ctus": ctus, "ctu_steps": steps,
            "events": steps * EVENTS_PER_STEP}


def recorder(run):
    """a bounds_lockstep.Recorder of K1, X1 and K2 over each event
    program's warm-up step."""
    from benchmark import bounds_lockstep
    p = run.program
    return bounds_lockstep.Recorder({"fused_eval": p.fused_eval,
                                     "fused_node": p.fused_node,
                                     "cabac_scan": p.cabac_scan},
                                    p.lockstep)


def bound_ms(run, calls, recorder):
    """the kernels' bound over the calls' replays: a batch of B images steps
    once a CTU, each step replaying the node and PU programs of B as the
    schedule says; None if one of them was not recorded."""
    total = 0.0
    for idx in calls:
        for h, w, B in run.load.shape_batches(idx):
            step = recorder.ctu_step_ms(B)
            if step is None:
                return None
            total += -(-h // CTU) * -(-w // CTU) * step
    return total


def lost_launches(made, kernels):
    """{k1, k2, x1: launches the wrappers made that the trace lacks}."""
    seen = devtrace.port_counts(kernels, PORT_KERNELS)
    return {k: made[k] - seen[p]
            for k, p in zip(("k1", "k2", "x1"), PORT_KERNELS)
            if made[k] > seen[p]}


def release(run):
    """the event programs and their captured graphs."""
    from hevce_tpu_torch.utils import graphs
    ls = run.program.lockstep
    for cached in (ls._node_program, ls._pu_program, ls._gather_program):
        cached.cache_clear()
    graphs.CAPTURED.clear()


def reference(run, images):
    from benchmark.reference import exact
    return exact.encode_recon(images, run.opts["qpd6"], run.device)
