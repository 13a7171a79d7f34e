"""A stand-in driver of the bit-exact lockstep engine
(`parallel/lockstep.encode_batch`), for tests and sizing runs only: a test
copies it into a benchmark's drivers/ folder, and a configuration names it
with "driver". It is no cell's driver: its reference is the port's own
native engine (`runtime/native.encode_image_native`), where a cell needs a
plain exact reference of its own. See drivers/fast.py for the interface.

Configuration keys: "qpd6", "node_rates" (bool) and "batch" (the images of
one shape that encode_batch takes at once).
"""
import types

from benchmark import devtrace, harness

PORT_KERNELS = ("k1_kernel", "k2_kernel", "x1_predict")
CTU = 32


def prepare(config):
    return {"qpd6": int(config["qpd6"]),
            "node_rates": bool(config["node_rates"])}


def import_program():
    port = harness.import_port
    return types.SimpleNamespace(
        lockstep=port("hevce_tpu_torch.parallel.lockstep"),
        native=port("hevce_tpu_torch.runtime.native"))


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
    """CTUs encoded, and lockstep steps: a batch steps once a CTU of its
    shape, whatever its size."""
    ctus = steps = 0
    for h, w, B in load.shape_batches(idx):
        n = -(-h // CTU) * -(-w // CTU)
        ctus += n * B
        steps += n
    return {"ctus": ctus, "ctu_steps": steps}


def recorder(run):
    return None


def bound_ms(run, calls, recorder):
    return None


def lost_launches(made, kernels):
    seen = devtrace.port_counts(kernels, PORT_KERNELS)
    return {k: made[k] - seen[p]
            for k, p in zip(("k1", "k2", "x1"), PORT_KERNELS)
            if made[k] > seen[p]}


def release(run):
    from hevce_tpu_torch.utils import graphs
    ls = run.program.lockstep
    for cached in (ls._node_program, ls._pu_program, ls._gather_program):
        cached.cache_clear()
    graphs.CAPTURED.clear()


def reference(run, images):
    return [run.program.native.encode_image_native(im, run.opts["qpd6"])[1]
            for im in images]
