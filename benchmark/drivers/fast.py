"""The wavefront fast mode's driver: what the harness calls to run a cell of
`models/wavefront.encode_many_fast` (HEVCE_ADAPT=pre, lean records), to
bound its kernels K1 and X1-X3, and to work its images out again in plain
PyTorch (reference/search.py). A configuration without "driver" names this
one.

A driver is a module under drivers/, found by the stem that a configuration
names (harness.Bench.driver), with:

    prepare(config) -> opts            the configuration's settings; raises
                                       harness.Fail for one it cannot run
    import_program() -> program        the port's modules, from this checkout
    encode(run, idx, timer) -> streams one call of the pool images idx
    work(load, idx) -> {name: number}  what one call does, summed over the
                                       window's and the stretch's calls
                                       (idx empty: every name, at 0)
    PORT_KERNELS                       the port's hand-written kernels, by a
                                       substring of their names
    recorder(run) -> recorder or None  installed() around the warm-up calls
    bound_ms(run, calls, recorder)     the kernels' bound over the calls, ms
    lost_launches(made, kernels)       kernels launched and not traced
    release(run)                       frees the program's state on the card
    reference(run, images)             the plain reconstructions
"""
import os
import types

from benchmark import devtrace, harness

PORT_KERNELS = ("k1_kernel", "x1_predict", "x2_preselect", "x3_rate_cost")


def prepare(config):
    """{"qpd6", "rmd"}; sets HEVCE_ADAPT from the configuration."""
    if config["adapt"] != "pre" or config["records"] != "lean":
        raise harness.Fail("the reference works out HEVCE_ADAPT=pre with "
                           "lean records only")
    rmd = config["rmd"]
    os.environ["HEVCE_ADAPT"] = config["adapt"]
    return {"qpd6": int(config["qpd6"]),
            "rmd": None if rmd is None else tuple(rmd)}


def import_program():
    """the fast mode (wavefront) and the modules of its kernels' wrappers
    (fused_eval, fused_node)."""
    port = harness.import_port
    return types.SimpleNamespace(
        wavefront=port("hevce_tpu_torch.models.wavefront"),
        fused_eval=port("hevce_tpu_torch.ops.fused_eval"),
        fused_node=port("hevce_tpu_torch.ops.fused_node"))


def encode(run, idx, timer):
    streams, _ = run.program.wavefront.encode_many_fast(
        [run.load.pool[i] for i in idx], run.opts["qpd6"],
        batch=run.load.batch, timer=timer, want_recon=False,
        rmd=run.opts["rmd"], device=run.device)
    return streams


def work(load, idx):
    """the front steps one call replays."""
    return {"fronts": load.fronts(idx)}


def recorder(run):
    """a bounds.Recorder of K1 and X1-X3 over each slice runner's warm-up
    step."""
    from benchmark import bounds
    p = run.program
    return bounds.Recorder({"fused_eval": p.fused_eval,
                            "fused_node": p.fused_node},
                           p.wavefront._SliceRunner)


def bound_ms(run, calls, recorder):
    """the port's kernels' bound over the calls' replays: a batch of key
    (qpd6, R, Cc, B, rmd) replays D front steps, each bounded by its
    warm-up step's calls; None if a key was not recorded."""
    from benchmark import loadgen
    total = 0.0
    for idx in calls:
        for h, w, B in run.load.shape_batches(idx):
            key = (run.opts["qpd6"], -(-h // 32), -(-w // 32), B,
                   run.opts["rmd"])
            if key not in recorder.step_ms:
                return None
            total += loadgen.fronts(h, w) * recorder.step_ms[key]
    return total


def lost_launches(made, kernels):
    """{k1, x1, x2, x3: launches the wrappers made that the trace lacks}."""
    seen = devtrace.port_counts(kernels, PORT_KERNELS)
    return {k: made[k] - seen[p]
            for k, p in zip(("k1", "x1", "x2", "x3"), PORT_KERNELS)
            if made[k] > seen[p]}


def release(run):
    """the slice runners and their captured graphs."""
    from hevce_tpu_torch.utils import graphs
    run.program.wavefront._slice_runner_cache.cache_clear()
    graphs.CAPTURED.clear()


def reference(run, images):
    from benchmark.reference import search
    return search.encode_recon(images, run.opts["qpd6"], run.opts["rmd"],
                               run.device)
