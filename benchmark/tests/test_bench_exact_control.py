"""The lower-precision controls of the lockstep cell, on the card at the
cell's own size.

The configuration states int32 integer arithmetic with exact CABAC rates
from live context states. A control is the plain exact reference with less
than that, put in the program's place: int16 transform sums (each stage's
sum wraps as a 16-bit accumulator's would) and every trial priced from the
slice's initial context states instead of the live ones. Its
reconstructions go through the harness's own comparison (check.run, with
the pictures in place of decoded streams, and check.verdict) against the
exact reference's, on the cell's check sample; each control has to come
out not correct on every seed. Beside them, parity at the cell's size: the
reference's streams equal the lockstep engine's byte for byte. Run with
`python -m pytest -m cuda -s benchmark/tests/test_bench_exact_control.py`.
"""
import json

import numpy as np
import pytest
import torch

from benchmark import check, harness, loadgen
from benchmark.reference import exact

SEEDS = (2 ** 31 + 7, 2 ** 33 + 19, 5_000_000_017)
CELL = "kodak18-q16-exact.album"
CONTROLS = {"int16": lambda: exact.transform_dtype(torch.int16),
            "initial_contexts": exact.initial_context_rates}


def control_readings(seed, device="cuda"):
    """{control: the check's readings} of each control on the cell's check
    sample for seed."""
    bench = harness.Bench()
    w = bench.cell(CELL)
    cfg, traffic = bench.config(w["config"]), bench.traffic(w["traffic"])
    load = loadgen.Load(cfg, traffic, seed)
    rng = np.random.default_rng([seed, 1])
    sample = check.draw_sample(rng, load.pool, range(len(load.pool)),
                               int(traffic["check_per_shape"]))
    imgs = [load.pool[i] for i in sample]
    want = exact.encode_recon(imgs, cfg["qpd6"], device)
    out = {}
    for name, knob in CONTROLS.items():
        with knob():
            pics = dict(zip(sample, exact.encode_recon(imgs, cfg["qpd6"],
                                                       device)))
        out[name] = check.run(load.pool, {i: [i] for i in sample}, sample,
                              lambda images: want, 0, sample,
                              decode=lambda i: (pics[i], None))[0]
    return out


@pytest.mark.cuda
def test_controls_fail_at_cell_size(card):
    seen = {name: [] for name in CONTROLS}
    for seed in SEEDS:
        for name, readings in control_readings(seed).items():
            seen[name].append(readings)
    print(json.dumps({"cell": CELL, "seeds": SEEDS, "readings": seen}))
    for name, runs in seen.items():
        assert all(r["recon_mismatch_px"] > 0 for r in runs), name
        assert not any(check.verdict(r) for r in runs), name


@pytest.mark.cuda
def test_exact_streams_equal_the_lockstep_on_card(card):
    """the check sample of one seed: the reference's streams and
    reconstructions equal those of the lockstep engine, run as the cell
    runs it (the whole pool as one batch)."""
    from hevce_tpu_torch.parallel import lockstep
    bench = harness.Bench()
    w = bench.cell(CELL)
    cfg, traffic = bench.config(w["config"]), bench.traffic(w["traffic"])
    seed = SEEDS[0]
    load = loadgen.Load(cfg, traffic, seed)
    rng = np.random.default_rng([seed, 1])
    sample = check.draw_sample(rng, load.pool, range(len(load.pool)),
                               int(traffic["check_per_shape"]))
    streams, recons = lockstep.encode_batch(
        load.pool, cfg["qpd6"], node_rates=cfg["node_rates"],
        pipeline=False, device="cuda")
    want = exact.encode_streams([load.pool[i] for i in sample], cfg["qpd6"],
                                "cuda")
    for i, (stream, recon) in zip(sample, want):
        assert streams[i] == stream, i
        assert np.array_equal(recons[i], recon), i
