"""The lower-precision controls, on the card at the cells' own sizes.

The configurations state exact int32 arithmetic. A control is the plain
reference with its transform products below that, put in the program's
place: int16 (the integer type below int32: each stage's sum wraps as a
16-bit accumulator's would) and bfloat16 (a float tensor-core path). Its
reconstructions go through the harness's own comparison (check.run, with
the pictures in place of decoded streams, and check.verdict) against the
exact reference's, on the cell's check sample; each control has to come out
not correct on every seed. Run with
`python -m pytest -m cuda -s benchmark/tests/test_bench_control.py`.
"""
import json

import numpy as np
import pytest
import torch

from benchmark import check, harness, loadgen
from benchmark.reference import search

SEEDS = (2 ** 31 + 7, 2 ** 33 + 19, 5_000_000_017)
CELLS = ("kodak24-q16-rmd.album", "ctcB-q22-dense.batch8")
CONTROLS = (torch.int16, torch.bfloat16)


def control_readings(cell, seed, device="cuda"):
    """{dtype name: the check's readings} of each control on the cell's
    check sample for seed."""
    bench = harness.Bench()
    w = bench.cell(cell)
    cfg, traffic = bench.config(w["config"]), bench.traffic(w["traffic"])
    load = loadgen.Load(cfg, traffic, seed)
    rng = np.random.default_rng([seed, 1])
    everything = range(len(load.pool))
    sample = check.draw_sample(rng, load.pool, everything,
                               int(traffic["check_per_shape"]))
    imgs = [load.pool[i] for i in sample]
    rmd = None if cfg["rmd"] is None else tuple(cfg["rmd"])
    exact = search.encode_recon(imgs, cfg["qpd6"], rmd, device)
    out = {}
    for dtype in CONTROLS:
        with search.transform_dtype(dtype):
            pics = dict(zip(sample, search.encode_recon(
                imgs, cfg["qpd6"], rmd, device)))
        out[str(dtype)] = check.run(
            load.pool, {i: [i] for i in sample}, sample,
            lambda images: exact, 0, sample,
            decode=lambda i: (pics[i], None))[0]
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_at_cell_size(cell, card):
    seen = {str(d): [] for d in CONTROLS}
    for seed in SEEDS:
        for dtype, readings in control_readings(cell, seed).items():
            seen[dtype].append(readings)
    print(json.dumps({"cell": cell, "seeds": SEEDS, "readings": seen}))
    for dtype, runs in seen.items():
        assert not any(check.verdict(r) for r in runs), dtype
