"""A tiny benchmark in a temporary directory, for driving the harness on the
CPU: its own BENCHMARK.json, configuration and traffic, with the real
drivers and metric readers."""
import json
import pathlib
import shutil

BENCH = pathlib.Path(__file__).resolve().parent.parent

TINY_CONFIG = {
    "name": "tiny", "qpd6": 2, "rmd": [12, 4], "adapt": "pre",
    "records": "lean", "batch": 2, "bit_depth": 8,
    "images": [{"h": 40, "w": 64, "count": 2, "sigma_offset": 0},
               {"h": 64, "w": 40, "count": 1, "sigma_offset": 3}],
    "noise_sigmas": [1.5, 3.0, 6.0, 30.0], "reduced": [], "assumed": [],
    "guarantees": []}
TINY_TRAFFIC = {"images_per_call": "pool", "batch": "config",
                "profile_calls": 1, "check_per_shape": 2}


def tiny_bench(tmp: pathlib.Path, config=None, traffic=None):
    """write a one-cell benchmark ("tiny.pool") under tmp; returns tmp."""
    spec = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    spec["configs"] = [{"name": "tiny", "source": "test",
                        "file": "bench/configs/tiny.json", "reduced": [],
                        "why": "test"}]
    spec["workloads"] = [{"name": "tiny.pool", "config": "tiny",
                          "traffic": "pool", "chips": 1, "why": "test"}]
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            m["workloads"] = ["tiny.pool"]
    (tmp / "bench" / "configs").mkdir(parents=True)
    (tmp / "bench" / "traffic").mkdir()
    for d in ("drivers", "end_to_end", "layer_metrics"):
        shutil.copytree(BENCH / d, tmp / "bench" / d)
    (tmp / "BENCHMARK.json").write_text(json.dumps(spec))
    (tmp / "bench" / "configs" / "tiny.json").write_text(
        json.dumps(config or TINY_CONFIG))
    (tmp / "bench" / "traffic" / "pool.json").write_text(
        json.dumps(traffic or TINY_TRAFFIC))
    return tmp
