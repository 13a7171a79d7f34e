"""The harness on the CPU: every name of BENCHMARK.json resolves, a new
configuration is found as a file alone, a run's last line has the keys the
contract names, and nothing loads JAX or the JAX package."""
import json
import pathlib
import re
import subprocess
import sys
import time

import pytest

from benchmark import harness, loadgen
from benchmark.tests import helpers

ROOT = pathlib.Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def spec():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_contract_keys_and_names():
    s = spec()
    assert set(s) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= s["run_seconds"] <= 51
    for c in s["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("benchmark/")
    for w in s["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in s["end_to_end"] + s["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in s["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25
    cells = {w["name"] for w in s["workloads"]}
    for m in s["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert set(m["workloads"]) <= cells
    assert {c["name"] for c in s["configs"]} == {w["config"]
                                                 for w in s["workloads"]}


@pytest.mark.parametrize("cell", [w["name"] for w in spec()["workloads"]])
def test_every_cell_resolves_by_name(cell):
    b = harness.Bench()
    w = b.cell(cell)
    cfg, traffic = b.config(w["config"]), b.traffic(w["traffic"])
    assert cfg["reduced"] == []
    for kind in ("end_to_end", "per_layer"):
        ms = b.metrics(kind, cell)
        assert ms, (cell, kind)
        for m in ms:
            assert callable(b.reader(harness.READERS[kind], m["name"]))
    names = {m["name"] for m in b.metrics("end_to_end", cell)}
    assert "setup_s" in names and len(names) >= 2
    load = loadgen.Load(dict(cfg, images=[dict(g, count=1) for g in
                                          cfg["images"]]), traffic, 1)
    assert load.fronts(load.warmup_calls()[0]) > 0


def test_fronts_and_batches():
    assert loadgen.fronts(512, 768) == 54
    assert loadgen.fronts(768, 512) == 62
    assert loadgen.fronts(1080, 1920) == 126
    shapes = [(512, 768)] * 18 + [(768, 512)] * 6
    assert sorted(loadgen.batches(shapes, 18)) == [(512, 768, 18),
                                                  (768, 512, 6)]
    assert loadgen.batches([(8, 8)] * 5, 2) == [(8, 8, 2), (8, 8, 2),
                                                (8, 8, 1)]


def test_a_configuration_added_as_a_file_is_found(tmp_path):
    helpers.tiny_bench(tmp_path)
    b = harness.Bench(root=tmp_path, bench_dir=tmp_path / "bench")
    assert b.config("tiny")["qpd6"] == 2
    assert b.traffic("pool")["images_per_call"] == "pool"
    r = harness.Run(b, "tiny.pool", 5, device="cpu")
    assert r.opts == {"qpd6": 2, "rmd": (12, 4)}


def test_a_per_layer_metric_without_workloads_follows_what_it_moves(
        tmp_path):
    helpers.tiny_bench(tmp_path)
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    spec["per_layer"].append({"name": "new_metric", "unit": "ms",
                              "better": "lower", "source": "program_span",
                              "layer": "device", "moves": "mps"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    b = harness.Bench(root=tmp_path, bench_dir=tmp_path / "bench")
    assert "new_metric" in {m["name"] for m in b.metrics("per_layer",
                                                         "tiny.pool")}
    spec["end_to_end"] = [m for m in spec["end_to_end"]
                          if m["name"] != "mps"]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    b = harness.Bench(root=tmp_path, bench_dir=tmp_path / "bench")
    assert "new_metric" not in {m["name"] for m in b.metrics("per_layer",
                                                             "tiny.pool")}


def test_seed_gives_the_same_load():
    cfg = helpers.TINY_CONFIG
    big = 2 ** 31 + 12345
    a = loadgen.Load(cfg, helpers.TINY_TRAFFIC, big)
    b = loadgen.Load(cfg, helpers.TINY_TRAFFIC, big)
    assert all((x == y).all() for x, y in zip(a.pool, b.pool))
    assert [a.next_call() for _ in range(3)] == \
        [b.next_call() for _ in range(3)]
    single = dict(helpers.TINY_TRAFFIC, images_per_call=1, batch=1)
    s = loadgen.Load(cfg, single, 3)
    seen = [s.next_call()[0] for _ in range(6)]
    assert sorted(seen) == [0, 0, 1, 1, 2, 2]


def test_a_run_prints_the_contract_keys(tmp_path):
    helpers.tiny_bench(tmp_path)
    b = harness.Bench(root=tmp_path, bench_dir=tmp_path / "bench")
    out = harness.drive(b, "tiny.pool", 2 ** 31 + 99, 0.5, 0,
                        time.perf_counter(), device="cpu")
    keys = list(out)
    assert set(keys) - {"breakdown"} == {"correct", "attempted", "failed",
                                         "metrics", "device", "compared"}
    assert keys[-1] == "compared"
    assert out["correct"] is True and out["failed"] == 0
    assert set(out["metrics"]) == {"mps", "image_ms_p50", "image_ms_p90",
                                   "setup_s"}
    assert set(out["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    assert all(v["value"] <= v["limit"] for v in out["compared"].values())
    assert harness.loaded_forbidden() == []


def test_nothing_loads_jax_or_the_jax_package():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from benchmark import harness, check, bounds, devtrace\n"
            "from benchmark.reference import search, decoder\n"
            "harness.Bench().driver('fast').import_program()\n"
            "print(harness.loaded_forbidden())" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_the_reference_imports_nothing_of_the_port():
    for p in (ROOT / "benchmark" / "reference").glob("*.py"):
        code = "\n".join(ln for ln in p.read_text().splitlines()
                         if not ln.lstrip().startswith("#"))
        assert not re.search(r"^\s*(from|import)\s+hevce_tpu", code,
                             re.M), p


def test_no_result_without_a_card_or_the_port(tmp_path):
    """run.py in a directory with only BENCHMARK.json and the benchmark's
    files exits non-zero and prints no result (here also for lack of a
    card)."""
    import shutil
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          "kodak24-q16-rmd.album", "--seed", "1",
                          "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300,
                         cwd=tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.cuda
def test_a_cell_runs_on_the_card(card):
    """the album cell, a short window, through run.py."""
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          "kodak24-q16-rmd.album", "--seed", "77",
                          "--seconds", "3", "--trace", "0"],
                         capture_output=True, text=True, timeout=900,
                         cwd=ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True and res["device"]["platform"] == "gpu"
    assert set(res["metrics"]) == {"mps", "setup_s"}
