"""A configuration names the driver of the part of the port its cells run
(drivers/<stem>.py; drivers/fast.py where it names none), on the CPU in a
copy of the benchmark under tmp_path: the fast mode through drivers/fast.py,
the lockstep engine through a driver file added beside it (the test-only
stand-in lockstep_standin.py) with no edit to the harness, no result for an
unknown driver, and nothing of JAX loaded with either. Also the card's idle
gaps named from the port's PhaseTimer spans as from the close-ordered spans
the harness kept before."""
import hashlib
import pathlib
import shutil
import subprocess
import sys
import time
from types import SimpleNamespace

import pytest
import torch
from torch.autograd import DeviceType

from benchmark import devtrace, harness
from benchmark.tests import helpers

HERE = pathlib.Path(__file__).resolve().parent
LOCKSTEP_CONFIG = dict(helpers.TINY_CONFIG, driver="lockstep", qpd6=2,
                       node_rates=False, batch=2,
                       images=[{"h": 64, "w": 64, "count": 2,
                                "sigma_offset": 0}])


@pytest.fixture(autouse=True)
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def add_lockstep_driver(tmp):
    shutil.copy(HERE / "lockstep_standin.py",
                tmp / "bench" / "drivers" / "lockstep.py")


def drive(tmp, monkeypatch, seconds=0.0):
    """harness.drive of the tiny cell on the CPU: (result, the Run)."""
    seen = {}
    check = harness.Run.check

    def keep(run):
        seen["run"] = run
        return check(run)
    monkeypatch.setattr(harness.Run, "check", keep)
    b = harness.Bench(root=tmp, bench_dir=tmp / "bench")
    out = harness.drive(b, "tiny.pool", 2 ** 31 + 3, seconds, 0,
                        time.perf_counter(), device="cpu")
    return out, seen["run"]


def test_a_configuration_without_a_driver_runs_the_fast_driver(
        tmp_path, monkeypatch):
    from hevce_tpu_torch.models import wavefront
    helpers.tiny_bench(tmp_path)
    assert "driver" not in helpers.TINY_CONFIG
    wavefront._slice_runner_cache.cache_clear()
    out, r = drive(tmp_path, monkeypatch)
    assert pathlib.Path(r.driver.__file__) == (tmp_path / "bench" /
                                               "drivers" / "fast.py")
    assert out["correct"] is True
    w = r.readings["window"]
    assert w["calls"] == 1 and w["images"] == 3
    assert w["fronts"] == 8 and w["pixels"] == 40 * 64 * 3
    # two images of one shape pack on the pool, the third inline
    assert w["counts"]["pack_pooled"] == 2
    for phase in ("prices", "dispatch", "tile", "upload", "enqueue",
                  "fetch", "verify", "pack"):
        assert w["counts"][phase] >= 1 and w["phases"][phase] > 0, phase
    assert wavefront._slice_runner_cache.cache_info().currsize == 0


def test_a_driver_added_as_a_file_runs_through_the_harness(
        tmp_path, monkeypatch):
    before = hashlib.sha256((HERE.parent / "harness.py").read_bytes())
    helpers.tiny_bench(tmp_path, config=LOCKSTEP_CONFIG)
    add_lockstep_driver(tmp_path)
    out, r = drive(tmp_path, monkeypatch)
    assert pathlib.Path(r.driver.__file__) == (tmp_path / "bench" /
                                               "drivers" / "lockstep.py")
    assert out["correct"] is True, out["compared"]
    assert all(v["value"] == 0 for v in out["compared"].values())
    w = r.readings["window"]
    assert w["images"] == 2 and w["ctus"] == 8 and w["ctu_steps"] == 4
    for phase in ("host_arbiter", "winner_fetch", "writeback"):
        assert w["counts"][phase] > 0, phase
    assert {"mps", "setup_s"} <= set(out["metrics"])
    assert hashlib.sha256((HERE.parent / "harness.py").read_bytes()
                          ).digest() == before.digest()


def test_an_unknown_driver_gives_no_result(tmp_path):
    helpers.tiny_bench(tmp_path, config=dict(helpers.TINY_CONFIG,
                                             driver="no_such_driver"))
    b = harness.Bench(root=tmp_path, bench_dir=tmp_path / "bench")
    with pytest.raises(harness.Fail, match="no_such_driver"):
        harness.drive(b, "tiny.pool", 1, 0.0, 0, time.perf_counter(),
                      device="cpu")


@pytest.mark.parametrize("driver", ["fast", "lockstep"])
def test_either_driver_loads_nothing_forbidden(driver, tmp_path):
    helpers.tiny_bench(tmp_path)
    add_lockstep_driver(tmp_path)
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from benchmark import harness\n"
            "b = harness.Bench(root=%r, bench_dir=%r)\n"
            "b.driver(%r).import_program()\n"
            "print(harness.loaded_forbidden())"
            % (str(HERE.parents[1]), str(tmp_path), str(tmp_path / "bench"),
               driver))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


# spans of one batch (name, start, end, parent, tag) as a PhaseTimer keeps
# them, in the order they opened, and the same as the harness's own timer
# kept them before: (name, start, end), in the order they closed
SPANS = [("dispatch", 0, 100, None, 1), ("tile", 0, 10, 0, 1),
         ("upload", 10, 60, 0, 1), ("enqueue", 60, 100, 0, 1),
         ("pack", 120, 200, None, 1)]
CLOSED = [("tile", 0, 10), ("upload", 10, 60), ("enqueue", 60, 100),
          ("dispatch", 0, 100), ("pack", 120, 200)]


@pytest.mark.parametrize("gap,name", [
    ((20, 50), "upload"), ((5, 30), "dispatch"), ((100, 120), "host"),
    ((90, 140), "pack"), ((60, 100), "enqueue"), ((2, 8), "tile")])
def test_gaps_are_named_as_before(gap, name):
    assert devtrace._label(*gap, devtrace._close_order(SPANS)) == name
    assert devtrace._label(*gap, CLOSED) == name


def test_reduce_reads_phase_timer_spans():
    from hevce_tpu_torch.utils.tracing import PhaseTimer

    def event(name, start, end):
        return SimpleNamespace(device_type=lambda: DeviceType.CUDA,
                               name=lambda: name, start_ns=lambda: start,
                               duration_ns=lambda: end - start)
    events = [event("k1_kernel_tc", 60, 80), event("void glue<3>", 80, 100),
              event("Memcpy HtoD", 10, 20)]
    prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))
    t = devtrace.reduce(prof, (0, 200), SPANS, ("k1_kernel",))
    assert t["busy_s"] == 50 / 1e9 and t["port_us"] == 0.02
    assert t["glue_us"] == 0.02 and t["kernel_count"] == 2
    assert [g[0] for g in t["idle_gaps"]] == ["pack", "upload", "tile"]
    timer = PhaseTimer(spans=[])
    with timer.phase("dispatch"):
        with timer.phase("upload"):
            pass
    assert [s[0] for s in devtrace._close_order(timer.spans)] == [
        "upload", "dispatch"]
