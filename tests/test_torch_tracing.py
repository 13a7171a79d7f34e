"""The port's PhaseTimer (utils/tracing): nested phases, spans with their
parents and tags on the profiler's clock, self times; and the benchmark's
readers of the fast mode's spans and card total, on made-up readings. No
encode runs here (tests/test_torch_batch.py holds the span tree of a CPU
encode_many_fast call).
"""
import importlib.util
import pathlib
import time

import pytest

from hevce_tpu_torch.utils.tracing import CARD, PhaseTimer

READERS = (pathlib.Path(__file__).resolve().parent.parent / "benchmark"
           / "layer_metrics")


def _nested(timer):
    """a: (b, c: (d)), then e; each with a tag of its own letter's batch."""
    timer.tag = 1
    with timer.phase("a"):
        with timer.phase("b"):
            time.sleep(0.002)
        with timer.phase("c"):
            timer.tag = 2
            with timer.phase("d"):
                time.sleep(0.002)
    with timer.phase("e"):
        pass


def test_spans_keep_parents_tags_and_the_profilers_clock():
    t0 = time.time_ns()
    timer = PhaseTimer(spans=[])
    _nested(timer)
    t1 = time.time_ns()
    spans = timer.spans
    assert [(s[0], s[3], s[4]) for s in spans] == [
        ("a", None, 1), ("b", 0, 1), ("c", 0, 1), ("d", 2, 2), ("e", None, 2)]
    for name, start, end, parent, _ in spans:
        assert t0 <= start <= end <= t1, name
        if parent is not None:               # children inside their parents
            assert spans[parent][1] <= start and end <= spans[parent][2]
    assert spans[1][2] <= spans[2][1]        # siblings in order
    assert spans[1][2] - spans[1][1] >= 2e6  # b slept 2 ms


@pytest.mark.parametrize("spans", [None, []])
def test_totals_and_counts_with_or_without_spans(spans):
    timer = PhaseTimer(spans=spans)
    for _ in range(3):
        _nested(timer)
    assert dict(timer.counts) == {"a": 3, "b": 3, "c": 3, "d": 3, "e": 3}
    assert timer.totals["a"] >= timer.totals["b"] + timer.totals["c"]
    assert timer.totals["c"] >= timer.totals["d"] >= 0.006
    assert (timer.spans is None) if spans is None else len(spans) == 15


def test_report_gives_each_phase_its_self_time():
    timer = PhaseTimer()
    _nested(timer)
    timer.totals[CARD] += 5.0                # card seconds: not a host phase
    timer.counts[CARD] += 1
    own = timer.self_times()
    tot = timer.totals
    assert own["a"] == pytest.approx(tot["a"] - tot["b"] - tot["c"])
    assert own["c"] == pytest.approx(tot["c"] - tot["d"])
    assert own["b"] == tot["b"] and own["d"] == tot["d"]
    assert own[CARD] == 5.0
    assert sum(v for n, v in own.items() if n != CARD) == pytest.approx(
        tot["a"] + tot["e"])                 # nothing counted twice
    lines = timer.report().splitlines()
    assert lines[0].split()[:3] == [CARD, "5.000s", "card"]
    shares = [float(ln.split()[2].rstrip("%")) for ln in lines[1:]]
    assert sum(shares) == pytest.approx(100.0, abs=0.5)


def test_a_phase_that_raises_is_closed_and_counted():
    timer = PhaseTimer(spans=[])
    with pytest.raises(KeyError):
        with timer.phase("outer"):
            with timer.phase("inner"):
                raise KeyError("x")
    with timer.phase("after"):
        pass
    assert [(s[0], s[3]) for s in timer.spans] == [
        ("outer", None), ("inner", 0), ("after", None)]
    assert all(s[2] is not None for s in timer.spans)
    assert timer.counts["outer"] == timer.counts["inner"] == 1


def _reader(name):
    path = READERS / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "reader_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


# a window of 10 s, 2 MP of source pixels and 500 front steps
PHASES = {"dispatch": 1.5, "prices": 0.04, "upload": 1.0, "enqueue": 0.05,
          "card": 6.0, "pack": 0.9}


@pytest.mark.parametrize("name,want", [
    ("prices_ms_per_mp.batch", 20.0),
    ("upload_ms_per_front.batch", 2.0),
    ("enqueue_ms_per_front.batch", 0.1),
    ("card_span_ms_per_front.batch", 12.0),
    ("card_span_ms_per_front.single", 12.0),
    ("card_span_idle_pct.batch", 40.0),
    ("card_span_idle_pct.single", 40.0)])
def test_span_readers(name, want):
    read = _reader(name)
    window = {"seconds": 10.0, "pixels": 2_000_000, "fronts": 500,
              "phases": dict(PHASES)}
    assert read({"window": window, "trace": None}) == pytest.approx(want)
    phase = "card" if "card" in name else name.split("_")[0]
    del window["phases"][phase]              # a program without the span
    assert read({"window": window, "trace": None}) is None
