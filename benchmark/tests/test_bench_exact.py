"""The lockstep engine's cell on the CPU: the plain exact reference
(reference/exact.py) against the port's native engine byte for byte, its
imports, drivers/lockstep.py driven through the harness on a tiny
configuration, a corrupted stream coming out not correct, and the two
lower-precision controls at 32x32."""
import ast
import pathlib
import time

import numpy as np
import pytest
import torch

from benchmark import check, harness, synth
from benchmark.reference import exact, xform
from benchmark.tests import helpers

HERE = pathlib.Path(__file__).resolve().parent
REFERENCE = HERE.parent / "reference"
LOCKSTEP_CONFIG = dict(helpers.TINY_CONFIG, driver="lockstep", qpd6=2,
                       node_rates=False, batch=2,
                       images=[{"h": 40, "w": 64, "count": 2,
                                "sigma_offset": 0}])
SPAN_READERS = ("arbiter_ms_per_step.lockstep", "enqueue_ms_per_step.lockstep",
                "card_wait_ms_per_step.lockstep",
                "card_span_idle_pct.lockstep")


@pytest.fixture(autouse=True)
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def image(seed, h, w, sigma=6.0):
    """a synthetic image of h x w, cut from one of at least 40 x 40 (the
    least that synth.synth_image makes)."""
    im = synth.synth_image(np.random.default_rng(seed), max(h, 40),
                           max(w, 40), sigma)
    return np.ascontiguousarray(im[:h, :w])


@pytest.mark.parametrize("qpd6,h,w", [(0, 32, 32), (1, 32, 32), (2, 32, 32),
                                      (3, 32, 32), (4, 32, 32),
                                      (2, 40, 72)])
def test_exact_equals_the_native_engine(qpd6, h, w):
    from hevce_tpu_torch.runtime import native
    img = image(100 + qpd6 + h, h, w)
    [(stream, recon)] = exact.encode_streams([img], qpd6, "cpu")
    want_stream, want_recon = native.encode_image_native(img, qpd6)
    assert stream == want_stream
    assert np.array_equal(recon, want_recon)


def _imports(path):
    tree = ast.parse(path.read_text())
    for n in ast.walk(tree):
        if isinstance(n, ast.Import):
            yield from (a.name for a in n.names)
        elif isinstance(n, ast.ImportFrom):
            yield n.module or ""
            if n.module == "benchmark.reference":
                yield from (f"benchmark.reference.{a.name}"
                            for a in n.names)


def test_exact_imports_nothing_of_the_port_or_jax():
    """exact.py and every reference module it reaches import no module of
    the port, of the JAX package or of JAX."""
    seen, todo = set(), ["benchmark.reference.exact"]
    while todo:
        mod = todo.pop()
        if mod in seen:
            continue
        seen.add(mod)
        for name in _imports(REFERENCE / (mod.rsplit(".", 1)[1] + ".py")):
            top = name.split(".")[0]
            assert top not in ("hevce_tpu_torch", "hevce_tpu", "jax",
                               "jaxlib"), (mod, name)
            if name.startswith("benchmark.reference."):
                todo.append(name)
    assert "benchmark.reference.node" in seen


def drive(tmp, monkeypatch, count=2):
    """harness.drive of the tiny lockstep cell of `count` images on the CPU
    (one call in the window): (result, the Run, the Bench)."""
    seen = {}
    check_ = harness.Run.check

    def keep(run):
        seen["run"] = run
        return check_(run)
    monkeypatch.setattr(harness.Run, "check", keep)
    config = dict(LOCKSTEP_CONFIG, images=[
        dict(LOCKSTEP_CONFIG["images"][0], count=count)])
    helpers.tiny_bench(tmp, config=config)
    b = harness.Bench(root=tmp, bench_dir=tmp / "bench")
    out = harness.drive(b, "tiny.pool", 2 ** 33 + 5, 0.0, 0,
                        time.perf_counter(), device="cpu")
    return out, seen["run"], b


def test_lockstep_driver_through_the_harness(tmp_path, monkeypatch):
    out, r, b = drive(tmp_path, monkeypatch)
    assert pathlib.Path(r.driver.__file__) == (tmp_path / "bench" /
                                               "drivers" / "lockstep.py")
    assert out["correct"] is True, out["compared"]
    assert all(v["value"] == 0 for v in out["compared"].values())
    w = r.readings["window"]
    assert w["calls"] == 1 and w["images"] == 2
    assert (w["ctus"], w["ctu_steps"], w["events"]) == (8, 4, 4 * 85)
    assert {"mps", "setup_s"} <= set(out["metrics"])
    values = {m: b.reader("layer_metrics", m)(r.readings)
              for m in SPAN_READERS}
    for m in SPAN_READERS[:3]:            # host spans: read on the CPU too
        assert values[m] > 0, m
    assert values["card_span_idle_pct.lockstep"] is None   # no card
    for cached in (r.program.lockstep._node_program,
                   r.program.lockstep._pu_program):
        assert cached.cache_info().currsize == 0


def test_a_corrupted_stream_is_not_correct(tmp_path, monkeypatch):
    encode = harness.Run.encode

    def corrupt(run, idx, timer):
        out = encode(run, idx, timer)
        s = bytearray(out[0])
        s[len(s) // 2] ^= 0x5A
        out[0] = bytes(s)
        return out
    monkeypatch.setattr(harness.Run, "encode", corrupt)
    out, _, _ = drive(tmp_path, monkeypatch, count=1)
    assert out["correct"] is False
    assert (out["compared"]["recon_mismatch_px"]["value"] > 0
            or out["compared"]["undecodable"]["value"] > 0)


@pytest.mark.parametrize("control", ["int16", "initial_contexts"])
def test_lower_precision_control_is_not_correct(control):
    img = image(7, 32, 32, sigma=30.0)
    want = exact.encode_recon([img], 2, "cpu")
    knob = (exact.transform_dtype(torch.int16) if control == "int16"
            else exact.initial_context_rates())
    with knob:
        got = exact.encode_recon([img], 2, "cpu")
    readings, _ = check.run([img], {0: [0]}, [0], lambda _: want, 0, [0],
                            decode=lambda i: (got[i], None))
    assert readings["recon_mismatch_px"] > 0
    assert not check.verdict(readings)
    assert xform.DTYPE == torch.float64 and exact.LIVE_CONTEXTS
