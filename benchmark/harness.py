"""The benchmark's harness: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
                             --trace <0|1>

Everything is found by name: the cell in BENCHMARK.json, its configuration
at the file that BENCHMARK.json names, its traffic mix at
traffic/<traffic>.json, each end-to-end metric's reader at
end_to_end/<metric>.py and each per-layer metric's at
layer_metrics/<metric>.py (a module with read(readings) -> number or None;
None leaves the metric out of the line). A new configuration, mix or metric
is a new file and an entry in BENCHMARK.json.

A run: set-up (the port's builds, the pool of images, one warm-up call of
every batch shape the mix makes, which captures the slice runners), then a
closed loop of calls for --seconds, then with --trace 1 a profiled stretch
of whole calls, then the correctness check (check.py), and the last line of
standard output: one JSON object.
"""
import argparse
import collections
import contextlib
import gc
import importlib.util
import json
import math
import os
import pathlib
import sys
import time

import numpy as np

BENCH = pathlib.Path(__file__).resolve().parent
ROOT = BENCH.parent
# the program's own knobs: the configuration sets what the cell runs, and
# nothing from the caller's environment may change it
PROGRAM_KNOBS = ("HEVCE_ADAPT", "HEVCE_RMD", "HEVCE_CTX_BIT",
                 "HEVCE_SIG_ZERO", "HEVCE_ASYNC_FETCH")
FORBIDDEN = ("jax", "jaxlib", "flax", "hevce_tpu")
# the folder of each kind of metric's readers
READERS = {"end_to_end": "end_to_end", "per_layer": "layer_metrics"}


class Fail(Exception):
    """a run that prints no result (exit code 2)."""


# ------------------------------------------------------------------ lookup

class Bench:
    """BENCHMARK.json and the files it names, resolved by name under
    `bench_dir` (the folder that holds configs/, traffic/, end_to_end/ and
    layer_metrics/) and `root` (where BENCHMARK.json and the configuration
    files' paths start)."""

    def __init__(self, root=ROOT, bench_dir=BENCH):
        self.root, self.dir = pathlib.Path(root), pathlib.Path(bench_dir)
        self.spec = json.loads((self.root / "BENCHMARK.json").read_text())

    def cell(self, name):
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise Fail(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name):
        for c in self.spec["configs"]:
            if c["name"] == name:
                return json.loads((self.root / c["file"]).read_text())
        raise Fail(f"no configuration {name!r} in BENCHMARK.json")

    def traffic(self, name):
        path = self.dir / "traffic" / f"{name}.json"
        if not path.exists():
            raise Fail(f"no traffic mix {path}")
        return json.loads(path.read_text())

    def reader(self, kind, name):
        """read() of <kind>/<name>.py."""
        path = self.dir / kind / f"{name}.py"
        if not path.exists():
            raise Fail(f"no reader {path} for metric {name!r}")
        spec = importlib.util.spec_from_file_location(
            f"bench_{kind}_{name}".replace(".", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read

    def metrics(self, kind, cell):
        """the metric entries of `kind` ("end_to_end" or "per_layer") that
        this cell reports."""
        e2e = [m for m in self.spec["end_to_end"]
               if "workloads" not in m or cell in m["workloads"]]
        if kind == "end_to_end":
            return e2e
        # an entry without "workloads" is reported in every cell that
        # reports the end-to-end metric it moves (the contract lets a
        # later PR add one so)
        names = {m["name"] for m in e2e}
        return [m for m in self.spec["per_layer"]
                if (cell in m["workloads"] if "workloads" in m
                    else m["moves"] in names)]


# -------------------------------------------------------------- the timer

class SpanTimer:
    """encode_many_fast's timer (the port's PhaseTimer interface: phase(),
    totals, counts): wall seconds a phase; while `spans` is a list, each
    phase is also kept there as (name, start ns, end ns) on the clock of
    time.time_ns(), the profiler's clock, to name the card's idle gaps."""

    def __init__(self):
        self.totals = collections.defaultdict(float)
        self.counts = collections.defaultdict(int)
        self.spans = None

    @contextlib.contextmanager
    def phase(self, name):
        t0, n0 = time.perf_counter(), time.time_ns()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1
            if self.spans is not None:
                self.spans.append((name, n0, time.time_ns()))


# -------------------------------------------------------------------- run

class Run:
    """One run of one cell: set-up, window, stretch, check."""

    def __init__(self, bench: Bench, cell: str, seed: int, device="cuda"):
        self.seed, self.device = seed, device
        self.cell = bench.cell(cell)
        self.config = bench.config(self.cell["config"])
        self.traffic = bench.traffic(self.cell["traffic"])
        self.qpd6 = int(self.config["qpd6"])
        rmd = self.config["rmd"]
        self.rmd = None if rmd is None else tuple(rmd)
        if self.config["adapt"] != "pre" or self.config["records"] != "lean":
            raise Fail("the reference works out HEVCE_ADAPT=pre with lean "
                       "records only")
        os.environ["HEVCE_ADAPT"] = self.config["adapt"]
        self.readings = {"setup_s": None, "window": None, "trace": None}

    # ---- set-up
    def setup(self, wavefront, record=None):
        """the pool, and one warm-up call of every batch shape (builds the
        port's libraries and captures its slice runners); record: an
        optional bounds.Recorder installed around the warm-up."""
        from benchmark import loadgen
        self.wf = wavefront
        self.load = loadgen.Load(self.config, self.traffic, self.seed)
        ctx = record() if record is not None else contextlib.nullcontext()
        with ctx:
            for idx in self.load.warmup_calls():
                self.encode(idx, SpanTimer())
        self.sync()

    def encode(self, idx, timer):
        streams, _ = self.wf.encode_many_fast(
            [self.load.pool[i] for i in idx], self.qpd6,
            batch=self.load.batch, timer=timer, want_recon=False,
            rmd=self.rmd, device=self.device)
        return streams

    def sync(self):
        if self.device != "cpu":
            import torch
            torch.cuda.synchronize()

    # ---- window
    def window(self, seconds: float):
        """closed loop: the next call as soon as one returns, until
        `seconds` have passed; the window ends with the last call. A call
        that raises, or returns another number of streams than it was
        given images, or no stream for one of them, is failed: its images
        count in `failed`, and its pixels, fronts and latency nowhere."""
        timer = SpanTimer()
        calls, streams = [], collections.defaultdict(list)
        failed, asked = 0, set()
        t0 = time.perf_counter()
        while True:
            idx = self.load.next_call()
            asked.update(idx)
            ts = time.perf_counter()
            try:
                out = self.encode(idx, timer)
            except Exception as e:        # a failed request is counted
                print(f"call failed: {type(e).__name__}: {e}",
                      file=sys.stderr, flush=True)
                out = None
            te = time.perf_counter()
            if out is not None and (len(out) != len(idx)
                                    or any(s is None for s in out)):
                print(f"call failed: {sum(s is not None for s in out)} "
                      f"streams for {len(idx)} images", file=sys.stderr,
                      flush=True)
                out = None
            if out is None:
                failed += len(idx)
            else:
                for i, s in zip(idx, out):
                    streams[i].append(bytes(s))
            calls.append((idx, ts, te, out is not None))
            if te - t0 >= seconds:
                break
        ok = [c for c in calls if c[3]]
        self.streams, self.failed, self.asked = streams, failed, asked
        self.readings["window"] = {
            "seconds": calls[-1][2] - t0, "calls": len(calls),
            "images": sum(len(c[0]) for c in calls),
            "pixels": sum(self.load.pixels(c[0]) for c in ok),
            "fronts": sum(self.load.fronts(c[0]) for c in ok),
            "latencies_s": [c[2] - c[1] for c in ok],
            "phases": dict(timer.totals)}

    # ---- traced stretch
    def stretch(self, recorder=None):
        """profile traffic["profile_calls"] whole calls."""
        from benchmark import devtrace
        from hevce_tpu_torch.utils import graphs
        timer = SpanTimer()
        calls = [self.load.next_call()
                 for _ in range(int(self.traffic["profile_calls"]))]
        before = {k: m.LAUNCHES for k, m in graphs.COUNTERS.items()}
        self.sync()
        timer.spans = []
        with devtrace.session() as prof:
            w0 = time.time_ns()
            for idx in calls:
                self.encode(idx, timer)
            self.sync()
            w1 = time.time_ns()
        t = devtrace.reduce(prof, (w0, w1), timer.spans)
        if t["outside"]:
            print(f"profiled stretch: {t['outside']} card operations lie "
                  f"outside the host's window", file=sys.stderr, flush=True)
        made = {k: m.LAUNCHES - before[k] for k, m in graphs.COUNTERS.items()}
        seen = devtrace.port_counts(t["kernels"])
        t["lost_launches"] = {
            k: made[k] - seen[p] for k, p in zip(
                ("k1", "x1", "x2", "x3"), devtrace.PORT_KERNELS)
            if made[k] > seen[p]}
        if t["lost_launches"]:
            print(f"profiled stretch lost launches: {t['lost_launches']}",
                  file=sys.stderr, flush=True)
        t["fronts"] = sum(self.load.fronts(c) for c in calls)
        t["calls"] = len(calls)
        t["bound_ms"] = None
        if recorder is not None:
            t["bound_ms"] = self.bound_ms(calls, recorder)
        self.readings["trace"] = t

    def bound_ms(self, calls, recorder):
        """the port's kernels' bound over the calls' replays: a batch of
        key (qpd6, R, Cc, B, rmd) replays D front steps, each bounded by
        its warm-up step's calls; None if a key was not recorded."""
        from benchmark import loadgen
        total = 0.0
        for idx in calls:
            for h, w, B in self.load.shape_batches(idx):
                key = (self.qpd6, -(-h // 32), -(-w // 32), B, self.rmd)
                if key not in recorder.step_ms:
                    return None
                total += loadgen.fronts(h, w) * recorder.step_ms[key]
        return total

    # ---- check
    def check(self):
        from benchmark import check
        from benchmark.reference import search
        encoded = list(self.streams)
        rng = np.random.default_rng([self.seed, 1])
        sample = check.draw_sample(rng, self.load.pool, encoded,
                                   int(self.traffic["check_per_shape"]))

        def reference(images):
            return search.encode_recon(images, self.qpd6, self.rmd,
                                       self.device)
        return check.run(self.load.pool, self.streams, sample, reference,
                         self.failed, self.asked), sample


# ---------------------------------------------------------------- helpers

def loaded_forbidden():
    """top-level names in sys.modules that no run may load."""
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def percentile(values, q):
    """nearest-rank q-th percentile of values."""
    s = sorted(values)
    return s[max(0, math.ceil(q / 100 * len(s)) - 1)]


def prepare_env():
    """the program's knobs cleared: the configuration sets the cell."""
    for k in PROGRAM_KNOBS:
        os.environ.pop(k, None)


def import_port():
    """the port's fast mode (models/wavefront), from this checkout."""
    try:
        from hevce_tpu_torch.models import wavefront
    except ImportError as e:
        raise Fail(f"the port is not in this checkout: {e}") from None
    where = pathlib.Path(wavefront.__file__).resolve()
    if ROOT not in where.parents:
        raise Fail(f"the port was imported from {where}, outside {ROOT}")
    return wavefront


def main(argv, t0):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    try:
        result = run(a, t0)
    except Fail as e:
        print(f"benchmark: {e}", file=sys.stderr, flush=True)
        return 2
    print(json.dumps(result), flush=True)
    return 0


def run(a, t0):
    """the chip's look, then drive()."""
    prepare_env()
    bench = Bench()
    cell = bench.cell(a.workload)
    import torch
    if not torch.cuda.is_available():
        raise Fail("CUDA is not available")
    if torch.cuda.device_count() < int(cell["chips"]):
        raise Fail(f"the cell needs {cell['chips']} cards, "
                   f"{torch.cuda.device_count()} present")
    return drive(bench, a.workload, a.seed, a.seconds, a.trace, t0)


def drive(bench, workload, seed, seconds, trace, t0, device="cuda"):
    """one run of the cell after the chip's look: set-up, window, traced
    stretch (trace 1), the check; returns the result's JSON object. The
    tests drive it on the CPU (device="cpu", trace 0)."""
    import torch
    wavefront = import_port()
    from benchmark import bounds, check
    from hevce_tpu_torch.ops import fused_eval, fused_node
    from hevce_tpu_torch.utils import graphs

    on_card = device != "cpu"
    r = Run(bench, workload, seed, device)
    recorder = bounds.Recorder() if trace else None
    record = None
    if recorder is not None:
        record = lambda: recorder.installed(                    # noqa: E731
            {"fused_eval": fused_eval, "fused_node": fused_node},
            wavefront._SliceRunner)
    t_setup = time.perf_counter()
    r.setup(wavefront, record)
    r.readings["setup_s"] = time.perf_counter() - t0
    print(f"set-up: {r.readings['setup_s']:.3f} s, of which pool and "
          f"warm-up calls {time.perf_counter() - t_setup:.3f} s",
          file=sys.stderr, flush=True)
    r.window(seconds)
    if trace:
        t_trace = time.perf_counter()
        r.stretch(recorder)
        t = r.readings["trace"]
        print(f"traced stretch: {t['calls']} calls, {t['fronts']} fronts, "
              f"{t['kernel_count']} kernels, {t['window_s']:.3f} s; read in "
              f"{time.perf_counter() - t_trace:.3f} s", file=sys.stderr,
              flush=True)
    r.sync()
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    # the program's state is freed before the reference runs on the card
    wavefront._slice_runner_cache.cache_clear()
    graphs.CAPTURED.clear()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in bench.metrics(kind, workload):
        v = bench.reader(READERS[kind], m["name"])(r.readings)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    t_check = time.perf_counter()
    (readings, notes), sample = r.check()
    print(f"check: {time.perf_counter() - t_check:.3f} s", file=sys.stderr)
    correct = check.verdict(readings)
    bad = loaded_forbidden()
    if bad:
        raise Fail(f"modules loaded that no run may load: {bad}")
    w = r.readings["window"]
    lat = w["latencies_s"]
    print(f"requests in the window: {w['images']} images in {w['calls']} "
          f"calls, {w['seconds']:.3f} s (of them returned "
          f"{len(lat)}: the first {[round(x, 4) for x in lat[:3]]} s, the "
          f"median {percentile(lat, 50) if lat else None} s); checked pool "
          f"images {sample}", file=sys.stderr)
    for n in notes:
        print(f"check: {n}", file=sys.stderr)
    for k, v in readings.items():
        print(f"compared {k}: {v} (limit {check.LIMITS[k]})",
              file=sys.stderr, flush=True)
    device_out = {"platform": "gpu" if on_card else "cpu",
                  "kind": torch.cuda.get_device_name(0) if on_card
                  else "cpu",
                  "count": int(r.cell["chips"]) if on_card else 0,
                  "memory_peak_bytes": int(peak)}
    out = {"correct": bool(correct), "attempted": w["images"],
           "failed": r.failed, "metrics": metrics, "device": device_out}
    if trace:
        t = r.readings["trace"]
        device_out["busy_s"] = t["busy_s"]
        device_out["window_s"] = t["window_s"]
        out["breakdown"] = {"device_ops": t["device_ops"],
                            "idle_gaps": t["idle_gaps"]}
    out["compared"] = {k: {"value": v, "limit": check.LIMITS[k]}
                       for k, v in readings.items()}
    return out
