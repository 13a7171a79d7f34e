"""The benchmark's harness: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
                             --trace <0|1>

Everything is found by name: the cell in BENCHMARK.json, its configuration
at the file that BENCHMARK.json names, the driver of the part of the port it
runs at drivers/<driver>.py (the configuration's "driver", "fast" where it
names none; drivers/fast.py lists what a driver provides), its traffic mix
at traffic/<traffic>.json, each end-to-end metric's reader at
end_to_end/<metric>.py and each per-layer metric's at
layer_metrics/<metric>.py (a module with read(readings) -> number or None;
None leaves the metric out of the line). A new configuration, driver, mix or
metric is a new file and an entry in BENCHMARK.json.

A run: set-up (the port's builds, the pool of images, one warm-up call of
every batch shape the mix makes, which builds what the driven path
captures), then a closed loop of calls for --seconds, then with --trace 1 a
profiled stretch of whole calls, then the correctness check (check.py) of
the streams against the driver's plain reference, and the last line of
standard output: one JSON object. Every call is timed by the port's
utils/tracing.PhaseTimer; the window keeps its phase totals and counts.
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
# the program's own knobs, every variable of this prefix: the configuration
# sets what the cell runs, and nothing from the caller's environment may
# change it
PROGRAM_KNOBS = "HEVCE_"
# the driver of a configuration that names none
DEFAULT_DRIVER = "fast"
FORBIDDEN = ("jax", "jaxlib", "flax", "hevce_tpu")
# the folder of each kind of metric's readers
READERS = {"end_to_end": "end_to_end", "per_layer": "layer_metrics"}


class Fail(Exception):
    """a run that prints no result (exit code 2)."""


# ------------------------------------------------------------------ lookup

class Bench:
    """BENCHMARK.json and the files it names, resolved by name under
    `bench_dir` (the folder that holds configs/, drivers/, traffic/,
    end_to_end/ and layer_metrics/) and `root` (where BENCHMARK.json and the
    configuration files' paths start)."""

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
        return _load(path, f"bench_{kind}_{name}").read

    def driver(self, stem):
        """the module drivers/<stem>.py."""
        path = self.dir / "drivers" / f"{stem}.py"
        if not path.exists():
            raise Fail(f"no driver {path}")
        return _load(path, f"bench_driver_{stem}")

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


# -------------------------------------------------------------------- run

class Run:
    """One run of one cell: set-up, window, stretch, check. The cell's
    driver (drivers/<stem>.py) makes the calls and works out the reference;
    program holds what its import_program() gave."""

    def __init__(self, bench: Bench, cell: str, seed: int, device="cuda"):
        self.seed, self.device = seed, device
        self.cell = bench.cell(cell)
        self.config = bench.config(self.cell["config"])
        self.traffic = bench.traffic(self.cell["traffic"])
        self.driver = bench.driver(self.config.get("driver", DEFAULT_DRIVER))
        self.opts = self.driver.prepare(self.config)
        self.program = None
        self.readings = {"setup_s": None, "window": None, "trace": None}

    # ---- set-up
    def setup(self, recorder=None):
        """the pool, and one warm-up call of every batch shape (builds the
        port's libraries and what the driven path captures); recorder: the
        driver's optional recorder, installed around the warm-up."""
        from benchmark import loadgen
        self.load = loadgen.Load(self.config, self.traffic, self.seed)
        ctx = (recorder.installed() if recorder is not None
               else contextlib.nullcontext())
        with ctx:
            for idx in self.load.warmup_calls():
                self.encode(idx, _timer())
        self.sync()

    def encode(self, idx, timer):
        return self.driver.encode(self, idx, timer)

    def work(self, calls):
        """{name: sum over the calls} of the driver's work(load, idx);
        every name, 0 where there is no call."""
        total = dict(self.driver.work(self.load, []))
        for idx in calls:
            for k, v in self.driver.work(self.load, idx).items():
                total[k] += v
        return total

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
        count in `failed`, and its pixels, work and latency nowhere."""
        timer = _timer()
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
            **self.work([c[0] for c in ok]),
            "latencies_s": [c[2] - c[1] for c in ok],
            "phases": dict(timer.totals), "counts": dict(timer.counts)}

    # ---- traced stretch
    def stretch(self, recorder=None):
        """profile traffic["profile_calls"] whole calls."""
        from benchmark import devtrace
        from hevce_tpu_torch.utils import graphs
        timer = _timer()
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
        t = devtrace.reduce(prof, (w0, w1), timer.spans,
                            self.driver.PORT_KERNELS)
        if t["outside"]:
            print(f"profiled stretch: {t['outside']} card operations lie "
                  f"outside the host's window", file=sys.stderr, flush=True)
        made = {k: m.LAUNCHES - before[k] for k, m in graphs.COUNTERS.items()}
        t["lost_launches"] = self.driver.lost_launches(made, t["kernels"])
        if t["lost_launches"]:
            print(f"profiled stretch lost launches: {t['lost_launches']}",
                  file=sys.stderr, flush=True)
        self.traced_work = self.work(calls)
        t.update(self.traced_work)
        t["calls"] = len(calls)
        t["bound_ms"] = None
        if recorder is not None:
            t["bound_ms"] = self.driver.bound_ms(self, calls, recorder)
        self.readings["trace"] = t

    # ---- check
    def check(self):
        from benchmark import check
        encoded = list(self.streams)
        rng = np.random.default_rng([self.seed, 1])
        sample = check.draw_sample(rng, self.load.pool, encoded,
                                   int(self.traffic["check_per_shape"]))

        def reference(images):
            return self.driver.reference(self, images)
        return check.run(self.load.pool, self.streams, sample, reference,
                         self.failed, self.asked), sample


# ---------------------------------------------------------------- helpers

def _load(path, name):
    """the module at path, loaded under name."""
    spec = importlib.util.spec_from_file_location(name.replace(".", "_"),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _timer():
    """the port's phase timer (utils/tracing.PhaseTimer)."""
    from hevce_tpu_torch.utils.tracing import PhaseTimer
    return PhaseTimer()


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
    for k in [k for k in os.environ if k.startswith(PROGRAM_KNOBS)]:
        del os.environ[k]


def import_port(name):
    """the port's module `name`, from this checkout."""
    try:
        mod = importlib.import_module(name)
    except ImportError as e:
        raise Fail(f"the port is not in this checkout: {e}") from None
    where = pathlib.Path(mod.__file__).resolve()
    if ROOT not in where.parents:
        raise Fail(f"the port was imported from {where}, outside {ROOT}")
    return mod


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
    from benchmark import check

    on_card = device != "cpu"
    r = Run(bench, workload, seed, device)
    r.program = r.driver.import_program()
    recorder = r.driver.recorder(r) if trace else None
    t_setup = time.perf_counter()
    r.setup(recorder)
    r.readings["setup_s"] = time.perf_counter() - t0
    print(f"set-up: {r.readings['setup_s']:.3f} s, of which pool and "
          f"warm-up calls {time.perf_counter() - t_setup:.3f} s",
          file=sys.stderr, flush=True)
    r.window(seconds)
    if trace:
        t_trace = time.perf_counter()
        r.stretch(recorder)
        t = r.readings["trace"]
        work = "".join(f"{v} {k}, " for k, v in r.traced_work.items())
        print(f"traced stretch: {t['calls']} calls, {work}"
              f"{t['kernel_count']} kernels, {t['window_s']:.3f} s; read in "
              f"{time.perf_counter() - t_trace:.3f} s", file=sys.stderr,
              flush=True)
    r.sync()
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    # the program's state is freed before the reference runs on the card
    r.driver.release(r)
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
