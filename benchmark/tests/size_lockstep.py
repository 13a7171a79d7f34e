"""Size a lockstep cell: one run of the stand-in lockstep driver
(lockstep_standin.py) through harness.drive, in a benchmark written to a
temporary directory, on synthetic images of one shape.

    python3 benchmark/tests/size_lockstep.py --h 256 --w 384 --count 18 \
        --node-rates 0 --seed 7 --seconds 60 --trace 0

Prints one JSON object: the result's line, and the Run's readings (the
window's seconds, calls, work, phase totals and counts; with --trace 1 the
stretch's busy and window seconds, kernel count, top kernels and gaps).
"""
import argparse
import json
import pathlib
import shutil
import sys
import tempfile
import time

T0 = time.perf_counter()
ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--h", type=int, default=256)
    ap.add_argument("--w", type=int, default=384)
    ap.add_argument("--count", type=int, default=18)
    ap.add_argument("--qpd6", type=int, default=2)
    ap.add_argument("--node-rates", type=int, choices=(0, 1), default=0)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--seconds", type=float, default=60)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()

    from benchmark import harness
    from benchmark.tests import helpers
    harness.prepare_env()
    config = dict(helpers.TINY_CONFIG, driver="lockstep", qpd6=a.qpd6,
                  node_rates=bool(a.node_rates), batch=a.count,
                  images=[{"h": a.h, "w": a.w, "count": a.count,
                           "sigma_offset": 0}])
    seen = {}
    check = harness.Run.check

    def keep(run):
        seen["run"] = run
        return check(run)
    harness.Run.check = keep
    with tempfile.TemporaryDirectory() as d:
        tmp = pathlib.Path(d)
        helpers.tiny_bench(tmp, config=config)
        shutil.copy(pathlib.Path(__file__).parent / "lockstep_standin.py",
                    tmp / "bench" / "drivers" / "lockstep.py")
        spec = json.loads((tmp / "BENCHMARK.json").read_text())
        spec["per_layer"] = []          # the fast mode's readers
        (tmp / "BENCHMARK.json").write_text(json.dumps(spec))
        b = harness.Bench(root=tmp, bench_dir=tmp / "bench")
        out = harness.drive(b, "tiny.pool", a.seed, a.seconds, a.trace, T0,
                            device=a.device)
    r = seen["run"]
    w = dict(r.readings["window"])
    lat = w.pop("latencies_s")
    t = r.readings["trace"]
    if t:
        t = {k: t[k] for k in ("window_s", "busy_s", "kernel_count",
                               "device_ops", "idle_gaps", "lost_launches",
                               "calls", "ctus", "ctu_steps")}
    print(json.dumps({"args": vars(a), "result": out,
                      "setup_s": r.readings["setup_s"], "window": w,
                      "call_s": lat, "trace": t}), flush=True)


if __name__ == "__main__":
    main()
