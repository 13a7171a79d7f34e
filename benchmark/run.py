"""Run one cell of the benchmark (see harness.py and BENCHMARK.json):

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. The last line of standard output is the run's
result as one JSON object; exit code 2 means no result.
"""
import time

T0 = time.perf_counter()           # set-up is timed from here

import pathlib  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

if __name__ == "__main__":
    from benchmark import harness
    sys.exit(harness.main(sys.argv[1:], T0))
