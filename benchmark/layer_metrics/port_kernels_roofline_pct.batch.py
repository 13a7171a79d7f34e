"""port_kernels_roofline_pct.batch: the share of their roofline that the
port's kernels K1 and X1-X3 reach in the profiled stretch: the sum of their
calls' bounds (bounds.py, each replay counted from its runner's warm-up
calls) over the sum of their card times, in percent."""


def read(readings):
    t = readings["trace"]
    if not t or t["bound_ms"] is None or t["port_us"] <= 0:
        return None
    return 100.0 * t["bound_ms"] * 1e3 / t["port_us"]
