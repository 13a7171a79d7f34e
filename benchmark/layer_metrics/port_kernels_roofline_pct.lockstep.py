"""port_kernels_roofline_pct.lockstep: the share of their roofline that the
lockstep engine's kernels K1, X1 and K2 reach in the profiled stretch: the
sum of their calls' bounds (bounds_lockstep.py, each event program's
replay counted from its warm-up calls, K2 with none of its ops) over the
sum of their card times, in percent."""


def read(readings):
    t = readings["trace"]
    if not t or t["bound_ms"] is None or t["port_us"] <= 0:
        return None
    return 100.0 * t["bound_ms"] * 1e3 / t["port_us"]
