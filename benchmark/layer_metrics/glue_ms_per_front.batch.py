"""glue_ms_per_front.batch: card milliseconds of every kernel of the
profiled stretch that is not one of the port's hand-written kernels (K1,
X1-X3), per front step: the front step's picks, commits and node glue."""


def read(readings):
    t = readings["trace"]
    if not t or not t["fronts"] or t["glue_us"] <= 0:
        return None
    return t["glue_us"] / 1e3 / t["fronts"]
