"""card_ms_per_front.batch: the card's busy milliseconds (the union of its
operations' intervals in the profiled stretch) per front step replayed
there."""


def read(readings):
    t = readings["trace"]
    if not t or not t["fronts"] or t["busy_s"] <= 0:
        return None
    return 1e3 * t["busy_s"] / t["fronts"]
