"""card_ms_per_step.lockstep: the card's busy milliseconds (the union of its
operations' intervals in the profiled stretch) per CTU step of the
lockstep engine there."""


def read(readings):
    t = readings["trace"]
    if not t or not t.get("ctu_steps") or t["busy_s"] <= 0:
        return None
    return 1e3 * t["busy_s"] / t["ctu_steps"]
