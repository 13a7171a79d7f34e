"""card_idle_pct.single: the share of the profiled stretch in which no
operation ran on the card, in percent."""


def read(readings):
    t = readings["trace"]
    if not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
