"""card_span_idle_pct.single: the share of the window, untraced, in which the
card ran none of its batches, in percent: 100 minus the program's "card"
total (each batch's CUDA-event time, batches one after another on one
stream) over the window's seconds."""


def read(readings):
    w = readings["window"]
    t = w["phases"].get("card")
    if not t or w["seconds"] <= 0:
        return None
    return 100.0 * (1.0 - t / w["seconds"])
