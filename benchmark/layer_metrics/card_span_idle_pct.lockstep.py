"""card_span_idle_pct.lockstep: the share of the untraced window that lies
outside the card spans of the lockstep engine's events, in percent: 100
minus the program's "card" total over the window's seconds. An event's span
runs from a CUDA timing event after its rows' load (a full fetch: before
its copies) to one after its results' copies, events one after another on
one stream, so it holds the card's work and the launch between them. None
where the program keeps no such total (the CPU, or a program without it)."""


def read(readings):
    w = readings["window"]
    t = w["phases"].get("card")
    if not t or w["seconds"] <= 0:
        return None
    return 100.0 * (1.0 - t / w["seconds"])
