"""enqueue_ms_per_front.batch: host milliseconds of the slice runner's call
per front step (_dispatch_batch's "enqueue" phase inside "dispatch": the
runner's load, one graph replay a front, its tail and the start of the copy
to the host), over the window: the host's cost of a replay."""


def read(readings):
    w = readings["window"]
    t = w["phases"].get("enqueue")
    return 1e3 * t / w["fronts"] if t and w["fronts"] else None
