"""dispatch_ms_per_front.batch: milliseconds of the fast mode's host
dispatch (the PhaseTimer "dispatch" phase: price prediction, tiling,
uploads and the slice runner's replay calls) per front step, over the
window. The uploads are pageable copies, which wait behind the replays
already queued on the card, so the phase holds that wait too: where a call
queues a second batch behind a first, as album calls do, the metric reads
card time as well as the host's."""


def read(readings):
    w = readings["window"]
    d = w["phases"].get("dispatch")
    return 1e3 * d / w["fronts"] if d and w["fronts"] else None
