"""upload_ms_per_front.batch: milliseconds of the fast mode's uploads
(_dispatch_batch's "upload" phase inside "dispatch": the pageable copies of
a batch's tiles and prices to the card, with their wait behind the replays
already queued there) per front step, over the window."""


def read(readings):
    w = readings["window"]
    t = w["phases"].get("upload")
    return 1e3 * t / w["fronts"] if t and w["fronts"] else None
