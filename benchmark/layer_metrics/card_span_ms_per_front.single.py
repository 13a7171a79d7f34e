"""card_span_ms_per_front.single: the card's milliseconds of the window's
batches per front step, untraced: each batch's time from a CUDA event
before its uploads to the one after its records' copy to the host, summed
by the program into its timer's "card" total when the batch is fetched."""


def read(readings):
    w = readings["window"]
    t = w["phases"].get("card")
    return 1e3 * t / w["fronts"] if t and w["fronts"] else None
