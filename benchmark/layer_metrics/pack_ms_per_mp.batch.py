"""pack_ms_per_mp.batch: milliseconds of the fast mode's host pack
(encode_many_fast's PhaseTimer "pack" phase: runtime/native's CABAC pack of
each image) per source megapixel, over the window."""


def read(readings):
    w = readings["window"]
    pack = w["phases"].get("pack")
    return 1e3 * pack / (w["pixels"] / 1e6) if pack and w["pixels"] else None
