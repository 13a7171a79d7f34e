"""prices_ms_per_mp.batch: milliseconds of the fast mode's price
prediction (encode_many_fast's "prices" phase: _predict_prices, the pre
pass over each batch's images, outside "dispatch") per source megapixel,
over the window."""


def read(readings):
    w = readings["window"]
    t = w["phases"].get("prices")
    return 1e3 * t / (w["pixels"] / 1e6) if t and w["pixels"] else None
