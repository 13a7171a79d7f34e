"""The comparison that decides `correct`.

After the window, a sample of the pool's images is drawn from the seed:
check_per_shape distinct images of each shape, among those that the window
encoded. For each sampled image:

* every stream that the window returned for it is the same bytes
  (stream_variants: distinct streams beyond the first; the program is
  deterministic, so each decoded stream stands for all of them);
* the stream decodes (the frozen readable-spec decoder,
  reference/decoder.py; undecodable counts those that do not);
* its decoded picture equals, pixel for pixel, the reconstruction that the
  plain reference (reference/search.py) works out from the image alone
  (recon_mismatch_px: the most pixels that differ in one sampled image; a
  stream that does not decode counts every pixel).

failed_requests counts the images of calls that failed: that raised, or
returned another number of streams than they were given images, or no
stream for one of them. unencoded_images counts the pool images that the
window's calls asked for and got no stream for. Each number must be at most
its limit, and every limit is 0: the fast mode's decisions are integer
arithmetic, and the reference computes them exactly (PERF.md gives the
readings). Decoding runs in worker processes while the reference runs on
the card.
"""
import multiprocessing

import numpy as np

WORKERS = 4                      # decoding processes

LIMITS = {"failed_requests": 0, "unencoded_images": 0,
          "stream_variants": 0, "undecodable": 0, "recon_mismatch_px": 0}


def draw_sample(rng, pool, encoded, per_shape: int):
    """sorted pool indices: per_shape distinct images of each shape, drawn
    from rng among `encoded` (the pool indices the window encoded)."""
    by_shape = {}
    for i in sorted(set(encoded)):
        by_shape.setdefault(pool[i].shape, []).append(i)
    out = []
    for shape in sorted(by_shape):
        idx = by_shape[shape]
        k = min(per_shape, len(idx))
        out += [int(i) for i in rng.choice(idx, size=k, replace=False)]
    return sorted(out)


def _decode(stream):
    from benchmark.reference import decoder
    try:
        return decoder.decode(stream), None
    except Exception as e:             # a broken stream: reported, counted
        return None, f"{type(e).__name__}: {e}"


def run(pool, streams_by_image, sample, reference, failed: int = 0,
        asked=(), decode=None):
    """the check's readings {name: value} and notes: streams_by_image maps a
    pool index to the streams the window returned for it; asked holds the
    pool indices the window's calls asked for; reference(images) gives the
    plain reconstructions of a list of images. decode(stream) -> (picture,
    error or None) stands in for the stream decoder where the outputs
    judged are pictures (the lower-precision control)."""
    firsts = [streams_by_image[i][0] for i in sample]
    variants = max((len(set(streams_by_image[i])) - 1 for i in sample),
                   default=0)
    unencoded = len(set(asked) - set(streams_by_image))
    notes = []
    if unencoded:
        notes.append(f"{unencoded} images asked for and never returned")
    if not sample:
        want, decoded = [], []
    elif decode is not None:
        want = reference([pool[i] for i in sample])
        decoded = [decode(s) for s in firsts]
    else:
        ctx = multiprocessing.get_context("spawn")
        procs = ctx.Pool(min(WORKERS, len(firsts)))
        try:
            pending = procs.map_async(_decode, firsts)
            want = reference([pool[i] for i in sample])
            decoded = pending.get(timeout=600)
        finally:
            procs.close()
            procs.join()
    worst, bad = 0, 0
    for i, (got, err), ref in zip(sample, decoded, want):
        if got is None:
            bad += 1
            diff = int(ref.size)
            notes.append(f"image {i}: stream does not decode: {err}")
        elif got.shape != ref.shape:
            diff = int(ref.size)
            notes.append(f"image {i}: decoded {got.shape}, reference "
                         f"{ref.shape}")
        else:
            diff = int(np.count_nonzero(got != ref))
            if diff:
                notes.append(f"image {i}: {diff} pixels differ")
        worst = max(worst, diff)
    return {"failed_requests": failed, "unencoded_images": unencoded,
            "stream_variants": variants, "undecodable": bad,
            "recon_mismatch_px": worst}, notes


def verdict(readings):
    """True when every reading is at most its limit."""
    return all(readings[k] <= LIMITS[k] for k in LIMITS)
