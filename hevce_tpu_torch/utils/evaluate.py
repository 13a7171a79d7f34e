"""Quality / size benchmark against JPEG / JPEG2000 / WEBP at matched SSIM.

The reference's eval harness (HEVCeval.py:119-244): for each image, encode
it with this encoder, measure the reconstruction's SSIM, then bisect the
competitor codec's quality parameter until its SSIM matches, and compare
bits per pixel. The competitor codecs are PIL's (HEVCeval.py:194-229), so
this needs PIL with its JPEG, JPEG2000 and WEBP plugins: a machine without
PIL cannot run it.

Usage: python -m hevce_tpu_torch.utils.evaluate <in-dir> [qpd6]
"""
import io
import pathlib
import sys

import numpy as np

from hevce_tpu_torch.utils.imageio import to_grayscale
from hevce_tpu_torch.utils.metrics import ssim


def _pad32(img):
    """pad to multiples of 32 by edge replication (HEVCeval.py:21-42)."""
    h, w = img.shape
    hp, wp = -(-h // 32) * 32, -(-w // 32) * 32
    return np.pad(img, ((0, hp - h), (0, wp - w)), mode="edge")


def _competitor(img, fmt, quality):
    """encode + decode with PIL; returns (nbytes, decoded), or None where
    PIL cannot write the format."""
    from PIL import Image
    buf = io.BytesIO()
    pil = Image.fromarray(img)
    try:
        if fmt == "JPEG":
            pil.save(buf, "JPEG", quality=quality)
        elif fmt == "WEBP":
            pil.save(buf, "WEBP", quality=quality)
        elif fmt == "JPEG2000":
            pil.save(buf, "JPEG2000", quality_mode="rates",
                     quality_layers=[max(quality, 1.01)])
        else:
            return None
    except (OSError, KeyError, ValueError):   # no encoder for the format
        return None
    nbytes = buf.tell()
    buf.seek(0)
    dec = np.asarray(Image.open(buf).convert("L"), np.uint8)
    return nbytes, dec


def _match_ssim(img, fmt, target_ssim, lo, hi, iters=12):
    """bisect the quality parameter until SSIM matches
    (HEVCeval.py:202-217)."""
    best = None
    for _ in range(iters):
        mid = (lo + hi) / 2
        r = _competitor(img, fmt, mid if fmt == "JPEG2000"
                        else int(round(mid)))
        if r is None:
            return None
        nbytes, dec = r
        s = ssim(img, dec)
        best = (nbytes, s)
        # JPEG / WEBP: higher quality, higher SSIM; J2K rates: the reverse
        if (s < target_ssim) ^ (fmt == "JPEG2000"):
            lo = mid
        else:
            hi = mid
    return best


def evaluate(in_dir, qpd6=3, encode_fn=None, verbose=True):
    """Rows of {file, ssim, bpp, JPEG / JPEG2000 / WEBP: {bpp, ssim}} for
    every readable image in in_dir, and the summary: our size against each
    codec's at equal SSIM, in percent. encode_fn(img, qpd6) -> (stream,
    recon); default the native bit-exact engine
    (runtime/native.encode_image_native)."""
    if encode_fn is None:
        from hevce_tpu_torch.runtime.native import encode_image_native
        encode_fn = encode_image_native
    rows = []
    for f in sorted(pathlib.Path(in_dir).iterdir()):
        try:
            img = _pad32(to_grayscale(f))
        except (OSError, ValueError):          # not an image
            continue
        stream, rcon = encode_fn(img, qpd6)
        s_hevc = ssim(img, rcon)
        bpp_hevc = 8.0 * len(stream) / img.size
        row = {"file": f.name, "ssim": s_hevc, "bpp": bpp_hevc}
        for fmt, lo, hi in (("JPEG", 1, 99), ("JPEG2000", 1.02, 80),
                            ("WEBP", 1, 99)):
            r = _match_ssim(img, fmt, s_hevc, lo, hi)
            if r is not None:
                nbytes, s = r
                row[fmt] = {"bpp": 8.0 * nbytes / img.size, "ssim": s}
        rows.append(row)
        if verbose:
            comps = "  ".join(
                f"{k}: {v['bpp']:.3f}bpp(ssim {v['ssim']:.4f})"
                for k, v in row.items() if isinstance(v, dict))
            print(f"{f.name}: hevc {bpp_hevc:.3f}bpp ssim {s_hevc:.4f} | "
                  f"{comps}", flush=True)
    summary = {}
    for fmt in ("JPEG", "JPEG2000", "WEBP"):
        pairs = [(r["bpp"], r[fmt]["bpp"]) for r in rows if fmt in r]
        if pairs:
            ours = sum(p[0] for p in pairs)
            theirs = sum(p[1] for p in pairs)
            summary[fmt] = 100.0 * (ours - theirs) / theirs
    if verbose:
        for fmt, pct in summary.items():
            print(f"size vs {fmt} at equal SSIM: {pct:+.1f}%")
    return rows, summary


if __name__ == "__main__":
    evaluate(sys.argv[1], int(sys.argv[2]) if len(sys.argv) > 2 else 3)
