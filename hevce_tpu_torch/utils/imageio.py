"""Image I/O: PGM (P5) read / write in numpy, as the reference CLI's
loadPGMfile / writePGMfile (reference src/HEVCeMain.c:9-90), and any
PIL-readable image as 8-bit grayscale (PIL is imported only for input that
is not PGM).
"""
import pathlib
import re

import numpy as np


def read_pgm(path) -> np.ndarray:
    """Read a binary PGM (P5, maxval <= 255) as (h, w) uint8."""
    data = pathlib.Path(path).read_bytes()
    if not data.startswith(b"P5"):
        raise ValueError(f"{path}: not a binary PGM (P5) file")
    # header: magic, width, height, maxval — whitespace/comment separated
    tokens = []
    pos = 2
    while len(tokens) < 3:
        m = re.match(rb"(?:\s+|#[^\n]*\n)*(\d+)", data[pos:])
        if not m:
            raise ValueError(f"{path}: malformed PGM header")
        tokens.append(int(m.group(1)))
        pos += m.end()
    w, h, maxval = tokens
    if maxval > 255:
        raise ValueError(f"{path}: 16-bit PGM not supported (maxval={maxval})")
    pos += 1  # single whitespace after maxval
    px = np.frombuffer(data[pos:pos + w * h], np.uint8)
    if px.size != w * h:
        raise ValueError(f"{path}: truncated pixel data")
    return px.reshape(h, w).copy()


def write_pgm(path, img: np.ndarray) -> None:
    if img.dtype != np.uint8 or img.ndim != 2:
        raise ValueError(f"write_pgm takes a 2-D uint8 image, got "
                         f"{img.dtype}{img.shape}")
    h, w = img.shape
    with open(path, "wb") as f:
        f.write(b"P5\n%d %d\n255\n" % (w, h))
        f.write(img.tobytes())


def to_grayscale(path) -> np.ndarray:
    """Load an image as (h, w) uint8 grayscale: a PGM with read_pgm, any
    other format through PIL's convert('L') (the reference's
    ConvertToPGM.py:16-20)."""
    p = str(path)
    if p.lower().endswith(".pgm"):
        return read_pgm(p)
    from PIL import Image
    return np.asarray(Image.open(p).convert("L"), np.uint8)


def convert_to_pgm(src, dst) -> None:
    """Any-format -> grayscale PGM converter (ConvertToPGM.py)."""
    write_pgm(dst, to_grayscale(src))
