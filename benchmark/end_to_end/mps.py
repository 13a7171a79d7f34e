"""mps: source megapixels (not padded to CTUs) of every stream the window
returned, over the window's seconds (from its start to the return of its
last call)."""


def read(readings):
    w = readings["window"]
    return w["pixels"] / 1e6 / w["seconds"] if w["pixels"] else None
