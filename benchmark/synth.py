# Frozen copy of hevce_tpu_torch/utils/synth.py at commit 2c4bff8, unchanged:
# the benchmark's traffic makes its images here from --seed.
"""Synthetic test images, made from a numpy generator.

Kodak is not in the repository, so the port's measurement tools and
chip_smoke.py encode images made here: an illumination gradient, flat
rectangles with edges, an oriented texture patch and Gaussian noise, so
that CU splits, TU splits and NxN partitions all occur.
"""
import numpy as np

SIGMAS = (1.5, 3.0, 6.0, 30.0)       # noise levels, cycled over a set


def synth_image(rng, h, w, noise_sigma):
    """one (h, w) uint8 image."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    img = 60 + 120 * (0.5 + 0.5 * np.sin(xx / w * rng.uniform(1, 4)
                                         + rng.uniform(0, 6))) \
        * (0.5 + 0.5 * yy / h)
    for _ in range(int(rng.integers(6, 16))):
        y0, x0 = int(rng.integers(0, h)), int(rng.integers(0, w))
        hh, ww = int(rng.integers(12, h // 3)), int(rng.integers(12, w // 3))
        img[y0:y0 + hh, x0:x0 + ww] = rng.uniform(20, 235)
    fy, fx = rng.uniform(0.05, 0.7, 2)
    cy, cx = rng.uniform(0, h), rng.uniform(0, w)
    patch = ((yy - cy) / (h / 3)) ** 2 + ((xx - cx) / (w / 3)) ** 2 < 1
    img += 45 * np.sin(yy * fy + xx * fx) * patch
    img += rng.normal(0, noise_sigma, (h, w))
    return np.clip(np.rint(img), 0, 255).astype(np.uint8)


def kodak_shaped(rng, n_land=18, n_port=6):
    """n_land images of shape (512, 768) and n_port of (768, 512): Kodak's
    two shapes (its 24 images are 18 and 6)."""
    land = [synth_image(rng, 512, 768, SIGMAS[i % 4]) for i in range(n_land)]
    port = [synth_image(rng, 768, 512, SIGMAS[(i + 3) % 4])
            for i in range(n_port)]
    return land + port
