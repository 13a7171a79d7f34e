"""Quality metrics, numpy only: MSE / PSNR (reference src/HEVCeMain.c:116-133)
and SSIM (the reference's HEVCeval.py:188 calls scikit-image; computed here
directly with skimage's defaults: a uniform 7x7 window, unbiased
covariance)."""
import math

import numpy as np


def mse_psnr(a: np.ndarray, b: np.ndarray):
    """MSE / PSNR over the overlapping region (min-crop,
    src/HEVCeMain.c:121-124)."""
    h = min(a.shape[0], b.shape[0])
    w = min(a.shape[1], b.shape[1])
    d = a[:h, :w].astype(np.float64) - b[:h, :w].astype(np.float64)
    mse = float((d * d).mean())
    psnr = 99.0 if mse <= 0 else 10.0 * math.log10(255.0 * 255.0 / mse)
    return mse, psnr


def _filter2(img, win):
    """'valid' 2-D correlation through a sliding-window view."""
    from numpy.lib.stride_tricks import sliding_window_view
    v = sliding_window_view(img, win.shape)
    return np.einsum("ijkl,kl->ij", v, win)


def ssim(a: np.ndarray, b: np.ndarray) -> float:
    """Mean SSIM, as skimage.metrics.structural_similarity with its defaults
    for uint8 inputs (gaussian_weights=False: a uniform 7x7 window), the
    call HEVCeval.py makes."""
    h = min(a.shape[0], b.shape[0])
    w = min(a.shape[1], b.shape[1])
    x = a[:h, :w].astype(np.float64)
    y = b[:h, :w].astype(np.float64)
    win = 7
    box = np.full((win, win), 1.0 / (win * win))
    ux = _filter2(x, box)
    uy = _filter2(y, box)
    uxx = _filter2(x * x, box)
    uyy = _filter2(y * y, box)
    uxy = _filter2(x * y, box)
    # skimage's unbiased (N / (N - 1)) covariance normalisation
    n = win * win
    cov_norm = n / (n - 1.0)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)
    c1 = (0.01 * 255) ** 2
    c2 = (0.03 * 255) ** 2
    s = (((2 * ux * uy + c1) * (2 * vxy + c2))
         / ((ux ** 2 + uy ** 2 + c1) * (vx + vy + c2)))
    return float(s.mean())
