"""Quality metrics: PSNR, SSIM (self-contained), LPIPS (NaN), RMSE
(port of ``raw_ngp_tpu/train/metrics.py``: ``PSNRMeter`` ``:30``,
``_gaussian_kernel`` / ``_filter2d`` / ``ssim`` / ``SSIMMeter``
``:48-103``, ``LPIPSMeter`` ``:106-139``, ``rmse`` ``:142``), host numpy.

SSIM is the Wang et al. formula with the standard 11x11 Gaussian window.
LPIPS needs the lpips package and its pretrained VGG weights, which the
repository does not have: its meter measures NaN, as in the JAX package
without lpips.
"""

from __future__ import annotations


import numpy as np


class MeterBase:
    def __init__(self):
        self.V = 0.0
        self.N = 0

    def clear(self):
        self.V, self.N = 0.0, 0

    def measure(self) -> float:
        return self.V / max(self.N, 1)


class PSNRMeter(MeterBase):
    """Mean over images of -10 log10(MSE), max value 1."""

    name = "PSNR"

    def update(self, preds, truths) -> float:
        preds = np.asarray(preds, np.float64)
        truths = np.asarray(truths, np.float64)
        mse = np.mean((preds - truths) ** 2)
        psnr = -10.0 * np.log10(max(mse, 1e-12))
        self.V += psnr
        self.N += 1
        return psnr

    def report(self) -> str:
        return f"PSNR = {self.measure():.6f}"


def _gaussian_kernel(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    ax = np.arange(size) - size // 2
    g = np.exp(-(ax ** 2) / (2 * sigma ** 2))
    k = np.outer(g, g)
    return k / k.sum()


def _filter2d(img: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    """Valid-mode 2D convolution per channel by sliding windows."""
    kh, kw = kernel.shape
    H, W = img.shape[:2]
    out_h, out_w = H - kh + 1, W - kw + 1
    strides = img.strides
    windows = np.lib.stride_tricks.as_strided(
        img, (out_h, out_w, kh, kw) + img.shape[2:],
        (strides[0], strides[1], strides[0], strides[1]) + strides[2:],
        writeable=False)
    return np.einsum("ijkl...,kl->ij...", windows, kernel)


def ssim(img1: np.ndarray, img2: np.ndarray, data_range: float = 1.0,
         k1: float = 0.01, k2: float = 0.03) -> float:
    """Structural similarity with the standard 11x11 sigma=1.5 window."""
    img1 = np.asarray(img1, np.float64)
    img2 = np.asarray(img2, np.float64)
    if img1.ndim == 2:
        img1, img2 = img1[..., None], img2[..., None]
    kernel = _gaussian_kernel()
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2

    mu1 = _filter2d(img1, kernel)
    mu2 = _filter2d(img2, kernel)
    mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1 = _filter2d(img1 * img1, kernel) - mu1_sq
    sigma2 = _filter2d(img2 * img2, kernel) - mu2_sq
    sigma12 = _filter2d(img1 * img2, kernel) - mu12

    num = (2 * mu12 + c1) * (2 * sigma12 + c2)
    den = (mu1_sq + mu2_sq + c1) * (sigma1 + sigma2 + c2)
    return float(np.mean(num / den))


class SSIMMeter(MeterBase):
    """SSIM meter (train_utils.py:290-328 without torchmetrics)."""

    name = "SSIM"

    def update(self, preds, truths) -> float:
        v = ssim(np.asarray(preds), np.asarray(truths))
        self.V += v
        self.N += 1
        return v

    def report(self) -> str:
        return f"SSIM = {self.measure():.6f}"


class LPIPSMeter(MeterBase):
    """Perceptual metric (train_utils.py:250-288). It needs the lpips
    package and its pretrained VGG weights, which the repository does not
    have: ``update`` records nothing and ``measure`` is NaN, as in the JAX
    package without lpips."""

    name = "LPIPS"

    def update(self, preds, truths) -> None:
        return None

    def measure(self) -> float:
        return float("nan")

    def report(self) -> str:
        return f"LPIPS = {self.measure():.6f}"


def rmse(preds: np.ndarray, truths: np.ndarray) -> float:
    return float(np.sqrt(np.mean((np.asarray(preds, np.float64)
                                  - np.asarray(truths, np.float64)) ** 2)))
