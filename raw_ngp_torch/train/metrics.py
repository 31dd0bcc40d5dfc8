"""Quality metrics (port of ``raw_ngp_tpu/train/metrics.py``
``PSNRMeter`` ``:30``; SSIM and LPIPS are not ported)."""

from __future__ import annotations

import numpy as np


class PSNRMeter:
    """Mean over images of -10 log10(MSE), max value 1."""

    name = "PSNR"

    def __init__(self):
        self.V = 0.0
        self.N = 0

    def clear(self):
        self.V, self.N = 0.0, 0

    def update(self, preds, truths) -> float:
        preds = np.asarray(preds, np.float64)
        truths = np.asarray(truths, np.float64)
        mse = np.mean((preds - truths) ** 2)
        psnr = -10.0 * np.log10(max(mse, 1e-12))
        self.V += psnr
        self.N += 1
        return psnr

    def measure(self) -> float:
        return self.V / max(self.N, 1)

    def report(self) -> str:
        return f"PSNR = {self.measure():.6f}"
