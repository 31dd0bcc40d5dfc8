"""Host-side RAW preprocessing in numpy (counterpart of
``raw_ngp_tpu/native.py``).

The JAX package binds a C++ runtime (``native/raw_ngp_native.cpp``) through
ctypes and falls back to numpy when it cannot build it. The port keeps the
numpy forms of the two functions the image loader calls
(``native.py:83-107``); it never builds nor loads the shared object. The
ctypes bindings (Morton codes, packbits, the sRGB curve) wait for ROADMAP
item A16.

The numpy forms round as JAX's fallback does, which can differ from its
C++ route by an ulp: ``normalize_levels`` divides by ``white - black``
where the C++ multiplies by its f32 reciprocal, and ``demosaic_rggb``
sums in numpy's order.
"""

from __future__ import annotations

import numpy as np

from raw_ngp_torch.postprocess.raw import bilinear_demosaic


def demosaic_rggb(bayer: np.ndarray) -> np.ndarray:
    """Bilinear RGGB demosaic of a [H, W] mosaic -> [H, W, 3] float32
    (wrap-around at the edges)."""
    bayer = np.ascontiguousarray(bayer, np.float32)
    return bilinear_demosaic(bayer).astype(np.float32)


def normalize_levels(img: np.ndarray, black: float, white: float,
                     clip: bool = True) -> np.ndarray:
    """(img - black) / (white - black) in float32, after clipping img to
    [0, 1] when ``clip``; returns a new array."""
    img = np.ascontiguousarray(img, np.float32).copy()
    if clip:
        img = np.clip(img, 0.0, 1.0)
    return (img - black) / (white - black)
