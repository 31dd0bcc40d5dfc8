"""RAW / HDR image math: sRGB curves, Bayer demosaicking, exposure
postprocessing, HDR merge + tonemap.

Re-implementation of the multinerf-derived raw utilities the reference
vendors (raw/raw_utils.py:55-237). Host-side numpy for data prep and output
postprocessing; the training-path pieces (Bayer loss mask) live in
raw_ngp_torch.data.sampler as torch.

A copy of the numpy functions of ``raw_ngp_tpu/postprocess/raw.py``
(``:17-94``), its ``postprocess_raw_hdr`` (``:96-139``) over the numpy
copies of cv2's HDR calibration, merges and tonemaps in ``hdr.py``, and its
``depth_to_normal`` (``:142``) with cv2's 3x3 Sobel written in numpy (the
card's machine has no cv2).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from raw_ngp_torch.postprocess import hdr as _hdr


def linear_to_srgb(linear: np.ndarray, eps: Optional[float] = None):
    """sRGB OETF (raw_utils.py:55-62)."""
    if eps is None:
        eps = np.finfo(np.float32).eps
    srgb0 = 323 / 25 * linear
    srgb1 = (211 * np.maximum(eps, linear) ** (5 / 12) - 11) / 200
    return np.where(linear <= 0.0031308, srgb0, srgb1)


def srgb_to_linear(srgb: np.ndarray, eps: Optional[float] = None):
    """Inverse sRGB OETF (raw_utils.py:65-72)."""
    if eps is None:
        eps = np.finfo(np.float32).eps
    lin0 = 25 / 323 * srgb
    lin1 = np.maximum(eps, (200 * srgb + 11) / 211) ** (12 / 5)
    return np.where(srgb <= 0.04045, lin0, lin1)


def bilinear_demosaic(bayer: np.ndarray) -> np.ndarray:
    """RGGB Bayer [H, W] -> RGB [H, W, 3] by bilinear upsampling
    (raw_utils.py:74-139 semantics: R top-left, wrap-around at edges)."""

    def tile_quads(*planes):
        p = np.stack(planes, -1)
        h, w = p.shape[:2]
        return p.reshape(h, w, 2, 2).transpose(0, 2, 1, 3).reshape(2 * h,
                                                                   2 * w)

    def up2(z):
        zx = 0.5 * (z + np.roll(z, -1, axis=-1))
        zy = 0.5 * (z + np.roll(z, -1, axis=-2))
        zxy = 0.5 * (zx + np.roll(zx, -1, axis=-2))
        return tile_quads(z, zx, zy, zxy)

    def up_green(g1, g2):
        z = np.zeros_like(g1)
        full = tile_quads(z, g1, g2, z)
        cross = sum(0.25 * np.roll(full, r, axis=a)
                    for a, r in ((-1, -1), (-1, 1), (-2, -1), (-2, 1)))
        return cross + full

    r = bayer[0::2, 0::2]
    g1 = bayer[0::2, 1::2]
    g2 = bayer[1::2, 0::2]
    b = bayer[1::2, 1::2]
    r_full = up2(r)
    b_full = up2(b[::-1, ::-1])[::-1, ::-1]
    g_full = up_green(g1, g2)
    return np.stack([r_full, g_full, b_full], -1)


def pixels_to_bayer_mask(pix_x: np.ndarray, pix_y: np.ndarray) -> np.ndarray:
    """Binary RGGB mask per pixel coordinate (raw_utils.py:141-150)."""
    r = (pix_x % 2 == 0) * (pix_y % 2 == 0)
    g = ((pix_x % 2 == 1) * (pix_y % 2 == 0)
         + (pix_x % 2 == 0) * (pix_y % 2 == 1))
    b = (pix_x % 2 == 1) * (pix_y % 2 == 1)
    return np.stack([r, g, b], -1).astype(np.float32)


def postprocess_raw(raw: np.ndarray, cam2rgb: np.ndarray,
                    exposure: Optional[float] = None) -> np.ndarray:
    """Linear camera RGB -> displayable sRGB (raw_utils.py:173-192):
    demosaic if mosaiced, cam2rgb matrix, exposure scale, sRGB curve.

    NOTE: the reference flips channels at the end (BGR for cv2 writers);
    we return RGB and let writers handle channel order.
    """
    if raw.shape[-1] != 3:
        raw = bilinear_demosaic(raw)
    if cam2rgb.shape != (3, 3):
        raise ValueError(f"cam2rgb must be 3x3, got {cam2rgb.shape}")
    rgb_linear = raw @ cam2rgb.T
    if exposure is None:
        exposure = np.percentile(rgb_linear, 97.0)
    scaled = np.clip(rgb_linear / exposure, 0.0, 1.0)
    return linear_to_srgb(scaled)


def exposure_stack(rgb_linear: np.ndarray, percentiles: Sequence[float]):
    """The uint8 exposures of a linear image at each percentile whose value
    is above 0 (255 at that value, truncated), and their float32 times
    1 / value: postprocess_raw_hdr's input to the merge."""
    exposed, times = [], []
    for p in percentiles:
        exp = np.percentile(rgb_linear, p)
        if exp > 0:
            exposed.append((255.0 * np.clip(rgb_linear / exp, 0, 1))
                           .astype(np.uint8))
            times.append(exp)
    return exposed, np.array([1.0 / t for t in times], dtype=np.float32)


def postprocess_raw_hdr(raw: np.ndarray, cam2rgb: np.ndarray,
                        percentiles: Sequence[float],
                        merge_algo: str = "robertson",
                        tonemap_algo: str = "reinhard") -> np.ndarray:
    """Multi-exposure HDR merge + tonemap of a linear prediction
    (raw_utils.py:194-237): re-expose at several percentiles (those whose
    exposure is above 0), merge with Debevec/Robertson, tonemap
    Reinhard/Mantiuk/Drago (``hdr.py``, OpenCV's algorithms in numpy).
    Returns float32 [H, W, 3], NaN where cv2's tonemaps give NaN."""
    if raw.shape[-1] != 3:
        raise ValueError("expected demosaiced 3-channel input")
    exposed, times = exposure_stack(raw @ cam2rgb.T, percentiles)

    if merge_algo == "debevec":
        calibrate, merge = _hdr.calibrate_debevec, _hdr.merge_debevec
    elif merge_algo == "robertson":
        calibrate, merge = _hdr.calibrate_robertson, _hdr.merge_robertson
    else:
        raise ValueError(f"unknown merge algo {merge_algo!r}")
    if tonemap_algo == "reinhard":
        tonemap = _hdr.tonemap_reinhard
    elif tonemap_algo == "mantiuk":
        tonemap = _hdr.tonemap_mantiuk
    elif tonemap_algo == "drago":
        tonemap = _hdr.tonemap_drago
    else:
        raise ValueError(f"unknown tonemap {tonemap_algo!r}")
    crf = calibrate(exposed, times)
    return tonemap(merge(exposed, times, crf))


def _sobel3(img: np.ndarray, axis: int) -> np.ndarray:
    """cv2.Sobel(img, CV_32F, dx, dy, ksize=3) with its default border
    (BORDER_REFLECT_101, numpy's "reflect"), in f32 and in cv2's order (the
    row filter, then the column filter): the derivative [-1, 0, 1] along
    ``axis`` (1 = x, 0 = y), the smoothing [1, 2, 1] across it. Within a
    few f32 ulps of cv2's (its vector code groups the adds its own way)."""
    p = np.pad(np.asarray(img, np.float32), 1, mode="reflect")
    if axis == 1:
        r = p[:, 2:] - p[:, :-2]
        return (r[:-2] + r[2:]) + 2 * r[1:-1]
    r = (p[:, :-2] + p[:, 2:]) + 2 * p[:, 1:-1]
    return r[2:] - r[:-2]


def depth_to_normal(depth: np.ndarray) -> np.ndarray:
    """Sobel-gradient normal map from a depth image
    (img/image_utils.py:243-261 equivalent)."""
    dzdx = _sobel3(depth, 1)
    dzdy = _sobel3(depth, 0)
    n = np.stack([-dzdx, -dzdy, np.ones_like(dzdx)], axis=-1)
    n /= (np.linalg.norm(n, axis=-1, keepdims=True) + 1e-8)
    return (n + 1.0) / 2.0
