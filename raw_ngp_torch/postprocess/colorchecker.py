"""Color-checker white-balance solve.

Rebuild of the reference's ``determine_wb`` (img/image_utils.py:263-363,
img/determineWB.py): average the 24 patches of a Macbeth-style chart in a
linear RAW capture, then solve the least-squares 3x3 color matrix mapping
the measured camera colors onto the chart's reference sRGB values
(O = C @ M^T). The reference hard-codes its capture path, crop box and
patch geometry; here they are parameters, and the normal-equations solve
(image_utils.py:356-360) becomes a numerically safer ``lstsq``.

A copy of ``raw_ngp_tpu/postprocess/colorchecker.py``; ``determine_wb``
demosaics through the port's ``bilinear_demosaic``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

# Standard 24-patch ColorChecker sRGB values (row-major, as in the
# reference image_utils.py:285-309 — public chart constants).
CLASSIC_24 = np.array(
    [[115, 82, 68], [194, 150, 130], [98, 122, 157], [87, 108, 67],
     [133, 128, 177], [103, 189, 170], [214, 126, 44], [80, 91, 166],
     [193, 90, 99], [94, 60, 108], [157, 188, 64], [224, 163, 46],
     [56, 61, 150], [70, 148, 73], [175, 54, 60], [231, 199, 31],
     [187, 86, 149], [8, 133, 161], [243, 243, 242], [200, 200, 200],
     [160, 160, 160], [122, 122, 121], [85, 85, 85], [52, 52, 52]],
    dtype=np.float64) / 255.0


def extract_patch_means(image: np.ndarray,
                        first_patch: Tuple[int, int, int, int] = (
                            60, 50, 140, 130),
                        spacing: float = 150.0,
                        grid: Tuple[int, int] = (4, 6)) -> np.ndarray:
    """Mean linear color of each chart patch.

    ``first_patch`` is (x0, y0, x1, y1) of the upper-left patch in array
    coordinates (rows, cols) and ``spacing`` the patch pitch — the
    reference's coords/delta walk (image_utils.py:318-348), vectorized.
    Returns [grid_rows*grid_cols, 3].
    """
    x0, y0, x1, y1 = first_patch
    rows, cols = grid
    means = np.zeros((rows * cols, 3), np.float64)
    k = 0
    for r in range(rows):
        for c in range(cols):
            xa = int(x0 + r * spacing)
            xb = int(x1 + r * spacing)
            ya = int(y0 + c * spacing)
            yb = int(y1 + c * spacing)
            xb = min(xb, image.shape[0])
            yb = min(yb, image.shape[1])
            patch = image[xa:xb, ya:yb, :3]
            means[k] = patch.reshape(-1, 3).mean(axis=0)
            k += 1
    return means


def solve_color_matrix(cam_colors: np.ndarray,
                       ref_colors: Optional[np.ndarray] = None
                       ) -> np.ndarray:
    """Least-squares M with ref ~= cam @ M.T (image_utils.py:356-360
    normal equations, solved via lstsq)."""
    ref = CLASSIC_24 if ref_colors is None else np.asarray(ref_colors)
    cam = np.asarray(cam_colors, np.float64)
    m_t, *_ = np.linalg.lstsq(cam, ref, rcond=None)
    return m_t.T                                           # [3, 3]


def determine_wb(image: np.ndarray,
                 black_level: float = 0.0,
                 white_level: float = 1.0,
                 crop: Optional[Tuple[int, int, int, int]] = None,
                 rot90: int = 0,
                 mosaiced: bool = False,
                 first_patch: Tuple[int, int, int, int] = (60, 50, 140, 130),
                 spacing: float = 150.0) -> np.ndarray:
    """Solve the 3x3 WB/color matrix from a color-checker capture.

    Args mirror the reference's hard-coded pipeline: ``crop`` is a PIL-
    style (left, upper, right, lower) box, ``rot90`` counts clockwise
    90-degree turns (the reference rotates -90), black/white levels come
    from EXIF, ``mosaiced`` runs the bilinear demosaic first.
    """
    img = np.asarray(image, np.float32)
    if crop is not None:
        left, upper, right, lower = crop
        img = img[upper:lower, left:right]
    if rot90:
        img = np.rot90(img, k=-rot90)
    img = (img - black_level) / max(white_level - black_level, 1e-12)
    if mosaiced or img.ndim == 2:
        from raw_ngp_torch.postprocess.raw import bilinear_demosaic
        img = bilinear_demosaic(img)
    cam = extract_patch_means(img, first_patch, spacing)
    return solve_color_matrix(cam)
