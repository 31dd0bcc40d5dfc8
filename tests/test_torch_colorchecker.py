"""The port's colour-checker solve (raw_ngp_torch/postprocess/
colorchecker.py) on the CPU: tests/test_colorchecker.py's three checks
asked of the port, and determine_wb equal to the JAX package's on a
synthetic mosaiced chart."""

import numpy as np

from raw_ngp_torch.postprocess import (
    CLASSIC_24,
    determine_wb,
    extract_patch_means,
    solve_color_matrix,
)


def make_chart(mat_inv, first=(60, 50, 140, 130), spacing=150,
               shape=(660, 950, 3), noise=0.0, seed=0):
    """Synthetic chart: patches = reference colors pushed through the
    INVERSE of a known color matrix (so the solve must recover mat)."""
    rng = np.random.default_rng(seed)
    img = np.zeros(shape, np.float32)
    k = 0
    for r in range(4):
        for c in range(6):
            x0 = first[0] + r * spacing
            y0 = first[1] + c * spacing
            img[x0:x0 + 80, y0:y0 + 80] = CLASSIC_24[k] @ mat_inv.T
            k += 1
    if noise:
        img += rng.normal(0, noise, img.shape).astype(np.float32)
    return img


def test_recovers_known_color_matrix():
    mat = np.array([[1.8, -0.3, -0.1],
                    [-0.2, 1.5, -0.3],
                    [0.05, -0.4, 1.9]])
    got = determine_wb(make_chart(np.linalg.inv(mat)))
    np.testing.assert_allclose(got, mat, atol=1e-3)


def test_noise_robust_and_patch_means():
    mat = np.eye(3) * 2.0
    img = make_chart(np.linalg.inv(mat), noise=5e-3)
    means = extract_patch_means(img)
    assert means.shape == (24, 3)
    np.testing.assert_allclose(solve_color_matrix(means), mat, atol=0.05)


def test_crop_rotation_and_levels():
    mat = np.array([[1.2, 0.1, 0.0],
                    [0.0, 1.1, 0.1],
                    [0.1, 0.0, 1.3]])
    base = make_chart(np.linalg.inv(mat))
    framed = np.rot90(base, k=-1)   # chart captured rotated clockwise
    levels = framed * 3000.0 + 256.0
    canvas = np.zeros((1400, 1400, 3), np.float32)
    canvas[100:100 + levels.shape[0], 200:200 + levels.shape[1]] = levels
    got = determine_wb(
        canvas, black_level=256.0, white_level=3256.0,
        crop=(200, 100, 200 + levels.shape[1], 100 + levels.shape[0]),
        rot90=-1)
    np.testing.assert_allclose(got, mat, atol=2e-3)


def mosaic(rgb):
    """RGGB Bayer mosaic [H, W] of an RGB image."""
    out = rgb[..., 1].copy()
    out[0::2, 0::2] = rgb[0::2, 0::2, 0]
    out[1::2, 1::2] = rgb[1::2, 1::2, 2]
    return out


def test_determine_wb_mosaiced_equals_jax():
    """A mosaiced chart with noise, levels and a crop: the port's
    determine_wb (through its own demosaic) and its pieces equal the JAX
    package's bit for bit, and recover the matrix; with a turn too (which
    changes the mosaic's phase, so only the equality holds)."""
    from raw_ngp_tpu.postprocess import colorchecker as jcc

    mat = np.array([[1.5, -0.2, 0.0], [-0.1, 1.3, -0.2], [0.0, -0.3, 1.6]])
    chart = make_chart(np.linalg.inv(mat), noise=2e-3, seed=3)
    raw = mosaic(chart) * 4000.0 + 200.0
    canvas = np.full((800, 1100), 200.0, np.float32)
    canvas[40:40 + raw.shape[0], 60:60 + raw.shape[1]] = raw
    kw = dict(black_level=200.0, white_level=4200.0,
              crop=(60, 40, 60 + raw.shape[1], 40 + raw.shape[0]),
              mosaiced=True)
    got = determine_wb(canvas, **kw)
    np.testing.assert_array_equal(got, jcc.determine_wb(canvas, **kw))
    np.testing.assert_allclose(got, mat, atol=0.05)
    turned = np.rot90(canvas, k=1).copy()
    kw.update(crop=(40, 0, 40 + raw.shape[0], 1040), rot90=-1)
    np.testing.assert_array_equal(determine_wb(turned, **kw),
                                  jcc.determine_wb(turned, **kw))
    np.testing.assert_array_equal(CLASSIC_24, jcc.CLASSIC_24)
    means = extract_patch_means(chart)
    np.testing.assert_array_equal(means, jcc.extract_patch_means(chart))
    np.testing.assert_array_equal(solve_color_matrix(means),
                                  jcc.solve_color_matrix(means))
