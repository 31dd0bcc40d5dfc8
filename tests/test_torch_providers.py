"""Parity of the port's scene loading (raw_ngp_torch.data: colmap_io,
pose_utils, trajectories, reflectance, image_io, providers, the rfield
grid scene; raw_ngp_torch.utils.cameras, raw_ngp_torch.postprocess.raw,
raw_ngp_torch.native) with the JAX package's, on the CPU.

The numpy modules are copies, so their results are held bit for bit. The
port reads PNG itself and resizes with a numpy copy of cv2's INTER_AREA
downscale, where JAX calls cv2: both are held bit for bit against cv2
(PNGs that cv2 and Pillow write, all five row filters, 8 and 16 bits,
grey, RGB, RGBA, grey + alpha, palette, transparency, bit depths below 8
and Adam7 interlacing), and the loaders' SceneData field by field against
JAX's. DTU's camera decomposition uses scipy's RQ where JAX uses cv2.
The loaders' centring draws from numpy's global stream where the
cameras' mean up vector is opposite to +z, so each package's load is
preceded by the same ``np.random.seed``. A last test imports every module
of the port and loads a COLMAP PNG scene and a COLMAP JPEG scene in an
interpreter where cv2, imageio, rawpy and PIL cannot be imported, as on
the card's machine. The area resize's upscale (cv2's linear branch) is
held against cv2 as the downscale is.
Each test states its tolerance.
"""

import dataclasses
import json
import os
import struct
import subprocess
import sys
import zlib
from dataclasses import replace

import cv2
import numpy as np
import pytest
import torch

import chip_smoke
import raw_ngp_torch.config as tcfg
import raw_ngp_tpu.config as jcfg
from raw_ngp_torch import native as tnative
from raw_ngp_torch.data import colmap_io as tcio
from raw_ngp_torch.data import image_io as tio
from raw_ngp_torch.data import pose_utils as tpu
from raw_ngp_torch.data import providers as tprov
from raw_ngp_torch.data import reflectance as trefl
from raw_ngp_torch.data import synthetic as tsyn
from raw_ngp_torch.data import trajectories as ttraj
from raw_ngp_torch.postprocess import raw as traw
from raw_ngp_torch.train.trainer import Trainer
from raw_ngp_torch.utils import cameras as tcam
from raw_ngp_tpu import native as jnative
from raw_ngp_tpu.data import colmap_io as jcio
from raw_ngp_tpu.data import image_io as jio
from raw_ngp_tpu.data import pose_utils as jpu
from raw_ngp_tpu.data import providers as jprov
from raw_ngp_tpu.data import reflectance as jrefl
from raw_ngp_tpu.data import synthetic as jsyn
from raw_ngp_tpu.data import trajectories as jtraj
from raw_ngp_tpu.postprocess import raw as jraw
from raw_ngp_tpu.utils import cameras as jcam
from test_torch_train import mini_cfg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's torch work, set back after
    it (under pytest-xdist torch's default of a thread a core
    oversubscribes the cores: tests/test_torch_proposal.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _same(a, b, what=""):
    """Bit for bit: same dtype, shape and values (NaN-safe)."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype,
                                                       b.dtype, a.shape,
                                                       b.shape)
    np.testing.assert_array_equal(a, b, err_msg=what)


def _same_scene(t, j):
    """Every field of two SceneData equal bit for bit, meta included."""
    assert type(t).__name__ == type(j).__name__ == "SceneData"
    for f in dataclasses.fields(j):
        vt, vj = getattr(t, f.name), getattr(j, f.name)
        if f.name == "meta":
            for g in dataclasses.fields(vj):
                mt, mj = getattr(vt, g.name), getattr(vj, g.name)
                if isinstance(mj, (dict, str, int, float)) or (
                        isinstance(mj, list) and mj
                        and isinstance(mj[0], (str, float, int))):
                    assert mt == mj, g.name
                elif mj is None or (isinstance(mj, list) and not mj):
                    assert mt is None or (isinstance(mt, list) and not mt), \
                        g.name
                else:
                    _same(np.asarray(mt), np.asarray(mj), f"meta.{g.name}")
        elif vj is None:
            assert vt is None, f.name
        elif isinstance(vj, int):
            assert vt == vj, f.name
        else:
            _same(vt, vj, f.name)


def _cfgs(**data):
    """(JAX config, port config) with the same data options."""
    out = []
    for mod in (jcfg, tcfg):
        cfg = mod.Config()
        out.append(replace(cfg, data=replace(cfg.data, **data)))
    return out


def _both(split, j_cfg, t_cfg, j_fn, t_fn, seed=1, **kwargs):
    """(JAX's, the port's) load of `split`, each after np.random.seed."""
    np.random.seed(seed)
    j = j_fn(j_cfg, split, **kwargs)
    np.random.seed(seed)
    t = t_fn(t_cfg, split, **kwargs)
    return j, t


# ------------------------------------------------------------ COLMAP IO

def _colmap_model(rng, n_images=6, n_points=40):
    cams = {1: ("PINHOLE", 48, 40, [50.0, 51.0, 24.0, 20.0]),
            2: ("SIMPLE_RADIAL", 64, 48, [60.0, 32.0, 24.0, 0.01]),
            3: ("OPENCV", 32, 32, [30.0, 31.0, 16.0, 16.0, 0.1, -0.1, 0.0,
                                   0.0])}
    images = {}
    for i in range(1, n_images + 1):
        q = rng.standard_normal(4)
        images[i] = (q / np.linalg.norm(q), rng.standard_normal(3),
                     1 + i % 3, f"im_{i:02d}.png",
                     rng.uniform(0, 40, (7 + i, 2)),
                     rng.integers(-1, n_points, 7 + i).astype(np.int64))
    points = {k: (rng.uniform(-1, 1, 3), rng.integers(0, 255, 3),
                  float(rng.uniform(0.1, 2)))
              for k in range(1, n_points)}
    return cams, images, points


def _write_model(io, root, model):
    cams, images, points = model
    io.write_cameras_binary(
        {k: io.ColmapCamera(k, m, w, h, np.array(p))
         for k, (m, w, h, p) in cams.items()}, os.path.join(root, "c.bin"))
    io.write_images_binary(
        {k: io.ColmapImage(k, q, t, c, n, xy, ids)
         for k, (q, t, c, n, xy, ids) in images.items()},
        os.path.join(root, "i.bin"))
    io.write_points3d_binary(
        {k: io.ColmapPoint3D(k, xyz, rgb, e)
         for k, (xyz, rgb, e) in points.items()},
        os.path.join(root, "p.bin"))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_colmap_binaries_written_by_either_read_by_both(tmp_path, writer):
    """cameras.bin, images.bin and points3D.bin written by one package
    (three camera models, keypoints with unmatched -1 ids) read by both:
    every field equal bit for bit; the files' bytes the same from either
    writer; qvec_to_rotmat the same matrices, and rotmat_to_qvec (the
    port's writers' helper) its inverse within 1e-15."""
    model = _colmap_model(np.random.default_rng(0))
    root = str(tmp_path)
    _write_model(jcio if writer == "jax" else tcio, root, model)
    other = tmp_path / "other"
    other.mkdir()
    _write_model(tcio if writer == "jax" else jcio, str(other), model)
    for name in ("c.bin", "i.bin", "p.bin"):
        assert (tmp_path / name).read_bytes() == (other / name).read_bytes()
    for rd in ("read_cameras_binary", "read_images_binary",
               "read_points3d_binary"):
        path = os.path.join(root, {"read_cameras_binary": "c.bin",
                                   "read_images_binary": "i.bin",
                                   "read_points3d_binary": "p.bin"}[rd])
        got, want = getattr(tcio, rd)(path), getattr(jcio, rd)(path)
        assert sorted(got) == sorted(want)
        for k in want:
            for f in dataclasses.fields(want[k]):
                a, b = getattr(got[k], f.name), getattr(want[k], f.name)
                if isinstance(b, np.ndarray):
                    _same(a, b, f"{rd} {k} {f.name}")
                else:
                    assert a == b, (rd, k, f.name)
    for q in [np.array([1.0, 0, 0, 0])] + [v[0] for v in model[1].values()]:
        R = tcio.qvec_to_rotmat(q)
        _same(R, jcio.qvec_to_rotmat(q))
        back = tcio.rotmat_to_qvec(R)
        np.testing.assert_allclose(back, q * np.sign(q[0]), atol=1e-15)


# --------------------------------------------------- numpy pose modules

def _ring_poses(n=9, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        th = 2 * np.pi * i / n
        eye = np.array([3 * np.cos(th), 3 * np.sin(th), 1.0 + 0.3 * i % 2])
        out.append(tsyn.look_at_pose(eye, rng.uniform(-0.2, 0.2, 3)))
    return np.stack(out)


def test_pose_utils_bit_identical():
    """rotmat_between (a general pair and the opposite-direction branch,
    which draws from numpy's global stream: seeded alike), center_poses
    (points, the camera centre, no points), auto_scale (auto and fixed),
    rectify_colmap_convention and nerf_matrix_to_ngp: bit for bit."""
    rng = np.random.default_rng(1)
    a, b = rng.standard_normal(3), rng.standard_normal(3)
    _same(tpu.rotmat_between(a, b), jpu.rotmat_between(a, b))
    opposite = []
    for mod in (tpu, jpu):
        np.random.seed(3)
        opposite.append(mod.rotmat_between(np.array([0.0, 0, 1]),
                                           np.array([0.0, 0, -1])))
    _same(*opposite)
    poses = _ring_poses()
    pts = rng.standard_normal((50, 3))
    for kw in ({}, {"enable_cam_center": True}):
        for p in (pts, None):
            (pt, qt), (pj, qj) = (mod.center_poses(poses, p, **kw)
                                  for mod in (tpu, jpu))
            _same(pt, pj)
            assert (qt is None) == (qj is None)
            if qj is not None:
                _same(qt, qj)
    for s in (-1.0, 0.5):
        assert tpu.auto_scale(poses, s) == jpu.auto_scale(poses, s)
    for p in (pts, None):
        (pt, qt), (pj, qj) = (mod.rectify_colmap_convention(poses, p)
                              for mod in (tpu, jpu))
        _same(pt, pj)
        if qj is not None:
            _same(qt, qj)
    _same(tpu.nerf_matrix_to_ngp(poses[0], 0.8, (0.1, -0.2, 0.3)),
          jpu.nerf_matrix_to_ngp(poses[0], 0.8, (0.1, -0.2, 0.3)))


def test_trajectories_and_camera_rigs_bit_identical():
    """circle_poses, interp_poses (scipy's Slerp), rand_poses,
    create_dodecahedron_cameras and interp_light_dirs of data/trajectories
    and the other defaults of utils/cameras: bit for bit."""
    poses = _ring_poses().astype(np.float32)
    _same(ttraj.circle_poses(1.3, 12, 70.0), jtraj.circle_poses(1.3, 12,
                                                                70.0))
    for kw in ({}, {"n_anchors": 3, "n_test": 6, "seed": 2}):
        _same(ttraj.interp_poses(poses, **kw), jtraj.interp_poses(poses,
                                                                  **kw))
    _same(ttraj.rand_poses(7, 1.5, seed=4), jtraj.rand_poses(7, 1.5,
                                                             seed=4))
    _same(ttraj.create_dodecahedron_cameras(2.0, (0.1, 0.0, -0.1)),
          jtraj.create_dodecahedron_cameras(2.0, (0.1, 0.0, -0.1)))
    a, b = np.array([0.0, 0.6, 0.8]), np.array([0.6, 0.0, 0.8])
    _same(ttraj.interp_light_dirs(a, b, 9), jtraj.interp_light_dirs(a, b, 9))
    _same(tcam.create_dodecahedron_cameras(),
          jcam.create_dodecahedron_cameras())
    _same(tcam.create_dodecahedron_cameras(1.5, np.array([0.2, 0, 0])),
          jcam.create_dodecahedron_cameras(1.5, np.array([0.2, 0, 0])))
    _same(tcam.rand_poses(6, 2.0, seed=1), jcam.rand_poses(6, 2.0, seed=1))


def test_light_calibration_bit_identical(tmp_path):
    """write_light_dirs_calibration's file from either package is the same
    bytes; load_light_dirs gives the same unit directions
    (tests/test_providers.py::test_light_dirs_roundtrip's checks)."""
    positions = np.array([[1.0, 0, 1.35], [-1.0, 0, 1.35],
                          [0, 1.0, 1.35], [0, -1.0, 1.35], [0.3, 0.2, 2.0]])
    pt, pj = str(tmp_path / "t.txt"), str(tmp_path / "j.txt")
    trefl.write_light_dirs_calibration(pt, positions)
    jrefl.write_light_dirs_calibration(pj, positions)
    assert open(pt).read() == open(pj).read()
    dirs = trefl.load_light_dirs(pt)
    _same(dirs, jrefl.load_light_dirs(pt))
    assert dirs.shape == (5, 3) and dirs[0, 0] < -0.9
    np.testing.assert_allclose(np.linalg.norm(dirs, axis=-1), 1.0,
                               rtol=1e-6)


def test_postprocess_raw_bit_identical():
    """linear_to_srgb, srgb_to_linear, bilinear_demosaic,
    pixels_to_bayer_mask and postprocess_raw (with and without an
    exposure, mosaiced and 3-channel input): bit for bit; the JAX tests'
    checks (sRGB round trip, a constant mosaic, the RGGB pattern, the
    output range) hold."""
    rng = np.random.default_rng(0)
    x = np.linspace(-0.1, 1.2, 301).astype(np.float32)
    for fn in ("linear_to_srgb", "srgb_to_linear"):
        _same(getattr(traw, fn)(x), getattr(jraw, fn)(x), fn)
        _same(getattr(traw, fn)(x, eps=1e-6), getattr(jraw, fn)(x, eps=1e-6))
    bayer = rng.uniform(0, 1, (16, 20)).astype(np.float32)
    _same(traw.bilinear_demosaic(bayer), jraw.bilinear_demosaic(bayer))
    xs, ys = np.meshgrid(np.arange(5), np.arange(4), indexing="xy")
    m = traw.pixels_to_bayer_mask(xs, ys)
    _same(m, jraw.pixels_to_bayer_mask(xs, ys))
    assert m[0, 0, 0] == 1 and m[0, 1, 1] == 1 and m[1, 1, 2] == 1
    cam2rgb = np.array([[1.2, -0.1, 0.0], [0.0, 0.9, 0.1], [0.1, 0, 1.1]])
    rgb = rng.uniform(0, 1, (8, 8, 3)).astype(np.float32)
    for raw in (rgb, bayer):
        for exposure in (None, 0.9):
            out = traw.postprocess_raw(raw, cam2rgb, exposure)
            _same(out, jraw.postprocess_raw(raw, cam2rgb, exposure))
            assert out.min() >= 0 and out.max() <= 1 + 1e-6
    lin = np.linspace(0.001, 1.0, 64)
    np.testing.assert_allclose(traw.srgb_to_linear(traw.linear_to_srgb(lin)),
                               lin, rtol=1e-4)
    np.testing.assert_allclose(
        traw.bilinear_demosaic(np.full((16, 16), 0.5, np.float32)), 0.5,
        rtol=1e-6)


def test_native_numpy_forms(monkeypatch):
    """normalize_levels and demosaic_rggb, route against route: the
    port's C++ library bit for bit the JAX package's (the same source and
    flags), and with both libraries switched off the port's numpy bit for
    bit JAX's numpy (the two routes differ from each other by an ulp: the
    C++ multiplies by the f32 reciprocal and sums the demosaic in another
    order)."""
    rng = np.random.default_rng(2)
    img = rng.uniform(-0.2, 1.3, (12, 18)).astype(np.float32)

    def outputs(mod):
        return ([mod.normalize_levels(img, 0.00024420026, 1.0, c)
                 for c in (True, False)] + [mod.demosaic_rggb(img)])

    assert tnative.available() and jnative.available()
    for got, want in zip(outputs(tnative), outputs(jnative)):
        _same(got, want)
    for mod in (tnative, jnative):
        monkeypatch.setattr(mod, "_LIB", None)
        monkeypatch.setattr(mod, "_TRIED", True)
    for got, want in zip(outputs(tnative), outputs(jnative)):
        _same(got, want)


def test_rfield_grid_scene_bit_identical():
    """make_rfield_grid_scene: every SceneData field of train and val bit
    for bit JAX's; tests/test_rfield.py's checks (V x L train pairs,
    held-out lights unseen at train and inside its polar band, val poses
    drawn from the train poses)."""
    kw = dict(n_views=4, n_lights=5, n_heldout_lights=3, n_val_views=2,
              H=16, W=16, textured=True)
    tr, va = tsyn.make_rfield_grid_scene(**kw)
    jtr_, jva = jsyn.make_rfield_grid_scene(**kw)
    _same_scene(tr, jtr_)
    _same_scene(va, jva)
    _same(tsyn._light_spiral(11), jsyn._light_spiral(11))
    assert tr.images.shape == (20, 16, 16, 3)
    assert va.images.shape == (6, 16, 16, 3)
    d = np.linalg.norm(tr.ldirs[:, None] - va.ldirs[None], axis=-1)
    assert d.min() > 1e-3
    assert va.ldirs[:, 2].min() >= tr.ldirs[:, 2].min() - 1e-6
    assert va.ldirs[:, 2].max() <= tr.ldirs[:, 2].max() + 1e-6
    dp = np.linalg.norm(tr.poses[:, None] - va.poses[None], axis=(-2, -1))
    assert (dp.min(axis=0) < 1e-6).all()


# ---------------------------------------------------------------- PNG

def _smooth(H, W, C, dtype, seed=0):
    """An image whose rows make libpng's filters matter: ramps plus a
    little noise."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[:H, :W]
    base = np.stack([(x * 3 + y * 5 + c * 40) % 256 for c in range(C)], -1)
    base = base + rng.integers(0, 6, base.shape)
    top = 65535 if dtype == np.uint16 else 255
    return (base / 262.0 * top).astype(dtype)


def _cv2_rgb(path):
    """cv2.imread(IMREAD_UNCHANGED) then JAX's BGR -> RGB step."""
    img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if img.ndim == 3 and img.shape[-1] == 3:
        img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
    elif img.ndim == 3 and img.shape[-1] == 4:
        img = cv2.cvtColor(img, cv2.COLOR_BGRA2RGBA)
    return img


_FILTERS = {"none": cv2.IMWRITE_PNG_FILTER_NONE,
            "sub": cv2.IMWRITE_PNG_FILTER_SUB,
            "up": cv2.IMWRITE_PNG_FILTER_UP,
            "avg": cv2.IMWRITE_PNG_FILTER_AVG,
            "paeth": cv2.IMWRITE_PNG_FILTER_PAETH}


@pytest.mark.parametrize("filt", sorted(_FILTERS))
@pytest.mark.parametrize("channels", [1, 3, 4])
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_read_png_matches_cv2(tmp_path, dtype, channels, filt):
    """A PNG that cv2 writes (67 x 83, each row filter forced in turn) read
    by read_png: bit for bit cv2.imread(IMREAD_UNCHANGED) with JAX's
    BGR -> RGB, the same dtype and shape; png_size its header."""
    img = _smooth(67, 83, channels, dtype)
    img = img[..., 0] if channels == 1 else img
    path = str(tmp_path / "a.png")
    assert cv2.imwrite(path, img, [cv2.IMWRITE_PNG_FILTER, _FILTERS[filt]])
    _same(tio.read_png(path), _cv2_rgb(path))
    assert tio.png_size(path) == (67, 83)


def _pil_cases(tmp_path):
    from PIL import Image
    out = {}
    rgb = _smooth(50, 70, 3, np.uint8, seed=1)
    grey = _smooth(50, 70, 1, np.uint8, seed=2)[..., 0]
    for bits in (1, 2, 4, 8):
        im = Image.fromarray(rgb).quantize(colors=2 ** bits)
        out[f"palette{bits}"] = (im, {"bits": bits})
        out[f"palette{bits}_trns"] = (im, {"bits": bits, "transparency": 1})
    for bits in (1, 2, 4):
        out[f"grey{bits}"] = (Image.fromarray(grey, "L"), {"bits": bits})
    out["grey_alpha"] = (Image.fromarray(_smooth(50, 70, 2, np.uint8), "LA"),
                         {})
    out["grey_trns"] = (Image.fromarray(grey, "L"), {"transparency": 5})
    out["rgb_trns"] = (Image.fromarray(rgb, "RGB"),
                       {"transparency": (10, 20, 30)})
    return out


_PIL_CASES = ["palette1", "palette1_trns", "palette2", "palette2_trns",
              "palette4", "palette4_trns", "palette8", "palette8_trns",
              "grey1", "grey2", "grey4", "grey_alpha", "grey_trns",
              "rgb_trns"]


@pytest.mark.parametrize("case", _PIL_CASES)
def test_read_png_matches_cv2_on_pillow_pngs(tmp_path, case):
    """PNGs that Pillow writes (palettes at 1, 2, 4 and 8 bits with and
    without a tRNS chunk, grey at 1, 2 and 4 bits, grey + alpha, grey and
    RGB with a transparent colour): read_png bit for bit cv2's reading
    with JAX's BGR -> RGB."""
    im, kw = _pil_cases(tmp_path)[case]
    path = str(tmp_path / f"{case}.png")
    im.save(path, **kw)
    _same(tio.read_png(path), _cv2_rgb(path))


_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _write_adam7(path, img):
    """An Adam7-interlaced PNG (filter 0): neither cv2 nor Pillow writes
    one."""
    img = img[..., None] if img.ndim == 2 else img
    H, W, C = img.shape
    raw = b""
    for x0, y0, dx, dy in _ADAM7:
        sub = img[y0::dy, x0::dx]
        if sub.size == 0:
            continue
        rows = sub.astype(img.dtype.newbyteorder(">")).reshape(
            sub.shape[0], -1).view(np.uint8)
        raw += np.concatenate([np.zeros((len(rows), 1), np.uint8), rows],
                              1).tobytes()

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(
                    ">IIBBBBB", W, H, 8 * img.dtype.itemsize,
                    {1: 0, 3: 2, 4: 6}[C], 0, 0, 1))
                + chunk(b"IDAT", zlib.compress(raw))
                + chunk(b"IEND", b""))


@pytest.mark.parametrize("channels", [1, 3, 4])
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_read_png_adam7_matches_cv2(tmp_path, dtype, channels):
    """Adam7-interlaced PNGs (13 x 11, so some passes are narrow, and
    64 x 70): read_png bit for bit cv2 and the written pixels."""
    for H, W in ((13, 11), (64, 70)):
        img = _smooth(H, W, channels, dtype)
        img = img[..., 0] if channels == 1 else img
        path = str(tmp_path / f"i{H}.png")
        _write_adam7(path, img)
        _same(tio.read_png(path), _cv2_rgb(path))
        _same(tio.read_png(path), img)


def test_write_png_round_trip(tmp_path):
    """write_png (8 and 16 bits, grey, RGB, RGBA): read back by cv2 and by
    read_png as written; a float image or a bad file raises ValueError."""
    for dtype in (np.uint8, np.uint16):
        for C in (1, 3, 4):
            img = _smooth(21, 34, C, dtype)
            img = img[..., 0] if C == 1 else img
            path = str(tmp_path / "w.png")
            tio.write_png(path, img)
            _same(tio.read_png(path), img)
            _same(_cv2_rgb(path), img)
    with pytest.raises(ValueError):
        tio.write_png(str(tmp_path / "f.png"), np.zeros((4, 4), np.float32))
    (tmp_path / "bad.png").write_bytes(b"not a png at all")
    with pytest.raises(ValueError):
        tio.read_png(str(tmp_path / "bad.png"))


# -------------------------------------------------------------- resize

_SIZES = {"x2": (128, 96, 64, 48), "x4": (128, 96, 32, 24),
          "x3": (120, 90, 40, 30), "non_integer": (100, 75, 37, 29),
          "x2_odd_width": (130, 122, 65, 61)}


@pytest.mark.parametrize("size", sorted(_SIZES))
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.float32])
def test_resize_area_matches_cv2(dtype, size):
    """resize_area against cv2.resize(..., INTER_AREA) at downscales 2, 3,
    4, 2 with an odd output width and a non-integer size, 1, 3 and 4
    channels. uint8 and uint16 bit for bit; float32 within one f32 ulp
    (rtol 1.2e-7: the 2 x 2 float path's sum order follows cv2's 4-lane
    vectors, measured bit for bit with this cv2). An upscale of one axis
    is cv2's too (its linear branch: test_resize_area_upscale_matches_cv2
    holds the rest)."""
    h, w, H, W = _SIZES[size]
    rng = np.random.default_rng(7)
    for C in (1, 3, 4):
        if dtype == np.float32:
            img = rng.random((h, w, C)).astype(dtype)
        else:
            img = rng.integers(0, np.iinfo(dtype).max + 1,
                               (h, w, C)).astype(dtype)
        img = img[..., 0] if C == 1 else img
        got = tio.resize_area(img, H, W)
        want = cv2.resize(img, (W, H), interpolation=cv2.INTER_AREA)
        if dtype == np.float32:
            assert got.dtype == want.dtype and got.shape == want.shape
            np.testing.assert_allclose(got, want, rtol=1.2e-7, atol=0)
        else:
            _same(got, want, f"C{C}")
    grid = np.arange(64, dtype=np.uint8).reshape(8, 8) * 3
    _same(tio.resize_area(grid, 16, 8),
          cv2.resize(grid, (8, 16), interpolation=cv2.INTER_AREA))


# (h, w) -> (H, W): both axes up (x2, non-integer, one pixel more, far),
# one up and one down, widths below and past cv2's vector lengths
_UPSCALES = {"x2": (24, 32, 48, 64), "non_integer": (30, 41, 47, 97),
             "one_more": (63, 95, 64, 96), "x8": (4, 5, 32, 40),
             "rows_up_cols_down": (20, 30, 41, 15),
             "rows_down_cols_up": (30, 20, 10, 45),
             "rows_only": (16, 16, 17, 16), "narrow": (5, 2, 9, 3),
             "wide": (5, 100, 9, 400)}


@pytest.mark.parametrize("size", sorted(_UPSCALES))
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.float32])
def test_resize_area_upscale_matches_cv2(dtype, size):
    """resize_area where an axis enlarges against cv2.resize(...,
    INTER_AREA), which takes its linear branch with area-mode coefficients
    there: 1, 2, 3 and 4 channels (cv2's row pass has a vector path for
    each count), uint8 and uint16 bit for bit, float32 within one f32 ulp
    (rtol 1.2e-7, as the downscale; measured bit for bit with this
    cv2)."""
    h, w, H, W = _UPSCALES[size]
    rng = np.random.default_rng(11)
    for C in (1, 2, 3, 4):
        if dtype == np.float32:
            img = rng.random((h, w, C)).astype(dtype)
        else:
            img = rng.integers(0, np.iinfo(dtype).max + 1,
                               (h, w, C)).astype(dtype)
        img = img[..., 0] if C == 1 else img
        got = tio.resize_area(img, H, W)
        want = cv2.resize(img, (W, H), interpolation=cv2.INTER_AREA)
        if dtype == np.float32:
            assert got.dtype == want.dtype and got.shape == want.shape
            np.testing.assert_allclose(got, want, rtol=1.2e-7, atol=0)
        else:
            _same(got, want, f"C{C}")


# ---------------------------------------------------------------- DTU

def test_decompose_projection_matches_cv2():
    """decompose_projection against cv2.decomposeProjectionMatrix on
    projections K [R | -R C] (random K with a positive diagonal and skew,
    random rotations and centres, an overall positive scale): K / K[2, 2]
    within 1e-9 of cv2's, R within 1e-12, the centre (cv2's homogeneous
    null vector divided out) within 1e-9 relative."""
    from scipy.spatial.transform import Rotation
    rng = np.random.default_rng(3)
    for i in range(20):
        K = np.array([[rng.uniform(300, 900), rng.uniform(-2, 2),
                       rng.uniform(100, 400)],
                      [0, rng.uniform(300, 900), rng.uniform(100, 400)],
                      [0, 0, 1.0]])
        R = Rotation.random(random_state=i).as_matrix()
        C = rng.uniform(-3, 3, 3)
        P = rng.uniform(0.5, 3.0) * K @ np.concatenate(
            [R, -R @ C[:, None]], 1)
        Kt, Rt, Ct = tprov.decompose_projection(P)
        Kc, Rc, tc, *_ = cv2.decomposeProjectionMatrix(P)
        assert (np.diag(Kt) > 0).all()
        np.testing.assert_allclose(Kt / Kt[2, 2], Kc / Kc[2, 2], atol=1e-9,
                                   rtol=1e-12)
        np.testing.assert_allclose(Rt, Rc, atol=1e-12)
        np.testing.assert_allclose(Ct, (tc[:3] / tc[3])[:, 0], rtol=1e-9,
                                   atol=1e-12)


# ------------------------------------------------------------- loaders

def make_colmap_dataset(root, n_images=10, H=40, W=48, images_d=False):
    """tests/test_providers.py's COLMAP dataset (random LDR PNGs written by
    cv2, keypoints naming random points), plus an ``images_2`` folder of
    half-size PNGs when ``images_d``."""
    os.makedirs(os.path.join(root, "sparse", "0"), exist_ok=True)
    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    cams = {1: tcio.ColmapCamera(1, "PINHOLE", W, H,
                                 np.array([50.0, 50.0, W / 2, H / 2]))}
    tcio.write_cameras_binary(cams, os.path.join(root, "sparse/0/"
                                                 "cameras.bin"))
    rng = np.random.default_rng(0)
    images = {}
    for i in range(n_images):
        theta = 2 * np.pi * i / n_images
        eye = np.array([3 * np.cos(theta), 3 * np.sin(theta), 1.0])
        c2w_cv = tsyn.look_at_pose(eye, np.zeros(3)) @ np.diag(
            [1.0, -1.0, -1.0, 1.0])
        w2c = np.linalg.inv(c2w_cv)
        xys = rng.uniform(0, [W, H], (20, 2))
        pids = rng.integers(1, 50, 20).astype(np.int64)
        pids[:2] = -1
        images[i + 1] = tcio.ColmapImage(
            i + 1, tcio.rotmat_to_qvec(w2c[:3, :3]), w2c[:3, 3], 1,
            f"img_{i:03d}.png", xys, pids)
        img = rng.uniform(0, 255, (H, W, 3)).astype(np.uint8)
        cv2.imwrite(os.path.join(root, "images", f"img_{i:03d}.png"), img)
        if images_d:
            os.makedirs(os.path.join(root, "images_2"), exist_ok=True)
            cv2.imwrite(os.path.join(root, "images_2", f"img_{i:03d}.png"),
                        img[::2, ::2])
    # one image no keypoint of which names a point: the default range
    images[n_images].point3d_ids[:] = -1
    tcio.write_images_binary(images, os.path.join(root, "sparse/0/"
                                                  "images.bin"))
    pts = {k: tcio.ColmapPoint3D(k, rng.uniform(-1, 1, 3),
                                 rng.integers(0, 255, 3), rng.uniform(0.1, 2))
           for k in range(1, 50)}
    tcio.write_points3d_binary(pts, os.path.join(root, "sparse/0/"
                                                 "points3D.bin"))
    return root


_COLMAP_CASES = {
    "plain": {}, "cam_near_far": {"enable_cam_near_far": True},
    "reduce_set": {"reduce_set": True, "enable_cam_near_far": True},
    "downscale2_resized": {"downscale": 2},
    "downscale2_folder": {"downscale": 2},
    "cam_center_scale": {"enable_cam_center": True, "scale": 0.7},
}


@pytest.mark.parametrize("case", sorted(_COLMAP_CASES))
def test_load_colmap_scene_matches_jax(tmp_path, case):
    """load_colmap_scene for "train", "val" and "trainval" (the options of
    each case; downscale 2 from the full-size images resized by area, or
    from an images_2 folder): every SceneData field bit for bit JAX's.
    tests/test_providers.py::test_load_colmap_scene's checks hold."""
    root = make_colmap_dataset(str(tmp_path),
                               images_d=case == "downscale2_folder")
    jc, tc = _cfgs(path=root, data_format="colmap", **_COLMAP_CASES[case])
    for split in ("train", "val", "trainval"):
        j, t = _both(split, jc, tc, jprov.load_colmap_scene,
                     tprov.load_colmap_scene)
        _same_scene(t, j)
    train = t if split == "train" else tprov.load_colmap_scene(tc, "train")
    if case == "plain":
        val = tprov.load_colmap_scene(tc, "val")
        assert train.images.shape[1:] == (40, 48, 3)
        assert train.n_images + val.n_images == 10 and val.n_images == 2
        dist = np.linalg.norm(train.poses[:, :3, 3], axis=-1).mean()
        assert 0.5 < dist < 2.0
        fwd = -train.poses[:, :3, 2]
        to_origin = -train.poses[:, :3, 3]
        to_origin /= np.linalg.norm(to_origin, axis=-1, keepdims=True)
        assert np.mean((fwd * to_origin).sum(-1)) > 0.7
    if "near_far" in case or case == "reduce_set":
        assert train.cam_near_far is not None
        assert (train.cam_near_far[:, 1] >= train.cam_near_far[:, 0]).all()


@pytest.mark.parametrize("traj", ["circle", "interp"])
def test_load_colmap_test_trajectories_match_jax(tmp_path, traj):
    """The "test" split's trajectories (a circle of 100, Slerp between
    train poses): every SceneData field bit for bit JAX's."""
    root = make_colmap_dataset(str(tmp_path))
    jc, tc = _cfgs(path=root, data_format="colmap", camera_traj=traj)
    j, t = _both("test", jc, tc, jprov.load_colmap_scene,
                 tprov.load_colmap_scene, n_test=6)
    _same_scene(t, j)
    assert len(t.poses) == (100 if traj == "circle" else 28)


def _hdr_dataset(root, n_images=6, H=16, W=20, leds=None, pixel="HALF"):
    """A light-stage layout: the COLMAP model of make_colmap_dataset, EXR
    captures under raw/ (bracketed _e<micros> names, or one _l<led> name
    per LED of ``leds``; each a one-channel mosaic drawn from its name,
    written by chip_smoke.write_exr as `pixel` HALF with ZIP or FLOAT with
    ZIPS), mask PNGs and an LED calibration."""
    make_colmap_dataset(root, n_images=n_images, H=H, W=W)
    for sub in ("raw", "mask"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    rng = np.random.default_rng(4)
    for i in range(n_images):
        stem = f"img_{i:03d}"
        names = ([f"{stem}_e{exp}" for exp in jprov.BRACKETING_EXPOSURES]
                 if leds is None else [f"{stem}_l{led}" for led in leds])
        for name in names:
            path = os.path.join(root, "raw", name + ".exr")
            chip_smoke.write_exr(path, _mosaic(path), "ZIP" if pixel ==
                                 "HALF" else "ZIPS", pixel)
        mask = (rng.random((H, W)) > 0.3).astype(np.uint8) * 255
        cv2.imwrite(os.path.join(root, "mask", stem + ".png"), mask)
    trefl.write_light_dirs_calibration(
        os.path.join(root, "led_positions.txt"),
        rng.uniform(-1, 1, (5, 3)) + np.array([0.0, 0.0, 2.0]))
    return root


def _mosaic(path, H=32, W=40):
    """A capture's pixels: a mosaic drawn from its name."""
    seed = zlib.crc32(os.path.basename(path).encode())
    return np.random.default_rng(seed).uniform(0, 1.2, (H, W)).astype(
        np.float32)


def _written(path, pixel):
    """The array an EXR of _mosaic(path) holds: float16's values as
    float32 for HALF, the mosaic for FLOAT (what JAX's imageio or cv2
    branch returns for the file)."""
    m = _mosaic(path)
    return m.astype(np.float16).astype(np.float32) if pixel == "HALF" else m


_HDR_CASES = {
    "bracketing": dict(data=dict(bracketing=True, clip=True)),
    "bracketing_masked_mosaiced": dict(data=dict(
        bracketing=True, clip=True, masked=True, mosaiced=True)),
    "bracketing_exposed_half": dict(data=dict(
        bracketing=True, clip=True, expose=True), H=16),
    "rfield_replace": dict(data=dict(clip=True, r_mode="replace"),
                           rfield=True),
    "rfield_all": dict(data=dict(clip=True, r_mode="all", masked=True),
                       rfield=True),
}


def _check_hdr_case(tmp_path, monkeypatch, case, pixel):
    spec = _HDR_CASES[case]
    H = spec.get("H", 32)
    root = _hdr_dataset(str(tmp_path), H=H, W=H * 5 // 4,
                        leds=(0, 2, 3) if spec.get("rfield") else None,
                        pixel=pixel)
    monkeypatch.setattr(jnative, "_load", lambda: None)
    monkeypatch.setattr(tnative, "_load", lambda: None)
    monkeypatch.setattr(jio, "load_exr_image", lambda p: _written(p, pixel))
    jc, tc = _cfgs(path=root, data_format="colmap", image_mode="HDR",
                   enable_cam_near_far=True, **spec["data"])
    if spec.get("rfield"):
        jc = replace(jc, model=replace(jc.model, rfield=True))
        tc = replace(tc, model=replace(tc.model, rfield=True))
    for split in ("train", "val", "test"):
        j, t = _both(split, jc, tc, jprov.load_colmap_scene,
                     tprov.load_colmap_scene, n_test=4)
        _same_scene(t, j)
    train = tprov.load_colmap_scene(tc, "train")
    assert train.exposures is not None and train.images.shape[1] == H
    if spec.get("rfield"):
        assert train.ldirs is not None and train.ldirs.shape[1] == 3


@pytest.mark.parametrize("case", sorted(_HDR_CASES))
def test_load_colmap_hdr_branches_match_jax(tmp_path, monkeypatch, case):
    """The HDR branches of load_colmap_scene on EXR captures (HALF, ZIP)
    that the port reads from disk, while JAX's load_exr_image is
    monkeypatched to the array each file holds (tests/test_tools.py's
    device: no EXR backend here): bracketing (exposures from the _e
    names), the mask PNGs (JAX reads them with imageio, the port with
    read_png), the Bayer mosaic kept, exposing to sRGB, a mosaic at twice
    the size (the float area resize), and rfield (light directions from
    the calibration, one image per LED or every LED, the LEDs from the
    capture names), for train, val and test: every SceneData field bit
    for bit JAX's, with both packages' native libraries switched off
    (their numpy routes; test_native_numpy_forms holds the C++ routes
    against each other)."""
    _check_hdr_case(tmp_path, monkeypatch, case, "HALF")


@pytest.mark.parametrize("case", sorted(_HDR_CASES))
def test_load_colmap_hdr_float_exr_match_jax(tmp_path, monkeypatch, case):
    """test_load_colmap_hdr_branches_match_jax on FLOAT captures (ZIPS)."""
    _check_hdr_case(tmp_path, monkeypatch, case, "FLOAT")


_DNG_EXIF = {"AsShotNeutral": "0.4521 1 0.6738",
             "ColorMatrix2": "0.6722 -0.0635 -0.0963 -0.4287 1.2460 0.2028 "
                             "-0.0908 0.2162 0.5668",
             "BlackLevel": 512, "WhiteLevel": 16383}


def _dng_dataset(root, compression, n_images=6, H=16, W=20):
    """A RAW capture folder: the COLMAP model of make_colmap_dataset,
    raw/img_XXX.dng (a 2H x 2W RGGB mosaic of 14-bit counts above the
    black level, written by chip_smoke.write_dng: `compression` "lj92"
    or "none") with exiftool-style raw/img_XXX.json sidecars, and mask
    PNGs. Returns {path: the written counts}."""
    make_colmap_dataset(root, n_images=n_images, H=H, W=W)
    for sub in ("raw", "mask"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    rng = np.random.default_rng(8)
    written = {}
    for i in range(n_images):
        stem = os.path.join(root, "raw", f"img_{i:03d}")
        raw = rng.integers(0, 16383, (2 * H, 2 * W)).astype(np.uint16)
        raw[:4] = 300                         # some counts below black
        chip_smoke.write_dng(stem + ".dng", raw, compression,
                             black=_DNG_EXIF["BlackLevel"],
                             white=_DNG_EXIF["WhiteLevel"], tile=16)
        with open(stem + ".json", "w") as f:
            json.dump([dict(_DNG_EXIF, SourceFile=stem + ".dng")], f)
        written[stem + ".dng"] = raw
        mask = (rng.random((H, W)) > 0.3).astype(np.uint8) * 255
        cv2.imwrite(os.path.join(root, "mask", f"img_{i:03d}.png"), mask)
    return written


def _listing(folder, first_json):
    """os.listdir with the names of `folder` listed sidecars first
    (`first_json`) or images first: the file system's order decides
    which JAX's COLMAP loader sees first."""
    listdir = os.listdir

    def fake(path):
        names = listdir(path)
        if os.path.abspath(path) != os.path.abspath(folder):
            return names
        return sorted(names, key=lambda n: (n.endswith(".json")
                                            != first_json, n))
    return fake


@pytest.mark.parametrize("masked", [False, True], ids=["plain", "masked"])
@pytest.mark.parametrize("clip", [True, False], ids=["clip", "no_clip"])
@pytest.mark.parametrize("compression", ["lj92", "none"])
def test_load_colmap_dng_captures_match_jax(tmp_path, monkeypatch,
                                            compression, clip, masked):
    """RAW camera captures: DNG files (lossless JPEG tiles or
    uncompressed) with their .json sidecars, read by the port from disk
    while JAX's load_dng_raw is monkeypatched to the written counts (no
    rawpy here): cam2rgb from the sidecar, black and white from it when
    not clipping, the demosaic and the area resize from twice the size,
    the masks; train, val and test, every SceneData field bit for bit."""
    root = str(tmp_path)
    written = _dng_dataset(root, compression)
    monkeypatch.setattr(jnative, "_load", lambda: None)
    monkeypatch.setattr(tnative, "_load", lambda: None)
    monkeypatch.setattr(jio, "load_dng_raw",
                        lambda p: written[p].astype(np.float32))
    # the images listed first, the one listing JAX loads correctly
    # (test_listing_order_repair_skips_json_sidecars)
    monkeypatch.setattr(os, "listdir", _listing(os.path.join(root, "raw"),
                                                False))
    jc, tc = _cfgs(path=root, data_format="colmap", image_mode="HDR",
                   clip=clip, masked=masked)
    for split in ("train", "val", "test"):
        j, t = _both(split, jc, tc, jprov.load_colmap_scene,
                     tprov.load_colmap_scene, n_test=4)
        _same_scene(t, j)
    train = tprov.load_colmap_scene(tc, "train")
    assert train.images.shape[1:] == (16, 20, 3)
    assert all(n.endswith(".dng") for n in train.meta.filenames)
    assert len(train.meta.cam2rgb) == train.n_images


def test_listing_order_repair_skips_json_sidecars(tmp_path, monkeypatch):
    """A DNG folder whose listing puts a .json sidecar first: the port
    takes the images' extension from the sorted listing without the
    sidecars, and loads what JAX loads where JAX's first listed name is
    an image (the only listing it loads correctly); with the sidecar
    first, JAX's load names the sidecars as its images."""
    root = str(tmp_path)
    written = _dng_dataset(root, "lj92")
    monkeypatch.setattr(jnative, "_load", lambda: None)
    monkeypatch.setattr(tnative, "_load", lambda: None)
    monkeypatch.setattr(jio, "load_dng_raw",
                        lambda p: written[p.rsplit(".", 1)[0] + ".dng"]
                        .astype(np.float32))
    jc, tc = _cfgs(path=root, data_format="colmap", image_mode="HDR",
                   clip=False)
    raw_dir = os.path.join(root, "raw")
    monkeypatch.setattr(os, "listdir", _listing(raw_dir, False))
    np.random.seed(1)
    j = jprov.load_colmap_scene(jc, "train")
    monkeypatch.setattr(os, "listdir", _listing(raw_dir, True))
    assert os.listdir(raw_dir)[0].endswith(".json")
    np.random.seed(1)
    t = tprov.load_colmap_scene(tc, "train")
    _same_scene(t, j)
    np.random.seed(1)
    j_json = jprov.load_colmap_scene(jc, "train")
    assert all(n.endswith(".json") for n in j_json.meta.filenames)
    assert all(n.endswith(".dng") for n in t.meta.filenames)


def _nerf_dataset(root, style, with_hw=False, rgba=False):
    """A transforms.json dataset: "blender" (per-split files, the camera
    angle) or "colmap" (one file, focal lengths and centre); PNGs written
    by cv2 (RGBA when ``rgba``)."""
    rng = np.random.default_rng(5)
    frames = {"train": [], "val": [], "test": []}
    for i in range(12):
        split = ("train", "val", "test")[i % 3] if style == "blender" \
            else "train"
        pose = tsyn.look_at_pose(np.array([2.0, 0.2 * i, 1.0]), np.zeros(3))
        name = f"{split}/r_{i}"
        os.makedirs(os.path.join(root, split), exist_ok=True)
        img = rng.integers(0, 256, (24, 32, 4 if rgba else 3)).astype(
            np.uint8)
        cv2.imwrite(os.path.join(root, name + ".png"), img)
        frames[split].append({"file_path": name if i % 2 else name + ".png",
                              "transform_matrix": pose.tolist()})
    if style == "blender":
        for split, fr in frames.items():
            with open(os.path.join(root, f"transforms_{split}.json"),
                      "w") as f:
                json.dump({"camera_angle_x": 0.8, "frames": fr}, f)
    else:
        meta = {"fl_x": 30.0, "fl_y": 31.0, "cx": 15.0, "cy": 12.5,
                "frames": frames["train"]}
        if with_hw:
            meta.update(h=24, w=32)
        with open(os.path.join(root, "transforms.json"), "w") as f:
            json.dump(meta, f)
    return root


_NERF_CASES = {"blender": ("blender", False, False),
               "blender_rgba_half": ("blender", False, True),
               "colmap": ("colmap", False, False),
               "colmap_hw_half": ("colmap", True, False)}


@pytest.mark.parametrize("case", sorted(_NERF_CASES))
def test_load_nerf_scene_matches_jax(tmp_path, case):
    """load_nerf_scene on "blender" (per-split files, camera_angle_x, RGBA
    images, split "all" merging three files) and "colmap" style
    transforms.json (focal lengths and centre, with h / w or sized from
    the first image's header; every 8th image val; the "test" split's
    interpolated poses), at downscale 1 or 2: every SceneData field bit
    for bit JAX's. tests/test_providers.py::test_load_nerf_scene_blender's
    checks hold."""
    style, with_hw, half = _NERF_CASES[case]
    rgba = case == "blender_rgba_half"
    root = _nerf_dataset(str(tmp_path), style, with_hw, rgba)
    jc, tc = _cfgs(path=root, data_format="nerf", scale=0.8,
                   downscale=2 if half or with_hw else 1)
    splits = ("train", "val", "test", "all") if style == "blender" \
        else ("train", "val", "test")
    for split in splits:
        j, t = _both(split, jc, tc, jprov.load_nerf_scene,
                     tprov.load_nerf_scene)
        _same_scene(t, j)
    if case == "blender":
        scene = tprov.load_nerf_scene(tc, "train")
        assert scene.images.shape == (4, 24, 32, 3)
        assert scene.intrinsics[0] == pytest.approx(32 / (2 * np.tan(0.4)),
                                                    rel=1e-5)


def _dtu_dataset(root, n=9, H=30, W=40):
    """cameras_sphere.npz (world_mat_i = K [R | -R C], scale_mat_i a scale
    and shift) with image/*.png and mask/*.png written by cv2."""
    from scipy.spatial.transform import Rotation
    rng = np.random.default_rng(6)
    os.makedirs(os.path.join(root, "image"))
    os.makedirs(os.path.join(root, "mask"))
    mats = {}
    for i in range(n):
        K = np.array([[55.0, 0.1, W / 2], [0, 56.0, H / 2], [0, 0, 1]])
        R = Rotation.random(random_state=i).as_matrix()
        C = rng.uniform(-3, 3, 3)
        world = np.eye(4)
        world[:3] = 2.0 * K @ np.concatenate([R, -R @ C[:, None]], 1)
        scale = np.diag([1.5, 1.5, 1.5, 1.0])
        scale[:3, 3] = rng.uniform(-0.2, 0.2, 3)
        mats[f"world_mat_{i}"], mats[f"scale_mat_{i}"] = world, scale
        cv2.imwrite(os.path.join(root, "image", f"{i:03d}.png"),
                    rng.integers(0, 256, (H, W, 3)).astype(np.uint8))
        cv2.imwrite(os.path.join(root, "mask", f"{i:03d}.png"),
                    ((rng.random((H, W)) > 0.4) * 255).astype(np.uint8))
    np.savez(os.path.join(root, "cameras_sphere.npz"), **mats)
    return root


@pytest.mark.parametrize("downscale", [1, 2])
def test_load_dtu_scene_matches_jax(tmp_path, downscale):
    """load_dtu_scene (train, val, test, all): images, masks and splits bit
    for bit JAX's; the poses and intrinsics, decomposed with scipy's RQ
    where JAX calls cv2.decomposeProjectionMatrix, within 2 f32 ulps
    (rtol 2.4e-7, atol 1e-6 on entries near 0)."""
    root = _dtu_dataset(str(tmp_path))
    jc, tc = _cfgs(path=root, data_format="dtu", downscale=downscale)
    for split in ("train", "val", "test", "all"):
        j, t = _both(split, jc, tc, jprov.load_dtu_scene,
                     tprov.load_dtu_scene)
        for f in dataclasses.fields(j):
            vj, vt = getattr(j, f.name), getattr(t, f.name)
            if f.name in ("poses", "poses_gt", "intrinsics") \
                    and vj is not None:
                assert vt.dtype == vj.dtype and vt.shape == vj.shape
                np.testing.assert_allclose(vt, vj, rtol=2.4e-7, atol=1e-6,
                                           err_msg=f.name)
            elif f.name != "meta":
                if vj is None:
                    assert vt is None, f.name
                elif isinstance(vj, int):
                    assert vt == vj, f.name
                else:
                    _same(vt, vj, f.name)


@pytest.mark.parametrize("fmt", ["colmap", "nerf", "dtu", "synthetic"])
def test_load_scene_dispatch_matches_jax(tmp_path, fmt):
    """load_scene dispatches on data_format (the synthetic scene through
    the port's own make_synthetic_scene, HDR for image_mode HDR): the
    train and val SceneData as JAX's (DTU's poses and intrinsics within
    test_load_dtu_scene_matches_jax's 2 ulps, the rest bit for bit); an
    unknown format raises ValueError."""
    root = str(tmp_path)
    if fmt == "colmap":
        make_colmap_dataset(root)
    elif fmt == "nerf":
        _nerf_dataset(root, "blender")
    elif fmt == "dtu":
        _dtu_dataset(root)
    jc, tc = _cfgs(path=root, data_format=fmt)
    if fmt == "synthetic":
        jc = replace(jc, data=replace(jc.data, image_mode="HDR"))
        tc = replace(tc, data=replace(tc.data, image_mode="HDR"))
    for split in ("train", "val"):
        j, t = _both(split, jc, tc, jprov.load_scene, tprov.load_scene)
        if fmt == "dtu":
            for k in ("poses", "poses_gt"):
                np.testing.assert_allclose(getattr(t, k), getattr(j, k),
                                           rtol=2.4e-7, atol=1e-6)
            _same(t.images, j.images)
        else:
            _same_scene(t, j)
    with pytest.raises(ValueError):
        tprov.load_scene(replace(tc, data=replace(tc.data,
                                                  data_format="bogus")))


def test_trainer_trains_from_a_colmap_scene_on_disk(tmp_path):
    """A COLMAP scene written by the port's writers (chip_smoke's
    write_colmap_scene: PNGs, sparse surface points per view) loaded with
    enable_cam_near_far and trained by the CPU Trainer on the golden
    miniature: the scene's ranges reach the Trainer and every batch, the
    losses stay finite and fall, the val PSNR is finite."""
    from chip_smoke import write_colmap_scene
    train, val = tsyn.make_synthetic_scene(n_train=10, n_val=2, H=24,
                                           W=24, seed=0)
    images = np.concatenate([train.images, val.images])
    poses = np.concatenate([train.poses, val.poses])
    write_colmap_scene(str(tmp_path), images, poses, train.intrinsics)
    cfg = mini_cfg(tcfg)
    cfg = replace(cfg, data=replace(cfg.data, path=str(tmp_path),
                                    data_format="colmap", scale=1.0,
                                    enable_cam_near_far=True))
    np.random.seed(0)
    tr_scene = tprov.load_scene(cfg, "train")
    np.random.seed(0)
    va_scene = tprov.load_scene(cfg, "val")
    cnf = tr_scene.cam_near_far
    assert cnf.shape == (tr_scene.n_images, 2)
    assert (cnf[:, 0] > 0.5).all() and (cnf[:, 1] > cnf[:, 0]).all()
    tr = Trainer(cfg, tr_scene, va_scene, device="cpu",
                 workspace=str(tmp_path))
    np.testing.assert_array_equal(
        tr.scene_arrays["cam_near_far"].numpy(), cnf)
    losses = [float(tr.step()["loss"]) for _ in range(24)]
    assert np.isfinite(losses).all()
    assert np.mean(losses[-6:]) < np.mean(losses[:6])
    assert np.isfinite(tr.evaluate()["psnr"])


# ------------------------------------------------- the card's installation

_NO_IMAGE_LIBS = r"""
import sys
for name in ("cv2", "imageio", "rawpy", "PIL"):
    sys.modules[name] = None
import importlib, pkgutil
from dataclasses import replace
import numpy as np
import raw_ngp_torch
for m in pkgutil.walk_packages(raw_ngp_torch.__path__, "raw_ngp_torch."):
    importlib.import_module(m.name)
import chip_smoke
from raw_ngp_torch import Config
from raw_ngp_torch.data import image_io, load_scene
from raw_ngp_torch.data import jpeg
for root in sys.argv[1:]:
    for d in (1, 2):
        cfg = Config()
        cfg = replace(cfg, data=replace(cfg.data, path=root, scale=1.0,
                                        data_format="colmap", downscale=d,
                                        enable_cam_near_far=True))
        np.random.seed(0)
        s = load_scene(cfg, "train")
        print("LOADED", root[-3:], d, s.images.shape, s.cam_near_far.shape,
              float(s.images.max()))
        np.save(f"{root}/train_{d}.npy", s.images)
print("JPEG-ROUTE", "native" if jpeg._native_lib() is not None else "python")
bad = sorted(m for m in ("cv2", "imageio", "rawpy", "PIL")
             if sys.modules.get(m) is not None)
print("IMPORTED:" + ",".join(bad))
"""


def test_card_installation_loads_a_colmap_png_scene(tmp_path):
    """In a fresh interpreter where cv2, imageio, rawpy and PIL cannot be
    imported (the card's machine has none of them), every module of the
    port and chip_smoke import, and two COLMAP scenes written beforehand
    with the port's writers (chip_smoke.write_colmap_scene), one of PNGs
    and one of JPEGs (quality 95, cv2.imwrite's bytes), load at downscale
    1 and 2 (the area resize) with their per-camera ranges through the
    C++ JPEG route, their images bit for bit this interpreter's load."""
    from chip_smoke import write_colmap_scene
    train, val = tsyn.make_synthetic_scene(n_train=6, n_val=2, H=16, W=16,
                                           seed=0)
    roots = {fmt: tmp_path / fmt for fmt in ("png", "jpg")}
    for fmt, root in roots.items():
        write_colmap_scene(str(root), np.concatenate([train.images,
                                                      val.images]),
                           np.concatenate([train.poses, val.poses]),
                           train.intrinsics, image_format=fmt)
    assert sorted(os.listdir(roots["jpg"] / "images"))[0] == "img_000.jpg"
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", _NO_IMAGE_LIBS,
                          str(roots["png"]), str(roots["jpg"])], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    for fmt in roots:
        assert f"LOADED {fmt} 1 (7, 16, 16, 3) (7, 2)" in " ".join(lines), \
            lines
        assert any(l.startswith(f"LOADED {fmt} 2 (7, 8, 8, 3)")
                   for l in lines), lines
    assert "JPEG-ROUTE native" in lines and "IMPORTED:" in lines, lines
    cfg = tcfg.Config()
    for fmt, root in roots.items():
        for d in (1, 2):
            cfg = replace(cfg, data=replace(cfg.data, path=str(root),
                                            scale=1.0, data_format="colmap",
                                            downscale=d,
                                            enable_cam_near_far=True))
            np.random.seed(0)
            _same(np.load(root / f"train_{d}.npy"),
                  tprov.load_scene(cfg, "train").images, f"{fmt} {d}")

