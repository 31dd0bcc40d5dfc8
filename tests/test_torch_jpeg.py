"""The port's JPEG decoder and encoder (raw_ngp_torch/data/jpeg.py, with
its C++ entropy coder raw_ngp_torch/csrc/jpeg_host.cpp) against cv2
(built with libjpeg-turbo) on the CPU, and the port's JPEG loads against
the JAX package's.

* The decoder, bit for bit against ``cv2.imread(IMREAD_UNCHANGED)`` with
  the channels reversed, on a matrix of files written by cv2 and by
  Pillow (both libjpeg-turbo): qualities 50, 75, 90, 95, 100; samplings
  4:4:4, 4:2:2, 4:2:0, 4:1:1, 4:4:0 and grey; progressive, optimised
  Huffman tables, restart intervals 1 and 3; sizes 1 x 1, 7 x 13, 17 x 1
  and 67 x 93. Every case through both routes, the C++ entropy decode
  and the pure-Python one (a machine without g++).
* The cases that raise: NotImplementedError for arithmetic, lossless and
  12-bit files, CMYK, and a progressive file cut after its first scan;
  ValueError for truncated files (where cv2 returns None).
* The encoder, byte for byte against ``cv2.imencode(".jpg", bgr,
  [IMWRITE_JPEG_QUALITY, q])``, both routes; its progressive form
  (spectral selection) decoded alike by cv2 and the port.
* ``image_io.load_ldr_image`` on JPEG files against
  ``raw_ngp_tpu.data.image_io.load_ldr_image`` at the file's size, at
  half size and at an upscale, bit for bit in float32.

The module runs on one torch, BLAS and OpenMP thread, and cv2 on one.
"""

import io

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

from raw_ngp_torch import native
from raw_ngp_torch.data import image_io as tio
from raw_ngp_torch.data import jpeg
from raw_ngp_tpu.data import image_io as jio

ROUTES = ("native", "python")
SAMPLING = {"444": 0x111111, "422": 0x211111, "420": 0x221111,
            "411": 0x411111, "440": 0x121111}
PIL_SUBSAMPLING = {"444": 0, "422": 1, "420": 2}
SIZES = ((1, 1), (7, 13), (17, 1), (67, 93))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch, BLAS and OpenMP thread (threadpoolctl, where present)
    and one cv2 thread for this module, set back after it."""
    n, n_cv2 = torch.get_num_threads(), cv2.getNumThreads()
    torch.set_num_threads(1)
    cv2.setNumThreads(1)
    try:
        from threadpoolctl import threadpool_limits
    except ImportError:
        limits = None
    else:
        limits = threadpool_limits(limits=1)
    yield
    if limits is not None:
        limits.unregister()
    cv2.setNumThreads(n_cv2)
    torch.set_num_threads(n)


def _image(h, w, grey=False, seed=0):
    """A smooth pattern with noise: every DCT frequency in use."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h, :w]
    base = np.stack([128 + 100 * np.sin(xx / 7.0 + c) * np.cos(yy / 5.0 - c)
                     for c in range(3)], -1)
    img = np.clip(base + rng.normal(0, 25, (h, w, 3)), 0, 255).astype(
        np.uint8)
    return img[..., 0] if grey else img


def _cv2_jpeg(img, quality, sampling=None, variant="baseline"):
    params = [cv2.IMWRITE_JPEG_QUALITY, quality]
    if sampling is not None:
        params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling]]
    if variant == "progressive":
        params += [cv2.IMWRITE_JPEG_PROGRESSIVE, 1]
    elif variant == "optimized":
        params += [cv2.IMWRITE_JPEG_OPTIMIZE, 1]
    elif variant.startswith("restart"):
        params += [cv2.IMWRITE_JPEG_RST_INTERVAL, int(variant[7:])]
    ok, buf = cv2.imencode(".jpg", img if img.ndim == 2 else img[..., ::-1],
                           params)
    assert ok
    return buf.tobytes()


def _pil_jpeg(img, quality, sampling, progressive):
    f = io.BytesIO()
    kw = {"quality": quality, "progressive": progressive,
          "optimize": progressive}
    if img.ndim == 3:
        kw["subsampling"] = PIL_SUBSAMPLING[sampling]
    Image.fromarray(img).save(f, "JPEG", **kw)
    return f.getvalue()


def _cv2_decode(data):
    img = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_UNCHANGED)
    if img is None:
        return None
    return img if img.ndim == 2 else np.ascontiguousarray(img[..., ::-1])


def _matrix():
    cases = []
    for h, w in SIZES:
        for sampling in ("444", "422", "420", "411", "440", "grey"):
            for q in (50, 75, 90, 95, 100):
                cases.append(("cv2", h, w, q, sampling, "baseline"))
            for q in (75, 95):
                for variant in ("progressive", "optimized", "restart1",
                                "restart3"):
                    cases.append(("cv2", h, w, q, sampling, variant))
                if sampling in PIL_SUBSAMPLING or sampling == "grey":
                    for variant in ("baseline", "progressive"):
                        cases.append(("pil", h, w, q, sampling, variant))
    return cases


def _case_id(case):
    writer, h, w, q, sampling, variant = case
    return f"{writer}-{h}x{w}-q{q}-{sampling}-{variant}"


def _case_bytes(case):
    writer, h, w, q, sampling, variant = case
    img = _image(h, w, grey=sampling == "grey", seed=h * 1000 + w + q)
    if writer == "pil":
        return _pil_jpeg(img, q, sampling, variant == "progressive")
    return _cv2_jpeg(img, q, None if sampling == "grey" else sampling,
                     variant)


def test_jpeg_library_builds():
    """csrc/jpeg_host.cpp builds with g++ into build/raw_ngp_torch/ under
    a name keyed by the source's hash, and loads."""
    lib = native.jpeg_library()
    assert lib is not None and lib.jpeg_host_version() == 1
    so = native.library_path(native.JPEG_SOURCE)
    assert so.exists() and so.name.startswith("libjpeg_host-")


@pytest.mark.parametrize("case", _matrix(), ids=_case_id)
def test_decoder_matches_cv2(case):
    """read_jpeg's pixels are cv2's (channels reversed) bit for bit,
    through the C++ and the Python entropy decode."""
    data = _case_bytes(case)
    want = _cv2_decode(data)
    for route in ROUTES:
        got = jpeg.decode_jpeg(data, _case_id(case), route=route)
        assert got.dtype == np.uint8 and got.shape == want.shape, route
        np.testing.assert_array_equal(got, want, err_msg=route)


def _first_scan_only(data):
    """The file cut at the marker that ends its first scan, then EOI."""
    sos = data.index(b"\xff\xda")
    pos = sos + 2 + int.from_bytes(data[sos + 2:sos + 4], "big")
    while not (data[pos] == 0xFF and data[pos + 1] not in
               (0x00, 0xFF, *range(0xD0, 0xD8))):
        pos += 1
    return data[:pos] + b"\xff\xd9"


def _with_sof(data, code=None, precision=None):
    sof = data.index(b"\xff\xc0")
    out = bytearray(data)
    if code is not None:
        out[sof + 1] = code
    if precision is not None:
        out[sof + 4] = precision
    return bytes(out)


def _cmyk():
    f = io.BytesIO()
    Image.fromarray(_image(16, 16)).convert("CMYK").save(f, "JPEG")
    return f.getvalue()


_UNSUPPORTED = {
    "arithmetic_sof9": lambda d: _with_sof(d, code=0xC9),
    "lossless_sof3": lambda d: _with_sof(d, code=0xC3),
    "hierarchical_sof5": lambda d: _with_sof(d, code=0xC5),
    "precision_12": lambda d: _with_sof(d, precision=12),
    "cmyk": lambda d: _cmyk(),
    "progressive_first_scan_only": lambda d: _first_scan_only(
        _cv2_jpeg(_image(24, 40), 90, "420", "progressive")),
}


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("kind", sorted(_UNSUPPORTED))
def test_unsupported_files_raise(kind, route):
    """NotImplementedError naming the file for what the port does not
    decode."""
    data = _UNSUPPORTED[kind](_cv2_jpeg(_image(24, 40), 90, "420"))
    with pytest.raises(NotImplementedError, match="x.jpg"):
        jpeg.decode_jpeg(data, "x.jpg", route=route)


_TRUNCATED = {"half": lambda d: d[:len(d) // 2],
              "no_eoi": lambda d: d[:-2],
              "in_header": lambda d: d[:100]}


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("kind", sorted(_TRUNCATED))
@pytest.mark.parametrize("variant", ["baseline", "progressive",
                                     "restart3"])
def test_truncated_files_raise(variant, kind, route):
    """A truncated file raises ValueError naming the file; cv2 returns
    None on it (so JAX's load raises too)."""
    data = _TRUNCATED[kind](_cv2_jpeg(_image(40, 56), 90, "420", variant))
    assert _cv2_decode(data) is None
    with pytest.raises(ValueError, match="t.jpg"):
        jpeg.decode_jpeg(data, "t.jpg", route=route)


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("size", [(1, 1), (7, 13), (17, 1), (1, 17),
                                  (17, 17), (67, 93)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("grey", [False, True], ids=["rgb", "grey"])
def test_encoder_bytes_match_cv2(grey, size, route):
    """encode_jpeg's bytes are cv2.imencode's at qualities 1-100 (dummy
    blocks at the right and bottom edges where the size is not a whole
    MCU), through the C++ and the Python entropy coder."""
    h, w = size
    for q in (1, 50, 75, 90, 95, 100):
        img = _image(h, w, grey=grey, seed=q)
        want = _cv2_jpeg(img, q)
        assert jpeg.encode_jpeg(img, q, route=route) == want, q


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("grey", [False, True], ids=["rgb", "grey"])
def test_progressive_writer(grey, route):
    """encode_jpeg(progressive=True) writes the baseline file's
    coefficients by spectral selection (SOF2, a DC scan, an AC scan a
    component): cv2 decodes it, and the port's decode of it is cv2's and
    the baseline file's, at sizes with dummy blocks."""
    for h, w in ((17, 1), (17, 17), (67, 93)):
        img = _image(h, w, grey=grey, seed=w)
        data = jpeg.encode_jpeg(img, 90, route, progressive=True)
        assert data[data.index(b"\xff\xc2") + 1] == 0xC2
        got = jpeg.decode_jpeg(data, "p.jpg", route)
        np.testing.assert_array_equal(got, _cv2_decode(data))
        np.testing.assert_array_equal(
            got, jpeg.decode_jpeg(jpeg.encode_jpeg(img, 90), "b.jpg", route))


def test_write_and_read_files(tmp_path):
    """write_jpeg writes cv2.imwrite's file (default quality 95), read_jpeg
    and image_io read it by its signature (also under a .png name, as cv2
    does), and image_size reads the size from the header alone."""
    img = _image(37, 54)
    path = str(tmp_path / "a.jpg")
    jpeg.write_jpeg(path, img)
    cv2.imwrite(str(tmp_path / "b.jpg"), img[..., ::-1])
    assert open(path, "rb").read() == open(tmp_path / "b.jpg", "rb").read()
    want = _cv2_decode(open(path, "rb").read())
    np.testing.assert_array_equal(jpeg.read_jpeg(path), want)
    (tmp_path / "c.png").write_bytes(open(path, "rb").read())
    assert tio.image_format(str(tmp_path / "c.png")) == "JPEG"
    np.testing.assert_array_equal(tio._read_rgb(str(tmp_path / "c.png")),
                                  want)
    assert tio.image_size(path) == (37, 54) == jpeg.jpeg_size(path)
    with pytest.raises(ValueError):
        jpeg.write_jpeg(path, img.astype(np.uint16))


_LOADS = {"420": dict(sampling="420"), "444": dict(sampling="444"),
          "grey": dict(grey=True), "progressive": dict(
              sampling="420", variant="progressive")}


@pytest.mark.parametrize("kind", sorted(_LOADS))
@pytest.mark.parametrize("size", ["same", "half", "upscale", "mixed"])
def test_load_ldr_image_matches_jax(tmp_path, kind, size):
    """The port's load_ldr_image on a JPEG file is JAX's (cv2.imread, BGR
    -> RGB, cv2.resize INTER_AREA) bit for bit in float32: at the file's
    size, at half size, at an upscale (51 x 77 -> 64 x 96) and where one
    axis grows while the other shrinks."""
    opts = dict(_LOADS[kind])
    grey = opts.pop("grey", False)
    img = _image(51, 77, grey=grey, seed=3)
    path = str(tmp_path / "v.jpg")
    with open(path, "wb") as f:
        f.write(_cv2_jpeg(img, 90, opts.get("sampling"),
                          opts.get("variant", "baseline")))
    H, W = {"same": (51, 77), "half": (25, 38), "upscale": (64, 96),
            "mixed": (70, 40)}[size]
    got = tio.load_ldr_image(path, H, W)
    want = jio.load_ldr_image(path, H, W)
    assert got.dtype == want.dtype == np.float32
    assert got.shape == want.shape == (H, W, 3)
    np.testing.assert_array_equal(got, want)
