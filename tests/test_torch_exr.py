"""The port's OpenEXR reader (raw_ngp_torch/data/exr.py) on the CPU.

This machine has no EXR library to hold the reader to (cv2 is built
without OpenEXR, imageio finds no EXR backend, and OpenEXR itself is not
installed), so the files are assembled byte by byte here from the
published file layout ("The OpenEXR File Layout", openexr.com): the magic
number and version field, the header's attributes, the offset table and
the chunks, each compression's bytes (NONE, RLE, ZIPS, ZIP, with
OpenEXR's byte predictor and even / odd split) written by this module's
own encoder, not by the port's or chip_smoke's writer. The half floats
are held to numpy's ``float16`` and the inflate to ``zlib``.

* ``read_exr`` bit for bit on every compression x pixel type (HALF,
  FLOAT, UINT) x channel set (Y, R, BGR, ABGR) x size (1 x 1, 17 x 23,
  and a height not a multiple of 16); HALF on all 65,536 bit patterns;
  a data window off the origin, DECREASING_Y and RANDOM_Y chunk orders,
  a chunk stored raw.
* ``chip_smoke.write_exr``'s files read back bit for bit.
* Each unsupported feature (PIZ, PXR24, B44, B44A, DWAA, DWAB; tiled,
  deep and multipart files; subsampled channels) raising
  NotImplementedError with its name, and a truncated file, another
  channel set and a file that is not OpenEXR raising ValueError.

The module runs on one torch and BLAS thread.
"""

import struct
import zlib

import numpy as np
import pytest
import torch

import chip_smoke
from raw_ngp_torch.data import exr
from raw_ngp_torch.data import image_io as tio

COMPRESSIONS = {"NONE": (0, 1), "RLE": (1, 1), "ZIPS": (2, 1),
                "ZIP": (3, 16)}
PIXELS = {"UINT": (0, "<u4"), "HALF": (1, "<f2"), "FLOAT": (2, "<f4")}
CHANNEL_SETS = {"Y": ("Y",), "R": ("R",), "BGR": ("B", "G", "R"),
                "ABGR": ("A", "B", "G", "R")}
SIZES = {"1x1": (1, 1), "17x23": (17, 23), "37x5": (37, 5)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch and BLAS thread (threadpoolctl, where present) for this
    module, set back after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        from threadpoolctl import threadpool_limits
    except ImportError:
        limits = None
    else:
        limits = threadpool_limits(limits=1)
    yield
    if limits is not None:
        limits.unregister()
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the test's encoder, from the file layout
# ---------------------------------------------------------------------------

def _attr(name, kind, value):
    return name.encode() + b"\0" + kind.encode() + b"\0" + \
        struct.pack("<i", len(value)) + value


def _predict(raw):
    """OpenEXR's ZIP / RLE preprocessing: even bytes then odd bytes, each
    stored as (byte - previous + 128) mod 256, in plain Python."""
    t = list(raw[0::2]) + list(raw[1::2])
    out = [t[0]] if t else []
    for i in range(1, len(t)):
        out.append((t[i] - t[i - 1] + 128) & 255)
    return bytes(out)


def _rle(data):
    """OpenEXR's rleCompress (RleCompressor.cpp): runs of at least 3
    equal bytes (at most 128) as (count - 1, byte), other stretches (at
    most 127) as (-count, bytes)."""
    out = bytearray()
    n, start = len(data), 0
    while start < n:
        end = start + 1
        while end < n and data[end] == data[start] and end - start < 128:
            end += 1
        if end - start >= 3:
            out += bytes([end - start - 1, data[start]])
            start = end
            continue
        end = start
        while end < n and end - start < 127 and not (
                end + 2 < n and data[end] == data[end + 1] == data[end + 2]):
            end += 1
        out += struct.pack("b", -(end - start)) + data[start:end]
        start = end
    return bytes(out)


def encode(channels, compression="ZIP", origin=(0, 0), order=0,
           raw_chunks=(), version_flags=0, attrs=(), sampling=(1, 1)):
    """An OpenEXR file of `channels` [(name, pixel type name, samples [H,
    W] as that type)] in the given order (the layout's order is sorted by
    name; the caller passes them sorted), `compression`, the data window
    at `origin`, line order `order` (0 increasing, 1 decreasing, 2 chunks
    in a shuffled order), the chunks whose indices are in `raw_chunks`
    stored raw, extra version flags and header attributes."""
    code, per = COMPRESSIONS.get(compression, (compression, 1))
    H, W = channels[0][2].shape
    x0, y0 = origin
    chlist = b"".join(name.encode() + b"\0" + struct.pack(
        "<iB3xii", PIXELS[ptype][0], 0, *sampling)
        for name, ptype, _ in channels) + b"\0"
    window = struct.pack("<4i", x0, y0, x0 + W - 1, y0 + H - 1)
    header = b"v/1\x01" + struct.pack("<I", 2 | version_flags) + \
        _attr("channels", "chlist", chlist) + \
        _attr("compression", "compression", bytes([code])) + \
        _attr("dataWindow", "box2i", window) + \
        _attr("displayWindow", "box2i", window) + \
        _attr("lineOrder", "lineOrder", bytes([min(order, 2)])) + \
        _attr("pixelAspectRatio", "float", struct.pack("<f", 1.0)) + \
        _attr("screenWindowCenter", "v2f", struct.pack("<2f", 0, 0)) + \
        _attr("screenWindowWidth", "float", struct.pack("<f", 1.0)) + \
        b"".join(_attr(*a) for a in attrs) + b"\0"
    chunks = []
    for k, y in enumerate(range(0, H, per)):
        raw = b"".join(np.ascontiguousarray(
            samples[line].astype(PIXELS[ptype][1])).tobytes()
            for line in range(y, min(y + per, H))
            for _, ptype, samples in channels)
        if k in raw_chunks or code == 0:
            packed = raw
        elif code == 1:
            packed = _rle(_predict(raw))
        else:
            packed = zlib.compress(_predict(raw), 9)
        if len(packed) >= len(raw):
            packed = raw
        chunks.append(struct.pack("<ii", y0 + y, len(packed)) + packed)
    if order == 1:
        chunks = chunks[::-1]
    elif order == 2:
        chunks = [chunks[i] for i in
                  np.random.default_rng(3).permutation(len(chunks))]
    offsets, at = [], len(header) + 8 * len(chunks)
    for c in chunks:
        offsets.append(at)
        at += len(c)
    return header + struct.pack(f"<{len(chunks)}Q", *offsets) + \
        b"".join(chunks)


def _samples(ptype, shape, rng):
    """Samples of a pixel type, every bit pattern possible: HALF and FLOAT
    drawn as raw bits (NaNs, infinities, subnormals and -0 included)."""
    if ptype == "HALF":
        return rng.integers(0, 1 << 16, shape).astype(np.uint16).view(
            np.float16)
    if ptype == "FLOAT":
        return rng.integers(0, 1 << 32, shape).astype(np.uint32).view(
            np.float32)
    return rng.integers(0, 1 << 32, shape).astype(np.uint32)


def _expected(samples):
    """What the reader must give for one channel's samples."""
    return samples.astype(np.float32)


def _same(a, b):
    """Bit for bit: dtype, shape and the float32 bits."""
    assert a.dtype == np.float32 and b.dtype == np.float32
    assert a.shape == b.shape, (a.shape, b.shape)
    np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))


def _want(channels):
    by_name = {n: _expected(s) for n, _, s in channels}
    if len(channels) == 1:
        return next(iter(by_name.values()))
    return np.stack([by_name[c] for c in "RGB"], -1)


# ---------------------------------------------------------------------------
# cases
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("size", sorted(SIZES))
@pytest.mark.parametrize("channels", sorted(CHANNEL_SETS))
@pytest.mark.parametrize("ptype", sorted(PIXELS))
@pytest.mark.parametrize("compression", sorted(COMPRESSIONS))
def test_read_exr_bitwise(tmp_path, compression, ptype, channels, size):
    """Every compression x pixel type x channel set x size: the data
    window's samples bit for bit (HALF through float16, UINT as its value
    in float32), [H, W] for one channel, [H, W, 3] RGB otherwise."""
    H, W = SIZES[size]
    rng = np.random.default_rng(zlib.crc32(
        f"{compression} {ptype} {channels} {size}".encode()))
    chans = [(name, ptype, _samples(ptype, (H, W), rng))
             for name in CHANNEL_SETS[channels]]
    if size != "1x1":
        # flat stretches, so the RLE and ZIP coders take their runs
        for _, _, s in chans:
            s[: H // 2] = s[0, 0]
    path = tmp_path / "a.exr"
    path.write_bytes(encode(chans, compression))
    got = exr.read_exr(str(path))
    _same(got, _want(chans))
    assert got.ndim == (2 if len(chans) == 1 else 3)


@pytest.mark.parametrize("compression", sorted(COMPRESSIONS))
def test_half_every_bit_pattern(tmp_path, compression):
    """All 65,536 HALF bit patterns in one 256 x 256 channel, through
    each compression, held to numpy's float16 -> float32 bit for bit."""
    bits = np.arange(1 << 16, dtype=np.uint16).reshape(256, 256)
    chans = [("Y", "HALF", bits.view(np.float16))]
    path = tmp_path / "h.exr"
    path.write_bytes(encode(chans, compression))
    got = exr.read_exr(str(path))
    _same(got, bits.view(np.float16).astype(np.float32))
    assert np.isnan(got).sum() == 2 * 1023
    assert np.isinf(got).sum() == 2


_LAYOUTS = {
    "window_off_origin": dict(origin=(-7, 13)),
    "decreasing_y": dict(order=1),
    "random_y": dict(order=2),
    "chunk_stored_raw": dict(raw_chunks=(0, 2)),
}


@pytest.mark.parametrize("compression", ["RLE", "ZIP", "ZIPS"])
@pytest.mark.parametrize("layout", sorted(_LAYOUTS))
def test_layouts(tmp_path, layout, compression):
    """A data window off the origin, decreasing and shuffled chunk orders
    (chunks are placed by their own y) and chunks stored raw among
    compressed ones: the same image."""
    rng = np.random.default_rng(7)
    H, W = 41, 19
    base = np.round(rng.normal(0, 1, (H, W, 3)) * 4) / 4
    chans = [(c, "HALF", base[..., "RGB".index(c)].astype(np.float16))
             for c in "BGR"]
    data = encode(chans, compression, **_LAYOUTS[layout])
    if layout == "chunk_stored_raw":
        # the raw chunks are stored raw where compressing them shrinks
        assert len(data) > len(encode(chans, compression))
    path = tmp_path / "l.exr"
    path.write_bytes(data)
    _same(exr.read_exr(str(path)), _want(chans))


def test_load_exr_image_reads_the_file(tmp_path):
    """image_io.load_exr_image is read_exr: a mosaic [H, W] float32."""
    rng = np.random.default_rng(1)
    mosaic = rng.uniform(0, 1.5, (24, 32)).astype(np.float16)
    path = tmp_path / "m.exr"
    path.write_bytes(encode([("Y", "HALF", mosaic)], "ZIP"))
    _same(tio.load_exr_image(str(path)), mosaic.astype(np.float32))


@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("pixel", ["HALF", "FLOAT"])
@pytest.mark.parametrize("compression", sorted(COMPRESSIONS))
def test_chip_smoke_writer_round_trips(tmp_path, compression, pixel,
                                       channels):
    """chip_smoke.write_exr's files (the card's phase writes its captures
    with it) read back bit for bit: HALF as float16 of the input."""
    rng = np.random.default_rng(5)
    shape = (35, 18) if channels == 1 else (35, 18, 3)
    img = rng.lognormal(-1, 2, shape).astype(np.float32)
    img[:10] = 0.25
    path = tmp_path / "w.exr"
    chip_smoke.write_exr(str(path), img, compression, pixel)
    want = img.astype(np.float16).astype(np.float32) if pixel == "HALF" \
        else img
    _same(exr.read_exr(str(path)), want)


_UNSUPPORTED = {
    "PIZ": dict(compression=4), "PXR24": dict(compression=5),
    "B44": dict(compression=6), "B44A": dict(compression=7),
    "DWAA": dict(compression=8), "DWAB": dict(compression=9),
    "tiled": dict(version_flags=exr.TILED),
    "deep": dict(version_flags=exr.DEEP),
    "multipart": dict(version_flags=exr.MULTIPART),
    "subsampled": dict(sampling=(2, 2)),
    "deepscanline": dict(attrs=[("type", "string", b"deepscanline")]),
}


@pytest.mark.parametrize("feature", sorted(_UNSUPPORTED))
def test_unsupported_features_raise_with_their_name(tmp_path, feature):
    chans = [("Y", "HALF", np.zeros((4, 4), np.float16))]
    path = tmp_path / "u.exr"
    kwargs = dict(_UNSUPPORTED[feature])
    compression = kwargs.pop("compression", "NONE")
    path.write_bytes(encode(chans, compression, **kwargs))
    with pytest.raises(NotImplementedError, match=feature):
        exr.read_exr(str(path))


def test_long_names_flag_is_read(tmp_path):
    chans = [("Y", "FLOAT", np.arange(6, dtype=np.float32).reshape(2, 3))]
    path = tmp_path / "n.exr"
    path.write_bytes(encode(chans, "ZIPS", version_flags=exr.LONG_NAMES))
    _same(exr.read_exr(str(path)), chans[0][2])


@pytest.mark.parametrize("cut", [6, 40, 200, -9, -1])
def test_truncated_file_raises(tmp_path, cut):
    rng = np.random.default_rng(2)
    chans = [("Y", "HALF", rng.normal(0, 1, (20, 20)).astype(np.float16))]
    data = encode(chans, "ZIP")
    path = tmp_path / "t.exr"
    path.write_bytes(data[:cut])
    with pytest.raises(ValueError, match="truncated|cut off|bytes"):
        exr.read_exr(str(path))


@pytest.mark.parametrize("names", [("G", "R"), ("B", "G", "R", "Z"),
                                   ("U", "V"), ("A", "Y")])
def test_other_channel_sets_raise(tmp_path, names):
    chans = [(n, "HALF", np.zeros((3, 3), np.float16)) for n in names]
    path = tmp_path / "c.exr"
    path.write_bytes(encode(chans, "NONE"))
    with pytest.raises(ValueError, match=repr(list(names)).replace(
            "[", r"\[").replace("]", r"\]")):
        exr.read_exr(str(path))


def test_not_an_exr_raises(tmp_path):
    path = tmp_path / "x.exr"
    path.write_bytes(b"\x89PNG\r\n\x1a\n" + bytes(40))
    with pytest.raises(ValueError, match="not an OpenEXR file"):
        exr.read_exr(str(path))
