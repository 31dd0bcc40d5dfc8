"""The port's DNG reader (raw_ngp_torch/data/dng.py, with the lossless
JPEG entropy decode of raw_ngp_torch/csrc/jpeg_host.cpp) on the CPU.

``read_dng_raw`` returns what ``rawpy.imread(f).raw_image`` gives: the
raw IFD's CFA samples, uncropped and unscaled. rawpy is not installed
here, so the reader is held to two independent writers:

* imageio's bundled tifffile (2018.06.15), which writes CFA pages with
  the DNG tags given as extra tags: uncompressed strips, deflate strips
  and deflate tiles with edge tiles, in either byte order, at 8 and 16
  bits; the samples come back bit for bit;
* lossless JPEG streams assembled here from ITU-T T.81 Annex H (the
  frame, the scan, each predictor's differences, the Huffman code of
  their categories, restart markers), for each predictor 1-7, precisions
  8, 12, 14 and 16 (SSSS 16 included), 1, 2 and 4 components and point
  transforms, decoded to their known samples by the C++ and the Python
  route alike (the C++ cases skip where the host library cannot build);
  at 8 bits and one component the same streams are also decoded by cv2's
  libjpeg-turbo, a decoder this repository did not write.

Packed samples of 1-16 bits (strips and tiles, either byte order,
uncompressed or deflated) are held to libtiff through cv2 (on a copy of
the file with Photometric 1: it leaves CFA pages to the caller; the
bundled tifffile's pure-Python unpack_ints refuses 10, 12 and 14 bits)
and to np.unpackbits; a LinearizationTable to LibRaw's curve,
table[min(s, len - 1)], after each compression.

``chip_smoke.write_dng``'s files (an 8-bit thumbnail in IFD0, the raw in
a SubIFD, uncompressed, packed or in lossless JPEG tiles, with or without
a LinearizationTable) read bit for bit by both routes, and every case the
reader leaves out raises with its name.
The module runs on one torch and BLAS thread.
"""

import struct
import zlib

import numpy as np
import pytest
import torch

import chip_smoke
from raw_ngp_torch import native
from raw_ngp_torch.data import dng
from raw_ngp_torch.data import image_io as tio

ROUTES = ("native", "python")
PREDICTORS = (1, 2, 3, 4, 5, 6, 7)
PRECISIONS = (8, 12, 14, 16)
NCOMP = (1, 2, 4)
DNG_TAGS = [(50706, "B", 4, (1, 4, 0, 0), True),   # DNGVersion
            (50714, "H", 1, 64, True),              # BlackLevel
            (50717, "H", 1, 4000, True),            # WhiteLevel
            (33421, "H", 2, (2, 2), True),          # CFARepeatPatternDim
            (33422, "B", 4, (0, 1, 1, 2), True)]    # CFAPattern


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


def _route(route):
    if route == "native" and native.jpeg_library() is None:
        pytest.skip("the host JPEG library does not build here (no g++)")
    return route


def _same(a, b):
    assert a.dtype == np.uint16 and a.shape == b.shape, (a.dtype, a.shape,
                                                         b.shape)
    np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# tifffile's files
# ---------------------------------------------------------------------------

_TIFF_LAYOUTS = {"strips_none": {},
                 "strips_deflate": dict(compress=6, rowsperstrip=7),
                 "tiles_deflate": dict(compress=6, tile=(32, 48))}


@pytest.mark.parametrize("bits", [8, 16])
@pytest.mark.parametrize("byteorder", ["<", ">"])
@pytest.mark.parametrize("layout", sorted(_TIFF_LAYOUTS))
def test_tifffile_cfa_pages_read_bitwise(tmp_path, layout, byteorder, bits):
    """A CFA page as tifffile writes it (the raw in IFD0, DNG tags as
    extra tags), 70 x 100 so that the tiles at the right and bottom edges
    are cropped: read_dng_raw gives the written samples back."""
    tf = pytest.importorskip("imageio.plugins._tifffile")
    rng = np.random.default_rng(bits)
    dtype = np.uint8 if bits == 8 else np.uint16
    raw = rng.integers(0, 1 << bits, (70, 100)).astype(dtype)
    raw[:20] = raw[0, 0]                    # something for deflate to find
    path = str(tmp_path / "t.dng")
    tf.imsave(path, raw, byteorder=byteorder, photometric="cfa",
              extratags=DNG_TAGS, **_TIFF_LAYOUTS[layout])
    with tf.TiffFile(path) as t:
        page = t.pages[0]
        assert page.photometric == 32803
        assert ("tile" in layout) == page.is_tiled
        np.testing.assert_array_equal(page.asarray(), raw)
    _same(dng.read_dng_raw(path), raw.astype(np.uint16))
    got = tio.load_dng_raw(path)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, raw.astype(np.float32))


# ---------------------------------------------------------------------------
# chip_smoke's writer: thumbnail IFD0, raw SubIFD
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("compression", ["none", "lj92"])
def test_chip_smoke_dng_read_bitwise(tmp_path, compression, route):
    """chip_smoke.write_dng (the card's phase writes its captures with
    it): IFD0 an 8-bit RGB thumbnail, the 16-bit raw in its SubIFD,
    uncompressed or in 256 x 256 lossless JPEG tiles (two components,
    predictor 1), 300 x 520 so that edge tiles are cropped."""
    rng = np.random.default_rng(11)
    raw = rng.integers(0, 1 << 14, (300, 520)).astype(np.uint16)
    raw[:30] = rng.integers(0, 1 << 16, (30, 520))   # SSSS up to 16
    raw[40:60] = 512
    path = str(tmp_path / f"{compression}.dng")
    chip_smoke.write_dng(path, raw, compression, black=512, white=16383)
    bo, ifds = dng.tiff_ifds(open(path, "rb").read())
    assert bo == "<" and len(ifds) == 2
    assert ifds[0][254] == (1,) and ifds[0][262] == (2,)
    assert ifds[1][254] == (0,) and ifds[1][262] == (32803,)
    assert ifds[1][50714] == (512,) and ifds[1][50717] == (16383,)
    _same(dng.read_dng_raw(path, _route(route)), raw)


# ---------------------------------------------------------------------------
# lossless JPEG streams from T.81 Annex H
# ---------------------------------------------------------------------------

# two Huffman tables of the 17 SSSS categories (code lengths 2-10 and
# 3-9; neither complete, so no code is all ones)
_TABLE_A = ((0, 2, 2, 2, 2, 2, 2, 2, 2, 1, 0, 0, 0, 0, 0, 0),
            bytes([0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15,
                   16]))
_TABLE_B = ((0, 0, 3, 4, 4, 3, 2, 1, 0, 0, 0, 0, 0, 0, 0, 0),
            bytes([16, 15, 14, 13, 12, 11, 10, 9, 8, 7, 6, 5, 4, 3, 2, 1,
                   0]))


def _codes(table):
    bits, symbols = table
    out, code, k = {}, 0, 0
    for length in range(1, 17):
        for _ in range(bits[length - 1]):
            out[symbols[k]] = (code, length)
            code, k = code + 1, k + 1
        code <<= 1
    return out


def _segment(marker, body):
    return bytes([0xFF, marker]) + struct.pack(">H", 2 + len(body)) + body


def lj92_stream(samples, precision, predictor, pt=0, restart_lines=0,
                two_tables=False, sof=0xC3, sampling=0x11, scan_comps=None,
                restart_mcus=None):
    """A lossless JPEG stream (T.81 process 14) of `samples` [Y, X, Nc]
    (values below 2^precision): the encoder's point transform (value >>
    pt), H.1.2.1's predictions (2^(P - Pt - 1) for the first sample of
    the first line and of the first line after each restart, Ra for the
    rest of that line, Rb for the first sample of every other line, the
    scan's predictor elsewhere), the differences modulo 2^16 coded as
    their SSSS category (table A, or A and B alternating by component)
    and SSSS extra bits (none for 16, the difference 32768), restart
    markers every `restart_lines` lines. Returns (stream, the samples
    the decoder must give [Y, X * Nc] uint16, the categories used)."""
    Y, X, nc = samples.shape
    v = (samples.astype(np.int64) >> pt).tolist()
    tables = [_TABLE_A, _TABLE_B] if two_tables else [_TABLE_A]
    codes = [_codes(t) for t in tables]
    acc, nacc, out = 0, 0, bytearray()

    def emit(value, n):
        nonlocal acc, nacc
        acc = (acc << n) | (value & ((1 << n) - 1))
        nacc += n
        while nacc >= 8:
            nacc -= 8
            byte = (acc >> nacc) & 0xFF
            out.append(byte)
            if byte == 0xFF:
                out.append(0)

    def flush():
        nonlocal nacc
        if nacc:
            emit((1 << (8 - nacc)) - 1, 8 - nacc)

    cats = set()
    first = True
    for y in range(Y):
        if restart_lines and y and y % restart_lines == 0:
            flush()
            out += bytes([0xFF, 0xD0 + (y // restart_lines - 1) % 8])
            first = True
        for x in range(X):
            for c in range(nc):
                if first:
                    px = (1 << (precision - pt - 1)) if x == 0 \
                        else v[y][x - 1][c]
                elif x == 0:
                    px = v[y - 1][x][c]
                else:
                    ra, rb, rc = v[y][x - 1][c], v[y - 1][x][c], \
                        v[y - 1][x - 1][c]
                    px = {1: ra, 2: rb, 3: rc, 4: ra + rb - rc,
                          5: ra + ((rb - rc) >> 1), 6: rb + ((ra - rc) >> 1),
                          7: (ra + rb) >> 1}[predictor]
                d = (v[y][x][c] - px) & 0xFFFF
                if d >= 32768:
                    d -= 65536
                t = 16 if d == -32768 else abs(d).bit_length()
                cats.add(t)
                code, n = codes[c % len(codes)][t]
                emit(code, n)
                if 0 < t < 16:
                    emit(d if d > 0 else d + (1 << t) - 1, t)
        first = False
    flush()
    comp_ids = list(range(1, nc + 1))
    dht = b"".join(bytes([k]) + bytes(t[0]) + t[1]
                   for k, t in enumerate(tables))
    sof_body = struct.pack(">BHHB", precision, Y, X, nc) + b"".join(
        bytes([i, sampling, 0]) for i in comp_ids)
    scan_ids = comp_ids if scan_comps is None else scan_comps
    sos = bytes([len(scan_ids)]) + b"".join(
        bytes([i, ((i - 1) % len(tables)) << 4]) for i in scan_ids) + \
        bytes([predictor, 0, pt])
    dri = b""
    if restart_lines or restart_mcus:
        dri = _segment(0xDD, struct.pack(
            ">H", restart_mcus or restart_lines * X))
    stream = b"\xff\xd8" + _segment(0xC4, dht) + dri + \
        _segment(sof, sof_body) + _segment(0xDA, sos) + bytes(out) + \
        b"\xff\xd9"
    want = ((np.array(v, np.int64) << pt) & 0xFFFF).astype(np.uint16)
    return stream, want.reshape(Y, X * nc), cats


def _lj92_samples(precision, nc, seed, Y=9, X=7):
    """Smooth samples with noise (every category small and large), the
    top of the range and a jump of 2^15 (SSSS 16) at 16 bits."""
    rng = np.random.default_rng(seed)
    top = (1 << precision) - 1
    yy, xx = np.mgrid[:Y, :X]
    base = (top / 2) * (1 + np.sin(xx / 2.0 + yy / 3.0))
    s = np.stack([base + rng.normal(0, top / 16, (Y, X)) * (c + 1)
                  for c in range(nc)], -1)
    s = np.clip(np.round(s), 0, top).astype(np.int64)
    s[Y - 1, X - 1] = top
    if precision == 16:
        s[0, 1] = (s[0, 0] + 32768) % 65536
    return s


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("nc", NCOMP)
@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("predictor", PREDICTORS)
def test_lj92_decodes_known_samples(predictor, precision, nc, route):
    """Each predictor x precision x component count: the decode gives the
    samples that were coded, components interleaved along each line."""
    samples = _lj92_samples(precision, nc, predictor * 100 + precision)
    stream, want, cats = lj92_stream(samples, precision, predictor,
                                     two_tables=nc > 1)
    if precision == 16:
        assert 16 in cats
    _same(dng.decode_lj92(stream, route=_route(route)), want)


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("case", ["restart_1", "restart_2_pt1",
                                  "restart_3_pt3_p7"])
def test_lj92_restart_and_point_transform(case, route):
    """Restart markers every 1, 2 or 3 lines (the first line after each is
    predicted as a first line) and point transforms 1 and 3."""
    lines, pt, pred = {"restart_1": (1, 0, 4), "restart_2_pt1": (2, 1, 6),
                       "restart_3_pt3_p7": (3, 3, 7)}[case]
    samples = _lj92_samples(14, 2, 9, Y=20, X=6)
    stream, want, _ = lj92_stream(samples, 14, pred, pt=pt,
                                  restart_lines=lines, two_tables=True)
    assert stream.count(b"\xff\xd0") >= 1
    _same(dng.decode_lj92(stream, route=_route(route)), want)


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("restart", [0, 1, 3])
@pytest.mark.parametrize("pt", [0, 2])
@pytest.mark.parametrize("predictor", PREDICTORS)
def test_lj92_matches_libjpeg_turbo(predictor, pt, restart, route):
    """An independent decoder: cv2's libjpeg-turbo (3.x decodes lossless
    JPEG at 8 bits) gives the same samples as the port and as the
    stream's own record, for every predictor, with restarts and a point
    transform, on one-component 8-bit streams."""
    cv2 = pytest.importorskip("cv2")
    samples = _lj92_samples(8, 1, predictor, Y=13, X=11)
    stream, want, _ = lj92_stream(samples, 8, predictor, pt=pt,
                                  restart_lines=restart)
    ref = cv2.imdecode(np.frombuffer(stream, np.uint8),
                       cv2.IMREAD_UNCHANGED)
    if ref is None:
        pytest.skip("this cv2 does not decode lossless JPEG")
    np.testing.assert_array_equal(ref, want.astype(np.uint8))
    _same(dng.decode_lj92(stream, route=_route(route)),
          ref.astype(np.uint16))


def test_lj92_routes_bitwise_on_a_large_stream():
    """The two routes on one 128 x 256 two-component stream at 16 bits."""
    _route("native")
    samples = _lj92_samples(16, 2, 3, Y=128, X=128)
    stream, want, _ = lj92_stream(samples, 16, 1, two_tables=True)
    a = dng.decode_lj92(stream, route="native")
    b = dng.decode_lj92(stream, route="python")
    _same(a, want)
    _same(b, a)


_LJ92_UNSUPPORTED = {
    "lossy JPEG": dict(sof=0xC0),
    "subsampled": dict(sampling=0x21),
    "several scans": dict(scan_comps=[1]),
    "not whole lines": dict(restart_mcus=5),
}


@pytest.mark.parametrize("what", sorted(_LJ92_UNSUPPORTED))
def test_lj92_unsupported_raise_with_their_name(what):
    samples = _lj92_samples(12, 2, 1, Y=4, X=4)
    stream, _, _ = lj92_stream(samples, 12, 1, **_LJ92_UNSUPPORTED[what])
    with pytest.raises(NotImplementedError, match=what):
        dng.decode_lj92(stream, route="python")


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("damage", ["truncated", "restart_marker"])
def test_lj92_corrupt_streams_raise(route, damage):
    samples = _lj92_samples(12, 1, 4, Y=8, X=16)
    stream, _, _ = lj92_stream(samples, 12, 1, restart_lines=2)
    if damage == "truncated":
        bad = stream[:len(stream) // 2]
    else:
        bad = stream.replace(b"\xff\xd1", b"\xff\xd5", 1)
    with pytest.raises(ValueError, match="corrupt DNG"):
        dng.decode_lj92(bad, route=_route(route))


# ---------------------------------------------------------------------------
# DNGs the reader leaves out
# ---------------------------------------------------------------------------

def _patch_raw_tag(data, tag, value):
    """chip_smoke.write_dng's file with the raw SubIFD's `tag` (one SHORT
    or LONG) set to `value`."""
    data = bytearray(data)
    ifd0 = struct.unpack("<I", data[4:8])[0]

    def entries(off):
        n = struct.unpack("<H", data[off:off + 2])[0]
        return [off + 2 + 12 * k for k in range(n)]

    sub = next(struct.unpack("<I", data[e + 8:e + 12])[0]
               for e in entries(ifd0)
               if struct.unpack("<H", data[e:e + 2])[0] == 330)
    for e in entries(sub):
        t, kind = struct.unpack("<HH", data[e:e + 4])
        if t == tag:
            data[e + 8:e + 12] = struct.pack(
                "<HH" if kind == 3 else "<I",
                *((value, 0) if kind == 3 else (value,)))
            return bytes(data)
    raise KeyError(tag)


def _small_dng(compression="none"):
    raw = np.random.default_rng(0).integers(0, 4096, (32, 48)).astype(
        np.uint16)
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        return chip_smoke.write_dng(f"{d}/s.dng", raw, compression,
                                    tile=32)


_DNG_UNSUPPORTED = {
    "LinearRaw": lambda: _patch_raw_tag(_small_dng(), 262, 34892),
    "lossy JPEG": lambda: _patch_raw_tag(_small_dng(), 259, 34892),
    "compression 5": lambda: _patch_raw_tag(_small_dng(), 259, 5),
    "BigTIFF": lambda: b"II+\x00" + bytes(60),
}
# once refused, now read: the 16-bit strip's bytes as 12-bit samples
_DNG_NOW_READ = {
    "packed 12-bit": lambda: _patch_raw_tag(_small_dng(), 258, 12),
}


def _unpack_reference(block, rows, cols, bits):
    """Samples of `bits` packed MSB first, rows on byte boundaries, by
    np.unpackbits and powers of two."""
    row_bytes = -(-cols * bits // 8)
    b = np.unpackbits(np.frombuffer(block, np.uint8, rows * row_bytes)
                      .reshape(rows, row_bytes), axis=1)[:, :cols * bits]
    return (b.reshape(rows, cols, bits).astype(np.int64)
            << np.arange(bits - 1, -1, -1)).sum(-1).astype(np.uint16)


@pytest.mark.parametrize("what", sorted(_DNG_UNSUPPORTED)
                         + sorted(_DNG_NOW_READ))
def test_dng_unsupported_raise_with_their_name(tmp_path, what):
    """What the reader leaves out raises NotImplementedError with its
    name; packed 12-bit samples, read since, come back as the strip's
    bytes unpacked 12 bits at a time."""
    path = tmp_path / "u.dng"
    data = (_DNG_UNSUPPORTED.get(what) or _DNG_NOW_READ[what])()
    path.write_bytes(data)
    if what in _DNG_NOW_READ:
        tags = dng.tiff_ifds(data)[1][1]
        at = tags[273][0]
        _same(dng.read_dng_raw(str(path)),
              _unpack_reference(data[at:at + tags[279][0]], 32, 48, 12))
        return
    with pytest.raises(NotImplementedError, match=what):
        dng.read_dng_raw(str(path))


@pytest.mark.parametrize("what", [
    "LinearizationTable", "Predictor", "SampleFormat-float16",
    "SampleFormat-float16-deflate", "SampleFormat-float32",
    "SampleFormat-float32-deflate"])
def test_tifffile_unsupported_raise_with_their_name(tmp_path, what):
    """Deflate with horizontal differencing (Predictor 2), as tifffile
    writes it, raises with its name; so does a float16 or float32 CFA
    page (SampleFormat 3), in strips or deflated, before any decode; a
    LinearizationTable (tag 50712) of 4 entries, refused before, now maps
    each sample s to table[min(s, 3)]."""
    tf = pytest.importorskip("imageio.plugins._tifffile")
    raw = np.arange(16 * 32, dtype=np.uint16).reshape(16, 32)
    path = str(tmp_path / "p.dng")
    if what.startswith("SampleFormat"):
        _, dtype, *deflate = what.split("-")
        tf.imsave(path, (raw / 512.0).astype(dtype), photometric="cfa",
                  extratags=DNG_TAGS, compress=6 if deflate else 0)
        with pytest.raises(NotImplementedError, match="SampleFormat"):
            dng.read_dng_raw(path)
        return
    if what == "LinearizationTable":
        table = np.array([0, 10, 20, 30], np.uint16)
        tf.imsave(path, raw, photometric="cfa", extratags=DNG_TAGS + [
            (50712, "H", 4, tuple(table), True)])
        _same(dng.read_dng_raw(path), table[np.minimum(raw, 3)])
        return
    tf.imsave(path, raw, photometric="cfa", extratags=DNG_TAGS,
              compress=6, predictor=True)
    with pytest.raises(NotImplementedError, match=what):
        dng.read_dng_raw(path)


# ---------------------------------------------------------------------------
# packed samples and the LinearizationTable
# ---------------------------------------------------------------------------

def packed_tiff(path, raw, bits, bo="<", photometric=32803, tile=None,
                rows_per_strip=None, deflate=False, table=None):
    """A one-IFD classic TIFF of `raw` [H, W] as `bits`-bit samples packed
    MSB first (each row of a strip or tile from a new byte): strips of
    `rows_per_strip` or `tile` (width, length) tiles padded with zeros,
    deflated where `deflate`; the CFA tags where `photometric` is 32803,
    tag 50712 where `table` is given. Returns the bytes."""
    H, W = raw.shape

    def pack(a):
        b = (a.astype(np.int64)[..., None] >> np.arange(bits - 1, -1, -1)) & 1
        return np.packbits(b.reshape(a.shape[0], -1).astype(np.uint8),
                           axis=1).tobytes()

    if tile:
        tw, tl = tile
        blocks = []
        for y in range(0, H, tl):
            for x in range(0, W, tw):
                t = np.zeros((tl, tw), np.int64)
                part = raw[y:y + tl, x:x + tw]
                t[:part.shape[0], :part.shape[1]] = part
                blocks.append(pack(t))
    else:
        per = rows_per_strip or H
        blocks = [pack(raw[y:y + per]) for y in range(0, H, per)]
    if deflate:
        blocks = [zlib.compress(b) for b in blocks]
    tags = [(256, 4, [W]), (257, 4, [H]), (258, 3, [bits]),
            (259, 3, [8 if deflate else 1]), (262, 3, [photometric]),
            (277, 3, [1])]
    if tile:
        tags += [(322, 4, [tile[0]]), (323, 4, [tile[1]]),
                 (324, 4, [0] * len(blocks)),
                 (325, 4, [len(b) for b in blocks])]
    else:
        tags += [(273, 4, [0] * len(blocks)), (278, 4, [per]),
                 (279, 4, [len(b) for b in blocks])]
    if photometric == 32803:
        tags += [(33421, 3, [2, 2]), (33422, 1, [0, 1, 1, 2]),
                 (50706, 1, [1, 4, 0, 0])]
    if table is not None:
        tags += [(50712, 3, [int(v) for v in table])]
    tags.sort()
    codes = {1: "B", 3: "H", 4: "I"}
    extra_at = 8 + 2 + 12 * len(tags) + 4
    sizes = [len(struct.pack(f"{bo}{len(v)}{codes[k]}", *v))
             for _, k, v in tags]
    at = extra_at + sum(n for n in sizes if n > 4)
    offsets = []
    for b in blocks:
        offsets.append(at)
        at += len(b)
    body, extra = b"", b""
    for tag, kind, values in tags:
        if tag in (273, 324):
            values = offsets
        payload = struct.pack(f"{bo}{len(values)}{codes[kind]}", *values)
        if len(payload) <= 4:
            field = payload.ljust(4, b"\0")
        else:
            field = struct.pack(bo + "I", extra_at + len(extra))
            extra += payload
        body += struct.pack(bo + "HHI", tag, kind, len(values)) + field
    head = (b"II*\0" if bo == "<" else b"MM\0*") + struct.pack(bo + "I", 8)
    data = head + struct.pack(bo + "H", len(tags)) + body + \
        struct.pack(bo + "I", 0) + extra + b"".join(blocks)
    with open(path, "wb") as f:
        f.write(data)
    return data


_PACKED_LAYOUTS = {"strips": dict(rows_per_strip=5),
                   "strips_deflate": dict(rows_per_strip=16, deflate=True),
                   "tiles": dict(tile=(16, 16)),
                   "tiles_deflate": dict(tile=(32, 16), deflate=True)}


@pytest.mark.parametrize("layout", sorted(_PACKED_LAYOUTS))
@pytest.mark.parametrize("byteorder", ["<", ">"])
@pytest.mark.parametrize("bits", [10, 12, 14])
def test_packed_samples_match_libtiff(tmp_path, bits, byteorder, layout):
    """10, 12 and 14-bit samples packed MSB first in strips or tiles
    (edge tiles cropped, rows from a new byte), little- and big-endian,
    uncompressed or deflated: read_dng_raw gives what libtiff (through
    cv2, on the same file with Photometric 1, since it leaves CFA pages
    to the caller) gives, shifted back from its 16 bits. (imageio's
    bundled tifffile refuses these sizes without its C extension.)"""
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(bits * 10 + len(layout))
    raw = rng.integers(0, 1 << bits, (37, 41)).astype(np.uint16)
    raw[:3] = (1 << bits) - 1
    path = str(tmp_path / "p.dng")
    packed_tiff(path, raw, bits, byteorder, **_PACKED_LAYOUTS[layout])
    grey = str(tmp_path / "p.tif")
    packed_tiff(grey, raw, bits, byteorder, photometric=1,
                **_PACKED_LAYOUTS[layout])
    ref = cv2.imread(grey, cv2.IMREAD_UNCHANGED)
    assert ref is not None and ref.dtype == np.uint16
    ref = ref >> (16 - bits)
    np.testing.assert_array_equal(ref, raw)
    _same(dng.read_dng_raw(path), ref)


@pytest.mark.parametrize("bits", [1, 2, 3, 5, 7, 9, 11, 13, 15])
def test_packed_odd_sizes(tmp_path, bits):
    """Every other packed size from 1 to 15 bits against the written
    samples and the np.unpackbits reference (rows of 13 samples end
    inside a byte)."""
    rng = np.random.default_rng(bits)
    raw = rng.integers(0, 1 << bits, (9, 13)).astype(np.uint16)
    path = str(tmp_path / "o.dng")
    data = packed_tiff(path, raw, bits, tile=(8, 8))
    _same(dng.read_dng_raw(path), raw)
    row_bytes = -(-8 * bits // 8)
    first = dng.tiff_ifds(data)[1][0][324][0]
    np.testing.assert_array_equal(
        _unpack_reference(data[first:first + 8 * row_bytes], 8, 8, bits),
        raw[:8, :8])


_TABLES = {"longer": lambda bits: chip_smoke.linearization_table(
    1 << bits, 16383),
    "shorter": lambda bits: np.arange(0, 3000, 7, dtype=np.uint16)[::-1]
    .copy()}


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("table", sorted(_TABLES))
@pytest.mark.parametrize("layout", ["packed12", "strips16_deflate",
                                    "lj92"])
def test_linearization_table_applies_after_decoding(tmp_path, layout, table,
                                                    route):
    """A LinearizationTable after packed 12-bit strips, deflated 16-bit
    strips and lossless JPEG tiles: each sample s becomes table[min(s,
    len - 1)], as LibRaw's curve (filled from the table and extended
    with its last entry) maps it; a table shorter than the largest sample
    (and not increasing) included."""
    rng = np.random.default_rng(len(layout) + len(table))
    bits = 12 if layout == "packed12" else 16
    raw = rng.integers(0, 1 << bits, (40, 56)).astype(np.uint16)
    lut = _TABLES[table](bits if bits == 12 else 12)
    path = str(tmp_path / "l.dng")
    if layout == "packed12":
        packed_tiff(path, raw, 12, table=lut, rows_per_strip=16)
    elif layout == "strips16_deflate":
        packed_tiff(path, raw, 16, bo=">", table=lut, rows_per_strip=16,
                    deflate=True)
    else:
        chip_smoke.write_dng(path, raw, "lj92", tile=32, table=lut)
    want = lut[np.minimum(raw, len(lut) - 1)]
    if table == "shorter":
        assert raw.max() >= len(lut)
    _same(dng.read_dng_raw(path, _route(route)), want)


@pytest.mark.parametrize("table", [False, True], ids=["plain", "table"])
@pytest.mark.parametrize("bits", [12, 14])
def test_chip_smoke_packed_dng_read_bitwise(tmp_path, bits, table):
    """chip_smoke.write_dng's packed strips (the card's dng phase writes
    12- and 14-bit captures) with and without its LinearizationTable
    (linearization_table, the stored samples from linearize_inverse):
    the table's values at the stored samples, within half a step of the
    counts."""
    rng = np.random.default_rng(bits)
    counts = rng.integers(512, 16384, (30, 44))
    path = str(tmp_path / "c.dng")
    if table:
        lut = chip_smoke.linearization_table(1 << bits, 16383)
        stored = chip_smoke.linearize_inverse(lut, counts)
        want = lut[stored]
        step = np.diff(lut.astype(np.int64)).max()
        assert np.abs(want.astype(np.int64) - counts).max() <= step // 2 + 1
    else:
        stored = want = (counts >> (14 - bits)).astype(np.uint16)
    chip_smoke.write_dng(path, stored, "none", bits=bits,
                         table=lut if table else None)
    assert dng.tiff_ifds(open(path, "rb").read())[1][1][258] == (bits,)
    _same(dng.read_dng_raw(path), want.astype(np.uint16))


@pytest.mark.parametrize("damage", ["not_tiff", "no_cfa", "cut"])
def test_dng_corrupt_files_raise(tmp_path, damage):
    data = _small_dng()
    if damage == "not_tiff":
        data = b"PK" + data[2:]
    elif damage == "no_cfa":
        data = _patch_raw_tag(data, 262, 2)
    else:
        data = data[:len(data) - 100]
    path = tmp_path / "c.dng"
    path.write_bytes(data)
    with pytest.raises(ValueError, match="TIFF|CFA|DNG"):
        dng.read_dng_raw(str(path))
