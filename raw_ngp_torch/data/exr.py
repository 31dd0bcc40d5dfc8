"""OpenEXR without a library: the files that cv2's and imageio's OpenEXR
(``InputFile``) read, as a light stage writes its captures.

:func:`read_exr` returns a float32 array of the data window: [H, W] for one
channel, [H, W, 3] in RGB order for R, G, B (an A channel is dropped, as
the JAX package's cv2 branch drops it; ``alpha=True`` asks for [H, W, 4]
RGBA, as cv2.imread(IMREAD_UNCHANGED) reads it) and for a luminance-chroma
file's Y, RY and BY (converted to RGB as cv2's EXR decoder converts
them). It reads the layout of the OpenEXR file format ("The OpenEXR File
Layout", openexr.com):

* the magic number ``76 2f 31 01`` and a version field whose low byte is
  2; its flags mark a single-part tiled file (0x200), long names (0x400,
  which need nothing), deep data (0x800) or several parts (0x1000);
* each header's attributes (``name\\0type\\0``, an int32 size, the value)
  up to a null byte, of which ``channels`` (chlist: pixel type, pLinear,
  x and y sampling), ``compression``, ``dataWindow`` (box2i),
  ``lineOrder``, ``tiles`` (tiledesc), ``type``, ``chunkCount`` and
  ``chromaticities`` are read. A multipart file holds a header a part
  and an empty header after the last; its parts' offset tables follow in
  order, and each of its chunks starts with its part's number. Part 0 is
  read, as ``InputFile`` reads it; the other parts' chunks are not
  decoded;
* scanline parts: one uint64 offset a chunk, each chunk an int32 y, an
  int32 size and the data: line by line, each channel's row in the
  header's (alphabetical) order, little-endian. A channel sampled every
  xs-th column and ys-th line has a row only on the lines y with y % ys
  == 0, of W / xs samples; the codecs that store planes (PIZ, B44, DWA)
  store its samples in the chunk, ny rows of W / xs. As OpenEXR's header
  check requires, the data window's corner and size are multiples of
  every channel's sampling, and a tiled part samples every channel at
  1. Tiled parts (the ``tiles`` attribute: the tile size, ONE_LEVEL,
  MIPMAP_LEVELS or RIPMAP_LEVELS and ROUND_DOWN or ROUND_UP) give level
  (0, 0), whose tiles come first in the offset table of every level
  mode; a tile chunk is its int32 tile x, tile y, level x and level y,
  an int32 size and the tile's data laid out as a scanline chunk of the
  tile's (edge-cropped) width. Chunks are placed by their own
  coordinates, so every line order reads the same image;
* the compressions NONE (1 line a chunk), RLE (1), ZIPS (1), ZIP (16),
  PIZ (32), PXR24 (16), B44 (32), B44A (32), DWAA (32) and DWAB (256); a
  tile is one chunk. A chunk whose size is not below its uncompressed
  size is stored raw.

  - ZIP and ZIPS are zlib's inflate; RLE is a signed count byte, -n then n
    literal bytes, n >= 0 then one byte repeated n + 1 times. Both are
    then undone in numpy: the predictor (``t[i] = t[i-1] + t[i] - 128``
    mod 256, a cumulative sum) and the split into even and odd bytes (the
    first ceil(n / 2) bytes are the even positions).
  - PXR24 inflates byte planes: for each line and channel the differences
    of successive samples (from 0 at the line's start), big-endian, one
    plane a byte: HALF 2 planes and UINT 4 (both lossless), FLOAT 3, the
    float's top 24 bits (its low byte 0 on decode).
  - B44 and B44A store each HALF channel of a chunk as 4 x 4 blocks
    (edge blocks padded by repeating the last line and column), each 14
    bytes (the first transformed value t0, a 6-bit shift and 15 6-bit
    differences of the t = ordered half bits) or, where byte 2 is at least
    13 << 2, 3 bytes (one value for the whole block, B44A's flat block);
    the values are exact given the stored bits. A channel marked pLinear
    goes through the exponential table B44 defines, ``half(exp(h / 8))``
    of each half h (0 for a non-finite h, HALF_MAX at and above 8 ln
    HALF_MAX), computed here from that formula. FLOAT and UINT channels
    are stored raw, little-endian; every channel's data is the chunk's
    lines of that channel, channel after channel.
  - PIZ: the bitmap of the 16-bit values used (the bytes from min to max
    nonzero byte), whose ordered set is the reverse LUT; the Huffman
    stream (im, iM, the table's length, the stream's bits; the code
    lengths as 6-bit fields, 59-62 a run of 2-5 unused symbols and 63 plus
    8 bits a run of 6-261; canonical codes, shorter codes numerically
    higher; the symbol iM followed by 8 bits repeats the last value that
    many times); the 2-D Haar-like wavelet of each channel's values (of
    each 16-bit half of a FLOAT or UINT sample), in its 14-bit form where
    the LUT's largest index is below 2^14 and else in its 16-bit modular
    form; the LUT applied; the channels' planes put back into lines. The
    Huffman decode is the one serial loop: it runs in C++
    (``piz_huf_decode`` in ``raw_ngp_torch/csrc/exr_host.cpp``,
    :func:`raw_ngp_torch.native.exr_library`) and, where that library
    does not build, in the pure Python of this module, its oracle: both
    give the same values. ``route`` picks one as in ``data/dng.py``.
  - DWAA and DWAB: the lossy DCT codec of ``data/exr_dwa.py``, whose
    docstring gives its layout (the AC stream's Huffman decode and run
    expansion are its serial loops, in the same C++ library and in
    Python by ``route``).

HALF samples go through numpy's ``float16``, bit for bit (infinities,
NaNs, -0 and subnormals included); FLOAT samples are copied bit for bit;
UINT samples are their value as float32.

Subsampled channels come back at the data window's size, each sample
repeated over its xs x ys pixels (cv2's ExrDecoder::UpSample). A file of
Y, RY and BY (luminance and chroma, the chroma often at 2 x 2) reads as
cv2's ExrDecoder::ChromaToBGR makes it, in float64 from the float32
samples: R = (RY + 1) Y, B = (BY + 1) Y, G = (Y - B wb - R wr) / wg, the
weights (wr, wg, wb) the y coordinates of the header's ``chromaticities``
(Rec. 709's, 0.33, 0.6 and 0.06, where it has none), then float32; Y
alone reads as one channel.

Departures, each raising with the file and its name:
``NotImplementedError`` for deep data; ``ValueError`` for a file that is
not OpenEXR, is cut short or is inconsistent (a subsampled channel in a
tiled part, or a data window that its sampling does not divide, among
them), and for a channel set other than one channel, R, G, B or Y, RY,
BY (each with or without A).

:func:`write_exr` writes a float32 image as ``cv2.imwrite`` writes one
through OpenCV's OpenEXR encoder.
"""

from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

MAGIC = b"v/1\x01"
TILED, LONG_NAMES, DEEP, MULTIPART = 0x200, 0x400, 0x800, 0x1000

# pixel types: (name, numpy dtype of a little-endian sample)
PIXEL_TYPES = {0: ("UINT", "<u4"), 1: ("HALF", "<f2"), 2: ("FLOAT", "<f4")}
UINT, HALF, FLOAT = 0, 1, 2
# compression codes: (name, scanlines a chunk) for the ones read
COMPRESSIONS = {0: ("NONE", 1), 1: ("RLE", 1), 2: ("ZIPS", 1), 3: ("ZIP", 16),
                4: ("PIZ", 32), 5: ("PXR24", 16), 6: ("B44", 32),
                7: ("B44A", 32), 8: ("DWAA", 32), 9: ("DWAB", 256)}
DWA_CODES = (8, 9)
LINE_ORDERS = {0: "INCREASING_Y", 1: "DECREASING_Y", 2: "RANDOM_Y"}
LEVEL_MODES = {0: "ONE_LEVEL", 1: "MIPMAP_LEVELS", 2: "RIPMAP_LEVELS"}
ROUNDING_MODES = {0: "ROUND_DOWN", 1: "ROUND_UP"}
PART_TYPES = ("scanlineimage", "tiledimage")
DEEP_TYPES = ("deepscanline", "deeptile")

# B44: byte 2 of a block at or above this marks a 3-byte flat block
B44_FLAT = 13 << 2
HUF_ERRORS = {1: "the Huffman stream ends early", 2: "a malformed Huffman "
              "code table", 3: "an undefined Huffman code",
              4: "the Huffman stream decodes to the wrong number of values"}
# the chromaticities attribute's default: Rec. 709's red, green, blue and
# white (x, y), as float32 (Imf::Chromaticities())
REC709 = tuple(float(np.float32(v)) for v in (
    0.64, 0.33, 0.30, 0.60, 0.15, 0.06, 0.3127, 0.3290))


def _cut(path, what):
    return ValueError(f"{path}: truncated OpenEXR file ({what})")


def _bad(path, what):
    return ValueError(f"{path}: corrupt OpenEXR file ({what})")


class _Corrupt(Exception):
    def __init__(self, code):
        super().__init__(code)
        self.code = code


@dataclass
class Part:
    """One part's header: its channels [(name, pixel type, pLinear)] in
    file order, compression, data window (x0, y0, x1, y1), line order,
    tiles ((width, height, level mode, rounding mode) or None), chunkCount
    (None where absent), each channel's (x, y) sampling (None: all 1) and
    the chromaticities (red, green, blue and white x, y; None where
    absent)."""
    channels: List[Tuple[str, int, bool]]
    compression: int
    data_window: Tuple[int, int, int, int]
    line_order: int = 0
    tiles: Optional[Tuple[int, int, int, int]] = None
    chunk_count: Optional[int] = None
    sampling: Optional[List[Tuple[int, int]]] = None
    chromaticities: Optional[Tuple[float, ...]] = None

    @property
    def samplings(self) -> List[Tuple[int, int]]:
        return self.sampling or [(1, 1)] * len(self.channels)

    @property
    def size(self) -> Tuple[int, int]:
        x0, y0, x1, y1 = self.data_window
        return y1 - y0 + 1, x1 - x0 + 1


def _cstring(data: bytes, pos: int, path: str) -> Tuple[str, int]:
    end = data.find(b"\0", pos)
    if end < 0:
        raise _cut(path, "a header name runs past the end")
    return data[pos:end].decode("latin-1"), end + 1


def _read_chlist(value: bytes, path: str
                 ) -> List[Tuple[str, int, bool, int, int]]:
    """The channels of a chlist value: (name, pixel type, pLinear, x
    sampling, y sampling) in file order."""
    out, pos = [], 0
    while True:
        if pos >= len(value):
            raise ValueError(f"{path}: OpenEXR channel list without its "
                             "closing null byte")
        if value[pos] == 0:
            return out
        name, pos = _cstring(value, pos, path)
        if pos + 16 > len(value):
            raise ValueError(f"{path}: OpenEXR channel {name!r} is cut off")
        ptype, linear, xs, ys = struct.unpack("<iB3xii", value[pos:pos + 16])
        pos += 16
        if ptype not in PIXEL_TYPES:
            raise ValueError(f"{path}: OpenEXR channel {name!r} has pixel "
                             f"type {ptype} (0 UINT, 1 HALF, 2 FLOAT)")
        if xs < 1 or ys < 1:
            raise ValueError(f"{path}: OpenEXR channel {name!r} has "
                             f"sampling {xs} x {ys}")
        out.append((name, ptype, bool(linear), xs, ys))


def _read_attributes(data: bytes, pos: int, path: str) -> Tuple[Dict, int]:
    """One header's attributes that the reader uses, and the position
    after its null byte."""
    header = {}
    while True:
        if pos >= len(data):
            raise _cut(path, "the header has no end")
        if data[pos] == 0:
            return header, pos + 1
        name, pos = _cstring(data, pos, path)
        kind, pos = _cstring(data, pos, path)
        if pos + 4 > len(data):
            raise _cut(path, f"attribute {name!r}")
        size = struct.unpack("<i", data[pos:pos + 4])[0]
        pos += 4
        if size < 0 or pos + size > len(data):
            raise _cut(path, f"attribute {name!r}")
        value = data[pos:pos + size]
        pos += size
        if name == "channels" and kind == "chlist":
            chlist = _read_chlist(value, path)
            header["channels"] = [c[:3] for c in chlist]
            header["sampling"] = [c[3:] for c in chlist]
        elif name == "compression" and kind == "compression" and size == 1:
            header["compression"] = value[0]
        elif name == "dataWindow" and kind == "box2i" and size == 16:
            header["data_window"] = struct.unpack("<4i", value)
        elif name == "lineOrder" and kind == "lineOrder" and size == 1:
            header["line_order"] = value[0]
        elif name == "tiles" and kind == "tiledesc" and size == 9:
            tw, th, mode = struct.unpack("<IIB", value)
            header["tiles"] = (tw, th, mode & 15, mode >> 4)
        elif name == "type" and kind == "string":
            header["type"] = value.rstrip(b"\0").decode("latin-1")
        elif name == "chunkCount" and kind == "int" and size == 4:
            header["chunk_count"] = struct.unpack("<i", value)[0]
        elif name == "chromaticities" and kind == "chromaticities" and \
                size == 32:
            header["chromaticities"] = struct.unpack("<8f", value)


def _part(header: Dict, tiled: bool, path: str) -> Part:
    """Part 0's header checked: a scanline or tiled image of a known
    compression, line order and level mode, with a data window and
    channels."""
    kind = header.get("type")
    if kind in DEEP_TYPES:
        raise NotImplementedError(f"{path}: an OpenEXR part of type {kind!r}"
                                  " (deep data) is not read")
    if kind is not None and kind not in PART_TYPES:
        raise ValueError(f"{path}: an OpenEXR part of unknown type "
                         f"{kind!r}")
    if kind is not None:
        tiled = kind == "tiledimage"
    for key, attr in (("channels", "channels"),
                      ("compression", "compression"),
                      ("data_window", "dataWindow")) + (
                          (("tiles", "tiles"),) if tiled else ()):
        if key not in header:
            raise ValueError(f"{path}: OpenEXR header without {attr!r}")
    code = header["compression"]
    if code not in COMPRESSIONS:
        raise ValueError(f"{path}: OpenEXR compression {code} is not "
                         "defined")
    order = header.setdefault("line_order", 0)
    if order not in LINE_ORDERS:
        raise ValueError(f"{path}: OpenEXR line order {order} is not "
                         "defined")
    x0, y0, x1, y1 = header["data_window"]
    if x1 < x0 or y1 < y0:
        raise ValueError(f"{path}: empty OpenEXR data window "
                         f"{header['data_window']}")
    if not header["channels"]:
        raise ValueError(f"{path}: OpenEXR file without channels")
    tiles = header.get("tiles") if tiled else None
    if tiles is not None:
        tw, th, mode, rounding = tiles
        if tw < 1 or th < 1 or mode not in LEVEL_MODES or \
                rounding not in ROUNDING_MODES:
            raise ValueError(f"{path}: OpenEXR tile description {tiles}")
    sampling = header["sampling"]
    for (name, _, _), (xs, ys) in zip(header["channels"], sampling):
        if (xs, ys) == (1, 1):
            continue
        if tiled:
            raise ValueError(f"{path}: OpenEXR channel {name!r} of a tiled "
                             f"part is subsampled ({xs} x {ys}); OpenEXR "
                             "samples a tiled part's channels at 1")
        if x0 % xs or y0 % ys or (x1 - x0 + 1) % xs or (y1 - y0 + 1) % ys:
            raise ValueError(f"{path}: OpenEXR channel {name!r} is sampled "
                             f"{xs} x {ys}, which does not divide the data "
                             f"window {header['data_window']}")
    if all(s == (1, 1) for s in sampling):
        sampling = None
    return Part(header["channels"], code, header["data_window"], order,
                tiles, header.get("chunk_count"), sampling,
                header.get("chromaticities"))


def read_header(data: bytes, path: str = "<bytes>"
                ) -> Tuple[Part, int, bool]:
    """Part 0 of an OpenEXR file, the position of its offset table and
    whether the file is multipart."""
    if data[:4] != MAGIC:
        raise ValueError(f"{path}: not an OpenEXR file")
    if len(data) < 8:
        raise _cut(path, "the version field")
    version = struct.unpack("<I", data[4:8])[0]
    if version & 0xFF != 2:
        raise ValueError(f"{path}: OpenEXR version {version & 0xFF} (2 "
                         "only)")
    if version & ~(0xFF | TILED | LONG_NAMES | DEEP | MULTIPART):
        raise ValueError(f"{path}: unknown OpenEXR version flags "
                         f"{version:#x}")
    multipart = bool(version & MULTIPART)
    if version & DEEP and not multipart:
        raise NotImplementedError(f"{path}: a deep OpenEXR file is not read")
    if multipart and version & TILED:
        raise ValueError(f"{path}: an OpenEXR file flagged both multipart "
                         "and single-part tiled")
    first, pos = _read_attributes(data, 8, path)
    if multipart:
        if not first:
            raise ValueError(f"{path}: a multipart OpenEXR file without "
                             "parts")
        while True:
            if pos >= len(data):
                raise _cut(path, "the header list has no end")
            if data[pos] == 0:
                pos += 1
                break
            _, pos = _read_attributes(data, pos, path)
        if "type" not in first or "chunk_count" not in first:
            raise ValueError(f"{path}: a multipart OpenEXR part without "
                             "'type' or 'chunkCount'")
    return _part(first, bool(version & TILED), path), pos, multipart


# ---------------------------------------------------------------------------
# tiles
# ---------------------------------------------------------------------------

def _round_log2(x: int, rounding: int) -> int:
    y, up = 0, 0
    while x > 1:
        up |= x & 1
        y += 1
        x >>= 1
    return y + (up if rounding else 0)


def _level_size(size: int, level: int, rounding: int) -> int:
    n = size >> level
    if rounding and n << level < size:
        n += 1
    return max(n, 1)


def tile_levels(part: Part) -> List[Tuple[int, int, int, int]]:
    """The levels of a tiled part in offset-table order: (level x, level
    y, tiles across, tiles down)."""
    H, W = part.size
    tw, th, mode, rounding = part.tiles
    if mode == 0:
        levels = [(0, 0)]
    elif mode == 1:
        levels = [(l, l) for l in range(_round_log2(max(W, H), rounding)
                                        + 1)]
    else:
        levels = [(lx, ly) for ly in range(_round_log2(H, rounding) + 1)
                  for lx in range(_round_log2(W, rounding) + 1)]
    return [(lx, ly, -(-_level_size(W, lx, rounding) // tw),
             -(-_level_size(H, ly, rounding) // th)) for lx, ly in levels]


def chunk_count(part: Part) -> int:
    """The number of chunks of a part: its offset table's length."""
    if part.tiles is None:
        return -(-part.size[0] // COMPRESSIONS[part.compression][1])
    return sum(nx * ny for _, _, nx, ny in tile_levels(part))


# ---------------------------------------------------------------------------
# the byte codecs: ZIP / ZIPS / RLE
# ---------------------------------------------------------------------------

def _rle_decode(packed: bytes, size: int, path: str) -> np.ndarray:
    """OpenEXR's run-length code: a signed count byte, -n then n literal
    bytes, n >= 0 then one byte repeated n + 1 times."""
    out = bytearray()
    pos, n = 0, len(packed)
    while pos < n:
        count = packed[pos] - 256 if packed[pos] > 127 else packed[pos]
        pos += 1
        if count < 0:
            if pos - count > n:
                raise _cut(path, "an RLE run")
            out += packed[pos:pos - count]
            pos -= count
        else:
            if pos >= n:
                raise _cut(path, "an RLE run")
            out += packed[pos:pos + 1] * (count + 1)
            pos += 1
    if len(out) != size:
        raise ValueError(f"{path}: an RLE chunk decodes to {len(out)} "
                         f"bytes, not {size}")
    return np.frombuffer(bytes(out), np.uint8)


def _unpredict(t: np.ndarray) -> np.ndarray:
    """Undoes the ZIP / RLE byte predictor and the even / odd split."""
    x = t.copy()
    x[1:] += np.uint8(128)            # t[i] - 128 mod 256
    x = np.cumsum(x, dtype=np.uint8)
    out = np.empty_like(x)
    half = (len(x) + 1) // 2
    out[0::2] = x[:half]
    out[1::2] = x[half:]
    return out


def _inflate(packed: bytes, size: int, what: str, path: str) -> bytes:
    try:
        raw = zlib.decompress(packed)
    except zlib.error as e:
        raise ValueError(f"{path}: a {what} chunk does not inflate ({e})"
                         ) from e
    if len(raw) != size:
        raise ValueError(f"{path}: a {what} chunk inflates to {len(raw)} "
                         f"bytes, not {size}")
    return raw


def _zip_rle(packed: bytes, size: int, code: int, path: str) -> np.ndarray:
    if code == 1:
        t = _rle_decode(packed, size, path)
    else:
        t = np.frombuffer(_inflate(packed, size, "ZIP", path), np.uint8)
    return _unpredict(t)


# ---------------------------------------------------------------------------
# PXR24
# ---------------------------------------------------------------------------

_PXR24_BYTES = {UINT: 4, HALF: 2, FLOAT: 3}


def _pxr24(packed: bytes, types: List[int], shapes, present,
           path: str) -> List[np.ndarray]:
    """Each channel's samples [rows, samples a row] (uint16 or uint32
    bits) of a PXR24 chunk."""
    planes = [_PXR24_BYTES[t] for t in types]
    row_bytes = [nb * nx for nb, (_, nx) in zip(planes, shapes)]
    raw = _inflate(packed, sum(ny * r for (ny, _), r in zip(shapes,
                                                             row_bytes)),
                   "PXR24", path)
    rows = _split_rows(np.frombuffer(raw, np.uint8), row_bytes, shapes,
                       present)
    out = []
    for ptype, nb, (lines, width), buf in zip(types, planes, shapes, rows):
        b = buf.reshape(lines, nb, width).astype(np.uint32)
        diff = np.zeros((lines, width), np.uint32)
        for k in range(nb):
            diff = (diff << np.uint32(8)) | b[:, k]
        if ptype == FLOAT:
            diff <<= np.uint32(8)
        vals = np.cumsum(diff, axis=1, dtype=np.uint32)
        out.append(vals.astype(np.uint16) if ptype == HALF else vals)
    return out


# ---------------------------------------------------------------------------
# B44 / B44A
# ---------------------------------------------------------------------------

_B44_EXP: Optional[np.ndarray] = None


def b44_exp_table() -> np.ndarray:
    """B44's expTable, uint16 [65536]: for each half h the bits of
    half(exp(h / 8)), 0 for a non-finite h and HALF_MAX where h >= 8 ln
    HALF_MAX (the float32 arithmetic of OpenEXR's generator)."""
    global _B44_EXP
    if _B44_EXP is None:
        h = np.arange(1 << 16, dtype=np.uint32).astype(np.uint16).view(
            np.float16).astype(np.float32)
        with np.errstate(over="ignore", invalid="ignore"):
            e = np.exp((h / np.float32(8)).astype(np.float64)).astype(
                np.float32).astype(np.float16).view(np.uint16)
        top = np.float32(8) * np.log(np.float32(65504.0))
        e = np.where(h >= top, np.uint16(0x7BFF), e)
        _B44_EXP = np.where(np.isfinite(h), e, np.uint16(0)).astype(
            np.uint16)
    return _B44_EXP


def _b44_starts(packed: bytes, pos: int, n: int, path: str
                ) -> Tuple[np.ndarray, int]:
    """The offsets of `n` consecutive B44 blocks from `pos` (3 bytes where
    byte 2 is at least 13 << 2, else 14) and the position after them."""
    starts = np.empty(n, np.int64)
    end = len(packed)
    for k in range(n):
        if pos + 3 > end:
            raise _cut(path, "a B44 block")
        starts[k] = pos
        pos += 3 if packed[pos + 2] >= B44_FLAT else 14
    if pos > end:
        raise _cut(path, "a B44 block")
    return starts, pos


def _b44_unpack(buf: np.ndarray, starts: np.ndarray) -> np.ndarray:
    """The 16 half bits of each block (uint16 [n, 16], raster order)."""
    b = buf[starts[:, None] + np.arange(3)].astype(np.int64)
    s0 = (b[:, 0] << 8) | b[:, 1]
    s = np.repeat(s0[:, None], 16, 1)
    full = np.flatnonzero(b[:, 2] < B44_FLAT)
    if len(full):
        b = buf[starts[full, None] + np.arange(14)].astype(np.int64)
        shift = b[:, 2] >> 2
        r = np.stack([
            ((b[:, 2] << 4) | (b[:, 3] >> 4)) & 63,    # s4 - s0
            ((b[:, 3] << 2) | (b[:, 4] >> 6)) & 63,    # s8 - s4
            b[:, 4] & 63,                              # s12 - s8
            b[:, 5] >> 2,                              # s1 - s0
            ((b[:, 5] << 4) | (b[:, 6] >> 4)) & 63,    # s5 - s4
            ((b[:, 6] << 2) | (b[:, 7] >> 6)) & 63,    # s9 - s8
            b[:, 7] & 63,                              # s13 - s12
            b[:, 8] >> 2,                              # s2 - s1
            ((b[:, 8] << 4) | (b[:, 9] >> 4)) & 63,    # s6 - s5
            ((b[:, 9] << 2) | (b[:, 10] >> 6)) & 63,   # s10 - s9
            b[:, 10] & 63,                             # s14 - s13
            b[:, 11] >> 2,                             # s3 - s2
            ((b[:, 11] << 4) | (b[:, 12] >> 4)) & 63,  # s7 - s6
            ((b[:, 12] << 2) | (b[:, 13] >> 6)) & 63,  # s11 - s10
            b[:, 13] & 63], 1)                         # s15 - s14
        step = (r - 32) << shift[:, None]
        v = np.empty((len(full), 16), np.int64)
        v[:, 0] = s0[full]
        v[:, 4] = v[:, 0] + step[:, 0]
        v[:, 8] = v[:, 4] + step[:, 1]
        v[:, 12] = v[:, 8] + step[:, 2]
        for col in range(1, 4):                 # each column from the left
            for row in range(4):
                v[:, 4 * row + col] = v[:, 4 * row + col - 1] + \
                    step[:, 3 + 4 * (col - 1) + row]
        s[full] = v
    s &= 0xFFFF
    return np.where(s & 0x8000, s & 0x7FFF, ~s & 0xFFFF).astype(np.uint16)


def _b44(packed: bytes, channels: List[Tuple[str, int, bool]], shapes,
         path: str) -> List[np.ndarray]:
    """Each channel's samples [rows, samples a row] (uint16 or uint32
    bits) of a B44 or B44A chunk."""
    buf = np.frombuffer(packed, np.uint8)
    out, pos = [], 0
    for (_, ptype, linear), (lines, width) in zip(channels, shapes):
        if ptype != HALF:
            n = lines * width * 4
            if pos + n > len(packed):
                raise _cut(path, "a B44 chunk's raw channel")
            out.append(buf[pos:pos + n].view("<u4").reshape(lines, width))
            pos += n
            continue
        bx, by = -(-width // 4), -(-lines // 4)
        starts, pos = _b44_starts(packed, pos, bx * by, path)
        s = _b44_unpack(buf, starts)
        if linear:
            s = b44_exp_table()[s]
        out.append(s.reshape(by, bx, 4, 4).transpose(0, 2, 1, 3).reshape(
            4 * by, 4 * bx)[:lines, :width])
    if pos != len(packed):
        raise _bad(path, f"a B44 chunk of {len(packed)} bytes holds "
                         f"{pos}")
    return out


# ---------------------------------------------------------------------------
# PIZ
# ---------------------------------------------------------------------------

HUF_ENCSIZE = (1 << 16) + 1
HUF_DECBITS = 14


def _huf_code_lengths(data: bytes, pos: int, im: int, iM: int
                     ) -> Tuple[List[int], int]:
    """The packed code-length table from `pos`: the lengths of symbols im
    to iM (6 bits each; 59-62 a run of 2-5 zeros, 63 and 8 bits a run of
    6-261) and the position of the byte after its last bit."""
    lengths = [0] * HUF_ENCSIZE
    c = lc = 0
    i = im
    while i <= iM:
        if lc < 6:
            if pos >= len(data):
                raise _Corrupt(1)
            c = ((c << 8) | data[pos]) & 0xFFFF
            pos += 1
            lc += 8
        lc -= 6
        length = (c >> lc) & 63
        if length >= 59:
            if length == 63:
                if lc < 8:
                    if pos >= len(data):
                        raise _Corrupt(1)
                    c = ((c << 8) | data[pos]) & 0xFFFF
                    pos += 1
                    lc += 8
                lc -= 8
                run = ((c >> lc) & 255) + 6
            else:
                run = length - 59 + 2
            if i + run > iM + 1:
                raise _Corrupt(2)
            i += run
            continue
        lengths[i] = length
        i += 1
    return lengths, pos


def _huf_canonical(lengths: List[int]) -> List[int]:
    """The canonical code of each symbol from the code lengths: the codes
    of one length consecutive in symbol order, and a shorter code, padded
    with zeros, numerically above every longer one."""
    count = [0] * 59
    for length in lengths:
        count[length] += 1
    first, c = [0] * 59, 0
    for length in range(58, 0, -1):
        first[length], c = c, (c + count[length]) >> 1
    codes = [0] * len(lengths)
    for sym, length in enumerate(lengths):
        if length:
            codes[sym] = first[length]
            first[length] += 1
    return codes


def _huf_decode_python(data: bytes, n_out: int) -> np.ndarray:
    """hufUncompress in pure Python (the C++ route's oracle)."""
    if len(data) < 20:
        raise _Corrupt(1)
    im, iM, _, nbits = struct.unpack("<4i", data[:16])
    if not (0 <= im < HUF_ENCSIZE and 0 <= iM < HUF_ENCSIZE) or nbits < 0:
        raise _Corrupt(2)
    lengths, pos = _huf_code_lengths(data, 20, im, iM)
    if nbits > 8 * (len(data) - pos):
        raise _Corrupt(1)
    codes = _huf_canonical(lengths)
    # the 14-bit table: short codes fill their entries, long codes are
    # listed under the entry of their first 14 bits
    short_len = [0] * (1 << HUF_DECBITS)
    short_sym = [0] * (1 << HUF_DECBITS)
    long_syms: Dict[int, List[int]] = {}
    for sym in range(im, iM + 1):
        length, code = lengths[sym], codes[sym]
        if code >> length:
            raise _Corrupt(2)
        if length > HUF_DECBITS:
            e = code >> (length - HUF_DECBITS)
            if short_len[e]:
                raise _Corrupt(2)
            long_syms.setdefault(e, []).append(sym)
        elif length:
            e = code << (HUF_DECBITS - length)
            for k in range(e, e + (1 << (HUF_DECBITS - length))):
                if short_len[k] or k in long_syms:
                    raise _Corrupt(2)
                short_len[k], short_sym[k] = length, sym
    out: List[int] = []
    rlc = iM
    end = pos + (nbits + 7) // 8
    c = lc = 0

    def emit(sym):
        nonlocal c, lc, pos
        if sym != rlc:
            if len(out) >= n_out:
                raise _Corrupt(4)
            out.append(sym)
            return
        if lc < 8:
            if pos >= len(data):
                raise _Corrupt(1)
            c = (c << 8) | data[pos]
            pos += 1
            lc += 8
        lc -= 8
        run = (c >> lc) & 255
        if len(out) + run > n_out or not out:
            raise _Corrupt(4)
        out.extend([out[-1]] * run)

    while pos < end:
        c = ((c << 8) | data[pos]) & ((1 << 64) - 1)
        pos += 1
        lc += 8
        while lc >= HUF_DECBITS:
            e = (c >> (lc - HUF_DECBITS)) & ((1 << HUF_DECBITS) - 1)
            if short_len[e]:
                lc -= short_len[e]
                emit(short_sym[e])
                continue
            for sym in long_syms.get(e, ()):
                length = lengths[sym]
                while lc < length and pos < end:
                    c = ((c << 8) | data[pos]) & ((1 << 64) - 1)
                    pos += 1
                    lc += 8
                if lc >= length and \
                        (c >> (lc - length)) & ((1 << length) - 1) == \
                        codes[sym]:
                    lc -= length
                    emit(sym)
                    break
            else:
                raise _Corrupt(3)
    pad = (8 - nbits) & 7
    c >>= pad
    lc -= pad
    while lc > 0:
        e = (c << (HUF_DECBITS - lc)) & ((1 << HUF_DECBITS) - 1)
        if not short_len[e] or short_len[e] > lc:
            raise _Corrupt(3)
        lc -= short_len[e]
        emit(short_sym[e])
    if len(out) != n_out:
        raise _Corrupt(4)
    return np.array(out, np.uint16)


def _huf_decode_native(lib, data: bytes, n_out: int) -> np.ndarray:
    out = np.empty(n_out, np.uint16)
    rc = lib.piz_huf_decode(data, len(data), out, n_out)
    if rc:
        raise _Corrupt(rc)
    return out


def _huf_decode(data: bytes, n_out: int, lib=None) -> np.ndarray:
    """The `n_out` 16-bit values of one PIZ Huffman stream, by the C++
    library `lib` or, where it is None, in Python."""
    if not data:
        if n_out:
            raise _Corrupt(4)
        return np.empty(0, np.uint16)
    if lib is None:
        return _huf_decode_python(data, n_out)
    return _huf_decode_native(lib, data, n_out)


def _wdec14(l, h):
    ls = (l ^ 0x8000) - 0x8000
    hs = (h ^ 0x8000) - 0x8000
    ai = ls + (hs & 1) + (hs >> 1)
    return ai & 0xFFFF, (ai - hs) & 0xFFFF


def _wdec16(l, h):
    b = (l - (h >> 1)) & 0xFFFF
    return (h + b - 0x8000) & 0xFFFF, b


def wav2_decode(a: np.ndarray, mx: int) -> np.ndarray:
    """OpenEXR's wav2Decode of a 2-D array of 16-bit values [ny, nx]: the
    levels from the coarsest (the largest power of two not above the
    smaller side) to 1, each undoing the vertical then the horizontal pair
    of every 2 x 2 group, then the odd column and the odd line; the 14-bit
    form where `mx` < 2^14, else the 16-bit modular one. Returns int64."""
    v = a.astype(np.int64)
    ny, nx = v.shape
    dec = _wdec14 if mx < (1 << 14) else _wdec16
    n = min(nx, ny)
    p = 1
    while p <= n:
        p <<= 1
    p2 = p >> 1
    p = p2 >> 1
    while p >= 1:
        ys = np.arange(0, ny - p2 + 1, p2)
        xs = np.arange(0, nx - p2 + 1, p2)
        if len(ys) and len(xs):
            Y, X = np.ix_(ys, xs)
            i00, i10 = dec(v[Y, X], v[Y + p, X])
            i01, i11 = dec(v[Y, X + p], v[Y + p, X + p])
            v[Y, X], v[Y, X + p] = dec(i00, i01)
            v[Y + p, X], v[Y + p, X + p] = dec(i10, i11)
        if nx & p and len(ys):
            x = len(xs) * p2
            v[ys, x], v[ys + p, x] = dec(v[ys, x], v[ys + p, x])
        if ny & p and len(xs):
            y = len(ys) * p2
            v[y, xs], v[y, xs + p] = dec(v[y, xs], v[y, xs + p])
        p2, p = p, p >> 1
    return v


def _piz(packed: bytes, types: List[int], shapes, path: str, lib
         ) -> List[np.ndarray]:
    """Each channel's samples [rows, samples a row] (uint16 or uint32
    bits) of a PIZ chunk."""
    if len(packed) < 4:
        raise _cut(path, "a PIZ chunk")
    lo, hi = struct.unpack("<HH", packed[:4])
    pos = 4
    if hi >= 8192:
        raise _bad(path, f"a PIZ bitmap up to byte {hi}")
    bitmap = np.zeros(8192, np.uint8)
    if lo <= hi:
        if pos + hi - lo + 1 > len(packed):
            raise _cut(path, "a PIZ bitmap")
        bitmap[lo:hi + 1] = np.frombuffer(packed, np.uint8, hi - lo + 1, pos)
        pos += hi - lo + 1
    used = np.unpackbits(bitmap, bitorder="little").astype(bool)
    used[0] = True
    lut = np.zeros(1 << 16, np.uint16)
    values = np.flatnonzero(used)
    lut[:len(values)] = values
    mx = len(values) - 1
    if pos + 4 > len(packed):
        raise _cut(path, "a PIZ chunk's Huffman length")
    length = struct.unpack("<i", packed[pos:pos + 4])[0]
    pos += 4
    if length < 0 or pos + length > len(packed):
        raise _cut(path, "a PIZ chunk's Huffman stream")
    halves = [1 if t == HALF else 2 for t in types]
    try:
        raw = _huf_decode(packed[pos:pos + length],
                         sum(ny * nx * h for (ny, nx), h in zip(shapes,
                                                                halves)),
                         lib)
    except _Corrupt as e:
        raise _bad(path, "PIZ: " + HUF_ERRORS[e.code]) from None
    out, at = [], 0
    for ptype, size, (lines, width) in zip(types, halves, shapes):
        n = lines * width * size
        plane = raw[at:at + n].reshape(lines, width, size).astype(np.int64)
        at += n
        for j in range(size):
            plane[:, :, j] = wav2_decode(plane[:, :, j], mx)
        bits = lut[plane]
        out.append(bits[:, :, 0] if size == 1 else
                   bits.astype(np.uint32)[:, :, 0]
                   | (bits.astype(np.uint32)[:, :, 1] << np.uint32(16)))
    return out


# ---------------------------------------------------------------------------
# chunks
# ---------------------------------------------------------------------------

def _library(route: Optional[str]):
    """The EXR library for `route` ("python": None)."""
    if route == "python":
        return None
    if route not in (None, "native"):
        raise ValueError(f"route {route!r} is not 'native' or 'python'")
    from raw_ngp_torch import native
    lib = native.exr_library()
    if lib is None and route == "native":
        raise RuntimeError("the EXR library did not build (no g++?)")
    return lib


def _widths(channels) -> List[int]:
    return [np.dtype(PIXEL_TYPES[t][1]).itemsize for _, t, _ in channels]


def chunk_shapes(width: int, lines: int, sampling=None, y: int = 0):
    """Each channel's samples in a chunk of `lines` lines from line `y`
    (absolute) and `width` pixels, (rows, samples a row), and which of
    the chunk's lines hold a row of it (None where every channel is
    sampled at 1)."""
    if sampling is None:
        return None, None
    present = [(np.arange(y, y + lines) % ys == 0) for _, ys in sampling]
    shapes = [(int(p.sum()), width // xs) for p, (xs, _) in
              zip(present, sampling)]
    return shapes, present


def _split_rows(raw: np.ndarray, row_bytes, shapes, present
                ) -> List[np.ndarray]:
    """Each channel's rows [rows, row bytes] of a buffer laid out line by
    line, in each line the rows of the channels that have one there."""
    if present is None:
        lines = shapes[0][0] if shapes else 0
        rows = raw.reshape(lines, sum(row_bytes))
        out, col = [], 0
        for r in row_bytes:
            out.append(rows[:, col:col + r])
            col += r
        return out
    sizes = np.stack(present, 1) * np.array(row_bytes, np.int64)
    starts = (np.cumsum(sizes.reshape(-1)) - sizes.reshape(-1)).reshape(
        sizes.shape)
    return [raw[starts[p, c][:, None] + np.arange(r)]
            for c, (p, r) in enumerate(zip(present, row_bytes))]


def _decode_block(packed: bytes, code: int, channels, width: int, lines: int,
                 path: str = "<bytes>", lib=None, sampling=None, y: int = 0
                 ) -> List[np.ndarray]:
    """Each channel's sample bits (uint16 for HALF, uint32 otherwise) of
    one chunk or tile of `width` x `lines` from line `y` compressed with
    `code`: [lines, width], or [rows, width / xs] for a channel of
    `sampling` (xs, ys)."""
    widths = _widths(channels)
    shapes, present = chunk_shapes(width, lines, sampling, y)
    if shapes is None:
        shapes = [(lines, width)] * len(channels)
    size = sum(ny * nx * w for (ny, nx), w in zip(shapes, widths))
    types = [t for _, t, _ in channels]
    if code == 0 or len(packed) >= size:
        if len(packed) != size:
            raise ValueError(f"{path}: an OpenEXR chunk holds {len(packed)} "
                             f"bytes where {size} are stored")
        code = 0
    if code == 4:
        return _piz(packed, types, shapes, path, lib)
    if code == 5:
        return _pxr24(packed, types, shapes, present, path)
    if code in (6, 7):
        return _b44(packed, channels, shapes, path)
    if code in DWA_CODES:
        from raw_ngp_torch.data import exr_dwa
        return exr_dwa.decode_chunk(packed, channels, shapes, sampling,
                                    path, lib)
    raw = np.frombuffer(packed, np.uint8) if code == 0 else \
        _zip_rle(packed, size, code, path)
    rows = _split_rows(raw, [nx * w for (_, nx), w in zip(shapes, widths)],
                       shapes, present)
    return [r.copy().view("<u2" if t == HALF else "<u4")
            for r, t in zip(rows, types)]


def _chunks(data: bytes, part: Part, pos: int, multipart: bool, path: str):
    """(x, y, width, lines, packed bytes) of each level-0 chunk of part 0,
    read through its offset table at `pos`."""
    H, W = part.size
    x0, y0 = part.data_window[:2]
    n_table = chunk_count(part)
    if part.chunk_count is not None and part.chunk_count != n_table:
        raise ValueError(f"{path}: chunkCount {part.chunk_count} where the "
                         f"header gives {n_table} chunks")
    if part.tiles is None:
        per = COMPRESSIONS[part.compression][1]
        n = n_table
    else:
        tw, th = part.tiles[:2]
        _, _, across, down = tile_levels(part)[0]
        n = across * down
    if pos + 8 * n_table > len(data):
        raise _cut(path, "the offset table")
    offsets = struct.unpack(f"<{n}Q", data[pos:pos + 8 * n])
    seen = np.zeros(n, bool)
    head = 4 if multipart else 0
    for off in offsets:
        if off + head + 8 > len(data):
            raise _cut(path, "a chunk's header")
        if multipart and struct.unpack("<i", data[off:off + 4])[0] != 0:
            raise ValueError(f"{path}: part 0's offset table names a chunk "
                             "of another part")
        at = off + head
        if part.tiles is None:
            y, size = struct.unpack("<ii", data[at:at + 8])
            at += 8
            k, r = divmod(y - y0, per)
            if r or not 0 <= k < n or seen[k]:
                raise ValueError(f"{path}: an OpenEXR chunk at line {y} does"
                                 " not start a chunk of the data window")
            box = (0, k * per, W, min(per, H - k * per))
        else:
            if at + 20 > len(data):
                raise _cut(path, "a tile's header")
            dx, dy, lx, ly, size = struct.unpack("<5i", data[at:at + 20])
            at += 20
            k = dy * across + dx
            if (lx, ly) != (0, 0) or not (0 <= dx < across
                                          and 0 <= dy < down) or seen[k]:
                raise ValueError(f"{path}: part 0's offset table names tile "
                                 f"({dx}, {dy}) of level ({lx}, {ly})")
            box = (dx * tw, dy * th, min(tw, W - dx * tw),
                   min(th, H - dy * th))
        if size < 0 or at + size > len(data):
            raise _cut(path, f"the chunk at {box[:2]}")
        seen[k] = True
        yield box + (data[at:at + size],)


def _channel_set(names: List[str], path: str) -> str:
    """"one", "rgb" or "yc" (Y, RY, BY) for the channel sets read."""
    if len(names) == 1:
        return "one"
    if len(set(names)) == len(names):
        rest = sorted(set(names) - {"A"})
        if rest == ["B", "G", "R"]:
            return "rgb"
        if rest == ["BY", "RY", "Y"]:
            return "yc"
    raise ValueError(f"{path}: OpenEXR channels {names} (one channel, or R, "
                     "G, B or Y, RY, BY with or without A)")


def _planes(data: bytes, part: Part, pos: int, multipart: bool, path: str,
            route: Optional[str]) -> List[np.ndarray]:
    """Part 0's channels' samples as float32, each [H / ys, W / xs]."""
    H, W = part.size
    sampling = part.samplings
    lib = _library(route) if part.compression in (4,) + DWA_CODES else None
    planes = [np.empty((H // ys, W // xs), "<u2" if t == HALF else "<u4")
              for (_, t, _), (xs, ys) in zip(part.channels, sampling)]
    y0 = part.data_window[1]
    for x, y, width, lines, packed in _chunks(data, part, pos, multipart,
                                              path):
        got = _decode_block(packed, part.compression, part.channels, width,
                            lines, path, lib, part.sampling, y0 + y)
        for plane, block, (_, ys) in zip(planes, got, sampling):
            row = -(-y // ys)
            plane[row:row + block.shape[0], x:x + block.shape[1]] = block
    return [plane.view(PIXEL_TYPES[t][1]).astype(np.float32)
            for plane, (_, t, _) in zip(planes, part.channels)]


def luminance_chroma_rgb(y: np.ndarray, ry: np.ndarray, by: np.ndarray,
                         chromaticities: Optional[Tuple[float, ...]] = None
                         ) -> np.ndarray:
    """cv2's ExrDecoder::ChromaToBGR of float32 Y, RY, BY [H, W] as RGB
    [H, W, 3] float32: in float64, R = (RY + 1) Y, B = (BY + 1) Y, G = (Y
    - B wb - R wr) / wg with (wr, wg, wb) the red, green and blue y of
    `chromaticities` (Rec. 709's where None)."""
    c = REC709 if chromaticities is None else chromaticities
    wr, wg, wb = (float(np.float32(c[k])) for k in (1, 3, 5))
    lum = y.astype(np.float64)
    r = (ry.astype(np.float64) + 1) * lum
    b = (by.astype(np.float64) + 1) * lum
    with np.errstate(all="ignore"):
        g = (lum - b * wb - r * wr) / wg
        return np.stack([r, g, b], -1).astype(np.float32)


def decode_exr(data: bytes, path: str = "<bytes>",
               route: Optional[str] = None, alpha: bool = False
               ) -> np.ndarray:
    """:func:`read_exr` of a file's bytes."""
    part, pos, multipart = read_header(data, path)
    names = [c for c, _, _ in part.channels]
    kind = _channel_set(names, path)
    planes = _planes(data, part, pos, multipart, path, route)
    by = {}
    for name, plane, (xs, ys) in zip(names, planes, part.samplings):
        if (xs, ys) != (1, 1):
            plane = np.repeat(np.repeat(plane, ys, 0), xs, 1)
        by[name] = plane
    if kind == "one":
        return by[names[0]]
    if kind == "rgb":
        rgb = np.stack([by[c] for c in "RGB"], -1)
    else:
        rgb = luminance_chroma_rgb(by["Y"], by["RY"], by["BY"],
                                   part.chromaticities)
    if alpha and "A" in by:
        return np.concatenate([rgb, by["A"][..., None]], -1)
    return rgb


def read_exr(path: str, route: Optional[str] = None,
             alpha: bool = False) -> np.ndarray:
    """The data window of an OpenEXR file's part 0 (scanline, or level 0
    of a tiled part) as float32: [H, W] for one channel, [H, W, 3] RGB
    for R, G, B or Y, RY, BY (A dropped; with `alpha`, [H, W, 4] RGBA
    where the file has A), subsampled channels repeated over their
    pixels. `route` "native" or "python" picks the serial loops of PIZ
    and DWA (the Huffman decode, DWA's AC runs); None takes the C++
    library where it builds."""
    with open(path, "rb") as f:
        return decode_exr(f.read(), path, route, alpha)


def read_exr_channels(path: str, route: Optional[str] = None
                      ) -> Dict[str, np.ndarray]:
    """Each channel of an OpenEXR file's part 0 as float32 at its own
    sampling, [H / ys, W / xs], by name (any channel set)."""
    with open(path, "rb") as f:
        data = f.read()
    part, pos, multipart = read_header(data, path)
    planes = _planes(data, part, pos, multipart, path, route)
    return {name: p for (name, _, _), p in zip(part.channels, planes)}


# ---------------------------------------------------------------------------
# writing as cv2.imwrite does
# ---------------------------------------------------------------------------

# zlib's level in OpenEXR's ZIP compressor (its default)
ZIP_LEVEL = 4


def _attr(name: str, kind: str, value: bytes) -> bytes:
    return (name.encode() + b"\0" + kind.encode() + b"\0"
            + struct.pack("<i", len(value)) + value)


def write_exr(path: str, img: np.ndarray) -> bytes:
    """Writes a float32 image [H, W], [H, W, 3] (RGB) or [H, W, 4] (RGBA)
    as cv2.imwrite writes a CV_32F image through OpenCV's OpenEXR encoder
    (ExrEncoder): one scanline part, FLOAT samples, ZIP compression (16
    lines a chunk, zlib at ZIP_LEVEL, OpenEXR's default; a chunk that does
    not shrink stored raw), channel Y for one channel, R, G, B for three
    and A too for four (in the file's alphabetical order: Y; B, G, R; A,
    B, G, R), increasing y, the data window and display window at the
    origin, pixel aspect ratio 1, screen window centre (0, 0) and width
    1. Returns the bytes written."""
    img = np.asarray(img, np.float32)
    if img.ndim not in (2, 3) or (img.ndim == 3 and img.shape[2] not in
                                  (3, 4)):
        raise ValueError(f"write_exr: an image [H, W], [H, W, 3] or "
                         f"[H, W, 4], not {img.shape}")
    H, W = img.shape[:2]
    names = ["Y"] if img.ndim == 2 else sorted("RGBA"[:img.shape[2]])
    planes = [img] if img.ndim == 2 else [img[..., "RGBA".index(c)]
                                          for c in names]
    rows = np.concatenate([np.ascontiguousarray(p, "<f4").view(
        np.uint8).reshape(H, -1) for p in planes], 1)
    chlist = b"".join(c.encode() + b"\0" + struct.pack("<iB3xii", FLOAT, 0,
                                                        1, 1)
                      for c in names) + b"\0"
    window = struct.pack("<4i", 0, 0, W - 1, H - 1)
    header = (MAGIC + struct.pack("<I", 2)
              + _attr("channels", "chlist", chlist)
              + _attr("compression", "compression", bytes([3]))
              + _attr("dataWindow", "box2i", window)
              + _attr("displayWindow", "box2i", window)
              + _attr("lineOrder", "lineOrder", b"\0")
              + _attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
              + _attr("screenWindowCenter", "v2f", struct.pack("<2f", 0, 0))
              + _attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
              + b"\0")
    chunks = []
    for y in range(0, H, 16):
        raw = rows[y:y + 16].reshape(-1)
        t = np.concatenate([raw[0::2], raw[1::2]])
        d = t.copy()
        d[1:] = t[1:] - t[:-1] + np.uint8(128)
        packed = zlib.compress(d.tobytes(), ZIP_LEVEL)
        if len(packed) >= raw.size:
            packed = raw.tobytes()
        chunks.append(struct.pack("<ii", y, len(packed)) + packed)
    at = len(header) + 8 * len(chunks)
    offsets = []
    for c in chunks:
        offsets.append(at)
        at += len(c)
    data = header + struct.pack(f"<{len(chunks)}Q", *offsets) + \
        b"".join(chunks)
    with open(path, "wb") as f:
        f.write(data)
    return data
