"""OpenEXR without a library: single-part scanline files as the light
stage writes its captures.

:func:`read_exr` returns a float32 array of the file's data window: [H, W]
for one channel, [H, W, 3] in RGB order for R, G, B (an A channel is
dropped, as the JAX package's cv2 branch drops it). It reads the layout of
the OpenEXR file format ("The OpenEXR File Layout", openexr.com):

* the magic number ``76 2f 31 01`` and a version field whose low byte is
  2 and whose flags mark neither tiles (0x200), deep data (0x800) nor
  several parts (0x1000); long names (0x400) need nothing;
* the header's attributes (``name\\0type\\0``, an int32 size, the value)
  up to a null byte, of which ``channels`` (chlist), ``compression``,
  ``dataWindow`` (box2i) and ``lineOrder`` are read;
* the offset table (one uint64 a chunk) and the chunks, each an int32 y,
  an int32 size and the data: scanline by scanline, each channel's row in
  the header's (alphabetical) order, little-endian. Chunks are placed by
  their own y, so every line order reads the same image;
* NONE (1 line a chunk), RLE (1), ZIPS (1) and ZIP (16). ZIP and ZIPS are
  zlib's inflate; RLE is a signed count byte, -n followed by n literal
  bytes, n >= 0 followed by one byte repeated n + 1 times. Both are then
  undone in numpy: the predictor (``t[i] = t[i-1] + t[i] - 128`` mod
  256, a cumulative sum) and the split into even and odd bytes (the first
  ceil(n / 2) bytes are the even positions). A chunk whose size is not
  below its uncompressed size is stored raw.

HALF samples go through numpy's ``float16``, bit for bit (infinities,
NaNs, -0 and subnormals included); FLOAT samples are copied bit for bit;
UINT samples are their value as float32.

Departures, each raising with the file and its name:
``NotImplementedError`` for PIZ, PXR24, B44, B44A, DWAA and DWAB
compression, tiled, multipart and deep files, and subsampled channels;
``ValueError`` for a file that is not OpenEXR, is cut short or is
inconsistent, and for a channel set other than one channel or R, G, B
(with or without A).
"""

from __future__ import annotations

import struct
import zlib
from typing import Dict, List, Tuple

import numpy as np

MAGIC = b"v/1\x01"
TILED, LONG_NAMES, DEEP, MULTIPART = 0x200, 0x400, 0x800, 0x1000

# pixel types: (name, numpy dtype of a little-endian sample)
PIXEL_TYPES = {0: ("UINT", "<u4"), 1: ("HALF", "<f2"), 2: ("FLOAT", "<f4")}
# compression codes: (name, scanlines a chunk) for the ones read
COMPRESSIONS = {0: ("NONE", 1), 1: ("RLE", 1), 2: ("ZIPS", 1), 3: ("ZIP", 16)}
UNSUPPORTED_COMPRESSIONS = {4: "PIZ", 5: "PXR24", 6: "B44", 7: "B44A",
                            8: "DWAA", 9: "DWAB"}
LINE_ORDERS = {0: "INCREASING_Y", 1: "DECREASING_Y", 2: "RANDOM_Y"}


def _cut(path, what):
    return ValueError(f"{path}: truncated OpenEXR file ({what})")


def _cstring(data: bytes, pos: int, path: str) -> Tuple[str, int]:
    end = data.find(b"\0", pos)
    if end < 0:
        raise _cut(path, "a header name runs past the end")
    return data[pos:end].decode("latin-1"), end + 1


def _read_chlist(value: bytes, path: str) -> List[Tuple[str, int]]:
    """The channels of a chlist value: (name, pixel type) in file order."""
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
        ptype, _, xs, ys = struct.unpack("<iB3xii", value[pos:pos + 16])
        pos += 16
        if ptype not in PIXEL_TYPES:
            raise ValueError(f"{path}: OpenEXR channel {name!r} has pixel "
                             f"type {ptype} (0 UINT, 1 HALF, 2 FLOAT)")
        if (xs, ys) != (1, 1):
            raise NotImplementedError(
                f"{path}: OpenEXR channel {name!r} is subsampled ({xs} x "
                f"{ys}); subsampled channels are not read")
        out.append((name, ptype))


def read_header(data: bytes, path: str = "<bytes>") -> Tuple[Dict, int]:
    """The header of a single-part scanline OpenEXR file: {"channels":
    [(name, pixel type)], "compression": code, "data_window": (x0, y0, x1,
    y1), "line_order": code}, and the position of the offset table."""
    if data[:4] != MAGIC:
        raise ValueError(f"{path}: not an OpenEXR file")
    if len(data) < 8:
        raise _cut(path, "the version field")
    version = struct.unpack("<I", data[4:8])[0]
    if version & 0xFF != 2:
        raise ValueError(f"{path}: OpenEXR version {version & 0xFF} (2 "
                         "only)")
    for bit, what in ((TILED, "tiled"), (MULTIPART, "multipart"),
                      (DEEP, "deep")):
        if version & bit:
            raise NotImplementedError(
                f"{path}: a {what} OpenEXR file is not read (single-part "
                "scanline files only)")
    if version & ~(0xFF | LONG_NAMES):
        raise ValueError(f"{path}: unknown OpenEXR version flags "
                         f"{version:#x}")
    header, pos = {}, 8
    while True:
        if pos >= len(data):
            raise _cut(path, "the header has no end")
        if data[pos] == 0:
            pos += 1
            break
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
            header["channels"] = _read_chlist(value, path)
        elif name == "compression" and kind == "compression" and size == 1:
            header["compression"] = value[0]
        elif name == "dataWindow" and kind == "box2i" and size == 16:
            header["data_window"] = struct.unpack("<4i", value)
        elif name == "lineOrder" and kind == "lineOrder" and size == 1:
            header["line_order"] = value[0]
        elif name == "type" and kind == "string":
            part = value.rstrip(b"\0").decode("latin-1")
            if part != "scanlineimage":
                raise NotImplementedError(
                    f"{path}: an OpenEXR part of type {part!r} is not read "
                    "(scanlineimage only)")
    for key, attr in (("channels", "channels"),
                      ("compression", "compression"),
                      ("data_window", "dataWindow")):
        if key not in header:
            raise ValueError(f"{path}: OpenEXR header without {attr!r}")
    code = header["compression"]
    if code in UNSUPPORTED_COMPRESSIONS:
        raise NotImplementedError(
            f"{path}: OpenEXR {UNSUPPORTED_COMPRESSIONS[code]} compression "
            "is not read (NONE, RLE, ZIPS and ZIP only)")
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
    return header, pos


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


def _chunk_bytes(packed: bytes, size: int, code: int,
                 path: str) -> np.ndarray:
    """The `size` uncompressed bytes of one chunk's data."""
    if len(packed) >= size or code == 0:
        if len(packed) != size:
            raise ValueError(f"{path}: an OpenEXR chunk holds {len(packed)} "
                             f"bytes where {size} are stored")
        return np.frombuffer(packed, np.uint8)
    if code == 1:
        t = _rle_decode(packed, size, path)
    else:
        try:
            raw = zlib.decompress(packed)
        except zlib.error as e:
            raise ValueError(f"{path}: a ZIP chunk does not inflate ({e})"
                             ) from e
        if len(raw) != size:
            raise ValueError(f"{path}: a ZIP chunk inflates to {len(raw)} "
                             f"bytes, not {size}")
        t = np.frombuffer(raw, np.uint8)
    return _unpredict(t)


def decode_exr(data: bytes, path: str = "<bytes>") -> np.ndarray:
    """:func:`read_exr` of a file's bytes."""
    header, pos = read_header(data, path)
    channels = header["channels"]
    code = header["compression"]
    x0, y0, x1, y1 = header["data_window"]
    W, H = x1 - x0 + 1, y1 - y0 + 1
    names = [c for c, _ in channels]
    if len(channels) == 1:
        keep = [0]
    elif sorted(set(names) - {"A"}) == ["B", "G", "R"] and \
            len(set(names)) == len(names):
        keep = [names.index(c) for c in "RGB"]
    else:
        raise ValueError(f"{path}: OpenEXR channels {names} (one channel, "
                         "or R, G, B with or without A)")
    widths = [np.dtype(PIXEL_TYPES[t][1]).itemsize for _, t in channels]
    row = W * sum(widths)
    per = COMPRESSIONS[code][1]
    n_chunks = -(-H // per)
    if pos + 8 * n_chunks > len(data):
        raise _cut(path, "the offset table")
    offsets = struct.unpack(f"<{n_chunks}Q", data[pos:pos + 8 * n_chunks])
    lines = np.empty((H, row), np.uint8)
    seen = np.zeros(n_chunks, bool)
    for off in offsets:
        if off + 8 > len(data):
            raise _cut(path, "a chunk's header")
        y, size = struct.unpack("<ii", data[off:off + 8])
        k, r = divmod(y - y0, per)
        if r or not 0 <= k < n_chunks or seen[k]:
            raise ValueError(f"{path}: an OpenEXR chunk at line {y} does "
                             "not start a chunk of the data window")
        if size < 0 or off + 8 + size > len(data):
            raise _cut(path, f"the chunk at line {y}")
        seen[k] = True
        n = min(per, H - k * per)
        lines[k * per:k * per + n] = _chunk_bytes(
            data[off + 8:off + 8 + size], n * row, code, path).reshape(n, row)
    out, col = [], 0
    for (_, ptype), width in zip(channels, widths):
        out.append(lines[:, col:col + W * width].copy().view(
            PIXEL_TYPES[ptype][1]).astype(np.float32))
        col += W * width
    if len(keep) == 1:
        return out[0]
    return np.stack([out[i] for i in keep], -1)


def read_exr(path: str) -> np.ndarray:
    """The data window of a single-part scanline OpenEXR file as float32:
    [H, W] for one channel, [H, W, 3] RGB for R, G, B (A dropped)."""
    with open(path, "rb") as f:
        return decode_exr(f.read(), path)
