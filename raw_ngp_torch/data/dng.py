"""DNG raw captures without rawpy: the CFA samples of a DNG file, as
``rawpy.imread(f).raw_image`` gives them.

:func:`read_dng_raw` returns the raw IFD's samples over its whole
ImageLength x ImageWidth as uint16 [H, W]: no crop to the active area, no
black subtraction, no scaling. The file is read as the TIFF 6.0 and DNG
1.4 specifications lay it out:

* the TIFF walk: classic TIFF in either byte order (``II`` or ``MM``),
  IFD0, its chain of next IFDs and every SubIFD (tag 330), to the IFD
  whose NewSubFileType (254) is 0 and whose PhotometricInterpretation
  (262) is CFA (32803). Cameras put it in a SubIFD behind an 8-bit
  thumbnail in IFD0; some writers put it in IFD0;
* the samples: strips (273 / 279, RowsPerStrip 278) or tiles (322-325,
  edge tiles cropped), one sample a pixel (SamplesPerPixel 1): 8 bits,
  16 bits in the file's byte order, or any other BitsPerSample from 1 to
  16 packed MSB first with each row of a strip or tile starting on a
  byte (TIFF 6.0's FillOrder 1, as LibRaw's getbits reads them in either
  byte order);
* the compression: 1 (none), 8 or 32946 (deflate with Predictor 1, zlib)
  or 7 (lossless JPEG: each strip or tile one stream);
* the LinearizationTable (tag 50712), applied after any compression as
  LibRaw's ``curve``: sample s becomes table[min(s, len - 1)] (LibRaw's
  linear_table extends the table with its last entry to 65,536, and
  adobe_copy_pixel passes every sample through it).

Lossless JPEG is ITU-T T.81's process 14 (Annex H, "LJ92"): SOI, DHT, DRI,
SOF3 (precision 2-16, Nc components of sampling 1 x 1), SOS (predictor
1-7, point transform), restart markers and EOI. The Huffman-coded
differences (SSSS 0-16; 16 means 32768 with no extra bits) are undone with
H.1.2.1's rules: the first sample of the first line (and of the first
line after each restart) is predicted by 2^(P - Pt - 1), the rest of that
line by Ra, the first sample of every other line by Rb, and every other
sample by the scan's predictor; values are modulo 2^16 and shifted left
by the point transform. The Nc components of a stream are interleaved
across its lines, so a DNG tile of width TW coded as two components of TW
/ 2 comes out in raster order. The marker parsing and the Huffman tables
are ``data/jpeg.py``'s. The entropy decode is the one serial loop: it runs
in C++ (``lj92_decode_scan`` in ``raw_ngp_torch/csrc/jpeg_host.cpp``,
:func:`raw_ngp_torch.native.jpeg_library`) and, where that library does
not build, in the pure Python of this module, its oracle: both give the
same samples.

Departures, each raising with the file and its name:
``NotImplementedError`` for BigTIFF, LinearRaw (Photometric 34892) and
lossy JPEG DNGs, a SampleFormat (tag 339) other than 1 (unsigned
integers: float and signed samples are refused before any decode), a
deflate Predictor other than 1, a lossless JPEG whose
restart interval is not whole lines or whose components are subsampled
or coded in several scans; ``ValueError`` for a file that is not TIFF, has no CFA
raw IFD, or is cut short or corrupt.
"""

from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from raw_ngp_torch.data.jpeg import (_Bits, _Corrupt, _lookup, _next_marker,
                                     _segment, _tables_blob, _valid_table)

CFA, LINEAR_RAW = 32803, 34892
NONE, LOSSLESS_JPEG, DEFLATE, ADOBE_DEFLATE, LOSSY_JPEG = 1, 7, 32946, 8, \
    34892
LINEARIZATION_TABLE = 50712
SAMPLE_FORMAT = 339

# TIFF field types: (struct code, bytes)
_TYPES = {1: ("B", 1), 2: ("B", 1), 3: ("H", 2), 4: ("I", 4), 5: ("II", 8),
          6: ("b", 1), 7: ("B", 1), 8: ("h", 2), 9: ("i", 4),
          10: ("ii", 8), 11: ("f", 4), 12: ("d", 8), 13: ("I", 4)}

_LJ92_ERRORS = {1: "the entropy-coded data ends early (truncated, or a "
                   "marker inside a scan)",
                2: "an undefined Huffman code",
                3: "a missing or out-of-order restart marker"}


def _fail(path, why):
    return ValueError(f"{path}: corrupt DNG: {why}")


# ---------------------------------------------------------------------------
# the TIFF walk
# ---------------------------------------------------------------------------

def _read_ifd(data: bytes, off: int, bo: str, path: str
              ) -> Tuple[Dict[int, tuple], int]:
    """The tags of the IFD at `off` ({tag: values}) and the next IFD's
    offset."""
    if off + 2 > len(data):
        raise _fail(path, f"an IFD at {off} lies past the end")
    n = struct.unpack(bo + "H", data[off:off + 2])[0]
    if off + 2 + 12 * n + 4 > len(data):
        raise _fail(path, f"the IFD at {off} is cut off")
    tags = {}
    for k in range(n):
        e = off + 2 + 12 * k
        tag, kind, count = struct.unpack(bo + "HHI", data[e:e + 8])
        if kind not in _TYPES:
            continue                      # a type of a later TIFF revision
        code, size = _TYPES[kind]
        nbytes = size * count
        at = e + 8 if nbytes <= 4 else \
            struct.unpack(bo + "I", data[e + 8:e + 12])[0]
        if at + nbytes > len(data):
            raise _fail(path, f"tag {tag}'s values lie past the end")
        tags[tag] = struct.unpack(f"{bo}{code * count}",
                                  data[at:at + nbytes])
    nxt = struct.unpack(bo + "I", data[off + 2 + 12 * n:off + 6 + 12 * n])[0]
    return tags, nxt


def tiff_ifds(data: bytes, path: str = "<bytes>"
              ) -> Tuple[str, List[Dict[int, tuple]]]:
    """The byte order ("<" or ">") and every IFD of a classic TIFF file:
    IFD0, then each IFD's SubIFDs before the next IFD of its chain."""
    if data[:2] == b"II":
        bo = "<"
    elif data[:2] == b"MM":
        bo = ">"
    else:
        raise ValueError(f"{path}: not a TIFF / DNG file")
    if len(data) < 8:
        raise _fail(path, "the header is cut off")
    magic, first = struct.unpack(bo + "HI", data[2:8])
    if magic == 43:
        raise NotImplementedError(f"{path}: a BigTIFF DNG is not read "
                                  "(classic TIFF only)")
    if magic != 42:
        raise ValueError(f"{path}: not a TIFF / DNG file")
    out, seen, todo = [], set(), [first]
    while todo:
        off = todo.pop()
        if off == 0 or off in seen:
            continue
        seen.add(off)
        tags, nxt = _read_ifd(data, off, bo, path)
        out.append(tags)
        # depth first: the SubIFDs, then the chain
        todo.append(nxt)
        todo.extend(reversed(tags.get(330, ())))
    return bo, out


def _raw_ifd(ifds: List[Dict[int, tuple]], path: str) -> Dict[int, tuple]:
    for tags in ifds:
        if tags.get(254, (0,))[0] == 0 and tags.get(262, (0,))[0] == CFA:
            return tags
    if any(tags.get(254, (0,))[0] == 0
           and tags.get(262, (0,))[0] == LINEAR_RAW for tags in ifds):
        raise NotImplementedError(f"{path}: a LinearRaw DNG (Photometric "
                                  "34892) is not read (CFA only)")
    raise ValueError(f"{path}: no CFA raw IFD (NewSubFileType 0, "
                     "Photometric 32803)")


# ---------------------------------------------------------------------------
# lossless JPEG (T.81 process 14)
# ---------------------------------------------------------------------------

@dataclass
class LJ92:
    """One lossless JPEG stream's frame and scan."""
    precision: int
    height: int
    width: int                 # samples a line of each component
    ncomp: int
    tables: List[int]          # the DC table slot of each component
    predictor: int
    pt: int
    restart: int               # MCUs a restart interval, 0 for none
    pos: int                   # the scan's first entropy-coded byte


def _read_dht_lossless(body: bytes, huff, path):
    """DHT tables of a lossless stream: DC class, SSSS symbols 0-16."""
    pos = 0
    while pos < len(body):
        if pos + 17 > len(body):
            raise _fail(path, "a malformed DHT segment")
        tc, th = body[pos] >> 4, body[pos] & 15
        bits = tuple(body[pos + 1:pos + 17])
        n = sum(bits)
        symbols = body[pos + 17:pos + 17 + n]
        if tc != 0 or th > 3 or len(symbols) != n or \
                not _valid_table(bits, symbols, False) or \
                any(s > 16 for s in symbols):
            raise _fail(path, "a malformed lossless DHT segment")
        huff[th] = (bits, bytes(symbols))
        pos += 17 + n


def parse_lj92(data: bytes, path: str = "<bytes>"):
    """The frame and scan of a lossless JPEG stream, and its Huffman
    tables (4 DC slots of (bits, symbols) or None)."""
    if data[:2] != b"\xff\xd8":
        raise _fail(path, "a lossless JPEG stream without an SOI marker")
    huff: List[Optional[tuple]] = [None] * 4
    frame, restart, pos = None, 0, 2
    while True:
        code, pos = _next_marker(data, pos, path)
        if code == 0xD9:
            raise _fail(path, "a lossless JPEG stream with no scan")
        if code == 0x01 or 0xD0 <= code <= 0xD7:
            continue
        if code in (0xC0, 0xC1, 0xC2):
            raise NotImplementedError(f"{path}: a lossy JPEG DNG (SOF"
                                      f"{code - 0xC0}) is not read")
        if 0xC5 <= code <= 0xCF and code not in (0xC8, 0xCC):
            raise NotImplementedError(f"{path}: a JPEG of SOF{code - 0xC0} "
                                      "is not read (lossless SOF3 only)")
        body, pos = _segment(data, pos, path)
        if code == 0xC3:
            if len(body) < 6:
                raise _fail(path, "a short SOF3 segment")
            p, y, x, nc = struct.unpack(">BHHB", body[:6])
            if not 2 <= p <= 16 or x == 0 or y == 0 or nc == 0 or \
                    len(body) < 6 + 3 * nc:
                raise _fail(path, f"an SOF3 of precision {p}, {x} x {y}, "
                                  f"{nc} components")
            comps = [body[6 + 3 * i:9 + 3 * i] for i in range(nc)]
            if any(c[1] != 0x11 for c in comps):
                raise NotImplementedError(f"{path}: subsampled lossless "
                                          "JPEG components are not read")
            frame = (p, y, x, [c[0] for c in comps])
        elif code == 0xC4:
            _read_dht_lossless(body, huff, path)
        elif code == 0xDD:
            if len(body) != 2:
                raise _fail(path, "a malformed DRI segment")
            restart = struct.unpack(">H", body)[0]
        elif code == 0xDA:
            if frame is None:
                raise _fail(path, "a scan before SOF3")
            p, y, x, ids = frame
            ns = body[0] if body else 0
            if len(body) != 4 + 2 * ns:
                raise _fail(path, "a malformed SOS segment")
            scan_ids = [body[1 + 2 * i] for i in range(ns)]
            if sorted(scan_ids) != sorted(ids):
                raise NotImplementedError(
                    f"{path}: lossless JPEG components in several scans "
                    "are not read")
            slots = [body[2 + 2 * i] >> 4 for i in range(ns)]
            if any(t > 3 or huff[t] is None for t in slots):
                raise _fail(path, "a scan names an undefined Huffman table")
            ss, pt = body[1 + 2 * ns], body[3 + 2 * ns] & 15
            if not 1 <= ss <= 7 or pt >= p:
                raise _fail(path, f"predictor {ss}, point transform {pt}")
            if restart and restart % x:
                raise NotImplementedError(
                    f"{path}: a lossless JPEG restart interval of {restart} "
                    f"MCUs is not whole lines of {x}")
            return LJ92(p, y, x, ns, slots, ss, pt, restart, pos), huff
        elif 0xE0 <= code <= 0xEF or code in (0xFE, 0xDB):
            continue
        else:
            raise _fail(path, f"an unexpected marker 0x{code:02X}")


def _lj92_python(data: bytes, s: LJ92, huff) -> np.ndarray:
    """The entropy decode and the prediction of one stream in pure Python
    (the C++ route's oracle): the samples [height, width * ncomp] uint16."""
    luts = [_lookup(huff[t]) for t in s.tables]
    X, nc = s.width, s.ncomp
    n = X * nc
    half = 1 << (s.precision - s.pt - 1)
    lines_per_interval = s.restart // X if s.restart else 0
    pred = s.predictor
    out = np.empty((s.height, n), np.uint16)
    br = _Bits(data, s.pos)
    prev = None
    next_rst = 0
    for y in range(s.height):
        if lines_per_interval and y and y % lines_per_interval == 0:
            try:
                code, at = _next_marker(data, br.pos, "")
            except ValueError:
                raise _Corrupt(1) from None
            if code != 0xD0 + next_rst:
                raise _Corrupt(3)
            br.pos = at
            br.restart()
            next_rst = (next_rst + 1) & 7
            prev = None
        row = [0] * n
        for i in range(n):
            t = br.decode(luts[i % nc])
            if t == 0:
                d = 0
            elif t == 16:
                d = 32768
            else:
                v = br.get(t)
                d = v - (1 << t) + 1 if v < (1 << (t - 1)) else v
            if prev is None:
                px = half if i < nc else row[i - nc]
            elif i < nc:
                px = prev[i]
            else:
                ra, rb, rc = row[i - nc], prev[i], prev[i - nc]
                if pred == 1:
                    px = ra
                elif pred == 2:
                    px = rb
                elif pred == 3:
                    px = rc
                elif pred == 4:
                    px = ra + rb - rc
                elif pred == 5:
                    px = ra + ((rb - rc) >> 1)
                elif pred == 6:
                    px = rb + ((ra - rc) >> 1)
                else:
                    px = (ra + rb) >> 1
            row[i] = (px + d) & 0xFFFF
        if br.cnt < br.pad:
            raise _Corrupt(1)
        out[y] = row
        prev = row
    return (out.astype(np.uint32) << s.pt).astype(np.uint16)


def _lj92_native(lib, data: bytes, s: LJ92, huff) -> np.ndarray:
    blob = _tables_blob([huff, [None] * 4])
    out = np.empty((s.height, s.width * s.ncomp), np.uint16)
    end = np.zeros(1, np.int64)
    rc = lib.lj92_decode_scan(
        data, len(data), s.pos, s.ncomp, np.array(s.tables, np.int32), blob,
        s.width, s.height, s.predictor, s.pt, s.precision, s.restart, out,
        end)
    if rc:
        raise _Corrupt(rc)
    return out


def _library(route: Optional[str]):
    if route == "python":
        return None
    if route not in (None, "native"):
        raise ValueError(f"route {route!r} is not 'native' or 'python'")
    from raw_ngp_torch import native
    lib = native.jpeg_library()
    if lib is None and route == "native":
        raise RuntimeError("the JPEG library did not build (no g++?)")
    return lib


def _lj92(data: bytes, path: str, lib) -> np.ndarray:
    scan, huff = parse_lj92(data, path)
    try:
        if lib is None:
            return _lj92_python(data, scan, huff)
        return _lj92_native(lib, data, scan, huff)
    except _Corrupt as e:
        raise _fail(path, _LJ92_ERRORS[e.code]) from None


def decode_lj92(data: bytes, path: str = "<bytes>",
                route: Optional[str] = None) -> np.ndarray:
    """The samples of one lossless JPEG stream, [lines, samples a line x
    components] uint16 (components interleaved along each line). `route`
    "native" or "python" picks the entropy decode; None takes the C++
    library where it builds, else Python."""
    return _lj92(data, path, _library(route))


# ---------------------------------------------------------------------------
# the raw IFD's samples
# ---------------------------------------------------------------------------

def _block(data: bytes, bo: str, tags, off: int, count: int, rows: int,
           cols: int, path: str, lib, lossless: bool) -> np.ndarray:
    """One strip or tile [rows, cols] uint16 of the raw IFD."""
    if off + count > len(data):
        raise _fail(path, "a strip or tile lies past the end")
    raw = data[off:off + count]
    if lossless:
        got = _lj92(raw, path, lib)
        if got.size != rows * cols:
            raise _fail(path, f"a lossless JPEG of {got.shape[1]} x "
                              f"{got.shape[0]} samples in a block of {cols} x "
                              f"{rows}")
        return got.reshape(rows, cols)
    if tags.get(259, (NONE,))[0] in (DEFLATE, ADOBE_DEFLATE):
        try:
            raw = zlib.decompress(raw)
        except zlib.error as e:
            raise _fail(path, f"a deflate block does not inflate ({e})"
                        ) from None
    bits = tags[258][0]
    need = rows * -(-cols * bits // 8)
    if len(raw) < need:
        raise _fail(path, f"a block of {len(raw)} bytes where {need} are "
                          "needed")
    if bits not in (8, 16):
        return unpack_bits(raw, rows, cols, bits)
    dtype = np.uint8 if bits == 8 else np.dtype(bo + "u2")
    return np.frombuffer(raw[:need], dtype).reshape(rows, cols).astype(
        np.uint16)


def unpack_bits(raw: bytes, rows: int, cols: int, bits: int) -> np.ndarray:
    """[rows, cols] uint16 samples of `bits` (1-16) packed MSB first, each
    row starting on a byte boundary."""
    row_bytes = -(-cols * bits // 8)
    buf = np.frombuffer(raw, np.uint8, rows * row_bytes).reshape(
        rows, row_bytes)
    buf = np.pad(buf, ((0, 0), (0, 2))).astype(np.uint32)
    at = np.arange(cols) * bits
    byte, shift = at >> 3, at & 7
    word = (buf[:, byte] << 16) | (buf[:, byte + 1] << 8) | buf[:, byte + 2]
    return ((word >> (24 - bits - shift)) & ((1 << bits) - 1)).astype(
        np.uint16)


def decode_dng_raw(data: bytes, path: str = "<bytes>",
                   route: Optional[str] = None) -> np.ndarray:
    """:func:`read_dng_raw` of a file's bytes."""
    bo, ifds = tiff_ifds(data, path)
    tags = _raw_ifd(ifds, path)
    if any(v != 1 for v in tags.get(SAMPLE_FORMAT, (1,))):
        raise NotImplementedError(f"{path}: SampleFormat "
                                  f"{tags[SAMPLE_FORMAT]} is not read "
                                  "(1, unsigned integers, only)")
    tiled = 322 in tags
    needed = (256, 257) + ((322, 323, 324, 325) if tiled else (273, 279))
    missing = [t for t in needed if t not in tags]
    if missing:
        raise _fail(path, f"the CFA IFD has no tag {missing}")
    W, H = tags[256][0], tags[257][0]
    spp = tags.get(277, (1,))[0]
    bits = tags.get(258, (1,))[0]
    comp = tags.get(259, (NONE,))[0]
    if spp != 1:
        raise NotImplementedError(f"{path}: a CFA IFD of {spp} samples a "
                                  "pixel is not read")
    if comp == LOSSY_JPEG:
        raise NotImplementedError(f"{path}: a lossy JPEG DNG (compression "
                                  "34892) is not read")
    if comp not in (NONE, ADOBE_DEFLATE, DEFLATE, LOSSLESS_JPEG):
        raise NotImplementedError(f"{path}: DNG compression {comp} is not "
                                  "read (1, 7, 8 and 32946)")
    lossless = comp == LOSSLESS_JPEG
    if not (2 if lossless else 1) <= bits <= 16:
        raise _fail(path, f"BitsPerSample {bits}")
    if comp in (ADOBE_DEFLATE, DEFLATE) and tags.get(317, (1,))[0] != 1:
        raise NotImplementedError(f"{path}: deflate with Predictor "
                                  f"{tags[317][0]} is not read (1 only)")
    lib = _library(route) if lossless else None
    out = np.empty((H, W), np.uint16)
    if tiled:
        tw, tl = tags[322][0], tags[323][0]
        offsets, counts = tags[324], tags[325]
        across = -(-W // tw)
        if len(offsets) < across * -(-H // tl) or len(counts) < len(offsets):
            raise _fail(path, "too few tiles")
        for k in range(across * -(-H // tl)):
            y, x = (k // across) * tl, (k % across) * tw
            tile = _block(data, bo, tags, offsets[k], counts[k], tl, tw,
                          path, lib, lossless)
            out[y:y + tl, x:x + tw] = tile[:H - y, :W - x]
    else:
        per = min(tags.get(278, (H,))[0], H)
        offsets, counts = tags[273], tags[279]
        if len(offsets) < -(-H // per) or len(counts) < len(offsets):
            raise _fail(path, "too few strips")
        for k in range(-(-H // per)):
            rows = min(per, H - k * per)
            out[k * per:k * per + rows] = _block(
                data, bo, tags, offsets[k], counts[k], rows, W, path, lib,
                lossless)
    table = tags.get(LINEARIZATION_TABLE)
    if table is not None:
        if not table or max(table) > 0xFFFF or min(table) < 0:
            raise _fail(path, "a LinearizationTable of no or out-of-range "
                              "entries")
        table = np.asarray(table[:1 << 16], np.uint16)
        out = table[np.minimum(out, len(table) - 1)]
    return out


def read_dng_raw(path: str, route: Optional[str] = None) -> np.ndarray:
    """``rawpy.imread(f).raw_image`` of a DNG file: the CFA samples of its
    raw IFD, uint16 [ImageLength, ImageWidth], uncropped and unscaled.
    `route` picks the lossless JPEG entropy decode as in
    :func:`decode_lj92`."""
    with open(path, "rb") as f:
        return decode_dng_raw(f.read(), path, route)
