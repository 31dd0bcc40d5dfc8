"""JPEG decoding and encoding without cv2: libjpeg-turbo's arithmetic, so
the pixels and the bytes are cv2's.

:func:`read_jpeg` returns what ``cv2.imread(path, cv2.IMREAD_UNCHANGED)``
returns, with the colour channels in RGB order: [H, W] uint8 for one
component, [H, W, 3] uint8 for three. It follows libjpeg-turbo's default
decompression, piece by piece (the libjpeg-turbo file in brackets):

* markers: SOI, DQT (8- and 16-bit tables), DHT, SOF0, SOF1, SOF2, DRI,
  SOS, RSTn, EOI; APPn and COM are skipped, and bytes that are not a
  marker between segments are skipped as libjpeg skips them (jdmarker.c);
* the colour space: JFIF means YCbCr, an Adobe APP14 with transform 0
  means RGB, three components with ids 'R', 'G', 'B' mean RGB, anything
  else YCbCr (jdapimin.c ``default_decompress_parms``);
* the entropy decode: sequential Huffman (jdhuff.c) and progressive
  Huffman (jdphuff.c: DC first and refine, AC first and refine, EOB
  runs), with restart intervals;
* dequantisation and the integer "islow" inverse DCT (jidctint.c,
  CONST_BITS 13, PASS1_BITS 2, the range-limit table of jdmaster.c);
* chroma upsampling: the "fancy" h2v1, h1v2 and h2v2 triangle filters
  and ``int_upsample`` for every other integral ratio (jdsample.c, with
  its choice of box filters for planes two samples wide or less);
* YCbCr -> RGB by the fixed-point tables of jdcolor.c
  ``ycc_rgb_convert`` (SCALEBITS 16).

EXIF orientation is not applied: ``IMREAD_UNCHANGED`` does not apply it.

Where it runs. The entropy decode is the one serial loop; it runs in C++
(``raw_ngp_torch/csrc/jpeg_host.cpp``, built with g++ at first use by
:mod:`raw_ngp_torch.native`) and, on a machine without g++, in the pure
Python of this module, which is also the C++ route's oracle: both write
the same coefficient array. Dequantisation, the IDCT (two exact integer
matrix products in float64, each followed by libjpeg's rounding shift),
the upsampling and the colour conversion are numpy over all blocks,
shared by both routes.

Departures, each raising with the file and the reason:

* ``NotImplementedError``: arithmetic coding (SOF9-11, SOF13-15),
  lossless (SOF3) and hierarchical (SOF5-7) coding, a precision other
  than 8 bits, a component count other than 1 or 3 (CMYK / YCCK files,
  which cv2 returns as 3-channel BGR after its own conversion), a
  fractional upsampling ratio, and a progressive file whose scans leave
  coefficients unknown (libjpeg would block-smooth them).
* ``ValueError``: a truncated or corrupt stream (cv2 returns None on a
  truncated file, and the JAX package raises then). libjpeg decodes a
  stream that runs into a marker, or holds an undefined Huffman code, with
  a warning and zeros in the rest of the scan; this module raises there.

:func:`write_jpeg` writes the bytes of ``cv2.imwrite(path, bgr,
[cv2.IMWRITE_JPEG_QUALITY, quality])``: the JFIF APP0, jcparam.c's
quality scaling of the standard tables (baseline forced), jccolor.c's
fixed-point RGB -> YCbCr, 4:2:0 by jcsample.c ``h2v2_downsample`` (its
alternating bias; one component for grey), jfdctint.c's islow forward
DCT, jcdctmgr.c's reciprocal quantisation, the standard Huffman tables
and no restart markers, the dummy blocks of jccoefct.c included.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# tables
# ---------------------------------------------------------------------------


def _zigzag() -> np.ndarray:
    """The natural (row-major) index of each zigzag position."""
    order = sorted(((i + j, (i if (i + j) % 2 else j), i * 8 + j)
                    for i in range(8) for j in range(8)))
    return np.array([n for _, _, n in order], np.int64)


ZIGZAG = _zigzag()
# jutils.c jpeg_natural_order: 16 extra entries so a corrupt run cannot
# index past the block
NATURAL_ORDER = np.concatenate([ZIGZAG, np.full(16, 63, np.int64)])

# Annex K quantisation tables, natural order (jcparam.c)
STD_LUMA_Q = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99],
    np.int64)
STD_CHROMA_Q = np.full(64, 99, np.int64)
STD_CHROMA_Q[[0, 1, 2, 3, 8, 9, 10, 11, 16, 17, 18, 24, 25]] = [
    17, 18, 24, 47, 18, 21, 26, 66, 24, 26, 56, 47, 66]

# Annex K Huffman tables (jstdhuff.c): (16 code counts, symbols)
_AC_LUMA_SYMBOLS = (
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f024"
    "33627282090a161718191a25262728292a3435363738393a434445464748494a53"
    "5455565758595a636465666768696a737475767778797a838485868788898a9293"
    "9495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9"
    "cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9fa")
_AC_CHROMA_SYMBOLS = (
    "000102031104052131061241510761711322328108144291a1b1c109233352f015"
    "6272d10a162434e125f11718191a262728292a35363738393a434445464748494a"
    "535455565758595a636465666768696a737475767778797a82838485868788898a"
    "92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7"
    "c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8f9fa")
STD_HUFFMAN = {
    "dc_luma": ((0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0),
                bytes(range(12))),
    "ac_luma": ((0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 125),
                bytes.fromhex(_AC_LUMA_SYMBOLS)),
    "dc_chroma": ((0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0),
                  bytes(range(12))),
    "ac_chroma": ((0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 119),
                  bytes.fromhex(_AC_CHROMA_SYMBOLS)),
}

_SOF_UNSUPPORTED = {
    0xC3: "lossless (SOF3)", 0xC5: "hierarchical (SOF5)",
    0xC6: "hierarchical (SOF6)", 0xC7: "hierarchical (SOF7)",
    0xC9: "arithmetic-coded (SOF9)", 0xCA: "arithmetic-coded (SOF10)",
    0xCB: "arithmetic-coded (SOF11)", 0xCD: "arithmetic-coded (SOF13)",
    0xCE: "arithmetic-coded (SOF14)", 0xCF: "arithmetic-coded (SOF15)",
    0xCC: "arithmetic-coded (DAC)", 0xDE: "hierarchical (DHP)",
    0xDF: "hierarchical (EXP)"}

# entropy-decode modes, shared with csrc/jpeg_host.cpp
SEQUENTIAL, DC_FIRST, DC_REFINE, AC_FIRST, AC_REFINE = range(5)
# the C++ route's error codes
_ERRORS = {1: "the entropy-coded data ends early (truncated, or a marker "
              "inside a scan)",
           2: "an undefined Huffman code",
           3: "a missing or out-of-order restart marker"}


def _canonical_codes(bits) -> List[Tuple[int, int]]:
    """(code, length) of each symbol in order (Annex C)."""
    out, code = [], 0
    for length in range(1, 17):
        for _ in range(bits[length - 1]):
            out.append((code, length))
            code += 1
        code <<= 1
    return out


def _valid_table(bits, symbols, dc: bool) -> bool:
    """jdhuff.c jpeg_make_d_derived_tbl's checks: at most 256 symbols, no
    code longer than its length allows, DC symbols at most 15."""
    n = sum(bits)
    if n > 256 or n != len(symbols):
        return False
    code = 0
    for length in range(1, 17):
        code += bits[length - 1]
        if code > (1 << length):
            return False
        code <<= 1
    return not dc or all(s <= 15 for s in symbols)


# ---------------------------------------------------------------------------
# parsing
# ---------------------------------------------------------------------------

@dataclass
class Component:
    ident: int
    h: int
    v: int
    tq: int
    rows: int = 0          # allocated block rows (whole MCUs)
    stride: int = 0        # allocated blocks a row (whole MCUs)
    offset: int = 0        # first block in the coefficient array
    width: int = 0         # downsampled_width (samples)
    height: int = 0        # downsampled_height
    qtable: Optional[np.ndarray] = None   # latched at its first scan
    scanned: bool = False


@dataclass
class Frame:
    path: str
    progressive: bool = False
    height: int = 0
    width: int = 0
    components: List[Component] = field(default_factory=list)
    hmax: int = 1
    vmax: int = 1
    mcux: int = 0
    mcuy: int = 0
    coef: Optional[np.ndarray] = None      # int16 [blocks * 64]
    coef_bits: Optional[np.ndarray] = None  # [n_comp, 64], -1 unseen
    jfif: bool = False
    adobe_transform: Optional[int] = None


@dataclass
class Scan:
    comps: List[int]
    dc: List[int]
    ac: List[int]
    mcux: int
    mcuy: int
    ss: int
    se: int
    al: int
    mode: int
    restart: int


def _fail(path, why):
    return ValueError(f"{path}: corrupt JPEG: {why}")


def _next_marker(data: bytes, pos: int, path: str) -> Tuple[int, int]:
    """jdmarker.c next_marker: skips bytes that are not a marker (and
    stuffed FF 00 pairs); returns (marker code, position after it)."""
    n = len(data)
    while True:
        while pos < n and data[pos] != 0xFF:
            pos += 1
        while pos < n and data[pos] == 0xFF:
            pos += 1
        if pos >= n:
            raise _fail(path, "the file ends before its EOI marker")
        code = data[pos]
        pos += 1
        if code != 0:
            return code, pos


def _segment(data: bytes, pos: int, path: str) -> Tuple[bytes, int]:
    if pos + 2 > len(data):
        raise _fail(path, "a marker segment is cut off")
    length = struct.unpack(">H", data[pos:pos + 2])[0]
    if length < 2 or pos + length > len(data):
        raise _fail(path, "a marker segment is cut off")
    return data[pos + 2:pos + length], pos + length


def _read_sof(frame: Frame, body: bytes, code: int):
    path = frame.path
    if len(body) < 6:
        raise _fail(path, "a short SOF segment")
    prec, height, width, nc = struct.unpack(">BHHB", body[:6])
    if prec != 8:
        raise NotImplementedError(
            f"{path}: JPEG precision {prec} bits is not decoded (8 only)")
    if height == 0 or width == 0 or nc == 0:
        raise _fail(path, "an empty image (a zero size in SOF)")
    if len(body) < 6 + 3 * nc:
        raise _fail(path, "a short SOF segment")
    if nc not in (1, 3):
        raise NotImplementedError(
            f"{path}: a JPEG of {nc} components is not decoded (1 or 3; "
            "cv2 returns a CMYK / YCCK file as BGR after its own "
            "conversion)")
    frame.progressive = code == 0xC2
    frame.height, frame.width = height, width
    for i in range(nc):
        ident, hv, tq = body[6 + 3 * i:9 + 3 * i]
        h, v = hv >> 4, hv & 15
        if not (1 <= h <= 4 and 1 <= v <= 4) or tq > 3:
            raise _fail(path, f"component {ident}: sampling {h}x{v}, "
                              f"table {tq}")
        frame.components.append(Component(ident, h, v, tq))
    frame.hmax = max(c.h for c in frame.components)
    frame.vmax = max(c.v for c in frame.components)
    frame.mcux = -(-width // (8 * frame.hmax))
    frame.mcuy = -(-height // (8 * frame.vmax))
    offset = 0
    for c in frame.components:
        c.rows, c.stride = frame.mcuy * c.v, frame.mcux * c.h
        c.offset = offset
        offset += c.rows * c.stride
        c.width = -(-width * c.h // frame.hmax)
        c.height = -(-height * c.v // frame.vmax)
    frame.coef = np.zeros(offset * 64, np.int16)
    frame.coef_bits = np.full((nc, 64), -1, np.int64)


def _read_sos(frame: Frame, body: bytes, qt, huff, restart) -> Scan:
    path = frame.path
    if frame.coef is None:
        raise _fail(path, "SOS before SOF")
    ns = body[0] if body else 0
    if not 1 <= ns <= 4 or len(body) != 4 + 2 * ns:
        raise _fail(path, "a malformed SOS segment")
    ids = {c.ident: i for i, c in enumerate(frame.components)}
    comps, dc, ac = [], [], []
    for i in range(ns):
        ident, tables = body[1 + 2 * i:3 + 2 * i]
        if ident not in ids or ids[ident] in comps:
            raise _fail(path, f"SOS names component {ident}")
        comps.append(ids[ident])
        dc.append(tables >> 4)
        ac.append(tables & 15)
    ss, se, a = body[1 + 2 * ns:4 + 2 * ns]
    ah, al = a >> 4, a & 15
    if frame.progressive:
        bad = (se != 0) if ss == 0 else (ss > se or se > 63 or ns != 1)
        bad = bad or (ah != 0 and al != ah - 1) or al > 13
        if bad:
            raise _fail(path, f"an invalid progressive scan (Ss {ss}, Se "
                              f"{se}, Ah {ah}, Al {al})")
        for ci in comps:
            known = frame.coef_bits[ci]
            if ss > 0 and known[0] < 0:
                raise _fail(path, "an AC scan before the DC scan")
            for k in range(ss, se + 1):
                if ah != max(int(known[k]), 0):
                    raise _fail(path, "a refinement scan out of order")
                known[k] = al
        mode = (DC_REFINE if ah else DC_FIRST) if ss == 0 else \
            (AC_REFINE if ah else AC_FIRST)
    else:
        mode, ss, se, ah, al = SEQUENTIAL, 0, 63, 0, 0
    blocks = sum(frame.components[ci].h * frame.components[ci].v
                 for ci in comps)
    if ns > 1 and blocks > 10:
        raise _fail(path, f"{blocks} blocks in an MCU (at most 10)")
    for ci, d, t in zip(comps, dc, ac):
        need_dc = mode in (SEQUENTIAL, DC_FIRST)
        need_ac = mode in (SEQUENTIAL, AC_FIRST, AC_REFINE)
        if (need_dc and (d > 3 or huff[0][d] is None)) or \
                (need_ac and (t > 3 or huff[1][t] is None)):
            raise _fail(path, "a scan uses an undefined Huffman table")
        comp = frame.components[ci]
        if comp.qtable is None:        # jdinput.c latch_quant_tables
            if qt[comp.tq] is None:
                raise _fail(path, f"quantisation table {comp.tq} is "
                                  "undefined")
            comp.qtable = qt[comp.tq].copy()
        comp.scanned = True
    if ns == 1:
        c = frame.components[comps[0]]
        mcux, mcuy = -(-c.width // 8), -(-c.height // 8)
    else:
        mcux, mcuy = frame.mcux, frame.mcuy
    return Scan(comps, dc, ac, mcux, mcuy, ss, se, al, mode, restart)


def _read_dqt(body: bytes, qt, path):
    pos = 0
    while pos < len(body):
        pq, tq = body[pos] >> 4, body[pos] & 15
        size = 128 if pq else 64
        if pq > 1 or tq > 3 or pos + 1 + size > len(body):
            raise _fail(path, "a malformed DQT segment")
        vals = np.frombuffer(body, ">u2" if pq else np.uint8, 64, pos + 1)
        table = np.zeros(64, np.int64)
        table[ZIGZAG] = vals
        qt[tq] = table
        pos += 1 + size


def _read_dht(body: bytes, huff, path):
    pos = 0
    while pos < len(body):
        if pos + 17 > len(body):
            raise _fail(path, "a malformed DHT segment")
        tc, th = body[pos] >> 4, body[pos] & 15
        bits = tuple(body[pos + 1:pos + 17])
        n = sum(bits)
        symbols = body[pos + 17:pos + 17 + n]
        if tc > 1 or th > 3 or len(symbols) != n or \
                not _valid_table(bits, symbols, tc == 0):
            raise _fail(path, "a malformed DHT segment")
        huff[tc][th] = (bits, bytes(symbols))
        pos += 17 + n


def jpeg_size(path: str) -> Tuple[int, int]:
    """(height, width) of a JPEG, read only as far as its SOF header."""
    with open(path, "rb") as f:
        data = f.read(1 << 16)
        while True:
            if data[:2] != b"\xff\xd8":
                raise ValueError(f"{path}: not a JPEG file")
            pos = 2
            try:
                while True:
                    code, pos = _next_marker(data, pos, path)
                    if 0xC0 <= code <= 0xCF and code not in (0xC4, 0xC8,
                                                             0xCC):
                        body, _ = _segment(data, pos, path)
                        if len(body) < 5:
                            raise _fail(path, "a short SOF segment")
                        h, w = struct.unpack(">HH", body[1:5])
                        return int(h), int(w)
                    if code in (0xD9, 0xDA):
                        raise _fail(path, "no SOF before the image data")
                    if code == 0x01 or 0xD0 <= code <= 0xD7:
                        continue
                    _, pos = _segment(data, pos, path)
            except ValueError:
                more = f.read(len(data))
                if not more:
                    raise
                data += more


# ---------------------------------------------------------------------------
# the entropy decode, pure Python (the fallback and the oracle)
# ---------------------------------------------------------------------------

def _lookup(table) -> List[int]:
    """A 16-bit lookahead table: entry (length << 8) | symbol for every
    16-bit window that starts with a code, 0 for the rest."""
    bits, symbols = table
    lut = [0] * 65536
    for (code, length), sym in zip(_canonical_codes(bits), symbols):
        lo = code << (16 - length)
        hi = (code + 1) << (16 - length)
        lut[lo:hi] = [(length << 8) | sym] * (hi - lo)
    return lut


class _Bits:
    """libjpeg's bit reader (jdhuff.c jpeg_fill_bit_buffer): FF 00 is a
    data FF, FF fill bytes before a marker are skipped, and past a marker
    or the end of the data it feeds zero bits, counted in `pad`: a read
    that takes a padding bit is an error."""

    __slots__ = ("data", "pos", "buf", "cnt", "pad", "marker")

    def __init__(self, data: bytes, pos: int):
        self.data, self.pos = data, pos
        self.buf = self.cnt = self.pad = 0
        self.marker = False

    def fill(self, need: int):
        data, n = self.data, len(self.data)
        buf, cnt = self.buf & ((1 << self.cnt) - 1), self.cnt
        while cnt < need:
            c = 0
            if self.marker:
                self.pad += 8
            else:
                pos = self.pos
                if pos >= n:
                    self.marker = True
                    self.pad += 8
                else:
                    c = data[pos]
                    if c == 0xFF:
                        p = pos + 1
                        while p < n and data[p] == 0xFF:
                            p += 1
                        if p < n and data[p] == 0:
                            self.pos = p + 1
                        else:
                            c = 0
                            self.marker = True
                            self.pad += 8
                    else:
                        self.pos = pos + 1
            buf = (buf << 8) | c
            cnt += 8
        self.buf, self.cnt = buf, cnt

    def get(self, k: int) -> int:
        if self.cnt < k:
            self.fill(k)
        self.cnt -= k
        return (self.buf >> self.cnt) & ((1 << k) - 1)

    def decode(self, lut) -> int:
        if self.cnt < 16:
            self.fill(16)
        e = lut[(self.buf >> (self.cnt - 16)) & 0xFFFF]
        if not e:
            raise _Corrupt(2)
        self.cnt -= e >> 8
        return e & 0xFF

    def restart(self):
        self.buf = self.cnt = self.pad = 0
        self.marker = False


class _Corrupt(Exception):
    def __init__(self, code):
        super().__init__(code)
        self.code = code


def _extend(v: int, s: int) -> int:
    """HUFF_EXTEND: the s-bit value v as a signed coefficient."""
    return v - (1 << s) + 1 if v < (1 << (s - 1)) else v


def _decode_scan_python(data: bytes, pos: int, frame: Frame,
                        scan: Scan, huff) -> int:
    coef = memoryview(frame.coef)
    nat = NATURAL_ORDER.tolist()
    comps = [frame.components[ci] for ci in scan.comps]
    single = len(comps) == 1
    dcl = [_lookup(huff[0][d]) if scan.mode in (SEQUENTIAL, DC_FIRST)
           else None for d in scan.dc]
    acl = [_lookup(huff[1][a]) if scan.mode in (SEQUENTIAL, AC_FIRST,
                                                AC_REFINE)
           else None for a in scan.ac]
    layout = []
    for j, c in enumerate(comps):
        h, v = (1, 1) if single else (c.h, c.v)
        layout += [(j, c.offset, c.stride, h, v, yi, xi)
                   for yi in range(v) for xi in range(h)]
    ss, se, al, mode = scan.ss, scan.se, scan.al, scan.mode
    p1, m1 = 1 << al, -1 << al
    br = _Bits(data, pos)
    last_dc = [0] * len(comps)
    eobrun = 0
    todo, next_rst = scan.restart, 0

    def store(i, v):
        coef[i] = ((v + 32768) & 0xFFFF) - 32768

    for my in range(scan.mcuy):
        for mx in range(scan.mcux):
            if scan.restart:
                if todo == 0:
                    code, at = _next_marker(data, br.pos, frame.path)
                    if code != 0xD0 + next_rst:
                        raise _Corrupt(3)
                    br.pos = at
                    br.restart()
                    next_rst = (next_rst + 1) & 7
                    last_dc = [0] * len(comps)
                    eobrun = 0
                    todo = scan.restart
                todo -= 1
            for j, off, stride, h, v, yi, xi in layout:
                b = (off + (my * v + yi) * stride + mx * h + xi) * 64
                if mode == SEQUENTIAL or mode == DC_FIRST:
                    s = br.decode(dcl[j])
                    if s:
                        s = _extend(br.get(s), s)
                    last_dc[j] = s = last_dc[j] + s
                    if mode == DC_FIRST:
                        store(b, s << al)
                        continue
                    store(b, s)
                    lut = acl[j]
                    k = 1
                    while k < 64:
                        s = br.decode(lut)
                        r, s = s >> 4, s & 15
                        if s:
                            k += r
                            store(b + nat[k], _extend(br.get(s), s))
                        elif r != 15:
                            break
                        else:
                            k += 15
                        k += 1
                elif mode == DC_REFINE:
                    if br.get(1):
                        store(b, coef[b] | p1)
                elif mode == AC_FIRST:
                    if eobrun > 0:
                        eobrun -= 1
                        continue
                    lut = acl[j]
                    k = ss
                    while k <= se:
                        s = br.decode(lut)
                        r, s = s >> 4, s & 15
                        if s:
                            k += r
                            store(b + nat[k], _extend(br.get(s), s) << al)
                        elif r == 15:
                            k += 15
                        else:
                            eobrun = 1 << r
                            if r:
                                eobrun += br.get(r)
                            eobrun -= 1
                            break
                        k += 1
                else:                            # AC_REFINE
                    lut = acl[j]
                    k = ss
                    if eobrun == 0:
                        while k <= se:
                            s = br.decode(lut)
                            r, s = s >> 4, s & 15
                            if s:
                                s = p1 if br.get(1) else m1
                            elif r != 15:
                                eobrun = 1 << r
                                if r:
                                    eobrun += br.get(r)
                                break
                            while k <= se:
                                i = b + nat[k]
                                c = coef[i]
                                if c != 0:
                                    if br.get(1) and (c & p1) == 0:
                                        store(i, c + (p1 if c >= 0 else m1))
                                else:
                                    r -= 1
                                    if r < 0:
                                        break
                                k += 1
                            if s:
                                store(b + nat[k], s)
                            k += 1
                    if eobrun > 0:
                        while k <= se:
                            i = b + nat[k]
                            c = coef[i]
                            if c != 0 and br.get(1) and (c & p1) == 0:
                                store(i, c + (p1 if c >= 0 else m1))
                            k += 1
                        eobrun -= 1
            if br.cnt < br.pad:
                raise _Corrupt(1)
    return br.pos


# ---------------------------------------------------------------------------
# the entropy decode, C++
# ---------------------------------------------------------------------------

def _tables_blob(huff) -> np.ndarray:
    """The 8 Huffman table slots (DC 0-3, AC 4-7) as 16 counts and 256
    symbols each, for csrc/jpeg_host.cpp."""
    blob = np.zeros((8, 272), np.uint8)
    for tc in (0, 1):
        for th in range(4):
            if huff[tc][th] is not None:
                bits, symbols = huff[tc][th]
                blob[tc * 4 + th, :16] = bits
                blob[tc * 4 + th, 16:16 + len(symbols)] = \
                    np.frombuffer(symbols, np.uint8)
    return blob


def _decode_scan_native(lib, data: bytes, pos: int, frame: Frame,
                        scan: Scan, huff) -> int:
    single = len(scan.comps) == 1
    info = []
    for ci, d, a in zip(scan.comps, scan.dc, scan.ac):
        c = frame.components[ci]
        h, v = (1, 1) if single else (c.h, c.v)
        info += [h, v, c.stride, c.offset, min(d, 3), 4 + min(a, 3)]
    info = np.array(info, np.int32)
    end = np.zeros(1, np.int64)
    rc = lib.jpeg_decode_scan(
        data, len(data), pos, len(scan.comps), info, _tables_blob(huff),
        scan.mcux, scan.mcuy, scan.ss, scan.se, scan.al, scan.mode,
        scan.restart, frame.coef, end)
    if rc:
        raise _Corrupt(rc)
    return int(end[0])


def _native_lib():
    from raw_ngp_torch import native
    return native.jpeg_library()


# ---------------------------------------------------------------------------
# the numpy stages
# ---------------------------------------------------------------------------

def _idct_1d(x):
    """jidctint.c's butterfly on one column (or row) of 8, before the
    descale: exact integer linear combinations."""
    z2, z3 = x[2], x[6]
    z1 = (z2 + z3) * 4433
    tmp2 = z1 + z3 * -15137
    tmp3 = z1 + z2 * 6270
    tmp0 = (x[0] + x[4]) * 8192
    tmp1 = (x[0] - x[4]) * 8192
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = x[7], x[5], x[3], x[1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * 9633
    t0, t1, t2, t3 = t0 * 2446, t1 * 16819, t2 * 25172, t3 * 12299
    z1, z2 = z1 * -7373, z2 * -20995
    z3, z4 = z3 * -16069 + z5, z4 * -3196 + z5
    t0, t1, t2, t3 = t0 + z1 + z3, t1 + z2 + z4, t2 + z2 + z3, t3 + z1 + z4
    return [tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
            tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3]


def _fdct_1d(d):
    """jfdctint.c's butterfly on one row (or column) of 8, before the
    descale; the even outputs 0 and 4, which the C shifts left, carry the
    factor 2^13 so one descale serves all eight."""
    t0, t7, t1, t6 = d[0] + d[7], d[0] - d[7], d[1] + d[6], d[1] - d[6]
    t2, t5, t3, t4 = d[2] + d[5], d[2] - d[5], d[3] + d[4], d[3] - d[4]
    t10, t13, t11, t12 = t0 + t3, t0 - t3, t1 + t2, t1 - t2
    out = [0] * 8
    out[0], out[4] = (t10 + t11) * 8192, (t10 - t11) * 8192
    z1 = (t12 + t13) * 4433
    out[2], out[6] = z1 + t13 * 6270, z1 + t12 * -15137
    z1, z2, z3, z4 = t4 + t7, t5 + t6, t4 + t6, t5 + t7
    z5 = (z3 + z4) * 9633
    t4, t5, t6, t7 = t4 * 2446, t5 * 16819, t6 * 25172, t7 * 12299
    z1, z2 = z1 * -7373, z2 * -20995
    z3, z4 = z3 * -16069 + z5, z4 * -3196 + z5
    out[7], out[5] = t4 + z1 + z3, t5 + z2 + z4
    out[3], out[1] = t6 + z2 + z3, t7 + z1 + z4
    return out


def _matrix(fn) -> np.ndarray:
    cols = []
    for j in range(8):
        e = [0] * 8
        e[j] = 1
        cols.append(fn(e))
    return np.array(cols, np.float64).T      # [out, in]


IDCT_M = _matrix(_idct_1d)
FDCT_M = _matrix(_fdct_1d)


def _descale(x: np.ndarray, n: int) -> np.ndarray:
    """DESCALE: (x + 2^(n-1)) >> n, exact on float64 integers."""
    return np.floor((x + float(1 << (n - 1))) * (1.0 / (1 << n)))


def _range_limit_table() -> np.ndarray:
    """jdmaster.c prepare_range_limit_table as the IDCT indexes it:
    table[(x) & 1023] for the centred output x."""
    t = np.zeros(1024, np.uint8)
    t[:128] = np.arange(128, 256)
    t[128:512] = 255
    t[896:] = np.arange(128)
    return t


_IDCT_LIMIT = _range_limit_table()
_CHUNK = 1 << 15


def idct_islow(blocks: np.ndarray, qtable: np.ndarray) -> np.ndarray:
    """jidctint.c jpeg_idct_islow on [N, 64] coefficients (natural order)
    dequantised by `qtable`: [N, 8, 8] uint8 samples."""
    out = np.empty((len(blocks), 8, 8), np.uint8)
    q = qtable.astype(np.float64).reshape(8, 8)
    for a in range(0, len(blocks), _CHUNK):
        x = blocks[a:a + _CHUNK].astype(np.float64).reshape(-1, 8, 8) * q
        n = len(x)
        # pass 1: the columns (over the vertical frequency u)
        w = IDCT_M @ x.transpose(1, 0, 2).reshape(8, -1)
        w = _descale(w, 11).reshape(8, n, 8).transpose(1, 0, 2)
        # pass 2: the rows
        y = _descale(w.reshape(-1, 8) @ IDCT_M.T, 18)
        out[a:a + n] = _IDCT_LIMIT[y.astype(np.int64) & 1023].reshape(
            n, 8, 8)
    return out


def _plane(frame: Frame, comp: Component) -> np.ndarray:
    """The component's samples [rows * 8, stride * 8] uint8."""
    n = comp.rows * comp.stride
    blocks = frame.coef[comp.offset * 64:(comp.offset + n) * 64]
    px = idct_islow(blocks.reshape(n, 64), comp.qtable)
    return px.reshape(comp.rows, comp.stride, 8, 8).transpose(
        0, 2, 1, 3).reshape(comp.rows * 8, comp.stride * 8)


def _triangle(p: np.ndarray, axis: int, biases) -> np.ndarray:
    """The fancy upsampler's 3:1 weighting along `axis` of int32 samples,
    the neighbours edge-replicated: two outputs per sample, (3 p + prev +
    biases[0]) and (3 p + next + biases[1]), interleaved (before the
    shift)."""
    n = p.shape[axis]
    prev = np.take(p, np.r_[0, np.arange(n - 1)], axis=axis)
    nxt = np.take(p, np.r_[np.arange(1, n), n - 1], axis=axis)
    lo, hi = 3 * p + prev + biases[0], 3 * p + nxt + biases[1]
    out = np.stack([lo, hi], axis=axis + 1)
    shape = list(p.shape)
    shape[axis] *= 2
    return out.reshape(shape)


def upsample(p: np.ndarray, hr: int, vr: int) -> np.ndarray:
    """jdsample.c on one component's [downsampled_height,
    downsampled_width] samples, by the integral ratios (hr, vr) to the
    largest sampling: [height * vr, width * hr] uint8."""
    w = p.shape[1]
    if hr == 1 and vr == 1:
        return p
    x = p.astype(np.int32)
    if hr == 2 and vr == 1 and w > 2:                  # h2v1_fancy
        return (_triangle(x, 1, (1, 2)) >> 2).astype(np.uint8)
    if hr == 1 and vr == 2:                            # h1v2_fancy
        return (_triangle(x, 0, (1, 2)) >> 2).astype(np.uint8)
    if hr == 2 and vr == 2 and w > 2:                  # h2v2_fancy
        cols = _triangle(x, 0, (0, 0))
        return (_triangle(cols, 1, (8, 7)) >> 4).astype(np.uint8)
    # h2v1 / h2v2 box filters and int_upsample
    return np.repeat(np.repeat(p, vr, 0), hr, 1)


def _fix(v: float) -> int:
    """FIX(x) of SCALEBITS 16."""
    return int(v * 65536 + 0.5)


def _ycc_tables():
    """jdcolor.c build_ycc_rgb_table, the G term of each (Cb, Cr) pair
    summed and shifted ahead, and the sample range limit as a lookup."""
    x = np.arange(256, dtype=np.int64) - 128
    one_half = 1 << 15
    cr_r = (_fix(1.40200) * x + one_half) >> 16
    cb_b = (_fix(1.77200) * x + one_half) >> 16
    cr_g = -_fix(0.71414) * x
    cb_g = -_fix(0.34414) * x + one_half
    g = (cb_g[:, None] + cr_g[None, :]) >> 16
    limit = np.clip(np.arange(-256, 512), 0, 255).astype(np.uint8)
    return (cr_r.astype(np.int32), cb_b.astype(np.int32),
            g.astype(np.int32), limit)


_CR_R, _CB_B, _CBCR_G, _LIMIT = _ycc_tables()


def ycc_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    """jdcolor.c ycc_rgb_convert: [H, W, 3] uint8."""
    out = np.empty(y.shape + (3,), np.uint8)
    y = y.astype(np.int32) + 256               # the limit table's origin
    out[..., 0] = _LIMIT[y + _CR_R[cr]]
    out[..., 1] = _LIMIT[y + _CBCR_G[cb, cr]]
    out[..., 2] = _LIMIT[y + _CB_B[cb]]
    return out


def _pixels(frame: Frame) -> np.ndarray:
    path = frame.path
    if frame.progressive and (frame.coef_bits != 0).any():
        raise NotImplementedError(
            f"{path}: a progressive JPEG whose scans leave coefficients "
            "unknown (libjpeg would block-smooth them) is not decoded")
    planes = []
    for comp in frame.components:
        if not comp.scanned:
            raise _fail(path, f"component {comp.ident} has no scan")
        hr, vr = frame.hmax // comp.h, frame.vmax // comp.v
        if frame.hmax % comp.h or frame.vmax % comp.v:
            raise NotImplementedError(
                f"{path}: fractional chroma sampling ({comp.h}x{comp.v} "
                f"of {frame.hmax}x{frame.vmax}) is not decoded")
        p = _plane(frame, comp)[:comp.height, :comp.width]
        planes.append(upsample(p, hr, vr)[:frame.height, :frame.width])
    if len(planes) == 1:
        return planes[0]
    ids = tuple(c.ident for c in frame.components)
    if frame.jfif:
        rgb = False
    elif frame.adobe_transform is not None:
        rgb = frame.adobe_transform == 0
    else:
        rgb = ids == (82, 71, 66)
    if rgb:
        return np.stack(planes, -1)
    return ycc_to_rgb(*planes)


# ---------------------------------------------------------------------------
# decoding
# ---------------------------------------------------------------------------

def decode_jpeg(data: bytes, path: str = "<bytes>",
                route: Optional[str] = None) -> np.ndarray:
    """The image of JPEG `data` (see the module docstring). `route`
    "native" or "python" picks the entropy decoder; None takes the C++
    library where it builds, else Python."""
    if route is None:
        lib = _native_lib()
    elif route == "native":
        lib = _native_lib()
        if lib is None:
            raise RuntimeError("the JPEG library did not build (no g++?)")
    elif route == "python":
        lib = None
    else:
        raise ValueError(f"route {route!r} is not 'native' or 'python'")
    if data[:2] != b"\xff\xd8":
        raise ValueError(f"{path}: not a JPEG file (no SOI marker)")
    frame = Frame(path)
    qt: List[Optional[np.ndarray]] = [None] * 4
    huff: List[List[Optional[tuple]]] = [[None] * 4, [None] * 4]
    restart = 0
    pos = 2
    while True:
        code, pos = _next_marker(data, pos, path)
        if code == 0xD9:                                   # EOI
            break
        if code == 0x01 or 0xD0 <= code <= 0xD7:           # TEM, RSTn
            continue
        if code == 0xD8:
            raise _fail(path, "a second SOI marker")
        if code in _SOF_UNSUPPORTED:
            raise NotImplementedError(
                f"{path}: {_SOF_UNSUPPORTED[code]} JPEG is not decoded")
        body, pos = _segment(data, pos, path)
        if code in (0xC0, 0xC1, 0xC2):
            if frame.coef is not None:
                raise _fail(path, "a second SOF marker")
            _read_sof(frame, body, code)
        elif code == 0xC4:
            _read_dht(body, huff, path)
        elif code == 0xDB:
            _read_dqt(body, qt, path)
        elif code == 0xDD:
            if len(body) != 2:
                raise _fail(path, "a malformed DRI segment")
            restart = struct.unpack(">H", body)[0]
        elif code == 0xDA:
            scan = _read_sos(frame, body, qt, huff, restart)
            try:
                if lib is None:
                    pos = _decode_scan_python(data, pos, frame, scan, huff)
                else:
                    pos = _decode_scan_native(lib, data, pos, frame, scan,
                                              huff)
            except _Corrupt as e:
                raise _fail(path, _ERRORS[e.code]) from None
        elif code == 0xE0:
            frame.jfif = frame.jfif or (len(body) >= 14
                                        and body[:5] == b"JFIF\0")
        elif code == 0xEE:
            if len(body) >= 12 and body[:5] == b"Adobe":
                frame.adobe_transform = body[11]
        elif 0xE0 <= code <= 0xEF or code in (0xFE, 0xDC):
            continue                                   # APPn, COM, DNL
        else:
            raise _fail(path, f"an unknown marker 0x{code:02X}")
    if frame.coef is None:
        raise _fail(path, "no SOF marker")
    return _pixels(frame)


def read_jpeg(path: str, route: Optional[str] = None) -> np.ndarray:
    """``cv2.imread(path, cv2.IMREAD_UNCHANGED)`` of a JPEG file with the
    channels in RGB order: [H, W] uint8 (one component) or [H, W, 3]."""
    with open(path, "rb") as f:
        data = f.read()
    return decode_jpeg(data, path, route)


# ---------------------------------------------------------------------------
# encoding
# ---------------------------------------------------------------------------

def quality_table(base: np.ndarray, quality: int) -> np.ndarray:
    """jcparam.c jpeg_set_quality with force_baseline: the table of
    `base` scaled (natural order)."""
    quality = min(max(int(quality), 1), 100)
    scale = 5000 // quality if quality < 50 else 200 - quality * 2
    return np.clip((base * scale + 50) // 100, 1, 255)


def _reciprocals(qtable: np.ndarray):
    """jcdctmgr.c compute_reciprocal of each divisor q * 8 (16-bit
    DCTELEM): (reciprocal, correction, shift)."""
    recip, corr, shift = [], [], []
    for q in qtable.tolist():
        d = q * 8
        r = 16 + d.bit_length() - 1
        fq, fr = (1 << r) // d, (1 << r) % d
        c = d // 2
        if fr == 0:
            fq >>= 1
            r -= 1
        elif fr <= d // 2:
            c += 1
        else:
            fq += 1
        recip.append(fq)
        corr.append(c)
        shift.append(r)
    return (np.array(recip, np.int64), np.array(corr, np.int64),
            np.array(shift, np.int64))


def fdct_quantize(plane: np.ndarray, qtable: np.ndarray) -> np.ndarray:
    """jfdctint.c jpeg_fdct_islow and jcdctmgr.c quantize on a [rows * 8,
    cols * 8] sample plane: [rows, cols, 64] int16 (natural order)."""
    rows, cols = plane.shape[0] // 8, plane.shape[1] // 8
    x = plane.reshape(rows, 8, cols, 8).transpose(0, 2, 1, 3).reshape(
        -1, 8, 8).astype(np.float64) - 128.0
    recip, corr, shift = _reciprocals(qtable)
    out = np.empty((len(x), 64), np.int16)
    for a in range(0, len(x), _CHUNK):
        blk = x[a:a + _CHUNK]
        n = len(blk)
        # pass 1: the rows
        w = _descale(blk.reshape(-1, 8) @ FDCT_M.T, 11).reshape(n, 8, 8)
        # pass 2: the columns
        y = FDCT_M @ w.transpose(1, 0, 2).reshape(8, -1)
        y = _descale(y, 15).reshape(8, n, 8).transpose(1, 0, 2)
        t = y.reshape(n, 64).astype(np.int64)
        mag = ((np.abs(t) + corr) * recip) >> shift
        out[a:a + n] = np.where(t < 0, -mag, mag)
    return out.reshape(rows, cols, 64)


def _rgb_to_ycc(rgb: np.ndarray):
    """jccolor.c rgb_ycc_convert (SCALEBITS 16, the Cb / Cr rounding
    fudge ONE_HALF - 1): int32 planes."""
    r, g, b = (rgb[..., i].astype(np.int32) for i in range(3))
    half, off = 1 << 15, 128 << 16
    y = (_fix(0.299) * r + _fix(0.587) * g + _fix(0.114) * b + half) >> 16
    cb = (-_fix(0.16874) * r - _fix(0.33126) * g + _fix(0.5) * b + off
          + half - 1) >> 16
    cr = (_fix(0.5) * r - _fix(0.41869) * g - _fix(0.08131) * b + off
          + half - 1) >> 16
    return y, cb, cr


def _pad_edge(p: np.ndarray, rows: int, cols: int) -> np.ndarray:
    return np.pad(p, ((0, rows - p.shape[0]), (0, cols - p.shape[1])),
                  mode="edge")


def _h2v2_downsample(p: np.ndarray) -> np.ndarray:
    """jcsample.c h2v2_downsample: 2 x 2 sums plus a bias of 1, 2, 1, 2,
    ... along each output row, shifted by 2."""
    s = (p[0::2, 0::2] + p[0::2, 1::2] + p[1::2, 0::2] + p[1::2, 1::2])
    bias = np.where(np.arange(s.shape[1]) % 2 == 0, 1, 2)
    return (s + bias) >> 2


def _interleave(blocks: List[np.ndarray], real: List[Tuple[int, int]],
                hv: List[Tuple[int, int]]) -> Tuple[np.ndarray, np.ndarray]:
    """Each component's quantised blocks [rows, cols, 64] (whole MCUs)
    with jccoefct.c's dummy blocks set (past the real `real` = (block
    rows, block cols): AC zero, DC the previous block's), in MCU order:
    ([n, 64] blocks, [n] component index)."""
    out, owner = [], []
    for ci, (b, (hib, wib), (h, v)) in enumerate(zip(blocks, real, hv)):
        b = b.copy()
        rows, cols = b.shape[:2]
        if wib < cols:
            b[:hib, wib:] = 0
            b[:hib, wib:, 0] = b[:hib, wib - 1:wib, 0]
        for r in range(hib, rows):
            b[r] = 0
            # the last block of the MCU's previous block row
            b[r, :, 0] = np.repeat(b[r - 1, h - 1::h, 0], h)
        mcuy, mcux = rows // v, cols // h
        per_mcu = b.reshape(mcuy, v, mcux, h, 64).transpose(0, 2, 1, 3, 4)
        out.append(per_mcu.reshape(mcuy * mcux, v * h, 64))
        owner.append(np.full(v * h, ci, np.int32))
    seq = np.concatenate(out, 1)
    n_mcu = seq.shape[0]
    return seq.reshape(-1, 64), np.tile(np.concatenate(owner), n_mcu)


def _code_table(table) -> Tuple[np.ndarray, np.ndarray]:
    """jchuff.c jpeg_make_c_derived_tbl: (code, length) by symbol."""
    bits, symbols = table
    code = np.zeros(256, np.uint32)
    size = np.zeros(256, np.uint8)
    for (c, length), s in zip(_canonical_codes(bits), symbols):
        code[s], size[s] = c, length
    return code, size


def _encode_python(blocks: np.ndarray, owner: np.ndarray, tables,
                   ss: int = 0, se: int = 63) -> bytes:
    """jchuff.c encode_one_block over the band [ss, se] of the blocks in
    order (the DC where ss is 0; [1, 63] and [0, 0] are progressive first
    scans with EOB runs of one), then the flush (ones to the byte's end);
    0xFF bytes are stuffed."""
    out = bytearray()
    acc, nacc = 0, 0
    zz = blocks[:, ZIGZAG].astype(np.int64)
    last = [0] * len(tables)
    codes = [(_code_table(dc), _code_table(ac)) for dc, ac in tables]
    codes = [((dcc.tolist(), dcs.tolist()), (acc_.tolist(), acs.tolist()))
             for (dcc, dcs), (acc_, acs) in codes]

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
        acc &= (1 << nacc) - 1

    for i, ci in enumerate(owner.tolist()):
        (dcc, dcs), (acc_c, acs) = codes[ci]
        row = zz[i]
        if ss == 0:
            dc = int(row[0])
            diff = dc - last[ci]
            last[ci] = dc
            nbits = abs(diff).bit_length()
            emit(dcc[nbits], dcs[nbits])
            if nbits:
                emit(diff - 1 if diff < 0 else diff, nbits)
        if se == 0:
            continue
        first = max(ss, 1)
        prev = first - 1
        for k in np.flatnonzero(row[first:se + 1]).tolist():
            k += first
            run = k - prev - 1
            while run > 15:
                emit(acc_c[0xF0], acs[0xF0])
                run -= 16
            v = int(row[k])
            nbits = abs(v).bit_length()
            sym = (run << 4) | nbits
            emit(acc_c[sym], acs[sym])
            emit(v - 1 if v < 0 else v, nbits)
            prev = k
        if prev < se:
            emit(acc_c[0], acs[0])
    if nacc:                                   # jchuff.c flush_bits
        emit(0x7F, 8 - nacc)
    return bytes(out)


def _encode_native(lib, blocks: np.ndarray, owner: np.ndarray, tables,
                   ss: int = 0, se: int = 63) -> bytes:
    derived = np.zeros((len(tables), 2, 2, 256), np.uint32)
    for ci, (dc, ac) in enumerate(tables):
        for j, t in enumerate((dc, ac)):
            code, size = _code_table(t)
            derived[ci, j, 0], derived[ci, j, 1] = code, size
    blocks = np.ascontiguousarray(blocks, np.int16)
    owner = np.ascontiguousarray(owner, np.int32)
    cap = len(blocks) * 160 + 1024
    while True:
        out = np.empty(cap, np.uint8)
        n = lib.jpeg_encode_blocks(blocks, owner, len(blocks), derived,
                                   len(tables), ss, se, out, cap)
        if n >= 0:
            return out[:n].tobytes()
        cap = len(blocks) * 512 + 1024


def _marker(code: int, body: bytes) -> bytes:
    return bytes([0xFF, code]) + struct.pack(">H", len(body) + 2) + body


def encode_jpeg(img: np.ndarray, quality: int = 95,
                route: Optional[str] = None,
                progressive: bool = False) -> bytes:
    """The bytes ``cv2.imencode(".jpg", bgr, [cv2.IMWRITE_JPEG_QUALITY,
    quality])`` writes for the RGB [H, W, 3] (or grey [H, W] / [H, W,
    1]) uint8 image `img`: baseline, 4:2:0 for colour. `route` as in
    :func:`decode_jpeg`, for the entropy coder. `progressive` writes the
    same coefficients as a progressive file by spectral selection alone
    (SOF2: one interleaved DC scan, then one AC scan a component, with the
    standard tables; not cv2's progressive bytes, which refine by
    successive approximation with optimised tables), so its pixels are
    the baseline file's."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"write_jpeg: dtype {img.dtype} is not uint8")
    if img.ndim == 3 and img.shape[-1] == 1:
        img = img[..., 0]
    if not (img.ndim == 2 or (img.ndim == 3 and img.shape[-1] == 3)):
        raise ValueError(f"write_jpeg: shape {img.shape} is not [H, W] or "
                         "[H, W, 3]")
    H, W = img.shape[:2]
    if not (0 < H <= 65500 and 0 < W <= 65500):
        raise ValueError(f"write_jpeg: size {H}x{W} out of range")
    lib = None if route == "python" else _native_lib()
    if route == "native" and lib is None:
        raise RuntimeError("the JPEG library did not build (no g++?)")
    q_luma = quality_table(STD_LUMA_Q, quality)
    q_chroma = quality_table(STD_CHROMA_Q, quality)
    wib, hib = -(-W // 8), -(-H // 8)
    luma_t = (STD_HUFFMAN["dc_luma"], STD_HUFFMAN["ac_luma"])
    chroma_t = (STD_HUFFMAN["dc_chroma"], STD_HUFFMAN["ac_chroma"])
    if img.ndim == 2:
        plane = _pad_edge(img.astype(np.int64), hib * 8, wib * 8)
        own = [fdct_quantize(plane, q_luma)]
        blocks = own[0].reshape(-1, 64)
        owner = np.zeros(len(blocks), np.int32)
        comps = [(1, 0x11, 0)]
        qts = [q_luma]
        tables = [luma_t]
    else:
        y, cb, cr = _rgb_to_ycc(img)
        mcux, mcuy = -(-W // 16), -(-H // 16)
        yb = fdct_quantize(_pad_edge(y, mcuy * 16, wib * 8), q_luma)
        own = [yb[:hib]]                  # [hib, wib]: no dummy blocks
        yb = np.concatenate([yb, np.zeros((yb.shape[0], 2 * mcux - wib, 64),
                                          np.int16)], 1)
        chroma = []
        for c in (cb, cr):
            full = _pad_edge(c, 2 * (-(-H // 2)), mcux * 16)
            small = _h2v2_downsample(full)
            chroma.append(fdct_quantize(_pad_edge(small, mcuy * 8,
                                                  mcux * 8), q_chroma))
        own += chroma
        blocks, owner = _interleave(
            [yb] + chroma, [(hib, wib), (mcuy, mcux), (mcuy, mcux)],
            [(2, 2), (1, 1), (1, 1)])
        comps = [(1, 0x22, 0), (2, 0x11, 1), (3, 0x11, 1)]
        qts = [q_luma, q_chroma]
        tables = [luma_t, chroma_t, chroma_t]

    def entropy(blk, who, ss, se):
        if lib is None:
            return _encode_python(blk, who, tables, ss, se)
        return _encode_native(lib, blk, who, tables, ss, se)

    def sos(members, ss, se):
        return _marker(0xDA, bytes([len(members)]) + b"".join(
            bytes([comps[i][0], 0x00 if comps[i][2] == 0 else 0x11])
            for i in members) + bytes([ss, se, 0]))

    head = [b"\xff\xd8",
            _marker(0xE0, b"JFIF\0\x01\x01\x00\x00\x01\x00\x01\x00\x00")]
    for i, q in enumerate(qts):
        head.append(_marker(0xDB, bytes([i]) + bytes(
            q[ZIGZAG].astype(np.uint8).tolist())))
    head.append(_marker(0xC2 if progressive else 0xC0,
                        struct.pack(">BHHB", 8, H, W, len(comps))
                        + b"".join(bytes(c) for c in comps)))
    sent = set()
    for ci, (dc, ac) in enumerate(tables):
        t = 0 if ci == 0 else 1
        for cls, table in ((0, dc), (1, ac)):
            if (cls, t) in sent:
                continue
            sent.add((cls, t))
            bits, symbols = table
            head.append(_marker(0xC4, bytes([cls << 4 | t]) + bytes(bits)
                                + symbols))
    everyone = list(range(len(comps)))
    if not progressive:
        body = [sos(everyone, 0, 63), entropy(blocks, owner, 0, 63)]
    else:
        body = [sos(everyone, 0, 0), entropy(blocks, owner, 0, 0)]
        for ci, b in enumerate(own):
            # a one-component scan covers the component's own blocks
            b = np.ascontiguousarray(b).reshape(-1, 64)
            body += [sos([ci], 1, 63),
                     entropy(b, np.full(len(b), ci, np.int32), 1, 63)]
    return b"".join(head + body) + b"\xff\xd9"


def write_jpeg(path: str, img: np.ndarray, quality: int = 95,
               route: Optional[str] = None):
    """Write `img` (RGB [H, W, 3] or grey uint8) as the JPEG file
    ``cv2.imwrite(path, bgr, [cv2.IMWRITE_JPEG_QUALITY, quality])``
    writes."""
    data = encode_jpeg(img, quality, route)
    with open(path, "wb") as f:
        f.write(data)
