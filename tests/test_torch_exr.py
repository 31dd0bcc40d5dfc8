"""The port's OpenEXR reader (raw_ngp_torch/data/exr.py, with PIZ's
Huffman decode in raw_ngp_torch/csrc/exr_host.cpp) on the CPU.

This machine has no EXR library to hold the reader to (cv2 is built
without OpenEXR, imageio finds no EXR backend, and OpenEXR itself is not
installed), so the files are assembled byte by byte here from the
published file layout ("The OpenEXR File Layout", openexr.com): the magic
number and version field, the headers' attributes, the offset tables and
the chunks, each compression's bytes written by this module's own scalar
encoders (NONE, RLE, ZIPS, ZIP with OpenEXR's byte predictor and even /
odd split; PXR24's byte planes; B44's pack / unpack and its log / exp
tables; PIZ's bitmap, LUT, wavelet and Huffman coder, the C loops
transliterated), not by the port's or chip_smoke's writer. The half
floats are held to numpy's ``float16`` and the inflate to ``zlib``.

* ``read_exr`` bit for bit on every compression x pixel type (HALF,
  FLOAT, UINT) x channel set x size (chunks and 4 x 4 blocks that do not
  divide it); HALF on all 65,536 bit patterns (PIZ in both wavelet
  forms, by both routes); a data window off the origin, DECREASING_Y and
  RANDOM_Y chunk orders, chunks stored raw; tiled files in every level
  and rounding mode; multipart files (part 0 read); pLinear B44
  channels; one hand-worked stream a new codec; corrupt PIZ chunks.
* ``chip_smoke.write_exr``'s files and ``exr.write_exr``'s read back
  bit for bit.
* What is left out (deep files) raising NotImplementedError with its
  name, what was once left out (DWAA, DWAB, subsampled channels) read
  back, and a truncated file, another channel set and a file that is
  not OpenEXR raising ValueError. DWA and subsampled files come from
  test_torch_exr_dwa's scalar encoder and are held there to its decode
  model.

The module runs on one torch and BLAS thread.
"""

import heapq
import math
import struct
import zlib

import numpy as np
import pytest
import torch

import chip_smoke
from raw_ngp_torch import native
from raw_ngp_torch.data import exr
from raw_ngp_torch.data import image_io as tio

COMPRESSIONS = {"NONE": (0, 1), "RLE": (1, 1), "ZIPS": (2, 1),
                "ZIP": (3, 16)}
NEW_CODECS = {"PIZ": (4, 32), "PXR24": (5, 16), "B44": (6, 32),
              "B44A": (7, 32)}
ALL_CODECS = {**COMPRESSIONS, **NEW_CODECS}
DWA_CODECS = {"DWAA": (8, 32), "DWAB": (9, 256)}
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


class _BitWriter:
    """MSB-first bits (OpenEXR's outputBits)."""

    def __init__(self):
        self.bits = []

    def put(self, value, n):
        self.bits += [(value >> (n - 1 - k)) & 1 for k in range(n)]

    def bytes(self):
        pad = -len(self.bits) % 8
        b = self.bits + [0] * pad
        return bytes(int("".join(map(str, b[i:i + 8])), 2)
                     for i in range(0, len(b), 8))


# PXR24 (Pxr24Compressor.cpp) --------------------------------------------

def _float24(bits):
    """floatToFloat24: a float's bits rounded to its top 24 (a NaN keeps
    its sign and top 15 mantissa bits, a finite value that would round to
    infinity is truncated instead)."""
    s, e, m = bits & 0x80000000, bits & 0x7F800000, bits & 0x007FFFFF
    if e == 0x7F800000:
        if m:
            m >>= 8
            i = (e >> 8) | m | (m == 0)
        else:
            i = e >> 8
    else:
        i = ((e | m) + (m & 0x80)) >> 8
        if i >= 0x7F8000:
            i = (e | m) >> 8
    return (s >> 8) | i


def _rows_of(block):
    """The chunk's rows in their file order: (channel, its row index) for
    each line and each channel with a row there (a block entry's third
    field marks the lines a subsampled channel has a row on)."""
    lines = len(block[0][2]) if len(block[0]) > 2 else block[0][1].shape[0]
    at = [0] * len(block)
    out = []
    for y in range(lines):
        for c, entry in enumerate(block):
            if len(entry) > 2 and not entry[2][y]:
                continue
            out.append((c, at[c]))
            at[c] += 1
    return out


def _pxr24_chunk(block):
    """A PXR24 chunk of `block` [(pixel type, bits [rows, samples])]: per
    line and channel the differences of successive (24-bit for FLOAT)
    samples from 0, in big-endian byte planes, then zlib. Returns (the
    chunk, each channel's bits as read back)."""
    out = bytearray()
    back = [np.zeros_like(e[1]) for e in block]
    for c, y in _rows_of(block):
        ptype, bits = block[c][:2]
        nb = {"HALF": 2, "UINT": 4, "FLOAT": 3}[ptype]
        planes = [bytearray() for _ in range(nb)]
        prev = 0
        for x, v in enumerate(int(b) for b in bits[y]):
            if ptype == "FLOAT":
                v = _float24(v)
                back[c][y, x] = v << 8
            d = (v - prev) & ((1 << (8 * nb)) - 1)
            prev = v
            for k in range(nb):
                planes[k].append((d >> (8 * (nb - 1 - k))) & 255)
        out += b"".join(planes)
        if ptype != "FLOAT":
            back[c][y] = bits[y]
    return zlib.compress(bytes(out)), back


# B44 (B44Compressor.cpp) ------------------------------------------------

def _b44_tables():
    """B44's logTable and expTable by their defining formulas, one half
    at a time: log: 8 ln h (0 for a non-finite or negative h); exp:
    exp(h / 8) (0 for a non-finite h, HALF_MAX from 8 ln HALF_MAX up)."""
    log = np.zeros(1 << 16, np.uint16)
    exp = np.zeros(1 << 16, np.uint16)
    top = np.float32(8) * np.float32(math.log(65504.0))
    for i in range(1 << 16):
        h = float(np.array(i, np.uint16).view(np.float16))
        if math.isfinite(h) and not h < 0:
            v = np.float32(math.log(h)) * np.float32(8) if h else -np.inf
            log[i] = np.float16(v).view(np.uint16)
        if math.isfinite(h):
            if np.float32(h) >= top:
                exp[i] = 0x7BFF
            else:
                v = np.float32(math.exp(h / 8)) if h / 8 < 709 else np.inf
                exp[i] = np.float16(v).view(np.uint16)
    return log, exp


_TABLES = []


def b44_tables():
    if not _TABLES:
        _TABLES.extend(_b44_tables())
    return _TABLES


def _shift_and_round(x, shift):
    x <<= 1
    a = (1 << shift) - 1
    shift += 1
    b = (x >> shift) & 1
    return (x + a + b) >> shift


def b44_pack(s, flat_ok, exact_max):
    """B44's pack of 16 half bits (raster order): 14 bytes, or 3 for a
    flat block where `flat_ok` (B44A)."""
    t = [0x8000 if v & 0x7C00 == 0x7C00 else (~v & 0xFFFF) if v & 0x8000
         else v | 0x8000 for v in s]
    t_max = max(t)
    shift = -1
    while True:
        shift += 1
        d = [_shift_and_round(t_max - v, shift) for v in t]
        r = [d[a] - d[b] + 32 for a, b in (
            (0, 4), (4, 8), (8, 12), (0, 1), (4, 5), (8, 9), (12, 13),
            (1, 2), (5, 6), (9, 10), (13, 14), (2, 3), (6, 7), (10, 11),
            (14, 15))]
        if min(r) >= 0 and max(r) <= 63:
            break
    if flat_ok and min(r) == max(r) == 32:
        return bytes([t[0] >> 8, t[0] & 255, 0xFC])
    t0 = (t_max - (d[0] << shift)) & 0xFFFF if exact_max else t[0]
    b = [t0 >> 8, t0, (shift << 2) | (r[0] >> 4), (r[0] << 4) | (r[1] >> 2),
         (r[1] << 6) | r[2], (r[3] << 2) | (r[4] >> 4),
         (r[4] << 4) | (r[5] >> 2), (r[5] << 6) | r[6],
         (r[7] << 2) | (r[8] >> 4), (r[8] << 4) | (r[9] >> 2),
         (r[9] << 6) | r[10], (r[11] << 2) | (r[12] >> 4),
         (r[12] << 4) | (r[13] >> 2), (r[13] << 6) | r[14]]
    return bytes(v & 255 for v in b)


def b44_unpack(b):
    """B44's unpack14 / unpack3 of one block's bytes, as the C source
    reads them: 16 half bits in raster order."""
    s = [0] * 16
    s[0] = (b[0] << 8) | b[1]
    if b[2] >= 13 << 2:
        s = [s[0]] * 16
    else:
        shift = b[2] >> 2
        bias = 0x20 << shift
        f = [((b[2] << 4) | (b[3] >> 4)) & 0x3F, ((b[3] << 2) | (b[4] >> 6))
             & 0x3F, b[4] & 0x3F, b[5] >> 2, ((b[5] << 4) | (b[6] >> 4))
             & 0x3F, ((b[6] << 2) | (b[7] >> 6)) & 0x3F, b[7] & 0x3F,
             b[8] >> 2, ((b[8] << 4) | (b[9] >> 4)) & 0x3F,
             ((b[9] << 2) | (b[10] >> 6)) & 0x3F, b[10] & 0x3F, b[11] >> 2,
             ((b[11] << 4) | (b[12] >> 4)) & 0x3F,
             ((b[12] << 2) | (b[13] >> 6)) & 0x3F, b[13] & 0x3F]
        order = [(4, 0), (8, 4), (12, 8), (1, 0), (5, 4), (9, 8), (13, 12),
                 (2, 1), (6, 5), (10, 9), (14, 13), (3, 2), (7, 6),
                 (11, 10), (15, 14)]
        for (dst, src), v in zip(order, f):
            s[dst] = (s[src] + (v << shift) - bias) & 0xFFFF
    return [v & 0x7FFF if v & 0x8000 else ~v & 0xFFFF for v in s]


def _b44_chunk(block, flat_ok, linear):
    """A B44 (or, `flat_ok`, B44A) chunk of `block` [(pixel type, bits
    [lines, width])]: each HALF channel as 4 x 4 blocks of its lines (edge
    blocks repeating the last line and column), through logTable where
    the channel is pLinear (`linear`), the others raw. Returns (the
    chunk, each channel's bits as read back)."""
    log, exp = b44_tables() if any(linear) else (None, None)
    out, back = bytearray(), []
    for (ptype, bits, *_), lin in zip(block, linear):
        if ptype != "HALF":
            out += bits.astype("<u4").tobytes()
            back.append(bits.copy())
            continue
        ny, nx = bits.shape
        got = np.zeros_like(bits)
        for y in range(0, ny, 4):
            for x in range(0, nx, 4):
                s = [int(bits[min(y + i, ny - 1), min(x + j, nx - 1)])
                     for i in range(4) for j in range(4)]
                if lin:
                    s = [int(log[v]) for v in s]
                packed = b44_pack(s, flat_ok, not lin)
                out += packed
                v = b44_unpack(packed)
                if lin:
                    v = [int(exp[u]) for u in v]
                for i in range(min(4, ny - y)):
                    for j in range(min(4, nx - x)):
                        got[y + i, x + j] = v[4 * i + j]
        back.append(got)
    return bytes(out), back


# PIZ (PizCompressor.cpp, ImfWav.cpp, ImfHuf.cpp) -------------------------

def _s16(v):
    return v - 65536 if v >= 32768 else v


def _wenc14(a, b):
    a_s, b_s = _s16(a), _s16(b)
    return ((a_s + b_s) >> 1) & 0xFFFF, (a_s - b_s) & 0xFFFF


def _wenc16(a, b):
    ao = (a + 32768) & 0xFFFF
    m = (ao + b) >> 1
    d = ao - b
    if d < 0:
        m = (m + 32768) & 0xFFFF
    return m, d & 0xFFFF


def wav2_encode(buf, start, nx, ox, ny, oy, mx):
    """wav2Encode on the list `buf` in place (the C loops transliterated:
    pointers are indices from `start`)."""
    enc = _wenc14 if mx < (1 << 14) else _wenc16
    n = min(nx, ny)
    p, p2 = 1, 2
    while p2 <= n:
        py, ey = start, start + oy * (ny - p2)
        oy1, oy2, ox1, ox2 = oy * p, oy * p2, ox * p, ox * p2
        while py <= ey:
            px, ex = py, py + ox * (nx - p2)
            while px <= ex:
                p01, p10 = px + ox1, px + oy1
                p11 = p10 + ox1
                i00, i01 = enc(buf[px], buf[p01])
                i10, i11 = enc(buf[p10], buf[p11])
                buf[px], buf[p10] = enc(i00, i10)
                buf[p01], buf[p11] = enc(i01, i11)
                px += ox2
            if nx & p:
                p10 = px + oy1
                buf[px], buf[p10] = enc(buf[px], buf[p10])
            py += oy2
        if ny & p:
            px, ex = py, py + ox * (nx - p2)
            while px <= ex:
                p01 = px + ox1
                buf[px], buf[p01] = enc(buf[px], buf[p01])
                px += ox2
        p, p2 = p2, p2 << 1


def huf_lengths(values):
    """Huffman code lengths of the values' symbols plus the run symbol
    max + 1 (count 1), from a heap of (count, order) pairs."""
    freq = {}
    for v in values:
        freq[v] = freq.get(v, 0) + 1
    rlc = max(freq) + 1
    freq[rlc] = 1
    heap = [(f, k, [sym]) for k, (sym, f) in enumerate(sorted(freq.items()))]
    heapq.heapify(heap)
    lengths = dict.fromkeys(freq, 0)
    k = len(heap)
    while len(heap) > 1:
        fa, _, a = heapq.heappop(heap)
        fb, _, b = heapq.heappop(heap)
        for sym in a + b:
            lengths[sym] += 1
        heapq.heappush(heap, (fa + fb, k, a + b))
        k += 1
    return lengths, min(freq), rlc


def huf_codes(lengths):
    """hufCanonicalCodeTable over {symbol: length}."""
    n = [0] * 59
    for length in lengths.values():
        n[length] += 1
    c = 0
    for length in range(58, 0, -1):
        n[length], c = c, (c + n[length]) >> 1
    codes = {}
    for sym in sorted(lengths):
        if lengths[sym]:
            codes[sym] = n[lengths[sym]]
            n[lengths[sym]] += 1
    return codes


def huf_compress(values):
    """hufCompress of a list of 16-bit values: the 20-byte header, the
    packed code-length table and the codes with runs."""
    if not values:
        return b""
    lengths, im, iM = huf_lengths(values)
    codes = huf_codes(lengths)
    table = _BitWriter()
    sym = im
    while sym <= iM:
        length = lengths.get(sym, 0)
        if length == 0:
            run = 1
            while sym < iM and run < 261 and lengths.get(sym + 1, 0) == 0:
                sym += 1
                run += 1
            if run >= 2:
                if run >= 6:
                    table.put(63, 6)
                    table.put(run - 6, 8)
                else:
                    table.put(59 + run - 2, 6)
                sym += 1
                continue
        table.put(length, 6)
        sym += 1
    bits = _BitWriter()

    def send(s, count):
        ls, lr = lengths[s], lengths[iM]
        if ls + lr + 8 < ls * count:
            bits.put(codes[s], ls)
            bits.put(codes[iM], lr)
            bits.put(count, 8)
        else:
            for _ in range(count + 1):
                bits.put(codes[s], ls)

    s, cs = values[0], 0
    for v in values[1:]:
        if v == s and cs < 255:
            cs += 1
        else:
            send(s, cs)
            cs = 0
        s = v
    send(s, cs)
    tb = table.bytes()
    return struct.pack("<5i", im, iM, len(tb), len(bits.bits), 0) + tb + \
        bits.bytes()


def _piz_chunk(block):
    """A PIZ chunk of `block` [(pixel type, bits [lines, width])]: the
    16-bit values channel by channel (a 32-bit sample as its low then
    high half), the bitmap of the values used and the forward LUT, each
    channel's each half through wav2Encode, hufCompress."""
    data, planes = [], []
    for ptype, bits, *_ in block:
        lines, width = bits.shape
        size = 1 if ptype == "HALF" else 2
        vals = bits.astype(np.uint32).reshape(lines, width, 1)
        if size == 2:
            vals = np.concatenate([vals & 0xFFFF, vals >> 16], 2)
        planes.append((len(data), width, size, lines))
        data += [int(v) for v in vals.reshape(-1)]
    bitmap = bytearray(8192)
    for v in data:
        bitmap[v >> 3] |= 1 << (v & 7)
    bitmap[0] &= 0xFE
    nonzero = [i for i, b in enumerate(bitmap) if b]
    lo, hi = (nonzero[0], nonzero[-1]) if nonzero else (8191, 0)
    lut, k = {}, 0
    for v in range(1 << 16):
        if v == 0 or bitmap[v >> 3] & (1 << (v & 7)):
            lut[v] = k
            k += 1
    mx = k - 1
    data = [lut[v] for v in data]
    for start, width, size, lines in planes:
        for j in range(size):
            wav2_encode(data, start + j, width, size, lines, width * size,
                        mx)
    huf = huf_compress(data)
    head = struct.pack("<HH", lo, hi) + (bytes(bitmap[lo:hi + 1])
                                         if lo <= hi else b"")
    return head + struct.pack("<i", len(huf)) + huf


# chunks, tiles, parts ----------------------------------------------------

def _chunk(block, code, linear, names=None, dwa=None):
    """One chunk's data of `block` [(pixel type, bits [rows, samples]
    [, the lines with a row of a subsampled channel])] with compression
    `code`, stored raw where that is not larger, and each channel's bits
    as read back. DWAA and DWAB chunks come from test_torch_exr_dwa's
    scalar encoder (`names` the channels' names, `dwa` its options), their
    values from its scalar decode model."""
    raw = b"".join(
        block[c][1][y].astype(PIXELS[block[c][0]][1].replace("f", "u"))
        .tobytes() for c, y in _rows_of(block))
    back = [e[1].copy() for e in block]
    if code == 0:
        return raw, back
    if code in (8, 9):
        import test_torch_exr_dwa as dwa_t
        chans = [(n, e[0], e[1], lin) for n, e, lin in zip(names, block,
                                                           linear)]
        packed = dwa_t.dwa_chunk(chans, **(dwa or {}))
        if len(packed) >= len(raw):
            return raw, back
        got = dwa_t.model_chunk(packed, [(n, e[0], lin) for n, e, lin in
                                         zip(names, block, linear)],
                                [e[1].shape for e in block],
                                (dwa or {}).get("sampling"))
        return packed, [g["bits"] for g in got]
    if code in (1, 2, 3):
        packed = _rle(_predict(raw)) if code == 1 else \
            zlib.compress(_predict(raw), 9)
    elif code == 4:
        packed = _piz_chunk(block)
    elif code == 5:
        packed, lossy = _pxr24_chunk(block)
    else:
        packed, lossy = _b44_chunk(block, code == 7, linear)
    if len(packed) >= len(raw):
        return raw, back
    return packed, (lossy if code in (5, 6, 7) else back)


def _level_size(size, level, rounding):
    n = size >> level
    if rounding and n << level < size:
        n += 1
    return max(n, 1)


def _log2(x, rounding):
    y, up = 0, 0
    while x > 1:
        up |= x & 1
        y += 1
        x >>= 1
    return y + (up if rounding else 0)


def _levels(W, H, mode, rounding):
    if mode == 0:
        return [(0, 0)]
    if mode == 1:
        return [(l, l) for l in range(_log2(max(W, H), rounding) + 1)]
    return [(lx, ly) for ly in range(_log2(H, rounding) + 1)
            for lx in range(_log2(W, rounding) + 1)]


CHUNK_LINES = {3: 16, 4: 32, 5: 16, 6: 32, 7: 32, 8: 32, 9: 256}


def _part_chunks(bits, code, origin, order, raw_chunks, tiles, linear,
                 names=None, sampling=None, dwa=None):
    """The chunks (header fields + data) of one part in offset-table
    order, and each channel's bits as read back (level 0; a channel of
    `sampling` (xs, ys) stores and gives back its samples [H / ys, W /
    xs], every xs-th column of every ys-th line)."""
    H, W = bits[0][1].shape
    x0, y0 = origin
    sampling = sampling or [(1, 1)] * len(bits)
    if code in (8, 9):
        dwa = dict(dwa or {}, sampling=sampling)
    if tiles is None:
        per = CHUNK_LINES.get(code, 1)
        subs = [(t, b[::ys, ::xs]) for (t, b), (xs, ys) in zip(bits,
                                                               sampling)]
        back = [np.zeros_like(b) for _, b in subs]
        chunks = []
        for k, y in enumerate(range(0, H, per)):
            lines = min(per, H - y)
            block = []
            for (t, b), (xs, ys) in zip(subs, sampling):
                present = (y0 + y + np.arange(lines)) % ys == 0
                first = -(-y // ys)
                block.append((t, b[first:first + int(present.sum())],
                              present))
            data, got = _chunk(block, 0 if k in raw_chunks else code, linear,
                               names, dwa)
            for dst, g, (_, ys) in zip(back, got, sampling):
                first = -(-y // ys)
                dst[first:first + len(g)] = g
            chunks.append(struct.pack("<ii", y0 + y, len(data)) + data)
        return chunks, back
    back = [np.zeros_like(b) for _, b in bits]
    chunks = []
    tw, th, mode, rounding = tiles
    k = 0
    for lx, ly in _levels(W, H, mode, rounding):
        lw, lh = _level_size(W, lx, rounding), _level_size(H, ly, rounding)
        level = [(t, b[::1 << ly, ::1 << lx][:lh, :lw]) for t, b in bits]
        for dy in range(-(-lh // th)):
            for dx in range(-(-lw // tw)):
                ys, xs = slice(dy * th, (dy + 1) * th), \
                    slice(dx * tw, (dx + 1) * tw)
                block = [(t, np.ascontiguousarray(b[ys, xs]))
                         for t, b in level]
                data, got = _chunk(block, 0 if k in raw_chunks else code,
                                   linear, names, dwa)
                if (lx, ly) == (0, 0):
                    for dst, g in zip(back, got):
                        dst[ys, xs] = g
                chunks.append(struct.pack("<5i", dx, dy, lx, ly, len(data))
                              + data)
                k += 1
    return chunks, back


def _header(channels, code, origin, order, attrs, sampling, linear, tiles,
            extra=b""):
    H, W = channels[0][2].shape
    x0, y0 = origin
    if isinstance(sampling[0], int):
        sampling = [sampling] * len(channels)
    chlist = b"".join(name.encode() + b"\0" + struct.pack(
        "<iB3xii", PIXELS[ptype][0], int(lin), *sc)
        for (name, ptype, _), lin, sc in zip(channels, linear, sampling)) + \
        b"\0"
    window = struct.pack("<4i", x0, y0, x0 + W - 1, y0 + H - 1)
    head = _attr("channels", "chlist", chlist) + \
        _attr("compression", "compression", bytes([code])) + \
        _attr("dataWindow", "box2i", window) + \
        _attr("displayWindow", "box2i", window) + \
        _attr("lineOrder", "lineOrder", bytes([min(order, 2)])) + \
        _attr("pixelAspectRatio", "float", struct.pack("<f", 1.0)) + \
        _attr("screenWindowCenter", "v2f", struct.pack("<2f", 0, 0)) + \
        _attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
    if tiles is not None:
        tw, th, mode, rounding = tiles
        head += _attr("tiles", "tiledesc", struct.pack(
            "<IIB", tw, th, mode | (rounding << 4)))
    return head + extra + b"".join(_attr(*a) for a in attrs)


def _bits(ptype, samples):
    return samples.view(np.uint16) if ptype == "HALF" else \
        samples.view(np.uint32)


def encode(channels, compression="ZIP", origin=(0, 0), order=0,
           raw_chunks=(), version_flags=0, attrs=(), sampling=(1, 1),
           tiles=None, linear=None, parts=None, values=False, dwa=None):
    """An OpenEXR file of `channels` [(name, pixel type name, samples [H,
    W] as that type)] in the given order (the layout's order is sorted by
    name; the caller passes them sorted), `compression`, the data window
    at `origin`, line order `order` (0 increasing, 1 decreasing, 2 chunks
    in a shuffled order), the chunks whose indices are in `raw_chunks`
    stored raw, extra version flags and header attributes; `tiles` (tile
    width, height, level mode, rounding mode) makes it tiled (every level,
    each level's pixels every 2^l-th of the image's), `linear` marks
    channels pLinear, and `parts` [(channels, compression, tiles)] makes it
    multipart with these after it as parts 1, 2, ... (their chunks
    interleaved with part 0's). `sampling` (x, y) samples every channel,
    or a list of them each channel, so (the file holds every xs-th sample
    of every ys-th line of the samples given); `dwa` are the DWA
    encoder's options (test_torch_exr_dwa.dwa_chunk). With `values`, also
    returns each channel's samples as the reader must give them,
    subsampled channels repeated over their pixels (B44, PXR24 FLOAT and
    DWA are lossy)."""
    codecs = {**ALL_CODECS, **DWA_CODECS}
    code = codecs[compression][0] if compression in codecs else compression
    if isinstance(sampling[0], int):
        sampling = [sampling] * len(channels)
    linear = tuple(linear or [False] * len(channels))
    spec = [(channels, code, tiles, origin, order, raw_chunks, linear)]
    spec += [(c, codecs[z][0], t, (0, 0), 0, (), [False] * len(c))
             for c, z, t in (parts or ())]
    multipart = parts is not None
    headers, all_chunks, back = [], [], None
    for i, (chans, z, t, org, od, raws, lin) in enumerate(spec):
        bits = [(ptype, _bits(ptype, s)) for _, ptype, s in chans]
        chunks, got = _part_chunks(bits, z, org, od, raws, t, lin,
                                   [n for n, _, _ in chans],
                                   sampling if i == 0 else None,
                                   dwa if i == 0 else None)
        if i == 0:
            back = [np.repeat(np.repeat(g, ys, 0), xs, 1)
                    for g, (xs, ys) in zip(got, sampling)]
        extra = b""
        if multipart:
            kind = b"tiledimage" if t is not None else b"scanlineimage"
            extra = _attr("name", "string", f"part{i}".encode()) + \
                _attr("type", "string", kind) + \
                _attr("chunkCount", "int", struct.pack("<i", len(chunks)))
        headers.append(_header(chans, z, org, od, attrs if i == 0 else (),
                               sampling if i == 0 else (1, 1), lin, t,
                               extra))
        if multipart:
            chunks = [struct.pack("<i", i) + c for c in chunks]
        all_chunks.append(chunks)
    flags = version_flags | (exr.TILED if tiles is not None and not
                             multipart else 0) | (exr.MULTIPART if multipart
                                                  else 0)
    head = b"v/1\x01" + struct.pack("<I", 2 | flags) + \
        b"".join(h + b"\0" for h in headers) + (b"\0" if multipart else b"")
    # the file order of the chunks: part 0's in its line order, the other
    # parts' interleaved with them
    order0 = list(range(len(all_chunks[0])))
    if order == 1:
        order0 = order0[::-1]
    elif order == 2:
        order0 = list(np.random.default_rng(3).permutation(len(order0)))
    placed = [(0, k) for k in order0]
    for i in range(1, len(all_chunks)):
        for k in range(len(all_chunks[i])):
            placed.insert(min(2 * k + 1, len(placed)), (i, k))
    table_size = 8 * sum(len(c) for c in all_chunks)
    offsets = [[0] * len(c) for c in all_chunks]
    at = len(head) + table_size
    body = []
    for i, k in placed:
        offsets[i][k] = at
        body.append(all_chunks[i][k])
        at += len(all_chunks[i][k])
    data = head + b"".join(struct.pack(f"<{len(o)}Q", *o) for o in offsets) \
        + b"".join(body)
    if not values:
        return data
    return data, [(name, ptype, b.view(PIXELS[ptype][1]))
                  for (name, ptype, _), b in zip(channels, back)]


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


@pytest.mark.parametrize("channels", sorted(CHANNEL_SETS))
@pytest.mark.parametrize("compression", sorted(ALL_CODECS))
def test_read_exr_alpha(tmp_path, compression, channels):
    """read_exr(alpha=True), the downscale tool's read (cv2's
    IMREAD_UNCHANGED): R, G, B and A as [H, W, 4] RGBA where the file has
    A, and what read_exr gives without it otherwise."""
    rng = np.random.default_rng(zlib.crc32(f"{compression} {channels}"
                                           .encode()))
    chans = [(name, "HALF", _samples("HALF", (19, 11), rng))
             for name in CHANNEL_SETS[channels]]
    data, got = encode(chans, compression, values=True)
    path = tmp_path / "a.exr"
    path.write_bytes(data)
    want = _want(got)
    if channels == "ABGR":
        by_name = {n: _expected(v) for n, _, v in got}
        want = np.stack([by_name[c] for c in "RGBA"], -1)
    _same(exr.read_exr(str(path), alpha=True), want)


def test_exr_library_builds():
    """csrc/exr_host.cpp builds with g++ into build/raw_ngp_torch/ under
    a name keyed by the source's hash, and loads."""
    lib = native.exr_library()
    assert lib is not None and lib.exr_host_version() == 1
    so = native.library_path(native.EXR_SOURCE)
    assert so.exists() and so.name.startswith("libexr_host-")


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


# ---------------------------------------------------------------------------
# PIZ, PXR24, B44, B44A, tiles and parts
# ---------------------------------------------------------------------------

ROUTES = ("native", "python")
NEW_CHANNEL_SETS = {"Y": ("Y",), "BGR": ("B", "G", "R"),
                    "ABGR": ("A", "B", "G", "R")}
NEW_SIZES = {"1x1": (1, 1), "37x41": (37, 41), "65x6": (65, 6)}


def _route(route):
    if route == "native" and native.exr_library() is None:
        pytest.skip("the host EXR library does not build here (no g++)")
    return route


def _read(data, tmp_path, route=None):
    path = tmp_path / "f.exr"
    path.write_bytes(data)
    return exr.read_exr(str(path), route)


@pytest.mark.parametrize("size", sorted(NEW_SIZES))
@pytest.mark.parametrize("channels", sorted(NEW_CHANNEL_SETS))
@pytest.mark.parametrize("ptype", sorted(PIXELS))
@pytest.mark.parametrize("compression", sorted(NEW_CODECS))
def test_new_codecs_bitwise(tmp_path, compression, ptype, channels, size):
    """PIZ (32 lines a chunk), PXR24 (16), B44 and B44A (32) x HALF /
    FLOAT / UINT x one channel and RGB(A) x sizes that neither the
    chunks nor the 4 x 4 blocks divide: the samples the encoder stored,
    bit for bit (lossless but for PXR24's 24-bit FLOAT and B44's HALF
    blocks, whose values the encoder's own unpack gives)."""
    H, W = NEW_SIZES[size]
    rng = np.random.default_rng(zlib.crc32(
        f"{compression} {ptype} {channels} {size}".encode()))
    chans = [(name, ptype, _samples(ptype, (H, W), rng))
             for name in NEW_CHANNEL_SETS[channels]]
    if size != "1x1":
        for _, _, s in chans:
            s[: H // 2] = s[0, 0]
    data, want = encode(chans, compression, values=True)
    _same(_read(data, tmp_path), _want(want))


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("shape", [(256, 256), (32, 2048)],
                         ids=["wavelet14", "wavelet16"])
def test_piz_every_half_pattern(tmp_path, shape, route):
    """All 65,536 HALF bit patterns through PIZ by each route: 256 x 256
    is 8 chunks of 8,192 values (the LUT's largest index below 2^14, the
    14-bit wavelet), 32 x 2048 one chunk of all of them (the 16-bit
    modular wavelet)."""
    bits = np.arange(1 << 16, dtype=np.uint16).reshape(shape)
    chans = [("Y", "HALF", bits.view(np.float16))]
    per_chunk = min(32, shape[0]) * shape[1]
    assert (per_chunk > 1 << 14) == (shape[0] == 32)
    got = _read(encode(chans, "PIZ"), tmp_path, _route(route))
    _same(got, bits.view(np.float16).astype(np.float32))


@pytest.mark.parametrize("form", ["14", "16"])
@pytest.mark.parametrize("shape", [(1, 1), (1, 7), (5, 1), (2, 2), (3, 5),
                                   (7, 3), (8, 8), (13, 9), (32, 17),
                                   (9, 40)])
def test_wavelet_decode_inverts_encode(shape, form):
    """exr.wav2_decode undoes this module's wav2Encode (the C loops
    transliterated) on random values of each form's range, on shapes
    with odd lines and columns at every level."""
    ny, nx = shape
    rng = np.random.default_rng(ny * 100 + nx)
    top = (1 << 14) - 1 if form == "14" else (1 << 16) - 1
    a = rng.integers(0, top + 1, shape)
    buf = [int(v) for v in a.reshape(-1)]
    wav2_encode(buf, 0, nx, 1, ny, nx, top)
    coded = np.array(buf).reshape(shape)
    if min(shape) > 1:
        assert not np.array_equal(coded, a)
    np.testing.assert_array_equal(exr.wav2_decode(coded, top), a)


def _single_chunk_file(channels, code, W, H, payload):
    """A one-chunk scanline file of `channels` [(name, pixel type name)]
    whose chunk holds `payload`."""
    chlist = b"".join(n.encode() + b"\0" + struct.pack(
        "<iB3xii", PIXELS[t][0], 0, 1, 1) for n, t in channels) + b"\0"
    head = b"v/1\x01" + struct.pack("<I", 2) + \
        _attr("channels", "chlist", chlist) + \
        _attr("compression", "compression", bytes([code])) + \
        _attr("dataWindow", "box2i", struct.pack("<4i", 0, 0, W - 1,
                                                 H - 1)) + \
        _attr("lineOrder", "lineOrder", b"\0") + b"\0"
    at = len(head) + 8
    return head + struct.pack("<Q", at) + struct.pack("<ii", 0,
                                                      len(payload)) + payload


# PIZ, one line of 32 HALF 1.0 (0x3C00):
#   bitmap: 0x3C00 is bit 0 of byte 0x3C00 >> 3 = 0x780, so min = max =
#     0x0780 (80 07 80 07) and the one byte 01; the LUT maps 0 -> 0 and
#     0x3C00 -> 1, the largest index 1 (the 14-bit wavelet, which on one
#     line does nothing);
#   Huffman of 32 ones: symbol 1 (count 32) and the run symbol 2 (count
#     1), one bit each; canonical: code(1) = 0, code(2) = 1. Header: im 1,
#     iM 2, table 2 bytes, 10 bits, 0. Table: lengths 1, 1 as 6-bit
#     fields 000001 000001, padded: 04 10. Codes: 1 then 31 repeats, the
#     run form being shorter (1 + 1 + 8 < 1 x 31): 0, 1, 00011111 ->
#     01000111 11(000000): 47 C0;
#   the stream's 24 bytes after its int32 length 18 00 00 00.
PIZ_HAND = bytes.fromhex(
    "80078007" "01" "18000000"
    "01000000" "02000000" "02000000" "0a000000" "00000000" "0410" "47c0")
# PXR24, one line of 32 HALF 1.0: the differences 0x3C00, then 31 zeros,
# as a high-byte plane (3C, 31 x 00) and a low-byte plane (32 x 00),
# deflated
PXR24_HAND_PLANES = b"\x3c" + bytes(31) + bytes(32)
# PXR24, one line of 16 FLOAT 0x3F800080 (1 + 2^-16): float24 rounds the
# low byte 0x80 up, 0x3F8001; the planes 3F 00.., 80 00.., 01 00..; read
# back as 0x3F800100
PXR24_HAND_FLOAT = b"\x3f" + bytes(15) + b"\x80" + bytes(15) + b"\x01" + \
    bytes(15)
# B44, one 4 x 4 block: 15 x 1.0 (0x3C00) and 2.0 (0x4000) last. Ordered
# t = h | 0x8000: 0xBC00 and 0xC000 = tMax; at shift 6 the differences
# d = (tMax - t) / 64 are 16 and 0, every r = d_a - d_b + 32 is 32 but
# r14 = d14 - d15 + 32 = 48; t0 = tMax - (16 << 6) = 0xBC00. Bytes: BC 00,
# 6 << 2 | 32 >> 4 = 1A, then the 6-bit fields packed: 08 20 | 82 08 20 |
# 82 08 20 | 82 08 (32 << 6 | 48) & FF = 30.
B44_HAND = bytes.fromhex("bc001a0820820820820820820830")
# B44A, one flat 4 x 4 block of 1.0: t0 = BC 00, then FC
B44A_HAND = bytes.fromhex("bc00fc")


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("case", ["PIZ", "PXR24", "PXR24_FLOAT", "B44",
                                  "B44A"])
def test_hand_worked_streams(tmp_path, case, route):
    """One chunk a codec whose bytes are derived above from the layout;
    the test's encoder gives the same bytes (or planes) and the reader
    the values."""
    one = np.float16(1.0)
    if case == "PIZ":
        chans, code, W, H = [("Y", "HALF")], 4, 32, 1
        payload = PIZ_HAND
        want = np.full((1, 32), 1.0, np.float32)
        assert _piz_chunk([("HALF", np.full((1, 32), one).view(
            np.uint16))]) == payload
    elif case == "PXR24":
        chans, code, W, H = [("Y", "HALF")], 5, 32, 1
        payload = zlib.compress(PXR24_HAND_PLANES)
        want = np.full((1, 32), 1.0, np.float32)
        got, _ = _pxr24_chunk([("HALF", np.full((1, 32), one).view(
            np.uint16))])
        assert zlib.decompress(got) == PXR24_HAND_PLANES
    elif case == "PXR24_FLOAT":
        chans, code, W, H = [("Y", "FLOAT")], 5, 16, 1
        payload = zlib.compress(PXR24_HAND_FLOAT)
        want = np.full((1, 16), 0x3F800100, np.uint32).view(np.float32)
        got, back = _pxr24_chunk([("FLOAT", np.full((1, 16), 0x3F800080,
                                                    np.uint32))])
        assert zlib.decompress(got) == PXR24_HAND_FLOAT
        np.testing.assert_array_equal(back[0], want.view(np.uint32))
    else:
        chans, code, W, H = [("Y", "HALF")], 6 if case == "B44" else 7, 4, 4
        h = np.full((4, 4), one)
        if case == "B44":
            h[3, 3] = 2.0
        payload = B44_HAND if case == "B44" else B44A_HAND
        want = h.astype(np.float32)
        assert b44_pack(list(h.view(np.uint16).reshape(-1)),
                        case == "B44A", True) == payload
    assert len(payload) < W * H * (2 if chans[0][1] == "HALF" else 4)
    data = _single_chunk_file(chans, code, W, H, payload)
    _same(_read(data, tmp_path, _route(route)), want.reshape(H, W))


def test_b44_exp_table_from_its_formula():
    """exr.b44_exp_table (numpy) is this module's table built one half at
    a time with math.exp: 0 for non-finite halves, HALF_MAX from 8 ln
    HALF_MAX up, half(exp(h / 8)) otherwise."""
    _, exp = b44_tables()
    np.testing.assert_array_equal(exr.b44_exp_table(), exp)
    assert exp[np.float16(0).view(np.uint16)] == np.float16(1).view(
        np.uint16)
    assert exp[np.float16(np.inf).view(np.uint16)] == 0


@pytest.mark.parametrize("compression", ["B44", "B44A"])
def test_b44_plinear_channels(tmp_path, compression):
    """pLinear HALF channels (R and B here) go through logTable before
    packing and expTable after unpacking; the encoder's values back bit
    for bit, and near the inputs (log coding keeps the relative error
    small on a smooth image whose blocks keep away from 1, where the
    log changes sign)."""
    H, W = 21, 14
    yy, xx = np.mgrid[:H, :W]
    base = np.exp(2 + np.sin(xx / 6) / 2 + np.cos(yy / 5) / 2).astype(
        np.float16)
    chans = [(c, "HALF", (base * (1 + k)).astype(np.float16))
             for k, c in enumerate("BGR")]
    data, want = encode(chans, compression, values=True,
                        linear=[True, False, True])
    got = _read(data, tmp_path)
    _same(got, _want(want))
    ref = np.stack([chans["BGR".index(c)][2].astype(np.float32)
                    for c in "RGB"], -1)
    assert np.abs(got / ref - 1).max() < 0.02


_TILE_CODECS = ["NONE", "ZIP", "PIZ", "PXR24", "B44A"]


@pytest.mark.parametrize("compression", _TILE_CODECS)
@pytest.mark.parametrize("rounding", [0, 1], ids=["round_down",
                                                  "round_up"])
@pytest.mark.parametrize("mode", [0, 1, 2], ids=["one_level", "mipmap",
                                                 "ripmap"])
def test_tiled_files_read_level_0(tmp_path, mode, rounding, compression):
    """Tiled files (16 x 8 tiles over 37 x 29: edge tiles cropped) in
    each level mode and rounding mode: level (0, 0), whose tiles come
    first in the offset table, bit for bit; the chunk count is the sum
    over the levels."""
    rng = np.random.default_rng(mode * 10 + rounding)
    H, W = 29, 37
    chans = [(c, "HALF", rng.normal(0, 1, (H, W)).astype(np.float16))
             for c in "BGR"]
    data, want = encode(chans, compression, tiles=(16, 8, mode, rounding),
                        values=True, order=2)
    _same(_read(data, tmp_path), _want(want))
    part, _, _ = exr.read_header(data)
    levels = _levels(W, H, mode, rounding)
    assert len(exr.tile_levels(part)) == len(levels)
    assert exr.chunk_count(part) == sum(
        -(-_level_size(W, lx, rounding) // 16)
        * -(-_level_size(H, ly, rounding) // 8) for lx, ly in levels)


_PARTS = {
    "scanline_then_tiled": (None, [("ZIP", (8, 8, 1, 0))]),
    "tiled_then_scanline": ((5, 7, 2, 1), [("PXR24", None)]),
    "three_parts": (None, [("B44", None), ("NONE", (4, 4, 0, 0))]),
}


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("case", sorted(_PARTS))
def test_multipart_reads_part_0(tmp_path, case, route):
    """Multipart files (a header a part, an empty header, the parts'
    offset tables, every chunk led by its part's number; the parts'
    chunks interleaved): part 0, PIZ, as InputFile reads it; the other
    parts (another channel set, size and compression) are skipped."""
    tiles, others = _PARTS[case]
    rng = np.random.default_rng(len(case))
    chans = [(c, "FLOAT", rng.normal(0, 1, (23, 18)).astype(np.float32))
             for c in "BGR"]
    other = [("Z", "UINT", rng.integers(0, 99, (9, 31)).astype(np.uint32))]
    data, want = encode(chans, "PIZ", tiles=tiles, values=True,
                        parts=[(other, z, t) for z, t in others])
    _same(_read(data, tmp_path, _route(route)), _want(want))


@pytest.mark.parametrize("compression", sorted(NEW_CODECS))
def test_routes_and_line_orders_alike(tmp_path, compression):
    """A 3-channel FLOAT file of 100 x 70 decreasing and in shuffled chunk
    order: the PIZ routes alike, every codec the increasing file's
    values."""
    rng = np.random.default_rng(4)
    yy, xx = np.mgrid[:100, :70]
    chans = [(c, "FLOAT", (np.sin(xx / 7 + k) * np.cos(yy / 5) + rng.normal(
        0, 1e-3, (100, 70))).astype(np.float32)) for k, c in enumerate(
        "BGR")]
    base, want = encode(chans, compression, values=True)
    ref = _read(base, tmp_path)
    _same(ref, _want(want))
    for order in (1, 2):
        data = encode(chans, compression, order=order)
        for route in ROUTES if compression == "PIZ" else (None,):
            if route == "native":
                _route(route)
            _same(_read(data, tmp_path, route), ref)


@pytest.mark.parametrize("damage", ["huffman_cut", "bitmap_cut",
                                    "wrong_count", "bad_table"])
@pytest.mark.parametrize("route", ROUTES)
def test_corrupt_piz_chunks_raise(tmp_path, route, damage):
    """A PIZ chunk cut short, with a bitmap past its end, decoding to
    more values than the chunk holds or with an over-full code table:
    ValueError naming the file, by either route."""
    payload = bytearray(PIZ_HAND)
    if damage == "huffman_cut":
        payload = payload[:-1]
    elif damage == "bitmap_cut":
        payload = payload[:4]
    elif damage == "wrong_count":
        payload[-2] = 0x48                     # a run of 32: 33 values
    else:
        # im 0, iM 2 and three codes of length 1 (000001 x 3: 04 10 40)
        huf = struct.pack("<5i", 0, 2, 3, 10, 0) + bytes.fromhex("041040") \
            + PIZ_HAND[-2:]
        payload = PIZ_HAND[:5] + struct.pack("<i", len(huf)) + huf
    data = _single_chunk_file([("Y", "HALF")], 4, 32, 1, bytes(payload))
    with pytest.raises(ValueError, match="OpenEXR"):
        _read(data, tmp_path, _route(route))


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_write_exr_as_cv2_reads_back(tmp_path, channels):
    """exr.write_exr (cv2.imwrite's encoder: FLOAT, ZIP, Y; B, G, R; or A,
    B, G, R) reads back bit for bit, NaNs and infinities included."""
    rng = np.random.default_rng(channels)
    shape = (35, 21) if channels == 1 else (35, 21, channels)
    img = rng.lognormal(0, 3, shape).astype(np.float32)
    img[:9] = 0.5
    img.reshape(-1)[:3] = [np.nan, np.inf, -0.0]
    path = str(tmp_path / "cv.exr")
    data = exr.write_exr(path, img)
    part, _, multipart = exr.read_header(data)
    assert not multipart and part.compression == 3
    assert [c[:2] for c in part.channels] == (
        [("Y", 2)] if channels == 1 else
        [(c, 2) for c in "ABGR"[4 - channels:]])
    _same(exr.read_exr(path, alpha=True), img)


def _dwa_writer_agrees(data, got, tmp_path):
    """chip_smoke.write_exr's DWA file and values held to
    test_torch_exr_dwa's scalar model: the port reads the model's values
    bit for bit (both routes) within the tolerance of the float64
    decode, inside the writer's band, and the writer's values are the
    model's float64 decode through toLinear (but where the two float64
    forms round across a half's tie)."""
    import test_torch_exr_dwa as dwa_t
    read, dct = dwa_t._check_file(data, tmp_path, "BGR" if got.values.ndim
                                  == 3 else "Y")
    assert dct > 0
    assert ((got.lo <= read) & (read <= got.hi)).all()
    part, planes = dwa_t.model_file(data)
    names = [n for n, _, _ in part.channels]
    ref = [dwa_t.table("linear")[p["ref"].astype(np.float16).view(
        np.uint16)].view(np.float16).astype(np.float32) for p in planes]
    ref = ref[0] if len(ref) == 1 else np.stack(
        [ref[names.index(c)] for c in "RGB"], -1)
    dct_samples = ~np.isnan(np.stack([p["ref"] for p in planes], -1)
                            .reshape(ref.shape))
    assert (ref == got.values)[dct_samples].mean() > 0.999


@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("pixel", ["HALF", "FLOAT"])
@pytest.mark.parametrize("compression", sorted(NEW_CODECS) +
                         sorted(DWA_CODECS))
def test_chip_smoke_writer_new_codecs(tmp_path, compression, pixel,
                                      channels):
    """chip_smoke.write_exr's vectorised PIZ, PXR24, B44, B44A, DWAA and
    DWAB (the card's captures and frames): the file reads back as the
    values the writer reports, and those are this module's scalar
    encoder's (B44's blocks and PXR24's 24-bit floats included); DWA
    files as _dwa_writer_agrees holds them."""
    rng = np.random.default_rng(6)
    shape = (45, 38) if channels == 1 else (45, 38, 3)
    img = rng.lognormal(-1, 2, shape).astype(np.float32)
    img[:10] = 0.25
    path = str(tmp_path / "w.exr")
    if compression in DWA_CODECS:
        import test_torch_exr_dwa as dwa_t
        yy, xx = np.mgrid[:70, :90]
        img = (0.5 + 0.4 * np.sin(xx / 6) * np.cos(yy / 9) + rng.normal(
            0, 0.002, (70, 90))).astype(np.float32) * 2
        if channels == 3:
            img = np.stack([img, img[::-1], img[:, ::-1]], -1)
        data, got = chip_smoke.write_exr(path, img, compression, pixel,
                                         values=True)
        _dwa_writer_agrees(data, got, tmp_path)
        return
    _, got = chip_smoke.write_exr(path, img, compression, pixel,
                                  values=True)
    dtype = np.float16 if pixel == "HALF" else np.float32
    planes = [img] if channels == 1 else [img[..., "RGB".index(c)]
                                          for c in "BGR"]
    chans = [(c, pixel, p.astype(dtype)) for c, p in zip(
        ["Y"] if channels == 1 else ["B", "G", "R"], planes)]
    _, want = encode(chans, compression, values=True)
    _same(got, _want(want))
    _same(exr.read_exr(path), got)


_WRITER_LAYOUTS = {
    "tiled_mipmap": ("PIZ", dict(tiles=(48, 40, 1, 0))),
    "tiled_ripmap_up": ("PIZ", dict(tiles=(48, 40, 2, 1))),
    "two_part": ("PIZ", "second"),
    "dwaa_tiled_mipmap": ("DWAA", dict(tiles=(48, 40, 1, 0))),
    "dwaa_tiled_ripmap_up": ("DWAA", dict(tiles=(48, 40, 2, 1))),
    "dwaa_two_part": ("DWAA", "second"),
    "dwab_tiled_mipmap": ("DWAB", dict(tiles=(48, 40, 1, 0))),
    "dwab_tiled_ripmap_up": ("DWAB", dict(tiles=(48, 40, 2, 1))),
    "dwab_two_part": ("DWAB", "second"),
}


@pytest.mark.parametrize("layout", sorted(_WRITER_LAYOUTS))
def test_chip_smoke_writer_tiles_and_parts(tmp_path, layout):
    """chip_smoke.write_exr's tiled PIZ, DWAA and DWAB parts (48 x 40
    tiles, which do not divide 100 x 70) and its two-part files read back
    bit for bit (DWA: as _dwa_writer_agrees holds them)."""
    codec, kwargs = _WRITER_LAYOUTS[layout]
    img = np.random.default_rng(8).lognormal(-1, 1, (70, 100)).astype(
        np.float32)
    if codec != "PIZ":
        yy, xx = np.mgrid[:70, :100]
        img = (0.6 + 0.4 * np.sin(xx / 9) * np.cos(yy / 7)).astype(
            np.float32)
    if kwargs == "second":
        kwargs = dict(second=(img[::2, ::2], "ZIP", "FLOAT", (32, 32, 0, 0)))
    path = str(tmp_path / "t.exr")
    data, got = chip_smoke.write_exr(path, img, codec, "HALF", values=True,
                                     **kwargs)
    part, _, multipart = exr.read_header(data)
    assert multipart == layout.endswith("two_part")
    if codec != "PIZ":
        _dwa_writer_agrees(data, got, tmp_path)
        return
    _same(got, img.astype(np.float16).astype(np.float32))
    _same(exr.read_exr(path), got)


_UNSUPPORTED = {
    "deep": dict(version_flags=exr.DEEP),
    "deepscanline": dict(attrs=[("type", "string", b"deepscanline")]),
}
# features the reader once refused and now reads: each case reads back
_NOW_READ = {
    "PIZ": dict(compression="PIZ"), "PXR24": dict(compression="PXR24"),
    "B44": dict(compression="B44"), "B44A": dict(compression="B44A"),
    "tiled": dict(tiles=(3, 3, 0, 0)),
    "multipart": dict(parts=[([("Z", "FLOAT", np.ones((2, 5), np.float32))],
                              "ZIP", None)]),
    "DWAA": dict(compression="DWAA"), "DWAB": dict(compression="DWAB"),
    "subsampled": dict(sampling=(2, 2)),
}


@pytest.mark.parametrize("feature", sorted(_UNSUPPORTED) + sorted(_NOW_READ))
def test_unsupported_features_raise_with_their_name(tmp_path, feature):
    """What the reader leaves out raises NotImplementedError with its
    name; the features it reads since PIZ, PXR24, B44 and B44A, tiled and
    multipart files, DWAA and DWAB and subsampled channels were ported
    read back instead: bit for bit, DWA (a 48 x 32 image, so that its
    chunks are coded) within test_torch_exr_dwa's tolerance of the
    float64 decode of the stored coefficients, and a 2 x 2 subsampled
    channel each sample over its pixels."""
    rng = np.random.default_rng(len(feature))
    shape = (32, 48) if feature.startswith("DWA") else (4, 4)
    yy, xx = np.mgrid[:shape[0], :shape[1]]
    chans = [("Y", "HALF", (rng.normal(0, 1, shape) if shape == (4, 4) else
                            np.sin(xx / 5) + np.cos(yy / 7)).astype(
                                np.float16))]
    path = tmp_path / "u.exr"
    kwargs = dict(_UNSUPPORTED.get(feature) or _NOW_READ[feature])
    compression = kwargs.pop("compression", "NONE")
    data, want = encode(chans, compression, values=True, **kwargs)
    path.write_bytes(data)
    if feature.startswith("DWA"):
        import test_torch_exr_dwa as dwa_t
        got = exr.read_exr(str(path))
        part, planes = dwa_t.model_file(data)
        lo, hi = dwa_t.band(planes[0]["ref"], planes[0]["tol"], True)
        assert (~np.isnan(planes[0]["ref"])).all()
        assert ((lo <= got) & (got <= hi)).all()
        assert np.abs(got - chans[0][2]).max() < 0.5
        return
    if feature in _NOW_READ:
        _same(exr.read_exr(str(path)), _want(want))
        return
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
