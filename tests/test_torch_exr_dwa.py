"""The port's DWAA / DWAB decoder (raw_ngp_torch/data/exr_dwa.py, its AC
runs in raw_ngp_torch/csrc/exr_host.cpp) and subsampled channels in every
codec (raw_ngp_torch/data/exr.py), on the CPU.

No OpenEXR library is installed here, so, as in test_torch_exr.py, the
files are assembled from the published layout (OpenEXR's
ImfDwaCompressor.cpp, ImfDwaCompressorSimd.h and dwaLookups.cpp; cv2's
grfmt_exr.cpp for luminance-chroma files) by this module's own scalar
code, one value at a time:

* an encoder (``dwa_chunk``): the channel rules and classes, the mirrored
  edge blocks, toNonlinear, the forward Rec. 709 conversion, a float64
  DCT, a quantiser that zeroes small AC coefficients, the zig-zag order,
  rleAc's runs, then PIZ's Huffman coder or zlib for the AC values, the
  ZIP predictor for the DC values, the RLE class's byte planes and
  run-length code, the UNKNOWN class raw;
* a decode model (``model_chunk``), the test's reference: the sections
  parsed again, the runs expanded, and each block in float32 in the
  order of dctInverse8x8_scalar (its zeroed-rows variants picked by the
  last literal, and dctInverse8x8DcOnly), csc709Inverse, the half's
  rounding and the toLinear table built value by value from its formula.
  Its Huffman stage is the port's Python oracle, which
  test_torch_exr.py's PIZ cases hold;
* beside it a float64 inverse DCT (and conversion) of the same stored
  coefficients. The tolerance: every sample before toLinear within one
  half-ulp of the float64 value plus the float32 arithmetic's own error,
  2^-20 times the sum of the block's (the CSC set's) absolute
  coefficients, which bounds what the float32 sums lose where a block's
  large coefficients cancel to a small value. On every case here the
  plain one half-ulp holds too, and the tests assert both.

The cases: DWAA and DWAB with one channel Y, R G B (a CSC set), R G B A
(A in the RLE class), an UNKNOWN-class channel, HALF and FLOAT, sizes
that neither 8 nor the chunk height divide, STATIC_HUFFMAN and DEFLATE
AC, version-1 and version-2 rules, tiled and multipart files: the Python
route bit for bit the model, the native route bit for bit the Python
route, and the model within the tolerance of the float64 decode;
toLinear on all 65,536 halves; hand-worked chunks; every lastNonZero row
case; corrupt chunks; subsampled channels in every codec; Y / RY / BY
files by cv2's conversion, with and without chromaticities.

The module runs on one torch and BLAS thread (test_torch_exr's fixture).
"""

import math
import struct
import zlib

import numpy as np
import pytest

from raw_ngp_torch.data import exr, exr_dwa
from test_torch_exr import (  # noqa: F401  (_one_thread: the fixture)
    ALL_CODECS, DWA_CODECS, PIXELS, ROUTES, _one_thread, _predict, _rle,
    _route, _same, _single_chunk_file, encode, huf_compress)

HALF_MAX = 65504.0
UNKNOWN, LOSSY_DCT, RLE = 0, 1, 2
TYPE = {"UINT": 0, "HALF": 1, "FLOAT": 2}
F = np.float32


# ---------------------------------------------------------------------------
# scalar halves and the tables
# ---------------------------------------------------------------------------

def half_bits(x) -> int:
    """The bits of float32 `x` as a half, rounded to nearest even."""
    with np.errstate(over="ignore"):
        return int(np.float16(F(x)).view(np.uint16))


def half_value(bits: int) -> float:
    return float(np.uint16(bits).view(np.float16))


LOG_BASE = float(F(math.pow(2.7182818, 2.2)))


def _to_linear_one(i: int) -> int:
    """dwaLookups.cpp's generateToLinear for one half."""
    if i & 0x7C00 == 0x7C00 or i == 0:
        return 0
    h = half_value(i)
    sign = -1.0 if h < 0 else 1.0
    a = abs(h)
    if a <= 1.0:
        v = float(F(math.pow(a, float(F(2.2)))))
    else:
        try:
            v = math.pow(LOG_BASE, float(F(a - 1.0)))
        except OverflowError:
            v = math.inf
        with np.errstate(over="ignore"):
            v = float(F(v))
    return half_bits(F(sign) * F(v))


def _to_nonlinear_one(i: int) -> int:
    """dwaLookups.cpp's generateToNonlinear for one half."""
    if i & 0x7C00 == 0x7C00 or i == 0:
        return 0
    h = half_value(i)
    sign = -1.0 if h < 0 else 1.0
    a = abs(h)
    if a <= 1.0:
        v = F(math.pow(a, float(F(1.0) / F(2.2))))
    else:
        v = F(math.log(a) / math.log(LOG_BASE) + 1.0)
    return half_bits(F(sign) * v)


_TABLES = {}


def table(name):
    if name not in _TABLES:
        one = _to_linear_one if name == "linear" else _to_nonlinear_one
        _TABLES[name] = np.array([one(i) for i in range(1 << 16)],
                                 np.uint16)
    return _TABLES[name]


# ---------------------------------------------------------------------------
# rules and classes
# ---------------------------------------------------------------------------

# DwaCompressor::initializeDefaultChannelRules and
# initializeLegacyChannelRules: (suffix, scheme, type, CSC index,
# case-insensitive)
DEFAULT_RULES = [
    ("R", 1, 1, 0, False), ("R", 1, 2, 0, False),
    ("G", 1, 1, 1, False), ("G", 1, 2, 1, False),
    ("B", 1, 1, 2, False), ("B", 1, 2, 2, False),
    ("Y", 1, 1, -1, False), ("Y", 1, 2, -1, False),
    ("BY", 1, 1, -1, False), ("BY", 1, 2, -1, False),
    ("RY", 1, 1, -1, False), ("RY", 1, 2, -1, False),
    ("A", 2, 0, -1, False), ("A", 2, 1, -1, False), ("A", 2, 2, -1, False)]
LEGACY_RULES = [
    ("r", 1, 1, 0, True), ("red", 1, 1, 0, True),
    ("g", 1, 1, 1, True), ("grn", 1, 1, 1, True), ("green", 1, 1, 1, True),
    ("b", 1, 1, 2, True), ("blu", 1, 1, 2, True), ("blue", 1, 1, 2, True),
    ("y", 1, 1, -1, True), ("by", 1, 1, -1, True), ("ry", 1, 1, -1, True),
    ("a", 2, 0, -1, True), ("a", 2, 1, -1, True), ("a", 2, 2, -1, True)]


def classify(names, types, sampling, rules):
    """classifyChannels: each channel's scheme (the last matching rule's)
    and the CSC sets in the order of their prefixes."""
    schemes, sets = [], {}
    for k, (name, ptype) in enumerate(zip(names, types)):
        prefix, suffix = "", name
        if "." in name:
            prefix, suffix = name[:name.rfind(".")], name[name.rfind(".")
                                                          + 1:]
        sets.setdefault(prefix, [-1, -1, -1])
        scheme = UNKNOWN
        for r_suffix, r_scheme, r_type, r_csc, nocase in rules:
            if r_type == ptype and (suffix.lower() if nocase else suffix) \
                    == r_suffix:
                scheme = r_scheme
                if r_csc >= 0:
                    sets[prefix][r_csc] = k
        schemes.append(scheme)
    csc = [tuple(sets[p]) for p in sorted(sets) if min(sets[p]) >= 0 and
           len({sampling[c] for c in sets[p]}) == 1]
    return schemes, csc


def _decoders(schemes, csc):
    done = {c for s in csc for c in s}
    return [list(s) for s in csc] + [[k] for k, s in enumerate(schemes)
                                     if s == LOSSY_DCT and k not in done]


# ---------------------------------------------------------------------------
# the encoder
# ---------------------------------------------------------------------------

ZIG = [0, 1, 5, 6, 14, 15, 27, 28, 2, 4, 7, 13, 16, 26, 29, 42,
       3, 8, 12, 17, 25, 30, 41, 43, 9, 11, 18, 24, 31, 40, 44, 53,
       10, 19, 23, 32, 39, 45, 52, 54, 20, 22, 33, 38, 46, 51, 55, 60,
       21, 34, 37, 47, 50, 56, 59, 61, 35, 36, 48, 49, 57, 58, 62, 63]


def _dct_matrix():
    c = np.zeros((8, 8))
    for k in range(8):
        for n in range(8):
            c[k, n] = (math.sqrt(1 / 8) if k == 0 else 0.5) * \
                math.cos((2 * n + 1) * k * math.pi / 16)
    return c


DCT = _dct_matrix()


def _mirror(v, n):
    """The encoder's edge padding: the last row / column mirrored."""
    if v >= n:
        v = n - (v - (n - 1))
    return n - 1 if v < 0 else v


def _rle_ac(zz):
    """LossyDctEncoderBase::rleAc of 64 half bits (zig-zag order)."""
    out, k = [], 1
    while k < 64:
        if zz[k] != 0:
            out.append(zz[k])
            k += 1
            continue
        run = 1
        while k + run < 64 and zz[k + run] == 0:
            run += 1
        if run == 1:
            out.append(zz[k])
        elif k + run == 64:
            out.append(0xFF00)
        else:
            out.append(0xFF00 | run)
        k += run
    return out


def quantise(coef, step):
    """The zig-zag halves of float64 DCT coefficients [8, 8] (raster):
    each rounded to half, the AC ones zeroed below step (1 + k / 8) at
    zig-zag index k."""
    zz = [0] * 64
    for r in range(64):
        k = ZIG[r]
        c = float(coef[r // 8, r % 8])
        if k and abs(c) < step * (1 + k / 8):
            continue
        zz[k] = int(np.float16(c).view(np.uint16))
    return zz


def dwa_chunk(chans, version=2, ac=0, step=2.0 ** -7, coefs=None,
              rules=None, tail=b"", sampling=None):
    """A DWA chunk of `chans` [(name, pixel type name, bits [rows,
    samples], pLinear)] in the header's order: `version` 1 (legacy rules)
    or 2 (the default rules stored; `rules` others), AC `ac` 0
    STATIC_HUFFMAN or 1 DEFLATE, the quantiser's `step`; `coefs` {(decoder,
    block, component): 64 zig-zag half bits} stores those coefficients
    instead; `tail` bytes after the sections; `sampling` the channels'
    (x, y) sampling (a CSC set's must agree)."""
    names = [c[0] for c in chans]
    types = [TYPE[c[1]] for c in chans]
    shapes = [c[2].shape for c in chans]
    rules = rules if rules is not None else (
        DEFAULT_RULES if version == 2 else LEGACY_RULES)
    schemes, csc = classify(names, types, sampling or [(1, 1)] * len(chans),
                            rules)
    unknown, planes = bytearray(), bytearray()
    for (name, ptype, bits, _), s in zip(chans, schemes):
        w = 2 if ptype == "HALF" else 4
        flat = [int(v) for v in bits.reshape(-1)]
        if s == UNKNOWN:
            for v in flat:
                unknown += v.to_bytes(w, "little")
        elif s == RLE:
            for j in range(w):
                planes += bytes((v >> (8 * j)) & 255 for v in flat)
    to_nl = table("nonlinear")
    ac_vals, dc_vals = [], []
    for d, comps in enumerate(_decoders(schemes, csc)):
        ny, nx = shapes[comps[0]]
        halves = []
        for c in comps:
            bits = chans[c][2]
            if chans[c][1] == "FLOAT":
                halves.append([[half_bits(max(min(F(HALF_MAX), v),
                                              F(-HALF_MAX)))
                                for v in row.view(np.float32)]
                               for row in bits])
            else:
                halves.append([[int(v) for v in row] for row in bits])
        nby, nbx = -(-ny // 8), -(-nx // 8)
        dcs = [[] for _ in comps]
        for blk in range(nby * nbx):
            by, bx = divmod(blk, nbx)
            x = []
            for j, c in enumerate(comps):
                lut = len(comps) == 3 or not chans[c][3]
                x.append([[F(half_value(
                    to_nl[h] if lut else h))
                    for h in [halves[j][_mirror(8 * by + i, ny)][
                        _mirror(8 * bx + k, nx)] for k in range(8)]]
                    for i in range(8)])
            if len(comps) == 3:
                for i in range(8):
                    for k in range(8):
                        r, g, b = x[0][i][k], x[1][i][k], x[2][i][k]
                        x[0][i][k] = F(0.2126) * r + F(0.7152) * g + \
                            F(0.0722) * b
                        x[1][i][k] = F(-0.1146) * r - F(0.3854) * g + \
                            F(0.5000) * b
                        x[2][i][k] = F(0.5000) * r - F(0.4542) * g - \
                            F(0.0458) * b
            for j in range(len(comps)):
                if coefs is not None and (d, blk, j) in coefs:
                    zz = list(coefs[(d, blk, j)])
                else:
                    zz = quantise(DCT @ np.array(x[j], np.float64) @ DCT.T,
                                  step)
                dcs[j].append(zz[0])
                ac_vals += _rle_ac(zz)
        for j in range(len(comps)):
            dc_vals += dcs[j]
    unknown_z = zlib.compress(bytes(unknown)) if unknown else b""
    if not ac_vals:
        ac_z = b""
    elif ac == 0:
        ac_z = huf_compress(ac_vals)
    else:
        ac_z = zlib.compress(struct.pack(f"<{len(ac_vals)}H", *ac_vals))
    dc_z = zlib.compress(_predict(struct.pack(f"<{len(dc_vals)}H",
                                              *dc_vals))) if dc_vals else b""
    rle = _rle(bytes(planes)) if planes else b""
    rle_z = zlib.compress(rle) if planes else b""
    counts = [version, len(unknown), len(unknown_z), len(ac_z), len(dc_z),
              len(rle_z), len(rle), len(planes), len(ac_vals), len(dc_vals),
              ac]
    head = struct.pack("<11Q", *counts)
    if version == 2:
        body = b"".join(s.encode() + b"\0" + bytes(
            [(((csc_i + 1) & 15) << 4) | (scheme << 2) | int(nocase), t])
            for s, scheme, t, csc_i, nocase in rules)
        head += struct.pack("<H", len(body) + 2) + body
    return head + unknown_z + ac_z + dc_z + rle_z + tail


# ---------------------------------------------------------------------------
# the decode model
# ---------------------------------------------------------------------------

def _cos(k, n):
    angle = F(F(k) * F(3.14159)) / F(n) if k != 1 else F(3.14159) / F(n)
    return F(0.5) * F(math.cos(float(angle)))


A, B, C, D = _cos(1, 4), _cos(1, 16), _cos(1, 8), _cos(3, 16)
E, FF, G = _cos(5, 16), _cos(3, 8), _cos(7, 16)
ROW_START = [2, 3, 9, 10, 20, 21, 35]


def _idct_1d(r, k=(A, B, C, D, E, FF, G)):
    """The 1-D step of dctInverse8x8_scalar in its order, with the
    constants a..g `k` (float32 by default)."""
    a, b, c, d, e, f, g = k
    alpha = [c * r[2], f * r[2], c * r[6], f * r[6]]
    beta = [b * r[1] + d * r[3] + e * r[5] + g * r[7],
            d * r[1] - g * r[3] - b * r[5] - e * r[7],
            e * r[1] - b * r[3] + g * r[5] + d * r[7],
            g * r[1] - e * r[3] + d * r[5] - b * r[7]]
    theta = [a * (r[0] + r[4]), alpha[0] + alpha[3], alpha[1] - alpha[2],
             a * (r[0] - r[4])]
    gamma = [theta[0] + theta[1], theta[3] + theta[2], theta[3] - theta[2],
             theta[0] - theta[1]]
    return [gamma[0] + beta[0], gamma[1] + beta[1], gamma[2] + beta[2],
            gamma[3] + beta[3], gamma[3] - beta[3], gamma[2] - beta[2],
            gamma[1] - beta[1], gamma[0] - beta[0]]


def idct_scalar(data, zeroed_rows):
    """dctInverse8x8_scalar<zeroedRows> on 64 float32 values (raster)."""
    data = list(data)
    for row in range(8 - zeroed_rows):
        data[8 * row:8 * row + 8] = _idct_1d(data[8 * row:8 * row + 8])
    for col in range(8):
        out = _idct_1d([data[8 * k + col] for k in range(8)])
        for k in range(8):
            data[8 * k + col] = out[k]
    return data


def _matrix64():
    """The 1-D step as a float64 matrix (its constants widened)."""
    k = tuple(float(v) for v in (A, B, C, D, E, FF, G))
    m = np.zeros((8, 8))
    for j in range(8):
        m[:, j] = _idct_1d([1.0 if i == j else 0.0 for i in range(8)], k)
    return m


M64 = _matrix64()


def idct64(coef):
    """The float64 inverse DCT [8, 8] of 64 coefficients (raster): rows
    then columns through M64."""
    return M64 @ np.array(coef, np.float64).reshape(8, 8) @ M64.T


def _unrle(vals, at):
    zz, k, last = [0] * 64, 1, 0
    while k < 64:
        if at >= len(vals):
            raise ValueError("the AC stream ends")
        v = vals[at]
        at += 1
        if v == 0xFF00:
            k = 64
        elif v >> 8 == 0xFF:
            k += v & 0xFF
        else:
            zz[k] = v
            last = k
            k += 1
    return zz, last, at


def _rle_decode(data):
    out = bytearray()
    i = 0
    while i < len(data):
        n = struct.unpack("b", data[i:i + 1])[0]
        i += 1
        if n < 0:
            out += data[i:i - n]
            i -= n
        else:
            out += data[i:i + 1] * (n + 1)
            i += 1
    return bytes(out)


def _unpredict(data):
    t = list(data)
    for i in range(1, len(t)):
        t[i] = (t[i - 1] + t[i] - 128) & 255
    half = (len(t) + 1) // 2
    out = [0] * len(t)
    out[0::2], out[1::2] = t[:half], t[half:]
    return bytes(out)


def model_chunk(packed, meta, shapes, sampling=None):
    """The decode model of one DWA chunk: `meta` [(name, pixel type name,
    pLinear)], `shapes` each channel's (rows, samples). Returns a dict a
    channel: "bits" (what the reader must give, uint16 / uint32 [rows,
    samples]), and for a LOSSY_DCT channel "nonlinear" (the halves before
    toLinear), "ref" (the float64 decode) and "tol" (the tolerance)."""
    counts = struct.unpack("<11Q", packed[:88])
    (version, u_raw, u_z, ac_z, dc_z, rle_z, rle_n, rle_raw, n_ac, n_dc,
     ac_code) = counts
    pos = 88
    if version == 2:
        size = struct.unpack("<H", packed[pos:pos + 2])[0]
        end, at, rules = pos + size, pos + 2, []
        while at < end:
            stop = packed.index(b"\0", at)
            flags, t = packed[stop + 1], packed[stop + 2]
            rules.append((packed[at:stop].decode(), (flags >> 2) & 3, t,
                          (flags >> 4) - 1, bool(flags & 1)))
            at = stop + 3
        pos = end
    else:
        rules = LEGACY_RULES
    names = [m[0] for m in meta]
    types = [TYPE[m[1]] for m in meta]
    schemes, csc = classify(names, types, sampling or [(1, 1)] * len(meta),
                            rules)
    sections = []
    for n in (u_z, ac_z, dc_z, rle_z):
        sections.append(packed[pos:pos + n])
        pos += n
    out = [dict() for _ in meta]
    unknown = zlib.decompress(sections[0]) if u_z else b""
    planes = _rle_decode(zlib.decompress(sections[3])) if rle_z else b""
    at_u = at_r = 0
    for k, ((ny, nx), m, s) in enumerate(zip(shapes, meta, schemes)):
        w = 2 if m[1] == "HALF" else 4
        dtype = np.uint16 if w == 2 else np.uint32
        if s == UNKNOWN:
            vals = [int.from_bytes(unknown[at_u + w * i:at_u + w * i + w],
                                   "little") for i in range(ny * nx)]
            at_u += w * ny * nx
            out[k]["bits"] = np.array(vals, dtype).reshape(ny, nx)
        elif s == RLE:
            n = ny * nx
            vals = [sum(planes[at_r + j * n + i] << (8 * j)
                        for j in range(w)) for i in range(n)]
            at_r += w * n
            out[k]["bits"] = np.array(vals, dtype).reshape(ny, nx)
    ac_vals = []
    if n_ac:
        ac_vals = [int(v) for v in (
            exr._huf_decode_python(sections[1], n_ac) if ac_code == 0 else
            np.frombuffer(zlib.decompress(sections[1]), "<u2"))]
    dc_raw = _unpredict(zlib.decompress(sections[2])) if n_dc else b""
    dc_vals = list(struct.unpack(f"<{n_dc}H", dc_raw))
    lin = table("linear")
    at_ac = at_dc = 0
    for comps in _decoders(schemes, csc):
        ny, nx = shapes[comps[0]]
        nby, nbx = -(-ny // 8), -(-nx // 8)
        nb, m = nby * nbx, len(comps)
        dcs = [dc_vals[at_dc + j * nb:at_dc + (j + 1) * nb]
               for j in range(m)]
        at_dc += m * nb
        res = {c: (np.zeros((8 * nby, 8 * nbx), np.uint16),
                   np.zeros((8 * nby, 8 * nbx)), np.zeros((8 * nby,
                                                           8 * nbx)))
               for c in comps}
        for blk in range(nb):
            by, bx = divmod(blk, nbx)
            f32, f64, total = [], [], 0.0
            for j in range(m):
                zz, last, at_ac = _unrle(ac_vals, at_ac)
                zz[0] = dcs[j][blk]
                coef = [F(half_value(zz[ZIG[r]])) for r in range(64)]
                total += sum(abs(float(v)) for v in coef)
                f64.append(idct64(coef))
                if last == 0:
                    v = coef[0] * F(3.535536e-01) * F(3.535536e-01)
                    f32.append([v] * 64)
                    continue
                zeroed = sum(last < s for s in ROW_START)
                f32.append(idct_scalar(coef, zeroed))
            if m == 3:
                y, cb, cr = f32
                f32 = [[y[i] + F(1.5747) * cr[i] for i in range(64)],
                       [y[i] - F(0.1873) * cb[i] - F(0.4682) * cr[i]
                        for i in range(64)],
                       [y[i] + F(1.8556) * cb[i] for i in range(64)]]
                y, cb, cr = f64
                k1, k2, k3, k4 = (float(F(v)) for v in (1.5747, 0.1873,
                                                        0.4682, 1.8556))
                f64 = [y + k1 * cr, y - k2 * cb - k3 * cr, y + k4 * cb]
            for j, c in enumerate(comps):
                h, r, t = res[c]
                block = np.array([half_bits(v) for v in f32[j]],
                                 np.uint16).reshape(8, 8)
                h[8 * by:8 * by + 8, 8 * bx:8 * bx + 8] = block
                r[8 * by:8 * by + 8, 8 * bx:8 * bx + 8] = f64[j]
                t[8 * by:8 * by + 8, 8 * bx:8 * bx + 8] = 2.0 ** -20 * total
        for c in comps:
            h, r, t = (a[:ny, :nx] for a in res[c])
            lut = m == 3 or not meta[c][2]
            final = lin[h] if lut else h
            if meta[c][1] == "FLOAT":
                final = final.view(np.float16).astype(np.float32).view(
                    np.uint32)
            out[c].update(bits=final, nonlinear=h, ref=r, tol=t)
    assert at_ac == n_ac and at_dc == n_dc
    return out


def within(nonlinear, ref, tol):
    """Where halves before toLinear lie within one half-ulp of the
    float64 decode `ref` plus `tol`."""
    got = nonlinear.view(np.float16).astype(np.float64)
    with np.errstate(invalid="ignore"):
        ulp = np.spacing(np.abs(ref).astype(np.float16)).astype(np.float64)
    return np.abs(got - ref) <= ulp + tol


def band(ref, tol, linear):
    """The float32 values a reader may give for samples within the
    tolerance: [lo, hi], through toLinear where `linear`."""
    lo = (ref - tol - np.spacing(np.abs(ref).astype(np.float16))).astype(
        np.float16)
    hi = (ref + tol + np.spacing(np.abs(ref).astype(np.float16))).astype(
        np.float16)
    if linear:
        lin = table("linear")
        lo = lin[lo.view(np.uint16)].view(np.float16)
        hi = lin[hi.view(np.uint16)].view(np.float16)
    return lo.astype(np.float32), hi.astype(np.float32)


# ---------------------------------------------------------------------------
# files through the model
# ---------------------------------------------------------------------------

def model_file(data, route=None):
    """Part 0 of a DWA file through the decode model chunk by chunk (the
    framing read by exr.read_header and exr._chunks; chunks stored raw
    read as they are): each channel's "bits", "nonlinear", "ref" and
    "tol" planes at its sampling, and the port's halves before toLinear
    ("port_nonlinear", exr_dwa.decode_chunk by `route`)."""
    part, pos, multipart = exr.read_header(data)
    H, W = part.size
    sampling = part.samplings
    meta = [(n, {0: "UINT", 1: "HALF", 2: "FLOAT"}[t], lin)
            for n, t, lin in part.channels]
    lib = exr._library(route)
    planes = [{k: np.zeros((H // ys, W // xs), dt) for k, dt in (
        ("bits", np.uint16 if t == "HALF" else np.uint32),
        ("nonlinear", np.uint16), ("port_nonlinear", np.uint16),
        ("ref", np.float64), ("tol", np.float64))}
        for (_, t, _), (xs, ys) in zip(meta, sampling)]
    y0 = part.data_window[1]
    for x, y, width, lines, packed in exr._chunks(data, part, pos, multipart,
                                                  "<model>"):
        shapes, _ = exr.chunk_shapes(width, lines, part.sampling, y0 + y)
        shapes = shapes or [(lines, width)] * len(meta)
        size = sum(ny * nx * (2 if m[1] == "HALF" else 4)
                   for (ny, nx), m in zip(shapes, meta))
        if len(packed) >= size:
            got = [dict(bits=b) for b in exr._decode_block(
                packed, 0, part.channels, width, lines, "<raw>", None,
                part.sampling, y0 + y)]
            port = [None] * len(meta)
        else:
            got = model_chunk(packed, meta, shapes, sampling)
            port = exr_dwa.decode_chunk(packed, part.channels, shapes,
                                        sampling, "<port>", lib,
                                        nonlinear=True)
        for plane, g, p, (_, ys) in zip(planes, got, port, sampling):
            row = -(-y // ys)
            sl = np.s_[row:row + g["bits"].shape[0],
                       x:x + g["bits"].shape[1]]
            plane["bits"][sl] = g["bits"]
            if "nonlinear" in g:
                plane["nonlinear"][sl] = g["nonlinear"]
                plane["ref"][sl] = g["ref"]
                plane["tol"][sl] = g["tol"]
                plane["port_nonlinear"][sl] = p if p.dtype == np.uint16 \
                    else p.view(np.float32).astype(np.float16).view(
                        np.uint16)
            else:
                plane["ref"][sl] = np.nan
    return part, planes


def _values(plane, ptype):
    return plane.view(PIXELS[ptype][1]).astype(np.float32)


def upsample(a, xs, ys):
    """cv2's ExrDecoder::UpSample: the samples packed at the top left of
    the image spread, from the bottom right, over xs x ys pixels each."""
    H, W = a.shape[0] * ys, a.shape[1] * xs
    img = np.zeros((H, W), a.dtype)
    img[:a.shape[0], :a.shape[1]] = a
    yre = H - ys
    for y in range((H - 1) // ys, -1, -1):
        xre = W - xs
        for x in range((W - 1) // xs, -1, -1):
            for i in range(ys):
                for n in range(xs):
                    img[yre + i, xre + n] = img[y, x]
            xre -= xs
        yre -= ys
    return img


def chroma_to_rgb(y, ry, by, chroma=None):
    """cv2's ExrDecoder::ChromaToBGR, one pixel at a time in double
    precision, as RGB float32."""
    c = chroma or (0.64, 0.33, 0.30, 0.60, 0.15, 0.06, 0.3127, 0.3290)
    wr, wg, wb = (float(F(c[k])) for k in (1, 3, 5))
    out = np.zeros(y.shape + (3,), np.float32)
    for i in range(y.shape[0]):
        for j in range(y.shape[1]):
            lum = float(y[i, j])
            r = (float(ry[i, j]) + 1) * lum
            b = (float(by[i, j]) + 1) * lum
            g = (lum - b * wb - r * wr) / wg
            out[i, j] = (F(r), F(g), F(b))
    return out


def _image(shape, rng, lo=0.0, hi=1.5):
    """A light stage's kind of frame: smooth shading, edges and noise."""
    H, W = shape
    yy, xx = np.mgrid[:H, :W]
    img = lo + (hi - lo) * (0.5 + 0.3 * np.sin(xx / 4.0 + rng.uniform(0, 6))
                            * np.cos(yy / 5.0))
    img = img * (1 + 0.5 * ((xx // 7 + yy // 5) % 2))
    return img + rng.normal(0, 0.03 * (hi - lo), shape)


def _chans(names, ptype, shape, rng, negative=False):
    out = []
    for k, name in enumerate(names):
        t = ptype if isinstance(ptype, str) else ptype[k]
        v = _image(shape, rng, -0.5 if negative else 0.0)
        if t == "UINT":
            out.append((name, t, rng.integers(0, 1 << 20, shape).astype(
                np.uint32)))
        else:
            out.append((name, t, v.astype(PIXELS[t][1])))
    return out


def _check_file(data, tmp_path, want_channels):
    """read_exr by both routes and the model: the Python route bit for
    bit the model (assembled as the channel set reads), the native route
    the Python route, the port's halves before toLinear the model's, and
    those within the tolerance of the float64 decode. Returns the
    image."""
    part, planes = model_file(data, "python")
    names = [n for n, _, _ in part.channels]
    types = [{0: "UINT", 1: "HALF", 2: "FLOAT"}[t] for _, t, _ in
             part.channels]
    dct = 0
    for p, t in zip(planes, types):
        keep = ~np.isnan(p["ref"])
        np.testing.assert_array_equal(p["port_nonlinear"][keep],
                                      p["nonlinear"][keep])
        assert within(p["nonlinear"], p["ref"], p["tol"])[keep].all()
        assert within(p["nonlinear"], p["ref"], 0)[keep].all()
        dct += int(keep.sum())
    vals = {n: upsample(_values(p["bits"], t), *s) for n, p, t, s in
            zip(names, planes, types, part.samplings)}
    if len(names) == 1:
        want = vals[names[0]]
    elif "Y" in vals:
        want = chroma_to_rgb(vals["Y"], vals["RY"], vals["BY"],
                             part.chromaticities)
    else:
        want = np.stack([vals[c] for c in "RGB"], -1)
    got = _read(data, tmp_path, "python")
    _same(got, want)
    if native_ok():
        _same(_read(data, tmp_path, "native"), got)
    assert sorted(names) == sorted(want_channels)
    return got, dct


def native_ok():
    from raw_ngp_torch import native
    return native.exr_library() is not None


def _read(data, tmp_path, route=None, alpha=False):
    path = tmp_path / "d.exr"
    path.write_bytes(data)
    return exr.read_exr(str(path), route, alpha)


# ---------------------------------------------------------------------------
# cases
# ---------------------------------------------------------------------------

def test_to_linear_table_from_its_formula():
    """exr_dwa.to_linear_table (numpy) is dwaLookups.cpp's formula one
    half at a time: 0 for non-finite halves and 0; ones map to one; odd
    and non-decreasing over the finite halves (which the tolerance's
    bands use)."""
    lin = table("linear")
    np.testing.assert_array_equal(exr_dwa.to_linear_table(), lin)
    assert lin[0x3C00] == 0x3C00 and lin[0xBC00] == 0xBC00
    assert lin[0x7C00] == lin[0xFC00] == lin[0x7E00] == 0
    with np.errstate(invalid="ignore"):
        v = np.arange(1 << 16, dtype=np.uint32).astype(np.uint16).view(
            np.float16).astype(np.float64)
        out = lin.view(np.float16).astype(np.float64)
    fin = np.isfinite(v)
    order = np.argsort(v[fin], kind="stable")
    o = out[fin][order]
    assert (o[1:] >= o[:-1]).all()
    i = np.flatnonzero(fin & (np.arange(1 << 16) & 0x7FFF > 0))
    np.testing.assert_array_equal(lin[i ^ 0x8000], lin[i] ^ 0x8000)
    half = np.float16(0.5).view(np.uint16)
    assert abs(half_value(lin[half]) - 0.5 ** 2.2) < 1e-3


DWA_SETS = {"Y": ("Y",), "BGR": ("B", "G", "R"), "ABGR": ("A", "B", "G", "R"),
            "unknown": ("B", "G", "R")}


@pytest.mark.parametrize("ac", [0, 1], ids=["huffman", "deflate"])
@pytest.mark.parametrize("ptype", ["HALF", "FLOAT"])
@pytest.mark.parametrize("channels", sorted(DWA_SETS))
@pytest.mark.parametrize("codec", sorted(DWA_CODECS))
def test_dwa_files(tmp_path, codec, channels, ptype, ac):
    """DWAA and DWAB, version 2: one channel Y, R G B (a CSC set), R G B
    A (A in the RLE class), R G B with B UINT (no rule: UNKNOWN; R and G
    then DCT-coded alone) in HALF and FLOAT, 53 x 61 (neither 8 nor the
    chunk height divides it), STATIC_HUFFMAN and DEFLATE AC: the model bit
    for bit, the routes alike, within the tolerance."""
    rng = np.random.default_rng(len(codec + channels + ptype) + ac)
    types = ["UINT", ptype, ptype] if channels == "unknown" else ptype
    chans = _chans(DWA_SETS[channels], types, (61, 53), rng)
    data = encode(chans, codec, dwa=dict(ac=ac))
    got, dct = _check_file(data, tmp_path, DWA_SETS[channels])
    # every chunk DWA-coded but, where a short one's Huffman table makes
    # it no smaller, the last (stored raw, as OpenEXR's writer stores it)
    assert dct >= 32 * 53 * (1 if channels == "Y" else 3 if channels in
                             ("BGR", "ABGR") else 2)
    part, _, _ = exr.read_header(data)
    assert part.compression == DWA_CODECS[codec][0]
    ref = np.stack([chans[[c for c, _, _ in chans].index(n)][2].astype(
        np.float32) for n in ("RGB" if got.ndim == 3 else "Y")], -1)
    if channels == "unknown":
        ref, got = ref[..., :2], got[..., :2]
    err = np.abs(got - ref.reshape(got.shape))
    assert err.mean() < 0.06 and err.max() < 0.6


def test_dwab_chunks_and_window(tmp_path):
    """DWAB over 300 lines (two chunks of 256 and 44) and DWAA with the
    data window off the origin and shuffled chunks."""
    rng = np.random.default_rng(3)
    for codec, shape, kw in (("DWAB", (300, 11), {}),
                             ("DWAA", (70, 19), dict(origin=(-5, 9),
                                                     order=2))):
        chans = _chans(("B", "G", "R"), "HALF", shape, rng)
        _check_file(encode(chans, codec, **kw), tmp_path, "BGR")


@pytest.mark.parametrize("ptype", ["HALF", "FLOAT"])
@pytest.mark.parametrize("codec", sorted(DWA_CODECS))
def test_version_1_rules(tmp_path, codec, ptype):
    """Version-1 chunks take the legacy rules (case-insensitive r, g, b,
    y, by, ry and a; HALF only, so FLOAT R, G, B are UNKNOWN)."""
    rng = np.random.default_rng(11)
    chans = _chans(("B", "G", "R"), ptype, (20, 27), rng)
    data = encode(chans, codec, dwa=dict(version=1))
    _, dct = _check_file(data, tmp_path, "BGR")
    assert dct == (20 * 27 * 3 if ptype == "HALF" else 0)


LAYERS = [("A", "HALF"), ("Z", "FLOAT"), ("diffuse.blue", "HALF"),
          ("diffuse.green", "HALF"), ("diffuse.red", "HALF"),
          ("spec.B", "FLOAT"), ("spec.G", "FLOAT"), ("spec.R", "FLOAT"),
          ("spec.y", "HALF")]


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("version", [1, 2])
def test_channel_classes(route, version):
    """A chunk of layered channels (decode_chunk directly): the CSC sets
    of each prefix that has R, G and B under the rules, singles, RLE and
    UNKNOWN channels, by either version's rules and either route: the
    model's values and halves before toLinear bit for bit."""
    _route(route)
    rng = np.random.default_rng(version)
    shape = (21, 18)
    chans = [(n, t, _image(shape, rng).astype(PIXELS[t][1]).view(
        np.uint16 if t == "HALF" else np.uint32), k % 3 == 1)
        for k, (n, t) in enumerate(LAYERS)]
    packed = dwa_chunk(chans, version=version)
    meta = [(n, t, lin) for n, t, _, lin in chans]
    want = model_chunk(packed, meta, [shape] * len(chans))
    ports = [(n, TYPE[t], lin) for n, t, lin in meta]
    lib = exr._library(route)
    got = exr_dwa.decode_chunk(packed, ports, [shape] * len(chans), None,
                               "<c>", lib)
    nl = exr_dwa.decode_chunk(packed, ports, [shape] * len(chans), None,
                              "<c>", lib, nonlinear=True)
    schemes, csc = classify([m[0] for m in meta], [TYPE[m[1]] for m in meta],
                            [(1, 1)] * len(meta), DEFAULT_RULES if version
                            == 2 else LEGACY_RULES)
    assert csc == ([(7, 6, 5)] if version == 2 else [(4, 3, 2)])
    for g, n, w in zip(got, nl, want):
        np.testing.assert_array_equal(g, w["bits"])
        if "nonlinear" in w:
            h = n if n.dtype == np.uint16 else n.view(np.float32).astype(
                np.float16).view(np.uint16)
            np.testing.assert_array_equal(h, w["nonlinear"])
            assert within(w["nonlinear"], w["ref"], w["tol"]).all()
            assert within(w["nonlinear"], w["ref"], 0).all()


_LAYOUTS = {"tiled_mipmap": dict(tiles=(16, 8, 1, 0)),
            "tiled_ripmap_up": dict(tiles=(8, 16, 2, 1)),
            "multipart": dict(parts=[([("Z", "FLOAT", np.ones(
                (5, 9), np.float32))], "ZIP", None)])}


@pytest.mark.parametrize("layout", sorted(_LAYOUTS))
@pytest.mark.parametrize("codec", sorted(DWA_CODECS))
def test_tiles_and_parts(tmp_path, codec, layout):
    """Tiled DWA parts (level 0's tiles, edge tiles cropped) and DWA part
    0 of a multipart file: the model, the routes alike."""
    rng = np.random.default_rng(len(layout))
    chans = _chans(("B", "G", "R"), "HALF", (29, 37), rng)
    data = encode(chans, codec, **_LAYOUTS[layout])
    _check_file(data, tmp_path, "BGR")


# the last literal's zig-zag index of each row case of the decoder
# (lastNonZero < 2, 3, 9, 10, 20, 21, 35, or above) and the DC-only block
ROW_CASES = [0, 1, 2, 5, 9, 15, 20, 30, 50, 63]


@pytest.mark.parametrize("route", ROUTES)
def test_every_row_case(route):
    """Blocks whose stored coefficients end at each lastNonZero class
    (DC only; 1; 2; 3-8; 9; 10-19; 20; 21-34; 35-63), a literal zero and a
    literal -0 among them, alone and as a CSC set (a constant block of
    three DC-only components too): the model bit for bit."""
    _route(route)
    rng = np.random.default_rng(5)
    n = len(ROW_CASES)
    coefs = {}
    for j in range(3):
        for blk, last in enumerate(ROW_CASES):
            zz = [0] * 64
            zz[0] = half_bits(rng.uniform(2, 6))
            for k in range(1, last + 1):
                if rng.random() < 0.6 or k == last:
                    zz[k] = half_bits(rng.normal(0, 0.3))
            if last > 4:
                zz[2], zz[3] = 0x8000, 0
            coefs[(0, blk, j)] = zz
    for comps in (["Y"], ["B", "G", "R"]):
        chans = [(c, "HALF", np.zeros((8, 8 * n), np.uint16), False)
                 for c in comps]
        m = len(comps)
        use = {(0, b, j): coefs[(0, b, j)] for b in range(n)
               for j in range(m)}
        if m == 3:
            for j in range(3):
                use[(0, 0, j)] = [coefs[(0, 0, j)][0]] + [0] * 63
        packed = dwa_chunk(chans, coefs=use)
        meta = [(c, "HALF", False) for c in comps]
        want = model_chunk(packed, meta, [(8, 8 * n)] * m)
        got = exr_dwa.decode_chunk(packed, [(c, 1, False) for c in comps],
                                   [(8, 8 * n)] * m, None, "<r>",
                                   exr._library(route))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w["bits"])
            assert within(w["nonlinear"], w["ref"], w["tol"]).all()
            assert within(w["nonlinear"], w["ref"], 0).all()


def test_block_arithmetic_in_the_scalar_order():
    """exr_dwa's vectorised inverse DCT and csc709Inverse, in float32
    before the rounding to half (which hides most differences of order):
    bit for bit the model's scalar dctInverse8x8_scalar (every row
    transformed, and each zeroed-rows variant where its rows are zero) and
    csc709Inverse on 300 blocks of random half coefficients."""
    rng = np.random.default_rng(12)
    halves = rng.normal(0, 2, (300, 64)).astype(np.float16)
    halves[::3, 10:] = 0
    coef = halves.astype(np.float32)
    got = exr_dwa.inverse_dct(coef.reshape(-1, 8, 8)).reshape(-1, 64)
    for k in range(len(coef)):
        row = [F(v) for v in coef[k]]
        zeroed = 7 - max(r for r in range(8) if any(row[8 * r:8 * r + 8]))
        want = np.array(idct_scalar(row, 0), np.float32)
        np.testing.assert_array_equal(got[k].view(np.uint32),
                                      want.view(np.uint32))
        np.testing.assert_array_equal(np.array(idct_scalar(
            row, zeroed), np.float32).view(np.uint32), want.view(np.uint32))
    y, cb, cr = got[:100], got[100:200], got[200:]
    rgb = exr_dwa.csc709_inverse(y, cb, cr)
    for i in range(0, 100, 7):
        for j in range(64):
            a, b, c = F(y[i, j]), F(cb[i, j]), F(cr[i, j])
            want = (a + F(1.5747) * c, a - F(0.1873) * b - F(0.4682) * c,
                    a + F(1.8556) * b)
            assert [F(v[i, j]) for v in rgb] == list(want)


def _chunk_file(chans, packed, code=8):
    H, W = chans[0][2].shape
    return _single_chunk_file([(c, t) for c, t, _ in chans], code, W, H,
                              packed)


def _counts(version, n_ac, n_dc, ac_z, dc_z, ac=1):
    return struct.pack("<11Q", version, 0, 0, len(ac_z), len(dc_z), 0, 0, 0,
                       n_ac, n_dc, ac)


# One 8 x 8 Y block, version 1 (legacy rules: "Y" is y, LOSSY_DCT), AC by
# DEFLATE: the DC 8.0 (0x4800) and the AC stream 0xff00 alone (end of
# block): DC only, every value 8 x 3.535536e-01 x 3.535536e-01 =
# 1.0000001 in float32, the half 1.0 (0x3C00), toLinear 1.0. DC section:
# the bytes 00 48 split even / odd (00 | 48), predicted: 00, 48 - 00 + 128
# = C8.
HAND_DC_SECTION = bytes.fromhex("00c8")
# The same block with one AC literal 1.0 (0x3C00) at zig-zag index 1
# (raster (0, 1), the first horizontal cosine) and the run to its end
# (0xff00): lastNonZero 1, so only row 0 is transformed (a 8 + b, a 8 + d,
# a 8 + e, a 8 + g, a 8 - g, ..., a 8 - b) and the columns scale it by a
# down every row: each row 8 a^2 + a (b, d, e, g, -g, -e, -d, -b), about
# 1 + (0.173, 0.147, 0.098, 0.034, -0.034, ...).


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("case", ["dc_only", "one_run", "csc_gray"])
def test_hand_worked_chunks(tmp_path, route, case):
    """Chunks whose bytes are derived above from the layout: a DC-only
    block (all 1.0), a block of one AC literal and a run to its end (the
    model's values, near the float64 decode), and a CSC block of gray (Y
    DC 4.0, Cb = Cr = 0: R = G = B = toLinear(0.5)); the test's encoder
    gives the same sections."""
    _route(route)
    if case == "csc_gray":
        chans = [(c, "HALF", None) for c in "BGR"]
        dc = struct.pack("<3H", 0x4400, 0, 0)
        ac_vals = [0xFF00] * 3
        version, want = 1, half_value(table("linear")[0x3800])
    else:
        chans = [("Y", "HALF", None)]
        dc = struct.pack("<H", 0x4800)
        ac_vals = [0xFF00] if case == "dc_only" else [0x3C00, 0xFF00]
        version, want = 1, 1.0 if case == "dc_only" else None
    dc_z = zlib.compress(_predict(dc))
    if case == "dc_only":
        assert _predict(dc) == HAND_DC_SECTION
    ac_z = zlib.compress(struct.pack(f"<{len(ac_vals)}H", *ac_vals))
    packed = _counts(version, len(ac_vals), len(dc) // 2, ac_z, dc_z) + \
        ac_z + dc_z
    chans = [(c, t, np.zeros((8, 8), np.float16)) for c, t, _ in chans]
    data = _chunk_file(chans, packed)
    got = _read(data, tmp_path, route)
    meta = [(c, "HALF", False) for c, _, _ in chans]
    model = model_chunk(packed, meta, [(8, 8)] * len(chans))
    if want is not None:
        assert (got == np.float32(want)).all()
    else:
        np.testing.assert_array_equal(got, _values(model[0]["bits"],
                                                   "HALF"))
        ref = idct64([1.0 if r == 1 else 0.0 for r in range(64)]) + 1.0
        nl = model[0]["nonlinear"].view(np.float16).astype(np.float64)
        assert np.abs(nl - ref).max() < 1e-3
        assert np.ptp(got[0]) > 0 and (got == got[0]).all()
    # the encoder writes these sections for these coefficients
    coefs = {(0, 0, j): [struct.unpack("<H", dc[2 * j:2 * j + 2])[0]]
             + ([0x3C00] if case == "one_run" else [0]) + [0] * 62
             for j in range(len(chans))}
    ours = dwa_chunk([(c, "HALF", np.zeros((8, 8), np.uint16), False)
                      for c, _, _ in chans], version=1, ac=1, coefs=coefs)
    assert ours == packed


def _corrupt(kind):
    chans = [("Y", "HALF", _image((16, 16), np.random.default_rng(0))
              .astype(np.float16).view(np.uint16), False)]
    packed = bytearray(dwa_chunk(chans, ac=1))
    counts = list(struct.unpack("<11Q", packed[:88]))
    if kind == "cut_counts":
        return bytes(packed[:60])
    if kind == "cut_sections":
        return bytes(packed[:-5])
    if kind == "ac_count":
        counts[8] += 1
    elif kind == "dc_count":
        counts[9] -= 1
    elif kind == "unknown_size":
        counts[1] = 8
    elif kind == "version":
        counts[0] = 3
    elif kind == "bad_run":
        ac_at = 88 + struct.unpack("<H", packed[88:90])[0]
        vals = list(struct.unpack(f"<{counts[8]}H", zlib.decompress(
            bytes(packed[ac_at:ac_at + counts[3]]))))
        vals[1] = 0xFF40
        ac_z = zlib.compress(struct.pack(f"<{len(vals)}H", *vals))
        packed = packed[:ac_at] + ac_z + packed[ac_at + counts[3]:]
        counts[3] = len(ac_z)
    packed[:88] = struct.pack("<11Q", *counts)
    return bytes(packed)


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("kind", ["cut_counts", "cut_sections", "ac_count",
                                  "dc_count", "unknown_size", "version",
                                  "bad_run"])
def test_corrupt_chunks_raise(tmp_path, kind, route):
    """A chunk cut inside its counts or its sections, AC or DC counts
    that disagree with the blocks, an UNKNOWN size that disagrees with
    the channels, version 3 and an AC run past the end of its block:
    ValueError naming the file, by either route."""
    _route(route)
    data = _chunk_file([("Y", "HALF", np.zeros((16, 16), np.float16))],
                       _corrupt(kind))
    with pytest.raises(ValueError, match="OpenEXR"):
        _read(data, tmp_path, route)


# ---------------------------------------------------------------------------
# subsampled channels
# ---------------------------------------------------------------------------

SUB_LAYOUTS = {
    "yc": ((("BY", (2, 2)), ("RY", (2, 2)), ("Y", (1, 1))), None),
    "yc_chroma": ((("BY", (2, 2)), ("RY", (2, 2)), ("Y", (1, 1))),
                  (0.7, 0.3, 0.2, 0.7, 0.12, 0.05, 0.31, 0.33)),
    "rgb": ((("A", (2, 2)), ("B", (1, 2)), ("G", (2, 1)), ("R", (1, 1))),
            None),
}


def _sub_chans(layout, shape, rng):
    chans = []
    for name, _ in SUB_LAYOUTS[layout][0]:
        v = _image(shape, rng, 0.05, 1.2)
        if name in ("RY", "BY"):
            v = rng.uniform(-0.3, 0.3) + 0.2 * np.sin(v)
        chans.append((name, "HALF", v.astype(np.float16)))
    return chans


@pytest.mark.parametrize("layout", sorted(SUB_LAYOUTS))
@pytest.mark.parametrize("codec", sorted(ALL_CODECS) + sorted(DWA_CODECS))
def test_subsampled_channels(tmp_path, codec, layout):
    """Subsampled channels in every codec (chunks of the test's own
    layout: a subsampled channel's rows only on its lines, each W / xs
    samples): R, G, B (and A) each at its own sampling up-sampled as numpy
    repeats them; Y, RY, BY (RY and BY at 2 x 2) as cv2's UpSample and
    ChromaToBGR (this module's scalar transcription) make them, with and
    without a chromaticities attribute. The window is off the origin (at
    multiples of the sampling) and 26 x 38 (96 x 70 for DWA, whose chunks
    of so few samples would be stored raw), which no chunk height
    divides."""
    spec, chroma = SUB_LAYOUTS[layout]
    rng = np.random.default_rng(len(codec) * 7 + len(layout))
    H, W = (70, 96) if codec in DWA_CODECS else (38, 26)
    chans = _sub_chans(layout, (H, W), rng)
    attrs = [] if chroma is None else [("chromaticities", "chromaticities",
                                        struct.pack("<8f", *chroma))]
    data, back = encode(chans, codec, values=True, origin=(-4, 6),
                        sampling=[s for _, s in spec], attrs=attrs)
    part, _, _ = exr.read_header(data)
    assert part.samplings == [s for _, s in spec]
    vals = {n: v.astype(np.float32) for n, _, v in back}
    if layout == "rgb":
        for name, (xs, ys) in spec:
            sub = [v for n, _, v in chans if n == name][0][::ys, ::xs]
            if codec in ("NONE", "RLE", "ZIPS", "ZIP", "PIZ"):
                _same(vals[name], np.repeat(np.repeat(
                    sub.astype(np.float32), ys, 0), xs, 1))
        want = np.stack([vals[c] for c in "RGBA"], -1)
    else:
        sub = {n: v.view(np.float32)[::ys, ::xs]
               for (n, v), (_, (xs, ys)) in zip(vals.items(), spec)}
        want = chroma_to_rgb(vals["Y"], upsample(sub["RY"], 2, 2),
                             upsample(sub["BY"], 2, 2),
                             None if chroma is None else
                             tuple(float(F(c)) for c in chroma))
    got = _read(data, tmp_path, alpha=True)
    _same(got, want)
    if codec in DWA_CODECS:
        _, dct = _check_file(data, tmp_path, [n for n, _ in spec])
        assert dct > 0
    chans_read = exr.read_exr_channels(str(tmp_path / "d.exr"))
    for name, (xs, ys) in spec:
        _same(chans_read[name], vals[name][::ys, ::xs])


def test_subsampled_luminance_alone(tmp_path):
    """Y alone at 2 x 2 reads as one channel, each sample over 2 x 2
    pixels, as cv2 reads it."""
    rng = np.random.default_rng(9)
    y = _image((12, 10), rng).astype(np.float16)
    data = encode([("Y", "HALF", y)], "ZIP", sampling=(2, 2))
    got = _read(data, tmp_path)
    _same(got, upsample(y[::2, ::2].astype(np.float32), 2, 2))


@pytest.mark.parametrize("case", ["tiled", "odd_window", "odd_origin"])
def test_subsampling_that_openexr_refuses(tmp_path, case):
    """OpenEXR's header check: a tiled part samples every channel at 1,
    and a channel's sampling divides the data window's corner and size;
    ValueError otherwise."""
    rng = np.random.default_rng(1)
    shape = (9, 8) if case == "odd_window" else (8, 8)
    y = _image(shape, rng).astype(np.float16)
    kw = {"tiled": dict(tiles=(4, 4, 0, 0)), "odd_window": {},
          "odd_origin": dict(origin=(1, 0))}[case]
    data = encode([("Y", "HALF", y)], "NONE", sampling=(2, 2), **kw)
    with pytest.raises(ValueError, match="sampl"):
        _read(data, tmp_path)
