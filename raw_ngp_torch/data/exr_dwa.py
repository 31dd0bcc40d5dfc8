"""DWAA and DWAB: OpenEXR's lossy DCT compressions (compression 8, 32
lines a chunk; 9, 256 lines), decoded as OpenEXR's ``ImfDwaCompressor.cpp``
lays out a chunk (the inverse DCT of its scalar ``dctInverse8x8_scalar``
in ``ImfDwaCompressorSimd.h``, the toLinear table of ``dwaLookups.cpp``).
A tile's data is laid out as a scanline chunk's.

The chunk:

* eleven little-endian uint64 counts: the version (1 or 2), the UNKNOWN
  section's uncompressed and compressed sizes, the AC and DC sections'
  compressed sizes, the RLE section's compressed, uncompressed (after
  inflate) and raw (after the run-length code) sizes, the total numbers
  of AC and DC values, and the AC compression (0 STATIC_HUFFMAN, 1
  DEFLATE);
* in version 2 the channel rules: a uint16 size (its own two bytes
  included), then rules, each a null-terminated suffix, a byte (bits 4-7
  the CSC index + 1, 0 for none; bits 2-3 the scheme, 0 UNKNOWN, 1
  LOSSY_DCT, 2 RLE; bit 0 case-insensitive) and a pixel type byte.
  Version 1 takes the legacy rules (:data:`LEGACY_RULES`);
* the sections UNKNOWN, AC, DC and RLE in that order, each as long as
  its compressed size; bytes after them are ignored, as OpenEXR's
  decoder ignores them.

Channel classes. Each channel, in the header's order, is matched on the
suffix after the last ``.`` of its name (the whole name where it has
none) and its pixel type against every rule in turn; the last rule that
matches sets its scheme and, with a CSC index, makes it that index of its
prefix's (the name before the last ``.``) CSC set. A prefix with all of
indices 0, 1 and 2 (R, G and B) at one sampling is a CSC set. A channel
that no rule matches is UNKNOWN.

* UNKNOWN: zlib's inflate to each UNKNOWN channel's samples (its rows
  of the chunk, little-endian), channel after channel.
* RLE: zlib's inflate, then OpenEXR's run-length code (that of RLE
  compression), to byte planes: for each RLE channel in turn, its
  samples' low bytes, then the next bytes up.
* DC: zlib's inflate undone with ZIP compression's predictor and even /
  odd split (OpenEXR's ``Zip``): uint16 half bits, one a block and
  component; each decoder's components one after another, every block of
  one component in row-major order; decoders in decode order.
* AC: STATIC_HUFFMAN is PIZ's Huffman stream (the decode of ``exr.py``,
  in ``raw_ngp_torch/csrc/exr_host.cpp`` or its Python oracle), DEFLATE
  zlib's inflate, both to uint16 values: block by block, in each block
  component by component, the 63 AC coefficients in JPEG's zig-zag order
  as half bits, where 0xff00 ends the block (the rest zero) and 0xffnn
  (nn > 0) stands for nn zeros.

Decoders: the CSC sets in the prefixes' byte order, each its R, G, B
decoded together; then every other LOSSY_DCT channel alone, in the
header's order. A decoder's channel is its samples in the chunk (a
subsampled channel its own samples, as ``ImfDwaCompressor.cpp`` reads its
rows), in 8 x 8 blocks, the edge blocks cropped (the encoder pads them by
mirroring the last row and column). Each block and component:

1. the DC and AC halves to float32, un-zig-zagged;
2. where the block holds no AC literal (``lastNonZero`` 0) every value is
   ``dc * 3.535536e-01 * 3.535536e-01`` (``dctInverse8x8DcOnly``); else
   the inverse DCT, rows then columns, each the 1-D transform of
   ``dctInverse8x8_scalar`` (its constants ``.5 cos(k 3.14159 / 16)`` in
   float32, its sums in its order), in float32, unfused (numpy does not
   fuse; its variants that skip rows known to be zero give the same
   values);
3. for a CSC set, the inverse Rec. 709 conversion ``R = Y + 1.5747 Cr``,
   ``G = Y - 0.1873 Cb - 0.4682 Cr``, ``B = Y + 1.8556 Cb`` in float32;
4. to half, rounding to nearest even;
5. through :func:`to_linear_table` unless the channel is pLinear (a CSC
   set always).

A FLOAT channel of the LOSSY_DCT class is stored as halves and reads as
their values; a UINT one is corrupt.

OpenEXR's SSE2 and AVX builds run other forms of the inverse DCT and of
the conversion, which may round a float32 value to another half where
the scalar order does not; this module gives the scalar order's values.
"""

from __future__ import annotations

import struct
import zlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

NUM_COUNTS = 11
HEADER_BYTES = 8 * NUM_COUNTS
UNKNOWN, LOSSY_DCT, RLE = 0, 1, 2
STATIC_HUFFMAN, DEFLATE = 0, 1
UINT, HALF, FLOAT = 0, 1, 2
AC_ERRORS = {5: "the AC stream ends inside a block",
             6: "an AC run past the end of its block"}

# (suffix, scheme, pixel type, CSC index, case-insensitive) in order:
# the rules a version-2 writer stores (OpenEXR's default rules) and the
# ones a version-1 chunk is read with
DEFAULT_RULES = tuple(
    [(c, LOSSY_DCT, t, i, False) for i, c in enumerate("RGB")
     for t in (HALF, FLOAT)]
    + [(c, LOSSY_DCT, t, -1, False) for c in ("Y", "BY", "RY")
       for t in (HALF, FLOAT)]
    + [("A", RLE, t, -1, False) for t in (UINT, HALF, FLOAT)])
LEGACY_RULES = tuple(
    [(c, LOSSY_DCT, HALF, i, True) for i, names in enumerate(
        (("r", "red"), ("g", "grn", "green"), ("b", "blu", "blue")))
     for c in names]
    + [(c, LOSSY_DCT, HALF, -1, True) for c in ("y", "by", "ry")]
    + [("a", RLE, t, -1, True) for t in (UINT, HALF, FLOAT)])

# JPEG's zig-zag order: ZIGZAG[r] is the zig-zag index of raster index r
ZIGZAG = np.array([
    0, 1, 5, 6, 14, 15, 27, 28, 2, 4, 7, 13, 16, 26, 29, 42,
    3, 8, 12, 17, 25, 30, 41, 43, 9, 11, 18, 24, 31, 40, 44, 53,
    10, 19, 23, 32, 39, 45, 52, 54, 20, 22, 33, 38, 46, 51, 55, 60,
    21, 34, 37, 47, 50, 56, 59, 61, 35, 36, 48, 49, 57, 58, 62, 63])

_F = np.float32
# dctInverse8x8_scalar's constants: .5f * cosf(k * 3.14159f / 16) (the
# product k * 3.14159f in float32), a..g
_PI = _F(3.14159)


def _half_cos(k: int, n: int) -> np.float32:
    angle = _F(_F(k) * _PI) / _F(n) if k != 1 else _PI / _F(n)
    return _F(0.5) * _F(np.cos(np.float64(angle)))


IDCT_A, IDCT_B, IDCT_C = _half_cos(1, 4), _half_cos(1, 16), _half_cos(1, 8)
IDCT_D, IDCT_E = _half_cos(3, 16), _half_cos(5, 16)
IDCT_F, IDCT_G = _half_cos(3, 8), _half_cos(7, 16)
DC_ONLY = _F(3.535536e-01)
CSC_INVERSE = (_F(1.5747), _F(0.1873), _F(0.4682), _F(1.8556))


def _bad(path, what):
    return ValueError(f"{path}: corrupt OpenEXR file (DWA: {what})")


# ---------------------------------------------------------------------------
# toLinear
# ---------------------------------------------------------------------------

_TO_LINEAR: Optional[np.ndarray] = None


def to_linear_table() -> np.ndarray:
    """dwaCompressorToLinear, uint16 [65536], from its formula in
    ``dwaLookups.cpp``: for each half h, 0 where h is not finite (and at
    h = 0), else ``half(sign(h) |h|^2.2f)`` where ``|h| <= 1`` and
    ``half(sign(h) L^(|h| - 1))`` above, L = ``float(2.7182818^2.2)``;
    each power correctly rounded to float32 (float64's ``pow`` rounded),
    then to half, rounding to nearest even."""
    global _TO_LINEAR
    if _TO_LINEAR is None:
        bits = np.arange(1 << 16, dtype=np.uint32).astype(np.uint16)
        with np.errstate(invalid="ignore"):
            h = bits.view(np.float16).astype(np.float32)
            a = np.abs(h).astype(np.float64)
        log_base = np.float64(_F(2.7182818 ** 2.2))
        with np.errstate(over="ignore", invalid="ignore"):
            small = _F_array(np.power(a, np.float64(_F(2.2))))
            large = _F_array(np.power(log_base, np.float64(
                _F_array(a - 1.0))))
        v = np.where(a <= 1.0, small, large)
        v = np.where(h < 0, -v, v).astype(np.float32)
        with np.errstate(over="ignore"):
            out = v.astype(np.float16).view(np.uint16)
        out = np.where(np.isfinite(h), out, np.uint16(0))
        out[0] = 0
        _TO_LINEAR = out.astype(np.uint16)
    return _TO_LINEAR


def _F_array(x) -> np.ndarray:
    with np.errstate(over="ignore", invalid="ignore"):
        return np.asarray(x, np.float64).astype(np.float32)


# ---------------------------------------------------------------------------
# the chunk's counts and rules
# ---------------------------------------------------------------------------

def read_rules(packed: bytes, path: str) -> Tuple[Tuple, int]:
    """A version-2 chunk's rules from byte HEADER_BYTES and the position
    after them."""
    pos = HEADER_BYTES
    if pos + 2 > len(packed):
        raise _bad(path, "the rules are cut off")
    size = struct.unpack("<H", packed[pos:pos + 2])[0]
    end = pos + size
    if size < 2 or end > len(packed):
        raise _bad(path, f"a rules block of {size} bytes")
    pos += 2
    rules = []
    while pos < end:
        stop = packed.find(b"\0", pos, end)
        if stop < 0 or stop + 3 > end:
            raise _bad(path, "a rule is cut off")
        suffix = packed[pos:stop].decode("latin-1")
        flags, ptype = packed[stop + 1], packed[stop + 2]
        csc, scheme = (flags >> 4) - 1, (flags >> 2) & 3
        if scheme > RLE or csc > 2 or ptype > FLOAT:
            raise _bad(path, f"a rule for {suffix!r} of scheme {scheme}, "
                             f"CSC index {csc}, pixel type {ptype}")
        rules.append((suffix, scheme, ptype, csc, bool(flags & 1)))
        pos = stop + 3
    return tuple(rules), end


def classify(channels: Sequence[Tuple[str, int, bool]],
             sampling: Sequence[Tuple[int, int]], rules
             ) -> Tuple[List[int], List[Tuple[int, int, int]]]:
    """Each channel's scheme and the CSC sets (R, G, B channel indices)
    in decode order, as ImfDwaCompressor's classifyChannels makes them."""
    schemes = []
    sets: Dict[str, List[int]] = {}
    for k, (name, ptype, _) in enumerate(channels):
        prefix, dot, suffix = name.rpartition(".")
        idx = sets.setdefault(prefix if dot else "", [-1, -1, -1])
        scheme = UNKNOWN
        for r_suffix, r_scheme, r_type, r_csc, r_nocase in rules:
            s = suffix.lower() if r_nocase else suffix
            if r_type == ptype and s == r_suffix:
                scheme = r_scheme
                if r_csc >= 0:
                    idx[r_csc] = k
        schemes.append(scheme)
    csc = []
    for prefix in sorted(sets, key=lambda p: p.encode("latin-1")):
        r, g, b = sets[prefix]
        if min(r, g, b) >= 0 and sampling[r] == sampling[g] == sampling[b]:
            csc.append((r, g, b))
    return schemes, csc


# ---------------------------------------------------------------------------
# the AC stream's runs: the C++ route and its Python oracle
# ---------------------------------------------------------------------------

def unrle_ac_python(ac: np.ndarray, n_blocks: int
                    ) -> Tuple[np.ndarray, np.ndarray, int]:
    """The AC values of `n_blocks` component blocks in stream order:
    (uint16 [n_blocks, 64] in zig-zag order with position 0 zero, the
    zig-zag index of each block's last literal (0 for none), the number
    of values read); raises _AcError 5 or 6."""
    vals = ac.tolist()
    n = len(vals)
    out = [0] * (64 * n_blocks)
    last = [0] * n_blocks
    p = 0
    for k in range(n_blocks):
        base, comp, lnz = 64 * k, 1, 0
        while comp < 64:
            if p >= n:
                raise _AcError(5)
            v = vals[p]
            p += 1
            if v == 0xFF00:
                comp = 64
            elif v >> 8 == 0xFF:
                comp += v & 0xFF
                if comp > 64:
                    raise _AcError(6)
            else:
                lnz = comp
                out[base + comp] = v
                comp += 1
        last[k] = lnz
    return (np.array(out, np.uint16).reshape(n_blocks, 64),
            np.array(last, np.uint8), p)


def unrle_ac_native(lib, ac: np.ndarray, n_blocks: int
                    ) -> Tuple[np.ndarray, np.ndarray, int]:
    """unrle_ac_python by ``dwa_unrle_ac`` of ``csrc/exr_host.cpp``."""
    ac = np.ascontiguousarray(ac, np.uint16)
    out = np.zeros((n_blocks, 64), np.uint16)
    last = np.zeros(n_blocks, np.uint8)
    used = np.zeros(1, np.int64)
    rc = lib.dwa_unrle_ac(ac, len(ac), n_blocks, out, last, used)
    if rc:
        raise _AcError(rc)
    return out, last, int(used[0])


class _AcError(Exception):
    def __init__(self, code):
        super().__init__(code)
        self.code = code


# ---------------------------------------------------------------------------
# the blocks' arithmetic
# ---------------------------------------------------------------------------

def _idct_1d(r):
    """dctInverse8x8_scalar's 1-D transform of the 8 float32 arrays `r`
    (one row's or one column's values), in its operation order."""
    a, b, c, d = IDCT_A, IDCT_B, IDCT_C, IDCT_D
    e, f, g = IDCT_E, IDCT_F, IDCT_G
    alpha0, alpha1 = c * r[2], f * r[2]
    alpha2, alpha3 = c * r[6], f * r[6]
    beta0 = b * r[1] + d * r[3] + e * r[5] + g * r[7]
    beta1 = d * r[1] - g * r[3] - b * r[5] - e * r[7]
    beta2 = e * r[1] - b * r[3] + g * r[5] + d * r[7]
    beta3 = g * r[1] - e * r[3] + d * r[5] - b * r[7]
    theta0 = a * (r[0] + r[4])
    theta3 = a * (r[0] - r[4])
    theta1 = alpha0 + alpha3
    theta2 = alpha1 - alpha2
    gamma0, gamma1 = theta0 + theta1, theta3 + theta2
    gamma2, gamma3 = theta3 - theta2, theta0 - theta1
    return (gamma0 + beta0, gamma1 + beta1, gamma2 + beta2, gamma3 + beta3,
            gamma3 - beta3, gamma2 - beta2, gamma1 - beta1, gamma0 - beta0)


def inverse_dct(x: np.ndarray) -> np.ndarray:
    """dctInverse8x8_scalar of float32 blocks [..., 8, 8] (raster order,
    rows then columns); a new array."""
    x = np.array(x, np.float32)
    with np.errstate(all="ignore"):
        rows = _idct_1d([x[..., k] for k in range(8)])
        for k in range(8):
            x[..., k] = rows[k]
        cols = _idct_1d([x[..., k, :] for k in range(8)])
        for k in range(8):
            x[..., k, :] = cols[k]
    return x


def csc709_inverse(y, cb, cr):
    """csc709Inverse in float32: (R, G, B) of Y', Cb, Cr."""
    k_rcr, k_gcb, k_gcr, k_bcb = CSC_INVERSE
    with np.errstate(all="ignore"):
        return y + k_rcr * cr, y - k_gcb * cb - k_gcr * cr, y + k_bcb * cb


def decode_blocks(zz: np.ndarray, last: np.ndarray) -> np.ndarray:
    """Half bits [n, comps, 64] in zig-zag order (the DC at 0) and each
    block's last literal [n, comps] -> the halves each block decodes to,
    uint16 [n, comps, 8, 8] in the nonlinear domain (before toLinear): the
    DC-only value or the inverse DCT, the CSC inverse where comps is 3,
    rounded to half."""
    n, comps = zz.shape[:2]
    coef = zz[..., ZIGZAG].view(np.float16).astype(np.float32).reshape(
        n, comps, 8, 8)
    with np.errstate(all="ignore"):
        dc = coef[..., 0, 0] * DC_ONLY * DC_ONLY
    x = np.where((last == 0)[..., None, None], dc[..., None, None],
                 inverse_dct(coef))
    if comps == 3:
        x = np.stack(csc709_inverse(x[:, 0], x[:, 1], x[:, 2]), 1)
    with np.errstate(over="ignore", invalid="ignore"):
        return x.astype(np.float16).view(np.uint16)


def _blocks_to_plane(h: np.ndarray, ny: int, nx: int) -> np.ndarray:
    nby, nbx = -(-ny // 8), -(-nx // 8)
    return h.reshape(nby, nbx, 8, 8).transpose(0, 2, 1, 3).reshape(
        8 * nby, 8 * nbx)[:ny, :nx]


# ---------------------------------------------------------------------------
# a chunk
# ---------------------------------------------------------------------------

def _inflate(data: bytes, size: int, what: str, path: str) -> bytes:
    try:
        raw = zlib.decompress(data)
    except zlib.error as e:
        raise _bad(path, f"the {what} section does not inflate ({e})"
                   ) from None
    if len(raw) != size:
        raise _bad(path, f"the {what} section inflates to {len(raw)} "
                         f"bytes, not {size}")
    return raw


def decode_chunk(packed: bytes, channels: Sequence[Tuple[str, int, bool]],
                 shapes: Sequence[Tuple[int, int]],
                 sampling: Optional[Sequence[Tuple[int, int]]] = None,
                 path: str = "<bytes>", lib=None,
                 nonlinear: bool = False) -> List[np.ndarray]:
    """Each channel's sample bits (uint16 for HALF, uint32 otherwise) of
    one DWAA or DWAB chunk: `channels` [(name, pixel type, pLinear)] in the
    header's order, `shapes` each channel's samples in the chunk (rows,
    samples a row); `lib` the EXR library (``native.exr_library()``) or
    None for the Python route. With `nonlinear`, LOSSY_DCT channels are
    given as the halves before toLinear."""
    from raw_ngp_torch.data import exr
    if sampling is None:
        sampling = [(1, 1)] * len(channels)
    if len(packed) < HEADER_BYTES:
        raise exr._cut(path, "a DWA chunk's counts")
    counts = struct.unpack(f"<{NUM_COUNTS}Q", packed[:HEADER_BYTES])
    (version, unknown_raw, unknown_size, ac_size, dc_size, rle_size,
     rle_inflated, rle_planes, n_ac, n_dc, ac_code) = counts
    if version > 2:
        raise _bad(path, f"version {version}")
    if version == 2:
        rules, pos = read_rules(packed, path)
    else:
        rules, pos = LEGACY_RULES, HEADER_BYTES
    if ac_code > DEFLATE:
        raise _bad(path, f"AC compression {ac_code}")
    if pos + unknown_size + ac_size + dc_size + rle_size > len(packed):
        raise exr._cut(path, "a DWA chunk's sections")
    sections = []
    for size in (unknown_size, ac_size, dc_size, rle_size):
        sections.append(packed[pos:pos + size])
        pos += size
    unknown, ac_data, dc_data, rle_data = sections
    schemes, csc = classify(channels, sampling, rules)
    types = [t for _, t, _ in channels]
    widths = [2 if t == HALF else 4 for t in types]
    out: List[Optional[np.ndarray]] = [None] * len(channels)

    # UNKNOWN: the channels' samples, one after another
    want = sum(ny * nx * w for (ny, nx), w, s in zip(shapes, widths, schemes)
               if s == UNKNOWN)
    if unknown_raw != want:
        raise _bad(path, f"{unknown_raw} bytes of UNKNOWN channels where "
                         f"they hold {want}")
    raw = _inflate(unknown, want, "UNKNOWN", path) if want else b""
    at = 0
    for k, ((ny, nx), w) in enumerate(zip(shapes, widths)):
        if schemes[k] == UNKNOWN:
            n = ny * nx * w
            out[k] = np.frombuffer(raw, "<u2" if w == 2 else "<u4",
                                   ny * nx, at).reshape(ny, nx).copy()
            at += n

    # RLE: byte planes, low bytes first
    want = sum(ny * nx * w for (ny, nx), w, s in zip(shapes, widths, schemes)
               if s == RLE)
    if rle_planes != want:
        raise _bad(path, f"{rle_planes} bytes of RLE channels where they "
                         f"hold {want}")
    if want:
        planes = exr._rle_decode(_inflate(rle_data, rle_inflated, "RLE",
                                          path), want, path)
        at = 0
        for k, ((ny, nx), w) in enumerate(zip(shapes, widths)):
            if schemes[k] != RLE:
                continue
            b = planes[at:at + ny * nx * w].reshape(w, ny * nx).astype(
                np.uint32)
            at += ny * nx * w
            v = sum(b[j] << np.uint32(8 * j) for j in range(w))
            out[k] = v.astype(np.uint16 if w == 2 else np.uint32).reshape(
                ny, nx)

    # AC and DC values
    if n_ac:
        if ac_code == STATIC_HUFFMAN:
            try:
                ac = exr._huf_decode(ac_data, n_ac, lib)
            except exr._Corrupt as e:
                raise _bad(path, "AC: " + exr.HUF_ERRORS[e.code]) from None
        else:
            ac = np.frombuffer(_inflate(ac_data, 2 * n_ac, "AC", path),
                               "<u2")
    else:
        ac = np.empty(0, np.uint16)
    dc = exr._unpredict(np.frombuffer(_inflate(
        dc_data, 2 * n_dc, "DC", path), np.uint8)).view("<u2") if n_dc \
        else np.empty(0, np.uint16)

    decoders = [list(s) for s in csc]
    for k in range(len(csc)):
        if any(schemes[c] != LOSSY_DCT for c in csc[k]):
            raise _bad(path, "a CSC set of channels not all LOSSY_DCT")
    in_set = {c for s in csc for c in s}
    decoders += [[k] for k, s in enumerate(schemes)
                 if s == LOSSY_DCT and k not in in_set]
    ac_at = dc_at = 0
    lut = to_linear_table()
    for comps in decoders:
        ny, nx = shapes[comps[0]]
        for c in comps:
            if types[c] == UINT:
                raise _bad(path, f"UINT channel {channels[c][0]!r} in the "
                                 "LOSSY_DCT class")
        nb = -(-ny // 8) * -(-nx // 8)
        if nb == 0:
            for c in comps:
                out[c] = np.zeros((ny, nx), np.uint16 if types[c] == HALF
                                  else np.uint32)
            continue
        m = len(comps)
        if dc_at + m * nb > len(dc):
            raise _bad(path, f"{n_dc} DC values where the channels hold "
                             f"more")
        try:
            if lib is None:
                zz, last, used = unrle_ac_python(ac[ac_at:], nb * m)
            else:
                zz, last, used = unrle_ac_native(lib, ac[ac_at:], nb * m)
        except _AcError as e:
            raise _bad(path, AC_ERRORS[e.code]) from None
        ac_at += used
        zz = zz.reshape(nb, m, 64)
        zz[:, :, 0] = dc[dc_at:dc_at + m * nb].reshape(m, nb).T
        dc_at += m * nb
        h = decode_blocks(zz, last.reshape(nb, m))
        for j, c in enumerate(comps):
            plane = _blocks_to_plane(h[:, j], ny, nx)
            if not nonlinear and (m == 3 or not channels[c][2]):
                plane = lut[plane]
            out[c] = plane if types[c] == HALF else \
                plane.view(np.float16).astype(np.float32).view(np.uint32)
    if ac_at != n_ac or dc_at != n_dc:
        raise _bad(path, f"the chunk's channels take {ac_at} AC and "
                         f"{dc_at} DC values where it counts {n_ac} and "
                         f"{n_dc}")
    return out
