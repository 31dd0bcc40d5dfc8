"""Image loading: LDR (png/jpg) and HDR (EXR / DNG) with RAW metadata (port
of ``raw_ngp_tpu/data/image_io.py``).

Redesign of the reference's load_images (img/image_utils.py:38-241). The
reference returns images and smuggles per-image metadata through the
mutable ``opt.metadict``; here loading returns ``(images, ImageMetadata)``
explicitly.

Key constants preserved for parity:
  * light-stage black level 0.00024420026 / white level 1.0 in --clip mode
    (image_utils.py:140-148)
  * the light-stage cam2rgb matrix x 255 for EXR captures
    (image_utils.py:217-222)
  * bracketing shutter speed parsed from the ``_e<micros>`` filename suffix
    (image_utils.py:92-94), relative exposure = shutter / max shutter
    (image_utils.py:107-121)

The JAX package decodes every image through cv2. The port reads PNG
(:func:`read_png`, numpy + ``zlib``) and JPEG (``data/jpeg.py``
:func:`read_jpeg`, libjpeg-turbo's decoder in numpy with a C++ entropy
decode) itself, choosing by the file's signature as cv2 does, and resizes
with :func:`resize_area`, a numpy copy of cv2's ``INTER_AREA`` (its area
downscale and, where an axis enlarges, its linear branch with area-mode
coefficients); all give cv2's values and dtypes on every machine. Other
formats go to cv2, EXR to imageio, then cv2, and DNG to rawpy, by JAX's
lazy imports, and raise ``ImportError`` where the library is absent;
nothing imports them with this module.
"""

from __future__ import annotations

import json
import os
import struct
import zlib
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

from raw_ngp_torch import native
from raw_ngp_torch.data.jpeg import jpeg_size, read_jpeg
from raw_ngp_torch.postprocess.raw import linear_to_srgb

# lightstage measured black/white levels (image_utils.py:142-143)
LIGHTSTAGE_BLACKLEVEL = 0.00024420026
LIGHTSTAGE_WHITELEVEL = 1.0

# lightstage EXR color matrix (image_utils.py:219-222), stored x255
LIGHTSTAGE_CAM2RGB = np.array(
    [[0.00689549, -0.00128842, -0.00071225],
     [-0.00200243, 0.00597485, -0.00057672],
     [0.00040781, -0.0030018, 0.00672216]]) * 255.0

# linear RGB -> XYZ (image_utils.py _RGB2XYZ constant; standard sRGB D65)
RGB2XYZ = np.array([
    [0.4124564, 0.3575761, 0.1804375],
    [0.2126729, 0.7151522, 0.0721750],
    [0.0193339, 0.1191920, 0.9503041],
])


@dataclass
class ImageMetadata:
    """Per-image metadata extracted during loading (replaces opt.metadict)."""

    filenames: List[str] = field(default_factory=list)
    shutter_speeds: List[float] = field(default_factory=list)
    cam2rgb: List[np.ndarray] = field(default_factory=list)
    ldirs: List[np.ndarray] = field(default_factory=list)
    exposure_idx: Optional[np.ndarray] = None
    exposure_values: Optional[np.ndarray] = None
    unique_shutters: Optional[np.ndarray] = None

    def finalize_exposures(self):
        """Relative exposures with 1.0 = brightest (image_utils.py:107-121)."""
        ss = np.array(self.shutter_speeds, dtype=np.float64)
        if len(ss) == 0:
            return
        unique = np.sort(np.unique(ss))[::-1]
        idx = np.zeros(len(ss), np.int32)
        for i, s in enumerate(unique):
            idx[ss == s] = i
        self.exposure_idx = idx
        self.unique_shutters = unique
        self.exposure_values = (ss / unique[0]).astype(np.float32)


# ---------------------------------------------------------------------------
# PNG (https://www.w3.org/TR/png/)
# ---------------------------------------------------------------------------

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
# Adam7 passes: (x0, y0, dx, dy)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _png_chunks(data: bytes, path: str):
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos = 8
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        yield kind, data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IEND":
            return


def png_size(path: str) -> Tuple[int, int]:
    """(height, width) of a PNG, from its header."""
    with open(path, "rb") as f:
        head = f.read(24)
    if head[:8] != _PNG_SIGNATURE or head[12:16] != b"IHDR":
        raise ValueError(f"{path}: not a PNG file")
    width, height = struct.unpack(">II", head[16:24])
    return int(height), int(width)


def _unfilter_avg_paeth(row: bytes, prev: bytes, bpp: int,
                        paeth: bool) -> bytearray:
    """One row of filter 3 (average) or 4 (Paeth), which read the bytes
    they reconstruct, so go byte by byte."""
    cur = bytearray(row)
    for i in range(min(bpp, len(cur))):
        up = prev[i]
        cur[i] = (cur[i] + (up if paeth else up >> 1)) & 255
    for i in range(bpp, len(cur)):
        a, b = cur[i - bpp], prev[i]
        if paeth:
            c = prev[i - bpp]
            pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        else:
            pred = (a + b) >> 1
        cur[i] = (cur[i] + pred) & 255
    return cur


def _unfilter(raw: bytes, pos: int, h: int, stride: int,
              bpp: int) -> Tuple[np.ndarray, int]:
    """The h reconstructed rows [h, stride] uint8 of one (sub-)image whose
    filtered rows start at raw[pos]; returns them and the end position."""
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        kind = raw[pos]
        row = np.frombuffer(raw, np.uint8, stride, pos + 1)
        pos += 1 + stride
        if kind == 0:
            cur = row
        elif kind == 1:
            cur = np.cumsum(row.reshape(-1, bpp), axis=0,
                            dtype=np.uint8).reshape(-1)
        elif kind == 2:
            cur = row + prev
        elif kind in (3, 4):
            cur = np.frombuffer(_unfilter_avg_paeth(
                row.tobytes(), prev.tobytes(), bpp, kind == 4), np.uint8)
        else:
            raise ValueError(f"PNG row filter {kind} is not defined")
        out[y] = cur
        prev = out[y]
    return out, pos


def _samples(rows: np.ndarray, w: int, ch: int, depth: int) -> np.ndarray:
    """Reconstructed rows [h, stride] -> samples [h, w, ch] (uint8, or
    uint16 at depth 16)."""
    h = rows.shape[0]
    if depth == 16:
        return rows.view(">u2").astype(np.uint16).reshape(h, w, ch)
    if depth == 8:
        return rows.reshape(h, w, ch)
    per = 8 // depth                     # samples a byte, first in the MSBs
    shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
    vals = (rows[:, :, None] >> shifts) & np.uint8((1 << depth) - 1)
    return vals.reshape(h, rows.shape[1] * per)[:, :w * ch].reshape(h, w, ch)


def read_png(path: str) -> np.ndarray:
    """A PNG as ``cv2.imread(path, cv2.IMREAD_UNCHANGED)`` returns it, with
    the colour channels in RGB(A) order: [H, W] for grey, [H, W, 3] for
    RGB and palette images, [H, W, 4] for grey + alpha, RGBA, and palette
    or RGB images with a tRNS chunk (alpha 0 at the transparent colour);
    uint16 at bit depth 16, else uint8 (grey below 8 bits scaled to
    0-255). Interlaced (Adam7) images and every bit depth of the standard
    are read; an undefined header raises ``ValueError``."""
    with open(path, "rb") as f:
        data = f.read()
    ihdr = plte = trns = None
    idat = []
    for kind, body in _png_chunks(data, path):
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            plte = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"tRNS":
            trns = body
        elif kind == b"IDAT":
            idat.append(body)
    if ihdr is None:
        raise ValueError(f"{path}: PNG without an IHDR chunk")
    W, H, depth, color, _, _, interlace = ihdr
    if color not in _PNG_CHANNELS or depth not in (1, 2, 4, 8, 16):
        raise ValueError(f"{path}: PNG colour type {color} at bit depth "
                         f"{depth} is not defined")
    if color == 3 and plte is None:
        raise ValueError(f"{path}: palette PNG without a PLTE chunk")
    ch = _PNG_CHANNELS[color]
    bpp = max(1, ch * depth // 8)
    raw = zlib.decompress(b"".join(idat))
    if interlace == 0:
        rows, _ = _unfilter(raw, 0, H, (W * ch * depth + 7) // 8, bpp)
        img = _samples(rows, W, ch, depth)
    else:
        img = np.zeros((H, W, ch), np.uint16 if depth == 16 else np.uint8)
        pos = 0
        for x0, y0, dx, dy in _ADAM7:
            pw, ph = -(-(W - x0) // dx), -(-(H - y0) // dy)
            if pw <= 0 or ph <= 0:
                continue
            rows, pos = _unfilter(raw, pos, ph, (pw * ch * depth + 7) // 8,
                                  bpp)
            img[y0::dy, x0::dx] = _samples(rows, pw, ch, depth)
    top = (1 << depth) - 1
    if color == 0:
        if depth < 8:
            img = img * np.uint8(255 // top)
        return img[..., 0]
    if color == 3:
        rgb = plte[np.minimum(img[..., 0], len(plte) - 1)]
        if trns is None:
            return rgb
        alpha = np.full(256, 255, np.uint8)
        alpha[:len(trns)] = np.frombuffer(trns, np.uint8)
        return np.concatenate([rgb, alpha[img[..., :1]]], -1)
    if color == 4:
        return np.concatenate([img[..., :1].repeat(3, -1), img[..., 1:]], -1)
    if color == 2 and trns is not None:
        key = np.array(struct.unpack(">3H", trns[:6]), img.dtype)
        alpha = np.where((img == key).all(-1, keepdims=True), 0, top)
        return np.concatenate([img, alpha.astype(img.dtype)], -1)
    return img


def write_png(path: str, img: np.ndarray):
    """Write a [H, W] grey or [H, W, 3|4] RGB(A) uint8 or uint16 array as a
    PNG (filter 0, no interlace)."""
    img = np.asarray(img)
    if img.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"write_png: dtype {img.dtype} is not uint8/16")
    if img.ndim == 2:
        img = img[..., None]
    H, W, ch = img.shape
    color = {1: 0, 3: 2, 4: 6}[ch]
    depth = 8 * img.dtype.itemsize
    rows = img.astype(img.dtype.newbyteorder(">")).reshape(H, -1)
    rows = np.concatenate([np.zeros((H, 1), np.uint8),
                           rows.view(np.uint8)], 1)

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    with open(path, "wb") as f:
        f.write(_PNG_SIGNATURE
                + chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, depth, color,
                                             0, 0, 0))
                + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
                + chunk(b"IEND", b""))


# ---------------------------------------------------------------------------
# cv2.INTER_AREA downscale
# ---------------------------------------------------------------------------

def _round_saturate(x: np.ndarray, dtype) -> np.ndarray:
    """cv2's saturate_cast from float: round half to even, then clamp."""
    if dtype == np.float32:
        return x.astype(np.float32)
    info = np.iinfo(dtype)
    return np.clip(np.rint(x), info.min, info.max).astype(dtype)


def _area_tab(ssize: int, dsize: int, scale: float):
    """cv2's computeResizeAreaTab: for each destination index, its source
    indices and f32 weights [dsize, m] (padded with weight 0)."""
    rows = []
    for d in range(dsize):
        f1 = d * scale
        f2 = f1 + scale
        cell = min(scale, ssize - f1)
        s2 = min(int(np.floor(f2)), ssize - 1)
        s1 = min(int(np.ceil(f1)), s2)
        tab = []
        if s1 - f1 > 1e-3:
            tab.append((s1 - 1, (s1 - f1) / cell))
        tab += [(s, 1.0 / cell) for s in range(s1, s2)]
        if f2 - s2 > 1e-3:
            tab.append((s2, min(min(f2 - s2, 1.0), cell) / cell))
        rows.append(tab)
    m = max(len(t) for t in rows)
    src = np.zeros((dsize, m), np.int64)
    wgt = np.zeros((dsize, m), np.float32)
    for d, tab in enumerate(rows):
        for j, (s, a) in enumerate(tab):
            src[d, j], wgt[d, j] = s, np.float32(a)
    return src, wgt


def _linear_tab(ssize: int, dsize: int, clamp: bool):
    """cv2 resize's area-mode coefficients of its linear branch: each
    destination index's source index and f32 weight of the next source,
    fx = (d + 1) - (s + 1) / scale with s = floor(d * scale), clamped into
    [0, 1); on the x axis the last source takes weight 0 (the scalar
    tail cv2 runs there)."""
    inv = dsize / ssize
    scale = 1.0 / inv
    src = np.empty(dsize, np.int64)
    frac = np.empty(dsize, np.float32)
    for d in range(dsize):
        s = int(np.floor(d * scale))
        f = np.float32((d + 1) - (s + 1) * inv)
        f = np.float32(0) if f <= 0 else f - np.float32(np.floor(f))
        if clamp and s >= ssize - 1:
            s, f = ssize - 1, np.float32(0)
        src[d], frac[d] = s, f
    return src, frac


def _resize_linear_area(x: np.ndarray, H: int, W: int) -> np.ndarray:
    """cv2.resize's INTER_AREA where an axis enlarges (resize.cpp's linear
    branch, area mode) on [h, w, C]: a 2-tap row pass, then a 2-tap
    column pass over the rows s and s + 1 (clipped to the image). 8 bits
    in cv2's fixed point (weights round(2048 w) as int16, the column pass
    ((b0 (S0 >> 4)) >> 16) + ((b1 (S1 >> 4)) >> 16) + 2 >> 2); 16 bits and
    f32 in f32, products summed in pairs, 16 bits rounded half to even."""
    h, w = x.shape[:2]
    sx, fx = _linear_tab(w, W, clamp=True)
    sy, fy = _linear_tab(h, H, clamp=False)
    x1 = np.minimum(sx + 1, w - 1)
    y0, y1 = np.clip(sy, 0, h - 1), np.clip(sy + 1, 0, h - 1)
    one = np.float32(1)
    if x.dtype == np.uint8:
        scale = np.float32(2048)
        a0 = np.rint((one - fx) * scale).astype(np.int64)[:, None]
        a1 = np.rint(fx * scale).astype(np.int64)[:, None]
        b0 = np.rint((one - fy) * scale).astype(np.int64)[:, None, None]
        b1 = np.rint(fy * scale).astype(np.int64)[:, None, None]
        xi = x.astype(np.int64)
        rows = xi[:, sx] * a0 + xi[:, x1] * a1
        out = (((b0 * (rows[y0] >> 4)) >> 16)
               + ((b1 * (rows[y1] >> 4)) >> 16) + 2) >> 2
        return np.clip(out, 0, 255).astype(np.uint8)
    xf = x.astype(np.float32)
    a0, a1 = (one - fx)[:, None], fx[:, None]
    rows = xf[:, sx] * a0 + xf[:, x1] * a1
    last = sx >= w - 1
    rows[:, last] = xf[:, sx[last]]
    b0, b1 = (one - fy)[:, None, None], fy[:, None, None]
    out = rows[y0] * b0 + rows[y1] * b1
    return _round_saturate(out, x.dtype)


def resize_area(img: np.ndarray, H: int, W: int) -> np.ndarray:
    """``cv2.resize(img, (W, H), interpolation=cv2.INTER_AREA)`` of a
    [h, w] or [h, w, C] uint8, uint16 or float32 image, in cv2's
    arithmetic. A downscale on both axes: an integer factor averages whole
    blocks (2 x 2 in integers, (sum + 2) >> 2, for 8 and 16 bits;
    otherwise the f32 sum times the f32 reciprocal of the block's area,
    rounded half to even); any other factor weighs the source cells that
    each destination cell covers, a row, then the rows, in f32. Where
    either axis enlarges (one may shrink), cv2's linear branch with
    area-mode coefficients (:func:`_resize_linear_area`)."""
    h, w = img.shape[:2]
    if (h, w) == (H, W):
        return img
    dtype = img.dtype
    if dtype not in (np.uint8, np.uint16, np.float32):
        raise ValueError(f"resize_area: dtype {dtype} is not ported")
    x = img[..., None] if img.ndim == 2 else img
    cn = x.shape[-1]
    if H > h or W > w:
        out = _resize_linear_area(x, H, W)
        return out[..., 0] if img.ndim == 2 else out
    # cv2's factors: the reciprocals of dsize / ssize, in f64
    sx, sy = 1.0 / (W / w), 1.0 / (H / h)
    ix, iy = int(np.rint(sx)), int(np.rint(sy))
    eps = np.finfo(np.float64).eps
    if abs(sx - ix) < eps and abs(sy - iy) < eps:
        blocks = x.reshape(H, iy, W, ix, cn).transpose(0, 2, 4, 1, 3)
        blocks = blocks.reshape(H, W, cn, iy * ix)
        if ix == iy == 2 and cn in (1, 3, 4) and dtype != np.float32:
            s = blocks.astype(np.int64).sum(-1)
            out = ((s + 2) >> 2).astype(dtype)
        elif ix == iy == 2 and cn in (1, 4):
            # cv2's 4-lane vector sum, and in order past the last whole
            # vector of a 1-channel row
            v = blocks
            out = ((v[..., 0] + v[..., 1]) + (v[..., 2] + v[..., 3])) \
                * np.float32(0.25)
            tail = W - W % 4 if cn == 1 else W
            out[:, tail:] = (((v[:, tail:, :, 0] + v[:, tail:, :, 1])
                              + v[:, tail:, :, 2]) + v[:, tail:, :, 3]) \
                * np.float32(0.25)
        else:
            scale = np.float32(1.0 / (ix * iy))
            if dtype == np.uint8:
                s = blocks.astype(np.int64).sum(-1).astype(np.float32)
            else:
                # f32 sum of four-term groups, each group summed in order
                # (int for 16 bits)
                v = blocks if dtype == np.float32 else \
                    blocks.astype(np.int64)
                s = np.zeros(blocks.shape[:-1], np.float32)
                k = 0
                while k + 4 <= ix * iy:
                    g = ((v[..., k] + v[..., k + 1]) + v[..., k + 2]) \
                        + v[..., k + 3]
                    s = s + g.astype(np.float32)
                    k += 4
                for k in range(k, ix * iy):
                    s = s + v[..., k].astype(np.float32)
            out = _round_saturate(s * scale, dtype)
    else:
        xs, xw = _area_tab(w, W, sx)
        ys, yw = _area_tab(h, H, sy)
        xf = x.astype(np.float32)
        buf = np.zeros((h, W, cn), np.float32)
        for j in range(xs.shape[1]):
            buf = buf + xf[:, xs[:, j]] * xw[:, j, None]
        acc = np.zeros((H, W, cn), np.float32)
        for j in range(ys.shape[1]):
            acc = acc + buf[ys[:, j]] * yw[:, j, None, None]
        out = _round_saturate(acc, dtype)
    return out[..., 0] if img.ndim == 2 else out


def _resize(img, H, W):
    if img.shape[0] != H or img.shape[1] != W:
        return resize_area(img, H, W)
    return img


# ---------------------------------------------------------------------------
# loaders
# ---------------------------------------------------------------------------

_SIGNATURES = ((_PNG_SIGNATURE, "PNG"), (b"\xff\xd8\xff", "JPEG"),
               (b"v/1\x01", "OpenEXR"), (b"II*\x00", "TIFF"),
               (b"MM\x00*", "TIFF"), (b"BM", "BMP"),
               (b"\x00\x00\x00\x0cjP  ", "JPEG 2000"),
               (b"\xffO\xffQ", "JPEG 2000"), (b"#?RADIANCE", "Radiance HDR"),
               (b"#?RGBE", "Radiance HDR"), (b"PF", "PFM"), (b"Pf", "PFM"))


def image_format(path: str) -> str:
    """The image format of a file by its signature, as cv2 chooses its
    decoder: "PNG", "JPEG", another format's name, or "unknown"."""
    with open(path, "rb") as f:
        head = f.read(12)
    if head[:4] == b"RIFF" and head[8:12] == b"WEBP":
        return "WebP"
    for sig, name in _SIGNATURES:
        if head.startswith(sig):
            return name
    if len(head) >= 2 and head[:1] == b"P" and head[1:2] in b"123456":
        return "PNM"
    return "unknown"


def _read_rgb(path: str) -> np.ndarray:
    """An image file as cv2.imread(IMREAD_UNCHANGED) gives it, colour
    channels in RGB(A) order: PNG through read_png and JPEG through
    read_jpeg (chosen by the signature), any other format through cv2
    (ImportError naming the format without it)."""
    fmt = image_format(path)
    if fmt == "PNG":
        return read_png(path)
    if fmt == "JPEG":
        return read_jpeg(path)
    try:
        import cv2
    except ImportError as e:
        raise ImportError(f"{path}: a {fmt} image needs cv2; the port reads "
                          "PNG and JPEG only") from e
    img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if img is None:
        raise FileNotFoundError(path)
    if img.ndim == 3 and img.shape[-1] in (3, 4):
        img = np.concatenate([img[..., 2::-1], img[..., 3:]], -1)
    return img


def image_size(path: str) -> Tuple[int, int]:
    """(height, width) of an image file: a PNG's and a JPEG's from their
    headers, any other through cv2 (ImportError without it)."""
    fmt = image_format(path)
    if fmt == "PNG":
        return png_size(path)
    if fmt == "JPEG":
        return jpeg_size(path)
    return _read_rgb(path).shape[:2]


def load_ldr_image(path: str, H: int, W: int) -> np.ndarray:
    """png/jpg -> float [H, W, 3/4] in [0, 1] (image_utils.py:52-65)."""
    img = _read_rgb(path)
    if img.ndim == 2:
        img = img[..., None].repeat(3, -1)
    img = _resize(img, H, W)
    if img.dtype == np.uint8:
        return img.astype(np.float32) / 255.0
    if img.dtype == np.uint16:
        return img.astype(np.float32) / 65535.0
    return img.astype(np.float32)


def load_exr_image(path: str) -> np.ndarray:
    """EXR via imageio (or cv2 fallback)."""
    try:
        import imageio.v2 as iio
        return np.asarray(iio.imread(path)).astype(np.float32)
    except Exception:
        import cv2
        img = cv2.imread(path, cv2.IMREAD_UNCHANGED | cv2.IMREAD_ANYDEPTH)
        if img is None:
            raise
        if img.ndim == 3 and img.shape[-1] >= 3:
            img = cv2.cvtColor(img[..., :3], cv2.COLOR_BGR2RGB)
        return img.astype(np.float32)


def load_dng_raw(path: str) -> np.ndarray:
    """Raw sensor mosaic from a DNG (image_utils.py:129-131). Requires
    rawpy; raises ImportError with guidance otherwise."""
    try:
        import rawpy
    except ImportError as e:
        raise ImportError(
            "rawpy is required for DNG captures; convert to EXR or install "
            "rawpy") from e
    with open(path, "rb") as f:
        return rawpy.imread(f).raw_image.astype(np.float32)


def dng_cam2rgb(exif: dict) -> np.ndarray:
    """Color matrix from DNG EXIF (image_utils.py:204-214): white-balance
    diagonal + ColorMatrix2-derived rgb2cam inverse."""
    wb = np.array(str(exif["AsShotNeutral"]).split()).astype(float)
    cam2camwb = np.diag(1.0 / wb)
    xyz2camwb = np.array(str(exif["ColorMatrix2"]).split()).astype(
        float).reshape(3, 3)
    rgb2camwb = xyz2camwb @ RGB2XYZ
    rgb2camwb /= rgb2camwb.sum(axis=-1, keepdims=True)
    return np.linalg.inv(rgb2camwb) @ cam2camwb


def apply_mask(image: np.ndarray, mask: np.ndarray,
               background: str) -> np.ndarray:
    """SAM-matte mask application (image_utils.py:174-202): background
    pixels become 0 (black) or 1 (white)."""
    if mask.ndim == 3:
        mask = mask[..., 0]
    bg = 0.0 if background == "black" else 1.0
    return np.where(mask[..., None] > 0, image, bg).astype(np.float32)


def mosaic_to_3ch(image: np.ndarray) -> np.ndarray:
    """Keep Bayer data mosaiced but expand to 3 channels with zeros at
    unobserved sites (image_utils.py:157-163) — pairs with the Bayer loss
    mask during training."""
    rgb = np.zeros((*image.shape[:2], 3), np.float32)
    rgb[0::2, 0::2, 0] = image[0::2, 0::2]
    rgb[0::2, 1::2, 1] = image[0::2, 1::2]
    rgb[1::2, 0::2, 1] = image[1::2, 0::2]
    rgb[1::2, 1::2, 2] = image[1::2, 1::2]
    return rgb


def load_hdr_image(
    path: str,
    H: int,
    W: int,
    clip: bool = True,
    mosaiced: bool = False,
    masked: bool = False,
    mask_dir: Optional[str] = None,
    background: str = "black",
    expose: bool = False,
    exposure_percentile: float = 99.0,
    exif: Optional[dict] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """One HDR capture -> (linear image [H, W, 3], cam2rgb [3, 3])
    (image_utils.py:125-238). The mask file (``<name>.png``) is read by
    its signature, as cv2 reads it."""
    ext = path.rsplit(".", 1)[-1].lower()
    if ext == "exr":
        image = load_exr_image(path)
        cam2rgb = LIGHTSTAGE_CAM2RGB.copy()
    else:
        image = load_dng_raw(path)
        if exif is None:
            with open(path.rsplit(".", 1)[0] + ".json", "rb") as f:
                exif = json.load(f)[0]
        cam2rgb = dng_cam2rgb(exif)

    image = image.astype(np.float32)
    if clip:
        black, white = LIGHTSTAGE_BLACKLEVEL, LIGHTSTAGE_WHITELEVEL
    else:
        assert exif is not None, "--clip off requires EXIF black/white level"
        black, white = float(exif["BlackLevel"]), float(exif["WhiteLevel"])
    image = native.normalize_levels(image, black, white, clip=clip)

    if image.ndim == 2 and not mosaiced:
        image = native.demosaic_rggb(image)
    image = _resize(image, H, W)
    if mosaiced and image.ndim == 2:
        image = mosaic_to_3ch(image)

    if masked and mask_dir is not None:
        base = os.path.splitext(os.path.basename(path))[0]
        base = base.split("_e")[0].split("_l")[0]
        mask_path = os.path.join(mask_dir, base + ".png")
        mask = _resize(_read_rgb(mask_path), H, W)
        image = apply_mask(image, mask, background)

    if expose:
        rgb_linear = image @ cam2rgb.T
        exposure = np.percentile(rgb_linear, exposure_percentile)
        image = linear_to_srgb(np.clip(rgb_linear / exposure, 0, 1))

    return image.astype(np.float32), cam2rgb


def parse_shutter_from_name(path: str, bracketing: bool) -> float:
    """Shutter (seconds) from the ``_e<micros>`` suffix
    (image_utils.py:92-94); 1.0 when not bracketing."""
    if not bracketing:
        return 1.0
    stem = path.rsplit(".", 1)[0]
    return float(stem.split("e")[-1]) / 1_000_000.0


def parse_led_from_name(path: str) -> int:
    """LED id from the ``_l<led>`` suffix (image_utils.py:79-80)."""
    return int(path.rsplit(".", 1)[0].split("l")[-1])
