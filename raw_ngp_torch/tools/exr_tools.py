"""EXR capture tooling (the JAX package's ``tools/exr_tools.py``): convert
a capture to a displayable PNG, apply a matte, solve the white balance
from a colour checker.

  convert <in.exr> <out.png> [--wb a,b,c,...9] [--percentile 99.99]
  mask <image> <mask> <out.png> [--bg black|white]
  wb <colorchecker.exr> [--crop l,u,r,b] [--patch0 x0,y0,x1,y1]
     [--delta 150]

EXR captures are read by the port's reader (``data/exr.py``), images and
mattes (PNG or JPEG) by the port's readers as cv2 / imageio read them (by
signature; RGB order), and every output PNG is written by
``data.image_io.write_png``: no imageio, cv2 or PIL. The pixels and the
matrix are the JAX tool's. ``convert`` demosaics a mosaic (bilinear
RGGB), applies the optional 3 x 3, exposes to the `percentile` and writes
the sRGB curve as 8 bits. ``mask`` keeps the image's first three
channels, in [0, 1], where the matte's first channel is above 0 and
writes the background elsewhere. ``wb`` averages the 24 patches of a
checker after the JAX tool's PIL crop (outside the image is 0) and
``rotate(rotate_deg, expand=True)`` (NEAREST; -90 by default, an exact
quarter turn clockwise), here in numpy at any angle.

Usage: python -m raw_ngp_torch.tools.exr_tools <subcommand> ...
"""

from __future__ import annotations

import argparse
import math

import numpy as np

from raw_ngp_torch.data.exr import read_exr
from raw_ngp_torch.data.image_io import _read_rgb, apply_mask, write_png
from raw_ngp_torch.postprocess.raw import bilinear_demosaic, linear_to_srgb

# standard 24-patch Macbeth ColorChecker sRGB reference values
MACBETH = np.array([
    [115, 82, 68], [194, 150, 130], [98, 122, 157], [87, 108, 67],
    [133, 128, 177], [103, 189, 170], [214, 126, 44], [80, 91, 166],
    [193, 90, 99], [94, 60, 108], [157, 188, 64], [224, 163, 46],
    [56, 61, 150], [70, 148, 73], [175, 54, 60], [231, 199, 31],
    [187, 86, 149], [8, 133, 161], [243, 243, 242], [200, 200, 200],
    [160, 160, 160], [122, 122, 121], [85, 85, 85], [52, 52, 52],
], dtype=np.float64) / 255.0


def _png_out(out: str, what: str):
    if not out.lower().endswith(".png"):
        raise ValueError(f"exr_tools {what}: {out} is not a .png; the port "
                         "writes PNG")


def convert_exr_to_png(exr_path: str, png_path: str,
                       wb: np.ndarray | None = None,
                       percentile: float = 99.99) -> np.ndarray:
    """Demosaic -> optional WB -> percentile expose -> sRGB -> 8-bit PNG
    (matte_utils.py:21-58); returns the written uint8 array."""
    _png_out(png_path, "convert")
    image = read_exr(exr_path).astype(np.float32)
    if image.ndim == 2:
        image = bilinear_demosaic(image)
    if wb is not None:
        image = image @ np.asarray(wb, np.float64).T
    exposure = np.percentile(image, percentile)
    image = linear_to_srgb(np.clip(image / max(exposure, 1e-12), 0, 1))
    pixels = (np.clip(image, 0, 1) * 255).astype(np.uint8)
    write_png(png_path, pixels)
    return pixels


def _affine_nearest(image: np.ndarray, size, m) -> np.ndarray:
    """Pillow's ImagingTransformAffine with NEAREST on a float image: each
    output pixel (x, y) takes the input pixel at floor(m . (x + 0.5, y +
    0.5, 1)), 0 outside the input. Where the four corners map inside
    +-32768 Pillow steps 16.16 fixed-point coordinates (each matrix entry
    rounded to 1/65536, the centre offset folded into the translation),
    else doubles accumulated pixel by pixel; both are followed here."""
    w, h = size
    H, W = image.shape[:2]

    def inside(x, y):
        return abs(x * m[0] + y * m[1] + m[2]) < 32768.0 and \
            abs(x * m[3] + y * m[4] + m[5]) < 32768.0

    xs, ys = np.arange(w, dtype=np.int64), np.arange(h, dtype=np.int64)
    if all(inside(x, y) for x, y in ((0, 0), (w, h), (0, h), (w, 0))):
        def fix(v):
            return math.floor(v * 65536.0 + 0.5)
        a0, a1, a3, a4 = fix(m[0]), fix(m[1]), fix(m[3]), fix(m[4])
        a2 = fix(m[2] + m[0] * 0.5 + m[1] * 0.5)
        a5 = fix(m[5] + m[3] * 0.5 + m[4] * 0.5)
        xin = (a2 + ys[:, None] * a1 + xs[None] * a0) >> 16
        yin = (a5 + ys[:, None] * a4 + xs[None] * a3) >> 16
    else:
        def walk(start, row_step, col_step):
            rows = np.add.accumulate(np.concatenate(
                [[start], np.full(h - 1, row_step)]))
            grid = np.concatenate([rows[:, None], np.full(
                (h, w - 1), col_step)], 1)
            v = np.add.accumulate(grid, axis=1)
            return np.where(v < 0, -1, v.astype(np.int64))
        xin = walk(m[2] + m[1] * 0.5 + m[0] * 0.5, m[1], m[0])
        yin = walk(m[5] + m[4] * 0.5 + m[3] * 0.5, m[4], m[3])
    ok = (xin >= 0) & (xin < W) & (yin >= 0) & (yin < H)
    out = np.zeros((h, w) + image.shape[2:], image.dtype)
    out[ok] = image[yin[ok], xin[ok]]
    return out


def rotate_expand(image: np.ndarray, angle: float) -> np.ndarray:
    """PIL's ``Image.rotate(angle, expand=True)`` of a float image (mode
    F, NEAREST, counter-clockwise degrees): 0 a copy, 180 a flip, 90 and
    270 exact quarter turns; any other angle the inverse affine map about
    the centre (its sines and cosines rounded to 15 places), the output
    the rotated corners' bounding box (floor to ceil), sampled at pixel
    centres (_affine_nearest)."""
    angle = float(angle) % 360.0
    if angle == 0:
        return image.copy()
    if angle == 180:
        return image[::-1, ::-1].copy()
    if angle in (90, 270):
        return np.ascontiguousarray(np.rot90(image, 1 if angle == 90 else 3))
    h, w = image.shape[:2]
    cx, cy = w / 2, h / 2
    a = -math.radians(angle)
    m = [round(math.cos(a), 15), round(math.sin(a), 15), 0.0,
         round(-math.sin(a), 15), round(math.cos(a), 15), 0.0]

    def transform(x, y):
        return m[0] * x + m[1] * y + m[2], m[3] * x + m[4] * y + m[5]

    m[2], m[5] = transform(-cx - 0, -cy - 0)
    m[2] += cx
    m[5] += cy
    corners = [transform(x, y) for x, y in ((0, 0), (w, 0), (w, h), (0, h))]
    xx, yy = [c[0] for c in corners], [c[1] for c in corners]
    nw = math.ceil(max(xx)) - math.floor(min(xx))
    nh = math.ceil(max(yy)) - math.floor(min(yy))
    m[2], m[5] = transform(-(nw - w) / 2.0, -(nh - h) / 2.0)
    return _affine_nearest(image, (nw, nh), m)


def crop_rotate(image: np.ndarray, crop, rotate_deg: float) -> np.ndarray:
    """PIL's ``Image.crop(crop).rotate(rotate_deg, expand=True)`` of a
    float image: the box (left, upper, right, lower), 0 where it leaves
    the image, then rotate_expand by `rotate_deg` counter-clockwise (a
    negative angle turns clockwise)."""
    left, upper, right, lower = (int(v) for v in crop)
    H, W = image.shape[:2]
    out = np.zeros((max(lower - upper, 0), max(right - left, 0))
                   + image.shape[2:], image.dtype)
    y0, y1 = max(upper, 0), min(lower, H)
    x0, x1 = max(left, 0), min(right, W)
    if y1 > y0 and x1 > x0:
        out[y0 - upper:y1 - upper, x0 - left:x1 - left] = image[y0:y1, x0:x1]
    return rotate_expand(out, rotate_deg)


def solve_wb(checker_path: str, crop=(2280, 1065, 2890, 1982),
             rotate_deg: float = -90.0, patch0=(60, 50, 140, 130),
             delta: float = 150.0,
             black: float = 0.0, white: float = 1.0) -> np.ndarray:
    """Least-squares 3x3 cam->rgb solve from a captured color checker
    (img/image_utils.py:263-363 determine_wb, generalized): average each
    of the 24 patches, then solve ``cam @ M.T ~= MACBETH``."""
    image = read_exr(checker_path).astype(np.float32)
    image = crop_rotate(image, crop, rotate_deg)
    image = (np.asarray(image, np.float32) - black) / (white - black)
    if image.ndim == 2:
        image = bilinear_demosaic(image)

    x0, y0, x1, y1 = patch0
    cam = np.zeros((24, 3))
    idx = 0
    for row in range(4):
        for col in range(6):
            xs = slice(int(x0 + row * delta), int(x1 + row * delta))
            ys = slice(int(y0 + col * delta), int(y1 + col * delta))
            cam[idx] = image[xs, ys].reshape(-1, 3).mean(axis=0)
            idx += 1
    # rows of M map camera RGB -> reference RGB
    M, *_ = np.linalg.lstsq(cam, MACBETH, rcond=None)
    return M.T


def mask_image(image: str, mask: str, out: str, bg: str = "black"):
    """Write `image` with `mask` applied over background `bg` to the PNG
    `out`; returns the written uint8 array."""
    _png_out(out, "mask")
    img = np.asarray(_read_rgb(image), np.float32) / 255.0
    matte = np.asarray(_read_rgb(mask))
    result = apply_mask(img[..., :3], matte, bg)
    pixels = (np.clip(result, 0, 1) * 255).astype(np.uint8)
    write_png(out, pixels)
    return pixels


def main(argv=None):
    p = argparse.ArgumentParser()
    sub = p.add_subparsers(dest="cmd", required=True)

    c = sub.add_parser("convert")
    c.add_argument("exr")
    c.add_argument("png")
    c.add_argument("--wb", type=str, default=None,
                   help="9 comma-separated cam2rgb entries")
    c.add_argument("--percentile", type=float, default=99.99)

    m = sub.add_parser("mask")
    m.add_argument("image")
    m.add_argument("mask")
    m.add_argument("out")
    m.add_argument("--bg", default="black", choices=["black", "white"])

    w = sub.add_parser("wb")
    w.add_argument("checker")
    w.add_argument("--crop", type=str, default="2280,1065,2890,1982")
    w.add_argument("--patch0", type=str, default="60,50,140,130")
    w.add_argument("--delta", type=float, default=150.0)

    args = p.parse_args(argv)
    if args.cmd == "convert":
        wb = None
        if args.wb:
            wb = np.array([float(v) for v in args.wb.split(",")]).reshape(3, 3)
        out = convert_exr_to_png(args.exr, args.png, wb, args.percentile)
        print(f"wrote {args.png}")
        return out
    if args.cmd == "mask":
        out = mask_image(args.image, args.mask, args.out, args.bg)
        print(f"wrote {args.out}")
        return out
    crop = tuple(int(v) for v in args.crop.split(","))
    patch0 = tuple(int(v) for v in args.patch0.split(","))
    M = solve_wb(args.checker, crop=crop, patch0=patch0, delta=args.delta)
    print("cam2rgb =")
    print(np.array2string(M, precision=8))
    return M


if __name__ == "__main__":
    main()
