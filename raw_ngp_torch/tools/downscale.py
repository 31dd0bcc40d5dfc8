"""Image downscaler: <root>/images -> <root>/images_<factor> (counterpart
of the JAX package's ``tools/downscale.py``, which reads, resizes and
writes through cv2).

PNG is read by the port's reader, shrunk by ``resize_area`` (cv2's
``INTER_AREA`` in numpy, the same pixels) and written by its writer. Any
other image format raises ``ImportError``: the port decodes and encodes
PNG only (JPEG and EXR need cv2 or imageio, which the card's machine does
not have). Files that are not images are skipped, as cv2.imread skips
them.

Usage: python -m raw_ngp_torch.tools.downscale <root> --factor 4
           [--folder images]
"""

from __future__ import annotations

import argparse
import glob
import os

from raw_ngp_torch.data.image_io import read_png, resize_area, write_png

IMAGE_SUFFIXES = (".jpg", ".jpeg", ".jpe", ".exr", ".tif", ".tiff", ".bmp",
                  ".webp", ".dng", ".hdr", ".pfm", ".ppm", ".pgm", ".jp2")


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("root", type=str)
    p.add_argument("--factor", type=int, default=4)
    p.add_argument("--folder", type=str, default="images")
    args = p.parse_args(argv)

    src = os.path.join(args.root, args.folder)
    dst = os.path.join(args.root, f"{args.folder}_{args.factor}")
    os.makedirs(dst, exist_ok=True)
    n = 0
    for path in sorted(glob.glob(os.path.join(src, "*"))):
        name = path.lower()
        if name.endswith(IMAGE_SUFFIXES):
            raise ImportError(
                f"downscale: {path} is not a PNG; the port reads and writes "
                "PNG only (other formats need cv2)")
        if not name.endswith(".png"):
            continue
        img = read_png(path)
        H, W = img.shape[:2]
        small = resize_area(img, H // args.factor, W // args.factor)
        write_png(os.path.join(dst, os.path.basename(path)), small)
        n += 1
    print(f"downscaled {n} images {args.factor}x into {dst}")
    return dst


if __name__ == "__main__":
    main()
