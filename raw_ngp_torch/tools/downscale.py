"""Image downscaler: <root>/images -> <root>/images_<factor> (counterpart
of the JAX package's ``tools/downscale.py``, which reads, resizes and
writes through cv2).

Each file is read as cv2.imread reads it, by its signature: PNG by the
port's reader, JPEG by ``data/jpeg.py``, OpenEXR by ``data/exr.py``
(float32, with its A channel where it has one, as cv2's
IMREAD_UNCHANGED reads it). It is shrunk by ``resize_area`` (cv2's
``INTER_AREA`` in numpy, the same pixels) and written under the same
name in the format of its extension, as cv2.imwrite writes: ``.png`` by
the port's PNG writer (the same pixels), ``.jpg`` / ``.jpeg`` / ``.jpe``
by ``write_jpeg`` at cv2's default quality 95 (the same bytes), ``.exr``
(an OpenEXR image only) by ``exr.write_exr``, OpenCV's EXR encoder's
layout (FLOAT, ZIP, A kept; the same pixels). Any other image format,
read or written, raises ``ImportError`` naming it: those need cv2, which the
card's machine does not have. Files that are not images are skipped, as
cv2.imread skips them.

Usage: python -m raw_ngp_torch.tools.downscale <root> --factor 4
           [--folder images]
"""

from __future__ import annotations

import argparse
import functools
import glob
import os

from raw_ngp_torch.data.exr import read_exr, write_exr
from raw_ngp_torch.data.image_io import (image_format, read_png,
                                         resize_area, write_png)
from raw_ngp_torch.data.jpeg import read_jpeg, write_jpeg

READERS = {"PNG": read_png, "JPEG": read_jpeg,
           "OpenEXR": functools.partial(read_exr, alpha=True)}
WRITERS = {".png": write_png, ".jpg": write_jpeg, ".jpeg": write_jpeg,
           ".jpe": write_jpeg, ".exr": write_exr}


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
        if not os.path.isfile(path):
            continue
        fmt = image_format(path)
        if fmt == "unknown":
            continue
        ext = os.path.splitext(path)[1].lower()
        if fmt not in READERS or ext not in WRITERS or \
                (fmt == "OpenEXR") != (ext == ".exr"):
            raise ImportError(
                f"downscale: {path} is a {fmt} image written as '{ext}'; "
                "the port reads and writes PNG and JPEG, and OpenEXR as "
                "'.exr', only (other formats need cv2)")
        img = READERS[fmt](path)
        H, W = img.shape[:2]
        small = resize_area(img, H // args.factor, W // args.factor)
        WRITERS[ext](os.path.join(dst, os.path.basename(path)), small)
        n += 1
    print(f"downscaled {n} images {args.factor}x into {dst}")
    return dst


if __name__ == "__main__":
    main()
