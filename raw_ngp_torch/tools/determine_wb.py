"""CLI for the color-checker white-balance solve (copy of the JAX
package's ``tools/determine_wb.py``; reference img/determineWB.py +
image_utils.py:263-363, with the hard-coded capture path/crop promoted to
arguments).

Reads ``.npy`` and PNG (the port's reader); EXR goes through
``data.image_io.load_exr_image``, which needs imageio or cv2 and raises
``ImportError`` without them.

Usage:
  python -m raw_ngp_torch.tools.determine_wb chart.npy \
      --crop 2280 1065 2890 1982 --rot90 -1 --black 0 --white 4095 \
      --mosaiced -o wb.npy
"""

from __future__ import annotations

import argparse

import numpy as np

from raw_ngp_torch.data.image_io import load_exr_image, read_png
from raw_ngp_torch.postprocess import determine_wb


def read_chart(path: str) -> np.ndarray:
    """The capture as an array: ``.npy`` as saved, PNG as the port's
    reader decodes it (RGB), anything else as an EXR."""
    if path.endswith(".npy"):
        return np.load(path)
    if path.lower().endswith(".png"):
        return read_png(path)
    return load_exr_image(path)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("image", help="linear color-checker capture "
                                  "(npy/PNG/EXR)")
    ap.add_argument("--crop", type=int, nargs=4, default=None,
                    metavar=("LEFT", "UPPER", "RIGHT", "LOWER"))
    ap.add_argument("--rot90", type=int, default=0,
                    help="clockwise 90-degree turns (reference uses -1)")
    ap.add_argument("--black", type=float, default=0.0)
    ap.add_argument("--white", type=float, default=1.0)
    ap.add_argument("--mosaiced", action="store_true")
    ap.add_argument("--first_patch", type=int, nargs=4,
                    default=(60, 50, 140, 130))
    ap.add_argument("--spacing", type=float, default=150.0)
    ap.add_argument("-o", "--out", default="wb.npy")
    args = ap.parse_args(argv)

    img = read_chart(args.image)
    mat = determine_wb(img, black_level=args.black, white_level=args.white,
                       crop=tuple(args.crop) if args.crop else None,
                       rot90=args.rot90, mosaiced=args.mosaiced,
                       first_patch=tuple(args.first_patch),
                       spacing=args.spacing)
    np.save(args.out, mat)
    print("color matrix:")
    print(mat)
    print(f"saved -> {args.out}")
    return mat


if __name__ == "__main__":
    main()
