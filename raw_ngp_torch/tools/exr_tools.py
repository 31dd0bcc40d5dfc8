"""Capture tooling: the ``mask`` subcommand of the JAX package's
``tools/exr_tools.py`` (apply a matte to an image).

  mask <image> <mask> <out.png> [--bg black|white]

The image and the matte are PNG or JPEG, read by the port's readers as
cv2 / imageio read them (by signature; RGB order); the image's first three
channels, in [0, 1], keep their values where the matte's first channel is
above 0 and become the background elsewhere (``data.image_io.apply_mask``);
the result is written as an 8-bit PNG, the pixels of the JAX tool's.

The JAX tool's ``convert`` and ``wb`` subcommands read EXR captures, which
the port cannot read without imageio or cv2: they wait for an EXR reader
held against a reference (ROADMAP A12c-3).

Usage: python -m raw_ngp_torch.tools.exr_tools mask <image> <mask> <out>
           [--bg black|white]
"""

from __future__ import annotations

import argparse

import numpy as np

from raw_ngp_torch.data.image_io import _read_rgb, apply_mask, write_png


def mask_image(image: str, mask: str, out: str, bg: str = "black"):
    """Write `image` with `mask` applied over background `bg` to the PNG
    `out`; returns the written uint8 array."""
    if not out.lower().endswith(".png"):
        raise ValueError(f"exr_tools mask: {out} is not a .png; the port "
                         "writes the masked image as PNG")
    img = np.asarray(_read_rgb(image), np.float32) / 255.0
    matte = np.asarray(_read_rgb(mask))
    result = apply_mask(img[..., :3], matte, bg)
    pixels = (np.clip(result, 0, 1) * 255).astype(np.uint8)
    write_png(out, pixels)
    return pixels


def main(argv=None):
    p = argparse.ArgumentParser()
    sub = p.add_subparsers(dest="cmd", required=True)
    m = sub.add_parser("mask")
    m.add_argument("image")
    m.add_argument("mask")
    m.add_argument("out")
    m.add_argument("--bg", default="black", choices=["black", "white"])
    args = p.parse_args(argv)
    out = mask_image(args.image, args.mask, args.out, args.bg)
    print(f"wrote {args.out}")
    return out


if __name__ == "__main__":
    main()
