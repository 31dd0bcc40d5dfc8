"""COLMAP sparse model -> instant-ngp transforms.json (copy of the JAX
package's ``tools/colmap2nerf.py`` over the port's COLMAP reader).

Reads cameras.bin / images.bin, converts w2c quaternions to c2w matrices
in the NeRF (OpenGL) convention, recenters, and writes transforms.json.
The video->frames->colmap part of the reference's script depends on
ffmpeg/colmap binaries and is out of scope; run colmap yourself, then
this converter.

Usage:
  python -m raw_ngp_torch.tools.colmap2nerf <scene_root> [--images images]
      [--aabb_scale 16]
"""

from __future__ import annotations

import argparse
import json
import math
import os

import numpy as np

from raw_ngp_torch.data.colmap_io import (qvec_to_rotmat,
                                          read_cameras_binary,
                                          read_images_binary)
from raw_ngp_torch.data.providers import _find_colmap_dir


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("root", type=str)
    p.add_argument("--images", type=str, default="images")
    p.add_argument("--aabb_scale", type=int, default=16)
    p.add_argument("--out", type=str, default=None)
    args = p.parse_args(argv)

    colmap_dir = _find_colmap_dir(args.root)
    cams = read_cameras_binary(os.path.join(colmap_dir, "cameras.bin"))
    ims = read_images_binary(os.path.join(colmap_dir, "images.bin"))

    cam = cams[sorted(cams.keys())[0]]
    if cam.model in ("SIMPLE_PINHOLE", "SIMPLE_RADIAL"):
        fl_x = fl_y = cam.params[0]
        cx, cy = cam.params[1], cam.params[2]
    else:
        fl_x, fl_y, cx, cy = cam.params[:4]

    frames = []
    # COLMAP (OpenCV, y down / z forward) c2w -> NeRF (OpenGL) c2w
    flip = np.diag([1.0, -1.0, -1.0, 1.0])
    for k in sorted(ims.keys()):
        im = ims[k]
        w2c = np.eye(4)
        w2c[:3, :3] = qvec_to_rotmat(im.qvec)
        w2c[:3, 3] = im.tvec
        c2w = np.linalg.inv(w2c) @ flip
        frames.append({
            "file_path": os.path.join(args.images, im.name),
            "transform_matrix": c2w.tolist(),
        })

    # recenter on the mean camera position
    centers = np.array([f["transform_matrix"] for f in frames])[:, :3, 3]
    center = centers.mean(axis=0)
    for f in frames:
        m = np.array(f["transform_matrix"])
        m[:3, 3] -= center
        f["transform_matrix"] = m.tolist()

    out = {
        "camera_angle_x": 2 * math.atan(cam.width / (2 * fl_x)),
        "camera_angle_y": 2 * math.atan(cam.height / (2 * fl_y)),
        "fl_x": fl_x, "fl_y": fl_y, "cx": cx, "cy": cy,
        "w": cam.width, "h": cam.height,
        "aabb_scale": args.aabb_scale,
        "frames": frames,
    }
    out_path = args.out or os.path.join(args.root, "transforms.json")
    with open(out_path, "w") as f:
        json.dump(out, f, indent=2)
    print(f"wrote {out_path} with {len(frames)} frames")
    return out_path


if __name__ == "__main__":
    main()
