"""COLMAP binary model reader and writer (a numpy copy of
``raw_ngp_tpu/data/colmap_io.py``).

Fresh implementation of the COLMAP sparse-reconstruction binary format
(https://colmap.github.io/format.html), covering what the pipeline needs:
cameras.bin / images.bin / points3D.bin (the reference vendors the ETH/UNC
reader as nerf/colmap_utils.py; this is a from-scratch numpy version).
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np

# camera_model_id -> (name, num_params); colmap/src/base/camera_models.h
CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}


@dataclass
class ColmapCamera:
    camera_id: int
    model: str
    width: int
    height: int
    params: np.ndarray


@dataclass
class ColmapImage:
    image_id: int
    qvec: np.ndarray          # [4] (w, x, y, z)
    tvec: np.ndarray          # [3]
    camera_id: int
    name: str
    xys: np.ndarray           # [n, 2] keypoint pixel coords
    point3d_ids: np.ndarray   # [n] int64, -1 = unmatched


@dataclass
class ColmapPoint3D:
    point_id: int
    xyz: np.ndarray
    rgb: np.ndarray
    error: float


def qvec_to_rotmat(q: np.ndarray) -> np.ndarray:
    """COLMAP (w, x, y, z) quaternion -> rotation matrix."""
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def rotmat_to_qvec(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> COLMAP (w, x, y, z) unit quaternion with w >= 0,
    the inverse of :func:`qvec_to_rotmat` (for the writers; taken from the
    largest of the four squared components, so stable at any angle)."""
    R = np.asarray(R, np.float64)
    t = np.trace(R)
    sq = np.array([1 + t, 1 + 2 * R[0, 0] - t, 1 + 2 * R[1, 1] - t,
                   1 + 2 * R[2, 2] - t])
    i = int(np.argmax(sq))
    q = np.empty(4)
    q[i] = 0.5 * np.sqrt(sq[i])
    f = 0.25 / q[i]
    off = {0: (R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]),
           1: (R[2, 1] - R[1, 2], R[0, 1] + R[1, 0], R[0, 2] + R[2, 0]),
           2: (R[0, 2] - R[2, 0], R[0, 1] + R[1, 0], R[1, 2] + R[2, 1]),
           3: (R[1, 0] - R[0, 1], R[0, 2] + R[2, 0], R[1, 2] + R[2, 1])}[i]
    q[[j for j in range(4) if j != i]] = np.array(off) * f
    return q if q[0] >= 0 else -q


def _read(fmt: str, f) -> tuple:
    size = struct.calcsize(fmt)
    return struct.unpack(fmt, f.read(size))


def read_cameras_binary(path: str) -> Dict[int, ColmapCamera]:
    cams: Dict[int, ColmapCamera] = {}
    with open(path, "rb") as f:
        (n,) = _read("<Q", f)
        for _ in range(n):
            cam_id, model_id, width, height = _read("<iiQQ", f)
            name, n_params = CAMERA_MODELS[model_id]
            params = np.array(_read(f"<{n_params}d", f))
            cams[cam_id] = ColmapCamera(cam_id, name, int(width),
                                        int(height), params)
    return cams


def _read_string(f) -> str:
    out = b""
    while True:
        c = f.read(1)
        if c == b"\x00" or c == b"":
            return out.decode("utf-8")
        out += c


def read_images_binary(path: str) -> Dict[int, ColmapImage]:
    images: Dict[int, ColmapImage] = {}
    with open(path, "rb") as f:
        (n,) = _read("<Q", f)
        for _ in range(n):
            image_id = _read("<i", f)[0]
            qvec = np.array(_read("<4d", f))
            tvec = np.array(_read("<3d", f))
            camera_id = _read("<i", f)[0]
            name = _read_string(f)
            (n_pts,) = _read("<Q", f)
            data = np.frombuffer(f.read(24 * n_pts), dtype=np.float64)
            data = data.reshape(n_pts, 3)
            xys = data[:, :2].copy()
            point3d_ids = data[:, 2].view(np.int64).copy()
            images[image_id] = ColmapImage(image_id, qvec, tvec, camera_id,
                                           name, xys, point3d_ids)
    return images


def read_points3d_binary(path: str) -> Dict[int, ColmapPoint3D]:
    points: Dict[int, ColmapPoint3D] = {}
    with open(path, "rb") as f:
        (n,) = _read("<Q", f)
        for _ in range(n):
            pid = _read("<Q", f)[0]
            xyz = np.array(_read("<3d", f))
            rgb = np.array(_read("<3B", f))
            (error,) = _read("<d", f)
            (track_len,) = _read("<Q", f)
            f.seek(8 * track_len, os.SEEK_CUR)     # skip track elements
            points[pid] = ColmapPoint3D(int(pid), xyz, rgb, float(error))
    return points


# ---------------------------------------------------------------------------
# writers (used by tests and the colmap2nerf tooling)
# ---------------------------------------------------------------------------

def write_cameras_binary(cams: Dict[int, ColmapCamera], path: str):
    name_to_id = {v[0]: k for k, v in CAMERA_MODELS.items()}
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(cams)))
        for cam in cams.values():
            mid = name_to_id[cam.model]
            f.write(struct.pack("<iiQQ", cam.camera_id, mid,
                                cam.width, cam.height))
            f.write(struct.pack(f"<{len(cam.params)}d", *cam.params))


def write_images_binary(images: Dict[int, ColmapImage], path: str):
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(images)))
        for im in images.values():
            f.write(struct.pack("<i", im.image_id))
            f.write(struct.pack("<4d", *im.qvec))
            f.write(struct.pack("<3d", *im.tvec))
            f.write(struct.pack("<i", im.camera_id))
            f.write(im.name.encode("utf-8") + b"\x00")
            n = len(im.xys)
            f.write(struct.pack("<Q", n))
            data = np.empty((n, 3), np.float64)
            data[:, :2] = im.xys
            data[:, 2] = im.point3d_ids.view(np.float64) \
                if im.point3d_ids.dtype == np.int64 \
                else np.asarray(im.point3d_ids, np.int64).view(np.float64)
            f.write(data.tobytes())


def write_points3d_binary(points: Dict[int, ColmapPoint3D], path: str):
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(points)))
        for p in points.values():
            f.write(struct.pack("<Q", p.point_id))
            f.write(struct.pack("<3d", *p.xyz))
            f.write(struct.pack("<3B", *p.rgb.astype(np.uint8)))
            f.write(struct.pack("<d", p.error))
            f.write(struct.pack("<Q", 0))   # empty track
