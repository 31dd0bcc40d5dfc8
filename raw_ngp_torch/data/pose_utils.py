"""Pose normalization shared by the dataset providers
(reference colmap_provider.py:29-65, 366-387); a numpy copy of
``raw_ngp_tpu/data/pose_utils.py``."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def rotmat_between(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Rotation taking unit vector a to b (colmap_provider.py:29-38)."""
    a = a / np.linalg.norm(a)
    b = b / np.linalg.norm(b)
    v = np.cross(a, b)
    c = float(np.dot(a, b))
    if c < -1 + 1e-10:   # opposite directions: perturb and retry
        return rotmat_between(a + np.random.uniform(-1e-2, 1e-2, 3), b)
    s = np.linalg.norm(v)
    k = np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])
    return np.eye(3) + k + k @ k * ((1 - c) / (s ** 2 + 1e-10))


def center_poses(poses: np.ndarray, pts3d: Optional[np.ndarray] = None,
                 enable_cam_center: bool = False):
    """Recenter on the point cloud (or camera centroid) and rotate the mean
    up-vector onto +z (colmap_provider.py:41-65)."""
    if pts3d is None or enable_cam_center:
        center = poses[:, :3, 3].mean(0)
    else:
        center = pts3d.mean(0)
    up = poses[:, :3, 1].mean(0)
    up = up / (np.linalg.norm(up) + 1e-10)
    R = np.pad(rotmat_between(up, np.array([0.0, 0.0, 1.0])), [0, 1])
    R[-1, -1] = 1.0

    poses = poses.copy()
    poses[:, :3, 3] -= center
    poses_centered = R @ poses
    if pts3d is not None:
        return poses_centered, (pts3d - center) @ R[:3, :3].T
    return poses_centered, None


def auto_scale(poses: np.ndarray, scale: float = -1.0) -> float:
    """Normalize mean camera distance to 1 when scale == -1
    (colmap_provider.py:372-376)."""
    if scale == -1.0:
        return float(1.0 / np.linalg.norm(poses[:, :3, 3],
                                          axis=-1).mean())
    return scale


def rectify_colmap_convention(poses: np.ndarray,
                              pts3d: Optional[np.ndarray] = None):
    """COLMAP world -> the OpenGL/NGP convention used by ray generation
    (colmap_provider.py:379-387): swap x/y, flip y/z columns, flip z row."""
    poses = poses[:, [1, 0, 2, 3], :].copy()
    poses[:, :3, 1:3] *= -1
    poses[:, 2] *= -1
    if pts3d is not None:
        pts3d = pts3d[:, [1, 0, 2]].copy()
        pts3d[:, 2] *= -1
    return poses, pts3d


def nerf_matrix_to_ngp(pose: np.ndarray, scale: float = 0.33,
                       offset=(0, 0, 0)) -> np.ndarray:
    """transforms.json pose -> bounded NGP frame
    (reference nerf/provider.py:16-19 convention)."""
    out = pose.astype(np.float32).copy()
    out[:3, 3] = out[:3, 3] * scale + np.asarray(offset, np.float32)
    return out
