"""Test-time camera trajectories (reference colmap_provider.py:459-519); a
numpy copy of ``raw_ngp_tpu/data/trajectories.py``."""

from __future__ import annotations

import numpy as np


def circle_poses(radius: float, num_frames: int = 100,
                 theta_deg: float = 80.0) -> np.ndarray:
    """360-degree orbit at fixed polar angle, looking at the origin
    (colmap_provider.py:461-488)."""
    theta = np.deg2rad(theta_deg)
    poses = []
    for i in range(num_frames):
        phi = np.deg2rad(i / num_frames * 360.0)
        center = np.array([
            radius * np.sin(theta) * np.sin(phi),
            radius * np.sin(theta) * np.cos(phi),
            radius * np.cos(theta),
        ])

        def normalize(v):
            return v / (np.linalg.norm(v) + 1e-10)

        forward = normalize(center)          # looking inward (-forward)
        up = np.array([0.0, 0.0, 1.0])
        right = normalize(np.cross(forward, up))
        up = normalize(np.cross(right, forward))
        pose = np.eye(4)
        pose[:3, :3] = np.stack((right, up, forward), axis=-1)
        pose[:3, 3] = center
        poses.append(pose)
    return np.stack(poses).astype(np.float32)


def interp_poses(poses: np.ndarray, n_anchors: int = 5, n_test: int = 24,
                 seed: int = 0) -> np.ndarray:
    """Slerp interpolation between randomly chosen training poses
    (colmap_provider.py:489-506)."""
    from scipy.spatial.transform import Rotation, Slerp

    rng = np.random.default_rng(seed)
    fs = rng.choice(len(poses), min(n_anchors, len(poses)), replace=False)
    out = []
    pose0 = poses[fs[0]]
    for k in range(1, len(fs)):
        pose1 = poses[fs[k]]
        rots = Rotation.from_matrix(np.stack([pose0[:3, :3],
                                              pose1[:3, :3]]))
        slerp = Slerp([0, 1], rots)
        for i in range(n_test + 1):
            ratio = np.sin(((i / n_test) - 0.5) * np.pi) * 0.5 + 0.5
            pose = np.eye(4, dtype=np.float32)
            pose[:3, :3] = slerp(ratio).as_matrix()
            pose[:3, 3] = (1 - ratio) * pose0[:3, 3] + ratio * pose1[:3, 3]
            out.append(pose)
        pose0 = pose1
    return np.stack(out).astype(np.float32)


def rand_poses(size: int, radius: float = 1.0,
               theta_range=(np.pi / 3, 2 * np.pi / 3),
               phi_range=(0.0, 2 * np.pi), seed: int = 0) -> np.ndarray:
    """Random orbit-camera poses looking at the origin (reference
    nerf/provider.py:53-87 rand_poses): uniform polar/azimuth draws on a
    fixed-radius sphere, y up, OpenGL c2w with columns
    (right, up, forward). Returns [size, 4, 4] float32."""
    rng = np.random.default_rng(seed)
    thetas = rng.uniform(theta_range[0], theta_range[1], size)
    phis = rng.uniform(phi_range[0], phi_range[1], size)
    centers = np.stack([
        radius * np.sin(thetas) * np.sin(phis),
        radius * np.cos(thetas),
        radius * np.sin(thetas) * np.cos(phis),
    ], axis=-1)                                            # [B, 3]

    def normalize(v):
        return v / (np.linalg.norm(v, axis=-1, keepdims=True) + 1e-10)

    # NOTE: the reference builds forward = -centers with up (0, -1, 0)
    # (provider.py:78-79, with its own "confused at the coordinate
    # system" comment) — under OUR OpenGL pixel_rays convention that
    # faces the cameras AWAY from the origin. We flip to forward =
    # +centers (same lookat as circle_poses / dodecahedron cameras) so
    # -z looks at the origin.
    forward = normalize(centers)
    up = np.broadcast_to(np.array([0.0, 1.0, 0.0]), centers.shape)
    right = normalize(np.cross(up, forward))
    up = normalize(np.cross(forward, right))
    poses = np.broadcast_to(np.eye(4, dtype=np.float32),
                            (size, 4, 4)).copy()
    poses[:, :3, :3] = np.stack((right, up, forward), axis=-1)
    poses[:, :3, 3] = centers
    return poses.astype(np.float32)


# unit dodecahedron vertices (train_utils.py:48-68)
_DODECA_VERTS = np.array([
    [-0.57735, -0.57735, 0.57735], [0.934172, 0.356822, 0.0],
    [0.934172, -0.356822, 0.0], [-0.934172, 0.356822, 0.0],
    [-0.934172, -0.356822, 0.0], [0.0, 0.934172, 0.356822],
    [0.0, 0.934172, -0.356822], [0.356822, 0.0, -0.934172],
    [-0.356822, 0.0, -0.934172], [0.0, -0.934172, -0.356822],
    [0.0, -0.934172, 0.356822], [0.356822, 0.0, 0.934172],
    [-0.356822, 0.0, 0.934172], [0.57735, 0.57735, -0.57735],
    [0.57735, 0.57735, 0.57735], [-0.57735, 0.57735, -0.57735],
    [-0.57735, 0.57735, 0.57735], [0.57735, -0.57735, -0.57735],
    [0.57735, -0.57735, 0.57735], [-0.57735, -0.57735, -0.57735],
], dtype=np.float64)


def create_dodecahedron_cameras(radius: float = 1.0,
                                center=(0.0, 0.0, 0.0)) -> np.ndarray:
    """20 inward-looking probe cameras on dodecahedron vertices
    (reference nerf/train_utils.py:46-92; consumed by the provider's
    mesh-visibility test, colmap_provider.py:570-574). Returns
    [20, 4, 4] float32 c2w poses."""
    center = np.asarray(center, np.float64)
    verts = _DODECA_VERTS / np.linalg.norm(
        _DODECA_VERTS, axis=1, keepdims=True) * radius + center

    def normalize(v):
        return v / (np.linalg.norm(v, axis=-1, keepdims=True) + 1e-8)

    forward = normalize(verts - center)
    up = np.broadcast_to(np.array([0.0, 1.0, 0.0]), forward.shape)
    right = normalize(np.cross(up, forward))
    up = normalize(np.cross(forward, right))
    poses = np.broadcast_to(np.eye(4, dtype=np.float32),
                            (len(verts), 4, 4)).copy()
    poses[:, :3, :3] = np.stack((right, up, forward), axis=-1)
    poses[:, :3, 3] = verts
    return poses.astype(np.float32)


def interp_light_dirs(start: np.ndarray, end: np.ndarray,
                      num: int = 100) -> np.ndarray:
    """Linear light-direction sweep for relighting videos
    (colmap_provider.py:511-517)."""
    t = np.linspace(0, 1, num)[:, None]
    return ((1 - t) * start[None] + t * end[None]).astype(np.float32)
