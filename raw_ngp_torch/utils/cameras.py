"""Camera-rig utilities: dodecahedron rigs and random orbit poses
(reference nerf/train_utils.py:46-92, nerf/provider.py:53-87); a numpy copy
of ``raw_ngp_tpu/utils/cameras.py``, whose defaults differ from
:mod:`raw_ngp_torch.data.trajectories`' functions of the same names."""

from __future__ import annotations

import numpy as np


def create_dodecahedron_cameras(radius: float = 2.5,
                                center=np.zeros(3)) -> np.ndarray:
    """20 cameras at dodecahedron vertices, all looking at ``center``
    (train_utils.py:46-92 equivalent built from the golden ratio)."""
    phi = (1 + np.sqrt(5)) / 2
    a, b = 1.0, 1.0 / phi
    verts = []
    for x in (-a, a):
        for y in (-a, a):
            for z in (-a, a):
                verts.append([x, y, z])
    for i, j in [(0, 1), (1, 2), (2, 0)]:
        for s1 in (-1, 1):
            for s2 in (-1, 1):
                v = [0.0, 0.0, 0.0]
                v[i] = s1 * b
                v[j] = s2 * phi
                verts.append(v)
    verts = np.array(verts, np.float64)
    verts = verts / np.linalg.norm(verts, axis=-1, keepdims=True)
    verts = verts * radius + center

    from raw_ngp_torch.data.synthetic import look_at_pose
    poses = np.stack([look_at_pose(v, np.asarray(center, np.float64))
                      for v in verts])
    return poses.astype(np.float32)


def rand_poses(n: int, radius: float = 1.0,
               theta_range=(np.pi / 3, 2 * np.pi / 3),
               phi_range=(0.0, 2 * np.pi), seed: int = 0) -> np.ndarray:
    """Random orbit-camera poses (provider.py:53-87), z-up convention."""
    rng = np.random.default_rng(seed)
    thetas = rng.uniform(*theta_range, n)
    phis = rng.uniform(*phi_range, n)
    centers = np.stack([
        radius * np.sin(thetas) * np.sin(phis),
        radius * np.sin(thetas) * np.cos(phis),
        radius * np.cos(thetas),
    ], axis=-1)
    from raw_ngp_torch.data.synthetic import look_at_pose
    poses = np.stack([look_at_pose(c, np.zeros(3)) for c in centers])
    return poses.astype(np.float32)
