"""Pose-refinement evaluation (port of ``raw_ngp_tpu/train/pose_analysis.py``):
Procrustes pre-alignment of the refined cameras onto ground truth, then
the mean rotation (degrees) and translation errors; and the offline LLFF
``poses_bounds.npy`` helpers. Everything is numpy except
:func:`refined_poses`, which reads a port Trainer's torch state.
"""

from __future__ import annotations

import os
from typing import Dict, Tuple

import numpy as np
import torch

from raw_ngp_torch.ops.lie import apply_refinement, compose_pose


def prealign_cameras(pred_poses: np.ndarray,
                     gt_poses: np.ndarray) -> np.ndarray:
    """Similarity-align predicted c2w poses onto GT via Procrustes on the
    camera centers."""
    X0 = pred_poses[:, :3, 3]
    X1 = gt_poses[:, :3, 3]
    t0, t1 = X0.mean(0), X1.mean(0)
    X0c, X1c = X0 - t0, X1 - t1
    s0 = np.sqrt((X0c ** 2).sum(-1).mean()) + 1e-12
    s1 = np.sqrt((X1c ** 2).sum(-1).mean()) + 1e-12
    U, _, Vt = np.linalg.svd((X0c / s0).T @ (X1c / s1))
    R = U @ Vt
    if np.linalg.det(R) < 0:
        U[:, -1] *= -1
        R = U @ Vt
    # x1 ~= ((x0 - t0)/s0) @ R * s1 + t1
    aligned = pred_poses.copy()
    aligned[:, :3, 3] = ((X0 - t0) / s0) @ R * s1 + t1
    aligned[:, :3, :3] = np.einsum("ji,njk->nik", R, pred_poses[:, :3, :3])
    return aligned


def rotation_error_deg(R1: np.ndarray, R2: np.ndarray) -> np.ndarray:
    """Per-camera geodesic rotation distance in degrees."""
    Rd = np.einsum("nij,nkj->nik", R1, R2)
    tr = np.trace(Rd, axis1=1, axis2=2)
    cos = np.clip((tr - 1) / 2, -1 + 1e-7, 1 - 1e-7)
    return np.rad2deg(np.arccos(cos))


def evaluate_camera_alignment(pred_poses: np.ndarray,
                              gt_poses: np.ndarray) -> Dict[str, float]:
    """Mean rotation (deg) and translation errors after pre-alignment."""
    aligned = prealign_cameras(pred_poses, gt_poses)
    rot = rotation_error_deg(aligned[:, :3, :3], gt_poses[:, :3, :3])
    trans = np.linalg.norm(aligned[:, :3, 3] - gt_poses[:, :3, 3], axis=-1)
    return {"rotation_deg": float(rot.mean()),
            "translation": float(trans.mean())}


def refined_poses(trainer) -> np.ndarray:
    """Current optimized camera poses [n, 4, 4] of a port Trainer: the
    base poses composed with the injected noise (self-test mode) and the
    learned se(3) refinements."""
    state = trainer.state
    if state.pose_params is None:
        raise ValueError("refined_poses: pose refinement is off")
    with torch.no_grad():
        dev = state.pose_params.device
        base = torch.as_tensor(trainer.train_scene.poses,
                               device=dev)[:, :3, :4]
        if state.pose_noise is not None:
            base = compose_pose(state.pose_noise, base)
        refined = apply_refinement(state.pose_params, base).cpu().numpy()
    refined4 = np.tile(np.eye(4, dtype=np.float32), (len(refined), 1, 1))
    refined4[:, :3, :4] = refined
    return refined4


def analyze_pose_optimization(trainer) -> Dict[str, float]:
    """Refined-vs-GT pose errors of a Trainer with pose refinement."""
    scene = trainer.train_scene
    gt = np.asarray(scene.poses_gt if scene.poses_gt is not None
                    else scene.poses)
    return evaluate_camera_alignment(refined_poses(trainer), gt)


# ---------------------------------------------------------------------------
# Offline half: LLFF poses_bounds.npy ingestion and the raw-camera
# convention. BARF poses are world-to-camera [3, 4] maps (X_cam = R X_w + t);
# compose_pair(a, b) = b o a with R = R_b R_a, t = R_b t_a + t_b; the
# inverse is (R^T, -R^T t).
# ---------------------------------------------------------------------------


def _compose_pair(pose_a: np.ndarray, pose_b: np.ndarray) -> np.ndarray:
    """pose_b o pose_a for [..., 3, 4] rigid maps."""
    R = pose_b[..., :3] @ pose_a[..., :3]
    t = pose_b[..., :3] @ pose_a[..., 3:] + pose_b[..., 3:]
    return np.concatenate([R, t], axis=-1)


def _invert_pose(pose: np.ndarray) -> np.ndarray:
    """(R, t) -> (R^T, -R^T t) for [..., 3, 4]."""
    RT = np.swapaxes(pose[..., :3], -1, -2)
    return np.concatenate([RT, -RT @ pose[..., 3:]], axis=-1)


def center_camera_poses(poses: np.ndarray) -> np.ndarray:
    """Re-express poses relative to their average pose: the average frame
    is built from the mean translation and the normalized means of
    rotation columns 1 and 2 (column 0 completed by the cross product),
    then inverted onto every pose."""
    poses = np.asarray(poses, np.float32)
    center = poses[..., 3].mean(0)
    v1 = poses[..., :3, 1].mean(0)
    v1 = v1 / (np.linalg.norm(v1) + 1e-12)
    v2 = poses[..., :3, 2].mean(0)
    v2 = v2 / (np.linalg.norm(v2) + 1e-12)
    v0 = np.cross(v1, v2)
    pose_avg = np.stack([v0, v1, v2, center], axis=-1)[None]   # [1, 3, 4]
    return _compose_pair(poses, _invert_pose(pose_avg))


def parse_raw_camera(pose_raw: np.ndarray) -> np.ndarray:
    """c2w matrices [N, 4, 4] (or [N, 3, 4]) -> BARF world-to-camera
    [N, 3, 4] in the right/down/forward convention: flip = diag(1, -1, -1)
    composed under the raw pose, then inverted."""
    pose_raw = np.asarray(pose_raw, np.float32)
    if pose_raw.ndim == 2:
        pose_raw = pose_raw[None]
    flip = np.zeros((1, 3, 4), np.float32)
    flip[0, :, :3] = np.diag([1.0, -1.0, -1.0])
    return _invert_pose(_compose_pair(flip, pose_raw[:, :3, :4]))


def parse_cameras_and_bounds(
        path: str, scale: float = 1.0,
) -> Tuple[np.ndarray, np.ndarray, Tuple[float, float, float]]:
    """Parse an LLFF ``poses_bounds.npy``: each row is a flattened [3, 5]
    camera block (pose [3, 4] + the (H, W, focal) column) followed by two
    depth bounds. The LLFF down/right axis pair is rotated into BARF's
    convention (col0, col1 <- col1, -col0), translations and bounds are
    scaled, and the set is re-centered on the average pose.

    Returns (poses [N, 3, 4] centered, bounds [N, 2], (raw_H, raw_W,
    focal))."""
    data = np.load(os.path.join(path, "poses_bounds.npy")).astype(
        np.float32)
    cam_data = data[:, :-2].reshape(-1, 3, 5)                 # [N, 3, 5]
    poses_raw = cam_data[..., :4].copy()                      # [N, 3, 4]
    c0 = poses_raw[..., 0].copy()
    poses_raw[..., 0] = poses_raw[..., 1]
    poses_raw[..., 1] = -c0
    raw_H, raw_W, focal = (float(v) for v in cam_data[0, :, -1])
    bounds = data[:, -2:] * scale                             # [N, 2]
    poses_raw[..., 3] *= scale
    return (center_camera_poses(poses_raw), bounds,
            (raw_H, raw_W, focal))
