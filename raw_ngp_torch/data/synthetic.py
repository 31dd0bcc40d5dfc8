"""Hermetic synthetic scene generator.

The reference has no test fixtures at all (SURVEY.md §4); golden-image
regression needs a scene that can be generated on the fly. This module
ray-traces a tiny analytic scene (diffuse spheres on a ground disc) with
the same camera convention the data providers use, producing a SceneData
that trains in seconds. Also doubles as the benchmark workload so perf
numbers are reproducible without shipping captures.

A numpy copy of the JAX package's ``data/synthetic.py`` (the port
imports nothing of that package): the scene, so both render the same
cameras, and the view x light grid scene ``make_rfield_grid_scene``
(``:191``, with ``_light_spiral`` ``:176``).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np

from raw_ngp_torch.data.scene import SceneData, SceneMeta

# scene definition: centers, radii, albedo
_SPHERES = np.array([
    # cx, cy, cz, r
    [0.0, 0.0, 0.0, 0.6],
    [0.7, 0.5, -0.2, 0.25],
    [-0.6, -0.4, 0.3, 0.3],
], dtype=np.float64)
_ALBEDO = np.array([
    [0.85, 0.25, 0.2],
    [0.2, 0.7, 0.9],
    [0.95, 0.85, 0.3],
], dtype=np.float64)
_LIGHT = np.array([0.35, 0.35, 0.87])   # directional light (unit)


def look_at_pose(eye: np.ndarray, target: np.ndarray,
                 up=np.array([0.0, 0.0, 1.0])) -> np.ndarray:
    """cam2world with OpenGL convention (camera looks down -z, y up) —
    same convention as the providers (provider.py:16-19 poses)."""
    forward = target - eye
    forward = forward / np.linalg.norm(forward)
    right = np.cross(forward, up)
    right = right / (np.linalg.norm(right) + 1e-12)
    new_up = np.cross(right, forward)
    pose = np.eye(4)
    pose[:3, 0] = right
    pose[:3, 1] = new_up
    pose[:3, 2] = -forward
    pose[:3, 3] = eye
    return pose


def _trace(origins, dirs, light=None, textured=False, sphere_scale=1.0):
    """Analytic ray trace of the sphere scene. origins/dirs [N, 3];
    optional per-call light direction (unit, pointing AT the scene).
    ``textured`` modulates each sphere's albedo with a lat/long checker —
    flat-albedo scenes saturate PSNR and under-constrain geometry, so
    quality studies use the textured variant (the bench scene stays
    flat for round-over-round comparability)."""
    N = origins.shape[0]
    best_t = np.full(N, np.inf)
    color = np.zeros((N, 3))
    for s in range(len(_SPHERES)):
        c, r = _SPHERES[s, :3], _SPHERES[s, 3] * sphere_scale
        oc = origins - c
        b = np.sum(oc * dirs, axis=-1)
        cterm = np.sum(oc * oc, axis=-1) - r * r
        disc = b * b - cterm
        hit = disc > 0
        sq = np.sqrt(np.maximum(disc, 0.0))
        t = -b - sq
        valid = hit & (t > 1e-3) & (t < best_t)
        if not np.any(valid):
            continue
        p = origins[valid] + dirs[valid] * t[valid, None]
        n = (p - c) / r
        albedo = np.broadcast_to(_ALBEDO[s], (valid.sum(), 3))
        if textured:
            theta = np.arccos(np.clip(n[:, 2], -1.0, 1.0)) / np.pi
            phi = (np.arctan2(n[:, 1], n[:, 0]) + np.pi) / (2 * np.pi)
            checker = (np.floor(theta * 8) + np.floor(phi * 12)) % 2
            albedo = albedo * (0.45 + 0.55 * checker)[:, None]
        L = _LIGHT if light is None else -np.asarray(light, np.float64)
        lam = np.clip(n @ L, 0.0, 1.0) * 0.85 + 0.15
        color[valid] = albedo * lam[:, None]
        best_t[valid] = t[valid]
    return color, best_t


def make_synthetic_scene(
    n_train: int = 24,
    n_val: int = 4,
    H: int = 64,
    W: int = 64,
    radius: float = 2.2,
    fov_deg: float = 50.0,
    hdr: bool = False,
    rfield: bool = False,
    textured: bool = False,
    sphere_scale: float = 1.0,
    seed: int = 0,
) -> Tuple[SceneData, SceneData]:
    """Generate (train, val) SceneData on a camera ring with two
    elevations. ``hdr=True`` emits linear radiance with per-image exposure
    (exercises the RawNeRF loss path). ``rfield=True`` lights each image
    from a different direction (exercises the reflectance-field path)."""
    rng = np.random.default_rng(seed)
    n_total = n_train + n_val
    fx = fy = 0.5 * W / math.tan(0.5 * math.radians(fov_deg))
    intr = np.array([fx, fy, W / 2.0, H / 2.0], dtype=np.float32)

    poses = []
    for i in range(n_total):
        theta = 2 * np.pi * i / n_total
        elev = 0.35 if i % 2 == 0 else -0.15
        eye = np.array([radius * np.cos(theta) * np.cos(elev),
                        radius * np.sin(theta) * np.cos(elev),
                        radius * np.sin(elev)])
        poses.append(look_at_pose(eye, np.zeros(3)))
    poses = np.stack(poses).astype(np.float32)

    # render GT with the same pixel-center ray convention as ops.rays
    ii, jj = np.meshgrid(np.arange(W), np.arange(H))   # col, row
    xs = (ii.reshape(-1) + 0.5 - intr[2]) / intr[0]
    ys = -(jj.reshape(-1) + 0.5 - intr[3]) / intr[1]
    zs = -np.ones_like(xs)
    cam_dirs = np.stack([xs, ys, zs], axis=-1)          # [H*W, 3]

    images = np.zeros((n_total, H, W, 3), dtype=np.float32)
    exposures = np.ones((n_total, 1), dtype=np.float32)
    ldirs = None
    if rfield:
        phis = rng.uniform(0, 2 * np.pi, n_total)
        thetas = rng.uniform(0.2, 1.2, n_total)
        ldirs = np.stack([np.sin(thetas) * np.cos(phis),
                          np.sin(thetas) * np.sin(phis),
                          np.cos(thetas)], axis=-1).astype(np.float32)
    for i in range(n_total):
        R, t = poses[i, :3, :3], poses[i, :3, 3]
        d = cam_dirs @ R.T
        d = d / np.linalg.norm(d, axis=-1, keepdims=True)
        o = np.broadcast_to(t, d.shape)
        col, _ = _trace(o.astype(np.float64), d.astype(np.float64),
                        light=ldirs[i] if rfield else None,
                        textured=textured, sphere_scale=sphere_scale)
        img = col.reshape(H, W, 3).astype(np.float32)
        if hdr:
            # simulate bracketing: the RECORDED image is scene radiance
            # scaled by the per-image shutter and clipped at the white
            # level, exactly what the RawNeRF loss models
            # (train_utils.py:529-536: min(1, pred * exposure) vs gt)
            exposures[i, 0] = float(rng.choice([0.25, 1.0, 4.0]))
            img = np.minimum(1.0, img * 0.2 * exposures[i, 0])
        images[i] = img

    meta = SceneMeta(filenames=[f"synthetic_{i:03d}" for i in range(n_total)],
                     cam2rgb=np.eye(3, dtype=np.float32))
    aabb = np.array([-1.2, -1.2, -1.2, 1.2, 1.2, 1.2], dtype=np.float32)

    def split(idx):
        return SceneData(
            images=images[idx], poses=poses[idx], intrinsics=intr,
            H=H, W=W,
            exposures=exposures[idx] if hdr else None,
            ldirs=ldirs[idx] if rfield else None,
            pts_aabb=aabb, poses_gt=poses[idx].copy(), meta=meta)

    # interleave the val views among the train views (every k-th frame, the
    # reference's split pattern, colmap_provider.py:521-543) so val poses
    # are within the covered viewing arc
    stride = max(n_total // max(n_val, 1), 1)
    val_idx = np.arange(n_total)[::stride][:n_val]
    train_idx = np.setdiff1d(np.arange(n_total), val_idx)[:n_train]
    return split(train_idx), split(val_idx)


def _light_spiral(n: int, theta_lo=0.2, theta_hi=1.2) -> np.ndarray:
    """n unit light directions on a Fibonacci spiral over the polar band
    [theta_lo, theta_hi] — the synthetic stand-in for a light-stage LED
    dome (reference LED trajectories, colmap_provider.py:459-519)."""
    golden = math.pi * (3.0 - math.sqrt(5.0))
    k = np.arange(n, dtype=np.float64)
    # uniform in cos(theta) over the band for even area coverage
    cz = np.cos(theta_lo) + (np.cos(theta_hi) - np.cos(theta_lo)) \
        * (k + 0.5) / n
    sz = np.sqrt(np.maximum(0.0, 1.0 - cz * cz))
    phi = golden * k
    return np.stack([sz * np.cos(phi), sz * np.sin(phi), cz],
                    axis=-1).astype(np.float32)


def make_rfield_grid_scene(
    n_views: int = 16,
    n_lights: int = 16,
    n_heldout_lights: int = 4,
    n_val_views: int = 2,
    H: int = 128,
    W: int = 128,
    radius: float = 2.2,
    fov_deg: float = 50.0,
    textured: bool = True,
) -> Tuple[SceneData, SceneData]:
    """Dense view x light grid for relighting generalization studies.

    Train: every (view, light) pair over ``n_views`` ring cameras and
    ``n_lights`` spiral LEDs. Val: ``n_val_views`` TRAIN views lit by
    ``n_heldout_lights`` directions NEVER seen at train — held-out PSNR
    then isolates light-direction generalization of the SH(ldir)
    conditioning (network.py:55-56) from view generalization. The
    held-out lights interleave the train spiral (every k-th point of a
    denser spiral), so they interpolate the trained light span rather
    than extrapolate past it — matching the reference light-stage rig,
    where any render-time LED direction lies inside the dome
    (colmap_provider.py:459-519 light-sweep trajectories)."""
    fx = fy = 0.5 * W / math.tan(0.5 * math.radians(fov_deg))
    intr = np.array([fx, fy, W / 2.0, H / 2.0], dtype=np.float32)

    poses = []
    for i in range(n_views):
        theta = 2 * np.pi * i / n_views
        elev = 0.35 if i % 2 == 0 else -0.15
        eye = np.array([radius * np.cos(theta) * np.cos(elev),
                        radius * np.sin(theta) * np.cos(elev),
                        radius * np.sin(elev)])
        poses.append(look_at_pose(eye, np.zeros(3)))
    poses = np.stack(poses).astype(np.float32)

    # one denser spiral; every k-th point is held out for val
    n_all = n_lights + n_heldout_lights
    all_lights = _light_spiral(n_all)
    hold = np.zeros(n_all, bool)
    hold[np.linspace(1, n_all - 2, n_heldout_lights).astype(int)] = True
    train_lights, val_lights = all_lights[~hold], all_lights[hold]

    ii, jj = np.meshgrid(np.arange(W), np.arange(H))
    xs = (ii.reshape(-1) + 0.5 - intr[2]) / intr[0]
    ys = -(jj.reshape(-1) + 0.5 - intr[3]) / intr[1]
    cam_dirs = np.stack([xs, ys, -np.ones_like(xs)], axis=-1)

    def render(view: int, light: np.ndarray) -> np.ndarray:
        R, t = poses[view, :3, :3], poses[view, :3, 3]
        d = cam_dirs @ R.T
        d = d / np.linalg.norm(d, axis=-1, keepdims=True)
        o = np.broadcast_to(t, d.shape)
        col, _ = _trace(o.astype(np.float64), d.astype(np.float64),
                        light=light, textured=textured)
        return col.reshape(H, W, 3).astype(np.float32)

    meta_names, imgs, pvs, lds = [], [], [], []
    for v in range(n_views):
        for li, l in enumerate(train_lights):
            imgs.append(render(v, l))
            pvs.append(poses[v])
            lds.append(l)
            meta_names.append(f"grid_v{v:02d}_l{li:02d}")
    tr_images = np.stack(imgs)
    tr_poses = np.stack(pvs)
    tr_ldirs = np.stack(lds)

    vimgs, vpvs, vlds, vnames = [], [], [], []
    val_views = np.linspace(0, n_views - 1,
                            max(n_val_views, 1)).astype(int)[:n_val_views]
    for v in val_views:
        for li, l in enumerate(val_lights):
            vimgs.append(render(int(v), l))
            vpvs.append(poses[int(v)])
            vlds.append(l)
            vnames.append(f"grid_v{v:02d}_hl{li:02d}")

    aabb = np.array([-1.2, -1.2, -1.2, 1.2, 1.2, 1.2], dtype=np.float32)

    def pack(images, ps, ls, names):
        m = SceneMeta(filenames=names, cam2rgb=np.eye(3, dtype=np.float32))
        ps = np.stack(ps).astype(np.float32)
        return SceneData(images=np.stack(images), poses=ps,
                         intrinsics=intr, H=H, W=W, exposures=None,
                         ldirs=np.stack(ls).astype(np.float32),
                         pts_aabb=aabb, poses_gt=ps.copy(), meta=m)

    return (pack(imgs, pvs, lds, meta_names),
            pack(vimgs, vpvs, vlds, vnames))
