"""Dataset providers: COLMAP, NeRF transforms.json, DTU (port of
``raw_ngp_tpu/data/providers.py``: ``load_colmap_scene`` ``:131``,
``load_nerf_scene`` ``:307``, ``load_dtu_scene`` ``:404``, ``load_scene``
``:465``).

Redesign of the reference providers (nerf/colmap_provider.py,
nerf/provider.py, nerf/dtu_provider.py): each loader is a pure function
``load_*_scene(cfg, split) -> SceneData`` that does ALL host-side work once
(COLMAP parse, pose normalization, image decode, metadata extraction); the
per-step ray sampling is the sampler (data/sampler.py), so no
DataLoader/collate machinery exists.

Host numpy, as JAX's, with three departures so that the card's machine
(no cv2) loads PNG scenes: images decode through
:func:`raw_ngp_torch.data.image_io.read_png`, the image-size probes read
the image's header (:func:`raw_ngp_torch.data.image_io.image_size`), and
DTU's projection matrices decompose with ``scipy.linalg.rq`` in place of
``cv2.decomposeProjectionMatrix``. And one repair: the COLMAP loader
takes the images' extension from the folder's sorted listing, skipping
``.json`` sidecars, where JAX takes ``os.listdir``'s first name (the file
system's order, which in a DNG folder can name a sidecar).
"""

from __future__ import annotations

import glob
import json
import os
import random
from typing import List, Optional

import numpy as np

from raw_ngp_torch.config import Config
from raw_ngp_torch.data import image_io
from raw_ngp_torch.data.colmap_io import (
    ColmapImage,
    qvec_to_rotmat,
    read_cameras_binary,
    read_images_binary,
    read_points3d_binary,
)
from raw_ngp_torch.data.pose_utils import (
    auto_scale,
    center_poses,
    nerf_matrix_to_ngp,
    rectify_colmap_convention,
)
from raw_ngp_torch.data.reflectance import load_light_dirs
from raw_ngp_torch.data.scene import SceneData, SceneMeta
from raw_ngp_torch.data.trajectories import (
    circle_poses,
    interp_light_dirs,
    interp_poses,
)

BRACKETING_EXPOSURES = (625, 2500, 10000)   # µs (colmap_provider.py:171)
# light-stage turntable rotations excluded in rfield mode
# (colmap_provider.py:217)
RFIELD_EXCLUDED_ROTATIONS = ("z18", "z54", "z90", "z126", "z162", "z198",
                             "z234", "z270", "z306", "z342")


def _find_colmap_dir(root: str) -> str:
    for cand in ("colmap_sparse/0", "sparse/0", "colmap"):
        p = os.path.join(root, cand)
        if os.path.exists(p):
            return p
    raise FileNotFoundError(
        f"no COLMAP sparse model under {root} "
        "(tried colmap_sparse/0, sparse/0, colmap)")


def _intrinsics_from_camera(cam, downscale: int) -> np.ndarray:
    """fx fy cx cy for the supported models (colmap_provider.py:326-337)."""
    if cam.model in ("SIMPLE_RADIAL", "SIMPLE_PINHOLE"):
        f, cx, cy = cam.params[0], cam.params[1], cam.params[2]
        fx = fy = f
    elif cam.model in ("PINHOLE", "OPENCV"):
        fx, fy, cx, cy = cam.params[:4]
    else:
        raise ValueError(f"unsupported camera model {cam.model}")
    d = downscale
    return np.array([fx / d, fy / d, cx / d, cy / d], np.float32)


def _clone_entry(im: ColmapImage, new_name: str, new_id: int) -> ColmapImage:
    return ColmapImage(new_id, im.qvec, im.tvec, im.camera_id, new_name,
                       im.xys, im.point3d_ids)


def _expand_bracketing(imdata: dict) -> dict:
    """Clone each entry once per exposure with the _e<micros>.exr naming
    (colmap_provider.py:168-205)."""
    out = dict(imdata)
    next_id = max(imdata.keys()) + 1
    for k in sorted(imdata.keys()):
        im = imdata[k]
        stem = im.name.split(".png")[0].split("_e")[0]
        for exp in BRACKETING_EXPOSURES:
            out[next_id] = _clone_entry(im, f"{stem}_e{exp}", next_id)
            next_id += 1
    return out


def _expand_rfield(imdata: dict, valid_leds: List[int], r_mode: str,
                   seed: int = 0) -> dict:
    """Clone/replace entries per LED (colmap_provider.py:208-292)."""
    rng = random.Random(seed)
    out = {}
    next_id = max(imdata.keys()) + 1
    led_idx = 0
    leds = list(valid_leds)
    for k in sorted(imdata.keys()):
        im = imdata[k]
        if any(part.split(".")[0] in RFIELD_EXCLUDED_ROTATIONS
               for part in im.name.split("_")):
            continue
        stem = im.name.split(".png")[0].split(".")[0]
        if r_mode == "replace":
            led = leds[led_idx % len(leds)]
            out[k] = _clone_entry(im, f"{stem}_l{led}.exr", k)
            led_idx += 1
        elif r_mode in ("downsample3", "downsample6", "all"):
            if r_mode == "downsample3":
                picks = [leds[(led_idx + j) % len(leds)] for j in range(8)]
                led_idx += 8
            elif r_mode == "downsample6":
                picks = [leds[(led_idx + j) % len(leds)] for j in range(4)]
                led_idx += 4
            else:
                picks = list(leds)
            rng.shuffle(picks)
            out[k] = im
            for led in picks:
                out[next_id] = _clone_entry(im, f"{stem}_l{led}.exr",
                                            next_id)
                next_id += 1
        else:
            out[k] = im
    return out


def sparse_depth_near_far(point3d_ids, ptskeys: np.ndarray,
                          pts3d: np.ndarray, poses: np.ndarray,
                          default) -> np.ndarray:
    """Each image's [near, far] [n, 2] f32: the least and the greatest depth
    along its camera's axis of the sparse points it observes
    (``point3d_ids[i]``, the ids of its keypoints' points, -1 for none;
    ``ptskeys`` [P] the sorted point ids of ``pts3d`` [P, 3]), or
    ``default`` where it observes none (colmap_provider.py:409-452)."""
    key_to_id = np.full(ptskeys.max() + 2, len(ptskeys), np.int64)
    key_to_id[ptskeys] = np.arange(len(ptskeys))
    nf = []
    for pids, P in zip(point3d_ids, poses):
        mask = pids >= 0
        if not mask.any():
            nf.append(list(default))
            continue
        pts = pts3d[key_to_id[pids[mask]]]
        depth = (P[:3, 3] - pts) @ P[:3, 2]
        nf.append([float(depth.min()), float(depth.max())])
    return np.array(nf, np.float32)


def load_colmap_scene(cfg: Config, split: str = "train",
                      n_test: int = 24,
                      light_calibration: Optional[str] = None) -> SceneData:
    """Full COLMAP pipeline (colmap_provider.py:109-663)."""
    root = cfg.data.path
    colmap_dir = _find_colmap_dir(root)
    d = cfg.data.downscale

    camdata = read_cameras_binary(os.path.join(colmap_dir, "cameras.bin"))
    imdata = read_images_binary(os.path.join(colmap_dir, "images.bin"))
    first_cam = camdata[sorted(camdata.keys())[0]]
    H = int(round(first_cam.height / d))
    W = int(round(first_cam.width / d))

    # light dirs for reflectance-field training
    ldirs_table = None
    valid_leds = None
    if cfg.model.rfield:
        if light_calibration is None:
            light_calibration = os.path.join(root, "led_positions.txt")
        ldirs_table = load_light_dirs(light_calibration)
        # valid LEDs from the capture filenames (main.py:179-188)
        captures = glob.glob(os.path.join(root, "raw", "*.exr"))
        valid_leds = sorted({
            int(p.rsplit(".", 1)[0].split("l")[-1]) for p in captures})

    if cfg.data.bracketing:
        imdata = _expand_bracketing(imdata)
    if cfg.model.rfield and valid_leds:
        imdata = _expand_rfield(imdata, valid_leds, cfg.data.r_mode)

    imkeys = np.array(sorted(imdata.keys()))
    if cfg.data.reduce_set:
        imkeys = imkeys[1::2]                     # colmap_provider.py:296-297

    img_names = [os.path.basename(imdata[k].name).rsplit(".", 1)[0]
                 for k in imkeys]
    if cfg.data.image_mode == "LDR":
        folder = os.path.join(root, f"images_{d}")
        if not os.path.exists(folder):
            folder = os.path.join(root, "images")
    else:
        folder = os.path.join(root, f"raw_{d}")
        if not os.path.exists(folder):
            folder = os.path.join(root, "raw")
    # the extension of the folder's first image in sorted order (JAX takes
    # os.listdir's first name, whose order is the file system's, and can
    # take a DNG's .json sidecar)
    names = sorted(os.listdir(folder))
    ext = next((n for n in names if not n.endswith(".json")),
               names[0]).rsplit(".", 1)[-1]
    img_paths = np.array([os.path.join(folder, n + "." + ext)
                          for n in img_names])
    exist = np.array([os.path.exists(p) for p in img_paths])
    imkeys, img_paths = imkeys[exist], img_paths[exist]

    intrinsics = np.stack([
        _intrinsics_from_camera(camdata[imdata[k].camera_id], d)
        for k in imkeys])

    # w2c -> c2w
    poses = []
    for k in imkeys:
        P = np.eye(4)
        P[:3, :3] = qvec_to_rotmat(imdata[k].qvec)
        P[:3, 3] = imdata[k].tvec
        poses.append(P)
    poses = np.linalg.inv(np.stack(poses))

    ptsdata = read_points3d_binary(os.path.join(colmap_dir, "points3D.bin"))
    ptskeys = np.array(sorted(ptsdata.keys()))
    pts3d = np.array([ptsdata[k].xyz for k in ptskeys])
    ptserr = np.array([ptsdata[k].error for k in ptskeys])

    poses, pts3d = center_poses(poses, pts3d, cfg.data.enable_cam_center)
    scale = auto_scale(poses, cfg.data.scale)
    poses[:, :3, 3] *= scale
    poses, pts3d = rectify_colmap_convention(poses, pts3d)
    pts3d *= scale
    poses_gt = poses.copy()

    pts_aabb = np.concatenate([pts3d.min(0), pts3d.max(0)]).astype(
        np.float32)                                # colmap_provider.py:397

    cam_near_far = None
    if split != "test":
        cam_near_far = sparse_depth_near_far(
            [imdata[k].point3d_ids for k in imkeys], ptskeys, pts3d, poses,
            (cfg.render.min_near, 2.0 * cfg.render.bound))

    meta = SceneMeta()

    if split == "test":
        if cfg.data.camera_traj == "circle":
            radius = np.linalg.norm(poses[:, :3, 3], axis=-1).mean()
            test_poses = circle_poses(radius)
        else:
            test_poses = interp_poses(poses.astype(np.float32),
                                      n_test=n_test)
        intr = intrinsics[0]
        ldirs = None
        if cfg.model.rfield and ldirs_table is not None:
            sweep = interp_light_dirs(ldirs_table[0], ldirs_table[-1], 100)
            test_poses = np.tile(test_poses[:1], (len(sweep), 1, 1))
            ldirs = sweep
        return SceneData(
            images=np.zeros((len(test_poses), H, W, 3), np.float32),
            poses=test_poses.astype(np.float32),
            intrinsics=intr, H=H, W=W, pts_aabb=pts_aabb, ldirs=ldirs,
            meta=meta)

    # train/val/trainval split: every 8th image is val
    # (colmap_provider.py:521-543)
    all_ids = np.arange(len(img_paths))
    val_ids = all_ids[::8]
    train_ids = np.setdiff1d(all_ids, val_ids)
    if split == "train":
        sel = train_ids
    elif split == "val":
        sel = val_ids
    else:                                           # trainval / all
        sel = all_ids
    meta.train_ids, meta.val_ids = train_ids, val_ids

    images = []
    per_image_ldirs = [] if cfg.model.rfield else None
    for p in img_paths[sel]:
        if cfg.data.image_mode == "LDR":
            img = image_io.load_ldr_image(p, H, W)
        else:
            img, cam2rgb = image_io.load_hdr_image(
                p, H, W, clip=cfg.data.clip, mosaiced=cfg.data.mosaiced,
                masked=cfg.data.masked,
                mask_dir=os.path.join(root, "mask"),
                background=cfg.render.background, expose=cfg.data.expose,
                exposure_percentile=cfg.data.exposure_percentile)
            meta.cam2rgb.append(cam2rgb)
        meta.filenames.append(os.path.basename(p))
        meta.shutter_speeds.append(
            image_io.parse_shutter_from_name(p, cfg.data.bracketing))
        if cfg.model.rfield:
            led = image_io.parse_led_from_name(p)
            per_image_ldirs.append(ldirs_table[led])
        images.append(img)
    meta.finalize_exposures()
    if meta.cam2rgb:
        meta.cam2rgb = meta.cam2rgb  # list of [3,3]

    images = np.stack(images).astype(np.float32)
    exposures = None
    if cfg.data.image_mode == "HDR":
        exposures = meta.exposure_values.reshape(-1, 1)

    # SceneData carries one shared intrinsics vector; COLMAP rigs with
    # per-image intrinsics are averaged (the reference keeps [N, 4] but all
    # light-stage/colmap captures share one camera)
    intr = intrinsics[sel].mean(axis=0).astype(np.float32)
    return SceneData(
        images=images, poses=poses[sel].astype(np.float32),
        intrinsics=intr, H=H, W=W,
        exposures=exposures,
        cam_near_far=(cam_near_far[sel]
                      if cfg.data.enable_cam_near_far else None),
        ldirs=(np.stack(per_image_ldirs).astype(np.float32)
               if per_image_ldirs else None),
        pts_aabb=pts_aabb, poses_gt=poses_gt[sel].astype(np.float32),
        meta=meta)


def load_nerf_scene(cfg: Config, split: str = "train",
                    n_test: int = 10) -> SceneData:
    """transforms.json loader (nerf/provider.py:90-331): 'colmap' style
    (one file, every-8th val) or 'blender' style (per-split files)."""
    root = cfg.data.path
    d = cfg.data.downscale
    scale = cfg.data.scale if cfg.data.scale > 0 else 1.0
    offset = cfg.data.offset

    if os.path.exists(os.path.join(root, "transforms.json")):
        mode = "colmap"
        with open(os.path.join(root, "transforms.json")) as f:
            transform = json.load(f)
    elif os.path.exists(os.path.join(root, "transforms_train.json")):
        mode = "blender"
        if split in ("trainval", "all"):
            names = (["train", "val"] if split == "trainval"
                     else ["train", "val", "test"])
            transform = None
            for n in names:
                p = os.path.join(root, f"transforms_{n}.json")
                if not os.path.exists(p):
                    continue
                with open(p) as f:
                    t = json.load(f)
                if transform is None:
                    transform = t
                else:
                    transform["frames"].extend(t["frames"])
        else:
            name = split if split != "val" else "val"
            with open(os.path.join(root, f"transforms_{name}.json")) as f:
                transform = json.load(f)
    else:
        raise FileNotFoundError(f"no transforms*.json under {root}")

    frames = transform["frames"]
    H = int(transform["h"]) // d if "h" in transform else None
    W = int(transform["w"]) // d if "w" in transform else None

    poses, images = [], []
    for fr in frames:
        pose = nerf_matrix_to_ngp(np.array(fr["transform_matrix"],
                                           np.float32), scale, offset)
        fpath = os.path.join(root, fr["file_path"])
        if not os.path.splitext(fpath)[1]:
            fpath += ".png"
        if not os.path.exists(fpath):
            continue
        if H is None:
            h, w = image_io.image_size(fpath)
            H, W = h // d, w // d
        images.append(image_io.load_ldr_image(fpath, H, W))
        poses.append(pose)
    poses = np.stack(poses)
    images = np.stack(images)

    # intrinsics (provider.py handles fl_x / camera_angle_x variants)
    if "fl_x" in transform or "fl_y" in transform:
        fl_x = float(transform.get("fl_x", transform.get("fl_y"))) / d
        fl_y = float(transform.get("fl_y", transform.get("fl_x"))) / d
    elif "camera_angle_x" in transform or "camera_angle_y" in transform:
        if "camera_angle_x" in transform:
            fl_x = W / (2 * np.tan(float(transform["camera_angle_x"]) / 2))
        else:
            fl_x = None
        if "camera_angle_y" in transform:
            fl_y = H / (2 * np.tan(float(transform["camera_angle_y"]) / 2))
        else:
            fl_y = fl_x
        fl_x = fl_x if fl_x is not None else fl_y
    else:
        raise ValueError("transforms.json has no focal length")
    cx = float(transform.get("cx", W / 2)) / (d if "cx" in transform else 1)
    cy = float(transform.get("cy", H / 2)) / (d if "cy" in transform else 1)
    intrinsics = np.array([fl_x, fl_y, cx, cy], np.float32)

    if mode == "colmap" and split in ("train", "val"):
        all_ids = np.arange(len(poses))
        val_ids = all_ids[::8]
        sel = (np.setdiff1d(all_ids, val_ids) if split == "train"
               else val_ids)
        poses, images = poses[sel], images[sel]

    if split == "test" and mode == "colmap":
        test_poses = interp_poses(poses, n_anchors=2, n_test=n_test)
        return SceneData(
            images=np.zeros((len(test_poses), H, W, 3), np.float32),
            poses=test_poses, intrinsics=intrinsics, H=H, W=W,
            pts_aabb=None)

    return SceneData(images=images, poses=poses.astype(np.float32),
                     intrinsics=intrinsics, H=H, W=W,
                     poses_gt=poses.astype(np.float32).copy())


def decompose_projection(P: np.ndarray):
    """A 3 x 4 projection P = K [R | -R C] -> (K, R, C): K upper triangular
    with a positive diagonal, R orthonormal (a rotation when det P[:, :3] >
    0), from the RQ decomposition of P[:, :3]; C the camera centre, P's
    null vector, -P[:, :3]^-1 P[:, 3]. ``cv2.decomposeProjectionMatrix``'s
    K, R and centre for such a P, without cv2."""
    from scipy.linalg import rq
    M = np.asarray(P, np.float64)[:, :3]
    K, R = rq(M)
    signs = np.sign(np.diag(K))
    signs[signs == 0] = 1.0
    K, R = K * signs, signs[:, None] * R
    center = -np.linalg.solve(M, np.asarray(P, np.float64)[:, 3])
    return K, R, center


def load_dtu_scene(cfg: Config, split: str = "train") -> SceneData:
    """DTU loader (nerf/dtu_provider.py:49-168): cameras_sphere.npz with
    world/scale matrices decomposed into K, R, t; mask folder applied."""
    root = cfg.data.path
    d = cfg.data.downscale
    camera_dict = np.load(os.path.join(root, "cameras_sphere.npz"))
    img_paths = sorted(glob.glob(os.path.join(root, "image", "*.png")))
    n = len(img_paths)

    poses, intrinsics_list = [], []
    for i in range(n):
        world_mat = camera_dict[f"world_mat_{i}"]
        scale_mat = camera_dict[f"scale_mat_{i}"]
        P = (world_mat @ scale_mat)[:3, :4]
        K, R, center = decompose_projection(P)
        K = K / K[2, 2]
        pose = np.eye(4)
        pose[:3, :3] = R.T
        pose[:3, 3] = center
        # OpenCV -> OpenGL convention (flip y, z axes)
        pose[:3, 1:3] *= -1
        poses.append(pose)
        intrinsics_list.append(np.array(
            [K[0, 0] / d, K[1, 1] / d, K[0, 2] / d, K[1, 2] / d],
            np.float32))
    poses = np.stack(poses).astype(np.float32)
    intrinsics = intrinsics_list[0]

    h, w = image_io.image_size(img_paths[0])
    H, W = h // d, w // d

    images = []
    mask_paths = sorted(glob.glob(os.path.join(root, "mask", "*.png")))
    for i, p in enumerate(img_paths):
        img = image_io.load_ldr_image(p, H, W)
        if i < len(mask_paths):
            mask = image_io.load_ldr_image(mask_paths[i], H, W)
            img = img[..., :3] * (mask[..., :1] > 0.5)
        images.append(img[..., :3])
    images = np.stack(images).astype(np.float32)

    all_ids = np.arange(n)
    val_ids = all_ids[::8]
    if split == "train":
        sel = np.setdiff1d(all_ids, val_ids)
    elif split == "val":
        sel = val_ids
    elif split == "test":
        test_poses = interp_poses(poses, n_anchors=3)
        return SceneData(
            images=np.zeros((len(test_poses), H, W, 3), np.float32),
            poses=test_poses, intrinsics=intrinsics, H=H, W=W)
    else:
        sel = all_ids
    return SceneData(images=images[sel], poses=poses[sel],
                     intrinsics=intrinsics, H=H, W=W,
                     poses_gt=poses[sel].copy())


def load_scene(cfg: Config, split: str = "train") -> SceneData:
    """Dispatch on cfg.data.data_format (main.py:190-195)."""
    fmt = cfg.data.data_format
    if fmt == "colmap":
        return load_colmap_scene(cfg, split)
    if fmt == "nerf":
        return load_nerf_scene(cfg, split)
    if fmt == "dtu":
        return load_dtu_scene(cfg, split)
    if fmt == "synthetic":
        from raw_ngp_torch.data.synthetic import make_synthetic_scene
        train, val = make_synthetic_scene(
            hdr=cfg.data.image_mode == "HDR")
        return train if split in ("train", "trainval", "all") else val
    raise ValueError(f"unknown data format {fmt!r}")
