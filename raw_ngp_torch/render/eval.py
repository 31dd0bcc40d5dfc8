"""Full-image render at fixed parameters — the port's serving entry point
(counterpart of ``raw_ngp_tpu/train/trainer.py`` ``make_eval_render``
``:419`` and ``Trainer.render_image`` ``:877``), on the occupancy path
(with the density bitfield) or on the proposal path (``render.occupancy``
False: no bitfield, no coarse volume)."""

from __future__ import annotations

import numpy as np
import torch

from raw_ngp_torch.config import Config
from raw_ngp_torch.device import resolve_device
from raw_ngp_torch.ops.rays import full_image_rays
from raw_ngp_torch.render.dispatch import render_any
from raw_ngp_torch.render.occupancy import (_coarse_dilate_radius,
                                            coarse_occupancy)


def scene_aabb(cfg: Config, pts_aabb=None, device="cuda") -> torch.Tensor:
    """The render AABB [6]: the scene's sparse-points box when it has one,
    else the bound box, clamped into the bound box (trainer.py:499-505)."""
    b = cfg.render.bound
    box = (np.asarray(pts_aabb, np.float32)
           if pts_aabb is not None and not cfg.render.contract
           else np.array([-b] * 3 + [b] * 3, np.float32))
    return torch.from_numpy(np.clip(box, -b, b)).to(resolve_device(device))


def coarse_volume(cfg: Config, bitfield) -> torch.Tensor:
    """The dilated coarse occupancy volume of a bitfield: it changes only
    when the bitfield does, so an image computes it once for all chunks."""
    r = cfg.render
    return coarse_occupancy(
        bitfield, r.grid_size, cfg.cascades,
        _coarse_dilate_radius(r.bound, r.grid_size, r.coarse_probes),
        bound=r.bound)


def make_eval_render(cfg: Config, plain: bool = False):
    """Chunk renderer for full-image eval: (field, bitfield, rays_o,
    rays_d, aabb, coarse_lin, annealing, rays_ldir) -> (image [n, 3],
    depth [n], weights_sum [n]); ``rays_ldir`` [n, 3] are an rfield
    field's light directions. On the proposal path the bitfield and
    coarse_lin are not read (pass None) and the sampling is the
    deterministic one. ``plain=True`` runs the kernels' plain versions."""
    bg = 1.0 if cfg.render.background != "black" else 0.0

    def render_chunk(field, bitfield, rays_o, rays_d, aabb, coarse_lin=None,
                     annealing=1.0, rays_ldir=None):
        with torch.inference_mode():
            out = render_any(field, rays_o, rays_d, aabb, bitfield,
                             bg_color=bg, rays_ldir=rays_ldir,
                             annealing=annealing, plain=plain,
                             coarse_lin=coarse_lin)
        return out["image"], out["depth"], out["weights_sum"]

    return render_chunk


def render_image(field, bitfield, pose, intrinsics, H: int, W: int, aabb,
                 device="cuda", plain: bool = False, annealing=1.0,
                 ldir=None):
    """Full-image chunked render -> (rgb [H, W, 3], depth [H, W]) on
    ``device``.

    ``field`` (an NGPField) and ``bitfield`` ([CAS*H^3/8] u8; None on the
    proposal path) must already be on ``device``; ``pose`` is a [4, 4] or
    [3, 4] cam2world and
    ``intrinsics`` (fx, fy, cx, cy). Rays go in chunks of
    ``cfg.render.max_ray_batch``; the last chunk is padded
    to full size with origin 0 / direction 1 rays, as the JAX trainer
    pads it, so every chunk has one shape. ``annealing`` is the BARF /
    BAA-NGP state to render at (the Trainer passes its current one).
    ``ldir`` [3], an rfield field's light direction, is given to every
    ray of every chunk, the padded rays of the last one included.
    """
    dev = resolve_device(device)
    cfg = field.spec.cfg
    pose = torch.as_tensor(pose, dtype=torch.float32, device=dev)
    intr = torch.as_tensor(intrinsics, dtype=torch.float32, device=dev)
    rays_o, rays_d = full_image_rays(pose, intr, H, W)
    N = H * W
    chunk = min(cfg.render.max_ray_batch, N)
    render_chunk = make_eval_render(cfg, plain=plain)
    ld = None
    if ldir is not None:
        ld = torch.as_tensor(ldir, dtype=torch.float32,
                             device=dev).reshape(1, 3).expand(chunk, 3)
    with torch.inference_mode():
        coarse_lin = (coarse_volume(cfg, bitfield) if cfg.render.occupancy
                      else None)
        imgs, depths = [], []
        for s in range(0, N, chunk):
            e = min(s + chunk, N)
            ro, rd = rays_o[s:e], rays_d[s:e]
            if e - s < chunk:
                pad = chunk - (e - s)
                ro = torch.cat([ro, torch.zeros(pad, 3, device=dev)])
                rd = torch.cat([rd, torch.ones(pad, 3, device=dev)])
            img, depth, _ = render_chunk(field, bitfield, ro, rd, aabb,
                                         coarse_lin, annealing, ld)
            imgs.append(img[: e - s])
            depths.append(depth[: e - s])
    return (torch.cat(imgs).reshape(H, W, 3),
            torch.cat(depths).reshape(H, W))
