"""Ray generation and AABB intersection (port of ``raw_ngp_tpu/ops/rays.py``:
``near_far_from_aabb``, ``sample_pixel_indices``, ``pixel_rays``,
``full_image_rays``)."""

from __future__ import annotations

import torch


def near_far_from_aabb(rays_o, rays_d, aabb, min_near: float = 0.05):
    """Slab test of rays against an axis-aligned box.

    rays_o, rays_d: [..., 3]; aabb: [6] = (xmin, ymin, zmin, xmax, ymax,
    zmax). Returns near, far [..., 1]; both 1e9 when the ray misses.
    """
    tmin = (aabb[:3] - rays_o) / (rays_d + 1e-15)
    tmax = (aabb[3:] - rays_o) / (rays_d + 1e-15)
    near = torch.minimum(tmin, tmax).amax(dim=-1, keepdim=True)
    far = torch.maximum(tmin, tmax).amin(dim=-1, keepdim=True)
    miss = far < near
    near = torch.where(miss, 1e9, near)
    far = torch.where(miss, 1e9, far)
    # maximum, not clamp_min: a tie splits the gradient as jnp.maximum does
    near = torch.maximum(near, near.new_full((), min_near))
    return near, far


def sample_pixel_indices(generator, num_rays: int, H: int, W: int,
                         patch_size: int = 1, device=None):
    """Random flat pixel indices ``row * W + col`` [num_rays], drawn from
    ``generator`` (a torch.Generator on ``device``). With ``patch_size`` p >
    1: num_rays // p^2 square patches, each p x p contiguous pixels in
    row-major order from a corner drawn in [0, H - p) x [0, W - p)."""
    if patch_size > 1:
        n_patch = num_rays // (patch_size ** 2)
        rows = torch.randint(0, H - patch_size, (n_patch,),
                             generator=generator, device=device)
        cols = torch.randint(0, W - patch_size, (n_patch,),
                             generator=generator, device=device)
        off = torch.arange(patch_size, device=device)
        pi, pj = torch.meshgrid(off, off, indexing="ij")
        rows = rows[:, None] + pi.reshape(1, -1)
        cols = cols[:, None] + pj.reshape(1, -1)
        return (rows * W + cols).reshape(-1)
    return torch.randint(0, H * W, (num_rays,), generator=generator,
                         device=device)


def pixel_rays(pose, intrinsics, flat_inds, W: int):
    """Rays through pixel centers for flat indices ``ind = row*W + col``.

    OpenGL-style camera (x right, y up, looking down -z); directions are
    not normalized, so composited ``t`` is metric depth. ``pose`` is a
    [3, 4] or [4, 4] cam2world matrix, or [N, 3|4, 4] one per ray.
    """
    fx, fy, cx, cy = intrinsics[0], intrinsics[1], intrinsics[2], intrinsics[3]
    row = torch.div(flat_inds, W, rounding_mode="floor").float() + 0.5
    col = (flat_inds % W).float() + 0.5
    xs = (col - cx) / fx
    ys = -(row - cy) / fy
    zs = -torch.ones_like(xs)
    directions = torch.stack([xs, ys, zs], dim=-1)     # [N, 3]
    rot = pose[..., :3, :3]
    if pose.ndim == 2:
        rays_d = directions @ rot.T
    else:
        # one pose per ray: the per-ray product as the chain of fused
        # multiply-adds that the reference's batched dot rounds with
        # (r0*d0, then fma(r1, d1, .), then fma(r2, d2, .)); each fma is
        # taken in f64 and rounded to f32
        acc = rot[..., 0] * directions[:, None, 0]
        for k in (1, 2):
            acc = (rot[..., k].double() * directions[:, None, k].double()
                   + acc.double()).float()
        rays_d = acc
    rays_o = pose[..., :3, 3].expand(rays_d.shape)
    return rays_o, rays_d


def full_image_rays(pose, intrinsics, H: int, W: int):
    """Rays for every pixel of an image, row-major [H*W, 3]."""
    inds = torch.arange(H * W, device=pose.device)
    return pixel_rays(pose, intrinsics, inds, W)
