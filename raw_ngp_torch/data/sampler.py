"""Per-step ray-batch sampling (port of ``raw_ngp_tpu/data/sampler.py``:
``bayer_lossmult`` ``:23`` and ``sample_ray_batch`` ``:34``).

Every mode is ported: random pixels of random images
(``random_image_batch``; one random image per batch otherwise), square
patches that share one image each (``patch_size``), and the explicit
``coords`` / ``coord_image_indices`` hook; so are the synthetic pose noise
and the learned se(3) refinements of pose refinement, composed onto each
ray's pose in the differentiated step, and the per-ray outputs: exposures,
light directions, each camera's near/far and the Bayer loss mask of
mosaiced images.
"""

from __future__ import annotations

from typing import Dict

import torch

from raw_ngp_torch.ops.lie import apply_refinement, compose_pose
from raw_ngp_torch.ops.rays import pixel_rays, sample_pixel_indices


def bayer_lossmult(rows, cols):
    """Binary RGB mask [..., 3] f32 of the RGGB Bayer pattern at integer
    pixel coords (row, col): R at (even, even), G at (even, odd) and
    (odd, even), B at (odd, odd)."""
    r = (cols % 2 == 0) & (rows % 2 == 0)
    g = (((cols % 2 == 1) & (rows % 2 == 0))
         | ((cols % 2 == 0) & (rows % 2 == 1)))
    b = (cols % 2 == 1) & (rows % 2 == 1)
    return torch.stack([r, g, b], dim=-1).float()


def sample_ray_batch(generator, images, poses, intrinsics, num_rays: int,
                     random_image_batch: bool = True, se3_refine=None,
                     pose_noise=None, exposures=None, ldirs=None,
                     cam_near_far=None, mosaiced: bool = False,
                     patch_size: int = 1, coords=None,
                     coord_image_indices=None) -> Dict[str, torch.Tensor]:
    """A training ray bundle: rays_o, rays_d [num_rays, 3], the GT pixels
    ``images`` [num_rays, C] and the image ``index`` of each ray; with
    ``exposures`` [n, 1] also ``exposure`` [num_rays, 1], with ``ldirs``
    [n, 3] ``rays_ldir`` [num_rays, 3], with ``cam_near_far`` [n, 2]
    ``cam_near_far`` [num_rays, 2] (each ray's camera's), and when
    ``mosaiced`` the Bayer ``lossmult`` [num_rays, 3] of each ray's pixel.

    images [n, H, W, C], poses [n, 4, 4] and intrinsics [4] are tensors on
    one device; ``generator`` (a torch.Generator there) draws the images
    and pixels. ``coords`` [num_rays, 2] (row, col) selects the pixels,
    from ``coord_image_indices`` [num_rays] or one random image.
    ``pose_noise`` [n, 3, 4] is composed under each ray's pose, then
    ``se3_refine`` [n, 6] on top (camera space, ``apply_refinement``); the
    rays are differentiable in both. With ``patch_size`` p > 1 (and no
    coords) the rays come in num_rays // p^2 patches of p x p contiguous
    pixels, each patch from one random image
    (:func:`raw_ngp_torch.ops.rays.sample_pixel_indices`)."""
    n, H, W, _ = images.shape
    dev = images.device
    patches = patch_size > 1 and coords is None
    if patches:
        img_idx = torch.randint(
            0, n, (num_rays // patch_size ** 2,), generator=generator,
            device=dev).repeat_interleave(patch_size ** 2)
    elif coord_image_indices is not None:
        img_idx = torch.as_tensor(coord_image_indices, device=dev).long()
    elif random_image_batch and coords is None:
        img_idx = torch.randint(0, n, (num_rays,), generator=generator,
                                device=dev)
    else:
        img_idx = torch.randint(0, n, (1,), generator=generator,
                                device=dev).expand(num_rays)
    if coords is not None:
        coords = torch.as_tensor(coords, device=dev).long()
        flat = coords[:, 0] * W + coords[:, 1]
    else:
        flat = sample_pixel_indices(generator, num_rays, H, W, patch_size,
                                    device=dev)
    rows = torch.div(flat, W, rounding_mode="floor")
    cols = flat % W
    sel_poses = poses[img_idx]                              # [N, 4, 4]
    if pose_noise is not None:
        sel_poses = compose_pose(pose_noise[img_idx], sel_poses[:, :3, :4])
    if se3_refine is not None:
        sel_poses = apply_refinement(se3_refine[img_idx], sel_poses)
    rays_o, rays_d = pixel_rays(sel_poses, intrinsics, flat, W)
    out = {"rays_o": rays_o, "rays_d": rays_d,
           "images": images[img_idx, rows, cols], "index": img_idx}
    if exposures is not None:
        out["exposure"] = exposures[img_idx]                # [N, 1]
    if ldirs is not None:
        out["rays_ldir"] = ldirs[img_idx]                   # [N, 3]
    if cam_near_far is not None:
        out["cam_near_far"] = cam_near_far[img_idx]         # [N, 2]
    if mosaiced:
        out["lossmult"] = bayer_lossmult(rows, cols)        # [N, 3]
    return out
