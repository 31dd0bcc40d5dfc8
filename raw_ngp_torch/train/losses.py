"""Training losses (port of ``raw_ngp_tpu/train/losses.py``: ``ldr_loss``
``:69`` and ``blend_gt_background`` ``:81``; the HDR losses are not
ported)."""

from __future__ import annotations


def ldr_loss(pred_rgb, gt_rgb):
    """Plain MSE."""
    return ((pred_rgb - gt_rgb) ** 2).mean()


def blend_gt_background(images, bg_color):
    """Alpha-composite 4-channel GT over the background."""
    if images.shape[-1] == 4:
        return (images[..., :3] * images[..., 3:]
                + bg_color * (1.0 - images[..., 3:]))
    return images
