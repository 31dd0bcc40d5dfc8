"""Training losses (port of ``raw_ngp_tpu/train/losses.py``: the loss
weightings ``gaussian_weighting`` ``:16``, ``hanning_weighting`` ``:24``,
``planck_taper_weighting`` ``:35``, ``loss_weight_fn`` ``:44``, the RawNeRF
HDR loss ``rawnerf_loss`` ``:54``, ``ldr_loss`` ``:69``, ``entropy_loss``
``:74`` and ``blend_gt_background`` ``:81``).

JAX's ``stop_gradient`` is ``.detach()`` here. The weightings keep the
reference's quirks, as the JAX package does: gaussian's ``peak_value ** 2``
and batch-wide max, hanning's window over the batch axis.
"""

from __future__ import annotations

import math

import torch


def gaussian_weighting(values, peak_value=1.0, sigma=0.5, max_weight=1.0):
    """exp(-(v - peak**2) / (2 sigma^2)) scaled so the batch's largest
    weight is ``max_weight`` (the peak is squared, not the residual, as in
    the reference); no gradient."""
    w = torch.exp(-(values - peak_value ** 2) / (2 * sigma ** 2))
    return (max_weight * w / w.max()).detach()


def hanning_weighting(values, max_weight=2.0):
    """A Hann window over the *batch* axis [N], divisor N - 1, scaled to
    ``max_weight`` and replicated to 3 channels; no gradient."""
    N = values.shape[0]
    n = torch.arange(N, dtype=torch.float32, device=values.device)
    w = 0.5 - 0.5 * torch.cos(2.0 * math.pi * n / (N - 1))
    w = max_weight * w / w.max()
    return w[:, None].expand(N, 3).detach()


def planck_taper_weighting(values, peak_value=0.5, start_taper=0.95,
                           max_weight=2.0):
    """A raised-cosine taper around ``peak_value``, 0 outside
    ``peak_value ± start_taper``."""
    inside = ((values >= (peak_value - start_taper))
              & (values <= (peak_value + start_taper)))
    w = max_weight * (0.5 + 0.5 * torch.cos(
        (values - peak_value) * (math.pi / (2.0 * start_taper))))
    return torch.where(inside, w, 0.0)


def loss_weight_fn(kind: str, gt_rgb):
    """The per-pixel loss weight of ``train.loss_weight``: "gaussian",
    "planck", "hanning", or 1.0 for anything else ("none")."""
    if kind == "gaussian":
        return gaussian_weighting(gt_rgb)
    if kind == "planck":
        return planck_taper_weighting(gt_rgb)
    if kind == "hanning":
        return hanning_weighting(gt_rgb)
    return 1.0


def rawnerf_loss(pred_rgb, gt_rgb, exposure, lossmult=1.0, loss_weight=1.0):
    """The RawNeRF loss: clipped, tonemap-gradient-weighted MSE.

      clip = min(1, pred * exposure)
      loss = sum(((clip - gt)^2 / (1e-3 + sg(clip))^2) * mult * w) / sum(mult)

    ``lossmult`` (a number or [N, 3], the Bayer mask of mosaiced batches)
    broadcasts to the GT's shape, so a scalar 1.0 divides by 3N."""
    # minimum, not clamp_max: at clip == 1 the gradient splits in half,
    # as jnp.minimum's does
    rgb_clip = torch.minimum(pred_rgb * exposure,
                             torch.ones((), dtype=pred_rgb.dtype,
                                        device=pred_rgb.device))
    resid_sq = (rgb_clip - gt_rgb) ** 2
    scaling = 1.0 / (1e-3 + rgb_clip.detach())
    data = resid_sq * scaling ** 2
    if isinstance(lossmult, torch.Tensor):
        mult = lossmult.float().expand(gt_rgb.shape)
    else:   # a fill on the device, not a host-to-device copy
        mult = torch.full(gt_rgb.shape, float(lossmult),
                          dtype=torch.float32, device=gt_rgb.device)
    return (data * mult * loss_weight).sum() / mult.sum()


def ldr_loss(pred_rgb, gt_rgb):
    """Plain MSE."""
    return ((pred_rgb - gt_rgb) ** 2).mean()


def entropy_loss(weights_sum):
    """Mean binary entropy (bits) of the rays' opacities, clipped to
    [1e-5, 1 - 1e-5] (``torch.minimum`` / ``torch.maximum``: the gradient
    splits at a tie as ``jnp.clip``'s)."""
    w = torch.minimum(torch.maximum(weights_sum, weights_sum.new_full(
        (), 1e-5)), weights_sum.new_full((), 1.0 - 1e-5))
    ent = -w * torch.log2(w) - (1.0 - w) * torch.log2(1.0 - w)
    return ent.mean()


def blend_gt_background(images, bg_color):
    """Alpha-composite 4-channel GT over the background."""
    if images.shape[-1] == 4:
        return (images[..., :3] * images[..., 3:]
                + bg_color * (1.0 - images[..., 3:]))
    return images
