"""The proposal-network volume renderer of the ``-O2`` preset (port of
``raw_ngp_tpu/render/proposal.py``: ``spacing_fn`` ``:27``,
``spacing_fn_inv`` ``:32``, ``render_proposal`` ``:37``).

Hierarchical sampling in warped s-space: uniform bins at the first
level, then per level inverse-CDF resampling of the previous level's
weights; the proposal networks give the densities of every level but the
last, the radiance field those of the last, and the last level's weights
composite the image. Every tensor is a dense [N, T] row per ray, so the
path runs no compaction: the hash encode (forward with records where a
gradient is wanted) and B2's flat form under its table gradient are its
kernels.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from raw_ngp_torch.ops.compositing import (bins_to_weights,
                                           composite_with_background)
from raw_ngp_torch.ops.contraction import contract
from raw_ngp_torch.ops.pdf import distortion_loss, proposal_loss, sample_pdf
from raw_ngp_torch.ops.rays import near_far_from_aabb


def spacing_fn(x):
    """Warp distances: linear near, 1/x far."""
    return torch.where(x < 1.0, x / 2.0, 1.0 - 1.0 / (2.0 * x))


def spacing_fn_inv(s):
    """Inverse of :func:`spacing_fn`."""
    return torch.where(s < 0.5, 2.0 * s, 1.0 / (2.0 - 2.0 * s))


def render_proposal(field, rays_o, rays_d, aabb, bg_color=1.0,
                    rays_ldir=None, annealing=1.0, training: bool = False,
                    update_proposal: bool = True, generator=None,
                    plain: bool = False) -> Dict[str, Any]:
    """Render one ray batch rays_o, rays_d [N, 3] inside ``aabb`` [6] with
    ``field`` (an NGPField with proposal networks) at the per-level step
    counts ``cfg.render.num_steps`` -> image [N, 3], depth [N],
    weights_sum [N]; with ``training`` also num_points (an int), the last
    level's weights [N, T], and the proposal loss (when
    ``train.lambda_proposal`` > 0 and ``update_proposal``) and the
    distortion loss (when ``train.lambda_distort`` > 0).

    A ``generator`` jitters the first level's edges and each resampling
    (perturbed sampling); ``None`` is the deterministic path. Rays that
    miss the AABB get a finite dummy segment [1, 2] and zero weights, so
    they composite to ``bg_color`` with finite gradients. With
    ``update_proposal`` False the proposal networks are queried without
    a gradient. ``rays_ldir`` [N, 3] are an rfield field's light
    directions; ``plain`` runs the kernels' plain versions.
    """
    cfg = field.spec.cfg
    N = rays_o.shape[0]
    dev = rays_o.device
    num_steps = cfg.render.num_steps
    nears, fars = near_far_from_aabb(rays_o, rays_d, aabb,
                                     cfg.render.min_near)
    miss = fars >= 1e8
    nears = torch.where(miss, 1.0, nears)
    fars = torch.where(miss, 2.0, fars)
    hit = (~miss).float()
    s_nears, s_fars = spacing_fn(nears), spacing_fn(fars)
    opaque = cfg.render.background == "last_sample"

    all_bins, all_weights = [], []
    weights = rgbs = ts_mid = bins = None
    last = len(num_steps) - 1
    for it, T in enumerate(num_steps):
        if it == 0:
            bins = torch.linspace(0.0, 1.0, T + 1,
                                      device=dev).expand(N, T + 1)
            if generator is not None:
                bins = torch.clamp(
                    bins + (torch.rand(N, T + 1, generator=generator,
                                       device=dev) - 0.5) / T, 0.0, 1.0)
        else:
            bins = sample_pdf(bins, weights, T + 1, generator=generator)
        real_bins = spacing_fn_inv(s_nears * (1.0 - bins) + s_fars * bins)
        ts_mid = (real_bins[..., 1:] + real_bins[..., :-1]) / 2.0
        xyzs = rays_o[:, None, :] + rays_d[:, None, :] * ts_mid[..., None]
        q = (contract(xyzs) if cfg.render.contract else xyzs).reshape(-1, 3)
        if it != last:
            with torch.set_grad_enabled(torch.is_grad_enabled()
                                        and update_proposal):
                sigmas = field.density(q, plain=plain, annealing=annealing,
                                       proposal=it).reshape(N, T)
        else:
            dirs = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
            dirs = dirs[:, None, :].expand(xyzs.shape).reshape(-1, 3)
            ld = None
            if rays_ldir is not None:
                ld = rays_ldir[:, None, :].expand(xyzs.shape).reshape(-1, 3)
            sigmas, rgbs = field(q, dirs, ld, plain=plain,
                                 annealing=annealing)
            sigmas, rgbs = sigmas.reshape(N, T), rgbs.reshape(N, T, 3)
        weights, ts_mid, _ = bins_to_weights(sigmas, real_bins, opaque)
        weights = weights * hit
        if training:
            all_bins.append(bins)
            all_weights.append(weights)

    weights_sum = weights.sum(dim=-1)
    depth = (weights * ts_mid).sum(dim=-1)
    image = (weights[..., None] * rgbs).sum(dim=-2)
    results: Dict[str, Any] = {}
    if training:
        results["num_points"] = N * sum(num_steps)
        results["weights"] = weights
        if cfg.train.lambda_proposal > 0 and update_proposal:
            results["proposal_loss"] = proposal_loss(all_bins, all_weights)
        if cfg.train.lambda_distort > 0:
            results["distort_loss"] = distortion_loss(bins, weights)
    results["image"] = composite_with_background(image, weights_sum,
                                                 bg_color)
    results["weights_sum"] = weights_sum
    results["depth"] = depth
    return results
