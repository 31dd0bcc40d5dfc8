"""PDF resampling and the proposal and distortion losses of the proposal
renderer (port of ``raw_ngp_tpu/ops/pdf.py``: ``sample_pdf`` ``:24``,
``interlevel_loss`` ``:60``, ``proposal_loss`` ``:82``,
``distortion_loss`` ``:92``, the O(K) prefix-sum form).

Every function takes fixed-shape [N, T] rows. Where the JAX package
builds a ``jnp.linspace``, the port builds a ``torch.linspace``, which
rounds some entries one ulp apart from JAX's (at most one ulp at the
path's sizes). Cumulative sums run in ``torch.cumsum``'s order, which is
not JAX's, so a CDF can sit an ulp apart from JAX's and a ``searchsorted``
tie can land one index over; the inverse CDF is continuous there, so the
resampled edges move by about an ulp of the CDF times the bin's width.
The gathers of :func:`interlevel_loss` have a fixed-order backward on
every device (:func:`take_rows`).
"""

from __future__ import annotations

import torch

from raw_ngp_torch.device import ordered_index_add


class _TakeRowsFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, src, idx):
        ctx.save_for_backward(idx)
        ctx.n_cols = src.shape[-1]
        return torch.gather(src, -1, idx)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        n, a = idx.shape[0], ctx.n_cols
        flat = (torch.arange(n, device=idx.device)[:, None] * a
                + idx).reshape(-1)
        grad = ordered_index_add(
            torch.zeros(n * a, dtype=g.dtype, device=g.device), flat,
            g.reshape(-1))
        return grad.view(n, a), None


def take_rows(src, idx):
    """``jnp.take_along_axis(src, idx, axis=-1)`` for src [N, A] and int64
    idx [N, V], differentiable in src with a backward that sums the
    cotangents of repeated indices in a fixed order on every device."""
    if torch.is_grad_enabled() and src.requires_grad:
        return _TakeRowsFn.apply(src, idx)
    return torch.gather(src, -1, idx)


def _searchsorted(a, v):
    """Row-wise ``searchsorted(a, v, side="right")``: a [N, A] sorted, v
    [N, V] -> int64 [N, V]."""
    return torch.searchsorted(a.contiguous(), v.contiguous(), right=True)


@torch.no_grad()
def sample_pdf(bins, weights, T: int, generator=None):
    """Inverse-CDF resampling of ``T`` new edges from the edges ``bins``
    [N, T0 + 1] in [0, 1] and their weights [N, T0] -> [N, T], sorted, no
    gradient. With a ``generator`` the uniform samples are jittered by
    U(-0.5, 0.5) / T (perturbed sampling in training); without one the
    sampling is deterministic."""
    N, T0 = weights.shape
    weights = weights + 0.01
    pdf = weights / weights.sum(dim=-1, keepdim=True)
    cdf = torch.clamp_max(torch.cumsum(pdf, dim=-1), 1.0)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)
    u = torch.linspace(0.5 / T, 1.0 - 0.5 / T, T,
                       device=bins.device).expand(N, T)
    if generator is not None:
        u = u + (torch.rand(N, T, generator=generator, device=bins.device)
                 - 0.5) / T
    inds = _searchsorted(cdf, u)
    below = torch.clamp(inds - 1, 0, T0)
    above = torch.clamp(inds, 0, T0)
    cdf_g0 = torch.gather(cdf, -1, below)
    cdf_g1 = torch.gather(cdf, -1, above)
    bins_g0 = torch.gather(bins, -1, below)
    bins_g1 = torch.gather(bins, -1, above)
    t = torch.clamp(torch.nan_to_num((u - cdf_g0) / (cdf_g1 - cdf_g0)),
                    0.0, 1.0)
    return bins_g0 + t * (bins_g1 - bins_g0)


def interlevel_loss(bins_ref, weights_ref, bins, weights):
    """Penalty on a proposal level whose weights under-cover the final
    level's: ``bins_ref`` [N, T + 1] and ``weights_ref`` [N, T] (the final
    level's, no gradient), ``bins`` [N, Tq + 1] and ``weights`` [N, Tq]
    (the proposal level's) -> scalar."""
    bins_ref, weights_ref = bins_ref.detach(), weights_ref.detach()
    Tq = weights.shape[-1]
    cw = torch.cat([torch.zeros_like(weights[..., :1]),
                    torch.cumsum(weights, dim=-1)], dim=-1)
    inds_lo = torch.clamp(
        _searchsorted(bins[..., :-1], bins_ref[..., :-1]) - 1, 0, Tq - 1)
    inds_hi = torch.clamp(
        _searchsorted(bins[..., 1:], bins_ref[..., 1:]), 0, Tq - 1)
    w = (take_rows(cw[..., 1:], inds_hi)
         - take_rows(cw[..., :-1], inds_lo))
    return (torch.clamp_min(weights_ref - w, 0.0) ** 2
            / (weights_ref + 1e-8)).mean()


def proposal_loss(all_bins, all_weights):
    """Sum of the interlevel losses of every proposal level against the
    last (final) level."""
    bins_ref, weights_ref = all_bins[-1], all_weights[-1]
    loss = 0.0
    for b, w in zip(all_bins[:-1], all_weights[:-1]):
        loss = loss + interlevel_loss(bins_ref, weights_ref, b, w)
    return loss


def distortion_loss(bins, weights):
    """mip-NeRF 360's distortion loss in its O(K) prefix-sum form: bins
    [N, T + 1] normalized edges, weights [N, T] -> scalar."""
    intervals = bins[..., 1:] - bins[..., :-1]
    mids = bins[..., :-1] + intervals / 2.0
    # the pairwise term sum_{i>j} 2 w_i w_j (m_i - m_j) by prefix sums
    cw = torch.cumsum(weights, dim=-1)
    cwm = torch.cumsum(weights * mids, dim=-1)
    w_prev = cw - weights
    wm_prev = cwm - weights * mids
    loss_bi = 2.0 * (weights * (mids * w_prev - wm_prev)).sum(dim=-1)
    loss_uni = (weights ** 2 * intervals).sum(dim=-1) / 3.0
    return (loss_bi + loss_uni).mean()
