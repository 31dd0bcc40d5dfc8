"""Volume compositing (port of ``raw_ngp_tpu/ops/compositing.py``:
``composite_rays`` ``:28`` on the occupancy path's dense [N, K] samples
(its expand path), ``composite_rays_compacted`` on the compacted sample
stream, ``composite_with_background``, and ``bins_to_weights`` ``:174``
on the proposal path's dense [N, T] bins)."""

from __future__ import annotations

import torch


def composite_rays(sigmas, rgbs, ts, deltas, mask=None,
                   t_thresh: float = 0.0):
    """Alpha-composite masked samples along each ray: sigmas [N, K], rgbs
    [N, K, 3], ts [N, K], deltas [N, K] (or broadcasting to it), mask
    [N, K] bool -> dict of weights [N, K], weights_sum [N], depth [N],
    image [N, 3]. Transmittance from the exclusive cumulative sum of
    sigma * delta along K (a shift, never csum - sdelta: inf - inf would
    NaN), sample i kept while the transmittance entering it is at least
    ``t_thresh``, NaN weights to 0. The sums run in ``torch.cumsum``'s
    order, not JAX's parallel prefix on the CPU: a weight can differ by a
    few f32 ulps of the row's optical depth."""
    sigmas = sigmas.float()
    deltas = deltas.float()
    zero = torch.zeros((), dtype=torch.float32, device=sigmas.device)
    if mask is not None:
        sigmas = torch.where(mask, sigmas, zero)
    sdelta = sigmas * deltas
    alphas = 1.0 - torch.exp(-sdelta)
    csum = torch.cumsum(sdelta, dim=-1)
    excl = torch.cat([torch.zeros_like(csum[..., :1]), csum[..., :-1]],
                     dim=-1)
    trans_before = torch.exp(-excl)
    weights = alphas * trans_before
    if t_thresh > 0.0:
        weights = torch.where(trans_before >= t_thresh, weights, zero)
    weights = torch.nan_to_num(weights, nan=0.0)
    return {"weights": weights,
            "weights_sum": weights.sum(dim=-1),
            "depth": (weights * ts.float()).sum(dim=-1),
            "image": (weights[..., None] * rgbs.float()).sum(dim=-2)}


def _segmented_inclusive_scan(rid, chans, max_len: int):
    """Inclusive prefix sums of 1-D f32 channels within runs of equal
    ``rid`` (a non-decreasing id stream), by the Hillis-Steele shift-mask
    scan of the JAX package: values only ever add within a run, so no
    cross-run cancellation (a global cumsum minus a per-run base would
    lose small runs' precision to large ones). Runs are at most
    ``max_len`` long, so shifts of ``max_len`` or more add nothing and
    are skipped; the additions that remain are the JAX scan's, in its
    order. (The one longer run, the unfilled slots' dummy id, holds
    zeros.)"""
    M = rid.shape[0]
    vs = [c.float() for c in chans]
    s = 1
    while s < min(M, max_len):
        same = rid[s:] == rid[:-s]
        vs = [torch.cat([v[:s], v[s:] + torch.where(same, v[:-s], 0.0)])
              for v in vs]
        s <<= 1
    return vs


def composite_rays_compacted(sigmas, rgbs, ts, deltas, rid, filled, counts,
                             num_rays: int, max_samples: int,
                             t_thresh: float = 0.0):
    """Alpha-composite directly on the compacted ray-major sample stream.

    sigmas [M], rgbs [M, 3], ts [M], deltas [M]: per compacted sample;
    rid [M]: non-decreasing ray id (a dummy id >= num_rays for unfilled
    slots); filled [M]: slot holds a real sample; counts [num_rays]:
    samples per ray in the stream, each at most ``max_samples``.
    Returns dict with weights_sum [N], depth [N], image [N, 3].
    """
    zero = torch.zeros((), dtype=torch.float32, device=sigmas.device)
    sig = torch.where(filled, sigmas.float(), zero)
    dt = torch.where(filled, deltas.float(), zero)
    sdelta = sig * dt
    (incl,) = _segmented_inclusive_scan(rid, [sdelta], max_samples)
    # within-run exclusive prefix: a shift, never `incl - sdelta` (inf - inf)
    prev_same = torch.cat([torch.zeros(1, dtype=torch.bool,
                                       device=rid.device), rid[1:] == rid[:-1]])
    excl = torch.where(prev_same, torch.cat([zero[None], incl[:-1]]), zero)
    trans_before = torch.exp(-excl)
    alphas = 1.0 - torch.exp(-sdelta)
    weights = alphas * trans_before
    if t_thresh > 0.0:
        weights = torch.where(trans_before >= t_thresh, weights, zero)
    weights = torch.nan_to_num(weights, nan=0.0)
    weights = torch.where(filled, weights, zero)

    rgbs = rgbs.float()
    chans = [weights * rgbs[:, 0], weights * rgbs[:, 1],
             weights * rgbs[:, 2], weights * ts.float(), weights]
    prefs = _segmented_inclusive_scan(rid, chans, max_samples)
    # each ray's totals sit at its last sample; empty rays -> 0
    M = rid.shape[0]
    end = torch.clamp(torch.cumsum(counts, 0) - 1, 0, M - 1)
    valid = counts > 0
    outs = [torch.where(valid, p[end], zero) for p in prefs]
    return {
        "image": torch.stack(outs[:3], dim=-1),
        "depth": outs[3],
        "weights_sum": outs[4],
    }


def composite_with_background(image, weights_sum, bg_color):
    """image + (1 - acc) * bg."""
    return image + (1.0 - weights_sum)[..., None] * bg_color


def bins_to_weights(sigmas, real_bins, last_sample_opaque: bool = False):
    """Compositing from bin edges (the proposal path): deltas between
    consecutive edges, transmittance from the exclusive cumulative sum of
    sigma * delta. sigmas [N, T], real_bins [N, T + 1] -> (weights [N, T],
    ts_mid [N, T], deltas [N, T]). With ``last_sample_opaque`` the last
    sample's optical depth is inf (the background is the last sample), so
    its weight is the remaining transmittance. The sums run along the row
    in ``torch.cumsum``'s order, not JAX's (its CPU scan is a parallel
    prefix): each weight can differ by a few f32 ulps of the row's
    optical depth."""
    deltas = real_bins[..., 1:] - real_bins[..., :-1]
    ds = deltas * sigmas
    if last_sample_opaque:
        ds = torch.cat([ds[..., :-1],
                        torch.full_like(ds[..., -1:], float("inf"))], dim=-1)
    alphas = 1.0 - torch.exp(-ds)
    csum = torch.cumsum(ds, dim=-1)
    # the exclusive sum as a shift, never csum - ds (inf - inf)
    excl = torch.cat([torch.zeros_like(csum[..., :1]), csum[..., :-1]],
                     dim=-1)
    # NaN (an inf density times a zero delta) to 0, +inf to the largest f32
    weights = torch.nan_to_num(alphas * torch.exp(-excl), nan=0.0)
    ts_mid = (real_bins[..., 1:] + real_bins[..., :-1]) / 2.0
    return weights, ts_mid, deltas
