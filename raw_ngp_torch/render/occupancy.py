"""Occupancy-grid volume render, for eval and for training (port of
``raw_ngp_tpu/render/occupancy.py``).

The JAX design is kept: static shapes end to end. The march places S
candidates a ray (uniformly or on the geometric ``dt_gamma`` schedule
over [near, far], optionally tightened to the occupied coarse-probe
intervals, or by inverting each ray's CDF of probe weights), tests them
against the Morton bitfield (contracted under ``render.contract``) and,
when S > K, packs the first K live ones of each ray into K slots. The
live samples are budget-decimated and compacted across rays into
``m_pad`` slots in one fold (``decimate_compact``,
``raw_ngp_torch/kernels/compact.py``), run through the field (whose
encode is the hash kernel) and composited on the compacted stream; the
expand path (normals) scatters the slots back to the [N, K] grid by the
fold's ``pos`` for the dense composite, and ``compact_ratio <= 0`` runs
the field on all N K samples. No step reads a device value back to the
host or copies one to the device (its constants are filled there), so a
train step captured in a CUDA graph replays as it ran. Every branch of the JAX render is ported. In training with
``lambda_orientation > 0`` the render also takes the expand path and
returns the Ref-NeRF orientation loss (:func:`orientation_loss`) at all
N K march positions, whose inner gradient is the field's
:meth:`~raw_ngp_torch.models.ngp.NGPField.density_grad`.

In training the gradient reaches the field's parameters through the field
and the composite, and, under pose refinement, the rays: through the
compacted t and dt (near/far and the march spacing depend on the rays;
the fold's backward is B1's), the ray-row gather (:func:`gather_ray_rows`)
and the positions' encode input gradient. Clips that a gradient crosses
use ``torch.minimum``/``torch.maximum``, which split the gradient at a tie
as ``jnp.clip`` does.
"""

from __future__ import annotations

import functools
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from raw_ngp_torch.device import ordered_index_add
from raw_ngp_torch.kernels.compact import decimate_compact
from raw_ngp_torch.ops.compositing import (composite_rays,
                                           composite_rays_compacted,
                                           composite_with_background)
from raw_ngp_torch.ops.contraction import contract
from raw_ngp_torch.ops.morton import morton3d
from raw_ngp_torch.ops.rays import near_far_from_aabb


def _floor_log2_p1(x):
    """floor(log2(x)) + 1 for positive finite f32, read from the exponent
    field of the bits (int32)."""
    bits = torch.clamp_min(x, 1e-12).float().view(torch.int32)
    return (bits >> 23) - 126


def _pow2(level):
    """2^level (f32) built in the exponent field of a small int level."""
    return ((level + 127) << 23).to(torch.int32).view(torch.float32)


def _mip_level(pos, dt, grid_size: int, cascades: int):
    """max(mip_from_pos, mip_from_dt) clamped to [0, cascades-1]
    (raymarching.cu:42-54)."""
    lp = _floor_log2_p1(pos.abs().amax(dim=-1))
    ld = _floor_log2_p1(dt * grid_size * 0.5)
    level = torch.clamp_min(torch.maximum(lp, ld), 0)
    return torch.clamp_max(level, cascades - 1)


def _bitfield_words(bitfield):
    """u8 bitfield -> its little-endian 32-bit words (int32 view; bit
    (i & 31) of word i >> 5 is bit (i & 7) of byte i >> 3)."""
    return bitfield.contiguous().view(torch.int32)


def _contract_inf(pos, mag):
    """The march's in-kernel MeRF contraction of clipped positions [..., 3]
    with their L-inf norms mag [..., 1]: every axis scaled by (2 - 1/m)/m
    outside the unit cube (raymarching.cu:421-429; not
    ``ops.contraction.contract``, whose other axes scale by 1/m)."""
    safe = torch.clamp_min(mag, 1e-12)
    scale = (2.0 - 1.0 / safe) / safe
    return torch.where(mag > 1.0, pos * scale, pos)


def occupancy_lookup(bitfield, pos, dt, bound: float, grid_size: int,
                     cascades: int, contract: bool = False):
    """Bitfield test of world positions [..., 3] with step sizes dt [...]
    at their mip level (raymarching.cu:406-442). With ``contract`` the
    cell is looked up at the contracted position and every point outside
    the unit cube counts as occupied (raymarching.cu:442)."""
    pos = torch.clamp(pos, -bound, bound)
    mag = pos.abs().amax(dim=-1, keepdim=True)
    cpos = _contract_inf(pos, mag) if contract else pos
    level = _mip_level(pos, dt, grid_size, cascades)
    mip_bound = torch.clamp_max(_pow2(level), bound)
    mip_rbound = 1.0 / mip_bound
    n = torch.clamp(0.5 * (cpos * mip_rbound[..., None] + 1.0) * grid_size,
                    0.0, grid_size - 1).to(torch.int32)
    index = level.to(torch.int64) * grid_size ** 3 + morton3d(n)
    word = _bitfield_words(bitfield)[index >> 5]
    # arithmetic >> on a negative int32 still leaves bit s at position 0
    occ = ((word >> (index & 31).to(torch.int32)) & 1).bool()
    if contract:
        occ = occ | (mag[..., 0] > 1.0)
    return occ


@functools.lru_cache(maxsize=8)
def _morton_of_linear(hc: int):
    """[Hc^3] Morton code of each x-major linear cell (host numpy)."""
    x, y, z = np.meshgrid(np.arange(hc), np.arange(hc), np.arange(hc),
                          indexing="ij")

    def spread(v):
        v = v.astype(np.uint32)
        v = (v | (v << 16)) & np.uint32(0x030000FF)
        v = (v | (v << 8)) & np.uint32(0x0300F00F)
        v = (v | (v << 4)) & np.uint32(0x030C30C3)
        v = (v | (v << 2)) & np.uint32(0x09249249)
        return v

    code = spread(x) | (spread(y) << 1) | (spread(z) << 2)
    return code.reshape(-1).astype(np.int64)


@functools.lru_cache(maxsize=64)
def _axis_overlap(hc: int, mb_tgt: float, mb_src: float):
    """[hc, hc] 0/1 matrix: target-cascade axis cell a overlaps source
    cell b (boundary touches count; out-of-extent source cells clamp to
    the edge cell)."""
    a = np.arange(hc + 1, dtype=np.float64)
    t = (a / hc * 2.0 - 1.0) * mb_tgt
    s = (a / hc * 2.0 - 1.0) * mb_src
    ov = (t[:-1, None] <= s[None, 1:]) & (s[None, :-1] <= t[1:, None])
    ov[0] |= s[1:] <= t[0]
    ov[-1] |= s[:-1] >= t[-1]
    return ov.astype(np.float32)


def coarse_occupancy(bitfield, grid_size: int, cascades: int,
                     dilate_radius: int, bound: float = 0.0):
    """4^3 max-pool + cross-cascade union + dilation of the Morton
    bitfield into linear-order coarse volumes [CAS * Hc^3] int32
    (Hc = H/4). Coarse cell c covers the 64 fine codes [64c, 64c+64), i.e.
    u32 words 2c and 2c+1."""
    if cascades > 1 and bound <= 0.0:
        raise ValueError("coarse_occupancy needs bound > 0 when "
                         "cascades > 1 (cross-cascade union fold)")
    hc = grid_size // 4
    dev = bitfield.device
    words = _bitfield_words(bitfield).reshape(cascades, hc ** 3, 2)
    occ_m = (words[..., 0] | words[..., 1]) != 0            # Morton order
    lin = torch.from_numpy(_morton_of_linear(hc)).to(dev)
    vol = occ_m[:, lin].reshape(cascades, hc, hc, hc).float()
    if bound > 0.0 and cascades > 1:
        mbs = [float(min(2.0 ** l, bound)) for l in range(cascades)]
        folded = []
        for tgt in range(cascades):
            u = vol[tgt]
            for src in range(cascades):
                if src == tgt:
                    continue
                ov = torch.from_numpy(
                    _axis_overlap(hc, mbs[tgt], mbs[src])).to(dev)
                r = vol[src]
                r = torch.einsum("xa,ayz->xyz", ov, r)
                r = torch.einsum("yb,xbz->xyz", ov, r)
                r = torch.einsum("zc,xyc->xyz", ov, r)
                u = u + r
            folded.append(u)
        vol = torch.stack(folded)
    k = 2 * dilate_radius + 1
    vol = F.max_pool3d(vol[:, None], k, stride=1, padding=dilate_radius)
    return (vol > 0).reshape(-1).to(torch.int32)


def _coarse_dilate_radius(bound: float, grid_size: int,
                          n_probes: int) -> int:
    """Worst-case probe half-spacing over the cascade-0 coarse cell."""
    hc = grid_size // 4
    max_span = 2.0 * np.sqrt(3.0) * bound
    cell0 = 2.0 * min(1.0, bound) / hc
    return max(1, int(np.ceil(max_span / n_probes / (2.0 * cell0))))


def _log_edges(nears, fars, n_probes: int):
    """(base, logg) [N, 1] of the log probe grid's edges base * exp(logg *
    i), i = 0..P: geometric from max(near, 1e-4 far) to far."""
    base = torch.maximum(nears, 1e-4 * fars)
    return base, torch.log(torch.clamp_min(fars / base, 1.0 + 1e-6)) / n_probes


def _probe_grid(nears, fars, n_probes: int, log_spacing: bool = False):
    """Probe intervals over [near, far]: centers t [N, P], widths (spacing
    [N, 1] uniform, [N, P] log) and (base, logg) [N, 1], the continuous
    edge map e(x) = base * exp(logg * x) of the log grid (logg = 0 on the
    uniform one). Log: geometric edges near * g^i, g = (far/near)^(1/P),
    centers at the geometric means."""
    steps = torch.arange(n_probes, dtype=torch.float32,
                         device=nears.device)[None, :] + 0.5
    if log_spacing:
        base, logg = _log_edges(nears, fars, n_probes)
        t = base * torch.exp(logg * steps)
        spacing = t * (torch.exp(0.5 * logg) - torch.exp(-0.5 * logg))
        return t, spacing, base, logg
    spacing = (fars - nears) / n_probes
    return nears + spacing * steps, spacing, nears, torch.zeros_like(nears)


def _probe_occupancy(rays_o, rays_d, coarse_lin, nears, fars, bound: float,
                     grid_size: int, cascades: int, n_probes: int,
                     contract: bool = False, log_spacing: bool = False):
    """Per-ray probe-interval occupancy against the dilated, union-folded
    coarse grid: one gather per probe at the cascade that contains its
    (contracted) position. Returns (occ [N, P] bool, t [N, P], spacing
    [N, 1] or [N, P])."""
    hc = grid_size // 4
    t, spacing, _, _ = _probe_grid(nears, fars, n_probes, log_spacing)
    pos = rays_o[:, None, :] + rays_d[:, None, :] * t[..., None]
    pos = torch.clamp(pos, -bound, bound)
    if contract:
        pos = _contract_inf(pos, pos.abs().amax(dim=-1, keepdim=True))
    lvl = torch.clamp(_floor_log2_p1(pos.abs().amax(dim=-1)), 0,
                      cascades - 1)
    mb = torch.clamp_max(_pow2(lvl), bound)[..., None]
    n = torch.clamp(0.5 * (pos / mb + 1.0) * hc, 0.0,
                    hc - 1).to(torch.int64)
    idx = (lvl.to(torch.int64) * hc ** 3
           + (n[..., 0] * hc + n[..., 1]) * hc + n[..., 2])
    occ = coarse_lin[idx] > 0
    return occ & (t < fars), t, spacing


def coarse_spans(rays_o, rays_d, coarse_lin, nears, fars, bound: float,
                 grid_size: int, cascades: int, n_probes: int,
                 contract: bool = False, log_spacing: bool = False):
    """[near, far] tightened to the occupied probe intervals, one interval
    of margin each side (the static-shape analogue of DDA skipping,
    raymarching.cu:446-460). Rays with no hit collapse to [far, far]."""
    occ, t, spacing = _probe_occupancy(
        rays_o, rays_d, coarse_lin, nears, fars, bound, grid_size,
        cascades, n_probes, contract, log_spacing)
    inf = float("inf")
    tin = torch.where(occ, t - spacing, inf).amin(dim=1, keepdim=True)
    tout = torch.where(occ, t + spacing, -inf).amax(dim=1, keepdim=True)
    empty = tin > tout
    near2 = torch.where(empty, fars, torch.maximum(nears, tin))
    far2 = torch.where(empty, fars, torch.minimum(fars, tout))
    return near2, far2


def cdf_candidates(rays_o, rays_d, coarse_lin, nears, fars, bound: float,
                   grid_size: int, cascades: int, n_probes: int,
                   num_candidates: int, jitter, contract: bool = False,
                   dt_gamma: float = 0.0, max_steps: int = 1024,
                   log_spacing: bool = False, floor: float = 0.0):
    """Candidate times over the OCCUPIED probe intervals only, by inverting
    each ray's CDF of probe weights. Uniform probes without dt_gamma or
    floor: the integer CDF of hits, dt [N, 1]. Otherwise each probe weighs
    spacing / clamp(t * dt_gamma, dt_min, dt_max) (1 without dt_gamma;
    dt_min = 2 sqrt(3) / max_steps, dt_max = 2 sqrt(3) 2^(cascades-1) /
    grid_size, raymarching.cu:396-397), times ``floor`` where unoccupied,
    and each candidate's dt [N, S] is its probe's dt_ref * w / S (0 on an
    empty ray). Returns (t_cand [N, S], dt)."""
    occ, t_probe, spacing = _probe_occupancy(
        rays_o, rays_d, coarse_lin, nears, fars, bound, grid_size, cascades,
        n_probes, contract, log_spacing)
    S = num_candidates
    steps = torch.arange(S, dtype=torch.float32, device=nears.device)[None]
    if dt_gamma <= 0.0 and not log_spacing and floor <= 0.0:
        Wt = torch.cumsum(occ.to(torch.int32), dim=1, dtype=torch.int32)
        w = Wt[:, -1:].float()                              # [N, 1]
        u = (steps + jitter) * (w / S)                      # [N, S]
        j_occ = torch.floor(u)
        j32 = j_occ.to(torch.int32)
        # probe index of the (j_occ+1)-th occupied interval: count probes
        # whose cumulative hit count has not passed j_occ
        p_idx = torch.zeros(u.shape, dtype=torch.int32, device=u.device)
        for p in range(n_probes):
            p_idx = p_idx + (Wt[:, p:p + 1] <= j32).to(torch.int32)
        frac = u - j_occ
        t_cand = nears + (p_idx.float() + frac) * spacing
        return t_cand, spacing * w / S

    sp_full = spacing.expand_as(t_probe)
    if dt_gamma > 0.0:
        sqrt3 = 1.7320508075688772
        dt_min = 2.0 * sqrt3 / max_steps
        dt_max = 2.0 * sqrt3 * (2.0 ** (cascades - 1)) / grid_size
        dt_ref = torch.clamp(t_probe * dt_gamma, dt_min, dt_max)
    else:
        # uniform in t over occupied space, as the integer branch
        dt_ref = torch.ones_like(t_probe)
    wv = sp_full / dt_ref * torch.where(occ, 1.0, floor)     # steps needed
    Wt = torch.cumsum(wv, dim=1)
    w = Wt[:, -1:]                                          # [N, 1]
    u = (steps + jitter) * (w / S)
    zero = torch.zeros((), dtype=torch.float32, device=u.device)
    p_idx = torch.zeros(u.shape, dtype=torch.int32, device=u.device)
    cw_before = torch.zeros_like(u)                         # weight < probe
    w_at = torch.zeros_like(u)                              # containing w
    sp_at = torch.zeros_like(u)                             # containing len
    for p in range(n_probes):
        wt_p, wv_p = Wt[:, p:p + 1], wv[:, p:p + 1]
        before = wt_p <= u
        contains = (wt_p > u) & (wt_p - wv_p <= u)
        p_idx = p_idx + before.to(torch.int32)
        cw_before = cw_before + torch.where(before, wv_p, zero)
        w_at = w_at + torch.where(contains, wv_p, zero)
        sp_at = sp_at + torch.where(contains, sp_full[:, p:p + 1], zero)
    frac = torch.clamp((u - cw_before) / torch.clamp_min(w_at, 1e-12), 0.0,
                       1.0 - 1e-6)
    if log_spacing:
        # linear placement within the probe: t = e_p + frac (e_p+1 - e_p)
        base, logg = _log_edges(nears, fars, n_probes)
        e_p = base * torch.exp(logg * p_idx.float())
        t_cand = e_p * (1.0 + frac * torch.expm1(logg))
    else:
        t_cand = nears + (p_idx.float() + frac) * spacing
    dt = torch.where(w_at > 0.0,
                     sp_at * w / (S * torch.clamp_min(w_at, 1e-12)), zero)
    return t_cand, dt


def march_rays(rays_o, rays_d, bitfield, nears, fars, bound: float,
               grid_size: int, cascades: int, num_candidates: int,
               samples_per_ray: int, coarse_probes: int = 0, coarse_lin=None,
               jitter=0.5, *, contract: bool = False, dt_gamma: float = 0.0,
               march_cdf: bool = False, max_steps: int = 1024,
               probe_log: bool = False, cdf_floor: float = 0.0):
    """Candidate -> occupancy mask march (``march_rays``, ``:459-573``),
    every branch: S candidates by the CDF over coarse probes
    (``march_cdf`` and ``coarse_probes`` > 0), or spread over [near, far]
    (tightened by the probes when there are any), uniformly or on the
    geometric ``dt_gamma`` schedule (normalized so that candidate S - 1
    still lands at far); tested against the bitfield (contracted with
    ``contract``); then the first K live candidates of each ray packed
    into K slots when S > K. ``jitter`` is 0.5 (the deterministic
    ``key=None`` path) or a [N, 1] tensor of uniforms. Returns dict with
    ts [N, K] (-1 where dead), deltas [N, K] and mask [N, K]."""
    N = rays_o.shape[0]
    S, K = num_candidates, samples_per_ray
    use_cdf = march_cdf and coarse_probes > 0
    if coarse_probes > 0:
        if coarse_lin is None:
            coarse_lin = coarse_occupancy(
                bitfield, grid_size, cascades,
                _coarse_dilate_radius(bound, grid_size, coarse_probes),
                bound=bound)
        if use_cdf:
            t_cand, dt = cdf_candidates(
                rays_o, rays_d, coarse_lin, nears, fars, bound, grid_size,
                cascades, coarse_probes, S, jitter, contract=contract,
                dt_gamma=dt_gamma, max_steps=max_steps,
                log_spacing=probe_log, floor=cdf_floor)
        else:
            nears, fars = coarse_spans(
                rays_o, rays_d, coarse_lin, nears, fars, bound, grid_size,
                cascades, coarse_probes, contract, probe_log)
    if not use_cdf:
        span = fars - nears
        steps = torch.arange(S, dtype=torch.float32,
                             device=nears.device)[None]
        if dt_gamma > 0.0:
            # t_i ~ near * (1 + dt_gamma)^i (raymarching.cu:396-401, 412)
            # 1 + dt_gamma in f32, filled on the device (no host copy)
            g1 = nears.new_full((), float(np.float32(1.0)
                                          + np.float32(dt_gamma)))
            denom = torch.pow(g1, float(S)) - 1.0
            t_cand = nears + span * ((torch.pow(g1, steps + jitter) - 1.0)
                                     / denom)
            t_next = nears + span * (
                (torch.pow(g1, steps + jitter + 1.0) - 1.0) / denom)
            dt = t_next - t_cand                            # [N, S]
        else:
            dt = span / S                                   # [N, 1]
            t_cand = nears + (steps + jitter) * dt
    pos = rays_o[:, None, :] + rays_d[:, None, :] * t_cand[..., None]
    occ = occupancy_lookup(bitfield, pos, dt.expand(N, S), bound, grid_size,
                           cascades, contract)
    occ = occ & (t_cand < fars)
    zero = torch.zeros((), dtype=torch.float32, device=occ.device)
    if S == K:
        # candidates ARE the sample slots: dead candidates just mask out
        ts = torch.where(occ, t_cand, -1.0)
        deltas = (torch.where(occ, dt.expand(N, S), zero) if dt_gamma > 0.0
                  else dt.expand(N, K))
        return {"ts": ts, "deltas": deltas, "mask": occ}
    # S > K: candidate s of ray r, the j-th live one, goes to slot j while
    # j < K. JAX scatters into [N, K + 1] with K a dump slot that several
    # candidates share; here every candidate has a target of its own (the
    # kept ones r * K + j, the others one each past N * K, cut off), so the
    # writes never collide and the backward is a plain gather
    slot = torch.cumsum(occ.to(torch.int32), dim=1, dtype=torch.int32) - 1
    keep = occ & (slot < K)
    rows = torch.arange(N, device=occ.device)[:, None]
    dest = torch.where(keep, rows * K + slot,
                       N * K + rows * S + torch.arange(S, device=occ.device))
    dest = (dest.reshape(-1),)
    ts = torch.full((N * (K + S),), -1.0, device=occ.device).index_put(
        dest, torch.where(keep, t_cand, -1.0).reshape(-1))[:N * K]
    ts = ts.reshape(N, K)
    if dt_gamma > 0.0:
        deltas = torch.zeros(N * (K + S), device=occ.device).index_put(
            dest, dt.reshape(-1))[:N * K].reshape(N, K)
    else:
        deltas = dt.expand(N, K)
    return {"ts": ts, "deltas": deltas, "mask": ts >= 0.0}


def _truncate_bf16(x):
    """f32 -> f32 keeping the top 16 bits (bf16 by truncation, as
    ``hash_fused._pack_bf16_pairs`` packs)."""
    return (x.contiguous().view(torch.int32) & -65536).view(torch.float32)


class _GatherRowsFn(torch.autograd.Function):
    """``buf[rid]`` with the JAX package's backward."""

    @staticmethod
    def forward(ctx, buf, rid):
        ctx.save_for_backward(rid)
        ctx.n_rows = buf.shape[0]
        return buf[rid.to(torch.int64)]

    @staticmethod
    def backward(ctx, g):
        (rid,) = ctx.saved_tensors
        totals = ordered_index_add(
            torch.zeros(ctx.n_rows, g.shape[1], dtype=torch.float32,
                        device=g.device), rid.to(torch.int64), g.float())
        return _truncate_bf16(totals).to(g.dtype), None


def gather_ray_rows(buf, rid):
    """``buf[rid]`` for a per-ray attribute buffer [N + 1, D] (last row a
    dummy) indexed by an ascending ray-id stream [m] (``gather_ray_rows``,
    ``occupancy.py:760-789``). Its backward is JAX's
    (``_gather_rows_bwd``): per-ray f32 totals of the rows' cotangents,
    each *truncated* to bf16 (the top 16 bits, as
    ``_segment_sum_sorted_scatter`` packs its totals), rows without
    samples 0. JAX computes it in XLA, outside any Pallas kernel, so it
    has no TPU kernel to port and stays plain PyTorch here: f32 per-ray
    sums in a fixed order (:func:`raw_ngp_torch.device.ordered_index_add`),
    then the truncation by bit operations. The f32 sums
    run in another order than JAX's shift-mask scan, so a total near a
    truncation boundary can land one bf16 ulp apart."""
    if torch.is_grad_enabled() and buf.requires_grad:
        return _GatherRowsFn.apply(buf, rid)
    return buf[rid.to(torch.int64)]


def _slot_targets(pos, M: int):
    """Where each of the m_pad slots lands in a flat [M + m_pad] buffer:
    its source index ``pos`` where filled, a place of its own past M where
    not (the sentinel ``pos == M``), so no two slots share a target."""
    return torch.where(pos < M, pos.to(torch.int64),
                       M + torch.arange(pos.shape[0], device=pos.device))


def _scatter_slots(packed, pos, M: int):
    """[m_pad, ...] slot rows -> [M, ...] at their source indices, zeros
    elsewhere."""
    buf = torch.zeros((M + pos.shape[0],) + packed.shape[1:],
                      dtype=packed.dtype, device=packed.device)
    return buf.index_put((_slot_targets(pos, M),), packed)[:M]


class _ExpandFn(torch.autograd.Function):
    """:func:`expand_from_slots` with its permutation backward."""

    @staticmethod
    def forward(ctx, packed, pos, M):
        ctx.save_for_backward(pos)
        return _scatter_slots(packed, pos, M)

    @staticmethod
    def backward(ctx, g):
        (pos,) = ctx.saved_tensors
        M = g.shape[0]
        rows = g[torch.clamp_max(pos, M - 1).to(torch.int64)]
        filled = (pos < M).reshape((-1,) + (1,) * (g.ndim - 1))
        return torch.where(filled, rows, torch.zeros((), dtype=g.dtype,
                                                     device=g.device)), \
            None, None


def expand_from_slots(packed, pos, M: int):
    """Packed slot rows [m_pad, D] back to the flat samples [M, D]
    (``expand_from_slots``, ``occupancy.py:686-717``): row i of the
    result is the slot whose source index ``pos`` is i, zeros for samples
    no slot holds (JAX gathers the rows at ``inv`` with a dummy zero row
    appended: the same map, since ``pos`` is unique over the filled
    slots). The backward is JAX's permutation: the cotangent rows gathered
    at ``pos``, zero in unfilled slots; no sum, no atomic."""
    if torch.is_grad_enabled() and packed.requires_grad:
        return _ExpandFn.apply(packed, pos, M)
    return _scatter_slots(packed, pos, M)


def _clip_bound(x, bound: float):
    """clip(x, -bound, bound) through torch.minimum / torch.maximum, whose
    gradient splits at a tie as ``jnp.clip``'s does."""
    b = x.new_full((), bound)
    return torch.minimum(torch.maximum(x, -b), b)


def _safe_norm(g):
    """|g| over the last axis, sqrt(sum(g^2)) as ``jnp.linalg.norm``
    computes it, whose gradient at g = 0 is 0 (torch.linalg.norm's) where
    sqrt's would be 0 * inf = NaN."""
    n2 = (g * g).sum(-1, keepdim=True)
    pos = n2 > 0
    return torch.where(pos, torch.sqrt(torch.where(pos, n2, 1.0)), 0.0)


def orientation_loss(field, xyzs, dirs, weights, plain: bool = False,
                     annealing=1.0):
    """Ref-NeRF's orientation loss (``occupancy.py:994-1009``):
    mean over rays of sum_K(weights * min(0, n . -d)^2), with the normals
    n = -grad / (|grad| + 1e-9) mapped to [0, 1] (as the reference does)
    and grad = d sum(sigma) / dx at the [N K, 3] positions ``xyzs``
    (:meth:`NGPField.density_grad`, which keeps the second-order term).

    One departure from JAX: |grad|'s gradient is 0 where grad is exactly
    0 (:func:`_safe_norm`). JAX's ``jnp.linalg.norm`` differentiates
    sqrt there, and 0 * inf gives NaN: dead march slots clipped to a
    corner of the bound box (beyond every level's last half cell on all
    three axes) have a zero density gradient, so JAX's step gradient is
    NaN wherever the batch holds one, and the step is skipped. Such slots
    carry zero weight, so 0 is their contribution."""
    N, K = weights.shape
    g = field.density_grad(xyzs, plain=plain, annealing=annealing)
    n = -g / (_safe_norm(g) + 1e-9)
    n = (n + 1.0) / 2.0
    n_dot_v = (n.reshape(N, K, 3) * -dirs[:, None, :]).sum(-1)
    facing = torch.minimum(n_dot_v, n_dot_v.new_zeros(()))
    return torch.mean((weights * facing ** 2).sum(-1))


def render_occupancy(field, rays_o, rays_d, aabb, bitfield, bg_color=0.0,
                     coarse_lin=None, plain: bool = False,
                     training: bool = False, generator=None,
                     point_budget=None, annealing=1.0,
                     rays_ldir=None, cam_near_far=None,
                     compute_normals: bool = False) -> Dict[str, torch.Tensor]:
    """Full occupancy-path render of rays [N, 3] (``render_occupancy``).
    ``field`` is an :class:`raw_ngp_torch.models.ngp.NGPField`;
    ``rays_ldir`` [N, 3] are the light directions of an rfield field's
    rays (zero-guarded, not normalized, as JAX's);
    ``plain=True`` runs the plain versions of the kernels. ``bg_color`` is
    a number or a tensor broadcasting to [N, 3]. ``generator`` draws the
    march jitter [N, 1] (None: the deterministic jitter 0.5 of
    ``key=None``). In training, ``point_budget`` (default
    ``cfg.render.point_budget``) overrides the compacted point budget and
    the result adds num_points and num_points_raw. ``annealing`` drives the
    field's BARF / BAA-NGP level mask. ``cam_near_far`` [N, 2] clamps each
    ray's AABB span to its camera's [near, far] (before the miss test, as
    JAX's). Returns image [N, 3], depth [N] and
    weights_sum [N]; on the expand and uncompacted paths in training also
    the per-sample weights [N, K]; with ``compute_normals`` the normal map
    [N, 3] (the composite of -normalize(grad sigma) mapped to [0, 1]); in
    training with ``train.lambda_orientation > 0`` the orientation loss
    (:func:`orientation_loss`)."""
    cfg = field.spec.cfg
    r = cfg.render
    N = rays_o.shape[0]
    K = r.samples_per_ray
    M = N * K
    # the orientation loss reads per-sample weights: the expand path
    orient = training and cfg.train.lambda_orientation > 0
    expand = compute_normals or orient

    nears, fars = near_far_from_aabb(rays_o, rays_d, aabb, r.min_near)
    if cam_near_far is not None:
        nears = torch.maximum(nears, cam_near_far[:, :1])
        fars = torch.minimum(fars, cam_near_far[:, 1:])
    miss = fars >= 1e8
    nears = torch.where(miss, 1.0, nears)
    fars = torch.where(miss, 1.001, fars)

    jitter = 0.5
    if generator is not None:
        jitter = torch.rand(N, 1, generator=generator, device=rays_o.device)
    m = march_rays(rays_o, rays_d, bitfield, nears, fars, r.bound,
                   r.grid_size, cfg.cascades, r.march_candidates, K,
                   r.coarse_probes, coarse_lin=coarse_lin, jitter=jitter,
                   contract=r.contract, dt_gamma=r.dt_gamma,
                   march_cdf=r.march_cdf, max_steps=r.max_steps,
                   probe_log=r.probe_log, cdf_floor=r.cdf_floor)
    ts, deltas, mask = m["ts"], m["deltas"], m["mask"]
    # the unit z axis, filled on the device (``ez[2] = 1.0`` would copy a
    # host scalar)
    ez = rays_d.new_zeros(3)
    ez[2:].fill_(1.0)

    results = {}
    if r.compact_ratio > 0:
        # evaluate the field on at most m_pad packed samples; the budget
        # keys off the base cfg.train.num_rays (not the chunk); in training
        # an explicit point budget overrides it
        if point_budget is None:
            point_budget = r.point_budget
        if point_budget is not None and training:
            m_pad = max(point_budget // 128 * 128, 128)
        else:
            m_pad = max(int(min(N, cfg.train.num_rays) * K * r.compact_ratio)
                        // 128 * 128, 128)
        # the live samples (mask & ~miss), decimated uniformly along each
        # ray when over budget (dt scaled by the stride), packed ray-major
        # into m_pad slots: the fold's kernels, no host sync. Unfilled slots
        # read the dummy ray row N (origin 0, unit-z direction and light
        # direction: a zero direction would NaN the SH normalization); the
        # dummy id also keeps rid ascending. The expand path (normals)
        # also takes each slot's source index pos
        t_c, dt_c, rid, filled, counts, valid_total, num_points, *pos = \
            decimate_compact(mask, miss, ts.contiguous(), deltas, m_pad,
                             plain=plain, positions=expand)
        cols = [torch.cat([rays_o, torch.zeros_like(ez)[None]]),
                torch.cat([rays_d, ez[None]])]
        if rays_ldir is not None:
            cols.append(torch.cat([rays_ldir, ez[None]]))
        odl = gather_ray_rows(torch.cat(cols, dim=1), rid)
        o_c, d_c = odl[:, :3], odl[:, 3:6]
        xyz = _clip_bound(o_c + d_c * t_c[:, None], r.bound)
        if r.contract:
            xyz = contract(xyz)
        dnorm = torch.linalg.norm(d_c, dim=-1, keepdim=True)
        dirs_c = torch.where(dnorm > 1e-8, d_c / dnorm, ez)
        ld_c = None
        if rays_ldir is not None:
            l_c = odl[:, 6:9]
            lnorm = torch.linalg.norm(l_c, dim=-1, keepdim=True)
            ld_c = torch.where(lnorm > 1e-8, l_c, ez)     # zero guard only
        sig_c, rgb_c = field(xyz, dirs_c, ld_c, plain=plain,
                             annealing=annealing)
        if training:
            results["num_points"] = num_points
            results["num_points_raw"] = valid_total
        if not expand:
            out = composite_rays_compacted(
                sig_c, rgb_c, t_c, dt_c, rid, filled, counts, N, K,
                t_thresh=r.t_thresh)
            return {"image": composite_with_background(
                        out["image"], out["weights_sum"], bg_color),
                    "depth": out["depth"],
                    "weights_sum": out["weights_sum"], **results}
        # the expand path: the slots back to [N, K] and the dense composite
        # on the decimated mask and dt * stride, as the JAX chain leaves
        # them
        (pos,) = pos
        sig_rgb = expand_from_slots(
            torch.cat([sig_c[:, None].float(), rgb_c.float()], dim=-1), pos,
            M)
        sigmas, rgbs = sig_rgb[:, 0].reshape(N, K), sig_rgb[:, 1:].reshape(
            N, K, 3)
        mask = _scatter_slots(filled, pos, M).reshape(N, K)
        stride = torch.clamp_min((valid_total + m_pad - 1) // m_pad, 1)
        deltas = deltas * stride.to(deltas.dtype)
    else:
        # every [N, K] sample through the field
        mask = mask & ~miss
        xyz = _clip_bound(rays_o[:, None, :] + rays_d[:, None, :]
                          * ts[..., None], r.bound).reshape(M, 3)
        if r.contract:
            xyz = contract(xyz)
        dirs = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
        ld = (None if rays_ldir is None else
              rays_ldir[:, None, :].expand(N, K, 3).reshape(M, 3))
        sigmas, rgbs = field(xyz, dirs[:, None, :].expand(N, K, 3).reshape(
            M, 3), ld, plain=plain, annealing=annealing)
        sigmas, rgbs = sigmas.reshape(N, K), rgbs.reshape(N, K, 3)
        if training:
            results["num_points"] = results["num_points_raw"] = mask.sum()

    out = composite_rays(sigmas, rgbs, ts, deltas, mask, t_thresh=r.t_thresh)
    if training:
        results["weights"] = out["weights"]
    if orient:
        # every [N, K] march position, clipped (and contracted), as
        # constants (JAX's stop_gradient)
        xyzs = _clip_bound(rays_o[:, None, :] + rays_d[:, None, :]
                           * ts[..., None], r.bound).reshape(M, 3)
        if r.contract:
            xyzs = contract(xyzs)
        dirs = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
        results["orientation_loss"] = orientation_loss(
            field, xyzs.detach(), dirs, out["weights"], plain=plain,
            annealing=annealing)
    if compute_normals:
        n = field.normals(xyz, plain=plain, annealing=annealing)
        if r.compact_ratio > 0:
            n = expand_from_slots(n, pos, M)
        nm = (out["weights"][..., None] * n.reshape(N, K, 3).float()).sum(1)
        results["normals"] = composite_with_background(
            nm, out["weights_sum"], bg_color)
    results["image"] = composite_with_background(
        out["image"], out["weights_sum"], bg_color)
    results["depth"] = out["depth"]
    results["weights_sum"] = out["weights_sum"]
    return results
