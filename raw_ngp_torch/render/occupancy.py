"""Occupancy-grid volume render, for eval and for training (port of
``raw_ngp_tpu/render/occupancy.py``).

The JAX design is kept: static shapes end to end. Candidates are placed
by inverting each ray's CDF of coarse-probe hits, tested against the
Morton bitfield, budget-decimated and compacted across rays into
``m_pad`` slots in one fold (``decimate_compact``,
``raw_ngp_torch/kernels/compact.py``), run through the field (whose
encode is the hash kernel) and composited on the compacted stream. No
step reads a device value back to the host.

Only the branches of the flagship configuration are ported: uniform
probes with the integer CDF branch of ``cdf_candidates``, the ``S == K``
return of ``march_rays`` and the compact-composite branch of
``render_occupancy``, with or without per-ray light directions (the
rfield field's). The others raise ``NotImplementedError``. In
training the gradient reaches the field's parameters through the field
and the composite, and, under pose refinement, the rays: through the
compacted t and dt (near/far and the CDF spacing depend on the rays; the
fold's backward is B1's), the ray-row gather
(:func:`gather_ray_rows`) and the positions' encode input gradient.
Clips that a gradient crosses use ``torch.minimum``/``torch.maximum``,
which split the gradient at a tie as ``jnp.clip`` does.
"""

from __future__ import annotations

import functools
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from raw_ngp_torch.device import ordered_index_add
from raw_ngp_torch.kernels.compact import decimate_compact
from raw_ngp_torch.ops.compositing import (composite_rays_compacted,
                                           composite_with_background)
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


def occupancy_lookup(bitfield, pos, dt, bound: float, grid_size: int,
                     cascades: int):
    """Bitfield test of world positions [..., 3] with step sizes dt [...]
    at their mip level (raymarching.cu:406-442). No contraction."""
    pos = torch.clamp(pos, -bound, bound)
    level = _mip_level(pos, dt, grid_size, cascades)
    mip_bound = torch.clamp_max(_pow2(level), bound)
    mip_rbound = 1.0 / mip_bound
    n = torch.clamp(0.5 * (pos * mip_rbound[..., None] + 1.0) * grid_size,
                    0.0, grid_size - 1).to(torch.int32)
    index = level.to(torch.int64) * grid_size ** 3 + morton3d(n)
    word = _bitfield_words(bitfield)[index >> 5]
    # arithmetic >> on a negative int32 still leaves bit s at position 0
    return ((word >> (index & 31).to(torch.int32)) & 1).bool()


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


def _probe_grid(nears, fars, n_probes: int):
    """Uniform probe intervals over [near, far]: centers t [N, P] and
    spacing [N, 1]."""
    steps = torch.arange(n_probes, dtype=torch.float32,
                         device=nears.device)[None, :] + 0.5
    spacing = (fars - nears) / n_probes
    return nears + spacing * steps, spacing


def _probe_occupancy(rays_o, rays_d, coarse_lin, nears, fars, bound: float,
                     grid_size: int, cascades: int, n_probes: int):
    """Per-ray probe-interval occupancy against the dilated, union-folded
    coarse grid: one gather per probe at its containing cascade.
    Returns (occ [N, P] bool, t [N, P], spacing [N, 1])."""
    hc = grid_size // 4
    t, spacing = _probe_grid(nears, fars, n_probes)
    pos = rays_o[:, None, :] + rays_d[:, None, :] * t[..., None]
    pos = torch.clamp(pos, -bound, bound)
    lvl = torch.clamp(_floor_log2_p1(pos.abs().amax(dim=-1)), 0,
                      cascades - 1)
    mb = torch.clamp_max(_pow2(lvl), bound)[..., None]
    n = torch.clamp(0.5 * (pos / mb + 1.0) * hc, 0.0,
                    hc - 1).to(torch.int64)
    idx = (lvl.to(torch.int64) * hc ** 3
           + (n[..., 0] * hc + n[..., 1]) * hc + n[..., 2])
    occ = coarse_lin[idx] > 0
    return occ & (t < fars), t, spacing


def cdf_candidates(rays_o, rays_d, coarse_lin, nears, fars, bound: float,
                   grid_size: int, cascades: int, n_probes: int,
                   num_candidates: int, jitter):
    """Candidate times over the OCCUPIED probe intervals only: the S
    candidates fill the union of occupied intervals uniformly, by
    inverting each ray's integer CDF of probe hits (uniform probes, no
    dt_gamma, no floor). Returns (t_cand [N, S], dt [N, 1])."""
    occ, _, spacing = _probe_occupancy(
        rays_o, rays_d, coarse_lin, nears, fars, bound, grid_size,
        cascades, n_probes)
    S = num_candidates
    steps = torch.arange(S, dtype=torch.float32, device=nears.device)[None]
    Wt = torch.cumsum(occ.to(torch.int32), dim=1, dtype=torch.int32)
    w = Wt[:, -1:].float()                                  # [N, 1]
    u = (steps + jitter) * (w / S)                          # [N, S]
    j_occ = torch.floor(u)
    j32 = j_occ.to(torch.int32)
    # probe index of the (j_occ+1)-th occupied interval: count probes
    # whose cumulative hit count has not passed j_occ
    p_idx = torch.zeros(u.shape, dtype=torch.int32, device=u.device)
    for p in range(n_probes):
        p_idx = p_idx + (Wt[:, p:p + 1] <= j32).to(torch.int32)
    frac = u - j_occ
    t_cand = nears + (p_idx.float() + frac) * spacing
    dt = spacing * w / S
    return t_cand, dt


def march_rays(rays_o, rays_d, bitfield, nears, fars, bound: float,
               grid_size: int, cascades: int, num_candidates: int,
               samples_per_ray: int, coarse_probes: int, coarse_lin=None,
               jitter=0.5):
    """Candidate -> occupancy mask march, S == K with CDF candidates over
    coarse probes. ``jitter`` is 0.5 (the deterministic ``key=None``
    path) or a [N, 1] tensor of uniforms (the keyed march, ``:489-492``).
    Returns dict with ts [N, K] (-1 where dead), deltas [N, K] and
    mask [N, K]."""
    N = rays_o.shape[0]
    S, K = num_candidates, samples_per_ray
    if S != K or coarse_probes <= 0:
        raise NotImplementedError("only the S == K CDF march is ported")
    if coarse_lin is None:
        coarse_lin = coarse_occupancy(
            bitfield, grid_size, cascades,
            _coarse_dilate_radius(bound, grid_size, coarse_probes),
            bound=bound)
    t_cand, dt = cdf_candidates(
        rays_o, rays_d, coarse_lin, nears, fars, bound, grid_size, cascades,
        coarse_probes, S, jitter)
    pos = rays_o[:, None, :] + rays_d[:, None, :] * t_cand[..., None]
    occ = occupancy_lookup(bitfield, pos, dt.expand(N, S), bound,
                           grid_size, cascades)
    occ = occ & (t_cand < fars)
    # candidates ARE the sample slots: dead candidates just mask out
    ts = torch.where(occ, t_cand, -1.0)
    return {"ts": ts, "deltas": dt.expand(N, K), "mask": occ}


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


def render_occupancy(field, rays_o, rays_d, aabb, bitfield, bg_color=0.0,
                     coarse_lin=None, plain: bool = False,
                     training: bool = False, generator=None,
                     point_budget=None, annealing=1.0,
                     rays_ldir=None) -> Dict[str, torch.Tensor]:
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
    field's BARF / BAA-NGP level mask. Returns image [N, 3], depth [N] and
    weights_sum [N]."""
    cfg = field.spec.cfg
    r = cfg.render
    N = rays_o.shape[0]
    K = r.samples_per_ray
    if (r.contract or r.dt_gamma > 0.0 or not r.march_cdf or r.probe_log
            or r.cdf_floor > 0.0 or r.compact_ratio <= 0
            or r.compute_normals):
        raise NotImplementedError(
            "only the flagship occupancy branch is ported (no contraction, "
            "dt_gamma, span march, log probes, cdf floor, expand path or "
            "normals)")

    nears, fars = near_far_from_aabb(rays_o, rays_d, aabb, r.min_near)
    miss = fars >= 1e8
    nears = torch.where(miss, 1.0, nears)
    fars = torch.where(miss, 1.001, fars)

    jitter = 0.5
    if generator is not None:
        jitter = torch.rand(N, 1, generator=generator, device=rays_o.device)
    m = march_rays(rays_o, rays_d, bitfield, nears, fars, r.bound,
                   r.grid_size, cfg.cascades, r.march_candidates, K,
                   r.coarse_probes, coarse_lin=coarse_lin, jitter=jitter)
    ts, deltas, mask = m["ts"], m["deltas"], m["mask"]

    # evaluate the field on at most m_pad packed samples; the budget keys
    # off the base cfg.train.num_rays (not the chunk); in training an
    # explicit point budget overrides it
    if point_budget is None:
        point_budget = r.point_budget
    if point_budget is not None and training:
        m_pad = max(point_budget // 128 * 128, 128)
    else:
        m_pad = max(int(min(N, cfg.train.num_rays) * K * r.compact_ratio)
                    // 128 * 128, 128)
    # the live samples (mask & ~miss), decimated uniformly along each ray
    # when over budget (dt scaled by the stride), packed ray-major into
    # m_pad slots: the fold's kernels, no host sync. Unfilled slots read the
    # dummy ray row N (origin 0, unit-z direction and light direction: a
    # zero direction would NaN the SH normalization); the dummy id also
    # keeps rid ascending
    t_c, dt_c, rid, filled, counts, valid_total, num_points = \
        decimate_compact(mask, miss, ts, deltas, m_pad, plain=plain)
    ez = torch.tensor([0.0, 0.0, 1.0], dtype=rays_d.dtype,
                      device=rays_d.device)
    cols = [torch.cat([rays_o, torch.zeros_like(ez)[None]]),
            torch.cat([rays_d, ez[None]])]
    if rays_ldir is not None:
        cols.append(torch.cat([rays_ldir, ez[None]]))
    odl = gather_ray_rows(torch.cat(cols, dim=1), rid)
    o_c, d_c = odl[:, :3], odl[:, 3:6]
    bound = torch.tensor(r.bound, dtype=torch.float32, device=odl.device)
    xyz_c = torch.minimum(torch.maximum(o_c + d_c * t_c[:, None], -bound),
                          bound)
    dnorm = torch.linalg.norm(d_c, dim=-1, keepdim=True)
    dirs_c = torch.where(dnorm > 1e-8, d_c / dnorm, ez)
    ld_c = None
    if rays_ldir is not None:
        l_c = odl[:, 6:9]
        lnorm = torch.linalg.norm(l_c, dim=-1, keepdim=True)
        ld_c = torch.where(lnorm > 1e-8, l_c, ez)     # zero guard only
    sig_c, rgb_c = field(xyz_c, dirs_c, ld_c, plain=plain,
                         annealing=annealing)

    out = composite_rays_compacted(
        sig_c, rgb_c, t_c, dt_c, rid, filled, counts, N, K,
        t_thresh=r.t_thresh)
    results = {
        "image": composite_with_background(out["image"], out["weights_sum"],
                                           bg_color),
        "depth": out["depth"],
        "weights_sum": out["weights_sum"],
    }
    if training:
        results["num_points"] = num_points
        results["num_points_raw"] = valid_total
    return results
