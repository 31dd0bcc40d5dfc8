"""Multi-cascade occupancy grid: state, bit packing, the density refresh and
frustum marking (port of ``raw_ngp_tpu/ops/grid.py``: ``init_grid_state``,
``packbits``, ``_cascade_coords_to_world``, ``make_grid_update`` and
``mark_untrained_grid``).

The refresh keeps the JAX schedule: a full sweep of every cell for the
first 16 refreshes, then a partial sweep of one cascade in turn (random
cells plus the occupied ones, stride-decimated), then ``finish``: EMA-max
merge, threshold, ``packbits``. Its random draws are explicit arguments
of :func:`full_sweep` and :func:`partial_sweep` (the parity tests feed the
JAX package's draws); :func:`make_grid_update` draws them from a
``torch.Generator``. The density is queried in 65,536-point chunks under
``torch.no_grad``, through the field's encode kernel.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from raw_ngp_torch.config import Config
from raw_ngp_torch.device import resolve_device
from raw_ngp_torch.ops.morton import morton3d_invert

_CHUNK = 2 ** 16


def init_grid_state(cfg: Config, device="cuda") -> Dict[str, torch.Tensor]:
    """Zero-initialized grid buffers: density_grid [CAS, H^3] f32 in Morton
    order and density_bitfield [CAS*H^3/8] u8."""
    dev = resolve_device(device)
    cas = cfg.cascades
    h3 = cfg.render.grid_size ** 3
    return dict(
        density_grid=torch.zeros(cas, h3, dtype=torch.float32, device=dev),
        density_bitfield=torch.zeros(cas * h3 // 8, dtype=torch.uint8,
                                     device=dev),
        mean_density=torch.zeros((), dtype=torch.float32, device=dev),
        iter_density=torch.zeros((), dtype=torch.int32, device=dev),
    )


def packbits(density_grid, thresh):
    """[CAS, H^3] Morton-ordered densities -> u8 bitfield (bit i of byte b
    is cell b*8+i, raymarching.cu:268-289)."""
    occ = (density_grid.reshape(-1, 8) > thresh).to(torch.int32)
    weights = 2 ** torch.arange(8, dtype=torch.int32,
                                device=density_grid.device)
    return (occ * weights).sum(dim=-1).to(torch.uint8)


def cascade_coords_to_world(coords, cas_bound: float, half_grid: float,
                            grid_size: int, noise):
    """Integer grid coords [..., 3] -> jittered world positions at one
    cascade; ``noise`` [..., 3] holds uniforms in [0, 1)."""
    xyz = 2.0 * coords.float() / (grid_size - 1) - 1.0
    xyz = xyz * (cas_bound - half_grid)
    return xyz + (noise * 2.0 - 1.0) * half_grid


def n_partial(cfg: Config) -> int:
    """Cells per half of a partial refresh, a multiple of 2^15."""
    h3 = cfg.render.grid_size ** 3
    return max(int(h3 * cfg.render.grid_partial_fraction) // 2 ** 15
               * 2 ** 15, min(2 ** 15, h3 // 4))


def _query_sigma(field, xyz):
    """Densities at world positions [n, 3], in chunks, without a graph."""
    with torch.no_grad():
        return torch.cat([field.density(c) for c in xyz.split(_CHUNK)])


def full_sweep(field, cfg: Config, noise):
    """Densities of every cell of every cascade, [CAS, H^3] (Morton
    order); ``noise`` [CAS, H^3, 3] uniforms jitter the cell centres."""
    n = cfg.render.grid_size
    codes = torch.arange(n ** 3, device=noise.device)
    coords = morton3d_invert(codes)
    tmp = []
    for cas in range(cfg.cascades):
        cas_bound = min(2 ** cas, cfg.grid_bound)
        xyz = cascade_coords_to_world(coords, cas_bound, cas_bound / n, n,
                                      noise[cas])
        tmp.append(_query_sigma(field, xyz))
    return torch.stack(tmp)


def partial_sweep(field, cfg: Config, density_grid, cas: int, rand_idx,
                  phase, noise):
    """-1 everywhere except the refreshed cells of cascade ``cas``: the
    cells ``rand_idx`` [n_partial] (sorted) and the occupied cells, all of
    them when they fit in n_partial, else every stride-th from ``phase``
    (an int >= 0, taken modulo the stride). ``noise`` [2 n_partial, 3]."""
    n = cfg.render.grid_size
    h3 = n ** 3
    npart = n_partial(cfg)
    dev = density_grid.device
    tmp = torch.full((cfg.cascades, h3), -1.0, device=dev)
    cas_bound = min(2 ** cas, cfg.grid_bound)
    occ = density_grid[cas] > 0
    c = torch.cumsum(occ.to(torch.int32), 0, dtype=torch.int32)
    stride = torch.clamp_min((c[-1] + npart - 1) // npart, 1)
    keep = occ & ((c - 1) % stride == phase % stride)
    ck = torch.cumsum(keep.to(torch.int32), 0, dtype=torch.int32)
    kept = keep & (ck <= npart)
    # kept cell number k writes row 2k; the rest write odd rows, dropped
    dest = torch.where(kept, 2 * ck, torch.clamp_max(2 * ck + 1,
                                                     2 * npart + 1))
    buf = torch.full((2 * npart + 2,), h3, dtype=torch.int64, device=dev)
    buf.scatter_(0, dest.to(torch.int64), torch.arange(h3, device=dev))
    # unfilled slots re-query the last cell (a harmless duplicate)
    occ_idx = torch.clamp_max(buf[2::2], h3 - 1)
    rand_idx = rand_idx.to(torch.int64)
    idx = torch.cat([rand_idx, occ_idx])
    xyz = cascade_coords_to_world(morton3d_invert(idx), cas_bound,
                                  cas_bound / n, n, noise)
    sig = _query_sigma(field, xyz)
    tmp[cas, rand_idx] = sig[:npart]
    tmp[cas, occ_idx] = sig[npart:]
    return tmp


def finish(density_grid, tmp, density_thresh: float, decay: float = 0.95):
    """EMA-max merge of the refreshed densities, threshold (the mean
    density, at most ``density_thresh``) and packbits. Returns (grid,
    bitfield, mean_density)."""
    valid = (density_grid >= 0) & (tmp >= 0)
    grid = torch.where(valid, torch.maximum(density_grid * decay, tmp),
                       density_grid)
    mean = torch.clamp_min(grid, 0.0).mean()
    return grid, packbits(grid, torch.clamp_max(mean, density_thresh)), mean


def make_grid_update(cfg: Config, decay: float = 0.95):
    """The density-grid refresh: ``update(field, grid_state, host_iter,
    generator) -> grid_state`` (a new dict of the four grid buffers).
    Refreshes 0-15 sweep every cell; later ones sweep cascade
    (host_iter - 16) % CAS partially."""
    n = cfg.render.grid_size
    h3 = n ** 3
    npart = n_partial(cfg)

    def update(field, state, host_iter: int, generator):
        dev = state["density_grid"].device
        if host_iter < 16:
            noise = torch.rand(cfg.cascades, h3, 3, generator=generator,
                               device=dev)
            tmp = full_sweep(field, cfg, noise)
        else:
            rand_idx = torch.sort(torch.randint(
                0, h3, (npart,), generator=generator, device=dev)).values
            phase = torch.randint(0, 1 << 30, (), generator=generator,
                                  device=dev)
            noise = torch.rand(2 * npart, 3, generator=generator, device=dev)
            tmp = partial_sweep(field, cfg, state["density_grid"],
                                (host_iter - 16) % cfg.cascades, rand_idx,
                                phase, noise)
        grid, bits, mean = finish(state["density_grid"], tmp,
                                  cfg.render.density_thresh, decay)
        return dict(density_grid=grid, density_bitfield=bits,
                    mean_density=mean,
                    iter_density=state["iter_density"] + 1)

    return update


def mark_untrained_grid(cfg: Config, poses, intrinsics, aabb,
                        cam_near_far=None) -> np.ndarray:
    """Initial density grid [CAS, H^3] f32 (numpy) with -1 in the cells no
    camera sees or outside the AABB (host side, once before training)."""
    grid_size = cfg.render.grid_size
    h3 = grid_size ** 3
    bound = cfg.grid_bound
    poses = np.asarray(poses)
    fx, fy, cx, cy = np.asarray(intrinsics)
    aabb = np.asarray(aabb)
    B = poses.shape[0]
    codes = torch.arange(h3, dtype=torch.int64)
    coords = morton3d_invert(codes).numpy()
    world = 2.0 * coords.astype(np.float32) / (grid_size - 1) - 1.0
    grid = np.zeros((cfg.cascades, h3), np.float32)
    min_near = (cfg.render.min_near if cam_near_far is None
                else np.asarray(cam_near_far)[:, 0][:, None])
    for cas in range(cfg.cascades):
        cas_bound = min(2 ** cas, bound)
        half = cas_bound / grid_size
        pts = world * (cas_bound - half)
        in_aabb = np.all(pts >= (aabb[:3] - half), axis=-1) & \
            np.all(pts <= (aabb[3:] + half), axis=-1)
        seen = np.zeros(h3, bool)
        S = 16
        for head in range(0, B, S):
            ps = poses[head:head + S]
            cam = pts[None] - ps[:, None, :3, 3]
            cam = np.einsum("bnc,bcr->bnr", cam, ps[:, :3, :3])
            cam[..., 2] *= -1                            # forward is -z
            mn = (min_near if np.isscalar(min_near)
                  else min_near[head:head + S])
            mask_z = cam[..., 2] > mn
            mask_x = np.abs(cam[..., 0]) < (cx / fx * cam[..., 2] + half * 2)
            mask_y = np.abs(cam[..., 1]) < (cy / fy * cam[..., 2] + half * 2)
            seen |= (mask_z & mask_x & mask_y).any(axis=0)
        grid[cas, ~(seen & in_aabb)] = -1.0
    return grid
