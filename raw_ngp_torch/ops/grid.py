"""Occupancy-grid state the render reads (port of ``raw_ngp_tpu/ops/grid.py``
``init_grid_state`` and ``packbits``; the grid refresh comes with the
training slices)."""

from __future__ import annotations

from typing import Dict

import torch

from raw_ngp_torch.config import Config
from raw_ngp_torch.device import resolve_device


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
