"""Morton (Z-order) 3D codes by bit interleaving (port of
``raw_ngp_tpu/ops/morton.py``: ``morton3d`` and ``morton3d_invert``).

Torch has little uint32 arithmetic, so the magic-number spreading runs in
int64 and each step's mask keeps only the low 32 bits — the same values as
the uint32 wrap-around of the reference.
"""

from __future__ import annotations

import torch


def _expand_bits(v):
    """Spread the low 10 bits of v so consecutive bits land 3 apart."""
    v = v.to(torch.int64)
    v = (v * 0x00010001) & 0xFF0000FF
    v = (v * 0x00000101) & 0x0F00F00F
    v = (v * 0x00000011) & 0xC30C30C3
    v = (v * 0x00000005) & 0x49249249
    return v


def morton3d(coords):
    """[..., 3] integer coords in [0, 1024) -> [...] int64 Morton codes
    (values < 2^30)."""
    x = _expand_bits(coords[..., 0])
    y = _expand_bits(coords[..., 1])
    z = _expand_bits(coords[..., 2])
    return x | (y << 1) | (z << 2)


def _compact_bits(v):
    """Inverse of :func:`_expand_bits`."""
    v = v.to(torch.int64) & 0x49249249
    v = (v ^ (v >> 2)) & 0xC30C30C3
    v = (v ^ (v >> 4)) & 0x0F00F00F
    v = (v ^ (v >> 8)) & 0xFF0000FF
    v = (v ^ (v >> 16)) & 0x000003FF
    return v


def morton3d_invert(codes):
    """[...] Morton codes (< 2^30) -> [..., 3] int32 coords."""
    codes = codes.to(torch.int64)
    return torch.stack([_compact_bits(codes), _compact_bits(codes >> 1),
                        _compact_bits(codes >> 2)], dim=-1).to(torch.int32)
