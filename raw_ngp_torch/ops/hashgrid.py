"""Multiresolution hash-grid encoding — the plain PyTorch version (port of
``raw_ngp_tpu/ops/hashgrid.py``), and the grid regularizers
``weight_decay_loss`` and ``total_variation_loss``.

``hash_encode_01`` here is the f32 plain version of the hand-written
encode kernel (``raw_ngp_torch/kernels/hash_encode.py``
``hash_encode_fused_plain``, which adds the fused encoder's bf16 chain):
the CPU tests hold it against the JAX function, and ``chip_smoke.py``
holds the kernel against it on the card. It is also the unfused encoder
(``model.fused_encoder`` False) on every device, differentiable in the
table and the positions by autograd: the gather's backward is
``index_put_(accumulate=True)``, which sums in a fixed order on the card.
Its clip is ``torch.minimum`` / ``torch.maximum``, whose gradient splits
at a tie as ``jnp.clip``'s does.

Torch has little uint32 arithmetic, so the table index is computed in
int64 and every product is masked with ``& 0xFFFFFFFF``: the same values
as the uint32 wrap-around of the reference (gridencoder.cu:46-79). The
additive variant's ``% (hmap - res)`` is taken after that mask.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

# per-dim hash primes (gridencoder.cu:49)
_PRIMES = (1, 2654435761, 805459861, 3674653429, 2097192037, 1434869437,
           2165219737)
_U32 = 0xFFFFFFFF


@dataclass(frozen=True)
class HashGridSpec:
    """Static description of a hash-grid encoder (same fields and
    semantics as the JAX package's HashGridSpec)."""

    input_dim: int = 3
    num_levels: int = 16
    level_dim: int = 2
    per_level_scale: float = 2.0
    base_resolution: int = 16
    log2_hashmap_size: int = 19
    gridtype: str = "hash"            # "hash" | "tiled"
    align_corners: bool = False
    interpolation: str = "linear"     # "linear" | "smoothstep"
    # "xor": prime-XOR hash; "additive": row = c[a] + mix(others), which
    # keeps the two a-corners of every cell on adjacent table rows
    hash_variant: str = "xor"
    # the channel count the fused encoder picks its dense (matmul) levels
    # at (kernels/hash_encode.matmul_split); 0 = level_dim. A tensor-
    # parallel shard keeps its whole table's, so that it takes the
    # unsharded encode's path, and its bits, level by level
    split_level_dim: int = 0

    @staticmethod
    def create(input_dim=3, num_levels=16, level_dim=2,
               base_resolution=16, log2_hashmap_size=19,
               desired_resolution=None, per_level_scale=2.0,
               gridtype="hash", align_corners=False,
               interpolation="linear", hash_variant="xor") -> "HashGridSpec":
        """A desired finest resolution overrides per_level_scale."""
        if desired_resolution is not None:
            per_level_scale = float(np.exp2(
                np.log2(desired_resolution / base_resolution)
                / max(num_levels - 1, 1)))
        return HashGridSpec(
            input_dim=input_dim, num_levels=num_levels, level_dim=level_dim,
            per_level_scale=per_level_scale, base_resolution=base_resolution,
            log2_hashmap_size=log2_hashmap_size, gridtype=gridtype,
            align_corners=align_corners, interpolation=interpolation,
            hash_variant=hash_variant)

    # computed once a spec (the frozen dataclass keeps an instance dict,
    # where cached_property stores them): the encode reads them per level
    # on every call
    @functools.cached_property
    def resolutions(self) -> Tuple[int, ...]:
        s = math.log2(self.per_level_scale)
        return tuple(int(math.ceil(2.0 ** (lv * s) * self.base_resolution))
                     for lv in range(self.num_levels))

    @functools.cached_property
    def offsets(self) -> Tuple[int, ...]:
        """Cumulative per-level table offsets, each level's size
        min(2^log2_T, res^D) rounded up to a multiple of 8."""
        offs = [0]
        max_params = 2 ** self.log2_hashmap_size
        for res in self.resolutions:
            params = min(max_params, res ** self.input_dim)
            params = int(math.ceil(params / 8) * 8)
            offs.append(offs[-1] + params)
        return tuple(offs)

    @property
    def n_params(self) -> int:
        return self.offsets[-1]

    @property
    def output_dim(self) -> int:
        return self.num_levels * self.level_dim


def init_hashgrid_params(spec: HashGridSpec, generator: torch.Generator,
                         device=None) -> torch.Tensor:
    """U(-1e-4, 1e-4) flat [n_params * level_dim] f32 table (row r's
    channels at [r*C, (r+1)*C))."""
    t = torch.rand(spec.n_params * spec.level_dim, generator=generator,
                   dtype=torch.float32)
    return (t * 2e-4 - 1e-4).to(device)


def pair_axis(spec: HashGridSpec, level: int) -> int:
    """Axis along which the additive variant's two interpolation corners
    are table-adjacent at this level (0 for dense levels and for xor)."""
    res = spec.resolutions[level]
    hmap = spec.offsets[level + 1] - spec.offsets[level]
    dense = res ** spec.input_dim <= hmap
    if dense or spec.hash_variant != "additive":
        return 0
    return level % spec.input_dim


def _mix_prime(d: int) -> int:
    """Prime for dimension d inside the additive variant's mix hash
    (dim 0 borrows a large prime, since _PRIMES[0] == 1)."""
    return _PRIMES[d] if d > 0 else _PRIMES[3]


def level_layout(spec: HashGridSpec, level: int):
    """How one level turns integer corner coords into a table row:
    (res, hmap, offset, strides, mode, axis). ``strides`` are the uint32
    strides of the dims that contribute before the cumulative-stride
    early-out (gridencoder.cu:62-79); ``mode`` is "stride" (dense, or
    tiled past the early-out), "xor" or "additive" (pair axis ``axis``).
    Shared by the plain version and the kernel's level table."""
    res = spec.resolutions[level]
    hmap = spec.offsets[level + 1] - spec.offsets[level]
    strides = []
    stride = 1
    for _ in range(spec.input_dim):
        if stride > hmap:
            break
        strides.append(stride & _U32)
        stride *= res
    mode = "stride"
    if spec.gridtype == "hash" and stride > hmap:
        mode = ("additive" if spec.hash_variant == "additive" and hmap > res
                else "xor")
    return res, hmap, spec.offsets[level], tuple(strides), mode, \
        pair_axis(spec, level)


def _level_indices(spec: HashGridSpec, level: int, corner_coords):
    """Flat table row (int64) for integer corner coords [..., D] at one
    level, with the reference's uint32 wrap-around."""
    _, hmap, offset, strides, mode, a = level_layout(spec, level)
    res = spec.resolutions[level]
    D = spec.input_dim
    c = corner_coords.to(torch.int64)
    if mode == "additive":
        g = torch.zeros_like(c[..., 0])
        for d in range(D):
            if d != a:
                g = g ^ ((c[..., d] * _mix_prime(d)) & _U32)
        index = (c[..., a] + g % (hmap - res)) & _U32
    elif mode == "xor":
        index = torch.zeros_like(c[..., 0])
        for d in range(D):
            index = index ^ ((c[..., d] * _PRIMES[d]) & _U32)
    else:
        index = torch.zeros_like(c[..., 0])
        for d, s in enumerate(strides):
            index = (index + c[..., d] * s) & _U32
    return index % hmap + offset


def _smoothstep(t):
    return t * t * (3.0 - 2.0 * t)


def _clip(x, lo: float, hi: float):
    """clip(x, lo, hi) whose gradient splits at a tie as ``jnp.clip``'s
    (the bounds filled on x's device: no host copy)."""
    return torch.minimum(torch.maximum(x, x.new_full((), lo)),
                         x.new_full((), hi))


def hash_encode_01(params, x01, spec: HashGridSpec, max_level=None):
    """Encode positions already mapped to [0, 1]^D (plain version).

    params: flat [n_params*C] table; x01: [B, D]. Inputs outside [0, 1]^D
    (and NaN) give zeros. ``max_level`` zeroes levels >= max_level.
    Returns [B, L*C] in the table's dtype.
    """
    B, D = x01.shape
    L, C = spec.num_levels, spec.level_dim
    table = params.reshape(spec.n_params, C)
    n_corners = 1 << D
    x01 = x01.float()

    # the negated in-bounds form also catches NaN inputs
    inb = ((x01 >= 0.0) & (x01 <= 1.0)).all(dim=-1, keepdim=True)
    x01 = torch.where(inb, x01, 0.5)

    # corner c's offset along axis d, bit d of c (made on the device: no
    # copy from the host inside a step)
    corners = torch.arange(n_corners, device=x01.device)
    bits = ((corners[:, None] >> torch.arange(D, device=x01.device))
            & 1).float()
    active = L if max_level is None else min(max_level, L)
    all_idx, all_w = [], []
    for lv in range(L):
        res = spec.resolutions[lv]
        if spec.align_corners:
            pos = x01 * (res - 1)
            grid = torch.clamp_max(torch.floor(pos), res - 2)
        else:
            pos = _clip(x01 * res - 0.5, 0.0, res - 1)
            grid = torch.floor(pos)
        frac = pos - grid
        if spec.interpolation == "smoothstep":
            frac = _smoothstep(frac)
        corner = torch.clamp_max(grid.to(torch.int64)[:, None, :]
                                 + bits.to(torch.int64), res - 1)
        idx = _level_indices(spec, lv, corner)              # [B, 2^D]
        # per-dim factor frac or 1 - frac, multiplied in dim order (the
        # kernel's f32 order)
        fac = bits * frac[:, None, :] + (1.0 - bits) * (1.0 - frac[:, None, :])
        w = fac[..., 0]
        for d in range(1, D):
            w = w * fac[..., d]
        if lv >= active:
            w = torch.zeros_like(w)
        all_idx.append(idx)
        all_w.append(w)

    idx = torch.cat(all_idx, dim=1)                         # [B, L*2^D]
    w = torch.cat(all_w, dim=1)
    vals = table[idx]                                       # [B, L*2^D, C]
    feats = (vals * w[..., None]).reshape(B, L, n_corners, C).sum(dim=2)
    return torch.where(inb, feats.reshape(B, L * C), 0.0)


def hash_encode(params, x, spec: HashGridSpec, bound: float = 1.0,
                max_level=None):
    """Encode world positions in [-bound, bound]^D."""
    x01 = (x + bound) / (2.0 * bound)
    return hash_encode_01(params, x01, spec, max_level=max_level)


# ---------------------------------------------------------------------------
# regularizers: the reference's in-place gradient kernels as loss terms
# (gridencoder.cu:525-631 TV, :670-703 weight decay)
# ---------------------------------------------------------------------------

def weight_decay_loss(params, spec: HashGridSpec):
    """Level-meaned weight decay (``weight_decay_loss``): each level adds
    ||emb_l||^2 / (2 n_params_l), so its gradient is emb / n_params_l."""
    table = params.reshape(spec.n_params, spec.level_dim)
    total = 0.0
    for lv in range(spec.num_levels):
        lo, hi = spec.offsets[lv], spec.offsets[lv + 1]
        emb = table[lo:hi]
        total = total + 0.5 * torch.sum(emb * emb) / (hi - lo)
    return total


def total_variation_at(params, spec: HashGridSpec, x01):
    """The total-variation penalty at the points x01 [n, D] in [0, 1)^D:
    per level the squared feature differences between each point's cell
    corner and its neighbour along each axis, summed, over n. The
    gathers' backward is ``index_put_(accumulate=True)`` (a fixed order on
    the card)."""
    table = params.reshape(spec.n_params, spec.level_dim)
    D = spec.input_dim
    total = 0.0
    for lv in range(spec.num_levels):
        res = spec.resolutions[lv]
        grid = torch.floor(torch.clamp(x01 * res - 0.5, 0.0, res - 1)).to(
            torch.int64)
        base = table[_level_indices(spec, lv, grid[:, None, :])[:, 0]]
        for d in range(D):
            nb = grid.clone()
            nb[:, d] = torch.clamp_max(nb[:, d] + 1, res - 1)
            diff = table[_level_indices(spec, lv, nb[:, None, :])[:, 0]] - base
            total = total + torch.sum(diff * diff)
    return total / x01.shape[0]


def total_variation_loss(params, spec: HashGridSpec, generator,
                         n_samples: int = 65536):
    """Stochastic total variation (``total_variation_loss``): the penalty
    at ``n_samples`` uniform points drawn from ``generator`` on the table's
    device (JAX draws them from the step's key; the streams differ). A
    ``None`` generator raises ``ValueError``: JAX's deterministic mode
    (``key=None``) has no points to draw either."""
    if generator is None:
        raise ValueError("total_variation_loss needs a generator: the "
                         "deterministic mode draws no points")
    x01 = torch.rand(n_samples, spec.input_dim, generator=generator,
                     device=params.device)
    return total_variation_at(params, spec, x01)
