"""NeRF positional (frequency) encoding (port of ``raw_ngp_tpu/ops/freq.py``):
per input dim [x, sin(2^0 x), ..., sin(2^{F-1} x), cos(2^0 x), ...,
cos(2^{F-1} x)], the layout of JAX's ``freq_encode``."""

from __future__ import annotations

import torch


def freq_encode(x, degree: int = 12, include_input: bool = True):
    """[..., D] -> [..., D * (2 * degree + include_input)]."""
    freqs = 2.0 ** torch.arange(degree, dtype=x.dtype, device=x.device)
    xb = x[..., None] * freqs                                 # [..., D, F]
    enc = torch.cat([torch.sin(xb), torch.cos(xb)], dim=-1)   # [..., D, 2F]
    enc = enc.reshape(*x.shape[:-1], -1)
    if include_input:
        enc = torch.cat([x, enc], dim=-1)
    return enc


def freq_output_dim(input_dim: int, degree: int = 12,
                    include_input: bool = True) -> int:
    return input_dim * (2 * degree + (1 if include_input else 0))
