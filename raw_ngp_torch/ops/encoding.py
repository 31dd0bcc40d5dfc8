"""Encoder factory (port of ``raw_ngp_tpu/ops/encoding.py``
``get_encoder``): name-keyed construction of direction and position
encoders.

Returns ``(encode_fn, output_dim, state)``: the stateless encoders
(identity, frequency, sh) give ``state`` None; the grid encoders give
(HashGridSpec, table), a table the caller owns, drawn from an explicit
``torch.Generator`` (JAX takes a key; the streams differ).
"""

from __future__ import annotations

from typing import Optional

import torch

from raw_ngp_torch.device import resolve_device
from raw_ngp_torch.ops.freq import freq_encode, freq_output_dim
from raw_ngp_torch.ops.hashgrid import (HashGridSpec, hash_encode,
                                        init_hashgrid_params)
from raw_ngp_torch.ops.sh import sh_encode, sh_output_dim


def get_encoder(name: Optional[str], input_dim: int = 3, *,
                degree: int = 4, freq_degree: int = 12,
                num_levels: int = 16, level_dim: int = 2,
                base_resolution: int = 16, log2_hashmap_size: int = 19,
                desired_resolution: Optional[float] = 2048,
                interpolation: str = "linear",
                generator: Optional[torch.Generator] = None,
                device="cuda"):
    """An encoder by name: None | 'none' | 'frequency' (or
    'frequency_torch') | 'sh' | 'hashgrid' | 'tiledgrid'. A grid's table
    comes from ``generator`` (default one seeded 0) and lives on
    ``device`` (the card unless the caller names the CPU); its encode is
    the plain :func:`raw_ngp_torch.ops.hashgrid.hash_encode`. Any other
    name raises ``ValueError``."""
    if name is None or name == "none":
        return (lambda x, **kw: x), input_dim, None

    if name in ("frequency", "frequency_torch"):
        def enc(x, **kw):
            return freq_encode(x, degree=freq_degree)
        return enc, freq_output_dim(input_dim, freq_degree), None

    if name == "sh":
        def enc(d, **kw):
            return sh_encode(d, degree=degree)
        return enc, sh_output_dim(degree), None

    if name in ("hashgrid", "tiledgrid"):
        spec = HashGridSpec.create(
            input_dim=input_dim, num_levels=num_levels,
            level_dim=level_dim, base_resolution=base_resolution,
            log2_hashmap_size=log2_hashmap_size,
            desired_resolution=desired_resolution,
            gridtype="hash" if name == "hashgrid" else "tiled",
            interpolation=interpolation)
        gen = generator if generator is not None else \
            torch.Generator().manual_seed(0)
        params = init_hashgrid_params(spec, gen,
                                      device=resolve_device(device))

        def enc(x, params=params, bound: float = 1.0, **kw):
            return hash_encode(params, x, spec, bound=bound)

        return enc, spec.output_dim, (spec, params)

    raise ValueError(f"unknown encoder {name!r}")
