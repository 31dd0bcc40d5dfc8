"""Bias-free MLP heads (port of ``raw_ngp_tpu/models/mlp.py``).

Weights are stored ``[in, out]`` in f32, as in the JAX pytree. Under a
bf16 compute dtype the JAX path rounds inputs and weights to bf16 and
accumulates in f32 with an f32 result; a torch bf16 matmul would return
bf16, so here both operands are rounded to bf16 and multiplied in f32
(with TF32 off, see ``apply_mlp``).
"""

from __future__ import annotations

import math
from typing import List, Sequence

import torch

from raw_ngp_torch.ops.activation import internal_activation


def init_mlp(generator: torch.Generator, dim_in: int, dim_out: int,
             dim_hidden: int, num_layers: int) -> List[torch.Tensor]:
    """Kaiming-uniform weights [in, out] as torch.nn.Linear's default init
    (U(±sqrt(3)/sqrt(fan_in)))."""
    dims = [dim_in] + [dim_hidden] * (num_layers - 1) + [dim_out]
    ws = []
    for l in range(num_layers):
        lim = math.sqrt(3.0) / math.sqrt(dims[l])
        u = torch.rand(dims[l], dims[l + 1], generator=generator,
                       dtype=torch.float32)
        ws.append(u * (2.0 * lim) - lim)
    return ws


def _round(x, compute_dtype):
    if compute_dtype == torch.float32:
        return x.float()
    return x.to(compute_dtype).float()


def apply_mlp(weights: Sequence[torch.Tensor], x, activation: str = "relu",
              beta: float = 2.0, compute_dtype=torch.float32):
    """Forward pass; hidden activation after all but the last layer.
    Returns f32. TF32 must be off for the f32 products to be f32
    (``torch.backends.cuda.matmul.allow_tf32 = False``, PyTorch's
    default; the field sets it)."""
    h = _round(x, compute_dtype)
    n = len(weights)
    for l, w in enumerate(weights):
        h = h @ _round(w, compute_dtype)
        if l != n - 1:
            h = _round(internal_activation(h, activation, beta=beta),
                       compute_dtype)
    return h
