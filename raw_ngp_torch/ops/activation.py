"""Density / color / hidden activations, forward only (port of
``raw_ngp_tpu/ops/activation.py``). The ±15 clamped backward of
``trunc_exp`` comes with the training slice."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def trunc_exp(x):
    """exp; its clamped backward is not ported yet (forward only)."""
    return torch.exp(x)


def softplus_beta(x, beta: float = 2.0, threshold: float = 20.0):
    """softplus with beta and a linear region above ``threshold``."""
    scaled = beta * x
    return torch.where(scaled > threshold, x, F.softplus(scaled) / beta)


def density_activation(x, kind: str, beta: float = 2.0):
    if kind == "clamped_exp":
        return trunc_exp(x)
    if kind == "softplus":
        return softplus_beta(x, beta=beta)
    raise ValueError(f"unknown density activation {kind!r}")


def color_activation(x, kind: str):
    if kind == "exp":
        return torch.exp(x - 5.0)
    if kind == "sigmoid":
        return torch.sigmoid(x)
    if kind == "clamped_exp":
        return torch.clamp_max(torch.exp(x - 5.0), 5.0)
    raise ValueError(f"unknown color activation {kind!r}")


def internal_activation(x, kind: str, beta: float = 2.0):
    if kind == "relu":
        return torch.relu(x)
    if kind == "softplus":
        return softplus_beta(x, beta=beta)
    raise ValueError(f"unknown internal activation {kind!r}")
