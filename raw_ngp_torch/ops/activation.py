"""Density / color / hidden activations (port of
``raw_ngp_tpu/ops/activation.py``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


class _TruncExp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.exp(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * torch.exp(torch.clamp(x, -15.0, 15.0))


def trunc_exp(x):
    """exp whose backward clamps the saved input to [-15, 15]
    (``trunc_exp`` ``:13-35``): g * exp(clip(x, -15, 15))."""
    return _TruncExp.apply(x)


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
