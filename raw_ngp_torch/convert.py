"""Carry JAX parameters and grid state across to the port.

The JAX param pytree (as numpy arrays) has a flat hash table ``grid``
[n_params*C] (ops/hashgrid.py:113-125) and bias-free MLP layers
``{"w": [in, out]}`` (models/mlp.py:32, models/ngp.py:96-104); the port
keeps both layouts, so conversion is a copy; on the proposal path the
pytree's ``prop_grids`` and ``prop_mlps`` lists carry across the same
way. Under pose refinement the
JAX state's ``pose_params`` [n, 6] and ``pose_noise`` [n, 3, 4] carry
across the same way (:func:`pose_from_jax`).
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from raw_ngp_torch.device import resolve_device
from raw_ngp_torch.models.ngp import FieldSpec, NGPField


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def field_from_jax(params: Dict[str, Any], spec: FieldSpec,
                   device="cuda") -> NGPField:
    """NGPField holding the JAX pytree's values (numpy leaves)."""
    mlps = [params["grid_mlp"], params["view_mlp"],
            *params.get("prop_mlps", ())]
    if any("b" in layer for mlp in mlps for layer in mlp):
        raise ValueError("biased MLP layers are not ported")
    grids = [_t(g).reshape(-1) for g in (params["grid"],
                                         *params.get("prop_grids", ()))]
    specs = (spec.grid_spec, *spec.prop_specs)
    if len(grids) != len(specs) or any(
            g.numel() != gs.n_params * gs.level_dim
            for g, gs in zip(grids, specs)):
        raise ValueError("grid sizes do not match the field spec")
    w = [[_t(layer["w"]) for layer in mlp] for mlp in mlps]
    field = NGPField(spec, grids[0], w[0], w[1], grids[1:], w[2:])
    return field.to(resolve_device(device))


def bitfield_from_jax(density_bitfield, device="cuda") -> torch.Tensor:
    """The port's density bitfield ([CAS*H^3/8] u8, same bit order) from
    the JAX grid state's ``density_bitfield``."""
    return torch.from_numpy(
        np.array(density_bitfield, dtype=np.uint8, copy=True)).to(
            resolve_device(device))


def pose_from_jax(pose_params, pose_noise=None, device="cuda"):
    """(pose_params [n, 6] f32 leaf that requires a gradient, pose_noise
    [n, 3, 4] f32 or None) from the JAX state's numpy values, for a port
    ``TrainState``."""
    dev = resolve_device(device)
    pose = _t(pose_params)
    if pose.ndim != 2 or pose.shape[1] != 6:
        raise ValueError(f"pose_params must be [n, 6], got {tuple(pose.shape)}")
    noise = None
    if pose_noise is not None:
        noise = _t(pose_noise).to(dev)
        if tuple(noise.shape) != (pose.shape[0], 3, 4):
            raise ValueError("pose_noise must be [n, 3, 4] for n cameras")
    return pose.to(dev).requires_grad_(), noise
