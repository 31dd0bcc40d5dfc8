"""The NGP radiance field: hash grid + bias-free MLPs + SH view encoding
(port of ``raw_ngp_tpu/models/ngp.py``: ``FieldSpec``, ``make_field_spec``,
``init_field``, ``_common_forward``, ``field_density``, ``field_forward``).

``NGPField`` is an ``nn.Module`` whose parameters keep the JAX pytree's
layout: a flat hash table ``grid`` [n_params*C] and MLP weights [in, out].
It is differentiable in its parameters: the encode's table gradient is the
fused backward of :mod:`raw_ngp_torch.kernels.hash_encode`, the MLPs'
bf16 emulation rounds gradients where JAX's bf16 ``dot_general``
transposes do (an f32 product converted to bf16).
Only the occupancy-mode field with ``pose_opt.mode == "none"`` and no
light conditioning is ported; the other modes raise.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from raw_ngp_torch.config import Config
from raw_ngp_torch.device import resolve_device
from raw_ngp_torch.kernels.hash_encode import hash_encode, hash_encode_plain
from raw_ngp_torch.models.mlp import apply_mlp, init_mlp
from raw_ngp_torch.ops.activation import color_activation, density_activation
from raw_ngp_torch.ops.hashgrid import HashGridSpec, init_hashgrid_params
from raw_ngp_torch.ops.sh import sh_encode


@dataclass(frozen=True)
class FieldSpec:
    """Static companion of the field's parameters."""

    cfg: Config
    grid_spec: HashGridSpec

    @property
    def compute_dtype(self):
        """bf16 MLP and encode arithmetic under ``train.fp16``."""
        return torch.bfloat16 if self.cfg.train.fp16 else torch.float32

    @property
    def encode_dtype(self):
        """The fused encoder computes in the compute dtype; the plain
        encoder of ``fused_encoder=False`` in the table's f32."""
        return (self.compute_dtype if self.cfg.model.fused_encoder
                else torch.float32)


def make_field_spec(cfg: Config) -> FieldSpec:
    m = cfg.model
    if not cfg.render.occupancy:
        raise NotImplementedError("raw_ngp_torch ports the occupancy-grid "
                                  "field only (no proposal networks yet)")
    if m.rfield or cfg.pose_opt.mode != "none":
        raise NotImplementedError("rfield and pose refinement are not "
                                  "ported yet")
    grid_spec = HashGridSpec.create(
        input_dim=3, num_levels=m.num_levels, level_dim=m.level_dim,
        log2_hashmap_size=m.log2_hashmap_size,
        desired_resolution=cfg.desired_resolution,
        gridtype=m.gridtype, interpolation=m.interpolation,
        align_corners=m.align_corners, hash_variant=m.hash_variant)
    return FieldSpec(cfg=cfg, grid_spec=grid_spec)


class NGPField(nn.Module):
    """Hash grid -> grid MLP -> (sigma, feature); feature + SH(dir) ->
    view MLP -> color."""

    def __init__(self, spec: FieldSpec, grid: torch.Tensor, grid_mlp,
                 view_mlp):
        super().__init__()
        self.spec = spec
        self.grid = nn.Parameter(grid)
        self.grid_mlp = nn.ParameterList(grid_mlp)
        self.view_mlp = nn.ParameterList(view_mlp)

    def _common(self, x, plain: bool):
        cfg = self.spec.cfg
        m = cfg.model
        x01 = (x + cfg.grid_bound) / (2.0 * cfg.grid_bound)
        encode = hash_encode_plain if plain else hash_encode
        f = encode(self.grid, x01, self.spec.grid_spec,
                   compute_dtype=self.spec.encode_dtype)
        h = apply_mlp(list(self.grid_mlp), f, m.internal_activation, m.beta,
                      self.spec.compute_dtype)
        sigma = density_activation(h[..., 0], m.density_activation, m.beta)
        return sigma, h[..., 1:]

    def density(self, x, plain: bool = False):
        """sigma [N] at world positions x [N, 3] (``field_density``)."""
        return self._common(x, plain)[0]

    def forward(self, x, d, plain: bool = False):
        """(sigma [N], color [N, 3]) at positions x [N, 3] seen along
        unit directions d [N, 3] (``field_forward``). ``plain=True`` runs
        the encode's plain version instead of its kernel."""
        m = self.spec.cfg.model
        sigma, feat = self._common(x, plain)
        h = torch.cat([feat, sh_encode(d, m.sh_degree)], dim=-1)
        c = apply_mlp(list(self.view_mlp), h, m.internal_activation, m.beta,
                      self.spec.compute_dtype)
        return sigma, color_activation(c, m.color_activation)


def init_field(spec: FieldSpec, seed: int = 0, device="cuda") -> NGPField:
    """Random field from ``seed``: U(±1e-4) table, Kaiming-uniform MLPs.
    (Different numbers from the JAX init of the same seed: tests carry
    JAX parameters across with :mod:`raw_ngp_torch.convert`.)"""
    dev = resolve_device(device)
    # f32 products must stay f32 on the card (PyTorch's default; set here
    # so a caller's global TF32 switch cannot change the field's numbers)
    torch.backends.cuda.matmul.allow_tf32 = False
    m = spec.cfg.model
    gen = torch.Generator().manual_seed(seed)
    sh_dim = m.sh_degree ** 2
    grid = init_hashgrid_params(spec.grid_spec, gen)
    grid_mlp = init_mlp(gen, spec.grid_spec.output_dim, m.grid_mlp_out,
                        m.grid_mlp_hidden, m.grid_mlp_layers)
    view_mlp = init_mlp(gen, (m.grid_mlp_out - 1) + sh_dim, 3,
                        m.view_mlp_hidden, m.view_mlp_layers)
    return NGPField(spec, grid, grid_mlp, view_mlp).to(dev)
