"""The NGP radiance field: hash grid + bias-free MLPs + SH view encoding
(port of ``raw_ngp_tpu/models/ngp.py``: ``FieldSpec``, ``make_field_spec``,
``init_field``, the BARF / BAA-NGP annealing ``_anneal_alpha``,
``barf_level_weights`` and ``baangp_blend``, ``_common_forward``,
``field_density``, ``field_forward``).

``NGPField`` is an ``nn.Module`` whose parameters keep the JAX pytree's
layout: a flat hash table ``grid`` [n_params*C] and MLP weights [in, out].
It is differentiable in its parameters and in the positions: the encode's
table and input gradients are the fused backward of
:mod:`raw_ngp_torch.kernels.hash_encode`, the MLPs' bf16 emulation rounds
gradients where JAX's bf16 ``dot_general`` transposes do (an f32 product
converted to bf16). JAX's static ``FieldSpec.needs_input_grads`` has no
counterpart: autograd sees per call whether the positions need a gradient
(the encode's ``ctx.needs_input_grad``). The occupancy-mode field is
ported, with or without light conditioning (``model.rfield``: SH(ld)
after SH(d) at the view MLP's input, which is ``ldir_dim`` wider, as is
its hidden width), and so are the proposal networks of the proposal path
(``render.occupancy`` False): one small hash grid and bias-free density
MLP per entry of ``model.prop_resolutions``, queried by
``density(x, proposal=i)`` with ``trunc_exp`` on the MLP's output.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch
from torch import nn

from raw_ngp_torch.config import Config
from raw_ngp_torch.device import resolve_device
from raw_ngp_torch.kernels.hash_encode import hash_encode, hash_encode_plain
from raw_ngp_torch.models.mlp import apply_mlp, init_mlp
from raw_ngp_torch.ops.activation import (color_activation,
                                          density_activation, trunc_exp)
from raw_ngp_torch.ops.hashgrid import HashGridSpec, init_hashgrid_params
from raw_ngp_torch.ops.sh import sh_encode


@dataclass(frozen=True)
class FieldSpec:
    """Static companion of the field's parameters."""

    cfg: Config
    grid_spec: HashGridSpec
    # the proposal networks' grids (none on the occupancy path)
    prop_specs: Tuple[HashGridSpec, ...] = ()

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
    grid_spec = HashGridSpec.create(
        input_dim=3, num_levels=m.num_levels, level_dim=m.level_dim,
        log2_hashmap_size=m.log2_hashmap_size,
        desired_resolution=cfg.desired_resolution,
        gridtype=m.gridtype, interpolation=m.interpolation,
        align_corners=m.align_corners, hash_variant=m.hash_variant)
    prop_specs = tuple(
        HashGridSpec.create(
            input_dim=3, num_levels=m.prop_num_levels,
            level_dim=m.prop_level_dim,
            log2_hashmap_size=m.prop_log2_hashmap_size,
            desired_resolution=res)
        for res in m.prop_resolutions) if not cfg.render.occupancy else ()
    return FieldSpec(cfg=cfg, grid_spec=grid_spec, prop_specs=prop_specs)


# ---------------------------------------------------------------------------
# coarse-to-fine annealing (BARF / BAA-NGP)
# ---------------------------------------------------------------------------

def _anneal_alpha(cfg: Config, annealing, L: int):
    """The ramp position, an f32 host scalar: JAX computes it from an f32
    annealing with the config's numbers taken as f32."""
    f32 = np.float32
    start, end = cfg.pose_opt.start_annealing, cfg.pose_opt.end_annealing
    if end == 0:
        end = 1e-12
    return (f32(annealing) - f32(start)) / f32(end - start) * f32(L)


def _cosine_ramp(alpha, L: int, device):
    """(1 - cos(clip(alpha - k, 0, 1) * pi)) / 2 for levels k < L, f32."""
    k = torch.arange(L, dtype=torch.float32, device=device)
    return (1.0 - torch.cos(torch.clamp(float(alpha) - k, 0.0, 1.0)
                            * math.pi)) / 2.0


def barf_level_weights(cfg: Config, annealing, device=None):
    """BARF cosine level mask over the L * level_dim grid features, the
    first level always on. Returns [L * level_dim] f32."""
    m = cfg.model
    L = m.num_levels
    w = _cosine_ramp(_anneal_alpha(cfg, annealing, L), L, device)
    w = w.repeat_interleave(m.level_dim)
    w[: m.level_dim] = 1.0
    return w


def baangp_blend(cfg: Config, annealing, feats):
    """BAA-NGP: blend the masked-out fine levels with the features of the
    finest *active* level. feats [N, L*C] -> f32 [N, L*C].

    The annealed levels are L - 1 (the reference anneals dim_out - 1). The
    weight vector's first two *features* are forced to 1, as the reference
    does (``weights[:2] = 1``): two features, not two levels."""
    m = cfg.model
    C = m.level_dim
    L_levels = m.num_levels
    L = L_levels - 1
    alpha = _anneal_alpha(cfg, annealing, L)
    w = _cosine_ramp(alpha, L, feats.device)
    weights = torch.cat([torch.ones(C, device=feats.device),
                         w.repeat_interleave(C)])
    weights[:2] = 1.0
    # the finest level with weight > 0 (level 0 always active)
    j_star = min(max(math.ceil(float(alpha)), 0), L_levels - 1)
    coarse = feats[..., j_star * C:(j_star + 1) * C]
    coarse_f = coarse.repeat(*([1] * (feats.ndim - 1)), L_levels)
    return feats.float() * weights + coarse_f.float() * (1.0 - weights)


class NGPField(nn.Module):
    """Hash grid -> grid MLP -> (sigma, feature); feature + SH(dir) ->
    view MLP -> color. On the proposal path also the proposal networks
    (``prop_grids`` [i], ``prop_mlps`` [i]): hash grid -> MLP -> sigma."""

    def __init__(self, spec: FieldSpec, grid: torch.Tensor, grid_mlp,
                 view_mlp, prop_grids=(), prop_mlps=()):
        super().__init__()
        if len(prop_grids) != len(spec.prop_specs) or len(prop_mlps) != len(
                spec.prop_specs):
            raise ValueError("one proposal grid and MLP per proposal spec")
        self.spec = spec
        self.grid = nn.Parameter(grid)
        self.grid_mlp = nn.ParameterList(grid_mlp)
        self.view_mlp = nn.ParameterList(view_mlp)
        self.prop_grids = nn.ParameterList(prop_grids)
        self.prop_mlps = nn.ModuleList(nn.ParameterList(w) for w in prop_mlps)

    def _encode(self, table, x, grid_spec, plain: bool):
        cfg = self.spec.cfg
        x01 = (x + cfg.grid_bound) / (2.0 * cfg.grid_bound)
        encode = hash_encode_plain if plain else hash_encode
        return encode(table, x01, grid_spec,
                      compute_dtype=self.spec.encode_dtype)

    def _common(self, x, plain: bool, annealing):
        cfg = self.spec.cfg
        m = cfg.model
        f = self._encode(self.grid, x, self.spec.grid_spec, plain)
        if cfg.pose_opt.mode == "baangp":
            f = baangp_blend(cfg, annealing, f)
        elif cfg.pose_opt.mode == "barf":
            f = f.float() * barf_level_weights(cfg, annealing, f.device)
        h = apply_mlp(list(self.grid_mlp), f, m.internal_activation, m.beta,
                      self.spec.compute_dtype)
        sigma = density_activation(h[..., 0], m.density_activation, m.beta)
        return sigma, h[..., 1:]

    def density(self, x, plain: bool = False, annealing=1.0,
                proposal: int = -1):
        """sigma [N] at world positions x [N, 3] (``field_density``; the
        grid refresh queries it at the default annealing 1.0).
        ``proposal`` i >= 0 queries proposal network i instead: its grid,
        its MLP and ``trunc_exp`` of the output (no annealing)."""
        if 0 <= proposal < len(self.spec.prop_specs):
            m = self.spec.cfg.model
            f = self._encode(self.prop_grids[proposal], x,
                             self.spec.prop_specs[proposal], plain)
            h = apply_mlp(list(self.prop_mlps[proposal]), f,
                          m.internal_activation, m.beta,
                          self.spec.compute_dtype)
            return trunc_exp(h[..., 0])
        return self._common(x, plain, annealing)[0]

    def forward(self, x, d, ld=None, plain: bool = False, annealing=1.0):
        """(sigma [N], color [N, 3]) at positions x [N, 3] seen along
        unit directions d [N, 3] (``field_forward``); an rfield field also
        takes the light directions ld [N, 3] and raises ``ValueError``
        without them. ``plain=True`` runs the encode's plain version
        instead of its kernel; ``annealing`` (a number in [0, 1]) drives
        the BARF / BAA-NGP level mask."""
        m = self.spec.cfg.model
        sigma, feat = self._common(x, plain, annealing)
        enc = [feat, sh_encode(d, m.sh_degree)]
        if m.rfield:
            if ld is None:
                raise ValueError("rfield mode requires light directions")
            enc.append(sh_encode(ld, m.sh_degree))
        h = torch.cat(enc, dim=-1)
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
    ldir_dim = sh_dim if m.rfield else 0
    grid = init_hashgrid_params(spec.grid_spec, gen)
    grid_mlp = init_mlp(gen, spec.grid_spec.output_dim, m.grid_mlp_out,
                        m.grid_mlp_hidden, m.grid_mlp_layers)
    # the view MLP widens by ldir_dim in rfield mode, input and hidden
    view_mlp = init_mlp(gen, (m.grid_mlp_out - 1) + sh_dim + ldir_dim, 3,
                        m.view_mlp_hidden + ldir_dim, m.view_mlp_layers)
    prop_grids = [init_hashgrid_params(ps, gen) for ps in spec.prop_specs]
    prop_mlps = [init_mlp(gen, ps.output_dim, 1, m.prop_mlp_hidden,
                          m.prop_mlp_layers) for ps in spec.prop_specs]
    return NGPField(spec, grid, grid_mlp, view_mlp, prop_grids,
                    prop_mlps).to(dev)
