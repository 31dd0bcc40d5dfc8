"""The NGP radiance field: hash grid + bias-free MLPs + SH view encoding
(port of ``raw_ngp_tpu/models/ngp.py``: ``FieldSpec``, ``make_field_spec``,
``init_field``, the BARF / BAA-NGP annealing ``_anneal_alpha``,
``barf_level_weights`` and ``baangp_blend``, ``_common_forward``,
``field_density``, ``field_forward``, ``field_normals``).

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

``model.fused_encoder`` False runs every grid through the plain encoder
:func:`raw_ngp_torch.ops.hashgrid.hash_encode` (JAX's ``hash_encode``, in
the table's f32) on every device, its gradients autograd's of plain ops.
:meth:`NGPField.density_grad` is the orientation loss's inner gradient,
kept in the graph of the parameters: through the fused encoder JAX's
frozen-table input gradient (:func:`raw_ngp_torch.kernels.hash_encode.
frozen_input_grad`), through the unfused one the full second order.

Under tensor parallelism (a spec with ``tp_devices`` > 1, made by
:func:`raw_ngp_torch.parallel.tp.tp_spec`) ``grid`` holds this rank's
channel shard, the flat table of the same grid at C / tp channels: the
radiance grid encodes the shard with the shard's spec and gathers the
channels over the tp group (JAX ``_encode``'s tp branch, ``ngp.py:176-
194``), so every rank of the group gets the unsharded encode's features.
The normals' position gradient is summed over the group and divided by
tp (each rank's covers its shard, tp times over). The orientation loss's
inner gradient is the single device's too (:meth:`NGPField.
density_grad`): each rank takes its shard's share and the shares are
summed over the group with their graph (:func:`raw_ngp_torch.parallel.
tp.sum_over_tp`), so every rank computes the same loss. JAX's tp step
sums nothing there, and its gradient departs from its single device's.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Optional, Tuple

import numpy as np
import torch
from torch import nn

from raw_ngp_torch.config import Config
from raw_ngp_torch.device import resolve_device
from raw_ngp_torch.kernels.hash_encode import (frozen_input_grad,
                                              hash_encode, hash_encode_plain)
from raw_ngp_torch.models.mlp import apply_mlp, init_mlp
from raw_ngp_torch.ops.activation import (color_activation,
                                          density_activation, trunc_exp)
from raw_ngp_torch.ops import hashgrid
from raw_ngp_torch.parallel import tp as ptp
from raw_ngp_torch.ops.hashgrid import HashGridSpec, init_hashgrid_params
from raw_ngp_torch.ops.sh import sh_encode


@dataclass(frozen=True)
class FieldSpec:
    """Static companion of the field's parameters."""

    cfg: Config
    grid_spec: HashGridSpec
    # the proposal networks' grids (none on the occupancy path)
    prop_specs: Tuple[HashGridSpec, ...] = ()
    # tensor parallelism: the radiance grid's channels sharded over the
    # process group tp_group of tp_devices ranks (parallel/tp.tp_spec)
    tp_group: Any = dataclasses.field(default=None, compare=False)
    tp_devices: int = 1

    @property
    def compute_dtype(self):
        """bf16 MLP and fused-encode arithmetic under ``train.fp16``."""
        return torch.bfloat16 if self.cfg.train.fp16 else torch.float32

    def __deepcopy__(self, memo):
        # immutable, and a process group does not copy: a copied field
        # shares its spec
        return self


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

@dataclass(frozen=True)
class DeviceAnnealing:
    """A train step's annealing on the device, read from host-built tables
    at the step's device counter (:class:`raw_ngp_torch.train.scalars.
    AnnealingTables`), so that a captured step anneals as the step it
    replays: the ramp position ``alpha`` (0-d f32, the bits of
    :func:`_anneal_alpha`) of ramp length ``L`` and, for BAA-NGP, the
    finest active level ``j_star`` (0-d int64)."""

    L: int
    alpha: torch.Tensor
    j_star: Optional[torch.Tensor] = None


def _anneal_alpha(cfg: Config, annealing, L: int):
    """The ramp position, an f32 host scalar: JAX computes it from an f32
    annealing with the config's numbers taken as f32. A
    :class:`DeviceAnnealing` gives its own (a 0-d device tensor)."""
    if isinstance(annealing, DeviceAnnealing):
        if annealing.L != L:
            raise ValueError(f"annealing tables of ramp length "
                             f"{annealing.L}, the field's ramp is {L}")
        return annealing.alpha
    f32 = np.float32
    start, end = cfg.pose_opt.start_annealing, cfg.pose_opt.end_annealing
    if end == 0:
        end = 1e-12
    return (f32(annealing) - f32(start)) / f32(end - start) * f32(L)


def _cosine_ramp(alpha, L: int, device):
    """(1 - cos(clip(alpha - k, 0, 1) * pi)) / 2 for levels k < L, f32;
    ``alpha`` a host scalar or a 0-d device tensor (the same f32 ops)."""
    k = torch.arange(L, dtype=torch.float32, device=device)
    a = alpha if torch.is_tensor(alpha) else float(alpha)
    return (1.0 - torch.cos(torch.clamp(a - k, 0.0, 1.0)
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
    does (``weights[:2] = 1``): two features, not two levels. Under a
    :class:`DeviceAnnealing` the finest active level is gathered at its
    device index."""
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
    if isinstance(annealing, DeviceAnnealing):
        coarse = feats.unflatten(-1, (L_levels, C)).index_select(
            -2, annealing.j_star.reshape(1)).flatten(-2)
    else:
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

    def _x01(self, x):
        b = self.spec.cfg.grid_bound
        return (x + b) / (2.0 * b)

    def _encode(self, table, x, grid_spec, plain: bool):
        """Grid features of world positions x (``_encode``): the fused
        encoder (its kernel, or with ``plain`` its plain version) in the
        compute dtype, or under ``fused_encoder=False`` the plain encoder
        in f32 on every device; the radiance grid under tensor parallelism
        as the shard's encode gathered over the tp group."""
        spec = self.spec
        if spec.tp_devices > 1 and grid_spec is spec.grid_spec:
            f = self._encode(table, x, ptp.local_grid_spec(
                grid_spec, spec.tp_devices), plain)
            return ptp.gather_channels(f, grid_spec.num_levels,
                                       spec.tp_group, spec.tp_devices)
        cfg = spec.cfg
        if not cfg.model.fused_encoder:
            return hashgrid.hash_encode(table, x, grid_spec,
                                        bound=cfg.grid_bound)
        encode = hash_encode_plain if plain else hash_encode
        return encode(table, self._x01(x), grid_spec,
                      compute_dtype=self.spec.compute_dtype)

    def _head(self, f, annealing):
        """(sigma, feature) from the grid features f: the BARF / BAA-NGP
        level blend, the grid MLP and the density activation."""
        cfg = self.spec.cfg
        m = cfg.model
        if cfg.pose_opt.mode == "baangp":
            f = baangp_blend(cfg, annealing, f)
        elif cfg.pose_opt.mode == "barf":
            f = f.float() * barf_level_weights(cfg, annealing, f.device)
        h = apply_mlp(list(self.grid_mlp), f, m.internal_activation, m.beta,
                      self.spec.compute_dtype)
        sigma = density_activation(h[..., 0], m.density_activation, m.beta)
        return sigma, h[..., 1:]

    def _common(self, x, plain: bool, annealing):
        return self._head(self._encode(self.grid, x, self.spec.grid_spec,
                                       plain), annealing)

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

    def normals(self, x, plain: bool = False, annealing=1.0):
        """Analytic normals at positions x [N, 3] (``field_normals``,
        ``ngp.py:261``): -normalize(d sum(sigma) / dx) mapped to [0, 1].
        The gradient is taken for the positions alone (the parameters
        collect no ``.grad``), also where the caller runs under
        ``no_grad`` or ``inference_mode``; on the card its backward is the
        encode's input-gradient kernel."""
        with torch.inference_mode(False), torch.enable_grad():
            x = x.detach().clone().requires_grad_(True)
            sigma = self.density(x, plain=plain, annealing=annealing)
            (g,) = torch.autograd.grad(sigma.sum(), x)
        if self.spec.tp_devices > 1:
            import torch.distributed as dist
            dist.all_reduce(g, group=self.spec.tp_group)
            g = g / self.spec.tp_devices
        n = -g / (torch.linalg.norm(g, dim=-1, keepdim=True) + 1e-9)
        return (n + 1.0) / 2.0

    def density_grad(self, x, plain: bool = False, annealing=1.0):
        """d sum(sigma) / dx [N, 3] at positions x [N, 3] taken as constants
        (JAX's ``jax.grad`` of the density inside the orientation loss,
        ``occupancy.py:999-1003``), in the graph of the parameters so that
        a loss of it differentiates a second time. Through the fused
        encoder as JAX's ``_fused_bwd`` composes it: g = d sum(sigma) /
        d(features) with its graph (the MLP, the activation, the level
        blend), then the encode's input gradient for g with the table
        frozen (:func:`frozen_input_grad`; its backward the JVP kernel), so
        the step computes no table gradient here. Through the unfused
        encoder autograd's full second order of plain ops.

        Under tensor parallelism the single device's gradient on every
        rank of the group. Fused: the shard encoded at its own spec and
        gathered, g taken on the gathered features, this rank's channels
        of g (:func:`~raw_ngp_torch.parallel.tp.split_channels`) through
        the shard's frozen input gradient (the kernels at C / tp), the
        shares summed over the group. Unfused: autograd's second order
        through the gather (whose backward is differentiable), each
        rank's share n_tp times its own (the gather's backward sums n_tp
        equal cotangents), averaged over the group. The step's
        reduction then holds (:func:`~raw_ngp_torch.parallel.mesh.
        make_reduce`): the replicated leaves get the single device's
        gradient, the shard n_tp times its own."""
        spec = self.spec
        cfg, n_tp, group = spec.cfg, spec.tp_devices, spec.tp_group
        x = x.detach()
        if not cfg.model.fused_encoder:
            x.requires_grad_(True)
            sigma = self.density(x, plain=plain, annealing=annealing)
            g = torch.autograd.grad(sigma.sum(), x, create_graph=True)[0]
            if n_tp > 1:
                g = ptp.sum_over_tp(g, group, n_tp, scale=1.0 / n_tp)
            return g
        x01 = self._x01(x)
        dtype = spec.compute_dtype
        gs = spec.grid_spec
        if n_tp > 1:
            gs = ptp.local_grid_spec(gs, n_tp)
        f = (hash_encode_plain if plain else hash_encode)(
            self.grid, x01, gs, compute_dtype=dtype)
        if not f.requires_grad:   # a field whose table takes no gradient
            f.requires_grad_(True)
        if n_tp > 1:
            f = ptp.gather_channels(f, gs.num_levels, group, n_tp)
        sigma, _ = self._head(f, annealing)
        (g,) = torch.autograd.grad(sigma.sum(), f, create_graph=True)
        if n_tp > 1:
            g = ptp.split_channels(g, gs.num_levels, group, n_tp)
        g01 = frozen_input_grad(self.grid, x01, g, gs, dtype, plain=plain)
        if n_tp > 1:
            g01 = ptp.sum_over_tp(g01, group, n_tp)
        return g01 / (2.0 * cfg.grid_bound)

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
