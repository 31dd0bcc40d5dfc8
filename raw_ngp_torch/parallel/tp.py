"""Tensor parallelism over the hash table's channel axis, composed with
ray-batch data parallelism on a (dp, tp) layout of ranks (port of
``raw_ngp_tpu/parallel/tp.py``: ``make_tp_mesh`` ``:50``, ``grid_to_2d``
and ``state_pspecs`` ``:57-84``, ``place_state_tp`` ``:87``,
``make_tp_train_step`` ``:97-215``).

The row math of the hash encode (hashing, windows, interpolation weights)
never reads the channel axis, so the [n_params, C] table shards on C: tp
rank j of a row owns channels [j*C/tp, (j+1)*C/tp) of every row, kept as
the flat [n_params * C/tp] table of a ``level_dim = C/tp`` grid. Each rank
encodes its shard with the same kernels at the shard's width, and one
all-gather of [B, L, C/tp] over the row (:func:`gather_channels`)
assembles the [B, L*C] features of the unsharded encode, bit for bit. Its
backward sums each channel block's cotangent over the row (JAX's
``psum_scatter``): every rank of a row computes the same loss from the
same features, so the raw table gradient comes out n_tp times too large
and the step divides it (:func:`raw_ngp_torch.parallel.mesh.make_reduce`).
The MLPs are small and replicated, their work done again on every rank of
a row. Only the dp index picks a rank's rays (its batch stream), so the
ranks of a row render the same rays.

The orientation loss differentiates the density's position gradient a
second time, so the gather's backward is itself differentiable
(:class:`_ReduceScatterChannels`, whose backward is the all-gather), and
two more collectives carry its inner gradient: :func:`split_channels`
(this rank's channels of a replicated [B, L*C]) and :func:`sum_over_tp`
(the ranks' shares of d sum(sigma) / dx added in rank order). With
them every rank computes the single device's loss and the step's
reduction gives the single device's gradient
(:meth:`raw_ngp_torch.models.ngp.NGPField.density_grad`).

Only the table, its EMA and its two Adam moments shard (``SHARDED``);
everything else is replicated. Checkpoints hold the whole flat table
(:func:`gather_table` on the way out, :func:`shard_of` on the way in), so a
file written on one layout loads on any other.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist
from torch import nn

from raw_ngp_torch.parallel.mesh import Mesh, make_parallel_train_step

# the state tensors of the radiance grid's table, by checkpoint key: they
# shard on the channel axis (``state_pspecs``); every other one is
# replicated
SHARDED = ("params.grid", "ema_params.grid", "opt_state.mu.grid",
           "opt_state.nu.grid")


def make_tp_mesh(n_dp: int, n_tp: int) -> Mesh:
    """The (dp, tp) layout of the default process group (n_dp * n_tp
    ranks, tp innermost: rank = dp * n_tp + tp): one tp group a dp row and
    one dp group a tp column. Every rank builds every group, in one
    order."""
    if not dist.is_initialized():
        raise RuntimeError("make_tp_mesh: torch.distributed has no "
                           "initialized process group")
    if dist.get_world_size() != n_dp * n_tp:
        raise ValueError(f"make_tp_mesh: ({n_dp}, {n_tp}) needs "
                         f"{n_dp * n_tp} ranks, the process group has "
                         f"{dist.get_world_size()}")
    rank = dist.get_rank()
    tp_group = dp_group = None
    for r in range(n_dp):
        g = dist.new_group([r * n_tp + j for j in range(n_tp)])
        if rank // n_tp == r:
            tp_group = g
    for j in range(n_tp):
        g = dist.new_group([r * n_tp + j for r in range(n_dp)])
        if rank % n_tp == j:
            dp_group = g
    return Mesh(n_dp=n_dp, n_tp=n_tp, rank=rank, dp_group=dp_group,
                tp_group=tp_group)


def tp_spec(spec, mesh: Mesh):
    """The field spec whose radiance grid encodes channel-sharded over
    ``mesh``'s tp group (:meth:`raw_ngp_torch.models.ngp.NGPField.
    _encode`)."""
    return dataclasses.replace(spec, tp_group=mesh.tp_group,
                               tp_devices=mesh.n_tp)


def local_grid_spec(grid_spec, n_tp: int):
    """The spec of one rank's shard: the same grid at C / n_tp channels,
    its dense (matmul) levels those of the whole table (the fused
    encoder's split depends on the channel count: at the whole table's,
    every level takes the unsharded encode's path, bf16 rounding chain
    included, so the gathered features are its bits)."""
    C = grid_spec.level_dim
    if C % n_tp:
        raise ValueError(f"level_dim {C} does not divide by tp {n_tp}")
    return dataclasses.replace(
        grid_spec, level_dim=C // n_tp,
        split_level_dim=grid_spec.split_level_dim or C)


def shard_of(table: torch.Tensor, grid_spec, n_tp: int, j: int):
    """Channels [j*C/n_tp, (j+1)*C/n_tp) of every row of the flat table
    [n_params * C], as a flat contiguous [n_params * C/n_tp] (``grid_to_2d``
    and the channel slice of ``place_state_tp``)."""
    C = grid_spec.level_dim
    c = C // n_tp
    return table.reshape(-1, C)[:, j * c:(j + 1) * c].contiguous().reshape(-1)


def gather_table(shard: torch.Tensor, grid_spec, mesh: Mesh) -> torch.Tensor:
    """The whole flat table [n_params * C] from the row's shards, on every
    rank of the row (the inverse of :func:`shard_of`)."""
    parts = [torch.empty_like(shard) for _ in range(mesh.n_tp)]
    dist.all_gather(parts, shard.contiguous(), group=mesh.tp_group)
    n = grid_spec.n_params
    return torch.cat([p.reshape(n, -1) for p in parts], dim=1).reshape(-1)


@torch.no_grad()
def place_state_tp(field, state, mesh: Mesh):
    """Keep this rank's channel shard of the table, its EMA and its Adam
    moments (``place_state_tp``), in place: the field's ``grid`` becomes a
    new parameter holding the shard, and the state's dicts take it and the
    sharded EMA and moments. Returns (field, state)."""
    gs = field.spec.grid_spec
    j, n = mesh.tp_rank, mesh.n_tp
    field.grid = nn.Parameter(shard_of(field.grid.detach(), gs, n, j))
    state.params["grid"] = field.grid
    for d in (state.ema_params, state.opt_state.mu, state.opt_state.nu):
        d["grid"] = shard_of(d["grid"], gs, n, j)
    return field, state


class _GatherChannels(torch.autograd.Function):
    """[B, L*c] shard features -> [B, L*c*n] whole ones over the tp group,
    rank j's block at channels [j*c, (j+1)*c) of every level; backward:
    :class:`_ReduceScatterChannels` of the cotangent, itself differentiable
    (the orientation loss differentiates this backward again)."""

    @staticmethod
    def forward(ctx, f, levels, group, n):
        B = f.shape[0]
        parts = [torch.empty_like(f) for _ in range(n)]
        dist.all_gather(parts, f.contiguous(), group=group)
        ctx.levels, ctx.group, ctx.n = levels, group, n
        return torch.stack([p.reshape(B, levels, -1) for p in parts],
                           dim=2).reshape(B, -1)

    @staticmethod
    def backward(ctx, g):
        return (_ReduceScatterChannels.apply(g, ctx.levels, ctx.group, ctx.n),
                None, None, None)


class _ReduceScatterChannels(torch.autograd.Function):
    """[B, L*c*n] -> [B, L*c]: the j-th channel block of every level summed
    over the tp group (in f32, exact for a bf16 cotangent at any n below
    2^16; JAX's ``psum_scatter``); backward: the all-gather."""

    @staticmethod
    def forward(ctx, g, levels, group, n):
        B = g.shape[0]
        gv = g.reshape(B, levels, n, -1).float()
        blocks = [gv[:, :, j].reshape(B, -1).contiguous() for j in range(n)]
        out = torch.empty_like(blocks[0])
        dist.reduce_scatter(out, blocks, group=group)
        ctx.levels, ctx.group, ctx.n = levels, group, n
        return out.to(g.dtype)

    @staticmethod
    def backward(ctx, ct):
        return (_GatherChannels.apply(ct, ctx.levels, ctx.group, ctx.n),
                None, None, None)


class _SplitChannels(torch.autograd.Function):
    """[B, L*c*n] replicated over the tp group -> this rank's block of every
    level, a contiguous [B, L*c]; backward: the all-gather of the ranks'
    cotangents (each rank's block is its own rank's)."""

    @staticmethod
    def forward(ctx, t, levels, group, n):
        B = t.shape[0]
        ctx.levels, ctx.group, ctx.n = levels, group, n
        j = dist.get_rank(group)
        return t.reshape(B, levels, n, -1)[:, :, j].reshape(B, -1).contiguous()

    @staticmethod
    def backward(ctx, ct):
        return (_GatherChannels.apply(ct, ctx.levels, ctx.group, ctx.n),
                None, None, None)


class _SumOverTp(torch.autograd.Function):
    """The ranks' partial tensors added in rank order (an all-gather, then
    the sum: every rank holds the same bits), times ``scale``; backward:
    the identity."""

    @staticmethod
    def forward(ctx, t, group, n, scale):
        parts = [torch.empty_like(t) for _ in range(n)]
        dist.all_gather(parts, t.contiguous(), group=group)
        out = parts[0]
        for p in parts[1:]:
            out = out + p
        return out * scale if scale != 1.0 else out

    @staticmethod
    def backward(ctx, ct):
        return ct, None, None, None


def gather_channels(f: torch.Tensor, levels: int, group, n: int):
    """The all-gather of :class:`_GatherChannels` (differentiable, twice)."""
    return _GatherChannels.apply(f, levels, group, n)


def split_channels(t: torch.Tensor, levels: int, group, n: int):
    """This rank's channel block of every level of a replicated [B, L*C]
    (the inverse of :func:`gather_channels`; :class:`_SplitChannels`)."""
    return _SplitChannels.apply(t, levels, group, n)


def sum_over_tp(t: torch.Tensor, group, n: int, scale: float = 1.0):
    """The sum over the tp group of each rank's partial ``t``, added in rank
    order so every rank holds the same bits, times ``scale``
    (:class:`_SumOverTp`). Its backward is the identity: every rank
    computes the same loss from the sum and the step's reduction takes
    each replicated leaf's gradient as the single device's
    (:func:`raw_ngp_torch.parallel.mesh.make_reduce`), so each partial
    takes the sum's cotangent once. ``scale`` is 1 / n where each partial
    is n times its share (the unfused second order: the gather's backward
    summed n equal cotangents)."""
    return _SumOverTp.apply(t, group, n, scale)


def make_tp_train_step(cfg, spec, net_tx, num_rays: int, mesh: Mesh,
                       point_budget=None, pose_tx=None):
    """The train step on a (dp, tp) ``mesh`` (``make_tp_train_step``):
    :func:`raw_ngp_torch.parallel.mesh.make_parallel_train_step` with the
    field's radiance grid channel-sharded (``spec`` must be the
    :func:`tp_spec` the field was built with) and the tp reduction of
    :func:`raw_ngp_torch.parallel.mesh.make_reduce`: the table gradient
    divided by n_tp, the pose gradient summed over the row and divided by
    n_tp, the global finite gate."""
    if spec.tp_devices != mesh.n_tp:
        raise ValueError("make_tp_train_step: the field spec is not sharded "
                         "over this mesh's tp group (tp_spec)")
    return make_parallel_train_step(cfg, spec, net_tx, num_rays, mesh,
                                    point_budget=point_budget,
                                    pose_tx=pose_tx)
