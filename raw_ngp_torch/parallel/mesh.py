"""Data-parallel training over the ranks of a process group (port of
``raw_ngp_tpu/parallel/mesh.py``: ``make_mesh`` ``:34``,
``make_parallel_train_step`` ``:40-122``, ``replicate_to_mesh`` ``:125``,
``make_parallel_eval_render`` ``:131-172``).

One process a rank. The caller sets up the default process group
(``torch.distributed.init_process_group``: NCCL with one GPU a rank, as
the CLI starts it; gloo on the CPU, or gloo with several ranks on one
GPU) and the port builds its layout from it; it never swaps the backend.
Collectives stand in for JAX's: ``all_reduce`` (sum, then a division) for
``pmean`` and ``psum``, ``all_gather`` for the eval render's gather, a MIN
``all_reduce`` for ``pmin``.

Ray-batch data parallelism: every rank holds the whole model and the
optimizer state, renders ``num_rays / n_dp`` rays drawn from its own
stream, and the network and pose gradients are all-reduced to their mean
before the fused Adam + EMA update, which then runs identically on every
rank. The all-reduce carries a non-finite gradient to every rank, so the
update's local finite gate is a global one.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Iterable

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class Mesh:
    """The (dp, tp) layout of the default process group's ranks: rank =
    dp * n_tp + tp (tp innermost, ``make_tp_mesh``). ``dp_group`` holds
    the ranks of this rank's tp column (the same tp index; gradients are
    averaged over it), ``tp_group`` those of its dp row (the same rays;
    None without tensor parallelism)."""

    n_dp: int
    n_tp: int
    rank: int
    dp_group: Any
    tp_group: Any = None

    @property
    def dp_rank(self) -> int:
        return self.rank // self.n_tp

    @property
    def tp_rank(self) -> int:
        return self.rank % self.n_tp

    @property
    def is_main(self) -> bool:
        """Rank 0: the one that logs and writes files."""
        return self.rank == 0


def make_mesh(num_devices: int = 0) -> Mesh:
    """The data-parallel layout over the default process group:
    ``num_devices`` ranks (0 = all of them), each its own dp index."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: torch.distributed has no initialized "
                           "process group")
    n = num_devices or dist.get_world_size()
    if n != dist.get_world_size():
        raise ValueError(f"make_mesh: {n} devices asked for, the process "
                         f"group has {dist.get_world_size()} ranks")
    return Mesh(n_dp=n, n_tp=1, rank=dist.get_rank(),
                dp_group=dist.group.WORLD)


def all_reduce_mean(tensors: Iterable[torch.Tensor], group, n: int):
    """``pmean``: each tensor summed over ``group`` (n ranks) in place, then
    divided by n. Every rank ends with the same bits."""
    for t in tensors:
        dist.all_reduce(t, group=group)
        t.div_(n)


def replicate(tensors: Iterable[torch.Tensor]):
    """``replicate_to_mesh``: every tensor made rank 0's, in place (a
    broadcast over the default group)."""
    for t in tensors:
        dist.broadcast(t, 0)


def global_ok(grads: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Whether every gradient of every rank is finite (``pmin`` over the
    whole layout of each rank's finite flag): one decision for all ranks."""
    ok = torch.stack([torch.isfinite(g).all() for g in grads.values()]
                     ).all().to(torch.int32)
    dist.all_reduce(ok, op=dist.ReduceOp.MIN)
    return ok.bool()


def make_reduce(mesh: Mesh):
    """The gradient reduction of a step on ``mesh`` (the body of
    ``make_parallel_train_step`` and ``make_tp_train_step`` between the
    backward and the update): ``reduce(grads, pose_grad, loss, aux) ->
    (grads, pose_grad, loss, aux, ok)``, in place on the gradients.

    Under tensor parallelism the table gradient is divided by n_tp first
    (the all-gather's backward summed n_tp identical cotangents into it)
    and the pose gradient is summed over the row and divided by n_tp (each
    rank's covers its channel shard, n_tp times over); ``ok`` is then the
    global finite gate (:func:`global_ok`), since a shard's non-finite
    gradient reaches no other row's rank through the dp all-reduce. On dp
    alone ``ok`` is None: the update's local gate sees the reduced
    gradients, the same on every rank. The loss is averaged over dp,
    ``num_points`` and ``num_points_raw`` summed, ``weights_sum``
    averaged."""
    n_dp, n_tp = mesh.n_dp, mesh.n_tp

    def reduce(grads, pose_grad, loss, aux):
        if n_tp > 1:
            grads["grid"] = grads["grid"] / n_tp
            if pose_grad is not None:
                dist.all_reduce(pose_grad, group=mesh.tp_group)
                pose_grad.div_(n_tp)
        all_reduce_mean(grads.values(), mesh.dp_group, n_dp)
        if pose_grad is not None:
            all_reduce_mean([pose_grad], mesh.dp_group, n_dp)
        loss = loss.detach().clone()
        all_reduce_mean([loss], mesh.dp_group, n_dp)
        aux = dict(aux)
        for k in ("num_points", "num_points_raw"):
            # a tensor on the occupancy path, an int on the proposal path
            aux[k] = torch.as_tensor(aux[k], device=loss.device).clone()
            dist.all_reduce(aux[k], group=mesh.dp_group)
        aux["weights_sum"] = aux["weights_sum"].detach().clone()
        all_reduce_mean([aux["weights_sum"]], mesh.dp_group, n_dp)
        ok = global_ok(grads) if n_tp > 1 else None
        return grads, pose_grad, loss, aux, ok

    return reduce


def local_point_budget(budget: int, n_dp: int) -> int:
    """A rank's compacted point budget: the global one split over the dp
    rows, a multiple of 128 and at least 128 (the tp ranks of a row render
    the row's rays alike)."""
    return max(budget // n_dp // 128 * 128, 128)


def make_parallel_train_step(cfg, spec, net_tx, num_rays: int, mesh: Mesh,
                             point_budget=None, pose_tx=None):
    """The train step on ``mesh``: ``train_step(field, state, scene, aabb,
    generator) -> metrics`` as :func:`raw_ngp_torch.train.trainer.
    make_train_step`'s, where ``num_rays`` is the GLOBAL ray count (it
    must divide by n_dp), each rank renders num_rays / n_dp rays drawn
    from ``generator`` (its dp row's stream) with ``point_budget`` points
    at most, and the gradients are reduced by :func:`make_reduce` before
    the update. The metrics are the reduced ones, the same on every
    rank."""
    from raw_ngp_torch.train.trainer import make_train_step
    if num_rays % mesh.n_dp:
        raise ValueError(f"num_rays {num_rays} must divide by the dp size "
                         f"{mesh.n_dp}")
    return make_train_step(cfg, spec, net_tx, num_rays // mesh.n_dp,
                           point_budget=point_budget, pose_tx=pose_tx,
                           reduce=make_reduce(mesh))


def make_parallel_eval_render(cfg, mesh: Mesh, plain: bool = False):
    """The chunk renderer of :func:`raw_ngp_torch.render.eval.
    make_eval_render` with the chunk's rays split over the dp ranks (the
    chunk must divide by n_dp) and each output gathered back, so every
    rank returns the whole chunk's. Every rank calls it with the same
    chunk; the tp ranks of a row render the same slice."""
    from raw_ngp_torch.render.eval import make_eval_render
    render = make_eval_render(cfg, plain=plain)
    n, r = mesh.n_dp, mesh.dp_rank

    def render_chunk(field, bitfield, rays_o, rays_d, aabb, coarse_lin=None,
                     annealing=1.0, rays_ldir=None):
        c = rays_o.shape[0]
        if c % n:
            raise ValueError(f"eval chunk {c} must divide by the dp size {n}")
        s = slice(r * c // n, (r + 1) * c // n)
        out = render(field, bitfield, rays_o[s], rays_d[s], aabb, coarse_lin,
                     annealing, None if rays_ldir is None else rays_ldir[s])
        return tuple(gather_rows(t, mesh.dp_group, n) for t in out)

    return render_chunk


def gather_rows(t: torch.Tensor, group, n: int) -> torch.Tensor:
    """The n ranks' ``t`` concatenated along the first axis, in rank
    order."""
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts)


def batch_seed(seed: int, dp_rank: int) -> int:
    """The seed of dp row ``dp_rank``'s batch stream: every row draws its
    own rays, the tp ranks of a row the same ones."""
    import numpy as np
    return int(np.random.SeedSequence([seed, dp_rank + 1]).generate_state(
        1, np.uint64)[0] >> 1)
