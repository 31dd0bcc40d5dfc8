"""Rank bodies of the port's multi-rank CPU tests (tests/test_torch_parallel.py,
tests/test_torch_tp.py), in a module that imports no JAX: spawned ranks
import the module that holds the function they run, and JAX loaded into
each of them would cost seconds and memory for nothing.

:func:`run_ranks` starts ``world`` gloo ranks on the CPU, each pinned to one
torch thread, runs ``fn(*args)`` in each and returns what every rank
returned, in rank order (through files in a temporary directory).
"""

from __future__ import annotations

import os
import pickle
import tempfile
from types import SimpleNamespace

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


# the ranks fork from one server process that has imported torch and the
# port once (a fresh interpreter a rank would import them again each time)
_PRELOAD = ["torch", "torch.distributed", "torch_parallel_workers",
            "raw_ngp_torch.train.trainer", "raw_ngp_torch.parallel"]


def run_ranks(fn, world: int, *args):
    """[fn's result on rank r for r in range(world)] from ``world`` gloo
    ranks on the CPU that meet through a file."""
    mp.set_forkserver_preload(_PRELOAD)
    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(_rank, args=(world, tmp, fn, args), nprocs=world,
                           join=True, start_method="forkserver")
        out = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out


def _rank(rank, world, tmp, fn, args):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                            rank=rank, world_size=world)
    try:
        result = fn(*args)
        with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(result, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _np(t):
    return t.detach().float().cpu().numpy() if t.dtype == torch.bfloat16 \
        else t.detach().cpu().numpy()


def _field(cfg, state_dict, mesh=None):
    """The port's field with the given (whole) parameters; under tp with
    this rank's channel shard of the table and the tp spec."""
    from raw_ngp_torch.models.ngp import init_field, make_field_spec
    from raw_ngp_torch.parallel.tp import shard_of, tp_spec
    spec = make_field_spec(cfg)
    if mesh is not None and mesh.n_tp > 1:
        spec = tp_spec(spec, mesh)
    field = init_field(spec, device="cpu")
    field.load_state_dict(state_dict)
    if mesh is not None and mesh.n_tp > 1:
        field.grid = torch.nn.Parameter(shard_of(
            field.grid.detach(), spec.grid_spec, mesh.n_tp, mesh.tp_rank))
    return spec, field


def batch_grads(cfg, blob, n_dp, n_tp):
    """The gradient of the fixed batch ``blob["batch"]`` (deterministic
    render, key None) on an (n_dp, n_tp) layout: each dp row takes its
    slice of the rays, the step's reduction (parallel.mesh.make_reduce)
    averages; the table's gradient gathered whole. -> {name: array}, and
    under the orientation loss its term ("orientation_loss")."""
    from raw_ngp_torch.parallel.mesh import make_mesh, make_reduce
    from raw_ngp_torch.parallel.tp import gather_table, make_tp_mesh
    from raw_ngp_torch.train.trainer import make_batch_loss_fn
    mesh = make_tp_mesh(n_dp, n_tp) if n_tp > 1 else make_mesh()
    spec, field = _field(cfg, blob["field"], mesh)
    n = blob["batch"]["rays_o"].shape[0]
    s = slice(mesh.dp_rank * n // n_dp, (mesh.dp_rank + 1) * n // n_dp)
    batch = {k: v[s] for k, v in blob["batch"].items()}
    state = SimpleNamespace(density_bitfield=blob["bits"])
    orient = []
    with _recorded_orientation(orient), given_march(blob.get("march"), s):
        loss, aux = make_batch_loss_fn(cfg, spec)(field, state, batch,
                                                  blob["aabb"], None)
    loss.backward()
    grads = {k: p.grad for k, p in field.named_parameters()
             if p.grad is not None}
    grads, _, loss, aux, ok = make_reduce(mesh)(grads, None, loss, aux)
    if n_tp > 1:
        grads["grid"] = gather_table(grads["grid"], spec.grid_spec, mesh)
    out = {k: _np(g) for k, g in grads.items()}
    if orient:
        out["orientation_loss"] = float(orient[0])
    return out


class given_march:
    """While active, the occupancy march returns the rows ``rows`` of the
    captured march ``march`` (a dict of [N, K] tensors) in place of its
    own; inactive where ``march`` is None."""

    def __init__(self, march, rows):
        self.march, self.rows = march, rows

    def __enter__(self):
        from raw_ngp_torch.render import occupancy
        self.orig = occupancy.march_rays
        if self.march is not None:
            part = {k: v[self.rows] for k, v in self.march.items()}
            occupancy.march_rays = lambda *args, **kwargs: dict(part)
        return self

    def __exit__(self, *exc):
        from raw_ngp_torch.render import occupancy
        occupancy.march_rays = self.orig


class _recorded_orientation:
    """While active, the orientation loss of each training render is
    appended to ``values`` (train.trainer.render_any wrapped)."""

    def __init__(self, values):
        self.values = values

    def __enter__(self):
        from raw_ngp_torch.train import trainer
        self.orig = render_any = trainer.render_any

        def wrapped(*args, **kwargs):
            out = render_any(*args, **kwargs)
            if "orientation_loss" in out:
                self.values.append(out["orientation_loss"].detach())
            return out

        trainer.render_any = wrapped
        return self

    def __exit__(self, *exc):
        from raw_ngp_torch.train import trainer
        trainer.render_any = self.orig


def pose_grads(cfg, blob, n_tp):
    """The pose gradient of the fixed pixels ``blob["coords"]`` under the
    refinements ``blob["pose"]`` on a (1, n_tp) layout through the tp
    step's reduction (summed over the row, divided by n_tp)."""
    from raw_ngp_torch.data.sampler import sample_ray_batch
    from raw_ngp_torch.parallel.mesh import make_reduce
    from raw_ngp_torch.parallel.tp import make_tp_mesh
    from raw_ngp_torch.train.trainer import make_batch_loss_fn
    mesh = make_tp_mesh(1, n_tp)
    spec, field = _field(cfg, blob["field"], mesh)
    pose = blob["pose"].clone().requires_grad_(True)
    sc = blob["scene"]
    batch = sample_ray_batch(None, sc["images"], sc["poses"],
                             sc["intrinsics"], blob["coords"].shape[0],
                             se3_refine=pose, coords=blob["coords"],
                             coord_image_indices=blob["index"])
    state = SimpleNamespace(density_bitfield=blob["bits"])
    loss, aux = make_batch_loss_fn(cfg, spec)(field, state, batch,
                                              blob["aabb"], None)
    loss.backward()
    grads = {k: p.grad for k, p in field.named_parameters()
             if p.grad is not None}
    _, g_pose, _, _, _ = make_reduce(mesh)(grads, pose.grad, loss, aux)
    return _np(g_pose)


def encode(table, x, spec, mode):
    """The port's encode of x under ``mode``: "f32" and "bf16" the fused
    encoder in that compute dtype, "unfused" the plain one."""
    from raw_ngp_torch.kernels.hash_encode import hash_encode
    from raw_ngp_torch.ops import hashgrid
    if mode == "unfused":
        return hashgrid.hash_encode_01(table, x, spec)
    dtype = torch.bfloat16 if mode == "bf16" else torch.float32
    return hash_encode(table, x, spec, compute_dtype=dtype)


def tp_features(cases, x, n_tp):
    """{name: the tp encode's features of x on a (1, n_tp) layout} for
    each (name, grid spec, table, mode) of ``cases``: this rank's channel
    shard encoded at the shard's spec, gathered over the row."""
    from raw_ngp_torch.parallel.tp import (gather_channels, local_grid_spec,
                                           make_tp_mesh, shard_of)
    mesh = make_tp_mesh(1, n_tp)
    out = {}
    for name, spec, table, mode in cases:
        local = local_grid_spec(spec, n_tp)
        f = encode(shard_of(table, spec, n_tp, mesh.tp_rank), x, local,
                   mode)
        out[name] = _np(gather_channels(f, spec.num_levels, mesh.tp_group,
                                        n_tp))
    return out


def eval_chunks(cfg, state_dict, rays_o, rays_d, aabb, chunk):
    """The sharded eval render (dp over every rank) of the rays, chunk by
    chunk -> (image, depth, weights_sum) of all of them."""
    from raw_ngp_torch.parallel.mesh import make_mesh
    from raw_ngp_torch.render.eval import make_eval_render
    mesh = make_mesh()
    _, field = _field(cfg, state_dict)
    render = make_eval_render(cfg, mesh=mesh)
    outs = [render(field, None, rays_o[s:s + chunk], rays_d[s:s + chunk],
                   aabb) for s in range(0, rays_o.shape[0], chunk)]
    return tuple(_np(torch.cat([o[i] for o in outs])) for i in range(3))


def state_arrays(tr):
    """The Trainer's state tensors by checkpoint key, tables whole (the
    row's shards gathered under tp), as numpy."""
    from raw_ngp_torch.parallel.tp import SHARDED, gather_table
    from raw_ngp_torch.train.checkpoint import state_tensors
    out = {}
    for k, t in state_tensors(tr.state).items():
        if tr.n_tp > 1 and k in SHARDED:
            t = gather_table(t, tr.spec.grid_spec, tr.mesh)
        out[k] = _np(t)
    return out


def trainer_run(cfg, scene_args, workspace, steps):
    """A Trainer on the layout cfg.parallel names: ``steps`` steps, a
    render of the first val view, a checkpoint; -> (state arrays, the
    point budget a rank renders under, the global base budget, the last
    loss and every step's, each step's orientation term (none without
    it), the render, the checkpoint's path)."""
    from raw_ngp_torch.data import make_synthetic_scene
    from raw_ngp_torch.train.trainer import Trainer
    train_s, val_s = make_synthetic_scene(**scene_args)
    tr = Trainer(cfg, train_s, val_s, device="cpu", workspace=workspace)
    assert tr.n_dp * tr.n_tp == dist.get_world_size()
    orient = []
    with _recorded_orientation(orient):
        losses = [float(tr.step()["loss"]) for _ in range(steps)]
    rgb, depth = tr.render_image(val_s.poses[0])
    path = tr.save_checkpoint()
    return {"state": state_arrays(tr), "local_budget": tr.local_point_budget(),
            "base_budget": tr.base_point_budget(),
            "loss": losses[-1], "losses": losses,
            "orientation": [float(o) for o in orient], "rgb": rgb,
            "depth": depth,
            "ckpt": path, "n_dp": tr.n_dp, "n_tp": tr.n_tp,
            "grid_shape": tuple(tr.field.grid.shape)}


def spawn_cli(argv, env):
    """``cli.main(argv)`` in a process of its own (forked from the ranks'
    server) with ``env`` set; the CLI then starts its ranks from there."""
    mp.set_forkserver_preload(_PRELOAD)
    ctx = mp.get_context("forkserver")
    q = ctx.Queue()
    p = ctx.Process(target=_cli_proc, args=(argv, env, q))
    p.start()
    p.join()
    return p.exitcode, (q.get() if not q.empty() else None)


def _cli_proc(argv, env, q):
    os.environ.update(env)
    torch.set_num_threads(1)
    from raw_ngp_torch import cli
    q.put(cli.main(argv))
