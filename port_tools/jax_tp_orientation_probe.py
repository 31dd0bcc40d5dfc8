#!/usr/bin/env python3
"""The orientation loss under tensor parallelism: JAX's tp step against its
own single device, and the port's against both single devices.

    JAX_PLATFORMS=cpu python3 port_tools/jax_tp_orientation_probe.py

CPU only; edits nothing. Part 1 runs tests/test_tp.py's
``test_tp_grads_match_single_device`` recipe (the 8-device CPU mesh,
(dp 4, tp 2), one fixed 512-ray batch) with ``lambda_orientation`` 0 and
1e-2, unfused (level_dim 2) and fused (level_dim 4), and prints per leaf
max |tp - single| and max |single|. JAX's inner gradient (jax.grad of the
density at ``render/occupancy.py:999-1003``) goes back through the tp
encode's all_gather and is never summed over tp, so with the orientation
loss the ranks' normals, and the gradient, leave the single device's.

Part 2 runs tests/test_torch_tp.py's gradient cases at lam 0 and 1e-2
((dp 2, tp 2) gloo ranks, every package through JAX's captured march)
and prints, per leaf,
max |port tp - port single| / max |port single|, max |port single - JAX
single| / max |port single|, the projection <tp, single> / <single,
single> (1 where tp carries the single device's scale), and max |port
single - JAX single| / max |port single| with the port on its own march
(an ulp from JAX's): ``leaves``. One JSON line per case and part.
"""

from __future__ import annotations

import json
import os
import sys

os.environ.setdefault("XLA_FLAGS",
                      "--xla_force_host_platform_device_count=8")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]


def jax_tp_vs_single(fused, level_dim, lam):
    """{leaf: [max |tp - single|, max |single|]} of JAX's (dp 4, tp 2)
    gradient (tests/test_tp.py:67-124) with the orientation loss at lam."""
    from dataclasses import replace

    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax import shard_map
    from jax.sharding import PartitionSpec as P
    from raw_ngp_tpu.data import make_synthetic_scene
    from raw_ngp_tpu.data.sampler import sample_ray_batch
    from raw_ngp_tpu.models import make_field_spec
    from raw_ngp_tpu.parallel.tp import grid_to_2d, make_tp_mesh
    from raw_ngp_tpu.train import init_train_state
    from raw_ngp_tpu.train.trainer import make_batch_loss_fn
    from test_tp import tp_cfg

    cfg = tp_cfg(level_dim=level_dim, fused=fused)
    cfg = replace(cfg, train=replace(cfg.train,
                                     lambda_orientation=lam)).validate()
    spec = make_field_spec(cfg)
    state = init_train_state(jax.random.PRNGKey(0), cfg, spec)
    state = state.replace(density_bitfield=jnp.full_like(
        state.density_bitfield, 255))
    state = grid_to_2d(state, spec)
    ts, _ = make_synthetic_scene(n_train=4, n_val=1, H=16, W=16)
    batch = sample_ray_batch(
        jax.random.PRNGKey(7), jnp.asarray(ts.images),
        jnp.asarray(ts.poses), jnp.asarray(ts.intrinsics), 512,
        random_image_batch=True)
    aabb = jnp.asarray(ts.pts_aabb)
    loss_single = make_batch_loss_fn(cfg, spec)
    g_single = jax.jit(jax.grad(lambda p: loss_single(
        p, state, batch, aabb, None, 1.0, True)[0]))(state.params)
    n_tp = 2
    mesh = make_tp_mesh(4, n_tp)
    loss_tp = make_batch_loss_fn(cfg, replace(spec, tp_axis="tp",
                                              tp_devices=n_tp))
    param_specs = dict(jax.tree.map(lambda _: P(), state.params))
    param_specs["grid"] = P(None, "tp")

    def per_device(params, batch_shard):
        g = dict(jax.grad(lambda p: loss_tp(
            p, state, batch_shard, aabb, None, 1.0, True)[0])(params))
        g["grid"] = g["grid"] / n_tp
        return jax.tree.map(lambda x: jax.lax.pmean(x, "dp"), g)

    g_tp = jax.jit(shard_map(per_device, mesh=mesh,
                             in_specs=(param_specs, P("dp")),
                             out_specs=param_specs, check_vma=False))(
        state.params, batch)
    out = {}
    for (ka, a), (_, b) in zip(
            jax.tree_util.tree_flatten_with_path(g_single)[0],
            jax.tree_util.tree_flatten_with_path(g_tp)[0]):
        a, b = np.asarray(a), np.asarray(b)
        out[jax.tree_util.keystr(ka)] = [float(np.abs(b - a).max()),
                                         float(np.abs(a).max())]
    return out


def port_tp_errors(fused, level_dim, lam):
    """{leaf: [tp vs port single, port single vs JAX single, projection,
    port single on its own march vs JAX single]} of
    tests/test_torch_tp.py's orientation case."""
    import numpy as np
    import torch
    import test_torch_tp as T
    import torch_parallel_workers as W

    torch.set_num_threads(1)
    jc, tc, state, batch, ts = T._case(level_dim, fused, lam)
    blob = T._blob(tc, state, ts)
    blob["batch"] = {k: torch.from_numpy(v.copy()) for k, v in batch.items()}
    own = T._port_grads(tc, blob, blob["batch"])
    march = {}
    g_j = T._jax_grads(jc, state, batch, ts.pts_aabb, march)
    blob["march"] = march
    out = W.run_ranks(W.batch_grads, 4, tc, blob, 2, 2)[0]
    single = T._port_grads(tc, blob, blob["batch"])
    res = {}
    for k, s in single.items():
        scale = np.abs(s).max()
        res[k] = [float(np.abs(out[k] - s).max() / scale),
                  float(np.abs(g_j[k] - s).max() / scale),
                  float(np.sum(out[k] * s) / np.sum(s * s)),
                  float(np.abs(g_j[k] - own[k]).max()
                        / np.abs(own[k]).max())]
    return res


def main():
    cases = ((False, 2), (True, 4), (True, 2))
    for fused, level_dim in cases[:2]:
        for lam in (0.0, 1e-2):
            print(json.dumps({"part": "jax_tp_vs_jax_single", "fused": fused,
                              "level_dim": level_dim, "lam": lam,
                              "max_abs_diff_and_max_single":
                                  jax_tp_vs_single(fused, level_dim, lam)}),
                  flush=True)
    for fused, level_dim in cases:
        for lam in (0.0, 1e-2):
            print(json.dumps({"part": "port_tp", "fused": fused,
                              "level_dim": level_dim, "lam": lam,
                              "leaves": port_tp_errors(fused, level_dim,
                                                       lam)}), flush=True)


if __name__ == "__main__":
    main()
