"""Data parallelism of the port (raw_ngp_torch.parallel.mesh, the Trainer's
mesh branch, the CLI's ranks) on the CPU: gloo ranks, one process each
(tests/torch_parallel_workers.py, which imports no JAX), against the JAX
package's shard_map on tests/conftest.py's virtual CPU mesh.

The ray batch is JAX's ``sample_ray_batch(PRNGKey(7), ..., 512)`` as numpy
and the parameters come across through raw_ngp_torch.convert, given to
both packages. Each test states its tolerance.
"""

import os
from dataclasses import replace
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

import raw_ngp_torch.config as tcfg
import raw_ngp_tpu.config as jcfg
import raw_ngp_tpu.kernels.segsum_pallas as sp
import torch_parallel_workers as W
from raw_ngp_torch.convert import bitfield_from_jax, field_from_jax
from raw_ngp_torch.models.ngp import make_field_spec as t_make_spec
from raw_ngp_tpu.data import make_synthetic_scene as j_scene
from raw_ngp_tpu.data.sampler import sample_ray_batch as j_sample
from raw_ngp_tpu.models.ngp import make_field_spec as j_make_spec
from raw_ngp_tpu.parallel import make_mesh as j_make_mesh
from raw_ngp_tpu.train import init_train_state as j_init_state
from raw_ngp_tpu.train.trainer import make_batch_loss_fn as j_batch_loss


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's torch work, set back after
    it (tests/test_torch_proposal.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny_cfg(mod, occupancy=False, **parallel):
    """tests/test_parallel.py's tiny_cfg, from either package's config."""
    cfg = mod.Config()
    cfg = replace(cfg, model=replace(
        cfg.model, num_levels=4, log2_hashmap_size=12,
        hashgrid_resolution=64, grid_mlp_hidden=16, view_mlp_hidden=16,
        prop_num_levels=3, prop_log2_hashmap_size=10,
        prop_resolutions=(16, 32), fused_encoder=False))
    cfg = replace(cfg, render=replace(
        cfg.render, num_steps=(16, 8, 8), occupancy=occupancy,
        grid_size=16, samples_per_ray=16, march_candidates=64,
        mark_untrained=False, bound=1.5))
    cfg = replace(cfg, train=replace(
        cfg.train, iters=100, num_rays=256, fp16=False,
        random_image_batch=True))
    if parallel:
        cfg = replace(cfg, parallel=mod.ParallelConfig(**parallel))
    return cfg.validate()


def _interpreted(fn):
    """fn() with JAX's table gradient through its Pallas segment totals,
    interpreted (its CPU fallback rounds the totals to bf16 and is not the
    reference), and XLA's optimizations off (eager JAX's rounding: jitted
    CPU XLA contracts products and sums into FMAs the port does not
    take; tests/test_torch_march.py)."""
    sp.FORCE_INTERPRET = True
    jax.config.update("jax_disable_most_optimizations", True)
    try:
        return fn()
    finally:
        sp.FORCE_INTERPRET = False
        jax.config.update("jax_disable_most_optimizations", False)


def _jax_case(occupancy, fused):
    """(jax cfg, port cfg, JAX state, the fixed batch as numpy, aabb)."""
    jc = tiny_cfg(jcfg, occupancy)
    tc = tiny_cfg(tcfg, occupancy)
    jc = replace(jc, model=replace(jc.model, fused_encoder=fused))
    tc = replace(tc, model=replace(tc.model, fused_encoder=fused))
    if occupancy:
        jc = replace(jc, render=replace(jc.render, compact_ratio=0.0))
        tc = replace(tc, render=replace(tc.render, compact_ratio=0.0))
    state = j_init_state(jax.random.PRNGKey(0), jc, j_make_spec(jc))
    if occupancy:
        state = state.replace(density_bitfield=jnp.full_like(
            state.density_bitfield, 255))
    ts, _ = j_scene(n_train=4, n_val=1, H=16, W=16)
    batch = j_sample(jax.random.PRNGKey(7), jnp.asarray(ts.images),
                     jnp.asarray(ts.poses), jnp.asarray(ts.intrinsics), 512,
                     random_image_batch=True)
    batch = {k: np.asarray(v) for k, v in batch.items()}
    return jc, tc, state, batch, np.asarray(ts.pts_aabb, np.float32)


def _port_blob(tc, state, batch, aabb):
    """What a rank needs: the field's parameters from the JAX init, the
    batch, the bitfield and the aabb, as CPU tensors."""
    field = field_from_jax(jax.tree_util.tree_map(np.asarray, state.params),
                           t_make_spec(tc), device="cpu")
    bits = (None if state.density_bitfield is None else
            bitfield_from_jax(np.asarray(state.density_bitfield), "cpu"))
    return {"field": field.state_dict(),
            "batch": {k: torch.from_numpy(v) for k, v in batch.items()},
            "bits": bits, "aabb": torch.from_numpy(aabb)}


def _jax_leaves(g):
    """JAX's gradient pytree by the port's parameter names."""
    out = {"grid": np.asarray(g["grid"]).reshape(-1)}
    for net in ("grid_mlp", "view_mlp"):
        for i, layer in enumerate(g[net]):
            out[f"{net}.{i}"] = np.asarray(layer["w"])
    for i, pg in enumerate(g.get("prop_grids", ())):
        out[f"prop_grids.{i}"] = np.asarray(pg).reshape(-1)
    for i, mlp in enumerate(g.get("prop_mlps", ())):
        for j, layer in enumerate(mlp):
            out[f"prop_mlps.{i}.{j}"] = np.asarray(layer["w"])
    return out


@pytest.mark.parametrize("occupancy,fused", [(False, False), (True, True)])
def test_dp_grads_match_jax_pmean(occupancy, fused):
    """Two gloo ranks, each the deterministic render's gradient of its half
    of one fixed 512-ray batch, averaged by the step's reduction
    (make_reduce): the same bits on both ranks; against the port's
    single-device gradient of the whole batch within JAX's own tolerance
    for its pmean against its single device (tests/test_parallel.py:
    101-162, compact_ratio 0 on the occupancy path): rtol 2e-5, atol 2e-6
    of each leaf's largest entry, plus 1e-6 fused (records pre-rounded to
    bf16 put the floor at f32 noise on bf16-scaled sums); measured: 1.5e-7
    of the largest entry, as JAX's 1.5e-7. Against JAX's shard_map pmean
    of the same halves on a 2-device mesh within the cross-package f32
    tolerance of tests/test_torch_train.py (sums in other orders: 1e-4 of
    each leaf's largest entry, the same fused floor). Measured there: 2.5e-5
    on the unfused table (its scatter-adds), 1.05e-4 on the fused one
    (the cotangent packed to bf16 words moves an ulp where f32 sums
    differ); the same differences as between the two packages' single-
    device gradients, to the bit."""
    from raw_ngp_torch.train.trainer import make_batch_loss_fn
    jc, tc, state, batch, aabb = _jax_case(occupancy, fused)
    loss_fn = j_batch_loss(jc, j_make_spec(jc))

    def grad_of(params, part):
        return jax.grad(lambda p: loss_fn(
            p, state, part, jnp.asarray(aabb), None, 1.0, True)[0])(params)

    mesh = j_make_mesh(2)
    sharded = jax.jit(shard_map(
        lambda p, b: jax.lax.pmean(grad_of(p, b), "dp"), mesh=mesh,
        in_specs=(P(), P("dp")), out_specs=P(), check_vma=False))
    g_j = _jax_leaves(_interpreted(lambda: sharded(
        state.params, jax.tree_util.tree_map(jnp.asarray, batch))))

    blob = _port_blob(tc, state, batch, aabb)
    out = W.run_ranks(W.batch_grads, 2, tc, blob, 2, 1)
    for k in out[0]:             # the all-reduce leaves every rank alike
        np.testing.assert_array_equal(out[1][k], out[0][k], err_msg=k)

    spec, field = W._field(tc, blob["field"])
    loss, _ = make_batch_loss_fn(tc, spec)(
        field, SimpleNamespace(density_bitfield=blob["bits"]),
        blob["batch"], blob["aabb"], None)
    loss.backward()
    single = {k: p.grad.numpy() for k, p in field.named_parameters()
              if p.grad is not None}
    assert set(out[0]) == set(g_j) == set(single)
    atol_extra = 1e-6 if fused else 0.0
    for k, gj in g_j.items():
        scale = np.abs(single[k]).max() + 1e-12
        np.testing.assert_allclose(out[0][k], single[k], rtol=2e-5,
                                   atol=2e-6 * scale + atol_extra,
                                   err_msg=k)
        scale = np.abs(gj).max() + 1e-12
        np.testing.assert_allclose(out[0][k], gj, rtol=2e-5,
                                   atol=1e-4 * scale + atol_extra,
                                   err_msg=k)


def test_sharded_eval_render_matches_single_device():
    """make_eval_render on a 2-rank mesh (each chunk's rays split over the
    dp ranks and gathered back) against the single-device render of the
    same chunks: rtol 1e-4, atol 1e-5 (tests/test_parallel.py:165-191;
    the MLP products run at half the rows)."""
    from raw_ngp_torch.models.ngp import init_field
    from raw_ngp_torch.render.eval import make_eval_render
    tc = tiny_cfg(tcfg, False)
    field = init_field(t_make_spec(tc), seed=0, device="cpu")
    N, chunk = 1024, 256
    rays_o = torch.zeros(N, 3)
    rays_o[:, 2] = 2.0
    rays_d = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (N, 3)).astype(np.float32))
    aabb = torch.tensor([-1.5] * 3 + [1.5] * 3)
    out = W.run_ranks(W.eval_chunks, 2, tc, field.state_dict(), rays_o,
                      rays_d, aabb, chunk)
    render = make_eval_render(tc)
    single = [render(field, None, rays_o[s:s + chunk], rays_d[s:s + chunk],
                     aabb) for s in range(0, N, chunk)]
    for i in range(3):
        ref = torch.cat([o[i] for o in single]).numpy()
        assert out[0][i].shape == ref.shape
        np.testing.assert_array_equal(out[1][i], out[0][i])
        np.testing.assert_allclose(out[0][i], ref, rtol=1e-4, atol=1e-5)


def _trainer_cfg(**parallel):
    cfg = tiny_cfg(tcfg, True, **parallel)
    return replace(cfg, ckpt="scratch")


@pytest.mark.parametrize("layout", [(2, 1), (4, 2)],
                         ids=["dp2", "dp2_tp2"])
def test_trainer_end_to_end_on_a_mesh(tmp_path, layout):
    """The Trainer on dp = 2 and on (dp = 2, tp = 2), 3 steps: every
    replicated tensor (and the gathered tables) bitwise equal across the
    ranks; each rank's point budget the global one over n_dp; under tp
    the field holds C/tp channels of every row; the val render the same
    on every rank; rank 0's checkpoint loads into a single-device Trainer
    bit for bit, and that Trainer renders the val view as the mesh did,
    bitwise, from the chunks the mesh's dp ranks rendered (each chunk's
    point budget is its own rays'; JAX's sharded eval has the same)."""
    from raw_ngp_torch.data import make_synthetic_scene
    from raw_ngp_torch.train.trainer import Trainer
    n, tp = layout
    cfg = _trainer_cfg(num_devices=n, tp_devices=tp)
    scene = dict(n_train=8, n_val=1, H=24, W=24)
    out = W.run_ranks(W.trainer_run, n, cfg, scene, str(tmp_path / "ws"), 3)
    spec = t_make_spec(cfg).grid_spec
    for o in out:
        assert (o["n_dp"], o["n_tp"]) == (n // tp, tp)
        assert o["local_budget"] == max(o["base_budget"] // (n // tp)
                                        // 128 * 128, 128)
        assert o["local_budget"] < o["base_budget"]
        assert o["grid_shape"] == (spec.n_params * spec.level_dim // tp,)
        assert np.isfinite(o["loss"]) and o["loss"] == out[0]["loss"]
        np.testing.assert_array_equal(o["rgb"], out[0]["rgb"])
        for k, v in out[0]["state"].items():
            np.testing.assert_array_equal(o["state"][k], v, err_msg=k)

    # the eval render compacts each chunk under a budget of its own rays,
    # so the single device renders the chunks the dp ranks rendered (576
    # rays: one chunk on the mesh, split in n_dp)
    single_cfg = replace(cfg, parallel=tcfg.ParallelConfig(num_devices=1),
                         ckpt=out[0]["ckpt"],
                         render=replace(cfg.render,
                                        max_ray_batch=576 // (n // tp)))
    train_s, val_s = make_synthetic_scene(**scene)
    tr = Trainer(single_cfg, train_s, val_s, device="cpu",
                 workspace=str(tmp_path / "single"))
    assert tr.mesh is None and tr.host_step == 3
    single = W.state_arrays(tr)
    assert set(single) == set(out[0]["state"])
    for k, v in out[0]["state"].items():
        np.testing.assert_array_equal(single[k], v, err_msg=k)
    rgb, depth = tr.render_image(val_s.poses[0])
    np.testing.assert_array_equal(rgb, out[0]["rgb"])
    np.testing.assert_array_equal(depth, out[0]["depth"])


def test_trainer_refuses_a_mesh_it_cannot_build(tmp_path):
    """The Trainer's guards: tensor parallelism with no process group, and
    (JAX's validate) tp that does not divide level_dim or leaves the
    occupancy path."""
    from raw_ngp_torch.data import make_synthetic_scene
    from raw_ngp_torch.train.trainer import Trainer
    train_s, val_s = make_synthetic_scene(n_train=4, n_val=1, H=16, W=16)
    with pytest.raises(RuntimeError, match="process group"):
        Trainer(_trainer_cfg(num_devices=2, tp_devices=2), train_s, val_s,
                device="cpu", workspace=str(tmp_path))
    cfg = tiny_cfg(tcfg, True)
    with pytest.raises(AssertionError):
        replace(cfg, parallel=tcfg.ParallelConfig(
            num_devices=8, tp_devices=3)).validate()
    with pytest.raises(AssertionError):
        replace(cfg, parallel=tcfg.ParallelConfig(num_devices=4,
                                                  tp_devices=2),
                render=replace(cfg.render, occupancy=False)).validate()
    # no process group: num_devices > 1 falls back to the one device
    # there is (JAX's min(n, devices))
    tr = Trainer(_trainer_cfg(num_devices=2), train_s, val_s, device="cpu",
                 workspace=str(tmp_path / "one"))
    assert tr.mesh is None and tr.n_dp == 1


def test_cli_starts_two_ranks_on_the_cpu(tmp_path):
    """``--n_devices 2`` with RAW_NGP_PLATFORM=cpu: the CLI starts two gloo
    ranks itself (a file rendezvous in the workspace), trains, evaluates,
    writes the validation PNGs, the test frames and the checkpoints and
    sweeps the density for the meshes from rank 0, and
    leaves no rendezvous file behind; the step checkpoint's table is the
    whole one."""
    ws = tmp_path / "ws"
    argv = ["unused", "--data_format", "synthetic", "-O", "--iters", "6",
            "--num_rays", "256", "--n_devices", "2", "--grid_size", "16",
            "--samples_per_ray", "8", "--march_candidates", "32",
            "--num_levels", "4", "--level_dim", "2", "--hashmap_size", "10",
            "--hashgrid_resolution", "32", "--grid_mlp_hidden", "16",
            "--view_mlp_hidden", "16", "--workspace", str(ws),
            "--eval_cnt", "1", "--save_cnt", "1", "--mcubes_reso", "32",
            "--env_reso", "16", "--decimate_target", "0",
            "--ckpt", "scratch"]
    code, ret = W.spawn_cli(argv, {"RAW_NGP_PLATFORM": "cpu"})
    assert code == 0 and ret == 0
    files = set(os.listdir(ws))
    assert not [f for f in files if f.startswith(".rendezvous")]
    assert os.path.isfile(ws / "results" / "rgb_000.png")
    assert os.path.isfile(ws / "validation" / "rgb_6_000.png")
    ckpts = sorted(os.listdir(ws / "checkpoints"))
    assert "ngp_step000006.npz" in ckpts and "ngp_best.npz" in ckpts
    with np.load(ws / "checkpoints" / "ngp_step000006.npz") as data:
        assert data["extra.batch_generators"].shape[0] == 2
        from raw_ngp_torch import cli
        spec = t_make_spec(cli.args_to_config(
            cli.build_parser().parse_args(argv))).grid_spec
        assert data["params.grid"].shape == (spec.n_params
                                             * spec.level_dim,)
    log = (ws / "log_ngp.txt").read_text()
    assert log.count("[final eval]") == 1     # rank 0 alone logs
    assert "[cli] meshes" in log              # a 6-step field has no faces
