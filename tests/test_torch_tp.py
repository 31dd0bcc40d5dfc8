"""Tensor parallelism of the port over the hash table's channel axis
(raw_ngp_torch.parallel.tp, NGPField's tp encode) on the CPU: gloo ranks,
one process each (tests/torch_parallel_workers.py, which imports no JAX),
against the port's unsharded encode and gradients and against the JAX
package's single-device gradients (tests/test_tp.py's configuration).

Each test states its tolerance.
"""

from dataclasses import replace
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raw_ngp_torch.config as tcfg
import raw_ngp_tpu.config as jcfg
import raw_ngp_tpu.kernels.segsum_pallas as sp
import raw_ngp_tpu.render.occupancy as jocc
import torch_parallel_workers as W
from raw_ngp_torch.convert import bitfield_from_jax, field_from_jax
from raw_ngp_torch.models.ngp import make_field_spec as t_make_spec
from raw_ngp_torch.ops.hashgrid import HashGridSpec, init_hashgrid_params
from raw_ngp_torch.train.trainer import make_batch_loss_fn as t_batch_loss
from raw_ngp_tpu.data import make_synthetic_scene as j_scene
from raw_ngp_tpu.data.sampler import sample_ray_batch as j_sample
from raw_ngp_tpu.models.ngp import make_field_spec as j_make_spec
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


def tp_cfg(mod, level_dim=2, fused=False):
    """tests/test_tp.py's tp_cfg, from either package's config."""
    cfg = mod.Config()
    cfg = replace(cfg, model=replace(
        cfg.model, num_levels=4, level_dim=level_dim,
        log2_hashmap_size=12, hashgrid_resolution=64, grid_mlp_hidden=16,
        view_mlp_hidden=16, fused_encoder=fused))
    cfg = replace(cfg, render=replace(
        cfg.render, occupancy=True, grid_size=16, samples_per_ray=16,
        march_candidates=64, mark_untrained=False, bound=1.5,
        compact_ratio=0.0))
    cfg = replace(cfg, train=replace(
        cfg.train, iters=100, num_rays=256, fp16=False,
        random_image_batch=True))
    return cfg


def _reference(fn):
    """fn() with JAX's B2 interpreted and XLA's optimizations off (eager
    JAX's rounding; tests/test_torch_march.py)."""
    sp.FORCE_INTERPRET = True
    jax.config.update("jax_disable_most_optimizations", True)
    try:
        return fn()
    finally:
        sp.FORCE_INTERPRET = False
        jax.config.update("jax_disable_most_optimizations", False)


# ---------------------------------------------------------------- features

# tests/test_tp.py's grid at level_dim 4, and the flagship's shape (2
# levels x 16 channels, additive hash, level 0 dense: at 4 channels a
# shard it leaves the matmul split) at a small table
_GRIDS = {
    "tp_cfg_C4": HashGridSpec.create(
        num_levels=4, level_dim=4, log2_hashmap_size=12,
        desired_resolution=64),
    "flagship_C16": HashGridSpec.create(
        num_levels=2, level_dim=16, log2_hashmap_size=12,
        desired_resolution=256, hash_variant="additive"),
}
_MODES = ("f32", "bf16", "unfused")


def _points(B=1000, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.random((B, 3)).astype(np.float32)
    x[:5] = x[:5] * 3.0 - 1.0          # outside [0, 1]^3
    x[6], x[7] = 0.0, 1.0
    return torch.from_numpy(x)


def _tables():
    """A table a grid, U(+-1e-4) from a seed, scaled to a trained grid's
    size (1e-4 would leave bf16's rounding little to do)."""
    return {name: init_hashgrid_params(
        spec, torch.Generator().manual_seed(3)) * 1e3
        for name, spec in _GRIDS.items()}


@pytest.fixture(scope="module")
def tp_features():
    """{tp: {case: the tp encode's features}} from one run of tp ranks a
    tp size, every grid and mode at once."""
    tables, x = _tables(), _points()
    cases = [(f"{g}-{m}", _GRIDS[g], tables[g], m)
             for g in _GRIDS for m in _MODES]
    return {n: W.run_ranks(W.tp_features, n, cases, x, n)
            for n in (2, 4)}


@pytest.mark.parametrize("mode", _MODES)
@pytest.mark.parametrize("grid", sorted(_GRIDS))
@pytest.mark.parametrize("n_tp", [2, 4])
def test_tp_features_equal_the_unsharded_encode(tp_features, n_tp, grid,
                                                mode):
    """Every rank's gathered features of its C/tp-channel shard against the
    unsharded encode (JAX's ngp.py:181-184 claim). Through the fused
    encoder in bf16, the main path's dtype, bit for bit: its arithmetic
    per channel does not depend on the channel count, also where 4
    channels a shard would move the flagship's dense level off the matmul
    split (the shard keeps its table's split, local_grid_spec). In f32,
    fused and plain, the CPU's plain version sums the 8 corners with
    torch's reduction, whose order depends on the channel count (at 2 and
    4 channels against 4 and 16: up to 3 ulps of the largest feature,
    measured); within 1e-6 of the largest feature there, bit for bit
    elsewhere. The card's f32 kernel adds the corners in order per
    channel: chip_smoke.py's multi phase holds it bit for bit."""
    ref = W._np(W.encode(_tables()[grid], _points(), _GRIDS[grid], mode))
    scale = np.abs(ref).max()
    for r, out in enumerate(tp_features[n_tp]):
        got = out[f"{grid}-{mode}"]
        if mode == "bf16":
            np.testing.assert_array_equal(got, ref, err_msg=f"rank {r}")
        else:
            np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6 * scale,
                                       err_msg=f"rank {r}")


# ---------------------------------------------------------------- gradients

def _with_orientation(cfg, lam):
    return replace(cfg, train=replace(cfg.train, lambda_orientation=lam))


def _case(level_dim, fused, lam=0.0):
    """(jax cfg, port cfg, JAX state, the fixed batch, aabb) of
    tests/test_tp.py:67-124, with the orientation loss at weight lam."""
    jc = _with_orientation(tp_cfg(jcfg, level_dim, fused), lam).validate()
    tc = _with_orientation(tp_cfg(tcfg, level_dim, fused), lam).validate()
    state = j_init_state(jax.random.PRNGKey(0), jc, j_make_spec(jc))
    state = state.replace(density_bitfield=jnp.full_like(
        state.density_bitfield, 255))
    ts, _ = j_scene(n_train=4, n_val=1, H=16, W=16)
    batch = j_sample(jax.random.PRNGKey(7), jnp.asarray(ts.images),
                     jnp.asarray(ts.poses), jnp.asarray(ts.intrinsics), 512,
                     random_image_batch=True)
    return jc, tc, state, {k: np.asarray(v) for k, v in batch.items()}, ts


def _blob(tc, state, ts):
    field = field_from_jax(jax.tree_util.tree_map(np.asarray, state.params),
                           t_make_spec(tc), device="cpu")
    return {"field": field.state_dict(),
            "bits": bitfield_from_jax(np.asarray(state.density_bitfield),
                                      "cpu"),
            "aabb": torch.from_numpy(np.asarray(ts.pts_aabb, np.float32))}


def _jax_grads(jc, state, batch, aabb, march=None):
    """JAX's single-device gradient of the batch; with ``march`` a dict,
    the march's outputs captured into it as torch tensors
    (tests/test_torch_regularizers.py's regularised step)."""
    loss_fn = j_batch_loss(jc, j_make_spec(jc))
    march_j = jocc.march_rays

    def j_march(*args, **kwargs):
        m = march_j(*args, **kwargs)
        jax.debug.callback(lambda *a: march.update(
            (k, torch.from_numpy(np.array(v))) for k, v in zip(m, a)),
            *m.values())
        return m

    with pytest.MonkeyPatch.context() as mp:
        if march is not None:
            mp.setattr(jocc, "march_rays", j_march)
        g = _reference(lambda: jax.block_until_ready(jax.jit(jax.grad(
            lambda p: loss_fn(p, state, jax.tree_util.tree_map(
                jnp.asarray, batch), jnp.asarray(aabb), None, 1.0,
                True)[0]))(state.params)))
    out = {"grid": np.asarray(g["grid"]).reshape(-1)}
    for net in ("grid_mlp", "view_mlp"):
        for i, layer in enumerate(g[net]):
            out[f"{net}.{i}"] = np.asarray(layer["w"])
    return out


def _port_grads(tc, blob, batch):
    """The port's single-device gradient of the whole batch (through the
    march ``blob["march"]`` where the blob holds one)."""
    spec, field = W._field(tc, blob["field"])
    with W.given_march(blob.get("march"), slice(None)):
        loss, _ = t_batch_loss(tc, spec)(
            field, SimpleNamespace(density_bitfield=blob["bits"]), batch,
            blob["aabb"], None)
    loss.backward()
    return {k: p.grad.numpy() for k, p in field.named_parameters()
            if p.grad is not None}


_GRAD_CASES = [(False, 2), (True, 4), (True, 2)]


@pytest.mark.parametrize("lam", [0.0, 1e-2])
@pytest.mark.parametrize("fused,level_dim", _GRAD_CASES)
def test_tp_grads_match_single_device(fused, level_dim, lam):
    """The gradient of one fixed 512-ray batch on (dp = 2, tp = 2): each
    rank's channel shard (C = 1 at fused level_dim 2, the -O grid's shard
    at tp = 2), the dp rows' halves of the rays, the tp step's reduction
    (the table gradient divided by n_tp, the dp mean), the table gathered
    whole: the same bits on every rank.

    Without the orientation loss, against the port's single-device
    gradient and JAX's single-device one within tests/test_tp.py's
    tolerance, rtol 1e-5, atol 2e-6 fused / 1e-7 unfused plus 1e-6 of
    each leaf's largest entry (measured: the cross-package differences of
    the table are those of the two packages' single-device gradients,
    tests/test_torch_parallel.py).

    With the orientation loss at lam 1e-2 (its inner gradient summed over
    the row, parallel.tp.sum_over_tp), every package's render through
    JAX's march (captured, as tests/test_torch_regularizers.py's
    regularised step: an ulp of a sample's position moves its normal
    where the density's gradient has a kink, and the gradient by up to
    13% of a leaf's largest entry between the packages' own marches,
    port_tools/jax_tp_orientation_probe.py). Against
    the port's single device at rtol 1e-5, atol 1e-6 of each leaf's
    largest entry (measured at most 1.3e-6 of the largest), but the
    fused table within 1e-4 of its largest (measured 3.1e-5 at C = 2 a
    shard, 5.0e-6 at C = 1): there the orientation's term is a
    rounding residue (the normal does not depend on the density
    activation's slope, tests/test_torch_regularizers.py) and tp sums the
    inner gradient in another order. Against JAX's single-device gradient
    within 1e-4 of each MLP leaf's largest entry and 5e-4 of the table's
    (measured at most 2.7e-5 and 1.3e-4; the packages' single-device
    gradients differ by as much, the table's by 1.0e-4 already without
    the orientation loss). The orientation term nonzero on every dp row.
    JAX's own tp step is not the reference there: its inner gradient is
    not summed over tp (ROADMAP Queue C, port_tools/jax_tp_orientation_
    probe.py)."""
    jc, tc, state, batch, ts = _case(level_dim, fused, lam)
    blob = _blob(tc, state, ts)
    blob["batch"] = {k: torch.from_numpy(v) for k, v in batch.items()}
    march = {} if lam else None
    g_j = _jax_grads(jc, state, batch, ts.pts_aabb, march)
    if lam:
        blob["march"] = march
    out = W.run_ranks(W.batch_grads, 4, tc, blob, 2, 2)
    # each dp row's orientation term, the same on the row's two tp ranks
    orient = [o.pop("orientation_loss", None) for o in out]
    assert orient[0] == orient[1] and orient[2] == orient[3], orient
    for r in range(1, 4):
        for k in out[0]:
            np.testing.assert_array_equal(out[r][k], out[0][k],
                                          err_msg=f"{k} rank {r}")
    single = _port_grads(tc, blob, blob["batch"])
    assert set(out[0]) == set(single) == set(g_j)
    if lam:
        assert min(orient) > 0, orient
        for k, g in single.items():
            scale = np.abs(g).max()
            assert scale > 0, k
            if fused and k == "grid":
                # the fused table's orientation term is a rounding residue
                # (tests/test_torch_regularizers.py), which tp's order of
                # the inner gradient's sum rounds otherwise
                assert np.abs(out[0][k] - g).max() <= 1e-4 * scale, k
                continue
            np.testing.assert_allclose(
                out[0][k], g, rtol=1e-5, atol=1e-6 * scale,
                err_msg=f"{k} against the port single device")
        for k, g in g_j.items():
            err = np.abs(out[0][k] - g).max() / np.abs(g).max()
            assert err <= (5e-4 if k == "grid" else 1e-4), (k, err)
        return
    assert orient == [None] * 4
    atol = 2e-6 if fused else 1e-7
    for ref_name, ref in (("port", single), ("jax", g_j)):
        for k, g in ref.items():
            scale = np.abs(g).max() + 1e-12
            np.testing.assert_allclose(
                out[0][k], g, rtol=1e-5, atol=atol + 1e-6 * scale,
                err_msg=f"{k} against the {ref_name} single device")


def test_tp_pose_grads_match_single_device():
    """Pose refinement under tp (tests/test_tp.py:185): the se(3)
    gradient of fixed pixels (explicit coords, BARF, nonzero refinements)
    on (dp = 1, tp = 2), each rank's through its shard's input gradient,
    summed over the row and divided by n_tp: the same bits on both ranks;
    against the port's and JAX's single-device pose gradient, rtol 1e-5,
    atol 2e-6 plus 1e-6 of the largest entry (tests/test_tp.py's)."""
    jc = tp_cfg(jcfg, 4, True).with_pose_opt("barf", 4)
    tc = tp_cfg(tcfg, 4, True).with_pose_opt("barf", 4)
    jc = replace(jc, train=replace(jc.train, random_image_batch=False))
    tc = replace(tc, train=replace(tc.train, random_image_batch=False))
    jc, tc = jc.validate(), tc.validate()
    state = j_init_state(jax.random.PRNGKey(0), jc, j_make_spec(jc),
                         num_cameras=4)
    state = state.replace(density_bitfield=jnp.full_like(
        state.density_bitfield, 255))
    ts, _ = j_scene(n_train=4, n_val=1, H=16, W=16)
    rng = np.random.default_rng(5)
    n = 256
    coords = np.stack([rng.integers(2, 14, n), rng.integers(2, 14, n)], -1)
    idx = rng.integers(0, 4, n)
    pose = (rng.standard_normal((4, 6)) * 0.01).astype(np.float32)
    aabb = np.asarray(ts.pts_aabb, np.float32)

    loss_fn = j_batch_loss(jc, j_make_spec(jc))

    def j_loss(pose_params):
        batch = j_sample(
            jax.random.PRNGKey(0), jnp.asarray(ts.images),
            jnp.asarray(ts.poses), jnp.asarray(ts.intrinsics), n,
            random_image_batch=False, se3_refine=pose_params,
            coords=jnp.asarray(coords),
            coord_image_indices=jnp.asarray(idx))
        return loss_fn(state.params, state, batch, jnp.asarray(aabb), None,
                       1.0, True)[0]

    gp_j = np.asarray(_reference(lambda: jax.jit(jax.grad(j_loss))(
        jnp.asarray(pose))))

    blob = _blob(tc, state, ts)
    blob.update(pose=torch.from_numpy(pose), coords=torch.from_numpy(coords),
                index=torch.from_numpy(idx),
                scene={k: torch.from_numpy(np.asarray(getattr(ts, k)))
                       for k in ("images", "poses", "intrinsics")})
    out = W.run_ranks(W.pose_grads, 2, tc, blob, 2)
    np.testing.assert_array_equal(out[1], out[0])

    from raw_ngp_torch.data.sampler import sample_ray_batch
    spec, field = W._field(tc, blob["field"])
    pose_t = blob["pose"].clone().requires_grad_(True)
    sc = blob["scene"]
    batch = sample_ray_batch(None, sc["images"], sc["poses"],
                             sc["intrinsics"], n, se3_refine=pose_t,
                             coords=blob["coords"],
                             coord_image_indices=blob["index"])
    loss, _ = t_batch_loss(tc, spec)(
        field, SimpleNamespace(density_bitfield=blob["bits"]), batch,
        blob["aabb"], None)
    loss.backward()
    for name, ref in (("port", pose_t.grad.numpy()), ("jax", gp_j)):
        scale = np.abs(ref).max() + 1e-12
        assert scale > 1e-9, name
        np.testing.assert_allclose(out[0], ref, rtol=1e-5,
                                   atol=2e-6 + 1e-6 * scale,
                                   err_msg=f"against the {name} pose "
                                           f"gradient")


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_tp_trainer_trains_the_orientation_loss(tmp_path, fused):
    """The Trainer on (dp = 1, tp = 2) with the orientation loss (lam 0.1,
    level_dim 2: fused, a C = 1 shard a rank), 3 steps through the tp
    step: finite losses, the orientation term finite and nonzero at every
    step and the same on both ranks, every replicated tensor (and the
    gathered tables) bitwise equal across the ranks."""
    cfg = replace(_with_orientation(tp_cfg(tcfg, 2, fused), 0.1),
                  parallel=tcfg.ParallelConfig(num_devices=2, tp_devices=2),
                  ckpt="scratch").validate()
    scene = dict(n_train=8, n_val=1, H=24, W=24)
    out = W.run_ranks(W.trainer_run, 2, cfg, scene, str(tmp_path / "ws"), 3)
    for o in out:
        assert (o["n_dp"], o["n_tp"]) == (1, 2)
        assert o["grid_shape"] == (t_make_spec(cfg).grid_spec.n_params,)
        assert np.isfinite(o["losses"]).all()
        assert len(o["orientation"]) == 3
        assert np.isfinite(o["orientation"]).all()
        assert min(o["orientation"]) > 0
        assert o["orientation"] == out[0]["orientation"]
        for k, v in out[0]["state"].items():
            np.testing.assert_array_equal(o["state"][k], v, err_msg=k)


# ---------------------------------------------------------------- guards

def test_tp_validate_guards():
    """JAX's tp guards, kept by the port's Config.validate
    (tests/test_tp.py's): tp must divide level_dim, tp needs the
    occupancy path, and the grid regularizers are not tp-aware."""
    cfg = tp_cfg(tcfg, level_dim=2)
    with pytest.raises(AssertionError):
        replace(cfg, parallel=tcfg.ParallelConfig(
            num_devices=8, tp_devices=3)).validate()
    with pytest.raises(AssertionError):
        replace(cfg, parallel=tcfg.ParallelConfig(num_devices=8,
                                                  tp_devices=2),
                render=replace(cfg.render, occupancy=False)).validate()
    with pytest.raises(AssertionError):
        replace(cfg, parallel=tcfg.ParallelConfig(num_devices=4,
                                                  tp_devices=2),
                train=replace(cfg.train, lambda_tv=1e-6)).validate()
