"""Parity of the port's light-stage path (raw_ngp_torch: the RawNeRF loss
and its weightings, the sampler's exposures, light directions and Bayer
loss mask, the rfield field, the render with light directions, one HDR +
rfield train step and the HDR evaluation) with the JAX package's, on the
CPU.

The configuration is the golden miniature of the flagship
(tests/test_torch_train.py ``mini_cfg``) with the light-stage switches of
``tools/quality_run.py --hdr --rfield``: ``data.image_mode="HDR"``,
``model.color_activation="clamped_exp"`` and ``model.rfield=True``; the
scene is ``make_synthetic_scene(..., hdr=True, rfield=True)``. Both
packages get the same numpy inputs: parameters from the JAX init carried
across by raw_ngp_torch.convert, the same bitfield, rays, exposures,
light directions and pixel coords. JAX runs eagerly where the march
matters (tests/test_torch_render.py says why) and its table gradient
runs the Pallas segment-totals kernel interpreted
(``segsum_pallas.FORCE_INTERPRET``). Each test states its tolerance and
the reason for it.
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
from raw_ngp_torch.convert import bitfield_from_jax, field_from_jax
from raw_ngp_torch.data import make_synthetic_scene
from raw_ngp_torch.data.sampler import bayer_lossmult as t_bayer
from raw_ngp_torch.data.sampler import sample_ray_batch as t_sample
from raw_ngp_torch.models.ngp import init_field as t_init_field
from raw_ngp_torch.models.ngp import make_field_spec as t_make_spec
from raw_ngp_torch.render import occupancy as tocc
from raw_ngp_torch.render.eval import render_image, scene_aabb
from raw_ngp_torch.train import losses as tl
from raw_ngp_torch.train import trainer as ttr
from raw_ngp_tpu.data.sampler import bayer_lossmult as j_bayer
from raw_ngp_tpu.data.sampler import sample_ray_batch as j_sample
from raw_ngp_tpu.models.ngp import field_forward as j_field_forward
from raw_ngp_tpu.models.ngp import init_field as j_init_field
from raw_ngp_tpu.models.ngp import make_field_spec as j_make_spec
from raw_ngp_tpu.ops import grid as jgrid
from raw_ngp_tpu.ops.morton import morton3d_invert as j_morton_invert
from raw_ngp_tpu.ops.rays import full_image_rays as j_full_image_rays
from raw_ngp_tpu.render import occupancy as jocc
from raw_ngp_tpu.train import losses as jl
from raw_ngp_tpu.train import trainer as jtr


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's torch work, set back after
    it (under pytest-xdist torch's default of a thread a core
    oversubscribes the cores: tests/test_torch_proposal.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def light_cfg(mod, fp16=False, loss_weight="none"):
    """The golden miniature of the flagship with the light-stage switches
    (HDR images, clamped_exp colours, rfield), from either package's
    config module."""
    cfg = mod.Config().with_preset_O().with_tpu_profile()
    cfg = replace(cfg, model=replace(
        cfg.model, log2_hashmap_size=12, hashgrid_resolution=64,
        grid_mlp_hidden=16, view_mlp_hidden=16, rfield=True,
        color_activation="clamped_exp"))
    cfg = replace(cfg, render=replace(
        cfg.render, grid_size=32, samples_per_ray=24, march_candidates=24,
        max_ray_batch=4096))
    cfg = replace(cfg, train=replace(cfg.train, iters=150, num_rays=512,
                                     seed=0, fp16=fp16,
                                     adaptive_num_rays=False,
                                     loss_weight=loss_weight))
    cfg = replace(cfg, data=replace(cfg.data, image_mode="HDR"))
    return replace(cfg, ckpt="scratch").validate()


def _np(t):
    return t.detach().cpu().numpy()


def _unit(rng, n):
    v = rng.standard_normal((n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


# ------------------------------------------------------------ losses

def _loss_inputs(n=257, seed=0):
    """HDR-like predictions (clamped_exp colours, some above 1, some 0),
    GT in [0, 1] with exact zeros (dark pixels: weights up to 1e6), the
    synthetic scene's exposures, a Bayer mask, and one prediction whose
    clip ties at 1 exactly (0.25 * 4)."""
    rng = np.random.default_rng(seed)
    pred = np.exp(rng.uniform(-8.0, 1.0, (n, 3))).astype(np.float32)
    pred[:7] = 0.0
    gt = np.minimum(1.0, rng.uniform(0.0, 1.2, (n, 3))).astype(np.float32)
    gt[::3] = 0.0
    exposure = rng.choice(np.array([0.25, 1.0, 4.0], np.float32),
                          (n, 1)).astype(np.float32)
    pred[7], exposure[7] = 0.25, 4.0
    rows, cols = rng.integers(0, 64, n), rng.integers(0, 64, n)
    mult = np.array(j_bayer(jnp.asarray(rows), jnp.asarray(cols)))
    return pred, gt, exposure, mult


@pytest.mark.parametrize("kind", ["gaussian", "hanning", "planck"])
def test_loss_weightings_match_jax(kind):
    """Each weighting (and loss_weight_fn's dispatch to it) on the same
    values, f32: exp and cos may round an ulp apart, rtol 1e-6 plus 2.4e-7
    (two ulps at 1). Hanning's 0.5 - 0.5 cos(.) near the window's ends is
    a difference of nearly equal numbers, so one ulp of cos is 7.9e-6 of
    the weight there (measured; 1.2e-7 absolute). Gaussian's and
    hanning's weights carry no gradient in either package."""
    _, gt, _, _ = _loss_inputs()
    fn = {"gaussian": "gaussian_weighting", "hanning": "hanning_weighting",
          "planck": "planck_taper_weighting"}[kind]
    want = np.asarray(getattr(jl, fn)(jnp.asarray(gt)))
    x = torch.from_numpy(gt).requires_grad_()
    got = getattr(tl, fn)(x)
    np.testing.assert_allclose(_np(got), want, rtol=1e-6, atol=2.4e-7)
    np.testing.assert_allclose(_np(tl.loss_weight_fn(kind, x)),
                               np.asarray(jl.loss_weight_fn(
                                   kind, jnp.asarray(gt))),
                               rtol=1e-6, atol=2.4e-7)
    assert got.shape == gt.shape
    if kind != "planck":          # the reference's planck has a gradient
        assert not got.requires_grad
    assert tl.loss_weight_fn("none", x) == 1.0


@pytest.mark.parametrize("with_mult", [False, True])
@pytest.mark.parametrize("kind", ["none", "gaussian", "hanning", "planck"])
def test_rawnerf_loss_and_gradient_match_jax(kind, with_mult):
    """rawnerf_loss forward and its gradient in pred_rgb, f32, with the
    weight of ``kind`` and with (Bayer mask) or without (1.0) lossmult.
    The gradient is d(clip)/d(pred) times the residual term only, so it
    shows whether the scaling's stop-gradient is in place; at the tie
    clip == 1 both packages split it in half. The loss is a sum over 3N
    terms in another order: rtol 1e-6 (measured at most 1.5e-7). The
    gradient is elementwise, its products in another order: rtol 1e-6
    plus 1e-6 of its largest entry, for hanning's weight near the
    window's ends (test_loss_weightings_match_jax; measured 7.9e-6
    relative there, 2.3e-7 elsewhere)."""
    pred, gt, exposure, mult = _loss_inputs()
    lm = mult if with_mult else 1.0

    def j_loss(p):
        g = jnp.asarray(gt)
        return jl.rawnerf_loss(p, g, jnp.asarray(exposure),
                               jnp.asarray(lm) if with_mult else 1.0,
                               jl.loss_weight_fn(kind, g))

    loss_j, grad_j = jax.value_and_grad(j_loss)(jnp.asarray(pred))
    p = torch.from_numpy(pred).requires_grad_()
    g = torch.from_numpy(gt)
    loss_t = tl.rawnerf_loss(p, g, torch.from_numpy(exposure),
                             torch.from_numpy(mult) if with_mult else 1.0,
                             tl.loss_weight_fn(kind, g))
    loss_t.backward()
    assert float(loss_j) > 0
    np.testing.assert_allclose(float(loss_t.detach()), float(loss_j),
                               rtol=1e-6)
    grad_j = np.asarray(grad_j)
    np.testing.assert_allclose(_np(p.grad), grad_j, rtol=1e-6,
                               atol=1e-6 * np.abs(grad_j).max())
    # the tie row keeps half the gradient where its mask lets it through
    live = mult[7] > 0 if with_mult else np.ones(3, bool)
    assert (grad_j[7][live] != 0).all()


# ----------------------------------------------------------- sampler

def test_bayer_lossmult_bit_identical():
    rows, cols = np.meshgrid(np.arange(6), np.arange(7), indexing="ij")
    want = np.asarray(j_bayer(jnp.asarray(rows), jnp.asarray(cols)))
    got = _np(t_bayer(torch.from_numpy(rows), torch.from_numpy(cols)))
    assert got.dtype == np.float32 and got.shape == (6, 7, 3)
    np.testing.assert_array_equal(got, want)
    assert (got.sum(-1) == 1).all()
    np.testing.assert_array_equal(got[0, 0], [1, 0, 0])
    np.testing.assert_array_equal(got[1, 1], [0, 0, 1])


def test_sampler_light_stage_outputs_bit_identical():
    """The coords hook with exposures, light directions and mosaiced:
    rays, GT pixels, exposure, rays_ldir and lossmult bit for bit."""
    train, _ = make_synthetic_scene(n_train=5, n_val=1, H=24, W=32, seed=0,
                                    hdr=True, rfield=True)
    rng = np.random.default_rng(4)
    n = 257
    coords = np.stack([rng.integers(0, 24, n), rng.integers(0, 32, n)], -1)
    idx = rng.integers(0, 5, n)
    bj = j_sample(jax.random.PRNGKey(0), jnp.asarray(train.images),
                  jnp.asarray(train.poses), jnp.asarray(train.intrinsics), n,
                  exposures=jnp.asarray(train.exposures),
                  ldirs=jnp.asarray(train.ldirs), mosaiced=True,
                  coords=jnp.asarray(coords),
                  coord_image_indices=jnp.asarray(idx))
    bt = t_sample(None, torch.from_numpy(train.images),
                  torch.from_numpy(train.poses),
                  torch.from_numpy(train.intrinsics), n,
                  exposures=torch.from_numpy(train.exposures),
                  ldirs=torch.from_numpy(train.ldirs), mosaiced=True,
                  coords=torch.from_numpy(coords),
                  coord_image_indices=torch.from_numpy(idx))
    assert sorted(bt) == sorted(bj)
    assert bt["exposure"].shape == (n, 1) and bt["rays_ldir"].shape == (n, 3)
    assert bt["lossmult"].shape == (n, 3)
    for k in bj:
        np.testing.assert_array_equal(_np(bt[k]), np.asarray(bj[k]),
                                      err_msg=k)


# ------------------------------------------------------------- field

def _field_pair(fp16):
    jc, tc = light_cfg(jcfg, fp16), light_cfg(tcfg, fp16)
    jspec, tspec = j_make_spec(jc), t_make_spec(tc)
    params = jax.tree_util.tree_map(
        np.asarray, j_init_field(jax.random.PRNGKey(1), jspec))
    rng = np.random.default_rng(0)
    params["grid"] = rng.uniform(-1.0, 1.0,
                                 params["grid"].shape).astype(np.float32)
    return jspec, tspec, params, field_from_jax(params, tspec, device="cpu")


@pytest.mark.parametrize("fp16", [False, True])
def test_rfield_field_forward_matches_jax(fp16):
    """The rfield field (view MLP 15 + 16 + 16 wide in, hidden 16 + 16)
    carried across by field_from_jax, at positions, view and light
    directions: the tolerances of tests/test_torch_field.py (f32 atol
    1e-5; bf16 rtol 1e-3, the MLPs' f32 sum order)."""
    jspec, tspec, params, field = _field_pair(fp16)
    assert [tuple(w.shape) for w in field.view_mlp] == \
        [tuple(l["w"].shape) for l in params["view_mlp"]]
    assert field.view_mlp[0].shape == (15 + 16 + 16, 32)
    rng = np.random.default_rng(1)
    n = 512
    x = rng.uniform(-2.0, 2.0, (n, 3)).astype(np.float32)
    d, ld = _unit(rng, n), _unit(rng, n)
    sig_j, rgb_j = (np.asarray(a) for a in j_field_forward(
        params, jspec, jnp.asarray(x), jnp.asarray(d), jnp.asarray(ld)))
    with torch.no_grad():
        sig_t, rgb_t = (a.numpy() for a in field(
            torch.from_numpy(x), torch.from_numpy(d), torch.from_numpy(ld)))
        _, rgb_o = field(torch.from_numpy(x), torch.from_numpy(d),
                         torch.from_numpy(-ld))
    tol = dict(rtol=1e-3, atol=0) if fp16 else dict(rtol=0, atol=1e-5)
    np.testing.assert_allclose(sig_t, sig_j, **tol)
    np.testing.assert_allclose(rgb_t, rgb_j, **tol)
    assert np.abs(rgb_o.numpy() - rgb_t).max() > 1e-3   # ld is read


def test_rfield_needs_light_dirs():
    """Mirror of tests/test_model_render.py::test_rfield_needs_light_dirs:
    an rfield field raises ValueError without light directions."""
    tc = light_cfg(tcfg)
    field = t_init_field(t_make_spec(tc), seed=0, device="cpu")
    x = torch.zeros(4, 3)
    d = torch.tensor([[0.0, 0.0, 1.0]]).repeat(4, 1)
    with pytest.raises(ValueError):
        field(x, d)
    sigma, color = field(x, d, ld=d)
    assert color.shape == (4, 3) and sigma.shape == (4,)


# ------------------------------------------------- render and one step

@pytest.fixture(scope="module")
def light():
    jc, tc = light_cfg(jcfg), light_cfg(tcfg)
    jspec = j_make_spec(jc)
    params = jax.tree_util.tree_map(
        np.array, j_init_field(jax.random.PRNGKey(0), jspec))
    # a table of trained-like magnitude and a colour head scaled so that
    # clamped_exp's colours span ~1e-4 to 5 (at the init's scale they sit
    # near exp(-5)), as a trained HDR field's do
    rng = np.random.default_rng(2)
    params["grid"] = rng.uniform(-1.0, 1.0,
                                 params["grid"].shape).astype(np.float32)
    params["view_mlp"][-1]["w"] *= np.float32(8.0)
    n = jc.render.grid_size
    xyz = np.asarray(j_morton_invert(jnp.arange(n ** 3, dtype=jnp.uint32)))
    rng = np.random.default_rng(3)
    dg = np.zeros((jc.cascades, n ** 3), np.float32)
    for cas in range(jc.cascades):
        p = (2.0 * xyz / (n - 1) - 1.0) * min(2 ** cas, jc.render.bound)
        dg[cas] = np.where(np.linalg.norm(p, axis=-1) < 1.0, 20.0, 0.0)
        dg[cas] += 20.0 * (rng.random(n ** 3) < 0.02)
    bits = np.asarray(jgrid.packbits(jnp.asarray(dg), 10.0))
    train, val = make_synthetic_scene(n_train=12, n_val=1, H=32, W=32,
                                      seed=0, hdr=True, rfield=True)
    aabb = scene_aabb(tc, train.pts_aabb, device="cpu").numpy()
    return SimpleNamespace(jc=jc, tc=tc, jspec=jspec, params=params,
                           bits=bits, train=train, val=val, aabb=aabb)


def test_render_occupancy_with_light_dirs_matches_jax(light):
    """render_occupancy of the 512 rays of the val view's middle rows
    with per-ray light directions (unit, scaled by 3, and zero, which both
    packages replace by +z without normalizing), key=None, against eager
    JAX: image, depth and weights_sum at atol 1e-4, the tolerance of
    tests/test_torch_render.py (measured 1.5e-8 on the image, 3.6e-7 on
    depth). The mirrored light gives another image (measured: 0.039 at
    most)."""
    s = light
    ro, rd = j_full_image_rays(jnp.asarray(s.val.poses[0]),
                               jnp.asarray(s.val.intrinsics), 32, 32)
    ro, rd = np.array(ro)[256:768], np.array(rd)[256:768]
    rng = np.random.default_rng(6)
    ld = _unit(rng, 512)
    ld[::7] *= 3.0
    ld[::11] = 0.0
    out_j = jocc.render_occupancy(
        s.params, s.jspec, jnp.asarray(ro), jnp.asarray(rd),
        jnp.asarray(s.aabb), jnp.asarray(s.bits), key=None, bg_color=0.0,
        training=False, rays_ldir=jnp.asarray(ld))
    field = field_from_jax(s.params, t_make_spec(s.tc), device="cpu")
    bits = bitfield_from_jax(s.bits, device="cpu")
    args = (field, torch.from_numpy(ro), torch.from_numpy(rd),
            torch.from_numpy(s.aabb), bits)
    with torch.no_grad():
        out_t = tocc.render_occupancy(*args, rays_ldir=torch.from_numpy(ld))
        out_m = tocc.render_occupancy(
            *args, rays_ldir=torch.from_numpy(-ld * np.float32([1, 1, -1])))
    assert float(np.asarray(out_j["weights_sum"]).max()) > 0.1
    for k in ("image", "depth", "weights_sum"):
        np.testing.assert_allclose(out_t[k].numpy(), np.asarray(out_j[k]),
                                   atol=1e-4, rtol=0, err_msg=k)
    assert float((out_m["image"] - out_t["image"]).abs().max()) > 1e-4
    with pytest.raises(ValueError):
        tocc.render_occupancy(*args)


def test_render_image_with_light_dir_matches_jax_chunks(light):
    """render_image of a 24x24 view under one light direction in 512-ray
    chunks, so the last chunk is padded, against JAX's render of the same
    padded chunks with the direction broadcast to each chunk after the
    padding, as the JAX trainer's render_image does (trainer.py:903-913):
    atol 1e-4, the tolerance of tests/test_torch_render.py."""
    s = light
    H = W = 24
    intr = s.val.intrinsics * (H / 32.0)
    ro, rd = j_full_image_rays(jnp.asarray(s.val.poses[0]),
                               jnp.asarray(intr), H, W)
    ro, rd = np.array(ro), np.array(rd)
    ld = s.val.ldirs[0]
    chunk, N = 512, H * W
    imgs = []
    for a in range(0, N, chunk):
        e = min(a + chunk, N)
        pad = chunk - (e - a)
        cro = np.pad(ro[a:e], ((0, pad), (0, 0)))
        crd = np.pad(rd[a:e], ((0, pad), (0, 0)), constant_values=1.0)
        out = jocc.render_occupancy(
            s.params, s.jspec, jnp.asarray(cro), jnp.asarray(crd),
            jnp.asarray(s.aabb), jnp.asarray(s.bits), key=None,
            bg_color=0.0, training=False,
            rays_ldir=jnp.broadcast_to(jnp.asarray(ld), cro.shape))
        imgs.append(np.asarray(out["image"])[: e - a])
    tc = replace(s.tc, render=replace(s.tc.render, max_ray_batch=chunk))
    field = field_from_jax(s.params, t_make_spec(tc), device="cpu")
    rgb, _ = render_image(field, bitfield_from_jax(s.bits, device="cpu"),
                          s.val.poses[0], intr, H, W,
                          torch.from_numpy(s.aabb), device="cpu", ldir=ld)
    want = np.concatenate(imgs)
    assert want.max() > 0.01
    np.testing.assert_allclose(rgb.numpy().reshape(-1, 3), want, atol=1e-4,
                               rtol=0)


def _interpreted(fn):
    sp.FORCE_INTERPRET = True
    try:
        return fn()
    finally:
        sp.FORCE_INTERPRET = False


@pytest.mark.parametrize("loss_weight", ["none", "gaussian"])
@pytest.mark.parametrize("fp16", [False, True])
def test_one_hdr_rfield_step_matches_jax(light, fp16, loss_weight):
    """One HDR + rfield step on the light-stage miniature with the same
    params, bitfield and explicit ray batch (exposure, rays_ldir and the
    Bayer lossmult in it), key=None: the loss and the gradient of each
    leaf against eager JAX jax.value_and_grad(make_batch_loss_fn(...))
    with the interpreted B2. The RawNeRF weight 1/(1e-3 + clip)^2 is up
    to 1e6 on the scene's black pixels, so every colour difference is
    magnified there: a few dark pixels carry most of each leaf's
    gradient. Loss: sums in other orders, measured at most 1.2e-7
    relative (f32 and bf16), held at rtol 1e-5 as the LDR step
    (tests/test_torch_train.py). f32 leaves: the MLPs' at most 2.1e-7 of
    their largest entry, held at 1e-4 as the LDR step. The table's window
    level, in both packages, rounds each w * g product to bf16 (B2's
    payload); a cotangent one f32 ulp apart (sum order) can move one
    product by a bf16 ulp, which the weight makes large: measured 8.6e-5
    of the table's largest entry, held at 2e-4. bf16: the encode forward
    is JAX's bit for bit, but the MLPs' outputs can round one bf16 ulp
    (2^-8 relative) apart by f32 sum order, and where that pixel
    dominates a leaf the ulp reaches its largest entry: measured at most
    6.9e-4 without a weight and 4.4e-3 with the gaussian one (the table;
    3.0e-3 on grid_mlp.1), held at 1e-2, against the LDR step's 1e-3.
    """
    s = light
    jc = light_cfg(jcfg, fp16, loss_weight)
    tc = light_cfg(tcfg, fp16, loss_weight)
    jspec, tspec = j_make_spec(jc), t_make_spec(tc)
    rng = np.random.default_rng(5)
    n = 512
    coords = np.stack([rng.integers(8, 24, n), rng.integers(8, 24, n)], -1)
    idx = rng.integers(0, s.train.n_images, n)
    batch_j = j_sample(jax.random.PRNGKey(0), jnp.asarray(s.train.images),
                       jnp.asarray(s.train.poses),
                       jnp.asarray(s.train.intrinsics), n,
                       exposures=jnp.asarray(s.train.exposures),
                       ldirs=jnp.asarray(s.train.ldirs), mosaiced=True,
                       coords=jnp.asarray(coords),
                       coord_image_indices=jnp.asarray(idx))
    assert {"exposure", "rays_ldir", "lossmult"} <= set(batch_j)
    jstate = SimpleNamespace(density_bitfield=jnp.asarray(s.bits))
    fn = jtr.make_batch_loss_fn(jc, jspec)
    (loss_j, aux_j), g_j = _interpreted(lambda: jax.value_and_grad(
        fn, has_aux=True)(jax.tree_util.tree_map(jnp.asarray, s.params),
                          jstate, batch_j, jnp.asarray(s.aabb), None, 1.0,
                          True))

    field = field_from_jax(s.params, tspec, device="cpu")
    batch_t = {k: torch.from_numpy(np.array(v)) for k, v in batch_j.items()}
    tstate = SimpleNamespace(density_bitfield=bitfield_from_jax(
        s.bits, device="cpu"))
    loss_t, aux_t = ttr.make_batch_loss_fn(tc, tspec)(
        field, tstate, batch_t, torch.from_numpy(s.aabb))
    loss_t.backward()
    assert int(aux_t["num_points"]) == int(aux_j["num_points"]) > 0
    np.testing.assert_allclose(float(loss_t.detach()), float(loss_j),
                               rtol=1e-5)
    tol = {"grid": 1e-2 if fp16 else 2e-4}
    leaves = [("grid", field.grid, g_j["grid"])]
    leaves += [(f"grid_mlp.{i}", w, g_j["grid_mlp"][i]["w"])
               for i, w in enumerate(field.grid_mlp)]
    leaves += [(f"view_mlp.{i}", w, g_j["view_mlp"][i]["w"])
               for i, w in enumerate(field.view_mlp)]
    for name, p, gj in leaves:
        gj = np.asarray(gj, np.float32).reshape(p.shape)
        scale = np.abs(gj).max()
        assert scale > 0, name
        atol = tol.get(name, 1e-2 if fp16 else 1e-4) * scale
        np.testing.assert_allclose(_np(p.grad), gj, rtol=0, atol=atol,
                                   err_msg=name)


# -------------------------------------------------- trainer, HDR eval

def test_hdr_evaluate_sets_exposure_levels_and_clipped_psnr(tmp_path):
    """Mirror of tests/test_trainer_features.py::
    test_exposure_levels_estimated_on_hdr_eval on the port's Trainer
    (HDR + rfield, CPU): no levels before the first HDR evaluate; after
    it, one finite level per configured percentile, monotone, equal to
    the percentiles of the exposure-1.0 view's render under its light
    direction, and stored on the scene meta. The PSNR is the mean over
    views of the clipped comparison min(1, rgb * exposure) against
    min(1, gt), recomputed in numpy from render_image with each view's
    light direction."""
    cfg = light_cfg(tcfg)
    ts, vs = make_synthetic_scene(n_train=4, n_val=2, H=16, W=16, seed=0,
                                  hdr=True, rfield=True)
    vs.exposures[0] = 1.0
    vs.exposures[1] = 0.25
    tr = ttr.Trainer(cfg, ts, vs, device="cpu", workspace=str(tmp_path))
    assert set(tr.scene_arrays) >= {"exposures", "ldirs"}
    tr.train(iters=2, log_every=2)
    assert np.isfinite(tr.stats["loss"]).all()
    assert tr.exposure_levels == {}
    psnr = tr.evaluate()["psnr"]
    assert set(tr.exposure_levels) == set(cfg.exposure_percentiles)
    vals = [tr.exposure_levels[p] for p in sorted(tr.exposure_levels)]
    assert all(np.isfinite(v) for v in vals)
    assert vals == sorted(vals)
    assert vs.meta.exposure_levels == tr.exposure_levels
    rgb0, _ = tr.render_image(vs.poses[0], vs.intrinsics, 16, 16,
                              ldir=vs.ldirs[0])
    for p, v in tr.exposure_levels.items():
        assert v == float(np.percentile(rgb0, p))
    want = []
    for i in range(vs.n_images):
        rgb, _ = tr.render_image(vs.poses[i], vs.intrinsics, 16, 16,
                                 ldir=vs.ldirs[i])
        mse = np.mean((np.minimum(1.0, rgb.astype(np.float64)
                                  * vs.exposures[i])
                       - np.minimum(1.0, vs.images[i][..., :3])) ** 2)
        want.append(-10.0 * np.log10(mse))
    np.testing.assert_allclose(psnr, np.mean(want), rtol=1e-6)
