"""Parity of the port's occupancy render (raw_ngp_torch.render) with the
JAX package's, on the CPU.

The configuration is the golden miniature of the flagship
(tests/test_golden_occupancy.py: log2 12, res 64, hidden 16, grid 32,
S = K = 24, fp32). Both packages get the same parameters (JAX init,
carried across by raw_ngp_torch.convert) and the same bitfield (packbits
of one seeded numpy density grid), and both march with the deterministic
``key=None`` jitter of 0.5.

The JAX side runs eagerly (op by op). Under ``jax.jit`` XLA's CPU backend
fuses ``a + b * c`` into FMAs, which moves probe and candidate times by an
ulp and flips about 0.1% of march bits at cell boundaries (measured on
this miniature: 20 of 24,576 slots); eager JAX rounds every op as the
port's PyTorch ops do, so it is the like-for-like reference. Every JAX
call has one shape (300-ray chunks), so the eager ops compile once.
"""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raw_ngp_torch.config as tcfg
import raw_ngp_tpu.config as jcfg
from raw_ngp_torch.convert import bitfield_from_jax, field_from_jax
from raw_ngp_torch.models.ngp import make_field_spec as t_make_spec
from raw_ngp_torch.ops.grid import packbits as t_packbits
from raw_ngp_torch.render import occupancy as tocc
from raw_ngp_torch.render.eval import coarse_volume, render_image, scene_aabb
from raw_ngp_tpu.data import make_synthetic_scene
from raw_ngp_tpu.models.ngp import init_field as j_init_field
from raw_ngp_tpu.models.ngp import make_field_spec as j_make_spec
from raw_ngp_tpu.ops.grid import packbits as j_packbits
from raw_ngp_tpu.ops.rays import full_image_rays as j_full_image_rays
from raw_ngp_tpu.render import occupancy as jocc


def mini_cfg(mod):
    """The golden miniature of the flagship, built from either package's
    config module (the two are field-for-field copies)."""
    cfg = mod.Config().with_preset_O().with_tpu_profile()
    cfg = replace(cfg, model=replace(
        cfg.model, log2_hashmap_size=12, hashgrid_resolution=64,
        grid_mlp_hidden=16, view_mlp_hidden=16))
    cfg = replace(cfg, render=replace(
        cfg.render, grid_size=32, samples_per_ray=24, march_candidates=24,
        max_ray_batch=4096))
    cfg = replace(cfg, train=replace(cfg.train, num_rays=512, fp16=False,
                                     adaptive_num_rays=False))
    return cfg.validate()


def _setup():
    jc, tc = mini_cfg(jcfg), mini_cfg(tcfg)
    jspec, tspec = j_make_spec(jc), t_make_spec(tc)
    params = jax.tree_util.tree_map(
        np.asarray, j_init_field(jax.random.PRNGKey(0), jspec))
    rng = np.random.default_rng(3)
    # a density grid occupying a ball of radius 1 plus sparse noise
    n = jc.render.grid_size
    from raw_ngp_tpu.ops.morton import morton3d_invert
    xyz = np.asarray(morton3d_invert(jnp.arange(n ** 3, dtype=jnp.uint32)))
    dg = np.zeros((jc.cascades, n ** 3), np.float32)
    for cas in range(jc.cascades):
        p = (2.0 * xyz / (n - 1) - 1.0) * min(2 ** cas, jc.render.bound)
        dg[cas] = np.where(np.linalg.norm(p, axis=-1) < 1.0, 20.0, 0.0)
        dg[cas] += 20.0 * (rng.random(n ** 3) < 0.02)
    bits_j = np.asarray(j_packbits(jnp.asarray(dg), 10.0))
    bits_t = t_packbits(torch.from_numpy(dg), 10.0).numpy()
    np.testing.assert_array_equal(bits_t, bits_j)
    _, val = make_synthetic_scene(n_train=2, n_val=1, H=32, W=32, seed=0)

    def j_render(ro, rd, aabb):
        return jocc.render_occupancy(
            params, jspec, ro, rd, aabb, jnp.asarray(bits_j), key=None,
            bg_color=0.0, training=False)

    return dict(jc=jc, tc=tc, jspec=jspec, tspec=tspec, params=params,
                bits=bits_j, val=val, j_render=j_render,
                field=field_from_jax(params, tspec, device="cpu"))


@pytest.fixture(scope="module")
def setup():
    return _setup()


CHUNK = 300
CENTER = slice(362, 362 + CHUNK)     # one chunk across the middle rows


def _rays(s, H=32, W=32):
    ro, rd = j_full_image_rays(jnp.asarray(s["val"].poses[0]),
                               jnp.asarray(s["val"].intrinsics), H, W)
    return np.array(ro), np.array(rd)


def _aabb(s):
    return scene_aabb(s["tc"], s["val"].pts_aabb, device="cpu").numpy()


def test_coarse_volume_matches(setup):
    s = setup
    r = s["jc"].render
    cl_j = jocc.coarse_occupancy(
        jnp.asarray(s["bits"]), r.grid_size, s["jc"].cascades,
        jocc._coarse_dilate_radius(r.bound, r.grid_size, r.coarse_probes),
        bound=r.bound)
    cl_t = coarse_volume(s["tc"], bitfield_from_jax(s["bits"], device="cpu"))
    np.testing.assert_array_equal(cl_t.numpy(), np.asarray(cl_j))


def test_march_masks_agree(setup):
    """>= 99.9% of march slots agree (mask, and t where both live)."""
    s = setup
    r = s["jc"].render
    ro, rd = _rays(s)
    ro, rd = ro[CENTER], rd[CENTER]
    aabb = _aabb(s)
    nj, fj = jocc.near_far_from_aabb(jnp.asarray(ro), jnp.asarray(rd),
                                     jnp.asarray(aabb), r.min_near)
    mj = jocc.march_rays(jnp.asarray(ro), jnp.asarray(rd),
                         jnp.asarray(s["bits"]), nj, fj, r.bound, False,
                         r.grid_size, s["jc"].cascades, r.march_candidates,
                         r.samples_per_ray, key=None,
                         coarse_probes=r.coarse_probes, march_cdf=True)
    mt = tocc.march_rays(torch.from_numpy(ro), torch.from_numpy(rd),
                         bitfield_from_jax(s["bits"], device="cpu"),
                         torch.from_numpy(np.array(nj)),
                         torch.from_numpy(np.array(fj)), r.bound,
                         r.grid_size, s["tc"].cascades, r.march_candidates,
                         r.samples_per_ray, r.coarse_probes, march_cdf=True)
    mask_j, mask_t = np.asarray(mj["mask"]), mt["mask"].numpy()
    assert mask_j.mean() > 0.05          # the march sees the ball
    assert (mask_j == mask_t).mean() >= 0.999
    both = mask_j & mask_t
    np.testing.assert_allclose(mt["ts"].numpy()[both],
                               np.asarray(mj["ts"])[both], rtol=1e-6)
    np.testing.assert_allclose(
        mt["deltas"].numpy(),
        np.broadcast_to(np.asarray(mj["deltas"]), mask_j.shape), rtol=1e-6)


def test_render_occupancy_matches(setup):
    """image, depth and weights_sum at atol 1e-4."""
    s = setup
    ro, rd = _rays(s)
    ro, rd = ro[CENTER], rd[CENTER]
    aabb = _aabb(s)
    out_j = s["j_render"](jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(aabb))
    with torch.no_grad():
        out_t = tocc.render_occupancy(
            s["field"], torch.from_numpy(ro), torch.from_numpy(rd),
            torch.from_numpy(aabb), bitfield_from_jax(s["bits"], device="cpu"))
    assert float(np.asarray(out_j["weights_sum"]).max()) > 0.1
    for k in ("image", "depth", "weights_sum"):
        np.testing.assert_allclose(out_t[k].numpy(), np.asarray(out_j[k]),
                                   atol=1e-4, rtol=0, err_msg=k)


def test_render_image_end_to_end(setup):
    """render_image on a 32x32 view in 300-ray chunks (so the chunking and
    the last chunk's padding run) against the JAX render of the same
    padded chunks, as the JAX trainer's render_image makes them."""
    s = setup
    ro, rd = _rays(s)
    aabb = _aabb(s)
    chunk, N = CHUNK, ro.shape[0]
    imgs, depths = [], []
    for a in range(0, N, chunk):
        e = min(a + chunk, N)
        pad = chunk - (e - a)
        cro = np.pad(ro[a:e], ((0, pad), (0, 0)))
        crd = np.pad(rd[a:e], ((0, pad), (0, 0)), constant_values=1.0)
        out = s["j_render"](jnp.asarray(cro), jnp.asarray(crd),
                            jnp.asarray(aabb))
        imgs.append(np.asarray(out["image"])[: e - a])
        depths.append(np.asarray(out["depth"])[: e - a])
    field = field_from_jax(s["params"], t_make_spec(replace(
        s["tc"], render=replace(s["tc"].render, max_ray_batch=chunk))),
        device="cpu")
    rgb, depth = render_image(
        field, bitfield_from_jax(s["bits"], device="cpu"),
        s["val"].poses[0], s["val"].intrinsics, 32, 32,
        torch.from_numpy(aabb), device="cpu")
    assert rgb.shape == (32, 32, 3) and depth.shape == (32, 32)
    assert torch.isfinite(rgb).all() and torch.isfinite(depth).all()
    np.testing.assert_allclose(rgb.numpy().reshape(-1, 3),
                               np.concatenate(imgs), atol=1e-4, rtol=0)
    np.testing.assert_allclose(depth.numpy().reshape(-1),
                               np.concatenate(depths), atol=1e-4, rtol=0)
