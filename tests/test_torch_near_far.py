"""Parity of the port's per-camera near/far and patch sampling with the JAX
package's, on the CPU: the sampler's ``cam_near_far`` rows and its patch
structure, ``sample_pixel_indices``, the renders' clamp of each ray to
its camera's [near, far] (occupancy and proposal paths), the untrained-cell
marking with camera ranges, and one train step's loss and gradients
with ``cam_near_far`` on both paths (the CPU Trainer on a COLMAP scene
loaded from disk is in tests/test_torch_providers.py).

Both packages get the same numpy inputs: the synthetic scene (a numpy
copy in each package), parameters from the JAX init carried across by
raw_ngp_torch.convert, one bitfield and per-camera ranges that cut into
each ray's box span from both ends. The random streams differ (threefry
against Philox), so random draws are compared by their structure, and
the renders run their deterministic paths (``key=None`` / no generator).
The JAX side is jitted with XLA's optimizations off
(``jax_disable_most_optimizations``, eager JAX's rounding) and its B2
interpreted, as in tests/test_torch_march.py. Each test states its
tolerance and the reason.
"""

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
from raw_ngp_torch.data.sampler import sample_ray_batch as t_sample
from raw_ngp_torch.models.ngp import make_field_spec as t_make_spec
from raw_ngp_torch.ops import grid as tgrid
from raw_ngp_torch.ops.rays import sample_pixel_indices as t_pixels
from raw_ngp_torch.render import occupancy as tocc
from raw_ngp_torch.render import proposal as tprop
from raw_ngp_torch.train import trainer as ttr
from raw_ngp_torch.train.state import TrainState
from raw_ngp_tpu.data.sampler import sample_ray_batch as j_sample
from raw_ngp_tpu.models.ngp import init_field as j_init_field
from raw_ngp_tpu.models.ngp import make_field_spec as j_make_spec
from raw_ngp_tpu.ops import grid as jgrid
from raw_ngp_tpu.ops.morton import morton3d_invert as j_morton_invert
from raw_ngp_tpu.ops.rays import sample_pixel_indices as j_pixels
from raw_ngp_tpu.train import trainer as jtr
from test_torch_proposal import _leaves as o2_leaves
from test_torch_proposal import _params as o2_params
from test_torch_proposal import o2_cfg
from test_torch_train import mini_cfg


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's torch work, set back after
    it (under pytest-xdist torch's default of a thread a core
    oversubscribes the cores: tests/test_torch_proposal.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reference(fn):
    """fn() with JAX's B2 interpreted and XLA's optimizations off."""
    sp.FORCE_INTERPRET = True
    jax.config.update("jax_disable_most_optimizations", True)
    try:
        return fn()
    finally:
        sp.FORCE_INTERPRET = False
        jax.config.update("jax_disable_most_optimizations", False)


def _jit_exact(fn, *args):
    """fn(*args) jitted as :func:`_reference` does, with every bf16
    rounding kept (``xla_allow_excess_precision`` off): eager JAX's
    numbers from one compile (tests/test_torch_regularizers.py)."""
    return _reference(lambda: jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})(*args))


def _np(t):
    return t.detach().cpu().numpy()


def _near_far(n, seed=3):
    """Per-camera [near, far] [n, 2] for cameras on a ring of radius 2.2
    about the scene's spheres: near in [1.2, 1.7] and far in [2.2, 2.9],
    inside the box span [~1.0, ~3.4] at both ends, so the clamp cuts."""
    rng = np.random.default_rng(seed)
    return np.stack([rng.uniform(1.2, 1.7, n), rng.uniform(2.2, 2.9, n)],
                    -1).astype(np.float32)


@pytest.fixture(scope="module")
def scene():
    train, _ = make_synthetic_scene(n_train=12, n_val=1, H=32, W=32,
                                    seed=0)
    return train


def _batch(scene, n=512, seed=5):
    """An explicit batch through JAX's sampler (coords, image indices and
    the cameras' ranges) as numpy: the rays both packages render."""
    rng = np.random.default_rng(seed)
    coords = np.stack([rng.integers(4, 28, n), rng.integers(4, 28, n)], -1)
    idx = rng.integers(0, scene.n_images, n)
    # jitted: these are inputs, which both packages get as numpy
    b = jax.jit(j_sample, static_argnums=4)(
        jax.random.PRNGKey(0), jnp.asarray(scene.images),
        jnp.asarray(scene.poses), jnp.asarray(scene.intrinsics), n,
        cam_near_far=jnp.asarray(_near_far(scene.n_images)),
        coords=jnp.asarray(coords), coord_image_indices=jnp.asarray(idx))
    return {k: np.array(v) for k, v in b.items()}


# ------------------------------------------------------------- sampler

def test_sampler_cam_near_far_rows_bit_identical(scene):
    """The explicit-pixel sampler with cam_near_far: each ray carries its
    camera's row, and the rays, pixels and rows are JAX's bit for bit."""
    rng = np.random.default_rng(4)
    n = 257
    coords = np.stack([rng.integers(0, 32, n), rng.integers(0, 32, n)], -1)
    idx = rng.integers(0, scene.n_images, n)
    cnf = _near_far(scene.n_images)
    bj = j_sample(jax.random.PRNGKey(0), jnp.asarray(scene.images),
                  jnp.asarray(scene.poses), jnp.asarray(scene.intrinsics), n,
                  cam_near_far=jnp.asarray(cnf), coords=jnp.asarray(coords),
                  coord_image_indices=jnp.asarray(idx))
    bt = t_sample(None, torch.from_numpy(scene.images),
                  torch.from_numpy(scene.poses),
                  torch.from_numpy(scene.intrinsics), n,
                  cam_near_far=torch.from_numpy(cnf),
                  coords=torch.from_numpy(coords),
                  coord_image_indices=torch.from_numpy(idx))
    for k in ("rays_o", "rays_d", "images", "index", "cam_near_far"):
        np.testing.assert_array_equal(_np(bt[k]), np.asarray(bj[k]),
                                      err_msg=k)
    np.testing.assert_array_equal(_np(bt["cam_near_far"]), cnf[idx])


def _patch_structure(flat, img, H, W, p):
    """Asserts that the rays come in p x p row-major blocks of contiguous
    pixels with corners in [0, H - p) x [0, W - p), each from one image
    (``img`` None: not checked)."""
    flat = np.asarray(flat).reshape(-1, p * p)
    rows, cols = flat // W, flat % W
    di, dj = np.meshgrid(np.arange(p), np.arange(p), indexing="ij")
    np.testing.assert_array_equal(rows - rows[:, :1], np.broadcast_to(
        di.reshape(1, -1), rows.shape))
    np.testing.assert_array_equal(cols - cols[:, :1], np.broadcast_to(
        dj.reshape(1, -1), cols.shape))
    assert (rows[:, 0] >= 0).all() and (rows[:, 0] < H - p).all()
    assert (cols[:, 0] >= 0).all() and (cols[:, 0] < W - p).all()
    if img is not None:
        img = np.asarray(img).reshape(-1, p * p)
        assert (img == img[:, :1]).all()


@pytest.mark.parametrize("p,num_rays", [(2, 64), (3, 70), (4, 512)])
def test_sample_pixel_indices_patches_like_jax(p, num_rays):
    """sample_pixel_indices with patches: num_rays // p^2 blocks of p x p
    contiguous pixels (row-major, corners in [0, H - p) x [0, W - p)), the
    structure of JAX's draw (the draws differ: Philox against threefry);
    the same count and, within each patch, the same offsets."""
    H, W = 20, 24
    fj = np.asarray(j_pixels(jax.random.PRNGKey(1), num_rays, H, W, p))
    ft = _np(t_pixels(torch.Generator().manual_seed(1), num_rays, H, W, p))
    assert ft.shape == fj.shape == ((num_rays // p ** 2) * p ** 2,)
    _patch_structure(fj, None, H, W, p)
    _patch_structure(ft, None, H, W, p)
    np.testing.assert_array_equal(
        (ft - ft.reshape(-1, p * p)[:, :1].repeat(p * p)),
        (fj - fj.reshape(-1, p * p)[:, :1].repeat(p * p)))
    # without patches: uniform flat indices
    flat = _np(t_pixels(torch.Generator().manual_seed(2), 4096, H, W))
    assert flat.min() >= 0 and flat.max() < H * W and len(set(flat)) > 300


@pytest.mark.parametrize("p", [2, 4])
def test_sampler_patches_share_one_image(scene, p):
    """sample_ray_batch(patch_size=p): every patch is p x p contiguous
    pixels of one image (pixels that name themselves: (image, row, col)),
    its rays those of JAX's pixel_rays at the same pixels, its
    cam_near_far the image's; JAX's batch has the same structure."""
    n, H, W = scene.n_images, scene.H, scene.W
    code = np.stack(np.meshgrid(np.arange(n), np.arange(H), np.arange(W),
                                indexing="ij"), -1).astype(np.float32)
    cnf = _near_far(n)
    bt = t_sample(torch.Generator().manual_seed(0), torch.from_numpy(code),
                  torch.from_numpy(scene.poses),
                  torch.from_numpy(scene.intrinsics), 128,
                  cam_near_far=torch.from_numpy(cnf), patch_size=p)
    img, row, col = _np(bt["images"]).astype(np.int64).T
    np.testing.assert_array_equal(img, _np(bt["index"]))
    _patch_structure(row * W + col, img, H, W, p)
    np.testing.assert_array_equal(_np(bt["cam_near_far"]), cnf[img])
    # the rays are those of the explicit hook at the same pixels
    again = t_sample(None, torch.from_numpy(code),
                     torch.from_numpy(scene.poses),
                     torch.from_numpy(scene.intrinsics), len(img),
                     coords=torch.from_numpy(np.stack([row, col], -1)),
                     coord_image_indices=torch.from_numpy(img))
    for k in ("rays_o", "rays_d"):
        np.testing.assert_array_equal(_np(bt[k]), _np(again[k]), err_msg=k)
    bj = j_sample(jax.random.PRNGKey(0), jnp.asarray(code),
                  jnp.asarray(scene.poses), jnp.asarray(scene.intrinsics),
                  128, cam_near_far=jnp.asarray(cnf), patch_size=p)
    img_j, row_j, col_j = np.asarray(bj["images"]).astype(np.int64).T
    _patch_structure(row_j * W + col_j, img_j, H, W, p)
    assert len(img_j) == len(img) == (128 // p ** 2) * p ** 2


# ------------------------------------------------------------ renders

@pytest.fixture(scope="module")
def occ():
    """The golden miniature (tests/test_torch_train.py), its JAX params,
    a bitfield of a ball of radius 1 plus 2% noise cells (two cascades)."""
    jc = mini_cfg(jcfg)
    params = jax.tree_util.tree_map(
        np.asarray, j_init_field(jax.random.PRNGKey(0), j_make_spec(jc)))
    n = jc.render.grid_size
    xyz = np.asarray(j_morton_invert(jnp.arange(n ** 3, dtype=jnp.uint32)))
    rng = np.random.default_rng(3)
    dg = np.zeros((jc.cascades, n ** 3), np.float32)
    for cas in range(jc.cascades):
        p = (2.0 * xyz / (n - 1) - 1.0) * min(2 ** cas, jc.render.bound)
        dg[cas] = np.where(np.linalg.norm(p, axis=-1) < 1.0, 20.0, 0.0)
        dg[cas] += 20.0 * (rng.random(n ** 3) < 0.02)
    bits = np.asarray(jgrid.packbits(jnp.asarray(dg), 10.0))
    return SimpleNamespace(params=params, bits=bits)


def _jax_step(jc, params, batch, aabb, bits=None):
    """JAX's jax.value_and_grad(make_batch_loss_fn(...)) on an explicit
    batch, key=None, in one compile (``_jit_exact``), its render_any
    wrapped so that the render's outputs ride out in the aux's
    num_points slot -> (loss, aux with the true num_points, grads, the
    render's outputs)."""
    fn = jtr.make_batch_loss_fn(jc, j_make_spec(jc))
    state = (None if bits is None
             else SimpleNamespace(density_bitfield=jnp.asarray(bits)))
    render_any = jtr.render_any

    def render_any_out(*args, **kwargs):
        out = render_any(*args, **kwargs)
        return dict(out, num_points=(out["num_points"], dict(out)))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtr, "render_any", render_any_out)
        (loss, aux), grads = _jit_exact(
            jax.value_and_grad(lambda p, bt: fn(p, state, bt,
                                                jnp.asarray(aabb), None, 1.0,
                                                True), has_aux=True),
            jax.tree_util.tree_map(jnp.asarray, params),
            {k: jnp.asarray(v) for k, v in batch.items()})
    num_points, out = aux["num_points"]
    return loss, dict(aux, num_points=num_points), grads, out


@pytest.fixture(scope="module")
def jax_steps(occ, scene):
    """{case: _jax_step of the case}, each computed on first use: "occ"
    and "occ_bf16" (the golden miniature on a 512-ray batch of the
    scene's rays with their cameras' ranges, inside the sparse box), and
    "o2" (the -O2 miniature, f32, uncontracted so the box and the ranges
    bound the bins, 256 of those rays, the bound box)."""
    cache = {}

    def get(case):
        if case not in cache:
            if case == "o2":
                jc = o2_cfg(jcfg, contract=False)
                bb = jc.render.bound
                aabb = np.array([-bb] * 3 + [bb] * 3, np.float32)
                params, batch = o2_params(jc), _batch(scene, n=256)
                res = _jax_step(jc, params, batch, aabb)
            else:
                jc = mini_cfg(jcfg, case == "occ_bf16")
                aabb = np.clip(scene.pts_aabb, -2.0, 2.0).astype(np.float32)
                params, batch = occ.params, _batch(scene)
                res = _jax_step(jc, params, batch, aabb, occ.bits)
            cache[case] = SimpleNamespace(params=params, batch=batch,
                                          aabb=aabb, loss=res[0],
                                          aux=res[1], grads=res[2],
                                          out=res[3])
        return cache[case]

    return get


def _port_step(tc, params, case, state):
    """The port's make_batch_loss_fn on the case's batch, its render_any
    wrapped to keep the render's outputs and the march's spans and
    samples -> (field, loss, aux, render outputs, marches)."""
    field = field_from_jax(params, t_make_spec(tc), device="cpu")
    outs, marches = [], []
    render_any, march = ttr.render_any, tocc.march_rays

    def render_any_out(*args, **kwargs):
        outs.append(render_any(*args, **kwargs))
        return outs[-1]

    def recorded(*args, **kwargs):
        out = march(*args, **kwargs)
        marches.append((args[3], args[4], out["ts"], out["mask"]))
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ttr, "render_any", render_any_out)
        mp.setattr(tocc, "march_rays", recorded)
        loss, aux = ttr.make_batch_loss_fn(tc, t_make_spec(tc))(
            field, state, {k: torch.from_numpy(v)
                           for k, v in case.batch.items()},
            torch.from_numpy(case.aabb))
    return field, loss, aux, outs[0], marches


def _occ_state(occ):
    return SimpleNamespace(density_bitfield=bitfield_from_jax(occ.bits,
                                                              device="cpu"))


def test_render_occupancy_clamps_to_camera_ranges_like_jax(occ, scene,
                                                          jax_steps):
    """The occupancy render of a training step whose batch carries
    cam_near_far: every ray's march span lies within its camera's [near,
    far] and every live sample's t inside it; image, depth and
    weights_sum against JAX's render in the same step at atol 1e-4 (as
    tests/test_torch_render.py: sums in other orders); the clamp changes
    the image (it cuts into the box spans)."""
    case = jax_steps("occ")
    tc = mini_cfg(tcfg)
    _, _, _, out_t, marches = _port_step(tc, case.params, case,
                                         _occ_state(occ))
    nears, fars, ts, mask = marches[0]
    cnf = torch.from_numpy(case.batch["cam_near_far"])
    assert (nears >= cnf[:, :1]).all() and (fars <= cnf[:, 1:]).all()
    live = ts[mask]
    assert live.numel() > 0
    assert (live >= cnf[:, :1].expand_as(ts)[mask]).all()
    assert (live <= cnf[:, 1:].expand_as(ts)[mask]).all()
    field = field_from_jax(case.params, t_make_spec(tc), device="cpu")
    with torch.no_grad():
        free = tocc.render_occupancy(
            field, torch.from_numpy(case.batch["rays_o"]),
            torch.from_numpy(case.batch["rays_d"]),
            torch.from_numpy(case.aabb),
            bitfield_from_jax(occ.bits, device="cpu"), training=True)
    assert float((out_t["image"] - free["image"]).abs().max()) > 1e-3
    assert float(np.asarray(case.out["weights_sum"]).max()) > 0.1
    for k in ("image", "depth", "weights_sum"):
        np.testing.assert_allclose(_np(out_t[k]), np.asarray(case.out[k]),
                                   atol=1e-4, rtol=0, err_msg=k)


def test_render_proposal_clamps_to_camera_ranges_like_jax(jax_steps):
    """The proposal render of a -O2 training step whose batch carries
    cam_near_far (the miniature, uncontracted so the box and the camera
    ranges bound the bins) against JAX's render in the same step: image,
    depth and weights_sum within 1e-4 of their largest entry
    (tests/test_torch_proposal.py's f32 tolerance: sums in other orders);
    the clamp changes the image."""
    case = jax_steps("o2")
    tc = o2_cfg(tcfg, contract=False)
    state = TrainState(params={}, opt_state=None, ema_params={}, step=0)
    field, _, _, out_t, _ = _port_step(tc, case.params, case, state)
    bt = {k: torch.from_numpy(v) for k, v in case.batch.items()}
    with torch.no_grad():
        free = tprop.render_proposal(field, bt["rays_o"], bt["rays_d"],
                                     torch.from_numpy(case.aabb),
                                     bg_color=0.0, training=True)
    assert float((out_t["image"] - free["image"]).abs().max()) > 1e-3
    for k in ("image", "depth", "weights_sum"):
        want = np.asarray(case.out[k])
        err = np.abs(_np(out_t[k]) - want).max() / np.abs(want).max()
        assert err <= 1e-4, (k, err)


def test_mark_untrained_grid_with_camera_ranges_bit_identical(scene):
    """mark_untrained_grid with per-camera near (each camera's own
    min_near) against JAX's, bit for bit; the ranges change the grid
    (nears moved out by 1, past the box's nearest cells)."""
    jc, tc = mini_cfg(jcfg), mini_cfg(tcfg)
    aabb = np.clip(scene.pts_aabb, -2.0, 2.0)
    cnf = _near_far(scene.n_images) + np.float32([1.0, 1.0])
    gj = np.asarray(jgrid.mark_untrained_grid(
        jc, scene.poses, scene.intrinsics, aabb, cam_near_far=cnf))
    gt = tgrid.mark_untrained_grid(tc, scene.poses, scene.intrinsics,
                                   aabb, cam_near_far=cnf)
    np.testing.assert_array_equal(gt, gj)
    free = tgrid.mark_untrained_grid(tc, scene.poses, scene.intrinsics,
                                     aabb)
    assert (gt != free).any()


# ----------------------------------------------------------- training

@pytest.mark.parametrize("fp16", [False, True])
def test_one_train_step_with_cam_near_far_matches_jax(occ, jax_steps, fp16):
    """One occupancy step on the golden miniature with the same params,
    bitfield and explicit batch carrying cam_near_far, key=None: the loss
    and every leaf's gradient against JAX's
    jax.value_and_grad(make_batch_loss_fn(...)) (B2 interpreted; bf16
    compiled with every rounding kept), at the tolerances of
    tests/test_torch_train.py::
    test_one_train_step_loss_and_gradients_match_jax: loss rtol 1e-5, each
    leaf within 1e-4 (f32) or 1e-3 (bf16) of its largest entry; the same
    live-sample counts. That test names why bf16 tables differ: a dense
    level's bf16 total lands one ulp apart (an f32 sum order). One bf16
    ulp of an entry can exceed 1e-3 of the largest (measured here: one
    entry of -4.08e-7 one ulp, 1.86e-9, apart, 1.13e-3 of the largest
    1.65e-6), so in bf16 a table entry may instead differ by at most one
    bf16 ulp of itself."""
    case = jax_steps("occ_bf16" if fp16 else "occ")
    field, loss_t, aux_t, _, _ = _port_step(mini_cfg(tcfg, fp16),
                                            case.params, case,
                                            _occ_state(occ))
    loss_t.backward()
    aux_j, g_j = case.aux, case.grads
    assert int(aux_t["num_points"]) == int(aux_j["num_points"]) > 0
    assert int(aux_t["num_points_raw"]) == int(aux_j["num_points_raw"])
    np.testing.assert_allclose(float(loss_t.detach()), float(case.loss),
                               rtol=1e-5)
    tol = 1e-3 if fp16 else 1e-4
    leaves = [("grid", field.grid, g_j["grid"])]
    leaves += [(f"grid_mlp.{i}", w, g_j["grid_mlp"][i]["w"])
               for i, w in enumerate(field.grid_mlp)]
    leaves += [(f"view_mlp.{i}", w, g_j["view_mlp"][i]["w"])
               for i, w in enumerate(field.view_mlp)]
    for name, p, gj in leaves:
        gj = np.asarray(gj, np.float32).reshape(p.shape)
        scale = np.abs(gj).max()
        assert scale > 0, name
        diff = np.abs(_np(p.grad) - gj)
        if fp16 and name == "grid":
            # one bf16 ulp of the entry: 2^(exponent - 7)
            ulp = np.ldexp(1.0, np.frexp(np.abs(gj))[1] - 8)
            bad = (diff > tol * scale) & (diff > ulp)
            assert not bad.any(), (name, diff[bad], gj[bad])
        else:
            np.testing.assert_allclose(_np(p.grad), gj, rtol=0,
                                       atol=tol * scale, err_msg=name)


def test_one_proposal_step_with_cam_near_far_matches_jax(jax_steps):
    """One -O2 step (the miniature of tests/test_torch_proposal.py, f32,
    uncontracted) on an explicit batch carrying cam_near_far, key=None,
    against JAX's make_batch_loss_fn: the loss at rtol 1e-5 and every MLP
    leaf's gradient within 1e-4 of its largest entry
    (tests/test_torch_train.py's f32 tolerances; measured 1.6e-5). The
    three tables' gradients pass through B2, which rounds each w * g
    product to bf16 in both packages, so a cotangent one f32 ulp apart
    moves a product by a bf16 ulp: within 5e-3, the table tolerance of
    tests/test_torch_proposal.py (measured 2.0e-4)."""
    case = jax_steps("o2")
    state = TrainState(params={}, opt_state=None, ema_params={}, step=0)
    field, loss_t, _, _, _ = _port_step(o2_cfg(tcfg, contract=False),
                                        case.params, case, state)
    loss_t.backward()
    np.testing.assert_allclose(float(loss_t.detach()), float(case.loss),
                               rtol=1e-5)
    for name, p, gj in o2_leaves(field, case.grads):
        gj = np.asarray(gj, np.float32).reshape(p.shape)
        assert np.abs(gj).max() > 0, name
        err = np.abs(_np(p.grad) - gj).max() / np.abs(gj).max()
        table = name in ("grid", "prop_grids.0", "prop_grids.1")
        assert err <= (5e-3 if table else 1e-4), (name, err)
