"""Parity of the port's training path (raw_ngp_torch: the encode's table
gradient, trunc_exp, the sampler, the grid refresh, one train step, the
fused Adam + EMA and the Trainer) with the JAX package's, on the CPU.

Every comparison feeds both packages the same numpy inputs: parameters
from the JAX init carried across by raw_ngp_torch.convert, the same
bitfield, rays, noise and indices. The JAX table gradient runs its Pallas
segment-totals kernel in interpret mode (``segsum_pallas.FORCE_INTERPRET``,
set back in a ``finally``): the JAX CPU fallback rounds the totals to bf16
and is not the reference. JAX runs eagerly where the march or the encode
positions matter (jitted CPU XLA contracts ``a*b + c`` into FMAs and flips
cell bits, see tests/test_torch_render.py). Each test states its
tolerance and the reason for it.
"""

import os
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
from raw_ngp_torch.data.sampler import sample_ray_batch as t_sample
from raw_ngp_torch.kernels import hash_encode as th
from raw_ngp_torch.kernels.compact import SENTINEL, compact_attrs
from raw_ngp_torch.models.ngp import make_field_spec as t_make_spec
from raw_ngp_torch.ops import grid as tgrid
from raw_ngp_torch.ops.activation import trunc_exp as t_trunc_exp
from raw_ngp_torch.ops.hashgrid import HashGridSpec as TSpec
from raw_ngp_torch.train import trainer as ttr
from raw_ngp_tpu.data.sampler import sample_ray_batch as j_sample
from raw_ngp_tpu.kernels import hash_fused as hf
from raw_ngp_tpu.models.ngp import init_field as j_init_field
from raw_ngp_tpu.models.ngp import make_field_spec as j_make_spec
from raw_ngp_tpu.ops import grid as jgrid
from raw_ngp_tpu.ops.activation import trunc_exp as j_trunc_exp
from raw_ngp_tpu.ops.hashgrid import HashGridSpec as JSpec
from raw_ngp_tpu.ops.morton import morton3d_invert as j_morton_invert
from raw_ngp_tpu.train import trainer as jtr
from raw_ngp_tpu.train.state import TrainState as JState

GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "occupancy_render_v2.npy")


def mini_cfg(mod, fp16=False):
    """The golden miniature of the flagship (tests/test_golden_occupancy.py)
    from either package's config module."""
    cfg = mod.Config().with_preset_O().with_tpu_profile()
    cfg = replace(cfg, model=replace(
        cfg.model, log2_hashmap_size=12, hashgrid_resolution=64,
        grid_mlp_hidden=16, view_mlp_hidden=16))
    cfg = replace(cfg, render=replace(
        cfg.render, grid_size=32, samples_per_ray=24, march_candidates=24,
        max_ray_batch=4096))
    cfg = replace(cfg, train=replace(cfg.train, iters=150, num_rays=512,
                                     seed=0, fp16=fp16,
                                     adaptive_num_rays=False))
    return replace(cfg, ckpt="scratch").validate()


def _interpreted(fn):
    sp.FORCE_INTERPRET = True
    try:
        return fn()
    finally:
        sp.FORCE_INTERPRET = False


def _np(t):
    return t.detach().cpu().numpy()


# ---------------------------------------------------------------- (a)

def test_trunc_exp_forward_and_clamped_backward():
    """Forward exp and backward g * exp(clip(x, -15, 15)), including
    |x| > 15; rtol 1e-6 (exp may differ by an ulp between the two)."""
    x = np.array([-40.0, -16.0, -15.0, -3.5, 0.0, 2.25, 15.0, 15.5, 30.0],
                 np.float32)
    g = np.linspace(-2.0, 3.0, x.size).astype(np.float32)
    yj, vjp = jax.vjp(j_trunc_exp, jnp.asarray(x))
    (gj,) = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_()
    yt = t_trunc_exp(xt)
    yt.backward(torch.from_numpy(g))
    np.testing.assert_allclose(_np(yt), np.asarray(yj), rtol=1e-6)
    np.testing.assert_allclose(_np(xt.grad), np.asarray(gj), rtol=1e-6)
    assert np.isfinite(_np(xt.grad)).all()


# ---------------------------------------------------------------- (c)

_SPECS = {
    # levels 0-1 dense, 2-5 hashed (tests/test_hash_fused.py)
    "xor": dict(input_dim=3, num_levels=6, level_dim=2, base_resolution=4,
                log2_hashmap_size=9, desired_resolution=64,
                hash_variant="xor"),
    "additive": dict(input_dim=3, num_levels=6, level_dim=2,
                     base_resolution=4, log2_hashmap_size=9,
                     desired_resolution=64, hash_variant="additive"),
    # flagship-like L2 x C16: level 0 dense res 16 (the matmul level)
    "L2xC16": dict(input_dim=3, num_levels=2, level_dim=16,
                   log2_hashmap_size=12, desired_resolution=256,
                   hash_variant="additive"),
}


def _points(B, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.random((B, 3)).astype(np.float32)
    x[:5] = x[:5] * 3.0 - 1.0          # outside [0, 1]^3
    x[5, 1] = np.nan
    x[6], x[7] = 0.0, 1.0
    return x


@pytest.mark.parametrize("mm", ["1", "0"])
@pytest.mark.parametrize("name", sorted(_SPECS))
def test_window_records_match_jax(monkeypatch, name, mm):
    """base, w0 and w1 of every window equal JAX's _window_indices_weights
    bit for bit (the backward truncates w0, w1 to bf16, so any f32
    difference could move a truncated value)."""
    monkeypatch.setenv("RAW_NGP_MM_LEVELS", mm)
    js, tspec = JSpec.create(**_SPECS[name]), TSpec.create(**_SPECS[name])
    assert th.matmul_split(tspec) == hf._matmul_split(js)
    x = _points(300)
    bj, w0j, w1j = hf._window_indices_weights(jnp.asarray(x), js)
    bt, w0t, w1t = th.window_indices_weights(torch.from_numpy(x), tspec)
    np.testing.assert_array_equal(_np(bt), np.asarray(bj))
    np.testing.assert_array_equal(_np(w0t).view(np.int32),
                                  np.asarray(w0j).view(np.int32))
    np.testing.assert_array_equal(_np(w1t).view(np.int32),
                                  np.asarray(w1j).view(np.int32))


def _ray_points(B, seed=1, per_ray=32):
    """B points in ray order, as the compaction hands them to the train
    forward: rays from random points in [0.1, 0.9]^3 in random directions,
    samples 0.004 apart, clipped to [0, 1]."""
    rng = np.random.default_rng(seed)
    n = -(-B // per_ray)
    o = rng.random((n, 3)) * 0.8 + 0.1
    d = rng.standard_normal((n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t = np.arange(per_ray) * 0.004
    x = (o[:, None] + t[None, :, None] * d[:, None]).reshape(-1, 3)[:B]
    return np.clip(x, 0.0, 1.0).astype(np.float32)


def _morton_points(B, seed=1, n=32, first=0):
    """B jittered cell centres in Morton order, as a grid refresh chunk
    (ops/grid.full_sweep) queries them: codes first..first+B of an n^3
    grid at cascade 0 with bound 1, as x01 = (x + 1) / 2."""
    codes = np.arange(first, first + B)
    coords = np.stack([sum(((codes >> (3 * i + d)) & 1) << i
                           for i in range(10)) for d in range(3)], -1)
    noise = np.random.default_rng(seed).random((B, 3))
    xyz = (2.0 * coords / (n - 1) - 1.0) * (1.0 - 1.0 / n) \
        + (noise * 2.0 - 1.0) / n
    return ((xyz + 1.0) / 2.0).astype(np.float32)


def _kind_points(kind, B):
    """Points of one input kind (uniform, ray-ordered, Morton-ordered
    refresh chunk) with _points' edge cases in the first 8 rows."""
    x = {"uniform": _points, "ray": _ray_points,
         "morton": _morton_points}[kind](B)
    x[:8] = _points(8)
    return x


@pytest.mark.parametrize("kind", ["uniform", "ray", "morton"])
@pytest.mark.parametrize("mm", ["1", "0"])
@pytest.mark.parametrize("name", sorted(_SPECS))
def test_encode_bf16_forward_matches_jax(monkeypatch, name, mm, kind):
    """The port's bf16 encode forward (hash_encode on CPU tensors, i.e.
    hash_encode_fused_plain) equals hash_encode_fused(..., jnp.bfloat16)
    bit for bit at uniform, ray-ordered and Morton-ordered (grid refresh)
    points, with points outside [0, 1]^3, NaN, 0.0 and 1.0. This
    holds because the port takes JAX's rounding chain, which was settled
    bitwise here: XLA's CPU reduce over the windows accumulates its bf16
    sum in f32 and rounds once (not after each add), and the dense level's
    bf16 matmul sums the yz lanes in f32 z-major in lane order (for B >= 2
    points; a single point goes through XLA's matrix-vector path, which
    sums in another order) and rounds once."""
    monkeypatch.setenv("RAW_NGP_MM_LEVELS", mm)
    js, tspec = JSpec.create(**_SPECS[name]), TSpec.create(**_SPECS[name])
    assert th.matmul_split(tspec) == hf._matmul_split(js)
    x = _kind_points(kind, 1500)
    params = (np.random.default_rng(2).standard_normal(
        js.n_params * js.level_dim) * 0.1).astype(np.float32)
    out_j = np.asarray(hf.hash_encode_fused(
        jnp.asarray(params), jnp.asarray(x), js, False, jnp.bfloat16
    ).astype(jnp.float32))
    out_t = th.hash_encode(torch.from_numpy(params), torch.from_numpy(x),
                           tspec, compute_dtype=torch.bfloat16)
    assert out_t.dtype == torch.bfloat16
    assert (out_t[:6] == 0).all()
    np.testing.assert_array_equal(_np(out_t.float()), out_j)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("name,mm", [("xor", "auto"), ("additive", "auto"),
                                     ("L2xC16", "1"), ("L2xC16", "0")])
def test_encode_table_gradient_matches_jax(monkeypatch, name, mm, dtype):
    """The port's encode under autograd (plain version on the CPU) against
    jax.grad of hash_encode_fused with the interpreted Pallas B2, in f32
    and bf16 compute. Both sides truncate the same record values and round
    the same products; the f32 totals and the dense level's matmul sum in
    another order, so rtol 1e-5 (atol 1e-6 of the largest entry); under
    bf16 the dense level's output is rounded to bf16 once, so a total near
    a rounding boundary may land one bf16 ulp apart (rtol 8e-3). The dense
    levels' plain version, mm_grad_table_plain, and the arithmetic of the
    card's design, mm_grad_table_cells_plain (cells, stable sort, corner
    sums, 8-corner gather), are also held to JAX's _mm_grad_table alone,
    at the same tolerances, the latter also with points on the top faces
    and at the clamped corner (_top_face_points)."""
    monkeypatch.setenv("RAW_NGP_MM_LEVELS", mm)
    js, tspec = JSpec.create(**_SPECS[name]), TSpec.create(**_SPECS[name])
    assert th.matmul_split(tspec) == hf._matmul_split(js)
    B = 700
    rng = np.random.default_rng(2)
    x = _points(B)
    params = (rng.standard_normal(js.n_params * js.level_dim) * 0.1
              ).astype(np.float32)
    cot = rng.standard_normal((B, js.output_dim)).astype(np.float32)
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]

    def loss(p):
        out = hf.hash_encode_fused(p, jnp.asarray(x), js, False, jdt)
        return (out.astype(jnp.float32) * jnp.asarray(cot)).sum()

    gj = np.asarray(_interpreted(lambda: jax.grad(loss)(jnp.asarray(params))))
    p = torch.from_numpy(params).requires_grad_()
    out = th.hash_encode(p, torch.from_numpy(x), tspec, compute_dtype=tdt)
    assert out.dtype == tdt
    (out.float() * torch.from_numpy(cot)).sum().backward()
    scale = np.abs(gj).max()
    assert scale > 0
    rtol = 1e-5 if dtype == "f32" else 8e-3
    np.testing.assert_allclose(_np(p.grad), gj, rtol=rtol,
                               atol=1e-6 * scale)
    if th.matmul_split(tspec):
        mm_j = np.asarray(hf._mm_grad_table(jnp.asarray(x), jnp.asarray(cot),
                                            js, jdt))
        mm_t = th.mm_grad_table_plain(torch.from_numpy(x),
                                      torch.from_numpy(cot), tspec, tdt)
        assert mm_t.shape == mm_j.shape and np.abs(mm_j).max() > 0
        np.testing.assert_allclose(_np(mm_t), mm_j, rtol=rtol,
                                   atol=1e-6 * np.abs(mm_j).max())
        _assert_cells_match_jax(_top_face_points(x), cot, js, tspec, dtype)


def _top_face_points(x):
    """x with rows 8-13 on the top faces (a coordinate exactly 1.0, where
    the upper corner clamps onto the lower), at the clamped corner
    (1, 1, 1) and at the origin."""
    x = x.copy()
    x[8:11] = [[1.0, 0.3, 0.6], [0.2, 1.0, 0.5], [0.7, 0.4, 1.0]]
    x[11], x[12], x[13] = [1.0, 1.0, 0.25], 1.0, 0.0
    return x


def _assert_cells_match_jax(x, cot, js, tspec, dtype):
    """mm_grad_table_cells_plain against JAX's _mm_grad_table on x: rtol
    1e-5 in f32, 8e-3 under bf16 (one rounding of a total that sums in
    another f32 order), atol 1e-6 of the largest entry."""
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    mm_j = np.asarray(hf._mm_grad_table(jnp.asarray(x), jnp.asarray(cot),
                                        js, jdt))
    mm_c = th.mm_grad_table_cells_plain(torch.from_numpy(x),
                                        torch.from_numpy(cot), tspec, tdt)
    assert mm_c.shape == mm_j.shape and np.abs(mm_j).max() > 0
    np.testing.assert_allclose(_np(mm_c), mm_j,
                               rtol=1e-5 if dtype == "f32" else 8e-3,
                               atol=1e-6 * np.abs(mm_j).max())


# specs with dense matmul levels: the flagship-like one, the same with
# aligned corners and smoothstep, and one with two dense levels (res 16
# and 24 at C = 8)
_CELL_SPECS = {
    "L2xC16": _SPECS["L2xC16"],
    "L2xC16_align_smooth": dict(_SPECS["L2xC16"], align_corners=True,
                                interpolation="smoothstep"),
    "L6xC8": dict(input_dim=3, num_levels=6, level_dim=8, base_resolution=16,
                  log2_hashmap_size=17, desired_resolution=128,
                  hash_variant="additive"),
}


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("kind", ["uniform", "ray", "morton"])
@pytest.mark.parametrize("name", sorted(_CELL_SPECS))
def test_mm_grad_table_cells_matches_jax(monkeypatch, name, kind, dtype):
    """The card design's arithmetic (mm_grad_table_cells_plain: each
    point's cell, a stable sort by cell, per-cell corner sums, the per-row
    gather of 8 corners with clamped upper corners dropped) against JAX's
    _mm_grad_table at uniform, ray-ordered and Morton-ordered points, with
    points outside [0, 1]^3, NaN, on the top faces and at the clamped
    corner: a corner-mapping error shows here, before any card run."""
    monkeypatch.setenv("RAW_NGP_MM_LEVELS", "auto")
    js = JSpec.create(**_CELL_SPECS[name])
    tspec = TSpec.create(**_CELL_SPECS[name])
    assert th.matmul_split(tspec) == hf._matmul_split(js) > 0
    x = _top_face_points(_kind_points(kind, 1500))
    cot = np.random.default_rng(4).standard_normal(
        (x.shape[0], js.output_dim)).astype(np.float32)
    _assert_cells_match_jax(x, cot, js, tspec, dtype)


def test_encode_plain_and_default_paths_agree():
    """hash_encode_plain (the plain version on any device) gives the same
    output and table gradient as hash_encode on CPU tensors."""
    tspec = TSpec.create(**_SPECS["L2xC16"])
    x = torch.from_numpy(_points(200))
    rng = np.random.default_rng(3)
    base = torch.from_numpy(rng.standard_normal(
        tspec.n_params * tspec.level_dim).astype(np.float32) * 0.1)
    grads = []
    for fn in (th.hash_encode, th.hash_encode_plain):
        p = base.clone().requires_grad_()
        out = fn(p, x, tspec, compute_dtype=torch.bfloat16)
        (out.float() ** 2).sum().backward()
        grads.append((_np(out.float()), _np(p.grad)))
    np.testing.assert_array_equal(grads[0][0], grads[1][0])
    np.testing.assert_array_equal(grads[0][1], grads[1][1])


@pytest.mark.parametrize("gdtype", ["f32", "bf16"])
def test_table_grad_glue_matches_jax(monkeypatch, gdtype):
    """The table gradient's glue on CPU tensors (the plain versions, no
    launch): pack_g_words equals JAX's _pack_bf16_pairs of each window
    level's g-channels (truncations of the f32 values) and combine_totals
    JAX's G0 + shift(G1) (hash_fused.py:686), bit for bit."""
    monkeypatch.setenv("RAW_NGP_MM_LEVELS", "1")
    tspec = TSpec.create(**_SPECS["L2xC16"])
    C, m = tspec.level_dim, th.matmul_split(tspec)
    rng = np.random.default_rng(8)
    g = rng.standard_normal((300, tspec.output_dim)).astype(np.float32)
    g_t = torch.from_numpy(g).to(torch.bfloat16 if gdtype == "bf16"
                                 else torch.float32)
    g32 = g_t.float().numpy()
    launches = (th.pack_g_words.launches, th.combine_totals.launches)
    words = th.pack_g_words(g_t, tspec)
    assert words.shape == (tspec.num_levels - m, 300, C // 2)
    for i, lv in enumerate(range(m, tspec.num_levels)):
        want = hf._pack_bf16_pairs([jnp.asarray(g32[:, lv * C + c])
                                    for c in range(C)])
        np.testing.assert_array_equal(
            _np(words[i]).view(np.uint32),
            np.stack([np.asarray(w) for w in want], axis=1))
    totals = rng.standard_normal((500, 2 * C)).astype(np.float32)
    out = th.combine_totals(torch.from_numpy(totals), torch.empty(500 * C))
    want = totals[:, :C] + np.concatenate([np.zeros((1, C), np.float32),
                                           totals[:-1, C:]])
    np.testing.assert_array_equal(_np(out).reshape(500, C), want)
    assert (th.pack_g_words.launches, th.combine_totals.launches) == launches


def test_unported_gradients_raise():
    """The gradients the pose slice ported (the encode's input gradient,
    B1's backward) now flow; what is still unported raises instead of
    returning a wrong result: rfield fields and the sampler's exposures,
    light directions and per-camera near/far."""
    tspec = TSpec.create(**_SPECS["L2xC16"])
    table = torch.zeros(tspec.n_params * tspec.level_dim)
    x = torch.rand(8, 3, requires_grad=True)
    th.hash_encode(table, x, tspec).sum().backward()
    assert x.grad is not None and x.grad.shape == (8, 3)
    attrs = torch.rand(2, 16, requires_grad=True)
    keys = torch.full((16,), SENTINEL, dtype=torch.int32)
    compact_attrs(attrs, keys, torch.zeros(16, dtype=torch.int32),
                  8)[1].sum().backward()
    assert torch.equal(attrs.grad, torch.zeros(2, 16))
    cfg = tcfg.Config().with_preset_O()
    with pytest.raises(NotImplementedError):
        t_make_spec(replace(cfg, model=replace(cfg.model, rfield=True)))
    train, _ = make_synthetic_scene(n_train=2, n_val=1, H=8, W=8, seed=0)
    arrays = [torch.from_numpy(a) for a in
              (train.images, train.poses, train.intrinsics)]
    for kw in ({"exposures": torch.ones(2, 1)}, {"ldirs": torch.ones(2, 3)},
               {"cam_near_far": torch.ones(2, 2)}):
        with pytest.raises(NotImplementedError):
            t_sample(torch.Generator().manual_seed(0), *arrays, 8, **kw)


# ---------------------------------------------------------------- (d)

def test_sampler_explicit_coords_bit_identical():
    """The coords / coord_image_indices hook: the same rays and GT pixels,
    bit for bit."""
    train, _ = make_synthetic_scene(n_train=5, n_val=1, H=24, W=32, seed=0)
    rng = np.random.default_rng(4)
    n = 257
    coords = np.stack([rng.integers(0, 24, n), rng.integers(0, 32, n)], -1)
    idx = rng.integers(0, 5, n)
    bj = j_sample(jax.random.PRNGKey(0), jnp.asarray(train.images),
                  jnp.asarray(train.poses), jnp.asarray(train.intrinsics), n,
                  coords=jnp.asarray(coords),
                  coord_image_indices=jnp.asarray(idx))
    bt = t_sample(None, torch.from_numpy(train.images),
                  torch.from_numpy(train.poses),
                  torch.from_numpy(train.intrinsics), n,
                  coords=torch.from_numpy(coords),
                  coord_image_indices=torch.from_numpy(idx))
    for k in ("rays_o", "rays_d", "images", "index"):
        np.testing.assert_array_equal(_np(bt[k]), np.asarray(bj[k]),
                                      err_msg=k)


def test_sampler_random_modes():
    """Random pixels of random images, or of one image per batch."""
    train, _ = make_synthetic_scene(n_train=5, n_val=1, H=8, W=8, seed=0)
    arrays = [torch.from_numpy(a) for a in
              (train.images, train.poses, train.intrinsics)]
    gen = torch.Generator().manual_seed(0)
    b = t_sample(gen, *arrays, 512, random_image_batch=True)
    assert b["rays_o"].shape == (512, 3) and b["images"].shape == (512, 3)
    assert len(torch.unique(b["index"])) > 1
    b = t_sample(gen, *arrays, 64, random_image_batch=False)
    assert len(torch.unique(b["index"])) == 1
    with pytest.raises(NotImplementedError):
        t_sample(gen, *arrays, 8, mosaiced=True)


# ---------------------------------------------------------------- (e)

@pytest.fixture(scope="module")
def mini():
    jc, tc = mini_cfg(jcfg), mini_cfg(tcfg)
    jspec, tspec = j_make_spec(jc), t_make_spec(tc)
    params = jax.tree_util.tree_map(
        np.asarray, j_init_field(jax.random.PRNGKey(0), jspec))
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
                                      seed=0)
    return SimpleNamespace(jc=jc, tc=tc, jspec=jspec, tspec=tspec,
                           params=params, dg=dg, bits=bits, train=train,
                           val=val)


def _jax_grid_state(s, dg, key):
    return JState(params=s.params, opt_state=None, ema_params=None, key=key,
                  step=jnp.zeros((), jnp.int32), density_grid=jnp.asarray(dg),
                  density_bitfield=jnp.zeros(dg.size // 8, jnp.uint8),
                  mean_density=jnp.zeros((), jnp.float32),
                  iter_density=jnp.zeros((), jnp.int32))


def test_grid_refresh_full_and_partial_match_jax(mini):
    """make_grid_update's full sweep (refresh 0) and partial sweep of
    cascade 0 (refresh 16), then finish, against JAX fed the same noise
    and indices (JAX eager, so the encode positions round alike). The
    density query of the two encoders agrees to ~1e-6 relative, so grid
    values at rtol 1e-4; the bitfield and the mean density follow."""
    s = mini
    field = field_from_jax(s.params, s.tspec, device="cpu")
    update_j = jgrid.make_grid_update(s.jc, s.jspec)
    h3 = s.jc.render.grid_size ** 3
    cas_n = s.jc.cascades
    dg0 = np.where(s.dg > 0, s.dg, 0.0).astype(np.float32)

    st = _jax_grid_state(s, dg0, jax.random.PRNGKey(7))
    with jax.disable_jit():
        full_j = update_j(st, 0)
    _, k = jax.random.split(st.key)
    noise = np.stack([np.asarray(jax.random.uniform(kc, (h3, 3)))
                      for kc in jax.random.split(k, cas_n)])
    tmp = tgrid.full_sweep(field, s.tc, torch.from_numpy(noise))
    grid_t, bits_t, mean_t = tgrid.finish(torch.from_numpy(dg0), tmp,
                                          s.tc.render.density_thresh)
    np.testing.assert_allclose(_np(grid_t), np.asarray(full_j.density_grid),
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(float(mean_t), float(full_j.mean_density),
                               rtol=1e-5)
    np.testing.assert_array_equal(_np(bits_t),
                                  np.asarray(full_j.density_bitfield))

    dg1 = np.array(full_j.density_grid)
    st1 = full_j.replace(key=jax.random.PRNGKey(8))
    with jax.disable_jit():
        part_j = update_j(st1, 16)
    npart = tgrid.n_partial(s.tc)
    _, k = jax.random.split(st1.key)
    k_rand, k_occ, k_noise = jax.random.split(k, 3)
    rand_idx = np.sort(np.asarray(jax.random.randint(
        k_rand, (npart,), 0, h3)))
    phase = int(jax.random.randint(k_occ, (), 0, 1 << 30))
    noise = np.asarray(jax.random.uniform(k_noise, (2 * npart, 3)))
    tmp = tgrid.partial_sweep(field, s.tc, torch.from_numpy(dg1), 0,
                              torch.from_numpy(rand_idx), phase,
                              torch.from_numpy(noise))
    assert ((_np(tmp[0]) >= 0).sum() > npart // 2
            and (_np(tmp[1]) < 0).all())
    grid_t, bits_t, mean_t = tgrid.finish(torch.from_numpy(dg1), tmp,
                                          s.tc.render.density_thresh)
    np.testing.assert_allclose(_np(grid_t), np.asarray(part_j.density_grid),
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(float(mean_t), float(part_j.mean_density),
                               rtol=1e-5)
    np.testing.assert_array_equal(_np(bits_t),
                                  np.asarray(part_j.density_bitfield))

    # the port's own update draws from a generator and keeps the schedule
    update_t = tgrid.make_grid_update(s.tc)
    state = {k: torch.as_tensor(np.asarray(v)) for k, v in
             dict(density_grid=dg1, density_bitfield=part_j.density_bitfield,
                  mean_density=part_j.mean_density,
                  iter_density=part_j.iter_density).items()}
    out = update_t(field, state, 17, torch.Generator().manual_seed(0))
    assert int(out["iter_density"]) == int(part_j.iter_density) + 1
    assert (_np(out["density_grid"])[0] == dg1[0]).all()   # cascade 1 only


def test_mark_untrained_grid_bit_identical(mini):
    s = mini
    aabb = np.clip(s.train.pts_aabb, -s.jc.render.bound, s.jc.render.bound)
    gj = np.asarray(jgrid.mark_untrained_grid(s.jc, s.train.poses,
                                              s.train.intrinsics, aabb))
    gt = tgrid.mark_untrained_grid(s.tc, s.train.poses, s.train.intrinsics,
                                   aabb)
    assert (gj < 0).any() and (gj == 0).any()
    np.testing.assert_array_equal(gt, gj)


# ---------------------------------------------------------------- (f)

@pytest.mark.parametrize("fp16", [False, True])
def test_one_train_step_loss_and_gradients_match_jax(mini, fp16):
    """One step on the golden miniature with the same params, bitfield and
    explicit ray batch, key=None: the loss and the gradient of each leaf
    (grid, grid_mlp, view_mlp) against eager JAX
    jax.value_and_grad(make_batch_loss_fn(...)) with the interpreted B2.
    f32: sums run in other orders, 1e-4 of each leaf's largest entry
    (measured: at most 1e-5, on the table). bf16: the encode forward takes
    JAX's rounding chain bit for bit (test_encode_bf16_forward_matches_jax),
    so the loss agrees to 6.5e-8 relative and the MLP leaves exactly
    (measured); the table's gradient differs where its dense level's bf16
    total lands one ulp apart and by f32 sum order, 1.5e-4 of its largest
    entry (measured): loss rtol 1e-5, 1e-3 of each leaf's largest entry.
    test_mlp_bf16_gradients_round_like_jax holds the bf16 gradient
    roundings themselves bit for bit."""
    s = mini
    jc, tc = mini_cfg(jcfg, fp16), mini_cfg(tcfg, fp16)
    jspec, tspec = j_make_spec(jc), t_make_spec(tc)
    rng = np.random.default_rng(5)
    n = 512
    coords = np.stack([rng.integers(8, 24, n), rng.integers(8, 24, n)], -1)
    idx = rng.integers(0, s.train.n_images, n)
    batch_j = j_sample(jax.random.PRNGKey(0), jnp.asarray(s.train.images),
                       jnp.asarray(s.train.poses),
                       jnp.asarray(s.train.intrinsics), n,
                       coords=jnp.asarray(coords),
                       coord_image_indices=jnp.asarray(idx))
    aabb = np.clip(s.train.pts_aabb, -2.0, 2.0).astype(np.float32)
    jstate = SimpleNamespace(density_bitfield=jnp.asarray(s.bits))
    fn = jtr.make_batch_loss_fn(jc, jspec)
    (loss_j, aux_j), g_j = _interpreted(lambda: jax.value_and_grad(
        fn, has_aux=True)(jax.tree_util.tree_map(jnp.asarray, s.params),
                          jstate, batch_j, jnp.asarray(aabb), None, 1.0,
                          True))

    field = field_from_jax(s.params, tspec, device="cpu")
    batch_t = {k: torch.from_numpy(np.array(v)) for k, v in batch_j.items()}
    tstate = SimpleNamespace(density_bitfield=bitfield_from_jax(s.bits,
                                                                device="cpu"))
    loss_t, aux_t = ttr.make_batch_loss_fn(tc, tspec)(
        field, tstate, batch_t, torch.from_numpy(aabb))
    loss_t.backward()
    assert int(aux_t["num_points"]) == int(aux_j["num_points"]) > 0
    assert int(aux_t["num_points_raw"]) == int(aux_j["num_points_raw"])
    tol = 1e-3 if fp16 else 1e-4
    np.testing.assert_allclose(float(loss_t.detach()), float(loss_j),
                               rtol=1e-5)
    leaves = [("grid", field.grid, g_j["grid"])]
    leaves += [(f"grid_mlp.{i}", w, g_j["grid_mlp"][i]["w"])
               for i, w in enumerate(field.grid_mlp)]
    leaves += [(f"view_mlp.{i}", w, g_j["view_mlp"][i]["w"])
               for i, w in enumerate(field.view_mlp)]
    for name, p, gj in leaves:
        gj = np.asarray(gj, np.float32).reshape(p.shape)
        scale = np.abs(gj).max()
        assert scale > 0, name
        np.testing.assert_allclose(_np(p.grad), gj, rtol=0,
                                   atol=tol * scale, err_msg=name)


def test_mlp_bf16_gradients_round_like_jax():
    """Under bf16 the port's MLP emulation (bf16-rounded operands, f32
    products) rounds its gradients where JAX's bf16 dot_general transpose
    does: an f32 product converted to the operand's bf16. The input and
    weight gradients agree bit for bit except where an f32 sum order
    moves a value across a bf16 rounding boundary (one bf16 ulp)."""
    from raw_ngp_torch.models.mlp import apply_mlp as t_apply
    from raw_ngp_tpu.models.mlp import apply_mlp as j_apply
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2048, 32)).astype(np.float32)
    ws = [(rng.standard_normal(s) * 0.3).astype(np.float32)
          for s in ((32, 64), (64, 64), (64, 16))]
    cot = rng.standard_normal((2048, 16)).astype(np.float32)

    def j_loss(x, ws):
        out = j_apply([{"w": w} for w in ws], x, "relu", 2.0, jnp.bfloat16)
        return (out * jnp.asarray(cot)).sum()

    gx_j, gw_j = jax.grad(j_loss, argnums=(0, 1))(
        jnp.asarray(x), [jnp.asarray(w) for w in ws])
    xt = torch.from_numpy(x).requires_grad_()
    wt = [torch.from_numpy(w).requires_grad_() for w in ws]
    (t_apply(wt, xt, "relu", 2.0, torch.bfloat16)
     * torch.from_numpy(cot)).sum().backward()
    # the input gradient is a bf16 value, as JAX's transpose leaves it
    assert torch.equal(xt.grad, xt.grad.to(torch.bfloat16).float())
    for got, want in [(xt.grad, gx_j)] + list(zip((w.grad for w in wt),
                                                  gw_j)):
        got, want = _np(got), np.asarray(want)
        assert (got == want).mean() >= 0.999
        np.testing.assert_allclose(got, want, rtol=2.0 ** -7, atol=0)


# ---------------------------------------------------------------- (g)

def test_fused_adam_ema_matches_jax(mini):
    """params, EMA, mu and nu after 1 and 3 steps fed the same gradients,
    then a step with an inf gradient, which freezes params and moments
    (the EMA still moves). The LR and bias corrections are f32 scalars on
    both sides, but the two libraries' f32 pow may round an ulp apart:
    rtol 1e-6, plus an absolute 1e-6 of the leaf's largest magnitude for
    entries near zero."""
    s = mini
    jc, tc = mini_cfg(jcfg), mini_cfg(tcfg)
    jopt, topt = jtr.fused_adam_ema(jc), ttr.fused_adam_ema(tc)
    params_j = jax.tree_util.tree_map(jnp.asarray, s.params)
    field = field_from_jax(s.params, t_make_spec(tc), device="cpu")
    params_t = {k: p.detach().clone() for k, p in field.named_parameters()}
    ema_j = jax.tree_util.tree_map(jnp.copy, params_j)
    ema_t = {k: p.clone() for k, p in params_t.items()}
    st_j, st_t = jopt.init(params_j), topt.init(params_t)
    rng = np.random.default_rng(6)

    def leaf_names(tree):
        out = {"grid": tree["grid"]}
        for top in ("grid_mlp", "view_mlp"):
            for i, layer in enumerate(tree[top]):
                out[f"{top}.{i}"] = layer["w"]
        return out

    def check(step):
        for tree_j, tree_t, what in ((params_j, params_t, "params"),
                                     (ema_j, ema_t, "ema"),
                                     (st_j.mu, st_t.mu, "mu"),
                                     (st_j.nu, st_t.nu, "nu")):
            for k, vj in leaf_names(tree_j).items():
                vj = np.asarray(vj).reshape(-1)
                np.testing.assert_allclose(
                    _np(tree_t[k]).reshape(-1), vj, rtol=1e-6,
                    atol=1e-6 * np.abs(vj).max(),
                    err_msg=f"{what} {k} step {step}")

    for step in range(1, 5):
        grads_np = {k: (rng.standard_normal(v.shape) * 1e-2).astype(
            np.float32) for k, v in leaf_names(params_j).items()}
        if step == 4:
            grads_np["grid_mlp.1"][0, 0] = np.inf
        grads_j = {"grid": jnp.asarray(grads_np["grid"])}
        for top in ("grid_mlp", "view_mlp"):
            grads_j[top] = [{"w": jnp.asarray(grads_np[f"{top}.{i}"])}
                            for i in range(len(params_j[top]))]
        params_j, ema_j, st_j = jopt.update_apply(grads_j, st_j, params_j,
                                                  ema_j)
        before = {k: v.clone() for k, v in params_t.items()}
        mu_before = {k: v.clone() for k, v in st_t.mu.items()}
        topt.update_apply({k: torch.from_numpy(v.reshape(params_t[k].shape))
                           for k, v in grads_np.items()}, st_t, params_t,
                          ema_t)
        assert st_t.count == step
        if step in (1, 3, 4):
            check(step)
        if step == 4:
            for k in params_t:
                assert torch.equal(params_t[k], before[k])
                assert torch.equal(st_t.mu[k], mu_before[k])


@pytest.mark.parametrize("anneal", [False, True])
def test_network_lr_schedule_matches_jax(anneal):
    """The step decay and the cosine branch, as f32 values; rtol 1e-6."""
    jc, tc = (replace(c, train=replace(c.train, anneal_lr=anneal))
              for c in (mini_cfg(jcfg), mini_cfg(tcfg)))
    fj, ft = jtr.network_lr_schedule(jc), ttr.network_lr_schedule(tc)
    for step in (0, 1, 75, 149, 150, 300, 5999, 6000, 7000):
        np.testing.assert_allclose(float(ft(step)),
                                   float(fj(jnp.asarray(step, jnp.int32))),
                                   rtol=1e-6, err_msg=str(step))


def test_adaptive_batching_follows_jax():
    """_adapt_batch and adaptation_quiescent take the JAX Trainer's
    decisions (ray growth, budget shrink, re-growth) on the same sequence
    of live-sample counts; the JAX methods run on a stand-in that holds
    the same fields."""
    jc, tc = (replace(c, train=replace(c.train, adaptive_num_rays=True))
              for c in (mini_cfg(jcfg), mini_cfg(tcfg)))
    train, _ = make_synthetic_scene(n_train=4, n_val=1, H=16, W=16, seed=0)
    tr = ttr.Trainer(tc, train, device="cpu")
    fake = SimpleNamespace(cfg=jc, _pts_ema=None, num_rays=jc.train.num_rays,
                           _point_budget=None,
                           logger=SimpleNamespace(log=lambda *a: None),
                           _get_step=lambda n: None)
    fake.base_point_budget = lambda: jtr.Trainer.base_point_budget(fake)
    assert tr.base_point_budget() == fake.base_point_budget()
    seen = set()
    for pts in (6000, 2500, 300, 100, 100, 100, 100, 100, 5000, 9000, 9000,
                700):
        metrics = {"num_points": np.int32(min(pts, 6144)),
                   "num_points_raw": np.int32(pts)}
        jtr.Trainer._adapt_batch(fake, metrics)
        tr._adapt_batch({k: torch.tensor(int(v)) for k, v in
                         metrics.items()})
        assert (tr.num_rays, tr._point_budget) == (fake.num_rays,
                                                   fake._point_budget)
        assert tr.adaptation_quiescent() == \
            jtr.Trainer.adaptation_quiescent(fake)
        seen.add((tr.num_rays, tr._point_budget))
    assert len(seen) >= 3          # growth and shrink both happened


# ---------------------------------------------------------------- (h)

def test_trainer_reaches_golden_quality():
    """The port's Trainer on the golden miniature (150 steps, fp32, CPU):
    its val-view PSNR against ground truth is at least the JAX golden
    render's own PSNR against ground truth minus 1.5 dB. The RNG streams
    differ, so this is statistical: over seeds 0-4 the port measured
    15.19-16.09 dB against the golden's 16.00 (CPU, clipped renders), a
    worst shortfall of 0.81 dB; the margin is about twice that."""
    cfg = mini_cfg(tcfg)
    train, val = make_synthetic_scene(n_train=12, n_val=1, H=32, W=32,
                                      seed=0)
    tr = ttr.Trainer(cfg, train, val, device="cpu")
    out = tr.train(150, log_every=150)
    assert out["rays_per_sec"] > 0
    assert np.isfinite(tr.stats["loss"]).all()
    assert tr.stats["loss"][-1] < tr.stats["loss"][0]
    rgb, depth = tr.render_image(val.poses[0])
    assert rgb.shape == (32, 32, 3) and np.isfinite(rgb).all()
    gt = val.images[0]

    def psnr(img):
        return -10 * np.log10(np.mean((np.clip(img, 0, 1) - gt) ** 2))

    golden = np.load(GOLDEN)
    assert psnr(rgb) >= psnr(golden) - 1.5, (psnr(rgb), psnr(golden))
    assert tr.evaluate()["psnr"] > 10.0
