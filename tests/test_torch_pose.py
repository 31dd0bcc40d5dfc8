"""Parity of the port's pose-refinement path (raw_ngp_torch: the se(3) maps,
the sampler's pose noise and refinements, the BARF / BAA-NGP annealing,
B1's backward, the encode's input gradient, the ray-row gather's backward,
one pose train step, the pose optimizer, the Trainer and the pose
analysis) with the JAX package's, on the CPU.

Both packages get the same numpy inputs. The JAX table gradient runs its
Pallas segment-totals kernel interpreted (``segsum_pallas.FORCE_INTERPRET``)
and B1's backward is held against the VJP of the interpreted Pallas
compaction (``compact_pallas.FORCE_INTERPRET``); both flags are set back
in a ``finally``. JAX runs eagerly where rays and march positions
matter: the port rounds its small matrix products as eager CPU JAX does
(``raw_ngp_torch.ops.lie.matmul_fma``), so the rays are bit-identical.
Each test states its tolerance and the reason for it.
"""

from dataclasses import replace
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import raw_ngp_torch.config as tcfg
import raw_ngp_tpu.config as jcfg
import raw_ngp_tpu.kernels.compact_pallas as cp
import raw_ngp_tpu.kernels.segsum_pallas as sp
from raw_ngp_torch.convert import bitfield_from_jax, field_from_jax, \
    pose_from_jax
from raw_ngp_torch.data import make_synthetic_scene
from raw_ngp_torch.data.sampler import sample_ray_batch as t_sample
from raw_ngp_torch.kernels import compact as tc
from raw_ngp_torch.kernels import hash_encode as th
from raw_ngp_torch.models import ngp as tngp
from raw_ngp_torch.ops import lie as tl
from raw_ngp_torch.ops.hashgrid import HashGridSpec as TSpec
from raw_ngp_torch.ops.hashgrid import hash_encode_01
from raw_ngp_torch.render import occupancy as tocc
from raw_ngp_torch.train import pose_analysis as tpa
from raw_ngp_torch.train import trainer as ttr
from raw_ngp_tpu.data.sampler import sample_ray_batch as j_sample
from raw_ngp_tpu.kernels import hash_fused as hf
from raw_ngp_tpu.models import ngp as jngp
from raw_ngp_tpu.ops import grid as jgrid
from raw_ngp_tpu.ops import lie as jl
from raw_ngp_tpu.ops.hashgrid import HashGridSpec as JSpec
from raw_ngp_tpu.ops.morton import morton3d_invert as j_morton_invert
from raw_ngp_tpu.render import occupancy as jocc
from raw_ngp_tpu.train import pose_analysis as jpa
from raw_ngp_tpu.train import trainer as jtr
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


def _np(t):
    return t.detach().cpu().numpy()


def _interpreted(fn, module=sp):
    module.FORCE_INTERPRET = True
    try:
        return fn()
    finally:
        module.FORCE_INTERPRET = False


# ---------------------------------------------------------------- lie


@pytest.mark.parametrize("zero", [True, False])
def test_lie_functions_and_refinement_gradient_match_jax(zero):
    """skew, the three series, so3/se3 exp maps, compose_pose,
    apply_refinement, rotation_distance and procrustes_analysis, and
    jax.grad of apply_refinement at zero and at random se(3). The products
    round as JAX's do, but the gradients' sums run in other orders and
    the two libraries' arccos/SVD may differ by ulps: rtol 1e-6 (atol
    1e-6 of the largest entry for entries near zero)."""
    rng = np.random.default_rng(0)
    n = 64
    se3 = (np.zeros((n, 6)) if zero
           else rng.standard_normal((n, 6)) * 0.3).astype(np.float32)
    poses = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    poses[:, :3, :4] = np.asarray(jl.se3_to_SE3(jnp.asarray(
        (rng.standard_normal((n, 6)) * 0.5).astype(np.float32))))
    cot = rng.standard_normal((n, 3, 4)).astype(np.float32)
    x2 = (rng.random(n) * 2.0).astype(np.float32)

    def close(got, want, what):
        want = np.asarray(want)
        np.testing.assert_allclose(_np(got), want, rtol=1e-6,
                                   atol=1e-6 * max(np.abs(want).max(), 1e-30),
                                   err_msg=what)

    close(tl.skew(torch.from_numpy(se3[:, :3])),
          jl.skew(jnp.asarray(se3[:, :3])), "skew")
    for name in ("A", "B", "C"):
        close(getattr(tl, f"taylor_{name}_sq")(torch.from_numpy(x2)),
              getattr(jl, f"_taylor_{name}_sq")(jnp.asarray(x2)), name)
    close(tl.so3_to_SO3(torch.from_numpy(se3[:, :3])),
          jl.so3_to_SO3(jnp.asarray(se3[:, :3])), "so3_to_SO3")
    close(tl.se3_to_SE3(torch.from_numpy(se3)),
          jl.se3_to_SE3(jnp.asarray(se3)), "se3_to_SE3")
    pa = np.array(jl.se3_to_SE3(jnp.asarray(se3 + 0.1)))
    close(tl.compose_pose(torch.from_numpy(pa),
                          torch.from_numpy(poses[:, :3])),
          jl.compose_pose(jnp.asarray(pa), jnp.asarray(poses[:, :3])),
          "compose_pose")
    close(tl.rotation_distance(torch.from_numpy(poses[:, :3, :3]),
                               torch.from_numpy(pa[:, :3, :3])),
          jl.rotation_distance(jnp.asarray(poses[:, :3, :3]),
                               jnp.asarray(pa[:, :3, :3])),
          "rotation_distance")
    X0 = rng.standard_normal((20, 3)).astype(np.float32)
    X1 = (X0 @ np.asarray(pa[0, :3, :3]).T * 1.7 + 0.3).astype(np.float32)
    pt = tl.procrustes_analysis(torch.from_numpy(X0), torch.from_numpy(X1))
    pj = jl.procrustes_analysis(jnp.asarray(X0), jnp.asarray(X1))
    for k in ("t0", "t1", "s0", "s1"):
        close(pt[k], pj[k], k)
    np.testing.assert_allclose(_np(pt["R"]), np.asarray(pj["R"]), atol=1e-5)

    def j_loss(s):
        return (jl.apply_refinement(s, jnp.asarray(poses))
                * jnp.asarray(cot)).sum()

    refined_j = jl.apply_refinement(jnp.asarray(se3), jnp.asarray(poses))
    gj = jax.grad(j_loss)(jnp.asarray(se3))
    st = torch.from_numpy(se3).requires_grad_()
    refined_t = tl.apply_refinement(st, torch.from_numpy(poses))
    (refined_t * torch.from_numpy(cot)).sum().backward()
    close(refined_t, refined_j, "apply_refinement")
    close(st.grad, gj, "grad apply_refinement")
    assert np.isfinite(_np(st.grad)).all()


# ---------------------------------------------------------------- sampler


def test_sampler_with_pose_noise_and_refinement_bit_identical():
    """Explicit coords with se3_refine and pose_noise: the same rays and
    pixels as the JAX sampler, bit for bit (the per-ray exp map and pose
    products round as eager CPU JAX's)."""
    train, _ = make_synthetic_scene(n_train=5, n_val=1, H=24, W=32, seed=0)
    rng = np.random.default_rng(4)
    n = 257
    coords = np.stack([rng.integers(0, 24, n), rng.integers(0, 32, n)], -1)
    idx = rng.integers(0, 5, n)
    se3 = (rng.standard_normal((5, 6)) * 0.05).astype(np.float32)
    noise = np.asarray(jl.se3_to_SE3(jnp.asarray(
        (rng.standard_normal((5, 6)) * 0.05).astype(np.float32))))
    bj = j_sample(jax.random.PRNGKey(0), jnp.asarray(train.images),
                  jnp.asarray(train.poses), jnp.asarray(train.intrinsics), n,
                  coords=jnp.asarray(coords),
                  coord_image_indices=jnp.asarray(idx),
                  se3_refine=jnp.asarray(se3), pose_noise=jnp.asarray(noise))
    bt = t_sample(None, torch.from_numpy(train.images),
                  torch.from_numpy(train.poses),
                  torch.from_numpy(train.intrinsics), n,
                  coords=torch.from_numpy(coords),
                  coord_image_indices=torch.from_numpy(idx),
                  se3_refine=torch.from_numpy(se3),
                  pose_noise=torch.from_numpy(np.array(noise)))
    for k in ("rays_o", "rays_d", "images", "index"):
        np.testing.assert_array_equal(_np(bt[k]), np.asarray(bj[k]),
                                      err_msg=k)


# ---------------------------------------------------------------- annealing


@pytest.mark.parametrize("profile", ["flagship", "default"])
def test_annealing_weights_and_blend_match_jax(profile):
    """barf_level_weights and baangp_blend at annealing 0, 0.1, 0.5 and 1,
    on the flagship's 2 x 16 grid and the default 16 x 2 one (where the
    blend's ``weights[:2] = 1`` covers one whole level). The ramp is f32 on
    both sides; cos may differ by an ulp: rtol 1e-6, atol 1e-7."""
    jc, tcf = (mod.Config().with_preset_O() for mod in (jcfg, tcfg))
    if profile == "flagship":
        jc, tcf = jc.with_tpu_profile(), tcf.with_tpu_profile()
    jc, tcf = (c.with_pose_opt("barf", 4) for c in (jc, tcf))
    L, C = jc.model.num_levels, jc.model.level_dim
    feats = np.random.default_rng(1).standard_normal(
        (33, L * C)).astype(np.float32)
    for ann in (0.0, 0.1, 0.5, 1.0):
        wj = jngp.barf_level_weights(jc, jnp.float32(ann))
        wt = tngp.barf_level_weights(tcf, ann)
        np.testing.assert_allclose(_np(wt), np.asarray(wj), rtol=1e-6,
                                   atol=1e-7, err_msg=f"barf {ann}")
        bj = jngp.baangp_blend(jc, jnp.float32(ann), jnp.asarray(feats))
        bt = tngp.baangp_blend(tcf, ann, torch.from_numpy(feats))
        np.testing.assert_allclose(_np(bt), np.asarray(bj), rtol=1e-6,
                                   atol=1e-7, err_msg=f"baangp {ann}")


# ---------------------------------------------------------------- B1 bwd


@pytest.mark.parametrize("case", ["keep 0.25", "overflow", "empty",
                                  "full"])
def test_compact_backward_matches_jax_vjp_bit_exact(case):
    """B1's plain backward (compact_attrs_bwd, through compact_attrs'
    autograd and through compact_positions_attrs) against
    jax.vjp of the interpreted compact_attrs_pallas: bit-exact, a copy of
    each kept slot's cotangent to its source index and 0 elsewhere."""
    rng = np.random.default_rng(11)
    M, m_pad = 1500, 512
    rate = {"keep 0.25": 0.25, "overflow": 0.5, "empty": 0.0,
            "full": 1.0}[case]
    mask = rng.random(M) < rate
    attrs = rng.standard_normal((2, M)).astype(np.float32)
    g = rng.standard_normal((2, m_pad)).astype(np.float32)
    c = np.cumsum(mask.astype(np.int32)).astype(np.int32)
    kept = mask & (c <= m_pad)
    keys = np.where(kept, c - 1, cp._SENTINEL).astype(np.int32)
    assert (c[-1] > m_pad) == (case in ("overflow", "full"))
    ac_j, vjp = jax.vjp(
        lambda a: _interpreted(lambda: cp.compact_attrs_pallas(
            a, jnp.asarray(keys), jnp.asarray(c), m_pad), cp)[1],
        jnp.asarray(attrs))
    gj = np.asarray(vjp(jnp.asarray(g))[0])

    at = torch.from_numpy(attrs).requires_grad_()
    pos, ac_t = tc.compact_attrs(at, torch.from_numpy(keys), m_pad)
    ac_t.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(_np(ac_t).view(np.int32),
                                  np.asarray(ac_j).view(np.int32))
    np.testing.assert_array_equal(_np(at.grad).view(np.int32),
                                  gj.view(np.int32))
    assert (_np(at.grad)[:, ~kept] == 0).all()
    np.testing.assert_array_equal(
        _np(tc.compact_attrs_bwd(torch.from_numpy(g), pos, M)).view(np.int32),
        gj.view(np.int32))
    a = [torch.from_numpy(attrs[i]).requires_grad_() for i in range(2)]
    _, _, _, (t_c, dt_c) = tc.compact_positions_attrs(torch.from_numpy(mask),
                                                      m_pad, a)
    (t_c * torch.from_numpy(g[0]) + dt_c * torch.from_numpy(g[1])
     ).sum().backward()
    for i in range(2):
        np.testing.assert_array_equal(_np(a[i].grad).view(np.int32),
                                      gj[i].view(np.int32))


# ---------------------------------------------------------------- encode


_SPECS = {
    "xor": dict(num_levels=6, level_dim=2, base_resolution=4,
                log2_hashmap_size=9, desired_resolution=64,
                hash_variant="xor"),
    "additive": dict(num_levels=6, level_dim=2, base_resolution=4,
                     log2_hashmap_size=9, desired_resolution=64,
                     hash_variant="additive"),
    # flagship-like L2 x C16: level 0 dense res 16 (the matmul level)
    "L2xC16": dict(num_levels=2, level_dim=16, log2_hashmap_size=12,
                   desired_resolution=256, hash_variant="additive"),
    "smoothstep": dict(num_levels=4, level_dim=4, base_resolution=4,
                       log2_hashmap_size=9, desired_resolution=64,
                       interpolation="smoothstep"),
    "align": dict(num_levels=4, level_dim=4, base_resolution=4,
                  log2_hashmap_size=9, desired_resolution=64,
                  align_corners=True),
}


def _points(B, res):
    rng = np.random.default_rng(1)
    x = rng.random((B, 3)).astype(np.float32)
    x[:5] = x[:5] * 3.0 - 1.0          # outside [0, 1]^3
    x[5, 1] = np.nan
    x[6], x[7] = 0.0, 1.0
    x[8, 0] = np.float32(0.5 / res)    # x * res - 0.5 == 0: a clip tie
    return x


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


@pytest.mark.parametrize("kind", ["uniform", "ray"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("name,mm", [("xor", "auto"), ("additive", "auto"),
                                     ("L2xC16", "auto"), ("L2xC16", "0"),
                                     ("smoothstep", "auto"),
                                     ("align", "auto")])
def test_encode_input_gradient_matches_jax(monkeypatch, name, mm, dtype,
                                           kind):
    """The encode's input gradient (plain version, also through the
    encode's autograd with x01 requiring a gradient) against the VJP of
    hash_encode_fused(..., need_input_grads=True) in x01, at uniform and
    ray-ordered points, with points outside [0, 1]^3, NaN and a clip tie
    in the first rows. Under bf16 both round the table,
    the lane products and (on the matmul level) the partial
    interpolations at the same points; only f32 sums run in another order
    (measured: at most 2.1e-7 of the largest entry): rtol 1e-5 of the
    largest entry, in f32 and bf16. In f32 it also agrees with
    torch.autograd through the plain encode hash_encode_01, except at the
    tie, where torch.clamp passes the whole gradient and jnp.clip half."""
    monkeypatch.setenv("RAW_NGP_MM_LEVELS", mm)
    js, ts = JSpec.create(**_SPECS[name]), TSpec.create(**_SPECS[name])
    assert th.matmul_split(ts) == hf._matmul_split(js)
    B = 400
    rng = np.random.default_rng(2)
    x = _points(B, ts.resolutions[-1])
    if kind == "ray":
        x[9:] = _ray_points(B - 9)
    params = (rng.standard_normal(js.n_params * js.level_dim) * 0.1
              ).astype(np.float32)
    cot = rng.standard_normal((B, js.output_dim)).astype(np.float32)
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    g = jnp.asarray(cot).astype(jdt)
    _, vjp = jax.vjp(lambda xx: hf.hash_encode_fused(
        jnp.asarray(params), xx, js, True, jdt), jnp.asarray(x))
    gj = np.asarray(vjp(g)[0])
    scale = np.abs(gj).max()
    assert scale > 0 and np.isfinite(gj).all()
    g_t = torch.from_numpy(np.asarray(g.astype(jnp.float32))).to(tdt)
    gt = th.encode_input_grad_plain(torch.from_numpy(params),
                                    torch.from_numpy(x), g_t, ts, tdt)
    np.testing.assert_allclose(_np(gt), gj, rtol=1e-5, atol=1e-5 * scale)
    # the encode's autograd hands the same gradient back (and the table's)
    xt = torch.from_numpy(x).requires_grad_()
    p = torch.from_numpy(params).requires_grad_()
    out = th.hash_encode(p, xt, ts, compute_dtype=tdt)
    out.backward(g_t)
    np.testing.assert_array_equal(_np(xt.grad), _np(gt))
    assert p.grad is not None and (_np(p.grad) != 0).any()
    if dtype == "f32":
        xa = torch.from_numpy(x).requires_grad_()
        (hash_encode_01(torch.from_numpy(params), xa, ts)
         * torch.from_numpy(cot)).sum().backward()
        ga = np.nan_to_num(_np(xa.grad))
        rows = np.arange(B) != 8
        np.testing.assert_allclose(ga[rows], _np(gt)[rows], rtol=1e-5,
                                   atol=1e-5 * scale)


def test_encode_input_gradient_with_the_table_frozen():
    """With the table frozen (requires_grad False) the encode is still
    differentiable in x01 and returns the plain input gradient."""
    ts = TSpec.create(**_SPECS["L2xC16"])
    x = torch.from_numpy(_points(64, ts.resolutions[-1])).requires_grad_()
    params = torch.full((ts.n_params * ts.level_dim,), 0.01)
    out = th.hash_encode(params, x, ts)
    assert out.requires_grad
    g = torch.ones_like(out)
    out.backward(g)
    want = th.encode_input_grad_plain(params, x.detach(), g, ts)
    np.testing.assert_array_equal(_np(x.grad), _np(want))


# ---------------------------------------------------------------- rows


def test_gather_ray_rows_backward_matches_jax():
    """gather_ray_rows' backward against JAX's (_gather_rows_bwd): per-ray
    f32 totals, each truncated to bf16. The port sums with index_add_, JAX
    with a shift-mask scan, so a total near a truncation boundary may land
    one bf16 ulp apart: rtol 2^-7 per entry, and at least 99% of the
    entries identical. Rows without samples are exactly 0."""
    rng = np.random.default_rng(3)
    N, m = 300, 4000
    rid = np.sort(rng.integers(0, N + 1, m)).astype(np.int32)
    rid[-200:] = N                              # unfilled slots: dummy row
    buf = rng.standard_normal((N + 1, 6)).astype(np.float32)
    g = rng.standard_normal((m, 6)).astype(np.float32)
    out_j, vjp = jax.vjp(lambda b: jocc.gather_ray_rows(b, jnp.asarray(rid)),
                         jnp.asarray(buf))
    gj = np.asarray(vjp(jnp.asarray(g))[0])
    bt = torch.from_numpy(buf).requires_grad_()
    out_t = tocc.gather_ray_rows(bt, torch.from_numpy(rid))
    out_t.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(_np(out_t), np.asarray(out_j))
    got = _np(bt.grad)
    assert (got.view(np.int32) & 0xFFFF == 0).all()      # truncated
    assert (got[np.setdiff1d(np.arange(N + 1), rid)] == 0).all()
    np.testing.assert_allclose(got, gj, rtol=2.0 ** -7, atol=0)
    assert (got == gj).mean() >= 0.99


# ---------------------------------------------------------------- step


@pytest.fixture(scope="module")
def pose_mini():
    jc = mini_cfg(jcfg)
    jspec = jngp.make_field_spec(jc)
    params = jax.tree_util.tree_map(
        np.asarray, jngp.init_field(jax.random.PRNGKey(0), jspec))
    n = jc.render.grid_size
    xyz = np.asarray(j_morton_invert(jnp.arange(n ** 3, dtype=jnp.uint32)))
    rng = np.random.default_rng(3)
    dg = np.zeros((jc.cascades, n ** 3), np.float32)
    for cas in range(jc.cascades):
        p = (2.0 * xyz / (n - 1) - 1.0) * min(2 ** cas, jc.render.bound)
        dg[cas] = np.where(np.linalg.norm(p, axis=-1) < 1.0, 20.0, 0.0)
        dg[cas] += 20.0 * (rng.random(n ** 3) < 0.02)
    bits = np.asarray(jgrid.packbits(jnp.asarray(dg), 10.0))
    train, _ = make_synthetic_scene(n_train=12, n_val=1, H=32, W=32, seed=0)
    return SimpleNamespace(params=params, bits=bits, train=train)


@pytest.mark.parametrize("mode", ["barf", "baangp"])
def test_pose_step_loss_and_gradients_match_jax(pose_mini, mode):
    """One fixed-batch step of the golden miniature with
    with_pose_opt(mode, 12), f32, annealing 0.1, random refinements and
    noise: loss, every net-gradient leaf and the pose gradient against
    jax.value_and_grad(argnums=(0, 1)) of the JAX sampler +
    make_batch_loss_fn(key=None). The rays and the march are bit-identical
    (same num_points); sums run in other orders and cos may differ by an
    ulp: loss rtol 1e-6; net leaves 1e-4 of each leaf's largest entry (as
    the step without poses); the pose gradient 1e-4 of its largest entry
    (measured 1.8e-7 / 4.5e-8: the per-ray totals truncated to bf16 agree
    but for an occasional ulp)."""
    s = pose_mini
    jc = mini_cfg(jcfg).with_pose_opt(mode, 12)
    tcf = mini_cfg(tcfg).with_pose_opt(mode, 12)
    jspec, tspec = jngp.make_field_spec(jc), tngp.make_field_spec(tcf)
    rng = np.random.default_rng(5)
    nr = 512
    coords = np.stack([rng.integers(8, 24, nr), rng.integers(8, 24, nr)], -1)
    idx = rng.integers(0, 12, nr)
    pose = (rng.standard_normal((12, 6)) * 0.01).astype(np.float32)
    noise = np.asarray(jl.se3_to_SE3(jnp.asarray(
        (rng.standard_normal((12, 6)) * 0.05).astype(np.float32))))
    aabb = np.clip(s.train.pts_aabb, -2.0, 2.0).astype(np.float32)
    ann = np.float32(0.1)
    jstate = SimpleNamespace(density_bitfield=jnp.asarray(s.bits))
    fn = jtr.make_batch_loss_fn(jc, jspec)

    def j_loss(params, pose_params):
        batch = j_sample(
            jax.random.PRNGKey(0), jnp.asarray(s.train.images),
            jnp.asarray(s.train.poses), jnp.asarray(s.train.intrinsics), nr,
            random_image_batch=False, se3_refine=pose_params,
            pose_noise=jnp.asarray(noise), coords=jnp.asarray(coords),
            coord_image_indices=jnp.asarray(idx))
        return fn(params, jstate, batch, jnp.asarray(aabb), None, ann, True)

    (loss_j, aux_j), (gn_j, gp_j) = _interpreted(lambda: jax.value_and_grad(
        j_loss, argnums=(0, 1), has_aux=True)(
            jax.tree_util.tree_map(jnp.asarray, s.params),
            jnp.asarray(pose)))

    field = field_from_jax(s.params, tspec, device="cpu")
    pose_t, noise_t = pose_from_jax(pose, noise, device="cpu")
    tstate = SimpleNamespace(
        density_bitfield=bitfield_from_jax(s.bits, device="cpu"),
        pose_params=pose_t, pose_noise=noise_t)
    batch = t_sample(None, torch.from_numpy(s.train.images),
                     torch.from_numpy(s.train.poses),
                     torch.from_numpy(s.train.intrinsics), nr,
                     random_image_batch=False, se3_refine=pose_t,
                     pose_noise=noise_t, coords=torch.from_numpy(coords),
                     coord_image_indices=torch.from_numpy(idx))
    loss_t, aux_t = ttr.make_batch_loss_fn(tcf, tspec)(
        field, tstate, batch, torch.from_numpy(aabb), annealing=ann)
    loss_t.backward()
    assert int(aux_t["num_points"]) == int(aux_j["num_points"]) > 0
    np.testing.assert_allclose(float(loss_t.detach()), float(loss_j),
                               rtol=1e-6)
    leaves = [("grid", field.grid, gn_j["grid"]), ("pose", pose_t, gp_j)]
    leaves += [(f"grid_mlp.{i}", w, gn_j["grid_mlp"][i]["w"])
               for i, w in enumerate(field.grid_mlp)]
    leaves += [(f"view_mlp.{i}", w, gn_j["view_mlp"][i]["w"])
               for i, w in enumerate(field.view_mlp)]
    for name, p, gj in leaves:
        gj = np.asarray(gj, np.float32).reshape(p.shape)
        scale = np.abs(gj).max()
        assert scale > 0, name
        np.testing.assert_allclose(_np(p.grad), gj, rtol=0,
                                   atol=1e-4 * scale, err_msg=name)


# ---------------------------------------------------------------- optimizer


def test_pose_adam_matches_optax_chain():
    """pose_adam against optax.chain(skip_nonfinite(), adam(pose LR,
    eps=1e-8)) over 5 steps fed the same gradients: step 3 holds an inf
    (the gradient is zeroed before Adam, so the moments decay and the
    pose still moves) and step 4 is frozen (gradient times 0). The LR and
    bias corrections are f32 pows on both sides that may round an ulp
    apart: rtol 1e-6 (atol 1e-6 of the largest entry)."""
    jc = mini_cfg(jcfg).with_pose_opt("barf", 7)
    tcf = mini_cfg(tcfg).with_pose_opt("barf", 7)
    _, tx = jtr.make_optimizers(jc)
    opt = ttr.pose_adam(tcf)
    rng = np.random.default_rng(8)
    p0 = (rng.standard_normal((7, 6)) * 1e-2).astype(np.float32)
    pj = jnp.asarray(p0)
    sj = tx.init(pj)
    pt = torch.from_numpy(p0.copy())
    st = opt.init(pt)
    for step in range(5):
        g = (rng.standard_normal((7, 6)) * 1e-3).astype(np.float32)
        if step == 2:
            g[3, 1] = np.inf
        if step == 3:
            g = g * 0.0
        upd, sj = tx.update(jnp.asarray(g), sj, pj)
        pj = optax.apply_updates(pj, upd)
        before = pt.clone()
        opt.update_apply(torch.from_numpy(g), st, pt)
        assert st.count == step + 1
        for got, want, what in ((pt, pj, "params"),
                                (st.mu["pose"], sj[1][0].mu, "mu"),
                                (st.nu["pose"], sj[1][0].nu, "nu")):
            want = np.asarray(want)
            np.testing.assert_allclose(_np(got), want, rtol=1e-6,
                                       atol=1e-6 * np.abs(want).max(),
                                       err_msg=f"{what} step {step}")
        assert not torch.equal(pt, before)       # momentum always moves it
    np.testing.assert_allclose(float(ttr.pose_lr_schedule(tcf)(37)),
                               float(jtr.pose_lr_schedule(jc)(
                                   jnp.asarray(37, jnp.int32))), rtol=1e-6)


# ---------------------------------------------------------------- trainer


@pytest.mark.parametrize("variant", ["noise", "identity"])
def test_pose_trainer_runs_on_cpu(variant, tmp_path):
    """The Trainer with BARF refinement for a few steps on the CPU: with
    the noise self-test the refinements leave zero and stay finite, and
    the pose freezes' schedule holds (frozen steps keep only Adam's
    momentum); with ``identity`` every camera starts at the identity and
    the ground truth moves to poses_gt."""
    cfg = mini_cfg(tcfg).with_pose_opt("barf", 6)
    cfg = replace(cfg, train=replace(cfg.train, iters=6, num_rays=256),
                  pose_opt=replace(cfg.pose_opt, end_annealing=0.5,
                                   noise=0.05 if variant == "noise" else 0.0,
                                   identity=variant == "identity"))
    train, val = make_synthetic_scene(n_train=6, n_val=1, H=16, W=16,
                                      seed=0)
    tr = ttr.Trainer(cfg, train, val, device="cpu", workspace=str(tmp_path))
    st = tr.state
    assert st.pose_params.shape == (6, 6) and st.pose_params.requires_grad
    if variant == "identity":
        assert st.pose_noise is None
        np.testing.assert_array_equal(tr.train_scene.poses,
                                      np.tile(np.eye(4), (6, 1, 1)))
        np.testing.assert_array_equal(tr.train_scene.poses_gt, train.poses)
    else:
        assert st.pose_noise.shape == (6, 3, 4)
        R = _np(st.pose_noise[:, :, :3])
        np.testing.assert_allclose(R @ R.transpose(0, 2, 1),
                                   np.tile(np.eye(3), (6, 1, 1)), atol=1e-5)
    tr.train(6, log_every=3)
    assert np.isfinite(tr.stats["loss"]).all()
    assert st.step == 6 and st.pose_opt_state.count == 6
    pose = _np(st.pose_params)
    assert np.isfinite(pose).all() and np.abs(pose).max() > 0
    errs = tpa.analyze_pose_optimization(tr)
    assert np.isfinite(errs["rotation_deg"]) and np.isfinite(
        errs["translation"])
    assert tr.evaluate()["psnr"] > 0


# ---------------------------------------------------------------- analysis


def test_pose_analysis_matches_jax(tmp_path):
    """The numpy helpers give JAX's numbers (rtol 1e-6); refined_poses of
    a port Trainer stand-in equals the JAX function's on the same state
    (the port's pose products round as JAX's: atol 1e-6)."""
    rng = np.random.default_rng(2)
    n = 9
    gt = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    gt[:, :3, :4] = np.asarray(jl.se3_to_SE3(jnp.asarray(
        (rng.standard_normal((n, 6)) * 0.5).astype(np.float32))))
    pred = gt.copy()
    pred[:, :3, :4] = np.asarray(jl.compose_pose(
        jl.se3_to_SE3(jnp.asarray((rng.standard_normal((n, 6)) * 0.05
                                   ).astype(np.float32))),
        jnp.asarray(gt[:, :3, :4])))
    for fn, args in (("prealign_cameras", (pred, gt)),
                     ("center_camera_poses", (pred[:, :3, :4],)),
                     ("parse_raw_camera", (pred,))):
        np.testing.assert_allclose(getattr(tpa, fn)(*args),
                                   getattr(jpa, fn)(*args), rtol=1e-6,
                                   atol=1e-6, err_msg=fn)
    np.testing.assert_allclose(
        tpa.rotation_error_deg(pred[:, :3, :3], gt[:, :3, :3]),
        jpa.rotation_error_deg(pred[:, :3, :3], gt[:, :3, :3]), rtol=1e-6)
    et, ej = (m.evaluate_camera_alignment(pred, gt) for m in (tpa, jpa))
    for k in ("rotation_deg", "translation"):
        np.testing.assert_allclose(et[k], ej[k], rtol=1e-6)
    data = np.concatenate([rng.standard_normal((n, 15)),
                           rng.random((n, 2)) + 0.1], 1).astype(np.float32)
    np.save(tmp_path / "poses_bounds.npy", data)
    out_t = tpa.parse_cameras_and_bounds(str(tmp_path), scale=0.25)
    out_j = jpa.parse_cameras_and_bounds(str(tmp_path), scale=0.25)
    for a, b in zip(out_t, out_j):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)

    se3 = (rng.standard_normal((n, 6)) * 0.02).astype(np.float32)
    noise = pred[:, :3, :4]
    scene = SimpleNamespace(poses=gt, poses_gt=None)
    fake_j = SimpleNamespace(train_scene=scene, state=SimpleNamespace(
        pose_params=jnp.asarray(se3), pose_noise=jnp.asarray(noise)))
    pose_t, noise_t = pose_from_jax(se3, noise, device="cpu")
    fake_t = SimpleNamespace(train_scene=scene, state=SimpleNamespace(
        pose_params=pose_t, pose_noise=noise_t))
    np.testing.assert_allclose(tpa.refined_poses(fake_t),
                               jpa.refined_poses(fake_j), rtol=0, atol=1e-6)
    et = tpa.analyze_pose_optimization(fake_t)
    ej = jpa.analyze_pose_optimization(fake_j)
    for k in ("rotation_deg", "translation"):
        np.testing.assert_allclose(et[k], ej[k], rtol=1e-5)
