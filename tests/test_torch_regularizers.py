"""Parity of the port's regularizers and unfused encoder with the JAX
package's, on the CPU: ``entropy_loss``, ``weight_decay_loss`` and
``total_variation_loss`` (at the points JAX draws), the unfused encoder
``ops/hashgrid.hash_encode`` (forward, table and input gradients,
``max_level``), ``freq_encode`` and ``get_encoder``, the encode's input
gradient differentiated in its cotangent (``encode_input_jvp_plain``, the
plain version of the JVP kernel, and ``frozen_input_grad``), the
orientation loss and its second-order gradients through the fused encoder
(f32 and bf16) and the unfused one, one regularised ``-O`` train step and
one ``-O2`` step on the unfused encoder.

Both packages get the same numpy inputs made from seeds. The JAX side is
jitted with XLA's optimizations off (``jax_disable_most_optimizations``,
as tests/test_torch_march.py does) and B2 interpreted; where bf16
arithmetic is compared also with ``xla_allow_excess_precision`` off
(:func:`_jit_exact`): by default jitted XLA on the CPU drops bf16
round trips inside a fusion (the fused encoder's bf16 forward then
differs from eager JAX's in 8.5% of the entries by a bf16 ulp), and the
port takes eager JAX's rounding bit for bit. Each test states its
tolerance and the measured error.
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
from raw_ngp_torch.convert import field_from_jax
from raw_ngp_torch.data import make_synthetic_scene
from raw_ngp_torch.kernels import hash_encode as th
from raw_ngp_torch.models.ngp import make_field_spec as t_make_spec
from raw_ngp_torch.ops import encoding as tenc
from raw_ngp_torch.ops import freq as tfreq
from raw_ngp_torch.ops import hashgrid as thg
from raw_ngp_torch.render import occupancy as tocc
from raw_ngp_torch.train import losses as tlosses
from raw_ngp_torch.train import trainer as ttr
from raw_ngp_torch.train.state import TrainState
from raw_ngp_tpu.kernels import hash_fused as hf
from raw_ngp_tpu.models.ngp import field_density
from raw_ngp_tpu.models.ngp import init_field as j_init_field
from raw_ngp_tpu.models.ngp import make_field_spec as j_make_spec
from raw_ngp_tpu.ops import encoding as jenc
from raw_ngp_tpu.ops import freq as jfreq
from raw_ngp_tpu.ops import hashgrid as jhg
from raw_ngp_tpu.render import occupancy as jocc
from raw_ngp_tpu.train import losses as jlosses
from raw_ngp_tpu.train import trainer as jtr

from test_torch_march import BOUND, _bitfield, _rays, o_cfg
from test_torch_march import _params as _params_o
from test_torch_proposal import _leaves, o2_cfg
from test_torch_proposal import _params as o2_params
from test_torch_proposal import _rays as o2_rays


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
    numbers from one compile."""
    return _reference(lambda: jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})(*args))


def _np(t):
    return t.detach().cpu().numpy()


def _rel_err(got, want):
    """max |got - want| / max |want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _jnp(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


# ------------------------------------------------------------ the losses

def test_entropy_loss_matches_jax():
    """entropy_loss of 512 opacities in [0, 1] (the clip bounds and 0 and
    1 among them): value and gradient against JAX's, f32; log2 and sums in
    other orders: rtol 1e-5 (measured: the value equal, the gradient
    8.2e-8)."""
    w = np.random.default_rng(0).uniform(0, 1, 512).astype(np.float32)
    w[:4] = (0.0, 1.0, 1e-5, np.float32(1.0 - 1e-5))
    lj, gj = jax.jit(jax.value_and_grad(jlosses.entropy_loss))(
        jnp.asarray(w))
    wt = torch.from_numpy(w).requires_grad_()
    lt = tlosses.entropy_loss(wt)
    lt.backward()
    np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=1e-5)
    assert _rel_err(_np(wt.grad), gj) <= 1e-5


@pytest.fixture(scope="module")
def small_spec():
    """(JAX spec, port spec, a table N(0, 0.1^2)) of tests/test_hashgrid.py's
    small grid (4 levels x 2, log2 12, finest 128: dense and hashed
    levels)."""
    kw = dict(input_dim=3, num_levels=4, level_dim=2, base_resolution=16,
              log2_hashmap_size=12, desired_resolution=128)
    js, ts = jhg.HashGridSpec.create(**kw), thg.HashGridSpec.create(**kw)
    table = (0.1 * np.random.default_rng(1).standard_normal(
        ts.n_params * ts.level_dim)).astype(np.float32)
    return js, ts, table


def test_weight_decay_loss_matches_jax(small_spec):
    """weight_decay_loss: value and table gradient against JAX's, and each
    level's gradient is emb / n_params_l (tests/test_hashgrid.py). Sums in
    other orders: rtol 1e-5 (measured at most 9.5e-8)."""
    js, ts, table = small_spec
    lj, gj = jax.jit(jax.value_and_grad(
        lambda p: jhg.weight_decay_loss(p, js)))(jnp.asarray(table))
    pt = torch.from_numpy(table).requires_grad_()
    lt = thg.weight_decay_loss(pt, ts)
    lt.backward()
    np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=1e-5)
    np.testing.assert_allclose(_np(pt.grad), np.asarray(gj), rtol=1e-5)
    C = ts.level_dim
    for lv in range(ts.num_levels):
        lo, hi = ts.offsets[lv], ts.offsets[lv + 1]
        np.testing.assert_allclose(_np(pt.grad)[lo * C:hi * C],
                                   table[lo * C:hi * C] / (hi - lo),
                                   rtol=1e-5)


def test_total_variation_matches_jax_at_its_points(small_spec):
    """total_variation_at, at the 4,096 points jax.random.uniform draws for
    total_variation_loss's key: value and table gradient against JAX's
    (the gathers' backward sums repeated rows, in another order): rtol
    1e-5 (measured: the value equal, the gradient 8.0e-8 of its largest
    entry). total_variation_loss draws its points from a generator and,
    without one (JAX's deterministic mode fails there too), raises
    ValueError."""
    js, ts, table = small_spec
    key, n = jax.random.PRNGKey(7), 4096
    lj, gj = jax.jit(jax.value_and_grad(
        lambda p: jhg.total_variation_loss(p, js, key, n_samples=n)))(
        jnp.asarray(table))
    x01 = torch.from_numpy(np.asarray(jax.random.uniform(key, (n, 3))))
    pt = torch.from_numpy(table).requires_grad_()
    lt = thg.total_variation_at(pt, ts, x01)
    lt.backward()
    np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=1e-5)
    assert _rel_err(_np(pt.grad), gj) <= 1e-5
    gen = torch.Generator().manual_seed(0)
    tv = thg.total_variation_loss(pt, ts, gen, n_samples=512)
    assert np.isfinite(float(tv.detach())) and float(tv.detach()) > 0
    with pytest.raises(ValueError):
        thg.total_variation_loss(pt, ts, None)


# ------------------------------------------------------------ the unfused encoder

_UNFUSED = {
    "dense_and_hashed": dict(num_levels=4, level_dim=2, base_resolution=16,
                             log2_hashmap_size=12, desired_resolution=128),
    "hash_overflow": dict(num_levels=3, level_dim=2, base_resolution=16,
                          log2_hashmap_size=5, desired_resolution=64),
    "additive_c4": dict(num_levels=4, level_dim=4, log2_hashmap_size=10,
                        desired_resolution=256, hash_variant="additive"),
    "tiled_align_smoothstep": dict(num_levels=3, level_dim=2,
                                   log2_hashmap_size=10,
                                   desired_resolution=64, gridtype="tiled",
                                   align_corners=True,
                                   interpolation="smoothstep"),
}


@pytest.mark.parametrize("max_level", [None, 2])
@pytest.mark.parametrize("name", sorted(_UNFUSED))
def test_unfused_encoder_matches_jax(name, max_level):
    """ops/hashgrid.hash_encode (the unfused encoder) of 256 world points
    in [-2, 2]^3 (bound 2; 4 outside it, 2 with a NaN, 2 on clip ties of
    the finest level) against JAX's hash_encode: the features, the table
    gradient and the input gradient for a seeded cotangent, with
    ``max_level`` None and 2 (the levels from it give zeros and no
    gradient). f32, sums in other orders: within 1e-5 of each one's
    largest entry (measured at most 1.8e-6, the C = 4 features); points
    outside [0, 1]^3 and NaN give zero features and zero gradients."""
    kw = _UNFUSED[name]
    js, ts = jhg.HashGridSpec.create(**kw), thg.HashGridSpec.create(**kw)
    rng = np.random.default_rng(3)
    B, C = 256, ts.level_dim
    x = rng.uniform(-2.0, 2.0, (B, 3)).astype(np.float32)
    x[:4] = (2.5, 0.0, 0.0)
    x[4:6, 1] = np.nan
    res = ts.resolutions[-1]
    # x01 * res - 0.5 == 0 and == res - 1 (exact in f32): clip ties
    x[6:8, 0] = (np.float32(0.5 / res) * 4.0 - 2.0,
                 np.float32((res - 0.5) / res) * 4.0 - 2.0)
    table = (0.1 * rng.standard_normal(ts.n_params * C)).astype(np.float32)
    cot = rng.standard_normal((B, ts.output_dim)).astype(np.float32)

    def f(p, xx):
        out = jhg.hash_encode(p, xx, js, bound=2.0, max_level=max_level)
        return (out * cot).sum(), out

    (_, out_j), (g_tab, g_x) = _reference(lambda: jax.jit(jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True))(jnp.asarray(table),
                                          jnp.asarray(x)))
    pt = torch.from_numpy(table).requires_grad_()
    xt = torch.from_numpy(x).requires_grad_()
    out_t = thg.hash_encode(pt, xt, ts, bound=2.0, max_level=max_level)
    (out_t * torch.from_numpy(cot)).sum().backward()
    assert out_t.dtype == torch.float32
    assert (_np(out_t)[:6] == 0).all() and (_np(xt.grad)[:6] == 0).all()
    for got, want in ((out_t, out_j), (pt.grad, g_tab), (xt.grad, g_x)):
        want = np.asarray(want)
        assert np.isfinite(_np(got)).all() and np.abs(want).max() > 0
        assert _rel_err(_np(got), want) <= 1e-5, _rel_err(_np(got), want)
    if max_level is not None:
        assert (_np(out_t)[:, max_level * C:] == 0).all()


def test_freq_encode_matches_jax():
    """freq_encode at degrees 3 and 12, with and without the input, against
    JAX's: the layout ([x, sin..., cos...] per dim) and the values within
    1e-6 (sin and cos of the same f32 products; measured 1.2e-7)."""
    x = np.random.default_rng(0).uniform(-2, 2, (64, 3)).astype(np.float32)
    for degree in (3, 12):
        for include in (True, False):
            want = np.asarray(jfreq.freq_encode(jnp.asarray(x), degree,
                                                include))
            got = _np(tfreq.freq_encode(torch.from_numpy(x), degree, include))
            assert got.shape == want.shape == (
                64, tfreq.freq_output_dim(3, degree, include))
            assert tfreq.freq_output_dim(3, degree, include) == \
                jfreq.freq_output_dim(3, degree, include)
            np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_get_encoder_matches_jax():
    """get_encoder by name (tests/test_tools.py): the identity, frequency,
    SH, hash and tiled grids give JAX's output widths; the stateless ones
    JAX's values (within 1e-6; measured 1.2e-7), the grids the values of
    JAX's hash_encode on the port's table (within 1e-5 of the largest;
    measured 1.1e-7); an unknown name raises ValueError."""
    x = np.random.default_rng(0).uniform(-1, 1, (5, 3)).astype(np.float32)
    d = x / np.linalg.norm(x, axis=-1, keepdims=True)
    for name, kw, inp in ((None, {}, x), ("none", {}, x),
                          ("frequency", dict(freq_degree=6), x),
                          ("frequency_torch", dict(freq_degree=6), x),
                          ("sh", dict(degree=4), d)):
        enc_j, dim_j, _ = jenc.get_encoder(name, input_dim=3, **kw)
        enc_t, dim_t, state = tenc.get_encoder(name, input_dim=3, **kw)
        assert dim_t == dim_j and state is None
        np.testing.assert_allclose(_np(enc_t(torch.from_numpy(inp))),
                                   np.asarray(enc_j(jnp.asarray(inp))),
                                   atol=1e-6, rtol=0)
    for name in ("hashgrid", "tiledgrid"):
        kw = dict(num_levels=4, log2_hashmap_size=10, desired_resolution=64)
        _, dim_j, (js, _) = jenc.get_encoder(name, key=jax.random.PRNGKey(0),
                                             **kw)
        enc_t, dim_t, (ts, table) = tenc.get_encoder(
            name, generator=torch.Generator().manual_seed(0), device="cpu",
            **kw)
        assert dim_t == dim_j == 8 and table.shape == (ts.n_params * 2,)
        assert ts.gridtype == js.gridtype
        got = _np(enc_t(torch.from_numpy(x), bound=1.0))
        want = np.asarray(jhg.hash_encode(jnp.asarray(_np(table)),
                                          jnp.asarray(x), js, bound=1.0))
        assert got.shape == (5, 8) and _rel_err(got, want) <= 1e-5
    with pytest.raises(ValueError):
        tenc.get_encoder("bogus")


# ------------------------------------------------------------ the JVP

_JVP_SPECS = {
    "xor_windows": dict(num_levels=4, level_dim=2, log2_hashmap_size=12,
                        desired_resolution=128, hash_variant="xor"),
    "dense_additive": dict(num_levels=2, level_dim=16, log2_hashmap_size=14,
                           base_resolution=16, desired_resolution=64,
                           hash_variant="additive"),
}


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("name", sorted(_JVP_SPECS))
def test_input_grad_jvp_matches_jax(name, dtype):
    """encode_input_jvp_plain (the JVP kernel's plain version) against
    JAX's input gradient of hash_encode_fused (``_fused_bwd``, the table
    frozen) differentiated in g with jax.vjp, for 300 points (2 outside
    [0, 1]^3) and seeded g and ct_x, on a grid of window levels (xor) and
    one with a dense matmul level (additive, C = 16). The port rounds
    where XLA's
    transpose rounds: bf16 bit for bit (measured), f32 window levels bit
    for bit and the dense level's sums in another order, within 1e-6 of
    the largest entry (measured 3.1e-8). In f32 also equal, within 1e-6
    (measured 1.2e-7), to torch.autograd's transpose of
    encode_input_grad_plain; frozen_input_grad's backward is the plain
    version bit for bit, and gives the table and the points no gradient."""
    kw = _JVP_SPECS[name]
    js, ts = jhg.HashGridSpec.create(**kw), thg.HashGridSpec.create(**kw)
    assert hf._matmul_split(js) == th.matmul_split(ts)
    bf16 = dtype == "bf16"
    jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if bf16
                else (jnp.float32, torch.float32))
    rng = np.random.default_rng(1)
    B = 300
    x = rng.uniform(0, 1, (B, 3)).astype(np.float32)
    x[:2] = 1.3
    table = (0.1 * rng.standard_normal(ts.n_params * ts.level_dim)
             ).astype(np.float32)
    g = rng.standard_normal((B, ts.output_dim)).astype(np.float32)
    ct = rng.standard_normal((B, 3)).astype(np.float32)

    def input_grad(gv):
        _, vjp = jax.vjp(lambda xx: hf.hash_encode_fused(
            jnp.asarray(table), xx, js, True, jdt), jnp.asarray(x))
        return vjp(gv)[0]

    def jvp_in_g(gv, c):
        return jax.vjp(input_grad, gv)[1](c)[0].astype(jnp.float32)

    want = np.asarray(_jit_exact(jvp_in_g, jnp.asarray(g).astype(jdt),
                                 jnp.asarray(ct)))
    tt, xt, ctt = (torch.from_numpy(a) for a in (table, x, ct))
    got = th.encode_input_jvp_plain(tt, xt, ctt, ts, tdt)
    assert got.dtype == tdt and (_np(got.float())[:2] == 0).all()
    assert np.abs(want).max() > 0
    if bf16 or th.matmul_split(ts) == 0:
        np.testing.assert_array_equal(_np(got.float()), want)
    else:
        assert _rel_err(_np(got), want) <= 1e-6
    gt = torch.from_numpy(g).to(tdt).requires_grad_()
    pt, xr = tt.clone().requires_grad_(), xt.clone().requires_grad_()
    out = th.frozen_input_grad(pt, xr, gt, ts, tdt, plain=True)
    (back,) = torch.autograd.grad(out, gt, ctt)
    assert torch.equal(back, got) and pt.grad is None and xr.grad is None
    if not bf16:
        gf = torch.from_numpy(g).requires_grad_()
        (ref,) = torch.autograd.grad(
            th.encode_input_grad_plain(tt, xt, gf, ts), gf, ctt)
        assert _rel_err(_np(got), _np(ref)) <= 1e-6


# ------------------------------------------------------------ orientation

def _orient_cfg(mod, fused, fp16):
    """The -O miniature's field (4 levels x 2 xor, log2 12, hidden 16) with
    the orientation loss on."""
    cfg = o_cfg(mod)
    cfg = replace(cfg, model=replace(cfg.model, fused_encoder=fused),
                  train=replace(cfg.train, fp16=fp16,
                                lambda_orientation=0.1))
    return cfg.validate()


# (fused encoder, fp16) of each orientation case
_ORIENT = {"fused_f32": (True, False), "fused_bf16": (True, True),
           "unfused_f32": (False, False)}


@pytest.mark.parametrize("case", sorted(_ORIENT))
def test_orientation_loss_and_second_order_gradients_match_jax(case):
    """The orientation loss of 512 points in [-1.5, 1.5]^3 with seeded unit
    view directions, mean(min(0, n . -d)^2) with n the normalised -grad
    sigma mapped to [0, 1] (render/occupancy.orientation_loss with unit
    weights), on the -O miniature's field with the table drawn U(±0.1):
    the value and the gradient of the grid and the grid MLP against
    JAX's (jax.grad inside the loss), each within its share of the leaf's
    largest entry.
    The MLP gradients are nonzero (largest 0.011-0.022): the second-order
    term reaches them. Through the fused encoder JAX takes the input
    gradient with the table frozen, and the term's path through the
    features cancels under the normalisation, so the table's gradient is
    a rounding residue: in f32 within 1e-6 of the largest gradient entry
    of zero in both packages (measured 8.7e-11 and 1.3e-10 against
    0.022); in bf16 the residue is larger (5.75e-6 and 5.78e-6) and held
    to JAX's within 2e-2 of the largest gradient entry (measured 3.6e-8
    apart). Through the unfused encoder the full second-order term gives
    the table a gradient larger than the MLPs' (0.039) that matches
    JAX's.
    Tolerances: f32 loss rtol 1e-5 and leaves 1e-5 of their largest
    entry (measured: loss 1.8e-7, leaves 7.6e-7 fused, 9.3e-7 unfused);
    bf16 loss rtol 1e-3 and leaves 2e-2 (measured: loss equal, MLPs
    2.8e-3)."""
    fused, fp16 = _ORIENT[case]
    jc, tc = _orient_cfg(jcfg, fused, fp16), _orient_cfg(tcfg, fused, fp16)
    jspec = j_make_spec(jc)
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map(
        np.asarray, j_init_field(jax.random.PRNGKey(0), jspec))
    params["grid"] = rng.uniform(-0.1, 0.1, params["grid"].shape
                                 ).astype(np.float32)
    n = 512
    x = rng.uniform(-1.5, 1.5, (n, 3)).astype(np.float32)
    d = rng.standard_normal((n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)

    def orient(p, x, d):
        g = jax.grad(lambda pts: field_density(p, jspec, pts).sum())(
            jax.lax.stop_gradient(x))
        nrm = -g / (jnp.linalg.norm(g, axis=-1, keepdims=True) + 1e-9)
        ndv = ((nrm + 1.0) / 2.0 * -d).sum(-1)
        return jnp.mean(jnp.minimum(0.0, ndv) ** 2)

    lj, gj = _jit_exact(jax.value_and_grad(orient), _jnp(params),
                        jnp.asarray(x), jnp.asarray(d))
    field = field_from_jax(params, t_make_spec(tc), device="cpu")
    lt = tocc.orientation_loss(field, torch.from_numpy(x),
                               torch.from_numpy(d), torch.ones(n, 1))
    lt.backward()
    loss_rtol, tol = (1e-3, 2e-2) if fp16 else (1e-5, 1e-5)
    np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=loss_rtol)
    mlp = [(w, np.asarray(gj["grid_mlp"][i]["w"]))
           for i, w in enumerate(field.grid_mlp)]
    top = max(np.abs(g).max() for _, g in mlp)
    assert top > 1e-2
    for w, want in mlp:
        assert np.abs(want).max() > 0
        assert _rel_err(_np(w.grad), want) <= tol
    assert all(w.grad is None for w in field.view_mlp)
    g_tab, want = _np(field.grid.grad), np.asarray(gj["grid"])
    if not fused:
        assert np.abs(want).max() > 0.5 * top
        assert _rel_err(g_tab, want) <= tol
    elif not fp16:
        assert np.abs(g_tab).max() <= 1e-6 * top
        assert np.abs(want).max() <= 1e-6 * top
    else:
        assert np.abs(g_tab - want).max() <= tol * top


# ------------------------------------------------------------ train steps

def _o_reg_cfg(mod):
    """The -O miniature (f32, 256 rays, S = 4K = 56) with all four
    regularizers on, at weights that make each term visible."""
    cfg = o_cfg(mod)
    return replace(cfg, train=replace(
        cfg.train, lambda_orientation=0.1, lambda_wd=0.1,
        lambda_entropy=1e-2, lambda_tv=1e-2)).validate()


def test_regularised_o_train_step_matches_jax():
    """One -O train step's objective with the orientation, entropy, TV and
    weight-decay terms on a fixed batch of 256 rays (4 misses; key=None):
    make_batch_loss_fn's loss and the gradient of every leaf against
    JAX's value_and_grad (jitted, optimizations off, B2 interpreted), f32.
    The port renders JAX's march (captured), takes the expand path with
    the fold's positions, and both packages' TV terms take the 4,096
    points jax.random.uniform draws for one key (each TV function
    wrapped). 14 dead slots of this batch sit on corners of the bound
    box, where JAX's gradient is NaN and the port's is not
    (test_orientation_gradient_at_a_zero_density_gradient): the port is
    held to JAX's step with jnp.linalg.norm's gradient at 0 taken as 0.
    The same tolerances as tests/test_torch_march.py's step:
    loss rtol 1e-5, the MLPs within 5e-4 and the table within 5e-3 of
    their largest entry (B2 rounds each w * g product to bf16 in both;
    measured 6.8e-8 on the loss, 3.8e-6 on the MLPs, 2.4e-7 on the
    table); the orientation term checked nonzero."""
    jc, tc = _o_reg_cfg(jcfg), _o_reg_cfg(tcfg)
    params = _params_o(jc)
    bits = _bitfield()
    o, d = _rays(256)
    rgb = np.random.default_rng(6).uniform(0, 1, (256, 3)).astype(np.float32)
    aabb = np.array([-BOUND] * 3 + [BOUND] * 3, np.float32)
    tv_key, n_tv = jax.random.PRNGKey(3), 4096
    tv_points = np.asarray(jax.random.uniform(tv_key, (n_tv, 3)))
    loss_j = jtr.make_batch_loss_fn(jc, j_make_spec(jc))
    state_j = SimpleNamespace(density_bitfield=jnp.asarray(bits))
    batch = {"rays_o": o, "rays_d": d, "images": rgb}
    march, march_j, tv_j = {}, jocc.march_rays, jtr.total_variation_loss
    parts = {}

    def j_march(*args, **kwargs):
        m = march_j(*args, **kwargs)
        jax.debug.callback(lambda *a: march.update(
            (k, torch.from_numpy(np.array(v))) for k, v in zip(m, a)),
            *m.values())
        return m

    def render_any_t(*args, **kwargs):
        out = render_any(*args, **kwargs)
        parts["orientation_loss"] = out["orientation_loss"]
        return out

    render_any = ttr.render_any

    def j_loss(p, b):
        return loss_j(p, state_j, b, jnp.asarray(aabb), None, 1.0, True)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jocc, "march_rays", j_march)
        mp.setattr(jtr, "total_variation_loss",
                   lambda p, s, key: tv_j(p, s, tv_key, n_samples=n_tv))
        mp.setattr(jnp.linalg, "norm", _safe_norm_jax)
        (lj, _), g_j = _reference(lambda: jax.block_until_ready(
            jax.jit(jax.value_and_grad(j_loss, has_aux=True))(
                _jnp(params), {k: jnp.asarray(v) for k, v in batch.items()})))
        mp.undo()
        mp.setattr(tocc, "march_rays", lambda *a, **k: march)
        mp.setattr(ttr, "total_variation_loss",
                   lambda p, s, gen: thg.total_variation_at(
                       p, s, torch.from_numpy(tv_points)))
        mp.setattr(ttr, "render_any", render_any_t)
        field = field_from_jax(params, t_make_spec(tc), device="cpu")
        state = TrainState(params={}, opt_state=None, ema_params={}, step=0,
                           density_bitfield=torch.from_numpy(bits))
        lt, aux_t = ttr.make_batch_loss_fn(tc, t_make_spec(tc))(
            field, state, {k: torch.from_numpy(v) for k, v in batch.items()},
            torch.from_numpy(aabb))
    assert int(aux_t["num_points"]) > 0
    assert float(parts["orientation_loss"].detach()) > 0
    np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=1e-5)
    lt.backward()
    leaves = [("grid", field.grid, g_j["grid"], 5e-3)]
    leaves += [(f"grid_mlp.{i}", w, g_j["grid_mlp"][i]["w"], 5e-4)
               for i, w in enumerate(field.grid_mlp)]
    leaves += [(f"view_mlp.{i}", w, g_j["view_mlp"][i]["w"], 5e-4)
               for i, w in enumerate(field.view_mlp)]
    for name, p, gj, tol in leaves:
        gj = np.asarray(gj, np.float32).reshape(p.shape)
        assert np.abs(gj).max() > 0, name
        assert _rel_err(_np(p.grad), gj) <= tol, (name, _rel_err(
            _np(p.grad), gj))


def test_orientation_gradient_at_a_zero_density_gradient():
    """Where the density's gradient is exactly 0 (a point at a corner of the
    bound box, beyond every level's last half cell on all three axes; the
    march's dead slots land there), JAX's orientation-loss gradient is NaN
    in the grid and the grid MLP even at zero weight: jnp.linalg.norm's
    sqrt differentiates to 0 * inf. The port's is finite there
    (render/occupancy._safe_norm): its grid MLP gradients equal JAX's with
    that point's norm's gradient taken as 0, within 1e-5 of each leaf's
    largest entry (measured 5.1e-7), and the fused table's stay a residue
    within 1e-6 of the largest MLP entry in both."""
    jc, tc = _orient_cfg(jcfg, True, False), _orient_cfg(tcfg, True, False)
    jspec = j_make_spec(jc)
    params = _params_o(jc)
    x = np.array([[2.0, 2.0, 2.0], [0.3, -0.2, 0.1], [-0.7, 0.5, 0.9]],
                 np.float32)
    d = np.array([[0.0, 0.0, 1.0], [0.6, 0.0, 0.8], [0.0, -1.0, 0.0]],
                 np.float32)
    w = np.array([[0.0], [0.7], [0.4]], np.float32)

    def orient(p, norm):
        g = jax.grad(lambda pts: field_density(p, jspec, pts).sum())(
            jnp.asarray(x))
        nrm = -g / (norm(g, axis=-1, keepdims=True) + 1e-9)
        ndv = ((nrm + 1.0) / 2.0 * -jnp.asarray(d)).sum(-1)
        return jnp.mean(jnp.asarray(w)[:, 0] * jnp.minimum(0.0, ndv) ** 2)

    raw, safe = _reference(lambda: jax.jit(lambda p: (
        jax.grad(lambda q: orient(q, jnp.linalg.norm))(p),
        jax.grad(lambda q: orient(q, _safe_norm_jax))(p)))(_jnp(params)))
    assert np.isnan(np.asarray(raw["grid"])).any()
    assert all(np.isnan(np.asarray(l["w"])).any() for l in raw["grid_mlp"])
    field = field_from_jax(params, t_make_spec(tc), device="cpu")
    assert float(field.density_grad(torch.from_numpy(x[:1])).abs().max()) == 0
    tocc.orientation_loss(field, torch.from_numpy(x), torch.from_numpy(d),
                          torch.from_numpy(w)).backward()
    top = max(np.abs(np.asarray(l["w"])).max() for l in safe["grid_mlp"])
    for wt, want in zip(field.grid_mlp, safe["grid_mlp"]):
        assert np.isfinite(_np(wt.grad)).all()
        assert _rel_err(_np(wt.grad), want["w"]) <= 1e-5
    # the fused table's term cancels to a rounding residue in both
    assert np.isfinite(_np(field.grid.grad)).all()
    assert np.abs(_np(field.grid.grad)).max() <= 1e-6 * top
    assert np.abs(np.asarray(safe["grid"])).max() <= 1e-6 * top


def _safe_norm_jax(x, ord=None, axis=None, keepdims=False):
    """jnp.linalg.norm's 2-norm with the gradient 0 at x = 0
    (render/occupancy._safe_norm written in JAX)."""
    assert ord is None
    n2 = jnp.sum(x * x, axis=axis, keepdims=keepdims)
    pos = n2 > 0
    return jnp.where(pos, jnp.sqrt(jnp.where(pos, n2, 1.0)), 0.0)


def test_unfused_proposal_train_step_matches_jax():
    """One -O2 train step on the unfused encoder (the miniature of
    tests/test_torch_proposal.py, f32, contraction, the radiance grid and
    both proposal grids through the plain encode) with the entropy and
    weight-decay terms, on an explicit batch of 256 rays (4 miss; key=None):
    the loss and the gradient of every leaf against JAX's (jitted,
    optimizations off). No B2 on either side: the gathers' backward sums
    in another order. Loss rtol 1e-5, the MLPs within 5e-4, the tables
    within 5e-3 of their largest entry (tests/test_torch_proposal.py's
    bounds; measured 1.6e-7, 5.0e-5 and 6.4e-5)."""
    def cfg_of(mod):
        cfg = o2_cfg(mod, lambda_entropy=1e-2, lambda_wd=0.1)
        return replace(cfg, model=replace(cfg.model, fused_encoder=False)
                       ).validate()

    jc, tc = cfg_of(jcfg), cfg_of(tcfg)
    params = o2_params(jc)
    rng = np.random.default_rng(5)
    o, d = o2_rays(rng, 256)
    batch = {"rays_o": o, "rays_d": d,
             "images": rng.uniform(0.0, 1.0, (256, 3)).astype(np.float32)}
    b = jc.render.bound
    aabb = np.array([-b] * 3 + [b] * 3, np.float32)
    loss_j = jtr.make_batch_loss_fn(jc, j_make_spec(jc))
    (lj, _), g_j = _reference(lambda: jax.jit(jax.value_and_grad(
        lambda p, bb: loss_j(p, None, bb, jnp.asarray(aabb), None, 1.0,
                             True), has_aux=True))(
        _jnp(params), {k: jnp.asarray(v) for k, v in batch.items()}))
    field = field_from_jax(params, t_make_spec(tc), device="cpu")
    state = TrainState(params={}, opt_state=None, ema_params={}, step=0)
    lt, _ = ttr.make_batch_loss_fn(tc, t_make_spec(tc))(
        field, state, {k: torch.from_numpy(v) for k, v in batch.items()},
        torch.from_numpy(aabb))
    np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=1e-5)
    lt.backward()
    for name, p, gj in _leaves(field, g_j):
        gj = np.asarray(gj, np.float32).reshape(p.shape)
        assert np.abs(gj).max() > 0, name
        err = _rel_err(_np(p.grad), gj)
        table = name in ("grid", "prop_grids.0", "prop_grids.1")
        assert err <= (5e-3 if table else 5e-4), (name, err)


@pytest.mark.parametrize("fused", [True, False])
def test_regularised_o_trainer_trains_on_cpu(fused, tmp_path):
    """A CPU Trainer on the -O miniature in bf16 (as the preset computes)
    with all four regularizers, on the fused and the unfused encoder: 6
    finite steps with a falling loss, the orientation term through the
    expand path, a finite PSNR and a normal map of the unfused field."""
    cfg = _o_reg_cfg(tcfg)
    cfg = replace(cfg, model=replace(cfg.model, fused_encoder=fused),
                  render=replace(cfg.render, compute_normals=True),
                  train=replace(cfg.train, fp16=True, iters=6)).validate()
    train, val = make_synthetic_scene(n_train=4, n_val=1, H=16, W=16,
                                      seed=0)
    tr = ttr.Trainer(cfg, train, val, device="cpu", workspace=str(tmp_path))
    losses = [float(tr.step()["loss"]) for _ in range(6)]
    assert np.isfinite(losses).all() and min(losses[3:]) < losses[0]
    assert all(bool(torch.isfinite(p).all()) for p in tr.field.parameters())
    rgb, _, nm = tr.render_image(val.poses[0], return_normals=True)
    assert np.isfinite(rgb).all() and np.isfinite(nm).all()
    assert np.isfinite(tr.evaluate()["psnr"])
