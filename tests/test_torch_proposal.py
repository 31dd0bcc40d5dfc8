"""Parity of the port's proposal path (the ``-O2`` preset: raw_ngp_torch's
contraction, ``bins_to_weights``, PDF resampling, the proposal and
distortion losses, the proposal networks, ``render_proposal``, the batch
loss, the proposal gradient gate and the Trainer) with the JAX package's,
on the CPU.

The configuration is the miniature of tests/test_model_render.py
(``tiny_config``) on the ``-O2`` preset: 4 levels, log2 12; 3 proposal
levels, log2 10, resolutions 32 and 64; ``num_steps`` (32, 16, 8); the
fused encoder, so the port's plain encode meets JAX's fused one. Both
packages get the same numpy inputs, made from a seed: parameters from the
JAX init with the hash tables redrawn N(0, 0.3^2) (so the densities vary
along a ray), carried across by raw_ngp_torch.convert, and the same rays.
Only the deterministic paths run (``key=None`` / ``generator=None``).
JAX's table gradient runs its Pallas segment-totals kernel in interpret
mode (``segsum_pallas.FORCE_INTERPRET``, set back in a ``finally``). The
JAX side is jitted with XLA's optimizations off
(``jax_disable_most_optimizations``, set back in the same ``finally``;
sample_pdf and jnp.linspace run eagerly): one compile a case, where eager
JAX compiles each op of three encoders apart and takes about a minute,
with eager JAX's numbers (measured: the render within 1.2e-8 of eager
JAX on the image, 1.1e-6 on the weights). With the
optimizations on, jitted CPU XLA fuses the encode's position math in
other ways (tests/test_torch_render.py says why that matters) and moved
a weight by 1.4e-2. Each test states its tolerance and the reason for
it.
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
from raw_ngp_torch.data.sampler import sample_ray_batch as t_sample
from raw_ngp_torch.models.ngp import init_field as t_init_field
from raw_ngp_torch.models.ngp import make_field_spec as t_make_spec
from raw_ngp_torch.ops import compositing as tcomp
from raw_ngp_torch.ops import contraction as tcon
from raw_ngp_torch.ops import pdf as tpdf
from raw_ngp_torch.render import proposal as tprop
from raw_ngp_torch.train import trainer as ttr
from raw_ngp_torch.train.state import TrainState
from raw_ngp_tpu.models.ngp import field_density as j_field_density
from raw_ngp_tpu.models.ngp import init_field as j_init_field
from raw_ngp_tpu.models.ngp import make_field_spec as j_make_spec
from raw_ngp_tpu.ops import compositing as jcomp
from raw_ngp_tpu.ops import contraction as jcon
from raw_ngp_tpu.ops import pdf as jpdf
from raw_ngp_tpu.render import proposal as jprop
from raw_ngp_tpu.train import trainer as jtr


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's torch work, set back after
    it. Under pytest-xdist several test processes share the cores, and
    torch's default of one thread a core then oversubscribes them: the
    many small ops of a CPU Trainer step slow some 40-fold (measured: a
    Trainer test 4 s alone, 195 s beside five other workers), where one
    thread costs about 10% alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def o2_cfg(mod, fp16=False, contract=True, rfield=False, lambda_distort=0.0,
           **train_kw):
    """The miniature of tests/test_model_render.py on the -O2 preset, from
    either package's config module."""
    cfg = mod.Config().with_preset_O2()
    cfg = replace(cfg, model=replace(
        cfg.model, num_levels=4, log2_hashmap_size=12,
        hashgrid_resolution=64, grid_mlp_hidden=16, view_mlp_hidden=16,
        prop_num_levels=3, prop_log2_hashmap_size=10,
        prop_resolutions=(32, 64), fused_encoder=True, rfield=rfield))
    cfg = replace(cfg, render=replace(cfg.render, num_steps=(32, 16, 8),
                                      contract=contract,
                                      max_ray_batch=1024))
    cfg = replace(cfg, train=replace(cfg.train, fp16=fp16, num_rays=256,
                                     seed=0, lambda_distort=lambda_distort,
                                     **train_kw))
    return replace(cfg, ckpt="scratch").validate()


def _reference(fn):
    """fn() with JAX's B2 interpreted and XLA's optimizations off."""
    sp.FORCE_INTERPRET = True
    jax.config.update("jax_disable_most_optimizations", True)
    try:
        return fn()
    finally:
        sp.FORCE_INTERPRET = False
        jax.config.update("jax_disable_most_optimizations", False)


def _np(t):
    return t.detach().cpu().numpy()


def _rel_err(got, want):
    """max |got - want| / max |want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _rays(rng, n, n_miss=4):
    """Rays from a sphere of radius 3 toward points near the centre; the
    first ``n_miss`` run parallel to the z axis beside the bound box
    [-2, 2]^3 and miss it."""
    c = rng.standard_normal((n, 3))
    o = (3.0 * c / np.linalg.norm(c, axis=-1, keepdims=True))
    d = rng.uniform(-0.5, 0.5, (n, 3)) - o
    o[:n_miss], d[:n_miss] = (3.0, 3.0, 0.0), (0.0, 0.0, 1.0)
    return o.astype(np.float32), d.astype(np.float32)


def _params(jc, seed=0):
    """JAX init of the field, hash tables redrawn N(0, 0.3^2) -> numpy."""
    params = jax.tree_util.tree_map(
        np.asarray, j_init_field(jax.random.PRNGKey(seed), j_make_spec(jc)))
    rng = np.random.default_rng(seed + 10)
    params["grid"] = (0.3 * rng.standard_normal(params["grid"].shape)
                      ).astype(np.float32)
    params["prop_grids"] = [(0.3 * rng.standard_normal(g.shape)
                             ).astype(np.float32)
                            for g in params["prop_grids"]]
    return params


def _leaves(field, g_j):
    """[(name, port parameter, JAX gradient)] of every leaf."""
    out = [("grid", field.grid, g_j["grid"])]
    out += [(f"grid_mlp.{i}", w, g_j["grid_mlp"][i]["w"])
            for i, w in enumerate(field.grid_mlp)]
    out += [(f"view_mlp.{i}", w, g_j["view_mlp"][i]["w"])
            for i, w in enumerate(field.view_mlp)]
    for i, table in enumerate(field.prop_grids):
        out.append((f"prop_grids.{i}", table, g_j["prop_grids"][i]))
        out += [(f"prop_mlps.{i}.{l}", w, g_j["prop_mlps"][i][l]["w"])
                for l, w in enumerate(field.prop_mlps[i])]
    return out


# ------------------------------------------------------------ small ops

def test_contract_and_uncontract_match_jax():
    """contract on points inside and outside the unit cube, on its faces,
    at the origin and with two and three axes tied at the maximum (each
    tied axis takes the dominant scale; the maximum's gradient splits
    evenly among ties), and uncontract on [-2, 2]^3 with ties: values and
    the gradient of sum(out * cot), f32. Values: the same f32 operations
    in the same order, asserted at 1 ulp (rtol 1.2e-7; measured bit for
    bit). Gradients: autograd adds the contributions of the scale's and
    the maximum's paths in another order than JAX's transpose, within
    1e-6 of the largest entry (measured 4.2e-8)."""
    rng = np.random.default_rng(0)
    x = rng.uniform(-8.0, 8.0, (512, 3)).astype(np.float32)
    x[:64] = rng.uniform(-1.0, 1.0, (64, 3))
    x[64:72] = np.array([[3, 3, 1], [-2, 2, 2], [5, -5, -5], [1, 1, 1],
                         [0, 0, 0], [1, 0.5, -1], [-1.5, 0.2, 1.5],
                         [2, 2, 2]], np.float32)
    z = rng.uniform(-1.99, 1.99, (512, 3)).astype(np.float32)
    z[:4] = np.array([[1.5, 1.5, 0.2], [-1.2, 1.2, 1.2], [1, 1, 1],
                      [0, 0, 0]], np.float32)
    cot = rng.standard_normal((512, 3)).astype(np.float32)
    for jf, tf, inp in ((jcon.contract, tcon.contract, x),
                        (jcon.uncontract, tcon.uncontract, z)):
        want, g_want = _reference(lambda: jax.jit(
            lambda a, c: (jf(a), jax.vjp(jf, a)[1](c)[0]))(
                jnp.asarray(inp), jnp.asarray(cot)))
        xt = torch.from_numpy(inp).requires_grad_()
        got = tf(xt)
        (got * torch.from_numpy(cot)).sum().backward()
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1.2e-7,
                                   atol=0)
        assert _rel_err(_np(xt.grad), g_want) <= 1e-6
    ties = tcon.contract(torch.tensor([[3.0, 3.0, 1.0]]))
    np.testing.assert_allclose(_np(ties), [[5 / 3, 5 / 3, 1 / 3]],
                               rtol=1e-6)


def test_spacing_fns_match_jax():
    """spacing_fn on distances 0.05-100 (both branches, 1 included) and
    spacing_fn_inv on [0, 1), f32: the same operations, bit for bit."""
    x = np.concatenate([np.linspace(0.05, 100.0, 997), [1.0]]
                       ).astype(np.float32)
    s = np.concatenate([np.linspace(0.0, 0.999, 997), [0.5]]
                       ).astype(np.float32)
    for jf, tf, inp in ((jprop.spacing_fn, tprop.spacing_fn, x),
                        (jprop.spacing_fn_inv, tprop.spacing_fn_inv, s)):
        np.testing.assert_array_equal(_np(tf(torch.from_numpy(inp))),
                                      np.asarray(jf(jnp.asarray(inp))))


def test_linspace_within_an_ulp_of_jnp_linspace():
    """The edges and the uniform samples the proposal path builds with
    torch.linspace, at the full -O2 sizes (257, 97, 49) and this
    miniature's (33, 17, 9), f32: within one ulp of eager jnp.linspace
    (measured: up to 48 of 97 entries one ulp apart, none further)."""
    for num in (257, 97, 49, 33, 17, 9):
        for start, stop in ((0.0, 1.0), (0.5 / num, 1.0 - 0.5 / num)):
            want = np.asarray(jnp.linspace(start, stop, num))
            got = _np(torch.linspace(start, stop, num))
            assert got.dtype == np.float32
            assert (np.abs(got - want) <= np.spacing(np.abs(want))).all()


def _sorted_bins(rng, n, t):
    """[n, t + 1] sorted edges in [0, 1] with both ends."""
    inner = np.sort(rng.uniform(0.0, 1.0, (n, t - 1)), axis=-1)
    return np.concatenate([np.zeros((n, 1)), inner, np.ones((n, 1))],
                          -1).astype(np.float32)


@pytest.mark.parametrize("opaque", [False, True])
def test_bins_to_weights_matches_jax(opaque):
    """bins_to_weights on [64, 48] rows of densities spanning 1e-3 to 1e3
    (some rays saturate) over real distances 0.05-20, in both background
    modes (the last sample opaque or not): weights, ts_mid and deltas,
    and the gradient of sum(weights * cot) in the densities, f32. The
    cumulative sum runs in torch.cumsum's order, not JAX's parallel
    prefix: a few ulps of the row's optical depth move exp(-excl) by as
    much: within 2e-6 of the largest entry (measured 6.0e-8 forward,
    7.5e-8 gradient)."""
    rng = np.random.default_rng(1)
    n, t = 64, 48
    sig = np.exp(rng.uniform(np.log(1e-3), np.log(1e3), (n, t))
                 ).astype(np.float32)
    real = (0.05 + 20.0 * _sorted_bins(rng, n, t)).astype(np.float32)
    cot = rng.standard_normal((n, t)).astype(np.float32)
    def jax_side(sig, real, cot):
        (want, mid, delta), vjp = jax.vjp(
            lambda s: jcomp.bins_to_weights(s, real, opaque), sig)
        g = vjp((cot, jnp.zeros_like(mid), jnp.zeros_like(delta)))[0]
        return want, g, mid, delta

    want, g_want, mid_j, delta_j = _reference(lambda: jax.jit(jax_side)(
        jnp.asarray(sig), jnp.asarray(real), jnp.asarray(cot)))
    st = torch.from_numpy(sig).requires_grad_()
    w, mid, delta = tcomp.bins_to_weights(st, torch.from_numpy(real), opaque)
    (w * torch.from_numpy(cot)).sum().backward()
    assert np.isfinite(_np(w)).all() and np.isfinite(_np(st.grad)).all()
    assert _rel_err(_np(w), want) <= 2e-6
    assert _rel_err(_np(st.grad), g_want) <= 2e-6
    np.testing.assert_array_equal(_np(mid), np.asarray(mid_j))
    np.testing.assert_array_equal(_np(delta), np.asarray(delta_j))
    if opaque:   # the last sample takes the remaining transmittance
        np.testing.assert_allclose(_np(w).sum(-1), 1.0, rtol=1e-5)


def test_sample_pdf_matches_jax():
    """sample_pdf of 97 edges from [128, 48] weights (one row all zero,
    one row a single spike, the rest random), deterministic. The CDFs
    (torch.cumsum against JAX's parallel prefix) sit up to a few ulps of
    1 apart (measured 5.96e-7, 10 x 2^-24, on the spike row), and the
    inverse CDF carries that into an edge times its slope, the bin's width
    over its CDF step: up to 200 x the bin width on the spike row's flat
    part. So each edge is held within 32 x 2^-24 x its slope + 1e-7
    (measured: up to 1.05e-4 absolute, 9 x 2^-24 x slope). A
    searchsorted tie that lands one bin over moves nothing more: the
    inverse CDF is continuous there. No gradient flows out."""
    rng = np.random.default_rng(2)
    n, t = 128, 48
    bins = _sorted_bins(rng, n, t)
    w = rng.exponential(1.0, (n, t)).astype(np.float32)
    w[0] = 0.0
    w[1] = 0.0
    w[1, 7] = 50.0
    want = np.asarray(jpdf.sample_pdf(jnp.asarray(bins), jnp.asarray(w), 97))
    wt = torch.from_numpy(w).requires_grad_()
    got = _np(tpdf.sample_pdf(torch.from_numpy(bins), wt, 97))
    assert got.shape == (n, 97) and (np.diff(got, axis=-1) >= 0).all()
    # each edge's slope d(edge)/d(cdf) in the bin the JAX edge lies in
    ww = w.astype(np.float64) + 0.01
    cdf = np.concatenate([np.zeros((n, 1)), np.cumsum(
        ww / ww.sum(-1, keepdims=True), -1)], -1)
    k = np.clip(np.stack([np.searchsorted(bins[r], want[r], side="right")
                          for r in range(n)]), 1, t) - 1
    slope = (np.take_along_axis(np.diff(bins, axis=-1), k, -1)
             / np.take_along_axis(np.diff(cdf, axis=-1), k, -1))
    err = np.abs(got - want)
    assert (err <= 32 * 2.0 ** -24 * slope + 1e-7).all(), (
        err.max(), (err / slope).max() * 2 ** 24)


def test_losses_and_gradients_match_jax():
    """interlevel_loss and proposal_loss (two proposal levels of 32 and 16
    bins against a final level of 8, each on its own sorted edges) and the
    distortion loss: values and gradients in the proposal weights (the
    final level's are held fixed) and, for the distortion loss, in the
    final weights, f32. Cumulative sums in another order: values within
    rtol 1e-5 (measured 1.1e-7), gradients within 1e-5 of each one's
    largest entry (measured 2.1e-6). The gathers' backward sums repeated indices in a
    fixed order (index_add_ here, the sorting index_put_ on the card)."""
    rng = np.random.default_rng(3)
    n = 96
    bins = [_sorted_bins(rng, n, t) for t in (32, 16, 8)]
    ws = [(rng.exponential(1.0, (n, t)) / t).astype(np.float32)
          for t in (32, 16, 8)]

    @jax.jit
    def jax_losses(w0, w1, w2):
        jb = [jnp.asarray(b) for b in bins]

        def losses(w0, w1, w2):
            return (jpdf.proposal_loss(jb, [w0, w1, w2]),
                    jpdf.interlevel_loss(jb[2], w2, jb[1], w1),
                    jpdf.distortion_loss(jb[2], w2))

        g_prop = jax.grad(lambda a, b: losses(a, b, w2)[0],
                          argnums=(0, 1))(w0, w1)
        g_dist = jax.grad(lambda c: losses(w0, w1, c)[2])(w2)
        return losses(w0, w1, w2), g_prop, g_dist

    want, g_prop, g_dist = _reference(
        lambda: jax_losses(*[jnp.asarray(w) for w in ws]))
    wt = [torch.from_numpy(w).requires_grad_() for w in ws]
    tb = [torch.from_numpy(b) for b in bins]
    prop = tpdf.proposal_loss(tb, wt)
    inter = tpdf.interlevel_loss(tb[2], wt[2], tb[1], wt[1])
    dist = tpdf.distortion_loss(tb[2], wt[2])
    for got, w in zip((prop, inter, dist), want):
        np.testing.assert_allclose(float(got.detach()), float(w), rtol=1e-5)
    prop.backward()
    assert wt[2].grad is None          # the final level is held fixed
    for t, g in zip(wt[:2], g_prop):
        assert _rel_err(_np(t.grad), g) <= 1e-5
    dist.backward()
    assert _rel_err(_np(wt[2].grad), g_dist) <= 1e-5


# ------------------------------------------------------------ field, render

# (config switches, whether the gradients are compared): the -O2
# miniature in f32 with the distortion loss, its gradients held tightly;
# the compute dtype of -O2, uncontracted, with light directions, forward
# only (a second value_and_grad compile would double the file's time; the
# bf16 gradients' rounding points are held by tests/test_torch_train.py)
_CASES = {
    "f32-contract-distort": (dict(fp16=False, contract=True,
                                  lambda_distort=0.01), True),
    "bf16-plain-rfield": (dict(fp16=True, contract=False, rfield=True),
                          False),
}


def _jax_case(case):
    """A case's inputs and JAX's answers from one jitted compile: the
    proposal densities at 4,096 points of [-2, 2]^3 (the contracted
    range), and one value_and_grad of make_batch_loss_fn on an explicit
    batch of 256 rays (4 miss the bound box), key=None, whose render_any
    is wrapped so that the render's outputs (training=True) ride out in
    the aux, in its num_points slot (no gradient where the case compares
    none)."""
    kw, with_grads = _CASES[case]
    jc = o2_cfg(jcfg, **kw)
    jspec = j_make_spec(jc)
    params = _params(jc)
    rng = np.random.default_rng(5)
    n = 256
    o, d = _rays(rng, n)
    batch = {"rays_o": o, "rays_d": d,
             "images": rng.uniform(0.0, 1.0, (n, 3)).astype(np.float32)}
    if kw.get("rfield"):
        ld = rng.standard_normal((n, 3))
        batch["rays_ldir"] = (ld / np.linalg.norm(ld, axis=-1, keepdims=True)
                              ).astype(np.float32)
    b = jc.render.bound
    aabb = np.array([-b] * 3 + [b] * 3, np.float32)
    x = np.random.default_rng(4).uniform(-2.0, 2.0, (4096, 3)
                                         ).astype(np.float32)
    render_any = jtr.render_any

    def render_any_out(*args, **kwargs):
        out = render_any(*args, **kwargs)
        return dict(out, num_points=(out["num_points"], dict(out)))

    loss_fn = jtr.make_batch_loss_fn(jc, jspec)

    def both(p, batch, x):
        dens = [j_field_density(p, jspec, x, proposal=i) for i in range(2)]
        args = (p, None, batch, jnp.asarray(aabb), None, 1.0, True)
        if with_grads:
            return dens, jax.value_and_grad(loss_fn, has_aux=True)(*args)
        return dens, (loss_fn(*args), None)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtr, "render_any", render_any_out)
        dens, ((loss, aux), grads) = _reference(lambda: jax.jit(both)(
            jax.tree_util.tree_map(jnp.asarray, params),
            {k: jnp.asarray(v) for k, v in batch.items()}, jnp.asarray(x)))
    return SimpleNamespace(kw=kw, tc=o2_cfg(tcfg, **kw), params=params,
                           batch=batch, aabb=aabb, x=x, dens=dens, loss=loss,
                           grads=grads, out=aux["num_points"][1])


@pytest.fixture(scope="module")
def jax_cases():
    """{case: _jax_case(case)}, each computed on first use."""
    cache = {}

    def get(case):
        if case not in cache:
            cache[case] = _jax_case(case)
        return cache[case]

    return get


@pytest.mark.parametrize("case", sorted(_CASES))
def test_proposal_density_matches_jax(jax_cases, case):
    """density(x, proposal=i) for both proposal networks at 4,096 points
    of [-2, 2]^3 (the contracted range), against field_density(...,
    proposal=i): the fused encode (the port's plain version of it), the
    bias-free MLP and trunc_exp. f32: sums in other orders, rtol 1e-5
    (measured 1.8e-7). bf16: the encode takes JAX's rounding chain bit for
    bit and the MLP rounds where JAX's bf16 dot does, but an f32 sum order
    can move a hidden unit across a bf16 rounding boundary (one bf16 ulp
    is up to 7.8e-3 of it): rtol 2e-2 (measured 1.2e-7: no unit moved on
    these points)."""
    c = jax_cases(case)
    field = field_from_jax(c.params, t_make_spec(c.tc), device="cpu")
    for i, want in enumerate(c.dens):
        with torch.no_grad():
            got = _np(field.density(torch.from_numpy(c.x), proposal=i))
        assert got.shape == (4096,) and (got > 0).all()
        np.testing.assert_allclose(got, np.asarray(want),
                                   rtol=2e-2 if c.kw["fp16"] else 1e-5)


@pytest.mark.parametrize("case", sorted(_CASES))
def test_render_proposal_and_batch_loss_match_jax(jax_cases, case):
    """One explicit batch of 256 rays (4 miss the bound box) through
    render_proposal (training=True: image, depth, weights_sum, the last
    level's weights, the proposal loss and, with lambda_distort > 0, the
    distortion loss) and through make_batch_loss_fn (the loss and, in the
    f32 case, the gradient of every leaf: the grid, both MLPs, both
    proposal grids and both proposal MLPs), against JAX's (jitted, its B2
    interpreted), key=None (``_jax_case``). Errors are of each tensor's
    largest entry.
    f32: sums in other orders: outputs within 1e-4 (measured 1.5e-5, on
    the last level's weights), loss rtol 1e-5 (measured 9.4e-8), the MLP
    leaves within 5e-4 (measured 4.3e-5); B2 rounds each w * g product to
    bf16 in both packages, so a cotangent one f32 ulp apart moves a
    product by a bf16 ulp (2^-8 of it): the tables within 5e-3 (measured
    8.7e-4).
    bf16: an MLP output one bf16 ulp apart by f32 sum order moves a
    density by up to 3%: outputs within 1e-2 (measured 1.4e-3), loss rtol
    1e-3 (measured equal)."""
    c = jax_cases(case)
    kw, tc, batch = c.kw, c.tc, c.batch
    tspec = t_make_spec(tc)
    n = batch["rays_o"].shape[0]
    field = field_from_jax(c.params, tspec, device="cpu")
    bt = {k: torch.from_numpy(v) for k, v in batch.items()}
    at = torch.from_numpy(c.aabb)
    with torch.no_grad():
        out_t = tprop.render_proposal(field, bt["rays_o"], bt["rays_d"], at,
                                      bg_color=0.0,
                                      rays_ldir=bt.get("rays_ldir"),
                                      training=True)
    # the proposal path reads no grid state: an empty one will do
    state = TrainState(params={}, opt_state=None, ema_params={}, step=0)
    loss_t, aux_t = ttr.make_batch_loss_fn(tc, tspec)(field, state, bt, at)

    out_tol, loss_rtol = (1e-2, 1e-3) if kw["fp16"] else (1e-4, 1e-5)
    keys = ["image", "depth", "weights_sum", "weights", "proposal_loss"]
    if kw.get("lambda_distort"):
        keys.append("distort_loss")
    assert set(keys) <= set(out_t)
    assert out_t["num_points"] == int(c.out["num_points"]) == n * 56
    assert aux_t["num_points"] == n * 56
    miss = np.asarray(c.out["weights_sum"])[:4]
    assert (miss == 0).all() and (_np(out_t["weights_sum"])[:4] == 0).all()
    for k in keys:
        err = _rel_err(_np(out_t[k]), c.out[k])
        assert err <= out_tol, (k, err)
    np.testing.assert_allclose(float(loss_t.detach()), float(c.loss),
                               rtol=loss_rtol)
    if c.grads is None:
        return
    loss_t.backward()
    for name, p, gj in _leaves(field, c.grads):
        gj = np.asarray(gj, np.float32).reshape(p.shape)
        assert np.abs(gj).max() > 0, name
        assert p.grad is not None and np.isfinite(_np(p.grad)).all(), name
        err = np.abs(_np(p.grad) - gj).max() / np.abs(gj).max()
        table = name in ("grid", "prop_grids.0", "prop_grids.1")
        assert err <= (5e-3 if table else 5e-4), (name, err)


# ------------------------------------------------------------ training

def _recording(tx):
    """tx whose update_apply keeps the gradients it is given."""
    seen = []

    def update_apply(grads, state, params, ema):
        seen.append({k: g.clone() for k, g in grads.items()})
        return tx.update_apply(grads, state, params, ema)

    return ttr._Optimizer(tx.init, update_apply), seen


def test_proposal_gate_multiplies_gradients():
    """The proposal networks' gradients are multiplied by the gate (step
    <= 3000) | (step % 5 == 0) before the fused update, as in JAX: by 1
    at steps 3000 and 3005, by 0 at 3001 (every other leaf untouched);
    at 3001 the proposal parameters still move, by Adam's momentum from
    the step before; and at a gated step a NaN proposal gradient stays
    NaN (NaN * 0) and freezes every parameter (the fused update's skip),
    where a skip of the multiply would have let the step through. Exact:
    the gate is a multiply by 1.0 or 0.0."""
    assert [ttr.proposal_gate(s) for s in (0, 3000, 3001, 3004, 3005)] == \
        [1.0, 1.0, 0.0, 0.0, 1.0]
    cfg = o2_cfg(tcfg)
    spec = t_make_spec(cfg)
    field, state = ttr.init_train_state(cfg, spec, device="cpu")
    train, _ = make_synthetic_scene(n_train=4, n_val=1, H=16, W=16, seed=0)
    scene = {k: torch.from_numpy(getattr(train, k))
             for k in ("images", "poses", "intrinsics")}
    aabb = torch.tensor([-2.0] * 3 + [2.0] * 3)
    net_tx, seen = _recording(ttr.fused_adam_ema(cfg))
    step = ttr.make_train_step(cfg, spec, net_tx, 64)
    gen = torch.Generator().manual_seed(0)
    prop = [k for k in state.params if k.startswith("prop_")]
    assert len(prop) == 6 and set(prop) == {
        "prop_grids.0", "prop_grids.1", "prop_mlps.0.0", "prop_mlps.0.1",
        "prop_mlps.1.0", "prop_mlps.1.1"}
    for s, gate in ((3000, 1.0), (3001, 0.0), (3005, 1.0)):
        state.step = s
        before = {k: p.detach().clone() for k, p in state.params.items()}
        step(field, state, scene, aabb, gen)
        grads = seen[-1]
        for k, p in state.params.items():
            raw = p.grad
            want = raw * gate if k in prop else raw
            assert torch.equal(grads[k], want), (s, k)
            if k in prop:
                assert raw.abs().max() > 0, k
                # moved by the gradient, or on a gated step by momentum
                assert not torch.equal(p.detach(), before[k]), (s, k)
    state.step = 3006
    hook = field.prop_grids[0].register_hook(
        lambda g: torch.full_like(g, float("nan")))
    try:
        before = {k: p.detach().clone() for k, p in state.params.items()}
        step(field, state, scene, aabb, gen)
    finally:
        hook.remove()
    assert torch.isnan(seen[-1]["prop_grids.0"]).all()
    for k, p in state.params.items():
        assert torch.equal(p.detach(), before[k]), k


def test_render_proposal_without_proposal_update():
    """render_proposal(update_proposal=False) (JAX's stop_gradient of the
    proposal networks, render/proposal.py:103-105, and no proposal loss,
    :137): the same forward outputs as with the update, no proposal loss,
    no gradient in any proposal parameter from the image plus the proposal
    loss, and the radiance field's gradients the same. Exact: the proposal
    networks' outputs feed only the resampled edges, which carry no
    gradient, and the proposal loss's reference weights are detached."""
    cfg = o2_cfg(tcfg)
    field = t_init_field(t_make_spec(cfg), seed=0, device="cpu")
    o, d = (torch.from_numpy(a) for a in _rays(np.random.default_rng(4), 64))
    aabb = torch.tensor([-2.0] * 3 + [2.0] * 3)
    outs, grads = [], []
    for update in (True, False):
        field.zero_grad(set_to_none=True)
        out = tprop.render_proposal(field, o, d, aabb, bg_color=0.0,
                                    training=True, update_proposal=update)
        (out["image"].sum() + out.get("proposal_loss", 0.0)).backward()
        outs.append(out)
        grads.append({k: p.grad for k, p in field.named_parameters()})
    assert "proposal_loss" in outs[0] and "proposal_loss" not in outs[1]
    for k in ("image", "depth", "weights_sum", "weights"):
        assert torch.equal(outs[0][k], outs[1][k]), k
    for k, g in grads[1].items():
        if k.startswith("prop_"):
            assert g is None and grads[0][k] is not None, k
        else:
            assert torch.equal(g, grads[0][k]), k


@pytest.mark.parametrize("hdr", [False, True])
def test_trainer_trains_evaluates_and_renders_on_cpu(hdr):
    """A CPU Trainer on the -O2 miniature (bf16, as the preset computes;
    HDR images with the RawNeRF loss in one case) at 256 rays a step: no
    grid state; 16 steps with finite losses, and the loss of one fixed
    batch of 1,024 rays (the deterministic render) lower after them than
    before (measured 0.02189 -> 0.02168 LDR, 13.79 -> 8.96 HDR; a step's
    own loss, on a fresh random batch, is too noisy to fall in 16 steps
    at LDR); finite params and EMA; then render_image and evaluate (LDR
    PSNR, or HDR with the exposure levels estimated from the train
    scene's first exposure-1.0 view: the val view's exposure is 4) give
    finite results of the right shapes."""
    cfg = o2_cfg(tcfg, fp16=True, iters=16)
    if hdr:
        cfg = replace(cfg, data=replace(cfg.data, image_mode="HDR"),
                      model=replace(cfg.model,
                                    color_activation="clamped_exp"))
    train, val = make_synthetic_scene(n_train=6, n_val=1, H=16, W=16,
                                      seed=0, hdr=hdr)
    tr = ttr.Trainer(cfg, train, val, device="cpu")
    assert tr.state.density_grid is None and tr._grid_update is None
    sa = tr.scene_arrays
    batch = t_sample(torch.Generator().manual_seed(1), sa["images"],
                     sa["poses"], sa["intrinsics"], 1024,
                     exposures=sa.get("exposures"))
    loss_fn = ttr.make_batch_loss_fn(cfg, tr.spec)

    def fixed_loss():
        with torch.no_grad():
            return float(loss_fn(tr.field, tr.state, batch, tr.aabb)[0])

    before = fixed_loss()
    losses = [float(tr.step()["loss"]) for _ in range(16)]
    assert np.isfinite(losses).all()
    assert fixed_loss() < before
    for tensors in (tr.state.params, tr.state.ema_params):
        assert all(bool(torch.isfinite(t).all()) for t in tensors.values())
    rgb, depth = tr.render_image(val.poses[0])
    assert rgb.shape == (16, 16, 3) and depth.shape == (16, 16)
    assert np.isfinite(rgb).all() and np.isfinite(depth).all()
    assert np.isfinite(tr.evaluate()["psnr"])
    if hdr:
        levels = tr.estimate_exposure_levels(train)
        assert set(levels) == set(cfg.exposure_percentiles)
        assert all(np.isfinite(v) for v in levels.values())


def test_o2_unported_branches_raise():
    """The -O2 field, its render and its Trainer are ported; what this
    slice leaves raises NotImplementedError instead of training wrongly:
    the entropy, TV, weight-decay and orientation regularizers, the
    unfused encoder, scenes with per-camera near/far and multi-device
    training."""
    cfg = o2_cfg(tcfg)
    field = t_init_field(t_make_spec(cfg), device="cpu")
    assert len(field.prop_grids) == 2 and len(field.prop_mlps) == 2
    train, val = make_synthetic_scene(n_train=2, n_val=1, H=8, W=8, seed=0)
    bad = [replace(cfg, train=replace(cfg.train, **{name: 0.1}))
           for name in ("lambda_entropy", "lambda_tv", "lambda_wd",
                        "lambda_orientation")]
    bad.append(replace(cfg, model=replace(cfg.model, fused_encoder=False)))
    bad.append(replace(cfg, parallel=replace(cfg.parallel, num_devices=2)))
    for c in bad:
        with pytest.raises(NotImplementedError):
            ttr.Trainer(c, train, val, device="cpu")
    near_far = replace(train, cam_near_far=np.ones((2, 2), np.float32))
    with pytest.raises(NotImplementedError):
        ttr.Trainer(cfg, near_far, val, device="cpu")
