"""Parity of the port's reference ``-O`` path and every other branch of the
occupancy march with the JAX package's, on the CPU: ``march_rays`` (the
span march with S > K packing, the geometric ``dt_gamma`` schedule,
coarse spans over uniform and log probes, the weighted CDF with
``dt_gamma``, log probes and the floor, contraction), ``composite_rays``,
``expand_from_slots``, ``render_occupancy`` in its compact, expand and
uncompacted branches with normals, one ``-O``-shaped train step, the
``validate()`` fallback and a CPU Trainer on the ``-O`` miniature.

The ``-O`` miniature: ``Config().with_preset_O()`` (16 x 2 xor grid, S =
512 over K = 64, no probes) cut to 4 levels, log2 12, resolution 64,
hidden 16, grid 32, K = 14 and S = 56 (S = 4K). Both packages get the
same numpy inputs made from seeds: parameters from the JAX init with the
hash table redrawn N(0, 0.3^2) (so densities vary along a ray), carried
across by raw_ngp_torch.convert; one bitfield (packbits of a seeded
density grid: a ball of radius 0.8 and 0.5% noise cells, two cascades);
rays from a sphere of radius 3 toward the centre, four of them missing
the bound box. Only the deterministic paths run (``key=None`` / jitter
0.5). The JAX side is jitted with XLA's optimizations off
(``jax_disable_most_optimizations``: eager JAX's rounding, no fused
multiply-adds; tests/test_torch_proposal.py says why) and, for the table
gradient, B2 interpreted (``segsum_pallas.FORCE_INTERPRET``); both set
back in a ``finally``. Each test states its tolerance and the reason.
"""

import warnings
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
from raw_ngp_torch.kernels import compact as tck
from raw_ngp_torch.models.ngp import make_field_spec as t_make_spec
from raw_ngp_torch.ops import compositing as tcomp
from raw_ngp_torch.ops.grid import packbits as t_packbits
from raw_ngp_torch.ops.morton import morton3d as t_morton3d
from raw_ngp_torch.ops.rays import near_far_from_aabb
from raw_ngp_torch.render import occupancy as tocc
from raw_ngp_torch.train import trainer as ttr
from raw_ngp_torch.train.state import TrainState
from raw_ngp_tpu.models.ngp import init_field as j_init_field
from raw_ngp_tpu.models.ngp import make_field_spec as j_make_spec
from raw_ngp_tpu.ops import compositing as jcomp
from raw_ngp_tpu.ops.grid import packbits as j_packbits
from raw_ngp_tpu.ops.morton import morton3d_invert
from raw_ngp_tpu.render import occupancy as jocc
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


def o_cfg(mod, **render_kw):
    """The -O miniature from either package's config module (f32). K = 14
    and S = 56: a ray through two opposite faces of the box puts its
    candidates at x01 = (s + 1/2) / 56 there, off every cell face of the
    grid's levels (16 to 128); at S = 64 they sit on the faces of the
    resolution-64 level, where the grid's gradient, so the normal, jumps
    with an ulp of position (the reference's jitted o + d t is one FMA)."""
    cfg = mod.Config().with_preset_O()
    cfg = replace(cfg, model=replace(
        cfg.model, num_levels=4, log2_hashmap_size=12, hashgrid_resolution=64,
        grid_mlp_hidden=16, view_mlp_hidden=16))
    cfg = replace(cfg, render=replace(cfg.render, **dict(
        dict(grid_size=32, samples_per_ray=14, march_candidates=56,
             max_ray_batch=1024), **render_kw)))
    cfg = replace(cfg, train=replace(cfg.train, num_rays=256, fp16=False,
                                     seed=0))
    return cfg.validate()


GS, CAS, BOUND = 32, 2, 2.0


def _bitfield(noise=0.005, seed=3):
    """packbits of a seeded density grid (numpy u8): a ball of radius 0.8
    and `noise` of the cells, both cascades."""
    rng = np.random.default_rng(seed)
    xyz = np.asarray(morton3d_invert(jnp.arange(GS ** 3, dtype=jnp.uint32)))
    dg = np.zeros((CAS, GS ** 3), np.float32)
    for c in range(CAS):
        p = (2.0 * xyz / (GS - 1) - 1.0) * min(2 ** c, BOUND)
        dg[c] = np.where(np.linalg.norm(p, axis=-1) < 0.8, 20.0, 0.0)
        dg[c] += 20.0 * (rng.random(GS ** 3) < noise)
    bits = np.asarray(j_packbits(jnp.asarray(dg), 10.0))
    np.testing.assert_array_equal(
        t_packbits(torch.from_numpy(dg), 10.0).numpy(), bits)
    return bits


def _rays(n, seed=5, n_miss=4):
    """Unit rays from a sphere of radius 3 toward points near the centre;
    the first `n_miss` pass beside the bound box [-2, 2]^3."""
    rng = np.random.default_rng(seed)
    c = rng.standard_normal((n, 3))
    o = 3.0 * c / np.linalg.norm(c, axis=-1, keepdims=True)
    d = rng.uniform(-0.5, 0.5, (n, 3)) - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o[:n_miss], d[:n_miss] = (3.0, 3.0, 0.0), (0.0, 0.0, 1.0)
    return o.astype(np.float32), d.astype(np.float32)


def _near_far(o, d):
    """The render's near/far (misses set to [1, 1.001]) as torch."""
    aabb = torch.tensor([-BOUND] * 3 + [BOUND] * 3)
    nears, fars = near_far_from_aabb(torch.from_numpy(o), torch.from_numpy(d),
                                     aabb, 0.05)
    miss = fars >= 1e8
    return torch.where(miss, 1.0, nears), torch.where(miss, 1.001, fars)


# ------------------------------------------------------------ the march

# name: (S, K, JAX march_rays keywords); P = 16 probes where probed
_BRANCHES = {
    "span_S>K": (64, 16, {}),
    "span_dt_gamma": (64, 16, dict(dt_gamma=1 / 128)),
    "coarse_span_uniform": (64, 16, dict(coarse_probes=16)),
    "coarse_span_log": (64, 16, dict(coarse_probes=16, probe_log=True)),
    "cdf_dt_gamma_S>K": (64, 16, dict(coarse_probes=16, march_cdf=True,
                                      dt_gamma=1 / 128)),
    "cdf_log": (32, 32, dict(coarse_probes=16, march_cdf=True,
                             probe_log=True)),
    "cdf_floor": (32, 32, dict(coarse_probes=16, march_cdf=True,
                               cdf_floor=0.05)),
    "cdf_gamma_log_floor": (64, 16, dict(coarse_probes=16, march_cdf=True,
                                         dt_gamma=1 / 128, probe_log=True,
                                         cdf_floor=0.05)),
    "contract_span_dt_gamma": (64, 16, dict(contract=True,
                                            dt_gamma=1 / 128)),
    "contract_cdf_log_floor": (32, 32, dict(contract=True, coarse_probes=16,
                                            march_cdf=True, probe_log=True,
                                            cdf_floor=0.05)),
}


def _cdf_tie_rays(o, d, nears, fars, bits, S, kw, contract):
    """Rays of a weighted-CDF march with a candidate whose CDF position u
    lies within 32 f32 ulps of the ray's total weight of a probe edge
    (the cumulative weight W_p), from the port's probe weights in f64.
    The packages sum W in other orders (torch.cumsum's sequential sum,
    JAX's parallel prefix on the CPU), so such a candidate may fall in
    either probe: its t jumps to the other probe or, where the two sums
    disagree on which probe contains u, to the end of its probe with dt
    0. Their rays are left out of the tight comparisons."""
    P = kw["coarse_probes"]
    occ, t_p, spc = (np.asarray(_np(a), np.float64) for a in
                     tocc._probe_occupancy(
                         torch.from_numpy(o), torch.from_numpy(d),
                         _coarse(torch.from_numpy(bits.copy()), BOUND, CAS, P),
                         nears, fars, BOUND, GS, CAS, P, contract,
                         kw.get("probe_log", False)))
    dt_ref = 1.0
    if kw.get("dt_gamma"):
        dt_ref = np.clip(t_p * kw["dt_gamma"], 2 * np.sqrt(3) / 1024,
                         2 * np.sqrt(3) * 2 ** (CAS - 1) / GS)
    wv = spc / dt_ref * np.where(occ > 0, 1.0, kw.get("cdf_floor", 0.0))
    W = np.cumsum(wv, axis=1)
    u = (np.arange(S) + 0.5) * W[:, -1:] / S
    gap = np.abs(u[:, :, None] - W[:, None, :]).min(-1)
    return (gap <= 32 * np.spacing(W[:, -1:].astype(np.float32))).any(1)


def _cell_edge_distance(pos, dt, contract):
    """Distance (in cells) of each position [..., 3] from the nearest
    face of its occupancy cell at its mip level, as occupancy_lookup
    indexes it."""
    pos = np.clip(pos, -BOUND, BOUND)
    mag = np.abs(pos).max(-1, keepdims=True)
    cpos = pos
    if contract:
        safe = np.maximum(mag, 1e-12)
        cpos = np.where(mag > 1.0, pos * (2.0 - 1.0 / safe) / safe, pos)
    lvl = np.asarray(jocc._mip_level(jnp.asarray(pos), jnp.asarray(dt),
                                     GS, CAS))
    mb = np.minimum(2.0 ** lvl, BOUND)[..., None]
    x = 0.5 * (cpos / mb + 1.0) * GS
    return np.abs(x - np.round(x)).min(-1)


@pytest.mark.parametrize("branch", sorted(_BRANCHES))
def test_march_rays_matches_jax(branch):
    """march_rays on 256 rays (4 misses) in every branch against JAX's.
    t and dt where both live: within 16 ulps of the ray's span (f32) for
    the weighted-CDF branches, whose per-probe cumulative weights sum in
    torch.cumsum's order against JAX's parallel prefix, an error the
    inverse CDF carries into t at up to about P ulps (measured 6.5), and
    within 4 ulps elsewhere (jnp.power against torch.pow, measured 2.5).
    A t an ulp apart can cross a cell face, so a mask entry may differ
    only where JAX's sample sits within 1e-4 cell of a face at its mip
    level, and at most 2% of them (measured: none on these rays). In the
    weighted-CDF branches the rays with a candidate at a near-tie of the
    CDF (_cdf_tie_rays) are left out of these comparisons, at most 10% of
    the rays (measured: 1 of 256 in two branches)."""
    S, K, kw = _BRANCHES[branch]
    kw = dict(kw)
    contract = kw.pop("contract", False)
    bits = _bitfield()
    o, d = _rays(256)
    nt, ft = _near_far(o, d)
    mj = _reference(lambda: jax.jit(lambda o, d, n, f: jocc.march_rays(
        o, d, jnp.asarray(bits), n, f, BOUND, contract, GS, CAS, S, K,
        key=None, **kw))(jnp.asarray(o), jnp.asarray(d),
                         jnp.asarray(_np(nt)), jnp.asarray(_np(ft))))
    mj = {k: np.asarray(v) for k, v in mj.items()}
    probes = kw.pop("coarse_probes", 0)
    mt = tocc.march_rays(torch.from_numpy(o), torch.from_numpy(d),
                         torch.from_numpy(bits.copy()), nt, ft, BOUND, GS, CAS, S,
                         K, probes, contract=contract, **kw)
    mt = {k: _np(v) for k, v in mt.items()}
    assert mt["ts"].shape == mt["deltas"].shape == (256, K)
    assert mj["mask"].mean() > 0.05
    np.testing.assert_array_equal(mt["mask"], mt["ts"] >= 0)
    weighted = kw.get("march_cdf") and (
        kw.get("dt_gamma") or kw.get("probe_log") or kw.get("cdf_floor"))
    rays = np.ones(256, bool)
    if weighted:
        rays = ~_cdf_tie_rays(o, d, nt, ft, bits, S, dict(
            kw, coarse_probes=probes), contract)
        assert rays.mean() >= 0.9, (~rays).sum()
    mt = {k: v[rays] for k, v in mt.items()}
    mj = {k: np.broadcast_to(v, (256,) + v.shape[1:])[rays]
          for k, v in mj.items()}
    o, d, nt, ft = o[rays], d[rays], nt[rays], ft[rays]
    diff = mt["mask"] != mj["mask"]
    assert diff.mean() <= 0.02, diff.sum()
    if diff.any():
        t_j = np.where(diff, mj["ts"], mt["ts"])   # the live one's t
        pos = o[:, None] + d[:, None] * t_j[..., None]
        dt = np.broadcast_to(np.where(diff, np.broadcast_to(
            mj["deltas"], diff.shape), mt["deltas"]), diff.shape)
        assert (_cell_edge_distance(pos, dt, contract)[diff] < 1e-4).all()
    tol = (16 if weighted else 4) * np.spacing(_np(ft - nt))   # [n, 1]
    both = mt["mask"] & mj["mask"]
    err_t = np.abs(mt["ts"] - mj["ts"])
    assert (err_t <= tol)[both].all(), (err_t / tol)[both].max()
    err_dt = np.abs(mt["deltas"] - np.broadcast_to(mj["deltas"],
                                                   mt["deltas"].shape))
    assert (err_dt <= tol)[both].all(), (err_dt / tol)[both].max()


def test_dt_gamma_march_implements_closed_form():
    """The port's dt_gamma candidates equal the closed form
    near + span ((1 + g)^(i + 0.5) - 1) / ((1 + g)^S - 1) of
    tests/test_dt_gamma.py:80 (rtol 2e-4, as there), on an all-occupied
    grid, at S = K = 32 and with the S > K packing at S = 64, K = 16
    (the first 16 candidates)."""
    gs = 16
    bits = torch.full((gs ** 3 // 8,), 0xFF, dtype=torch.uint8)
    ro, rd = torch.tensor([[0.0, 0.0, -0.9]]), torch.tensor([[0.0, 0.0, 1.0]])
    nears, fars = torch.tensor([[0.1]]), torch.tensor([[1.8]])
    g = 1 / 64
    for S, K in ((32, 32), (64, 16)):
        m = tocc.march_rays(ro, rd, bits, nears, fars, 1.0, gs, 1, S, K,
                            dt_gamma=g)
        steps = np.arange(S) + 0.5
        want = 0.1 + 1.7 * ((1 + g) ** steps - 1) / ((1 + g) ** S - 1)
        assert m["mask"].all()
        np.testing.assert_allclose(_np(m["ts"][0]), want[:K], rtol=2e-4)


def _slab_bitfield(slabs=((16, 20),), cascades=1):
    """Port bitfield with cascade 0 occupied on x-cell ranges (all y, z)."""
    dens = np.zeros((cascades, GS ** 3), np.float32)
    ar = np.arange(GS)
    for a, b in slabs:
        x, y, z = np.meshgrid(np.arange(a, b), ar, ar, indexing="ij")
        cells = torch.from_numpy(np.stack([x, y, z], -1).reshape(-1, 3))
        dens[0, _np(t_morton3d(cells))] = 100.0
    return t_packbits(torch.from_numpy(dens), 1.0)


def _coarse(bits, bound, cascades, P):
    return tocc.coarse_occupancy(
        bits, GS, cascades, tocc._coarse_dilate_radius(bound, GS, P),
        bound=bound)


@pytest.mark.parametrize("log_spacing", [False, True])
@pytest.mark.parametrize("bound,cascades", [(1.0, 1), (2.0, 2)])
def test_coarse_spans_are_conservative(bound, cascades, log_spacing):
    """The properties of tests/test_coarse_march.py on the port: on a
    random 5% grid the tightened spans never widen, and every sample the
    full-span march keeps (S 512, K 128) lies inside its ray's span, to
    the candidate spacing."""
    rng = np.random.default_rng(0)
    bits = t_packbits(torch.from_numpy(
        (rng.random((cascades, GS ** 3)) < 0.05).astype(np.float32) * 100),
        1.0)
    N, P = 256, 64
    ro = torch.from_numpy(rng.uniform(-0.9 * bound, 0.9 * bound, (N, 3))
                          .astype(np.float32))
    rd = torch.nn.functional.normalize(torch.from_numpy(
        rng.standard_normal((N, 3)).astype(np.float32)), dim=-1)
    nears = torch.full((N, 1), 0.05)
    fars = torch.full((N, 1), 2.0 * np.sqrt(3.0) * bound)
    m = tocc.march_rays(ro, rd, bits, nears, fars, bound, GS, cascades, 512,
                        128)
    near2, far2 = tocc.coarse_spans(ro, rd, _coarse(bits, bound, cascades, P),
                                    nears, fars, bound, GS, cascades, P,
                                    log_spacing=log_spacing)
    assert (near2 >= nears - 1e-6).all() and (far2 <= fars + 1e-6).all()
    slop = float(fars[0, 0] - nears[0, 0]) / 512
    ts, mask = _np(m["ts"]), _np(m["mask"])
    inside = (ts >= _np(near2) - slop) & (ts <= _np(far2) + slop)
    assert mask.any() and (inside | ~mask).all()


def test_empty_scene_collapses_spans():
    """An empty grid: every span collapses to [far, far] and the march
    over it keeps nothing (tests/test_coarse_march.py)."""
    bits = t_packbits(torch.zeros(1, GS ** 3), 1.0)
    o, d = _rays(32, seed=7, n_miss=0)
    ro, rd = torch.from_numpy(o) * 0.3, torch.from_numpy(d)
    nears, fars = torch.full((32, 1), 0.05), torch.full((32, 1), 3.4)
    near2, far2 = tocc.coarse_spans(ro, rd, _coarse(bits, 1.0, 1, 64), nears,
                                    fars, 1.0, GS, 1, 64)
    assert torch.equal(near2, fars) and torch.equal(far2, fars)
    m = tocc.march_rays(ro, rd, bits, near2, far2, 1.0, GS, 1, 128, 32)
    assert not m["mask"].any()


def test_cascade0_shell_content_not_dropped():
    """A cascade-0 cell at the unit cube's edge, cascade 1 empty: every ray
    grazing the shell on which the full-span march finds content finds it
    with the coarse probes too (tests/test_coarse_march.py)."""
    dens = np.zeros((2, GS ** 3), np.float32)
    dens[0, int(t_morton3d(torch.tensor([[31, 31, 16]])))] = 100.0
    bits = t_packbits(torch.from_numpy(dens), 1.0)
    N = 27
    ro = torch.stack([torch.full((N,), -2.0), torch.linspace(0.93, 0.999, N),
                      torch.full((N,), 0.02)], -1)
    rd = torch.tensor([[1.0, 0.0, 0.0]]).expand(N, 3)
    nears = torch.full((N, 1), 0.05)
    fars = torch.full((N, 1), 4.0 * np.sqrt(3.0))
    full = tocc.march_rays(ro, rd, bits, nears, fars, 2.0, GS, 2, 512,
                           128)["mask"].any(1)
    coarse = tocc.march_rays(ro, rd, bits, nears, fars, 2.0, GS, 2, 512,
                             128, 64)["mask"].any(1)
    assert full.any() and coarse[full].all()


@pytest.mark.parametrize("log_spacing", [False, True])
def test_cdf_floor_keeps_void_coverage(log_spacing):
    """cdf_floor 0.25 on two slabs with a void between them
    (tests/test_coarse_march.py): the share of candidates in unoccupied
    probe intervals is floor L_unocc / (L_occ + floor L_unocc) within 0.05
    on every ray, dt tiles the whole support within rtol 2e-2, and floor
    0 puts every live candidate in an occupied interval."""
    P, S, N, floor = 32, 256, 64, 0.25
    bits = _slab_bitfield(((16, 20), (26, 28)))
    coarse = _coarse(bits, 1.0, 1, P)
    ro = torch.stack([torch.full((N,), -0.9), torch.linspace(-0.7, 0.7, N),
                      torch.linspace(0.7, -0.7, N)], -1)
    rd = torch.tensor([[1.0, 0.0, 0.0]]).expand(N, 3)
    nears, fars = torch.full((N, 1), 0.05), torch.full((N, 1), 2.5)
    occ, _, spc = tocc._probe_occupancy(ro, rd, coarse, nears, fars, 1.0, GS,
                                        1, P, log_spacing=log_spacing)
    occ, spc = _np(occ), np.broadcast_to(_np(spc), occ.shape)
    _, _, base, logg = (_np(a) for a in tocc._probe_grid(nears, fars, P,
                                                          log_spacing))

    def interval(t):
        if log_spacing:
            p = np.log(np.maximum(t, 1e-12) / base) / logg
        else:
            p = (t - _np(nears)) / spc[:, :1]
        return np.clip(p.astype(int), 0, P - 1)

    t_f, dt_f = (_np(a) for a in tocc.cdf_candidates(
        ro, rd, coarse, nears, fars, 1.0, GS, 1, P, S, 0.5,
        log_spacing=log_spacing, floor=floor))
    in_occ = np.take_along_axis(occ, interval(t_f), axis=1)
    L_occ, L_un = (occ * spc).sum(1), ((~occ) * spc).sum(1)
    rows = L_occ > 0
    assert rows.any()
    np.testing.assert_allclose((1.0 - in_occ.mean(1))[rows],
                               (floor * L_un / (L_occ + floor * L_un))[rows],
                               atol=0.05)
    np.testing.assert_allclose(dt_f.sum(1)[rows], (L_occ + L_un)[rows],
                               rtol=0.02)
    t_0, _ = tocc.cdf_candidates(ro, rd, coarse, nears, fars, 1.0, GS, 1, P,
                                 S, 0.5, log_spacing=log_spacing)
    t_0 = _np(t_0)
    live = t_0 < _np(fars) - 1e-6
    assert np.take_along_axis(occ, interval(t_0), axis=1)[live].all()


# ------------------------------------------------------------ composite

def test_composite_rays_matches_jax():
    """composite_rays on 64 rays of 32 samples (30% masked out, one
    infinite density, t_thresh 1e-4) and the gradient of a random
    cotangent on image, depth and weights_sum in sigmas, rgbs and deltas,
    against JAX's (tests/test_compositing.py:41-90). Cumulative sums in
    another order: outputs and gradients within 1e-5 of each one's
    largest entry (measured 3.5e-7)."""
    rng = np.random.default_rng(0)
    N, K = 64, 32
    sig = rng.uniform(0, 5, (N, K)).astype(np.float32)
    sig[3, 5] = np.inf
    rgb = rng.uniform(0, 1, (N, K, 3)).astype(np.float32)
    ts = np.cumsum(rng.uniform(0.01, 0.1, (N, K)), 1).astype(np.float32)
    dl = rng.uniform(0.01, 0.1, (N, K)).astype(np.float32)
    mask = rng.uniform(size=(N, K)) > 0.3
    cots = [rng.standard_normal(s).astype(np.float32)
            for s in ((N, 3), (N,), (N,))]

    def loss(out, mod):
        return sum((out[k] * mod(c)).sum()
                   for k, c in zip(("image", "depth", "weights_sum"), cots))

    def jax_fn(s, r, dd):
        out = jcomp.composite_rays(s, r, jnp.asarray(ts), dd,
                                   jnp.asarray(mask), t_thresh=1e-4)
        return loss(out, jnp.asarray), out

    (_, out_j), g_j = _reference(lambda: jax.jit(jax.value_and_grad(
        jax_fn, argnums=(0, 1, 2), has_aux=True))(
        jnp.asarray(sig), jnp.asarray(rgb), jnp.asarray(dl)))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (sig, rgb, dl)]
    out_t = tcomp.composite_rays(leaves[0], leaves[1], torch.from_numpy(ts),
                                 leaves[2], torch.from_numpy(mask),
                                 t_thresh=1e-4)
    for k in ("weights", "weights_sum", "depth", "image"):
        assert np.isfinite(_np(out_t[k])).all()
        assert _rel_err(_np(out_t[k]), out_j[k]) <= 1e-5, k
    loss(out_t, torch.from_numpy).backward()
    for t, g in zip(leaves, g_j):
        g = np.nan_to_num(np.asarray(g))
        assert _rel_err(np.nan_to_num(_np(t.grad)), g) <= 1e-5


def test_expand_from_slots_matches_jax():
    """expand_from_slots of 4-wide slot rows over a decimated mask of 96 x
    16 samples into 640 slots (some unfilled), forward and the backward
    of a random cotangent, against JAX's (its inv / pos from
    compact_positions, the dummy row appended), bit for bit: a scatter
    and a gather of the same numbers, no arithmetic."""
    rng = np.random.default_rng(1)
    N, K, m_pad = 96, 16, 640
    mask = rng.random((N, K)) < 0.4
    _, inv, pos = jocc.compact_positions(jnp.asarray(mask), m_pad)
    packed = rng.standard_normal((m_pad, 4)).astype(np.float32)
    cot = rng.standard_normal((N * K, 4)).astype(np.float32)
    padded = jnp.concatenate([jnp.asarray(packed), jnp.zeros((1, 4))])
    out_j, (g_j,) = jax.jit(lambda p, c: (
        lambda out, vjp: (out, vjp(c)))(*jax.vjp(
            lambda q: jocc.expand_from_slots(q, inv, pos, m_pad), p)))(
        padded, jnp.asarray(cot))
    pt = torch.from_numpy(packed).requires_grad_()
    pos_t = torch.from_numpy(np.asarray(pos))
    out_t = tocc.expand_from_slots(pt, pos_t, N * K)
    (out_t * torch.from_numpy(cot)).sum().backward()
    assert int((np.asarray(pos) < N * K).sum()) < m_pad
    np.testing.assert_array_equal(_np(out_t), np.asarray(out_j))
    np.testing.assert_array_equal(_np(pt.grad), np.asarray(g_j)[:m_pad])


def test_fold_positions_are_compact_positions():
    """decimate_compact(positions=True) on the CPU (the plain version):
    the same seven outputs as without, and pos the flat source index of
    each slot (N * K where unfilled) that JAX's compact_positions gives
    for the decimated mask (stride 2 here), so rid = pos // K where
    filled."""
    rng = np.random.default_rng(2)
    N, K, m_pad = 64, 32, 384
    mask = torch.from_numpy(rng.random((N, K)) < 0.4)
    miss = torch.from_numpy(rng.random((N, 1)) < 0.1)
    ts = torch.from_numpy(rng.random((N, K)).astype(np.float32))
    dt = torch.from_numpy(rng.random((N, 1)).astype(np.float32))
    a = tck.decimate_compact(mask, miss, ts, dt.expand(N, K), m_pad)
    b = tck.decimate_compact(mask, miss, ts, dt.expand(N, K), m_pad,
                             positions=True)
    assert len(a) == 7 and len(b) == 8
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    live = mask & ~miss
    stride = max(-(-int(live.sum()) // m_pad), 1)
    assert stride == 2
    k_idx = torch.cumsum(live.int(), 1) - 1
    dec = live & (k_idx % stride == 0)
    _, _, pos_j = jocc.compact_positions(jnp.asarray(_np(dec)), m_pad)
    pos = b[7]
    np.testing.assert_array_equal(_np(pos), np.asarray(pos_j))
    filled = b[3]
    assert torch.equal(b[2][filled], (pos[filled] // K).int())
    assert (pos[~filled] == N * K).all()


# ------------------------------------------------------------ render

def _params(jc, seed=0):
    """JAX init of the field, hash table redrawn N(0, 0.3^2) -> numpy."""
    params = jax.tree_util.tree_map(
        np.asarray, j_init_field(jax.random.PRNGKey(seed), j_make_spec(jc)))
    rng = np.random.default_rng(seed + 10)
    params["grid"] = (0.3 * rng.standard_normal(params["grid"].shape)
                      ).astype(np.float32)
    return params


# (render keywords, compute_normals, training) of each render case
_RENDERS = {
    "compact": ({}, False, True),
    "expand_normals": ({}, True, False),
    "uncompacted_normals": (dict(compact_ratio=0.0), True, True),
    "contract_cdf_normals": (dict(contract=True, mark_untrained=False,
                                  coarse_probes=16, march_cdf=True,
                                  probe_log=True, cdf_floor=0.05,
                                  dt_gamma=1 / 128, samples_per_ray=32,
                                  march_candidates=32), True, False),
}


@pytest.mark.parametrize("case", sorted(_RENDERS))
def test_render_occupancy_matches_jax(case):
    """render_occupancy of 256 rays (4 misses) on the -O miniature (f32,
    S = 4K, budget decimation over 1,792 slots) in its
    compact-composite, expand (normals) and uncompacted (compact_ratio 0)
    branches, and contracted with log probes, the CDF floor and dt_gamma,
    against JAX's render_occupancy (key=None): image, depth, weights_sum,
    the normal map and, in training, weights and the point counts. The
    march's outputs are captured in both renders: a ray whose masks or
    packed ts differ (a candidate an ulp from a cell face, as
    test_march_rays_matches_jax allows, which also shifts the later
    candidates of its ray through the S > K packing; at most 5% of the
    rays) is left out, and the point counts may differ by its samples.
    On the other rays, sums in other orders: within 1e-4 of each one's
    largest entry (measured 7.7e-7; no ray left out on these inputs). The
    normal map composites -normalize(grad sigma) with the weights; where
    the density's gradient is small its direction carries the rounding of
    the encode's input gradient, which the weights damp (measured
    2.0e-5)."""
    kw, normals, training = _RENDERS[case]
    # the JAX field's encode gives input gradients only where the config
    # asks for normals (FieldSpec.needs_input_grads)
    kw = dict(kw, compute_normals=normals)
    jc, tc = o_cfg(jcfg, **kw), o_cfg(tcfg, **kw)
    params = _params(jc)
    bits = _bitfield()
    o, d = _rays(256)
    aabb = np.array([-BOUND] * 3 + [BOUND] * 3, np.float32)
    jspec = j_make_spec(jc)

    def render(p, o, d):
        return jocc.render_occupancy(
            p, jspec, o, d, jnp.asarray(aabb), jnp.asarray(bits), key=None,
            bg_color=1.0, training=training, compute_normals=normals)

    masks = {}

    def j_march(*args, **kwargs):
        m = march_j(*args, **kwargs)
        jax.debug.callback(lambda a, t: masks.update(
            jax=np.asarray(a), jax_ts=np.asarray(t)), m["mask"], m["ts"])
        return m

    def t_march(*args, **kwargs):
        m = march_t(*args, **kwargs)
        masks.update(port=_np(m["mask"]), port_ts=_np(m["ts"]))
        return m

    march_j, march_t = jocc.march_rays, tocc.march_rays
    field = field_from_jax(params, t_make_spec(tc), device="cpu")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jocc, "march_rays", j_march)
        mp.setattr(tocc, "march_rays", t_march)
        out_j = _reference(lambda: jax.block_until_ready(jax.jit(render)(
            jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(o),
            jnp.asarray(d))))
        with torch.no_grad():
            out_t = tocc.render_occupancy(
                field, torch.from_numpy(o), torch.from_numpy(d),
                torch.from_numpy(aabb), torch.from_numpy(bits), bg_color=1.0,
                training=training, compute_normals=normals)
    flip = ((masks["jax"] != masks["port"]).any(1)
            | (np.abs(masks["jax_ts"] - masks["port_ts"]) > 1e-4).any(1))
    assert flip.mean() <= 0.05, flip.sum()
    keys = ["image", "depth", "weights_sum"]
    keys += ["normals"] if normals else []
    if training:
        keys += ["weights"] if "weights" in out_j else []
        n_flip = int((masks["jax"] != masks["port"]).sum())
        for k in ("num_points", "num_points_raw"):
            assert abs(int(out_t[k]) - int(out_j[k])) <= n_flip, k
        assert n_flip or int(out_t["num_points"]) == int(out_j["num_points"])
    assert set(keys) <= set(out_t)
    ws = _np(out_t["weights_sum"])
    assert ws.max() > 0.2 and (ws[:4] == 0).all()
    for k in keys:
        got, want = _np(out_t[k]), np.asarray(out_j[k])
        assert np.isfinite(got).all(), k
        assert _rel_err(got[~flip], want[~flip]) <= 1e-4, (
            k, _rel_err(got[~flip], want[~flip]))
    if normals:
        nm = _np(out_t["normals"])
        assert (nm >= 0).all() and (nm <= 1).all()


def test_o_train_step_matches_jax():
    """One -O train step's objective on a fixed batch of 256 rays (4
    misses; key=None): make_batch_loss_fn's loss and the gradient of every
    leaf (the grid and both MLPs) against JAX's value_and_grad (B2
    interpreted), f32. The port renders JAX's march (captured in its
    render), so both differentiate the same samples; the march itself is
    held by test_march_rays_matches_jax, where a candidate an ulp from a
    cell face may differ. Sums in other orders: loss rtol 1e-5, the MLP
    leaves within 5e-4 of each one's largest entry; B2 rounds each w * g
    product to bf16 in both packages, so a cotangent one f32 ulp apart
    moves a product by a bf16 ulp: the table within 5e-3 (the tolerances
    of tests/test_torch_proposal.py; measured 4.5e-5 on the table, 2.9e-7
    on the MLPs)."""
    jc, tc = o_cfg(jcfg), o_cfg(tcfg)
    params = _params(jc)
    bits = _bitfield()
    o, d = _rays(256)
    rgb = np.random.default_rng(6).uniform(0, 1, (256, 3)).astype(np.float32)
    aabb = np.array([-BOUND] * 3 + [BOUND] * 3, np.float32)
    loss_j = jtr.make_batch_loss_fn(jc, j_make_spec(jc))
    state_j = SimpleNamespace(density_bitfield=jnp.asarray(bits))
    batch = {"rays_o": o, "rays_d": d, "images": rgb}
    march, march_j = {}, jocc.march_rays

    def j_march(*args, **kwargs):
        m = march_j(*args, **kwargs)
        jax.debug.callback(lambda *a: march.update(
            (k, torch.from_numpy(np.array(v))) for k, v in zip(m, a)),
            *m.values())
        return m

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jocc, "march_rays", j_march)
        (lj, aux_j), g_j = _reference(lambda: jax.block_until_ready(
            jax.jit(jax.value_and_grad(
                lambda p, b: loss_j(p, state_j, b, jnp.asarray(aabb), None,
                                    1.0, True), has_aux=True))(
                jax.tree_util.tree_map(jnp.asarray, params),
                {k: jnp.asarray(v) for k, v in batch.items()})))
        mp.setattr(tocc, "march_rays", lambda *a, **k: march)
        field = field_from_jax(params, t_make_spec(tc), device="cpu")
        state = TrainState(params={}, opt_state=None, ema_params={}, step=0,
                           density_bitfield=torch.from_numpy(bits))
        lt, aux_t = ttr.make_batch_loss_fn(tc, t_make_spec(tc))(
            field, state, {k: torch.from_numpy(v) for k, v in batch.items()},
            torch.from_numpy(aabb))
    assert int(march["mask"].sum()) > int(aux_t["num_points"]) > 0
    assert int(aux_t["num_points"]) == int(aux_j["num_points"])
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


# ------------------------------------------------------------ plumbing

def test_validate_falls_back_to_span_march_under_contraction():
    """validate() of a contracted config with the CDF march and no floor
    warns and turns march_cdf off, in both packages alike; with a floor
    it keeps the CDF."""
    for mod in (jcfg, tcfg):
        cfg = mod.Config().with_preset_O2()
        cfg = replace(cfg, render=replace(cfg.render, march_cdf=True,
                                          coarse_probes=16))
        with pytest.warns(UserWarning, match="falling back to the span"):
            out = cfg.validate()
        assert out.render.march_cdf is False
        floored = replace(cfg, render=replace(cfg.render, cdf_floor=0.05))
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            assert floored.validate().render.march_cdf is True


def test_o_trainer_trains_and_renders_normals_on_cpu(tmp_path):
    """A CPU Trainer on the -O miniature with compute_normals (bf16, as
    the preset computes; mark_untrained; 256 rays a step): no coarse
    cache (no probes), 8 finite steps, render_image(return_normals=True)
    gives a finite normal map in [0, 1] beside the image, evaluate a
    finite PSNR, and the field's parameters collect no gradient from the
    normals."""
    cfg = o_cfg(tcfg, compute_normals=True)
    cfg = replace(cfg, train=replace(cfg.train, fp16=True, iters=8))
    train, val = make_synthetic_scene(n_train=4, n_val=1, H=16, W=16,
                                      seed=0)
    tr = ttr.Trainer(cfg, train, val, device="cpu", workspace=str(tmp_path))
    losses = [float(tr.step()["loss"]) for _ in range(8)]
    assert np.isfinite(losses).all()
    assert "coarse_lin" not in tr.scene_arrays
    for p in tr.field.parameters():
        p.grad = None
    rgb, depth, nm = tr.render_image(val.poses[0], return_normals=True,
                                     use_ema=False)
    assert rgb.shape == nm.shape == (16, 16, 3) and depth.shape == (16, 16)
    assert np.isfinite(nm).all() and (nm >= 0).all() and (nm <= 1).all()
    assert all(p.grad is None for p in tr.field.parameters())
    assert len(tr.render_image(val.poses[0])) == 2
    assert np.isfinite(tr.evaluate()["psnr"])


def test_o_unported_branches_raise(tmp_path):
    """The regularizers and the unfused encoder are ported: a Trainer takes
    each of the entropy, TV, weight-decay and orientation weights and
    fused_encoder=False, and a training render with the orientation loss
    returns it, and a scene with per-camera near/far trains (its ranges
    ride in the Trainer's scene arrays). Multi-device training is ported
    (raw_ngp_torch.parallel): with no process group, num_devices=2 takes
    the one device there is (JAX's min(n, devices)) and tp_devices=2 has
    no ranks to shard over (RuntimeError). TV in the deterministic mode
    (no generator) raises ValueError, as JAX's fails there."""
    cfg = o_cfg(tcfg)
    train, val = make_synthetic_scene(n_train=2, n_val=1, H=8, W=8, seed=0)
    ported = [replace(cfg, train=replace(cfg.train, **{name: 0.1}))
              for name in ("lambda_entropy", "lambda_tv", "lambda_wd",
                           "lambda_orientation")]
    ported.append(replace(cfg, model=replace(cfg.model, fused_encoder=False)))
    for c in ported:
        ttr.Trainer(c, train, val, device="cpu", workspace=str(tmp_path))
    tr = ttr.Trainer(replace(cfg, parallel=replace(cfg.parallel,
                                                   num_devices=2)),
                     train, val, device="cpu", workspace=str(tmp_path))
    assert tr.mesh is None and tr.n_dp == tr.n_tp == 1
    with pytest.raises(RuntimeError):
        ttr.Trainer(replace(cfg, parallel=replace(cfg.parallel,
                                                  num_devices=2,
                                                  tp_devices=2)),
                    train, val, device="cpu", workspace=str(tmp_path))
    near_far = np.array([[0.5, 3.0], [1.0, 4.0]], np.float32)
    tr = ttr.Trainer(cfg, replace(train, cam_near_far=near_far), val,
                     device="cpu", workspace=str(tmp_path))
    assert torch.equal(tr.scene_arrays["cam_near_far"],
                       torch.from_numpy(near_far))
    orient = replace(cfg, train=replace(cfg.train, lambda_orientation=0.1))
    field = field_from_jax(_params(o_cfg(jcfg)), t_make_spec(orient),
                           device="cpu")
    o, d = _rays(8)
    out = tocc.render_occupancy(field, torch.from_numpy(o),
                                torch.from_numpy(d),
                                torch.tensor([-2.0] * 3 + [2.0] * 3),
                                torch.from_numpy(_bitfield()), training=True)
    assert out["orientation_loss"].ndim == 0
    assert bool(torch.isfinite(out["orientation_loss"]))
    tv = replace(cfg, train=replace(cfg.train, lambda_tv=0.1))
    state = TrainState(params={}, opt_state=None, ema_params={}, step=0,
                       density_bitfield=torch.from_numpy(_bitfield()))
    batch = {"rays_o": torch.from_numpy(o), "rays_d": torch.from_numpy(d),
             "images": torch.zeros(8, 3)}
    with pytest.raises(ValueError):
        ttr.make_batch_loss_fn(tv, t_make_spec(tv))(
            field, state, batch, torch.tensor([-2.0] * 3 + [2.0] * 3))
