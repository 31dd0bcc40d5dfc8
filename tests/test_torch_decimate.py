"""Parity of the port's folded budget decimation + compaction
(raw_ngp_torch.kernels.compact.decimate_compact) with the JAX package's
chain, bit for bit (tolerance 0), forward and gradients.

The JAX side is the render's chain written out with jnp:
``raw_ngp_tpu/render/occupancy.py:836`` (mask & ~miss) and ``:880-885``
(valid total, stride, the row scan, ``% stride``, dt * stride), then JAX's
own ``compact_positions_attrs`` (``:618``, its CPU path: compact_positions
+ gather_flat_sorted) and the ray ids and counts of ``:919-920`` and
``:950``. The port side is ``decimate_compact`` on CPU tensors (its plain
version, ``decimate_compact_plain``) and the render entry. The CUDA
kernels are held against the plain version on the card in
tests/test_torch_kernels.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raw_ngp_torch.kernels import compact as tc
from raw_ngp_tpu.render import occupancy as jocc

from decimate_cases import DECIMATE_CASES as CASES
from decimate_cases import decimate_case as make_case


def jax_chain(mask, miss, ts, dt, m_pad):
    """The JAX package's chain (see the module docstring) -> (t_c, dt_c,
    rid, filled, counts, valid_total, num_points)."""
    N, K = mask.shape
    mask = mask & ~miss[:, None]
    valid_total = mask.sum()
    stride = jnp.maximum((valid_total + m_pad - 1) // m_pad, 1)
    k_idx = jnp.cumsum(mask.astype(jnp.int32).T, axis=0).T - 1
    mask = mask & ((k_idx % stride) == 0)
    deltas = jnp.broadcast_to(dt, (N, K)) * stride.astype(dt.dtype)
    attrs = [ts.reshape(-1), jnp.broadcast_to(deltas, (N, K)).reshape(-1)]
    mask, _, pos, (t_c, dt_c) = jocc.compact_positions_attrs(mask, m_pad,
                                                             attrs)
    M = N * K
    filled = pos < M
    rid = jnp.where(filled, jnp.minimum(pos, M - 1) // K, N)
    return (t_c, dt_c, rid, filled, mask.sum(axis=-1), valid_total,
            mask.sum())


def port(mask, miss, ts, dt, m_pad, grad=False):
    N, K = mask.shape
    ts_t = torch.from_numpy(ts).requires_grad_(grad)
    dt_t = torch.from_numpy(dt).requires_grad_(grad)
    out = tc.decimate_compact(torch.from_numpy(mask),
                              torch.from_numpy(miss)[:, None], ts_t,
                              dt_t.expand(N, K), m_pad)
    return out, ts_t, dt_t


def assert_bits(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, what
    if a.dtype == np.float32:
        np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32),
                                      err_msg=what)
    else:
        np.testing.assert_array_equal(a.astype(np.int64),
                                      b.astype(np.int64), err_msg=what)


NAMES = ("t_c", "dt_c", "rid", "filled", "counts", "valid_total",
         "num_points")


@pytest.mark.parametrize("K", [64, 40])
@pytest.mark.parametrize("name", CASES)
def test_forward_matches_jax_chain(name, K):
    mask, miss, ts, dt, m_pad = make_case(name, 96, K)
    ref = jax_chain(jnp.asarray(mask), jnp.asarray(miss), jnp.asarray(ts),
                    jnp.asarray(dt), m_pad)
    out, _, _ = port(mask, miss, ts, dt, m_pad)
    for what, a, b in zip(NAMES, out, ref):
        assert_bits(a.numpy(), b, f"{name} K={K}: {what}")
    assert out[2].dtype == torch.int32 and out[3].dtype == torch.bool
    assert out[4].dtype == torch.int64 and out[5].ndim == out[6].ndim == 0
    stride = max(-(-int(out[5]) // m_pad), 1)
    assert stride == {"stride1": 1, "stride2": 2, "stride3": 3,
                      "backstop": 2}.get(name, stride)
    if name == "backstop":       # rounding up per ray overflows the budget
        assert int(-(-(mask.sum(1)) // 2).sum()) > m_pad
        assert int(out[6]) == m_pad and bool(out[3].all())
    if name in ("empty", "all_miss"):
        assert int(out[6]) == 0 and not bool(out[3].any())
        assert (out[2] == 96).all() and (out[0] == 0).all()


@pytest.mark.parametrize("K", [64, 40])
@pytest.mark.parametrize("name", CASES)
def test_gradients_match_jax_vjp(name, K):
    """The gradients of <t_c, g_t> + <dt_c, g_dt> against jax.vjp of the
    same chain. In ts and in the broadcast deltas [N, K] (what reaches the
    march's dt.expand): bit for bit, tolerance 0. In dt [N, 1] it is that
    [N, K] gradient summed over K by the expand's backward, torch's
    reduction in the port and XLA's in JAX: two f32 sums of the same terms
    in different orders, so within 2^-20 of the terms' absolute sum, and
    bit for bit torch's own sum of the per-sample gradient."""
    mask, miss, ts, dt, m_pad = make_case(name, 96, K, seed=1)
    N = mask.shape[0]
    rng = np.random.default_rng(2)
    g = rng.standard_normal((2, m_pad)).astype(np.float32)

    def f(ts_j, deltas_j):
        return jax_chain(jnp.asarray(mask), jnp.asarray(miss), ts_j,
                         deltas_j, m_pad)[:2]

    deltas = np.broadcast_to(dt, (N, K))
    _, vjp = jax.vjp(f, jnp.asarray(ts), jnp.asarray(deltas))
    g_ts, g_deltas = vjp((jnp.asarray(g[0]), jnp.asarray(g[1])))
    _, vjp_dt = jax.vjp(lambda d: f(jnp.asarray(ts), d)[1], jnp.asarray(dt))
    (g_dt,) = vjp_dt(jnp.asarray(g[1]))

    ts_t = torch.from_numpy(ts).requires_grad_()
    dt_t = torch.from_numpy(dt).requires_grad_()
    deltas_t = dt_t.expand(N, K)
    deltas_t.retain_grad()
    out = tc.decimate_compact(torch.from_numpy(mask),
                              torch.from_numpy(miss)[:, None], ts_t,
                              deltas_t, m_pad)
    (out[0] * torch.from_numpy(g[0])
     + out[1] * torch.from_numpy(g[1])).sum().backward()
    assert_bits(ts_t.grad.numpy(), g_ts, f"{name} K={K}: d ts")
    assert_bits(deltas_t.grad.numpy(), g_deltas, f"{name} K={K}: d deltas")
    assert_bits(dt_t.grad.numpy(),
                deltas_t.grad.sum(1, keepdim=True).numpy(), "d dt")
    mass = np.abs(np.asarray(g_deltas)).sum(1, keepdims=True)
    assert (np.abs(dt_t.grad.numpy() - np.asarray(g_dt))
            <= 2.0 ** -20 * mass).all(), f"{name} K={K}: d dt"


def test_plain_flag_and_render_entry():
    """``plain=True`` is the plain version on any device, and the render
    reads every output of the fold: its training outputs num_points and
    num_points_raw are the fold's."""
    from test_torch_train import mini_cfg

    import raw_ngp_torch.config as tcfg
    from raw_ngp_torch.models.ngp import init_field, make_field_spec
    from raw_ngp_torch.ops.grid import packbits
    from raw_ngp_torch.ops.rays import near_far_from_aabb
    from raw_ngp_torch.render.occupancy import march_rays, render_occupancy

    mask, miss, ts, dt, m_pad = make_case("stride2", 64, 64)
    a, _, _ = port(mask, miss, ts, dt, m_pad)
    b = tc.decimate_compact(torch.from_numpy(mask),
                            torch.from_numpy(miss), torch.from_numpy(ts),
                            torch.from_numpy(dt).expand(64, 64), m_pad,
                            plain=True)
    for what, x, y in zip(NAMES, a, b):
        assert_bits(x.numpy(), y.numpy(), what)

    cfg = mini_cfg(tcfg)
    field = init_field(make_field_spec(cfg), seed=0, device="cpu")
    rng = np.random.default_rng(3)
    N = 128
    ro = torch.from_numpy(rng.uniform(-0.2, 0.2, (N, 3)).astype(np.float32))
    ro[:, 2] -= 2.5
    rd = torch.nn.functional.normalize(torch.from_numpy(
        (rng.standard_normal((N, 3)) * 0.3 + [0, 0, 1]).astype(np.float32)),
        dim=-1)
    aabb = torch.tensor([-1.0, -1.0, -1.0, 1.0, 1.0, 1.0])
    bits = packbits(torch.from_numpy(
        rng.random((cfg.cascades, cfg.render.grid_size ** 3)).astype(
            np.float32)), 0.5)
    with torch.no_grad():
        out = render_occupancy(field, ro, rd, aabb, bits, training=True,
                               point_budget=256)
    r = cfg.render
    nears, fars = near_far_from_aabb(ro, rd, aabb, r.min_near)
    miss_r = fars >= 1e8
    m = march_rays(ro, rd, bits, torch.where(miss_r, 1.0, nears),
                   torch.where(miss_r, 1.001, fars), r.bound, r.grid_size,
                   cfg.cascades, r.march_candidates, r.samples_per_ray,
                   r.coarse_probes, march_cdf=r.march_cdf)
    ref = tc.decimate_compact_plain(m["mask"], miss_r, m["ts"],
                                    m["deltas"], 256)
    assert int(ref[5]) > 256        # over budget: the decimation runs
    assert int(out["num_points"]) == int(ref[6])
    assert int(out["num_points_raw"]) == int(ref[5])
    assert out["num_points"].dtype == out["num_points_raw"].dtype \
        == torch.int64
