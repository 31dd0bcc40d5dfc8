"""Parity of the port's sorted segment totals (raw_ngp_torch.kernels.segsum,
the plain version of kernel B2) with the JAX package's Pallas kernel in
interpret mode (raw_ngp_tpu/kernels/segsum_pallas.py), on the CPU.

The JAX CPU fallback of the table gradient (_segment_sum_sorted_scatter)
rounds the totals to bf16, which the TPU kernel does not, so the
reference here is the Pallas kernel itself, interpreted
(``segsum_pallas.FORCE_INTERPRET``, set back in a ``finally``). Both sides
get the same sorted stream. The streams mirror tests/test_segsum_pallas.py:
random keys, a single segment holding most records (a dense level's skew),
records on 512-row block and 1024-record tile boundaries, and empty rows,
which must be exactly 0. Tolerances: the inputs and products are bf16 on
both sides and only the order of the f32 additions differs, so rtol 1e-5
(1e-4 on the ~8000-term row of the skew stream).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raw_ngp_tpu.kernels.segsum_pallas as sp
from raw_ngp_torch.kernels import segsum as ts
from raw_ngp_tpu.kernels.hash_fused import _pack_bf16_pairs


def _interpret(fn, *args):
    sp.FORCE_INTERPRET = True
    try:
        return np.asarray(fn(*args))
    finally:
        sp.FORCE_INTERPRET = False


def _sorted_stream(keys, chans):
    order = np.argsort(keys, kind="stable")
    return (np.asarray(keys)[order].astype(np.int32),
            [np.asarray(c)[order].astype(np.float32) for c in chans])


def _channel_pair(keys, chans, n_rows):
    keys_s, chans_s = _sorted_stream(keys, chans)
    packed_j = _pack_bf16_pairs([jnp.asarray(c) for c in chans_s])
    out_j = _interpret(sp.segment_totals_pallas, jnp.asarray(keys_s),
                       packed_j, n_rows, len(chans))
    packed_t = torch.stack(ts.pack_bf16_pairs(
        [torch.from_numpy(c) for c in chans_s]))
    out_t = ts.segment_totals_plain(torch.from_numpy(keys_s), packed_t,
                                    n_rows, len(chans)).numpy()
    return out_t, out_j


def _outer_pair(keys, w0, w1, g, n_rows):
    """The outer stream (word 0 = (w0, w1), words 1.. = the C g-channels),
    through the Pallas kernel and through the port's plain version with
    the identity permutation (payload already in sorted order)."""
    C = g.shape[1]
    keys_s, (w0s, w1s, *gs) = _sorted_stream(keys, [w0, w1] + list(g.T))
    w_j = _pack_bf16_pairs([jnp.asarray(w0s), jnp.asarray(w1s)])[0]
    g_j = _pack_bf16_pairs([jnp.asarray(c) for c in gs])
    out_j = _interpret(sp.segment_totals_outer_pallas, jnp.asarray(keys_s),
                       w_j, g_j, n_rows, C)
    M = keys_s.shape[0]
    w_t = ts.pack_bf16_pairs([torch.from_numpy(w0s),
                              torch.from_numpy(w1s)])[0]
    g_t = torch.stack(ts.pack_bf16_pairs([torch.from_numpy(c) for c in gs]),
                      dim=1)
    out_t = ts.segment_totals_outer(
        torch.from_numpy(keys_s), torch.arange(M, dtype=torch.int32), w_t,
        g_t, n_rows, C).numpy()
    return out_t, out_j


@pytest.mark.parametrize("n_chan", [2, 4, 8, 16])
def test_random_stream(n_chan):
    rng = np.random.default_rng(0)
    M, n_rows = 4096, 1400          # 3 blocks, partial last block
    keys = rng.integers(0, n_rows, M)
    chans = [rng.standard_normal(M).astype(np.float32)
             for _ in range(n_chan)]
    out_t, out_j = _channel_pair(keys, chans, n_rows)
    np.testing.assert_allclose(out_t, out_j, rtol=1e-5, atol=1e-5)
    empty = np.setdiff1d(np.arange(n_rows), keys)
    assert empty.size and np.all(out_t[empty] == 0)


@pytest.mark.parametrize("C", [1, 2, 8, 16])
def test_outer_random_stream(C):
    rng = np.random.default_rng(4)
    M, n_rows = 3072, 1300
    keys = rng.integers(0, n_rows, M)
    w0, w1 = rng.random((2, M)).astype(np.float32)
    g = rng.standard_normal((M, C)).astype(np.float32)
    out_t, out_j = _outer_pair(keys, w0, w1, g, n_rows)
    assert out_t.shape == (n_rows, 2 * C)
    np.testing.assert_allclose(out_t, out_j, rtol=1e-5, atol=1e-5)
    empty = np.setdiff1d(np.arange(n_rows), keys)
    assert empty.size and np.all(out_t[empty] == 0)


def test_outer_dense_skew_single_segment():
    """One row owns almost every record (a dense level's funnel) and the
    segment spans many tiles."""
    rng = np.random.default_rng(1)
    M, n_rows = 8192, 600
    keys = np.concatenate([np.full(M - 100, 7), rng.integers(0, n_rows, 100)])
    w0, w1 = rng.random((2, M)).astype(np.float32)
    g = rng.standard_normal((M, 4)).astype(np.float32)
    out_t, out_j = _outer_pair(keys, w0, w1, g, n_rows)
    np.testing.assert_allclose(out_t, out_j, rtol=1e-4, atol=5e-4)


def test_block_and_tile_boundaries():
    """Records exactly at R and TK multiples, plus empty 512-row blocks."""
    n_rows = 5 * sp._R              # 5 blocks; blocks 1 and 3 empty
    keys = np.array([0, 0, sp._R - 1, sp._R - 1, 2 * sp._R, 2 * sp._R + 1,
                     4 * sp._R, n_rows - 1] * 300)
    rng = np.random.default_rng(2)
    w0, w1 = rng.random((2, keys.size)).astype(np.float32)
    g = rng.standard_normal((keys.size, 2)).astype(np.float32)
    out_t, out_j = _outer_pair(keys, w0, w1, g, n_rows)
    np.testing.assert_allclose(out_t, out_j, rtol=1e-5, atol=1e-4)
    assert np.all(out_t[sp._R:2 * sp._R] == 0)
    assert np.all(out_t[3 * sp._R:4 * sp._R] == 0)


def test_outer_reads_payload_through_permutation():
    """The kernel's calling form: unsorted window-major records (m = window
    * B + point) read through the sort permutation, g per point. Equal to
    the sorted-payload form above on the same records."""
    rng = np.random.default_rng(5)
    B, nw, C, n_rows = 700, 4, 8, 900
    keys = rng.integers(0, n_rows, nw * B).astype(np.int32)
    w0, w1 = rng.random((2, nw * B)).astype(np.float32)
    g = rng.standard_normal((B, C)).astype(np.float32)
    keys_t = torch.from_numpy(keys)
    keys_s, perm = torch.sort(keys_t, stable=True)
    w_t = ts.pack_bf16_pairs([torch.from_numpy(w0), torch.from_numpy(w1)])[0]
    g_t = torch.stack(ts.pack_bf16_pairs(
        [torch.from_numpy(c) for c in g.T]), dim=1)
    out_perm = ts.segment_totals_outer(keys_s, perm.to(torch.int32), w_t,
                                       g_t, n_rows, C).numpy()
    out_ref, out_j = _outer_pair(keys, w0, w1, np.tile(g, (nw, 1)), n_rows)
    np.testing.assert_allclose(out_perm, out_ref, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(out_perm, out_j, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("C", [1, 2, 8, 16])
def test_outer_flat_gradient_matches_jax(C):
    """The flat form of the outer mode (segment_grad_outer on CPU tensors,
    i.e. segment_grad_outer_plain) against JAX's window-level gradient:
    the interpreted Pallas totals, then g0 + shift(g1)
    (hash_fused.py:682-686). Rows 0 and n_rows - 1 hold records (row 0
    receives no G1, the last row's G1 is dropped); rows no record reaches
    directly or through G1 are exactly 0."""
    rng = np.random.default_rng(6)
    M, n_rows = 3072, 1300
    keys = np.concatenate([[0, 0, n_rows - 1], rng.integers(0, n_rows,
                                                              M - 3)])
    w0, w1 = rng.random((2, M)).astype(np.float32)
    g = rng.standard_normal((M, C)).astype(np.float32)
    keys_s, (w0s, w1s, *gs) = _sorted_stream(keys, [w0, w1] + list(g.T))
    totals_j = _interpret(
        sp.segment_totals_outer_pallas, jnp.asarray(keys_s),
        _pack_bf16_pairs([jnp.asarray(w0s), jnp.asarray(w1s)])[0],
        _pack_bf16_pairs([jnp.asarray(c) for c in gs]), n_rows, C)
    flat_j = (totals_j[:, :C] + np.concatenate(
        [np.zeros((1, C), np.float32), totals_j[:-1, C:]])).reshape(-1)
    w_t = ts.pack_bf16_pairs([torch.from_numpy(w0s),
                              torch.from_numpy(w1s)])[0]
    g_t = torch.stack(ts.pack_bf16_pairs([torch.from_numpy(c) for c in gs]),
                      dim=1)
    args = (torch.from_numpy(keys_s), torch.arange(M, dtype=torch.int32),
            w_t, g_t, n_rows, C)
    out = torch.full((n_rows * C,), float("nan"))
    assert ts.segment_grad_outer(*args, out=out) is out
    np.testing.assert_array_equal(
        out.numpy(), ts.segment_grad_outer_plain(*args).numpy())
    np.testing.assert_allclose(out.numpy(), flat_j, rtol=1e-5, atol=1e-5)
    reached = np.zeros(n_rows, bool)
    reached[keys] = True
    reached[np.minimum(keys + 1, n_rows - 1)] = True
    assert (~reached).any()
    assert np.all(out.numpy().reshape(n_rows, C)[~reached] == 0)


def test_pack_truncates_and_products_round():
    """Packing keeps the top 16 bits (truncation, like _pack_bf16_pairs),
    and the outer products round to the nearest bf16."""
    rng = np.random.default_rng(3)
    chans = [rng.standard_normal(256).astype(np.float32) for _ in range(5)]
    words_t = ts.pack_bf16_pairs([torch.from_numpy(c) for c in chans])
    words_j = _pack_bf16_pairs([jnp.asarray(c) for c in chans])
    for wt, wj in zip(words_t, words_j):
        np.testing.assert_array_equal(wt.numpy().view(np.uint32),
                                      np.asarray(wj))
    back = ts.unpack_bf16_pairs(words_t, 5)
    for c, b in zip(chans, back):
        trunc = (c.view(np.uint32) & np.uint32(0xFFFF0000)).view(np.float32)
        np.testing.assert_array_equal(b.numpy(), trunc)
    x = torch.tensor([1.0 + 2.0 ** -8, 1.0 + 3 * 2.0 ** -8])
    np.testing.assert_array_equal(ts.round_bf16(x).numpy(),
                                  [1.0, 1.0 + 2.0 ** -6])
    np.testing.assert_array_equal(
        ts.unpack_bf16_pairs(ts.pack_bf16_pairs([x]), 1)[0].numpy(),
        [1.0, 1.0 + 2.0 ** -7])
