"""Parity of the port's compaction (raw_ngp_torch.kernels.compact) with the
JAX Pallas streaming-compaction kernel, bit-exact.

The JAX side runs ``compact_attrs_pallas`` in interpret mode on the CPU
(``FORCE_INTERPRET``), as tests/test_compact_pallas.py runs it; the port
side is ``compact_attrs``, plain torch (compact_positions +
gather_flat_sorted), which the plain version of the render's fold
(``decimate_compact_plain``) builds on. The cases mirror
tests/test_compact_pallas.py. The fold's CUDA kernels are held against
that plain version in tests/test_torch_kernels.py, on the card.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import raw_ngp_tpu.kernels.compact_pallas as cp
from raw_ngp_torch.kernels import compact as tc
from raw_ngp_torch.kernels.compact import compact_positions_attrs
from raw_ngp_tpu.render.occupancy import compact_positions as j_compact_pos


def _keys_np(mask, m_pad):
    c = np.cumsum(mask.astype(np.int32)).astype(np.int32)
    kept = mask & (c <= m_pad)
    return np.where(kept, c - 1, tc.SENTINEL).astype(np.int32), c


def _jax(mask, attrs, m_pad):
    keys, c = _keys_np(mask, m_pad)
    cp.FORCE_INTERPRET = True
    try:
        pos, attrs_c = cp.compact_attrs_pallas(
            jnp.asarray(np.stack(attrs), jnp.float32), jnp.asarray(keys),
            jnp.asarray(c), m_pad)
    finally:
        cp.FORCE_INTERPRET = False
    return np.asarray(pos), np.asarray(attrs_c)


def _port(mask, attrs, m_pad):
    keys, _ = _keys_np(mask, m_pad)
    pos, attrs_c = tc.compact_attrs(torch.from_numpy(np.stack(attrs)),
                                    torch.from_numpy(keys), m_pad)
    return pos.numpy(), attrs_c.numpy()


def _assert_same(a, b):
    np.testing.assert_array_equal(a[0], b[0])
    assert (a[1].view(np.uint32) == b[1].view(np.uint32)).all()


@pytest.mark.parametrize("keep_rate", [0.03, 0.25, 0.9])
def test_random_mask_matches_pallas(keep_rate):
    rng = np.random.default_rng(7)
    M, m_pad = 5000, 1024
    mask = rng.random(M) < keep_rate
    attrs = [rng.standard_normal(M).astype(np.float32) for _ in range(2)]
    _assert_same(_port(mask, attrs, m_pad), _jax(mask, attrs, m_pad))


def test_overflow_truncates_like_pallas():
    rng = np.random.default_rng(1)
    M, m_pad = 4096, 512
    mask = rng.random(M) < 0.5
    attrs = [rng.standard_normal(M).astype(np.float32)]
    got = _port(mask, attrs, m_pad)
    _assert_same(got, _jax(mask, attrs, m_pad))
    assert (got[0] < M).all()


@pytest.mark.parametrize("fill", [False, True])
def test_empty_and_full_mask(fill):
    M, m_pad = 2048, 640
    attrs = [np.linspace(-3, 3, M, dtype=np.float32)]
    mask = np.full(M, fill)
    got = _port(mask, attrs, m_pad)
    _assert_same(got, _jax(mask, attrs, m_pad))
    if not fill:
        assert (got[0] == M).all() and (got[1] == 0.0).all()


def test_payload_bits_exact():
    vals = np.array([1e-38, -1e-38, 3.4e38, -0.0, 0.0, 1.5e-42,
                     np.float32(np.pi), -np.float32(np.e)], np.float32)
    rng = np.random.default_rng(3)
    M = 1536
    attrs = [rng.choice(vals, M).astype(np.float32)]
    mask = rng.random(M) < 0.5
    _assert_same(_port(mask, attrs, 512), _jax(mask, attrs, 512))


def test_large_flat_index_exact():
    M = (1 << 21) + 1024
    rng = np.random.default_rng(5)
    mask = np.zeros(M, bool)
    kept_idx = np.sort(rng.choice(M, 700, replace=False))
    mask[kept_idx] = True
    attrs = [np.zeros(M, np.float32)]
    got = _port(mask, attrs, 1024)
    _assert_same(got, _jax(mask, attrs, 1024))
    np.testing.assert_array_equal(got[0][:700], kept_idx)
    assert (got[0][700:] == M).all()


def test_compact_positions_and_render_entry_match_jax():
    """The plain compaction (kept, inv, pos) and
    compact_positions_attrs (the fold's plain version calls it)."""
    rng = np.random.default_rng(11)
    mask = rng.random((96, 24)) < 0.4
    m_pad = 640
    kj, ij, pj = (np.asarray(a) for a in j_compact_pos(jnp.asarray(mask),
                                                       m_pad))
    kt, it, pt = (a.numpy() for a in tc.compact_positions(
        torch.from_numpy(mask), m_pad))
    np.testing.assert_array_equal(kt, kj)
    np.testing.assert_array_equal(it, ij)
    np.testing.assert_array_equal(pt, pj)
    ts = rng.standard_normal(mask.size).astype(np.float32)
    kept, inv, pos, (t_c,) = compact_positions_attrs(
        torch.from_numpy(mask), m_pad, [torch.from_numpy(ts)])
    np.testing.assert_array_equal(kept.numpy(), kj)
    np.testing.assert_array_equal(inv.numpy(), ij)
    np.testing.assert_array_equal(pos.numpy(), pj)
    np.testing.assert_array_equal(
        t_c.numpy(), np.where(pj < mask.size,
                              ts[np.minimum(pj, mask.size - 1)], 0.0))

