"""The table gradient's radix sort (raw_ngp_torch.kernels.sort) on the
CPU: the plain version, which the wrapper takes for CPU tensors and which
repeats the kernel's passes, tile counts, look-back offsets and in-tile
ranks, held bitwise to torch.sort(stable=True) narrowed to int32 and to
numpy's stable argsort; and the table gradient's CPU path going through
it. The kernel itself is held to the same cases on the card
(tests/test_torch_kernels.py -k sort). No JAX here: the table gradient's
parity with JAX is tests/test_torch_train.py's and
tests/test_torch_proposal.py's, which now run through this sort.
"""

import numpy as np
import pytest
import torch

from raw_ngp_torch.kernels import hash_encode as th
from raw_ngp_torch.kernels import sort as tsort
from raw_ngp_torch.ops.hashgrid import HashGridSpec

from sort_cases import SORT_BITS, SORT_CASES, SORT_SIZES, sort_case


@pytest.fixture(autouse=True)
def _one_thread():
    """One torch and one BLAS thread for this module: under pytest-xdist
    (-n 6) a thread a core oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        from threadpoolctl import threadpool_limits
    except ImportError:
        yield
    else:
        with threadpool_limits(limits=1):
            yield
    torch.set_num_threads(n)


def _same(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


@pytest.mark.parametrize("M", SORT_SIZES)
@pytest.mark.parametrize("bits", SORT_BITS)
@pytest.mark.parametrize("name", SORT_CASES)
def test_plain_sort_is_torch_sort(name, bits, M):
    """sort_keys_plain(keys, bits, offset) is torch.sort(keys - offset,
    stable=True) with the indices as int32, bit for bit, and numpy's
    stable argsort; sort_keys on CPU tensors is the plain version and
    counts no launch."""
    keys_np, offset = sort_case(name, M, bits)
    keys = torch.from_numpy(keys_np)
    ref_k, ref_i = torch.sort(keys - offset, stable=True)
    got_k, got_p = tsort.sort_keys_plain(keys, bits, offset)
    assert _same(got_k, ref_k)
    assert _same(got_p, ref_i.to(torch.int32))
    order = np.argsort(keys_np.astype(np.int64) - offset, kind="stable")
    assert np.array_equal(got_p.numpy(), order)
    launches = tsort.sort_keys.launches
    k2, p2, oor = tsort.sort_keys(keys, bits, offset, out_of_range=True)
    assert tsort.sort_keys.launches == launches
    assert _same(k2, got_k) and _same(p2, got_p) and int(oor) == 0


@pytest.mark.parametrize("bits", (9, 13))
def test_plain_sort_of_keys_outside_the_range(bits):
    """Keys outside [0, 2^bits) are counted and sorted by their low bits,
    as the kernel's masked digits sort them."""
    rng = np.random.default_rng(bits)
    keys = rng.integers(-50, (1 << bits) + 50, 3 * tsort.TILE + 7)
    t = torch.from_numpy(keys.astype(np.int32))
    got_k, got_p = tsort.sort_keys_plain(t, bits)
    low = keys & ((1 << bits) - 1)
    order = np.argsort(low, kind="stable")
    assert np.array_equal(got_p.numpy(), order)
    assert np.array_equal(got_k.numpy(), keys[order])
    want = int(((keys < 0) | (keys >= 1 << bits)).sum())
    assert int(tsort.out_of_range_plain(t, bits)) == want > 0
    assert int(tsort.sort_keys(t, bits, out_of_range=True)[2]) == want


@pytest.mark.parametrize("bits,widths", [
    (1, [1]), (9, [9]), (10, [10]), (11, [6, 5]), (13, [7, 6]),
    (17, [9, 8]), (19, [10, 9]), (20, [10, 10]), (21, [7, 7, 7]),
    (30, [10, 10, 10]), (31, [8, 8, 8, 7])])
def test_digit_passes(bits, widths):
    """ceil(bits / 10) passes of at most 10 bits, the wider first, each
    shift the sum of the widths before it."""
    passes = tsort.digit_passes(bits)
    assert [w for _, w in passes] == widths
    assert [s for s, _ in passes] == list(np.cumsum([0] + widths[:-1]))
    if bits <= 20:
        assert len(passes) <= 2


def test_sort_refuses_what_the_kernel_does_not_take():
    """int32 keys of 1-31 bits only."""
    keys = torch.arange(8, dtype=torch.int32)
    with pytest.raises(TypeError):
        tsort.sort_keys(keys.long(), 4)
    for bits in (0, 32):
        with pytest.raises(ValueError):
            tsort.sort_keys(keys, bits)


def test_table_grad_sorts_through_the_plain_radix_sort(monkeypatch):
    """On the CPU the table gradient's window levels sort with
    sort_keys_plain over each level's row bits (one call a window level),
    and the dense levels' cell arithmetic with it over the cells' bits;
    the gradient is the one torch.sort's streams give."""
    spec = HashGridSpec.create(num_levels=3, level_dim=8,
                               log2_hashmap_size=12, base_resolution=16,
                               desired_resolution=64)
    calls = []
    plain = tsort.sort_keys_plain

    def counted(keys, bits, offset=0):
        calls.append((keys.numel(), bits, offset))
        return plain(keys, bits, offset)

    gen = torch.Generator().manual_seed(0)
    B = 3000
    x01 = torch.rand(B, 3, generator=gen)
    g = torch.randn(B, spec.output_dim, generator=gen)
    base, w_word = th.window_records_plain(x01, spec)
    m = th.matmul_split(spec)
    windows = th.level_windows(spec, m)
    assert m >= 1 and len(windows) >= 1
    monkeypatch.setattr(th, "sort_keys_plain", lambda keys, bits, offset=0: (
        lambda r: (r.values, r.indices.to(torch.int32)))(
            torch.sort(keys - offset, stable=True)))
    want = th.table_grad(spec, x01, base, w_word, g)
    monkeypatch.setattr(th, "sort_keys_plain", counted)
    got = th.table_grad(spec, x01, base, w_word, g)
    assert torch.equal(got, want)
    assert calls == [(nw * B, max((spec.offsets[lv + 1] - spec.offsets[lv]
                                   - 1).bit_length(), 1), spec.offsets[lv])
                     for lv, _, nw in windows]
    calls.clear()
    th.mm_grad_table_cells_plain(x01, g, spec)
    assert calls == [(B, (spec.resolutions[lv] ** 3).bit_length(), 0)
                     for lv in range(m)]
