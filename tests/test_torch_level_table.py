"""The encode kernels' level table (``kernels/hash_encode._level_table``)
on the CPU: its first 11 columns are ``level_layout``'s, and the moduli's
constants it adds reduce every uint32 exactly as ``%`` does.

The card's reduction (``mod_u32`` in ``csrc/hash_encode.cu``) is emulated
here with numpy's wrapping uint64 arithmetic: ``x & mask`` where the
divisor is a power of two, else Lemire's fastmod, the high 64 bits of
``lo64(magic * x) * d`` formed from 32-bit halves as ``__umul64hi`` forms
them. No JAX: the reference here is Python's ``%`` and the port's own
``_level_indices``.
"""

import numpy as np
import pytest
import torch

from raw_ngp_torch import Config
from raw_ngp_torch.kernels.hash_encode import (LEVEL_COLUMNS, _MODES,
                                               _level_table, level_pairable,
                                               level_windows, matmul_split,
                                               mod_constants)
from raw_ngp_torch.models.ngp import make_field_spec
from raw_ngp_torch.ops.hashgrid import (HashGridSpec, _level_indices,
                                        level_layout)

from test_torch_kernels import _ENCODE_SPECS

_U32 = (1 << 32) - 1


def _grids():
    """(name, spec) of every grid the port runs: the -O grid, the -O2
    radiance and proposal grids, the flagship's, and the card tests'
    _ENCODE_SPECS at every channel count whose layout differs."""
    o2 = make_field_spec(Config().with_preset_O2())
    out = {
        "O": make_field_spec(Config().with_preset_O()).grid_spec,
        "O2": o2.grid_spec,
        "flagship": make_field_spec(
            Config().with_preset_O().with_tpu_profile()).grid_spec,
    }
    for i, spec in enumerate(o2.prop_specs):
        out[f"O2_proposal{i}"] = spec
    for name, kw in _ENCODE_SPECS.items():
        for C in (2, 16):
            out[f"{name}_C{C}"] = HashGridSpec.create(level_dim=C, **kw)
    return out


_GRIDS = _grids()


def device_mod(x, d, mask, magic):
    """The card's x % d for uint32 x [n] (numpy uint64), from the table's
    (mask, magic): x & mask, or hi64(lo64(magic * x) * d)."""
    x = x.astype(np.uint64)
    if (mask & _U32) != _U32:
        return x & np.uint64(mask)
    with np.errstate(over="ignore"):
        lo = np.uint64(magic % 2 ** 64) * x          # wraps mod 2^64
        lo_hi, lo_lo = lo >> np.uint64(32), lo & np.uint64(_U32)
        d = np.uint64(d)
        return (lo_hi * d + ((lo_lo * d) >> np.uint64(32))) >> np.uint64(32)


def _values(d, n=1 << 14, seed=0):
    """n random uint32 and the edges 0, 1, d - 1, d, d + 1, 2^31, 2^32 - 1
    and the multiples of d next to 2^32."""
    rng = np.random.default_rng(seed)
    top = (_U32 // d) * d
    edges = [0, 1, d - 1, d, d + 1, 1 << 31, _U32, top - 1, top]
    edges = [e for e in edges if 0 <= e <= _U32]
    return np.concatenate([rng.integers(0, _U32, n, dtype=np.uint64,
                                        endpoint=True),
                           np.array(edges, dtype=np.uint64)])


def _columns(spec):
    table = _level_table(spec, matmul_split(spec), torch.device("cpu"))
    assert table.dtype == torch.int64
    assert table.shape == (spec.num_levels, len(LEVEL_COLUMNS))
    return [dict(zip(LEVEL_COLUMNS, row)) for row in table.tolist()]


@pytest.mark.parametrize("name", sorted(_GRIDS))
def test_level_table_moduli_match_remainder(name):
    """For every level: the card's reduction read from the table equals
    x % hmap, and on the additive hash's levels x % (hmap - res), at
    random uint32 values and the edges 0, d - 1, d, 2^32 - 1 (and the
    multiples of d next to 2^32)."""
    spec = _GRIDS[name]
    for lv, col in enumerate(_columns(spec)):
        divisors = [(col["hmap"], col["hmap_mask"], col["hmap_magic"])]
        if col["mode"] == _MODES["additive"]:
            divisors.append((col["hmap"] - col["res"], col["add_mask"],
                             col["add_magic"]))
        for d, mask, magic in divisors:
            assert 1 <= d <= _U32
            x = _values(d, seed=lv)
            want = x % np.uint64(d)
            got = device_mod(x, d, mask, magic)
            assert np.array_equal(got, want), (name, lv, d)
            # the fastmod alone, also where a mask serves the level
            assert np.array_equal(device_mod(x, d, -1, magic), want)


@pytest.mark.parametrize("name", sorted(_GRIDS))
def test_level_table_layout_columns(name):
    """The first 11 columns are level_layout's (res, hmap, offset, the
    strides padded with 0, mode, pair axis), pairability and the first
    window (-1 on the dense matmul levels), as before the moduli's
    columns were added."""
    spec = _GRIDS[name]
    m = matmul_split(spec)
    first = {lv: w0 for lv, w0, _ in level_windows(spec, m)}
    for lv, col in enumerate(_columns(spec)):
        res, hmap, offset, strides, mode, axis = level_layout(spec, lv)
        s = list(strides) + [0] * (3 - len(strides))
        want = [res, hmap, offset, len(strides), *s, _MODES[mode], axis,
                int(level_pairable(spec, lv)), first.get(lv, -1)]
        assert [col[k] for k in LEVEL_COLUMNS[:11]] == want, (name, lv)
        assert (col["hmap_mask"], col["hmap_magic"]) == mod_constants(hmap)


def _device_rows(col, corners):
    """The card's level_row (csrc/hash_encode.cu) in numpy uint32
    arithmetic from one level's table row, for corners [n, 3]."""
    c = corners.astype(np.uint64)
    m32 = np.uint64(_U32)
    with np.errstate(over="ignore"):
        if col["mode"] == _MODES["additive"]:
            primes = (3674653429, 2654435761, 805459861)
            g = np.zeros(len(c), dtype=np.uint64)
            for d in range(3):
                if d != col["axis"]:
                    g ^= (c[:, d] * np.uint64(primes[d])) & m32
            g = device_mod(g, col["hmap"] - col["res"], col["add_mask"],
                           col["add_magic"])
            index = (c[:, col["axis"]] + g) & m32
        elif col["mode"] == _MODES["xor"]:
            index = (c[:, 0] ^ ((c[:, 1] * np.uint64(2654435761)) & m32)
                     ^ ((c[:, 2] * np.uint64(805459861)) & m32))
        else:
            index = np.zeros(len(c), dtype=np.uint64)
            for d in range(col["n_strides"]):
                index = (index + c[:, d] * np.uint64(col[f"stride{d}"])) & m32
    return (device_mod(index, col["hmap"], col["hmap_mask"],
                       col["hmap_magic"]) + np.uint64(col["offset"]))


@pytest.mark.parametrize("name", sorted(_GRIDS))
def test_level_table_rows_match_level_indices(name):
    """The card's whole index computation, read from the table, gives
    _level_indices' rows at random corners of every level (every corner
    coordinate in [0, res))."""
    spec = _GRIDS[name]
    rng = np.random.default_rng(1)
    for lv, col in enumerate(_columns(spec)):
        corners = rng.integers(0, col["res"], (4096, 3), dtype=np.int64)
        corners[0], corners[1] = 0, col["res"] - 1
        want = _level_indices(spec, lv, torch.from_numpy(corners)).numpy()
        got = _device_rows(col, corners)
        assert np.array_equal(got.astype(np.int64), want), (name, lv)


@pytest.mark.parametrize("d", [1, 2, 3, 5, 7, 127, 4096, 4097, 65535,
                               (1 << 19) - 16, 1 << 19, (1 << 31) - 1,
                               1 << 31, (1 << 31) + 1, _U32 - 1, _U32])
def test_mod_constants_edge_divisors(d):
    """mod_constants at divisors beyond the grids': 1 (magic wraps to 0),
    powers of two, odd and even non-powers, and the largest uint32s."""
    mask, magic = mod_constants(d)
    assert (mask == d - 1) == (d & (d - 1) == 0)
    assert -2 ** 63 <= magic < 2 ** 63
    x = _values(d, n=1 << 12, seed=d % 1000)
    want = x % np.uint64(d)
    assert np.array_equal(device_mod(x, d, mask, magic), want)
    assert np.array_equal(device_mod(x, d, -1, magic), want)
