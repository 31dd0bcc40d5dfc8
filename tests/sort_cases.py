"""The radix sort's test cases (raw_ngp_torch.kernels.sort.sort_keys),
shared by its CPU tests (tests/test_torch_sort.py) and its card tests
(tests/test_torch_kernels.py). numpy only.
"""

import numpy as np

from raw_ngp_torch.kernels.sort import TILE

SORT_CASES = ("random", "all_equal", "descending", "ascending",
              "few_distinct", "runs", "extremes")
SORT_BITS = (1, 9, 10, 13, 19, 31)
# around the kernel's tile: empty, one key, a tile less one, a tile, a
# tile and one, three tiles and a partial one
SORT_SIZES = (0, 1, TILE - 1, TILE, TILE + 1, 3 * TILE + 5)


def sort_case(name, M, bits, seed=0):
    """Seeded keys [M] int32 (numpy) and the offset they carry: keys -
    offset lies in [0, 2^bits). random: uniform; all_equal: one value;
    descending / ascending: a ramp over the range; few_distinct: three
    values, so long runs of equal keys straddle the tiles; runs: the
    window records' shape, runs of 1-40 equal keys (consecutive samples
    of a ray in one cell) at random values; extremes: only 0 and 2^bits -
    1. The offset is 12345 (a level's first row), -3 at 31 bits (so the
    keys stay in int32)."""
    rng = np.random.default_rng([seed, M, bits, SORT_CASES.index(name)])
    top = (1 << bits) - 1
    if name == "random":
        k = rng.integers(0, top, M, endpoint=True)
    elif name == "all_equal":
        k = np.full(M, rng.integers(0, top, endpoint=True))
    elif name == "descending":
        k = (np.arange(M)[::-1] * max(top // max(M, 1), 1)) % (top + 1)
    elif name == "ascending":
        k = (np.arange(M) * max(top // max(M, 1), 1)) % (top + 1)
    elif name == "few_distinct":
        k = rng.choice(rng.integers(0, top, 3, endpoint=True), M)
    elif name == "runs":
        lengths = rng.integers(1, 41, M // 10 + 1)
        values = rng.integers(0, top, M // 10 + 1, endpoint=True)
        k = np.resize(np.repeat(values, lengths), M)
    else:
        k = rng.choice(np.array([0, top]), M)
    offset = -3 if bits == 31 else 12345
    return (k.astype(np.int64) + offset).astype(np.int32), offset
