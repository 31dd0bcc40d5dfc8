"""Stable radix sort of int32 keys over the bits that vary: the wrapper of
``csrc/radix_sort.cu`` and its plain version.

Replaces ``torch.sort(keys, stable=True)`` where the table gradient sorts
(:func:`~raw_ngp_torch.kernels.hash_encode.table_grad`'s window levels,
:func:`~raw_ngp_torch.kernels.hash_encode.mm_grad_level`'s dense cells),
which stood for JAX's ``jax.lax.sort`` at
``raw_ngp_tpu/kernels/hash_fused.py:659`` / ``:669`` (not Pallas).
:func:`sort_keys` gives exactly ``torch.sort(keys - offset, stable=True)``
with the indices narrowed to int32, for keys with ``keys - offset`` in
[0, 2^bits), so the kernels after it receive the same streams.

The kernel is a onesweep LSD radix sort (see the note in the source):
``ceil(bits / 10)`` digit passes of at most 10 bits split evenly
(:func:`digit_passes`), one launch a pass after a first kernel that
counts every pass's digits; each pass ranks a tile of :data:`TILE` keys
stably and finds the tile's global offsets by a look-back over the
tile-by-digit counts. :func:`sort_keys_plain` repeats that arithmetic in
plain torch: the same passes, per pass the tile-by-digit counts, their
exclusive scan in digit-major, tile order, and each key's stable rank
among its tile's keys of its digit. CPU tensors take the plain version;
CUDA tensors launch the kernel or the call raises. Bound on the card:
bytes, 12 B a record (the key read, the sorted key and its index
written).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from raw_ngp_torch.kernels import _build

TILE = 8192            # keys a tile (a block of the pass kernel)
MAX_DIGIT_BITS = 10    # bits a pass at most


def digit_passes(bits: int):
    """[(shift, width)] of the passes over the low ``bits`` bits:
    ceil(bits / 10) digits, the wider first where bits do not divide
    evenly (19: 10 + 9; 13: 7 + 6; 31: 8 + 8 + 8 + 7)."""
    n = -(-bits // MAX_DIGIT_BITS)
    base, extra = divmod(bits, n)
    out, shift = [], 0
    for i in range(n):
        width = base + (1 if i < extra else 0)
        out.append((shift, width))
        shift += width
    return out


def _check_args(keys, bits: int, offset: int, who: str):
    if keys.dtype != torch.int32 or keys.ndim != 1:
        raise TypeError(f"{who}: keys must be a 1-d int32 tensor")
    if not 1 <= bits <= 31:
        raise ValueError(f"{who}: bits must be in [1, 31], got {bits}")
    if not -2 ** 31 <= offset < 2 ** 31:
        raise ValueError(f"{who}: offset must fit int32, got {offset}")
    if keys.numel() >= 2 ** 30:
        raise ValueError(f"{who}: at most 2^30 - 1 keys, got "
                         f"{keys.numel()}")


def out_of_range_plain(keys, bits: int, offset: int = 0):
    """How many of ``keys - offset`` lie outside [0, 2^bits): 0-d i64."""
    k = keys.to(torch.int64) - offset
    return ((k < 0) | (k >= 1 << bits)).sum()


def sort_keys_plain(keys, bits: int, offset: int = 0):
    """Plain version of :func:`sort_keys`, on any device: per pass of
    :func:`digit_passes`, the digits of the current order, the counts of
    each (tile of :data:`TILE`, digit) and their exclusive scan in
    digit-major, tile order (the global start of each tile's run of a
    digit: the kernel's histogram and look-back), and each key's stable
    rank among its tile's keys of its digit (a stable sort by (tile,
    digit), which is the order the kernel's shared-memory ranking gives).
    Keys outside the range are sorted by their low ``bits`` bits, as the
    kernel does. -> (keys_sorted [M] i32, perm [M] i32)."""
    _check_args(keys, bits, offset, "sort_keys_plain")
    dev = keys.device
    M = keys.numel()
    k = keys - offset if offset else keys.clone()
    perm = torch.arange(M, dtype=torch.int32, device=dev)
    if M == 0:
        return k, perm
    T = -(-M // TILE)
    idx = torch.arange(M, device=dev)
    tile = idx // TILE
    for shift, width in digit_passes(bits):
        radix = 1 << width
        group = tile * radix + ((k >> shift) & (radix - 1)).to(torch.int64)
        counts = torch.bincount(group, minlength=T * radix)
        # the start of each (tile, digit) run: digit-major, tile order
        by_digit = counts.view(T, radix).t().reshape(-1)
        start = (torch.cumsum(by_digit, 0) - by_digit).view(radix, T).t()
        # each key's stable rank inside its (tile, digit)
        order = torch.sort(group, stable=True).indices
        first = torch.cumsum(counts, 0) - counts
        rank = torch.empty_like(idx)
        rank[order] = idx - first[group[order]]
        dest = start.reshape(-1)[group] + rank
        k = torch.empty_like(k).index_copy_(0, dest, k)
        perm = torch.empty_like(perm).index_copy_(0, dest, perm)
    return k, perm


_ARGTYPES = {
    "radix_sort_layout": ([ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
                          None),
    "radix_sort": ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                   + [ctypes.c_void_p], ctypes.c_int),
}
_fns = {}


def _lib(name):
    """A C entry point of ``csrc/radix_sort.cu``, bound once."""
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(_build.load("radix_sort"), name)
        fn.argtypes, fn.restype = _ARGTYPES[name]
        _fns[name] = fn
    return fn


@functools.lru_cache(maxsize=256)
def scratch_layout(M: int, bits: int):
    """(int32 words of the kernel's scratch, the word that counts keys
    outside the range) for M > 0 keys of ``bits`` bits, from the
    source's own plan."""
    layout = (ctypes.c_int64 * 2)()
    _lib("radix_sort_layout")(M, bits, ctypes.addressof(layout))
    return int(layout[0]), int(layout[1])


def sort_keys(keys, bits: int, offset: int = 0,
              out_of_range: bool = False):
    """Sort int32 keys [M] by ``keys - offset``, stably -> (keys_sorted
    [M] i32, perm [M] i32): exactly ``torch.sort(keys - offset,
    stable=True)`` with the indices as int32, for ``keys - offset`` in [0,
    2^bits), 1 <= bits <= 31 (window levels: ``(rows - 1).bit_length()``;
    dense cells: ``(res ** 3).bit_length()``, so the sentinel res^3 sorts
    last). CPU tensors take :func:`sort_keys_plain`; CUDA tensors launch
    the kernel (one counted launch a call: 1 + ceil(bits / 10) kernels) on
    the current stream. With ``out_of_range`` a third output, the 0-d i32
    count of keys outside the range, which the kernel keeps in its scratch
    (the table gradient never reads it: its keys' range holds by
    construction)."""
    if keys.device.type == "cpu":
        out = sort_keys_plain(keys, bits, offset)
        return (*out, out_of_range_plain(keys, bits, offset).to(
            torch.int32)) if out_of_range else out
    _check_args(keys, bits, offset, "sort_keys")
    if keys.device.type != "cuda":
        raise ValueError("sort_keys: keys must be a CPU or CUDA tensor")
    keys = keys.contiguous()
    M = keys.numel()
    dev = keys.device
    keys_s = torch.empty(M, dtype=torch.int32, device=dev)
    perm = torch.empty(M, dtype=torch.int32, device=dev)
    if M == 0:
        zero = torch.zeros((), dtype=torch.int32, device=dev)
        return (keys_s, perm, zero) if out_of_range else (keys_s, perm)
    words, oor_at = scratch_layout(M, bits)
    scratch = torch.empty(words, dtype=torch.int32, device=dev)
    err = _lib("radix_sort")(
        keys.data_ptr(), keys_s.data_ptr(), perm.data_ptr(),
        scratch.data_ptr(), M, bits, offset,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"sort_keys: CUDA launch failed (error {err})")
    sort_keys.launches += 1
    if out_of_range:
        return keys_s, perm, scratch[oor_at]
    return keys_s, perm


sort_keys.launches = 0   # calls that launched the kernels
