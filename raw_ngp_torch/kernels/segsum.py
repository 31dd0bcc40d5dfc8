"""Sorted segment totals (kernel B2): wrapper of ``csrc/segsum.cu``.

Replaces the Pallas TPU kernel ``raw_ngp_tpu/kernels/segsum_pallas.py``
(``_segment_totals_impl`` ``:124``) in both of its modes: the outer mode,
reached by ``segment_totals_outer_pallas`` ``:196`` from the hash-table
gradient (``kernels/hash_fused.py:671-673``), and the channel mode,
``segment_totals_pallas`` ``:182`` (:func:`segment_totals`, plain version
:func:`segment_totals_plain`; nothing on the training path calls it). In
the outer mode, what carries over, bit for bit: the
record values are bf16 *truncations* of f32 (``hash_fused._pack_bf16_pairs``
keeps the top 16 bits), each product w*g is rounded to bf16, and the
per-row totals are exact f32 sums (rows without records are 0). Only the
order of the f32 additions may differ, and the kernel's order is fixed
(no float atomics: two calls on the same stream give the same bits).

The stream is the record stream of one hash level: ``keys_sorted`` [M]
(table rows, ascending, from ``torch.sort``) and ``perm`` [M], the
position of each sorted record in the level's window-major stream
(record m = window * B + point). The kernel reads the payload through the
permutation, as the JAX package's ``RAW_NGP_IOTA_SORT`` variant does
(``hash_fused.py:621-664``): the (w0, w1) word per record and the g words
per *point*, point m % B. The plain version takes those words packed,
``g_words`` [B, ceil(C/2)] (JAX's interface); the kernel reads the
encode's cotangent g [B, L*C] (bf16 or f32) in place, the level's C
channels from column ``g_col``, and forms each word as it stages it, the
same bits as :func:`g_words_plain` (a truncation of each channel to
bf16). The wrappers take g and ``g_col`` (or, on the CPU, the packed
words).

The plain version, :func:`segment_totals_outer_plain`, is an
``index_add_`` of the rounded products; the wrapper takes it only for
tensors on the CPU. On a CUDA tensor the kernel launches or the call
raises. Bound on the card: bytes (see the note in ``csrc/segsum.cu``).

The outer mode's flat form, :func:`segment_grad_outer` (plain version
:func:`segment_grad_outer_plain`), is what the table gradient calls per
window level: the same totals G0 | G1, bit for bit, written by the kernel
straight into the level's slice of the flat gradient as
``out[r] = G0[r] + G1[r - 1]`` (JAX's ``g0 + shift(g1)``,
``hash_fused.py:682-686``), with no ``[n_rows, 2C]`` totals tensor and no
combine pass. JAX shifts the *concatenated* totals of all window levels,
so a level's last G1 lands in the next level's first row; a call per
level drops it. That changes no bit for a finite cotangent: w1 is +0 for
every record whose base is a level's last row (``window_indices_weights``
gives w1 != 0 only where the corner is base + 1 inside the level), so
each of its products bf16(w1 * g) is a zero, the total of zeros started at
+0 is +0 under round-to-nearest, and G0 + (+0) is what the per-level call
writes (``tests/test_torch_train.py`` checks both facts). A non-finite
cotangent departs from JAX there: bf16(+0 * inf) is NaN, which JAX
carries into the next level's first row and the per-level call drops.
"""

from __future__ import annotations

import ctypes

import torch

from raw_ngp_torch.kernels import _build

_HI = -65536          # 0xFFFF0000 as an int32: the bf16 half of an f32
_CHANNELS = (1, 2, 4, 8, 16, 32)


def round_bf16(x):
    """f32 -> f32 rounded to the nearest bf16 (ties to even)."""
    return x.to(torch.bfloat16).float()


def pack_bf16_pairs(chans):
    """List of [M] f32 tensors -> list of [M] int32 words, two bf16 values
    per word: channel 2p in the high half, 2p+1 in the low
    (``hash_fused._pack_bf16_pairs``; an odd count pads with 0). Each
    value is *truncated* to bf16 (its top 16 bits, by bit operations on an
    int32 view; ``.to(torch.bfloat16)`` would round)."""
    chans = list(chans)
    if len(chans) % 2 == 1:
        chans.append(torch.zeros_like(chans[0]))
    words = []
    for c in range(0, len(chans), 2):
        hi = chans[c].float().contiguous().view(torch.int32) & _HI
        lo = (chans[c + 1].float().contiguous().view(torch.int32) >> 16) \
            & 0xFFFF
        words.append(hi | lo)
    return words


def unpack_bf16_pairs(words, n: int):
    """Inverse of :func:`pack_bf16_pairs`: the first ``n`` channels as f32."""
    chans = []
    for w in words:
        chans.append((w & _HI).view(torch.float32))
        chans.append((w << 16).view(torch.float32))
    return chans[:n]


def segment_totals_plain(keys_sorted, packed, n_rows: int, n_chan: int):
    """Per-row f32 totals of a sorted record stream whose ``n_chan``
    channels ride bf16 pairs in the int32 words ``packed`` [n_packed, M]
    (the channel mode of the Pallas kernel, ``segment_totals_pallas``):
    the plain version of :func:`segment_totals`. Returns [n_rows, n_chan]
    f32."""
    vals = torch.stack(unpack_bf16_pairs(list(packed), n_chan), dim=1)
    out = torch.zeros(n_rows, n_chan, dtype=torch.float32,
                      device=vals.device)
    return out.index_add_(0, keys_sorted.to(torch.int64), vals)


def g_words_plain(g, g_col: int, C: int):
    """B2's payload words of one level: channels g_col .. g_col + C - 1 of
    g [B, *] (f32 or bf16) as ceil(C/2) words of two truncated bf16 halves
    per point (``pack_bf16_pairs``) -> [B, ceil(C/2)] i32. The plain
    version of the kernel's in-place read of g."""
    return torch.stack(pack_bf16_pairs(
        [g[:, g_col + c] for c in range(C)]), dim=1)


def _outer_products(perm, w_word, g_words, C: int):
    """[M, 2C] bf16-rounded products of each record: w0*g then w1*g."""
    p = perm.to(torch.int64)
    w0, w1 = unpack_bf16_pairs([w_word[p]], 2)
    rows = g_words[p % g_words.shape[0]]                  # [M, ceil(C/2)]
    g = torch.stack(unpack_bf16_pairs(list(rows.T), C), dim=1)   # [M, C]
    return torch.cat([round_bf16(w0[:, None] * g),
                      round_bf16(w1[:, None] * g)], dim=1)


def segment_totals_outer_plain(keys_sorted, perm, w_word, g_words,
                               n_rows: int, C: int, out=None):
    """Plain version of the kernel: per-row f32 totals of the products
    w0*g and w1*g of a sorted outer-product record stream.

    keys_sorted [M] i32 ascending rows in [0, n_rows); perm [M] i32 record
    index of each sorted record; w_word [M_all] i32 (w0, w1) pair per
    record; g_words [B, ceil(C/2)] i32 the C g-channels per point, record
    m reading row m % B. Returns ``out`` (or a new tensor) [n_rows, 2C]
    f32: columns [0, C) total w0*g, [C, 2C) total w1*g."""
    if out is None:
        out = torch.zeros(n_rows, 2 * C, dtype=torch.float32,
                          device=keys_sorted.device)
    else:
        out.zero_()
    return out.index_add_(0, keys_sorted.to(torch.int64),
                          _outer_products(perm, w_word, g_words, C))


def combine_totals_plain(totals, out):
    """out [R * C] = G0[r] + G1[r - 1] of outer-mode totals [R, 2C]
    (JAX's ``g0 + shift(g1)``); the first row receives no G1 (+0). The
    second half of :func:`segment_grad_outer_plain`, and with the 2C
    mode's totals the flat mode's bit-exact oracle on the card."""
    C = totals.shape[1] // 2
    out.view(-1, C).copy_(totals[:, :C] + torch.cat(
        [totals.new_zeros(1, C), totals[:-1, C:]]))
    return out


def segment_grad_outer_plain(keys_sorted, perm, w_word, g_words,
                             n_rows: int, C: int, out=None):
    """Plain version of :func:`segment_grad_outer`: the totals of
    :func:`segment_totals_outer_plain`, then :func:`combine_totals_plain`
    -> ``out`` (or a new tensor) [n_rows * C] f32."""
    if out is None:
        out = torch.empty(n_rows * C, dtype=torch.float32,
                          device=keys_sorted.device)
    return combine_totals_plain(segment_totals_outer_plain(
        keys_sorted, perm, w_word, g_words, n_rows, C), out)


def _lib(name="segment_totals_outer_fwd"):
    lib = _build.load("segsum")
    fn = getattr(lib, name)
    if name in ("segment_totals_outer_fwd", "segment_grad_outer_fwd"):
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64] \
            + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2 \
            + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    else:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 \
            + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def edge_buffer(M: int, width: int, device):
    """Scratch of the kernels' fixed-order chunk edges
    (``csrc/segments.cuh``) for a sorted stream of M records whose rows
    are ``width`` f32: head and tail partials of each 128-record chunk
    (``segments::kChunk``), then the sums of each group of 32 chunks
    (``segments::kGroup``) -> (buffer, chunks)."""
    n = -(-M // 128)
    return torch.empty(2 * n + -(-n // 32), width, dtype=torch.float32,
                       device=device), n


def flat_edge_buffer(M: int, C: int, device):
    """Scratch of the outer mode's flat form for M records: the edge rows
    of :func:`edge_buffer` (width 2C), then per chunk the first and last
    plain segments' G0 | G1 and the total of the row that starts there and
    crosses (2C each), then four int32 words per chunk, flat f32 ->
    (buffer, chunks)."""
    n = -(-M // 128)
    return torch.empty((4 * n + -(-n // 32)) * 2 * C + 4 * n,
                       dtype=torch.float32, device=device), n


def segment_totals(keys_sorted, packed, n_rows: int, n_chan: int):
    """Per-row f32 totals of the ``n_chan`` bf16 channels of a sorted
    record stream: keys_sorted [M] i32 ascending rows in [0, n_rows),
    packed [ceil(n_chan/2), M] i32 words (``pack_bf16_pairs``) ->
    [n_rows, n_chan] f32, rows without records 0. CPU tensors take
    :func:`segment_totals_plain`; CUDA tensors launch the kernel."""
    if keys_sorted.device.type == "cpu":
        return segment_totals_plain(keys_sorted, packed, n_rows, n_chan)
    dev = keys_sorted.device
    M = keys_sorted.shape[0]
    if dev.type != "cuda" or packed.device != dev:
        raise ValueError("segment_totals: all inputs must be on one CUDA "
                         "device")
    if keys_sorted.dtype != torch.int32 or packed.dtype != torch.int32:
        raise TypeError("segment_totals: keys and packed must be int32")
    if keys_sorted.ndim != 1 or packed.shape != ((n_chan + 1) // 2, M):
        raise ValueError("segment_totals: need keys [M] and packed "
                         "[ceil(n_chan/2), M]")
    if not (keys_sorted.is_contiguous() and packed.is_contiguous()):
        raise ValueError("segment_totals: inputs must be contiguous")
    if not 0 < n_chan <= 64 or not 0 <= M < 2 ** 31 or n_rows <= 0:
        raise ValueError(f"segment_totals: need 0 < n_chan <= 64, M < 2^31 "
                         f"and rows > 0 (n_chan={n_chan}, M={M})")
    out = torch.zeros(n_rows, n_chan, dtype=torch.float32, device=dev)
    if M == 0:
        return out
    edges, n_edge = edge_buffer(M, n_chan, dev)
    err = _lib("segment_totals_fwd")(
        keys_sorted.data_ptr(), packed.data_ptr(), out.data_ptr(),
        edges.data_ptr(), M, n_chan, n_rows, n_edge,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"segment_totals: CUDA launch failed (error {err})")
    segment_totals.launches += 1
    return out


segment_totals.launches = 0   # kernel launches, counted where they happen


def _cpu_words(who, g, g_col: int, C: int):
    """The payload words the plain version takes: g's level packed by
    :func:`g_words_plain`, or g itself when it is already the words."""
    if g.dtype == torch.int32:
        if g_col != 0:
            raise ValueError(f"{who}: packed words start at column 0")
        return g
    return g_words_plain(g, g_col, C)


def _check_outer(who, keys_sorted, perm, w_word, g, g_col, n_rows, C):
    """Raises unless the outer stream is one the kernel takes."""
    dev = keys_sorted.device
    M = keys_sorted.shape[0]
    if dev.type != "cuda" or any(t.device != dev for t in (perm, w_word, g)):
        raise ValueError(f"{who}: all inputs must be on one CUDA device")
    if any(t.dtype != torch.int32 for t in (keys_sorted, perm, w_word)):
        raise TypeError(f"{who}: keys, perm and w_word must be int32")
    if g.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{who}: the kernel reads g in place: f32 or bf16, "
                        f"not {g.dtype}")
    if keys_sorted.ndim != 1 or perm.shape != (M,) or w_word.ndim != 1 \
            or g.ndim != 2 or not 0 <= g_col <= g.shape[1] - C:
        raise ValueError(f"{who}: need keys and perm [M], w_word [M_all] "
                         f"and g [B, >= g_col + C] (g_col={g_col})")
    if not all(t.is_contiguous() for t in (keys_sorted, perm, w_word)) \
            or g.stride(1) != 1:
        raise ValueError(f"{who}: keys, perm and w_word must be contiguous "
                         "and g's rows too")
    # a channel pair is one aligned load (csrc/segsum.cu payload_word)
    if C > 1 and (g_col % 2 or g.stride(0) % 2
                  or g.data_ptr() % (2 * g.element_size())):
        raise ValueError(f"{who}: g's row stride and g_col must be even and "
                         "g aligned to a channel pair")
    if C not in _CHANNELS or not 0 <= M < 2 ** 31 or n_rows <= 0 \
            or g.shape[0] <= 0:
        raise ValueError(f"{who}: need C in {_CHANNELS}, M < 2^31, rows "
                         f"and points > 0 (C={C}, M={M})")


def _launch_outer(name, keys_sorted, perm, w_word, g, g_col, out, scratch,
                  n_edge, n_rows, C):
    dev = keys_sorted.device
    err = _lib(name)(
        keys_sorted.data_ptr(), perm.data_ptr(), w_word.data_ptr(),
        g.data_ptr(), g.stride(0), g_col, int(g.dtype == torch.bfloat16),
        out.data_ptr(), scratch.data_ptr(), keys_sorted.shape[0],
        g.shape[0], C, n_rows, n_edge,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed (error {err})")


def segment_totals_outer(keys_sorted, perm, w_word, g, n_rows: int, C: int,
                         *, g_col: int = 0, out=None):
    """Per-row totals of the outer-product record stream of one level (the
    arguments of :func:`segment_totals_outer_plain`, but g [B, *] f32 or
    bf16, the level's C channels from column ``g_col``: the encode's
    cotangent, read in place). ``out``, if given, is a contiguous
    [n_rows, 2C] f32 tensor that is overwritten. CPU tensors take the
    plain version on :func:`g_words_plain` (or on g itself when it is
    already the int32 words); CUDA tensors launch the kernel."""
    if keys_sorted.device.type == "cpu":
        return segment_totals_outer_plain(
            keys_sorted, perm, w_word,
            _cpu_words("segment_totals_outer", g, g_col, C), n_rows, C,
            out=out)
    _check_outer("segment_totals_outer", keys_sorted, perm, w_word, g, g_col,
                 n_rows, C)
    dev = keys_sorted.device
    M = keys_sorted.shape[0]
    if out is None:
        out = torch.empty(n_rows, 2 * C, dtype=torch.float32, device=dev)
    elif (out.shape != (n_rows, 2 * C) or out.dtype != torch.float32
          or out.device != dev or not out.is_contiguous()):
        raise ValueError("segment_totals_outer: out must be a contiguous "
                         "[n_rows, 2C] f32 tensor on the inputs' device")
    # rows without records must read exactly 0; the kernel adds the rest
    out.zero_()
    if M == 0:
        return out
    edges, n_edge = edge_buffer(M, 2 * C, dev)
    _launch_outer("segment_totals_outer_fwd", keys_sorted, perm, w_word, g,
                  g_col, out, edges, n_edge, n_rows, C)
    segment_totals_outer.launches += 1
    return out


segment_totals_outer.launches = 0   # kernel launches, counted where they happen


def segment_grad_outer(keys_sorted, perm, w_word, g, n_rows: int, C: int,
                       *, g_col: int = 0, out=None):
    """The window level's flat table gradient from its outer-product
    record stream (the arguments of :func:`segment_totals_outer`):
    ``out`` [n_rows * C] f32, a contiguous slice of the flat gradient (a
    new tensor if None), overwritten with ``G0[r] + G1[r - 1]`` (+0 into
    row 0; rows without records +0). CPU tensors take
    :func:`segment_grad_outer_plain` on :func:`g_words_plain` (or on g
    itself when it is already the int32 words); CUDA tensors launch the
    kernel's flat mode, which reads g in place: a zero fill of ``out``,
    then the main pass, the group sums, the fix-up and the join."""
    if keys_sorted.device.type == "cpu":
        return segment_grad_outer_plain(
            keys_sorted, perm, w_word,
            _cpu_words("segment_grad_outer", g, g_col, C), n_rows, C,
            out=out)
    _check_outer("segment_grad_outer", keys_sorted, perm, w_word, g, g_col,
                 n_rows, C)
    dev = keys_sorted.device
    M = keys_sorted.shape[0]
    if out is None:
        out = torch.empty(n_rows * C, dtype=torch.float32, device=dev)
    elif (out.shape != (n_rows * C,) or out.dtype != torch.float32
          or out.device != dev or not out.is_contiguous()):
        raise ValueError("segment_grad_outer: out must be a contiguous "
                         "[n_rows * C] f32 tensor on the inputs' device")
    # rows no pair writes must read exactly +0
    out.zero_()
    if M == 0:
        return out
    scratch, n_edge = flat_edge_buffer(M, C, dev)
    _launch_outer("segment_grad_outer_fwd", keys_sorted, perm, w_word, g,
                  g_col, out, scratch, n_edge, n_rows, C)
    segment_grad_outer.launches += 1
    return out


segment_grad_outer.launches = 0   # kernel launches, counted where they happen
