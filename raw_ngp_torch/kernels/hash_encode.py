"""Hash-grid encode, forward, table gradient and input gradient: wrapper of
the CUDA kernels in ``csrc/hash_encode.cu`` (the encode, which also
writes the window records, and its input gradient), ``csrc/hash_grad.cu``
(the dense levels' table gradient), ``csrc/segsum.cu`` (kernel B2,
through :mod:`raw_ngp_torch.kernels.segsum`) and ``csrc/radix_sort.cu``
(the sorts in front of both, through :mod:`raw_ngp_torch.kernels.sort`).

Replaces ``raw_ngp_tpu/kernels/hash_fused.py`` ``hash_encode_fused``
(``:497``, forward ``_fused_fwd`` ``:513``, backward ``_fused_bwd``
``:756``, with and without ``need_input_grads``) and its world-space
wrapper ``hash_encode_fast`` (``:784``).

Forward: the encode kernel; its plain version is
:func:`hash_encode_fused_plain` (``ops/hashgrid.hash_encode_01`` in f32;
JAX's bf16 rounding chain under bf16). When the table needs a gradient
the same launch also writes the backward's records, JAX's residuals
``base`` [P, B] and the (w0, w1) pair of every window packed as two
truncated bf16 halves (:func:`hash_encode_records`; plain version
:func:`window_records_plain`).

Backward, the table gradient (:func:`table_grad`), into one flat f32
gradient: the dense leading levels (``_matmul_split``) by
:func:`mm_grad_table` (``_mm_grad_table``; plain version
:func:`mm_grad_table_plain`, the transposed matmul): the points sorted by
cell, per-cell corner sums and a per-row gather, in a fixed order without
atomics (:func:`mm_grad_table_cells_plain` is that arithmetic in torch,
for the tests); the window levels as
``_window_bwd_table_chunked`` (``:633-689``): per level a stable radix
sort of the record keys over the level's row bits
(:func:`~raw_ngp_torch.kernels.sort.sort_keys`, ``torch.sort``'s order)
and kernel B2's flat mode, which reads the level's g
channels in place as bf16 pairs, sums the bf16-rounded products w0*g and
w1*g per row and writes ``grad[r] = G0[r] + G1[r-1]`` into the level's
slice itself (:func:`raw_ngp_torch.kernels.segsum.segment_grad_outer`).
The plain path keeps JAX's shape: g's channel pairs packed
(:func:`pack_g_words_plain`), the totals, then
:func:`combine_totals_plain`.

Backward, the input gradient (pose refinement, ``hash_fused.py:760-778``:
the VJP of the interpolation weights with the table frozen): the kernel
``hash_encode_bwd_input``, one group of ceil(C/4) threads per point as
the forward's (lanes over channel quads, cross-channel sums in channel
order); its plain version is :func:`encode_input_grad_plain`. Both take
JAX's rounding points under bf16 (see that function).

The input gradient differentiated in g (the orientation loss's
second-order term, JAX's ``jax.grad`` through ``_fused_bwd``'s input
gradient with the table frozen): :func:`frozen_input_grad`, whose
forward is the input gradient and whose backward is the kernel
``hash_encode_input_jvp`` (:func:`encode_input_jvp`): the encode's JVP
along the positions, the forward with each weight replaced by its
directional derivative, in the forward's groups of threads (below C = 8
with the outputs staged in shared memory and the rows stored whole); its
plain version is :func:`encode_input_jvp_plain`, which takes the rounding
of XLA's transpose of the bf16 chain.

Every kernel reads the level table (:func:`_level_table`), whose last
columns reduce the hashes modulo each level's size without a division
(:func:`mod_constants`).

CPU tensors take the plain versions in both directions; CUDA tensors
launch the kernels or the call raises.
"""

from __future__ import annotations

import ctypes
import functools
import os

import torch

from raw_ngp_torch.kernels import _build
from raw_ngp_torch.kernels.sort import sort_keys, sort_keys_plain
from raw_ngp_torch.kernels.segsum import (combine_totals_plain, edge_buffer,
                                          g_words_plain, pack_bf16_pairs,
                                          round_bf16, segment_grad_outer,
                                          segment_totals_outer_plain)
from raw_ngp_torch.ops.hashgrid import (HashGridSpec, _level_indices,
                                        _smoothstep, hash_encode_01,
                                        level_layout, pair_axis)

_MODES = {"stride": 0, "xor": 1, "additive": 2}
_CHANNELS = (1, 2, 4, 8, 16, 32)


# ---------------------------------------------------------------------------
# level split: dense matmul levels, then window levels
# ---------------------------------------------------------------------------

def _matmul_level(spec: HashGridSpec, lv: int) -> bool:
    """Whether level ``lv`` takes the dense matmul path
    (``hash_fused._matmul_level``): dense, 3-D, res*C >= 128,
    res^2 >= 128 and res^2*C <= 8192, C the table's channels
    (``split_level_dim`` where the spec sets it: a tensor-parallel shard
    takes its whole table's levels)."""
    res = spec.resolutions[lv]
    hmap = spec.offsets[lv + 1] - spec.offsets[lv]
    C = spec.split_level_dim or spec.level_dim
    return (spec.input_dim == 3 and res ** 3 <= hmap and res * C >= 128
            and res * res >= 128 and res * res * C <= 8192)


def matmul_split(spec: HashGridSpec) -> int:
    """Number of leading levels on the matmul path (``_matmul_split``):
    at least one level stays on the window path. ``RAW_NGP_MM_LEVELS``
    caps the count as in the JAX package (0 disables, N allows at most N,
    unset or "auto" uncapped, any other non-integer disables)."""
    k = 0
    while k < spec.num_levels - 1 and _matmul_level(spec, k):
        k += 1
    env = os.environ.get("RAW_NGP_MM_LEVELS", "")
    if env and env.lower() != "auto":
        try:
            k = min(max(int(env), 0), k)
        except ValueError:
            k = 0
    return k


def level_pairable(spec: HashGridSpec, lv: int) -> bool:
    """Whether the two pair-axis corners of every cell are adjacent table
    rows at this level (dense, or the additive hash)."""
    res = spec.resolutions[lv]
    hmap = spec.offsets[lv + 1] - spec.offsets[lv]
    if res ** spec.input_dim <= hmap:
        return True
    return (spec.gridtype == "hash" and spec.hash_variant == "additive"
            and hmap > res)


def level_windows(spec: HashGridSpec, m: int):
    """[(level, first window, number of windows)] of the window levels
    m..L-1, level-major (the order of ``_window_indices_weights``)."""
    D = spec.input_dim
    out, w0 = [], 0
    for lv in range(m, spec.num_levels):
        nw = 1 << (D - 1) if level_pairable(spec, lv) else 1 << D
        out.append((lv, w0, nw))
        w0 += nw
    return out


def mod_constants(d: int):
    """(mask, magic) that reduce a uint32 x modulo d (1 <= d < 2^32) on the
    card without a division (``mod_u32`` in ``csrc/hash_encode.cu``): x &
    mask where d is a power of two (mask = d - 1); else mask = -1 (all
    ones as u32, no power of two's mask) and Lemire's fastmod, x % d =
    hi64(lo64(magic * x) * d) with magic = floor((2^64 - 1) / d) + 1 mod
    2^64, exact for every uint32 x. magic is given for every d, as the
    i64 of its 64 bits."""
    mask = d - 1 if d & (d - 1) == 0 else -1
    magic = ((2 ** 64 - 1) // d + 1) % 2 ** 64
    return mask, magic - 2 ** 64 if magic >= 2 ** 63 else magic


# the level table's columns: level_layout's, then the moduli's constants
LEVEL_COLUMNS = ("res", "hmap", "offset", "n_strides", "stride0", "stride1",
                 "stride2", "mode", "axis", "pairable", "first_window",
                 "hmap_mask", "hmap_magic", "add_mask", "add_magic")


@functools.lru_cache(maxsize=16)
def _level_table(spec: HashGridSpec, m: int, device: torch.device):
    """[L, 15] i64 rows the kernels read per level (``LEVEL_COLUMNS``):
    res, hmap, offset, n_strides, stride0..2, mode, pair axis, pairable,
    first window (-1 on the matmul levels below ``m``), then
    :func:`mod_constants` of hmap (every mode's final ``% hmap``) and of
    hmap - res (the additive hash's ``g % (hmap - res)``; those of 1 on
    the other modes)."""
    first = {lv: w0 for lv, w0, _ in level_windows(spec, m)}
    rows = []
    for lv in range(spec.num_levels):
        res, hmap, offset, strides, mode, axis = level_layout(spec, lv)
        s = list(strides) + [0] * (3 - len(strides))
        add = hmap - res if mode == "additive" else 1
        rows.append([res, hmap, offset, len(strides), *s, _MODES[mode], axis,
                     int(level_pairable(spec, lv)), first.get(lv, -1),
                     *mod_constants(hmap), *mod_constants(add)])
    return torch.tensor(rows, dtype=torch.int64, device=device)


# ---------------------------------------------------------------------------
# plain versions of the backward's pieces
# ---------------------------------------------------------------------------

def _corner_axis(x, res: int, spec: HashGridSpec):
    """Per-axis lower corner (int64) and fraction (f32), rounded as the
    JAX ``_corner_axis`` / ``_window_indices_weights`` compute them."""
    if spec.align_corners:
        pos = x * (res - 1)
        g0 = torch.clamp_max(torch.floor(pos), res - 2)
    else:
        pos = torch.clamp(x * res - 0.5, 0.0, res - 1)
        g0 = torch.floor(pos)
    f = pos - g0
    if spec.interpolation == "smoothstep":
        f = _smoothstep(f)
    return g0.to(torch.int64), f


def _in_bounds(x01):
    """(inb [B] bool, per-axis coords with out-of-bounds points at 0.5)."""
    xs = [x01[:, d].float() for d in range(x01.shape[1])]
    inb = (xs[0] >= 0.0) & (xs[0] <= 1.0)
    for d in range(1, len(xs)):
        inb = inb & (xs[d] >= 0.0) & (xs[d] <= 1.0)
    return inb, [torch.where(inb, x, 0.5) for x in xs]


def window_indices_weights(x01, spec: HashGridSpec):
    """Window records of every window level (``_window_indices_weights``):
    base [P, B] i32, the first table row of each 2-row window (clamped to
    n_params - 2), and w0, w1 [P, B] f32, the weights routed to rows base
    and base + 1. The products follow the JAX order, so the values match
    bit for bit."""
    B, D = x01.shape
    inb, xs = _in_bounds(x01)
    inb_f = inb.float()
    top = spec.n_params - 2
    bases, w0s, w1s = [], [], []
    for lv, _, _ in level_windows(spec, matmul_split(spec)):
        res = spec.resolutions[lv]
        gr, fr = zip(*(_corner_axis(x, res, spec) for x in xs))
        a = pair_axis(spec, lv)
        rest = [d for d in range(D) if d != a]
        a_lo = gr[a]
        a_hi = torch.clamp_max(a_lo + 1, res - 1)
        for h in range(1 << (D - 1)):
            lo, hi = [None] * D, [None] * D
            lo[a], hi[a] = a_lo, a_hi
            w_rest = inb_f
            for j, d in enumerate(rest):
                bit = (h >> j) & 1
                lo[d] = hi[d] = torch.clamp_max(gr[d] + bit, res - 1)
                w_rest = w_rest * (fr[d] if bit else (1.0 - fr[d]))
            u = _level_indices(spec, lv, torch.stack(lo, -1))
            v = _level_indices(spec, lv, torch.stack(hi, -1))
            w_u = (1.0 - fr[a]) * w_rest
            w_v = fr[a] * w_rest
            if level_pairable(spec, lv):
                b = torch.clamp_max(torch.minimum(u, v), top)
                bases.append(b)
                w0s.append(w_u * (u == b) + w_v * (v == b))
                w1s.append(w_u * (u == b + 1) + w_v * (v == b + 1))
            else:
                for idx, w in ((u, w_u), (v, w_v)):
                    b = torch.clamp_max(idx, top)
                    bases.append(b)
                    w0s.append(w * (idx == b))
                    w1s.append(w * (idx == b + 1))
    return (torch.stack(bases).to(torch.int32), torch.stack(w0s),
            torch.stack(w1s))


def window_records_plain(x01, spec: HashGridSpec):
    """Plain version of the records the encode kernel writes under
    :func:`hash_encode_records`: (base [P, B] i32, w_word [P, B] i32 with
    w0 in the high and w1 in the low truncated bf16 half)."""
    base, w0, w1 = window_indices_weights(x01, spec)
    return base, pack_bf16_pairs([w0, w1])[0]


def _mm_lanes(g0, f, res: int):
    """The two lanes of one axis at a dense level (``_mm_axis_weights``'
    ``axis_w``): coords (g0, g1 = min(g0 + 1, res - 1)), weights
    (1 - f, f), or, where g1 is clamped onto g0, ((1 - f) + f, 0), and
    whether the upper lane is present."""
    c1 = torch.clamp_max(g0 + 1, res - 1)
    present = c1 != g0
    a0 = torch.where(present, 1.0 - f, (1.0 - f) + f)
    a1 = torch.where(present, f, torch.zeros_like(f))
    return (g0, c1), (a0, a1), present


def hash_encode_fused_plain(params, x01, spec: HashGridSpec,
                            compute_dtype=None):
    """Plain version of the encode kernel: the forward of JAX's
    ``hash_encode_fused`` (``_fused_fwd``) -> [B, L*C] in
    ``compute_dtype`` (default f32).

    In f32 it is ``ops/hashgrid.hash_encode_01``. Under bf16 it takes the
    fused encoder's rounding chain, which the CPU tests hold to JAX bit
    for bit: the table read as rnd(T); on a window level
    (``_window_forward``) each lane product rnd(rnd(T) * rnd(w)) of the
    records' (w0, w1), the window's two rows added and rounded, the
    level's windows summed in f32 in window order and rounded once (XLA's
    CPU reduce of bf16 accumulates in f32); on a dense matmul level
    (``_mm_forward``) per x lane Z = rnd(sum_yz rnd(wz wy) rnd(T)) with the
    yz lanes summed in f32 z-major, then rnd(Z * rnd(wx)), the two x lanes
    added in f32 and rounded once."""
    if compute_dtype != torch.bfloat16:
        return hash_encode_01(params, x01, spec)
    B = x01.shape[0]
    C = spec.level_dim
    tab = round_bf16(params.detach().reshape(spec.n_params, C).float())
    inb, xs = _in_bounds(x01)
    inb_f = inb.float()
    m = matmul_split(spec)
    outs = []
    for lv in range(m):
        res = spec.resolutions[lv]
        (cx, ax, _), (cy, ay, _), (cz, az, _) = (
            _mm_lanes(*_corner_axis(x, res, spec), res) for x in xs)
        out = torch.zeros(B, C, dtype=torch.float32, device=x01.device)
        for xi in range(2):
            z = torch.zeros_like(out)
            for zi in range(2):
                for yi in range(2):
                    w = round_bf16(az[zi] * ay[yi] * inb_f)
                    rows = _level_indices(spec, lv, torch.stack(
                        [cx[xi], cy[yi], cz[zi]], -1))
                    z = z + w[:, None] * tab[rows]
            out = out + round_bf16(round_bf16(z) * round_bf16(ax[xi])[:, None])
        outs.append(out)
    base, w0, w1 = window_indices_weights(x01, spec)
    for _, first, nw in level_windows(spec, m):
        out = torch.zeros(B, C, dtype=torch.float32, device=x01.device)
        for w in range(first, first + nw):
            rows = base[w].long()
            a = round_bf16(tab[rows] * round_bf16(w0[w])[:, None])
            b = round_bf16(tab[rows + 1] * round_bf16(w1[w])[:, None])
            out = out + round_bf16(a + b)
        outs.append(out)
    return torch.cat(outs, dim=1).to(torch.bfloat16)


def mm_axis_weights(x01, spec: HashGridSpec, lv: int):
    """(wyz [B, res^2], wx_p [B, res*C]) f32 weight operands of level
    ``lv``'s separable contraction (``_mm_axis_weights``); out-of-bounds
    points get zero rows."""
    res = spec.resolutions[lv]
    inb, xs = _in_bounds(x01)
    lanes = torch.arange(res, device=x01.device)[None, :]

    def axis_w(x):
        g0, f = _corner_axis(x, res, spec)
        g1 = torch.clamp_max(g0 + 1, res - 1)
        return ((1.0 - f)[:, None] * (lanes == g0[:, None])
                + f[:, None] * (lanes == g1[:, None]))

    wx, wy, wz = (axis_w(x) for x in xs)
    wyz = (wz[:, :, None] * wy[:, None, :]).reshape(-1, res * res) \
        * inb.float()[:, None]
    return wyz, wx.repeat_interleave(spec.level_dim, dim=1)


def mm_grad_level_plain(x01, g, spec: HashGridSpec, lv: int,
                        compute_dtype=None):
    """Plain version of :func:`mm_grad_level`: dense level ``lv``'s table
    gradient grad_T2 = wyz^T @ (wx * g) (``_mm_grad_table``), flat
    [hmap * C] f32, rows past res^3 zero. Under bf16 the operands and the
    elementwise product are rounded to bf16 and the f32-accumulated
    product is rounded once, as the JAX bf16 matmuls do; the products run
    in f32 (TF32 must be off) so that the card's reduced-precision bf16
    reductions cannot enter."""
    C = spec.level_dim
    rnd = round_bf16 if compute_dtype == torch.bfloat16 else (lambda t: t)
    res = spec.resolutions[lv]
    hmap = spec.offsets[lv + 1] - spec.offsets[lv]
    wyz, wx_p = mm_axis_weights(x01, spec, lv)
    g_lv = rnd(g[:, lv * C:(lv + 1) * C].float())
    gx = rnd(g_lv.repeat(1, res) * rnd(wx_p))
    flat = rnd(rnd(wyz).T @ gx).reshape(-1)
    return torch.cat([flat, flat.new_zeros((hmap - res ** 3) * C)])


def mm_grad_table_plain(x01, g, spec: HashGridSpec, compute_dtype=None,
                        out=None):
    """Plain version of :func:`mm_grad_table` (``_mm_grad_table``): every
    dense matmul level by :func:`mm_grad_level_plain`, flat [offsets[m] *
    C] f32 (copied into ``out`` if given)."""
    parts = [mm_grad_level_plain(x01, g, spec, lv, compute_dtype)
             for lv in range(matmul_split(spec))]
    flat = torch.cat(parts) if parts else g.new_zeros(0, dtype=torch.float32)
    return flat if out is None else out.copy_(flat)


def dense_cell_keys(x01, spec: HashGridSpec, lv: int):
    """Each point's cell at dense level ``lv``, the key the kernels sort
    by: its lower corner x + res (y + res z), res^3 for a point outside
    [0, 1]^3 or NaN -> [B] i64."""
    res = spec.resolutions[lv]
    inb, xs = _in_bounds(x01)
    cx, cy, cz = (_corner_axis(x, res, spec)[0] for x in xs)
    return torch.where(inb, cx + res * (cy + res * cz), res ** 3)


def mm_grad_table_cells_plain(x01, g, spec: HashGridSpec, compute_dtype=None):
    """The arithmetic of the kernels' design in plain torch, for the tests:
    per dense matmul level, each point's cell (lower corner; res^3 outside
    [0, 1]^3 or NaN) and a stable sort by cell, the per-cell corner sums
    [res^3, 8, C] of the sorted points' exact products rnd(wyz) *
    rnd(g * rnd(wx)) (corner i = xi + 2 yi + 4 zi), then per row the sum
    over corners i = 0..7 in order of the sums of cell (x - xi, y - yi,
    z - zi) where that cell exists, rounded once under bf16. A clamped
    upper corner weighs exactly 0 and has no row of its own: the gather
    drops it. -> flat [offsets[m] * C] f32, as :func:`mm_grad_table`."""
    C = spec.level_dim
    rnd = round_bf16 if compute_dtype == torch.bfloat16 else (lambda t: t)
    _, xs = _in_bounds(x01)
    parts = []
    for lv in range(matmul_split(spec)):
        res = spec.resolutions[lv]
        hmap = spec.offsets[lv + 1] - spec.offsets[lv]
        (_, ax, _), (_, ay, _), (_, az, _) = (
            _mm_lanes(*_corner_axis(x, res, spec), res) for x in xs)
        keys = dense_cell_keys(x01, spec, lv).to(torch.int32)
        perm = sort_keys_plain(keys, (res ** 3).bit_length())[1].long()
        g_lv = rnd(g[:, lv * C:(lv + 1) * C].float())
        prods = torch.stack([
            (rnd(az[i >> 2] * ay[(i >> 1) & 1])[:, None]
             * rnd(g_lv * rnd(ax[i & 1])[:, None])) for i in range(8)], 1)
        cells = torch.zeros(res ** 3 + 1, 8, C, dtype=torch.float32,
                            device=x01.device).index_add_(
            0, keys[perm], prods[perm])[:res ** 3]
        r = torch.arange(res ** 3, device=x01.device)
        x, y, z = r % res, (r // res) % res, r // (res * res)
        grad = torch.zeros(res ** 3, C, dtype=torch.float32,
                           device=x01.device)
        for i in range(8):
            ccx, ccy, ccz = x - (i & 1), y - ((i >> 1) & 1), z - (i >> 2)
            ok = (ccx >= 0) & (ccy >= 0) & (ccz >= 0)
            cell = (ccx + res * (ccy + res * ccz)).clamp_min(0)
            grad = grad + torch.where(ok[:, None], cells[cell, i], 0.0)
        parts += [rnd(grad).reshape(-1),
                  grad.new_zeros((hmap - res ** 3) * C)]
    return torch.cat(parts) if parts else g.new_zeros(0, dtype=torch.float32)


def pack_g_words_plain(g, spec: HashGridSpec):
    """B2's payload words of every window level: [L - m, B, ceil(C/2)]
    i32, :func:`~raw_ngp_torch.kernels.segsum.g_words_plain` of each window
    level's C g-channels (JAX's ``_pack_bf16_pairs``). The plain path's
    payload, and the oracle's input on the card, where B2 reads g in
    place."""
    C = spec.level_dim
    return torch.stack([g_words_plain(g, lv * C, C)
                        for lv, _, _ in level_windows(spec,
                                                      matmul_split(spec))])


def table_grad(spec: HashGridSpec, x01, base, w_word, g, compute_dtype=None,
               plain: bool = False):
    """Gradient of the flat table from the records of the forward and the
    encode's cotangent g [B, L*C] (``_window_bwd_table_chunked``), written
    into one flat [n_params * C] f32 tensor: the dense levels' slice by
    :func:`mm_grad_table`; per window level the keys (rows relative to
    the level) sorted stably over the level's ``(rows - 1).bit_length()``
    bits (:func:`~raw_ngp_torch.kernels.sort.sort_keys`, which reads the
    records in place and subtracts the level's offset as it loads; its
    plain version on the plain path) and the bf16-rounded outer products
    summed per row (kernel B2). On CUDA, B2's flat mode
    (:func:`segment_grad_outer`) reads the level's g channels in place and
    writes G0[r] + G1[r-1] into the level's slice itself; ``plain`` and CPU tensors take JAX's shape
    with every kernel's plain version: g packed (:func:`pack_g_words_plain`),
    the levels' [rows, 2C] totals, then :func:`combine_totals_plain` over
    all of them (the same bits for a finite g; a non-finite g can differ
    in the first row of a window level after the first: see
    ``kernels/segsum.py``)."""
    C = spec.level_dim
    m = matmul_split(spec)
    off_m = spec.offsets[m]
    grad = torch.empty(spec.n_params * C, dtype=torch.float32,
                       device=g.device)
    flat = not plain and g.device.type != "cpu"
    if m:
        (mm_grad_table if flat else mm_grad_table_plain)(
            x01, g, spec, compute_dtype, out=grad[:off_m * C])
    if flat:
        g = g.contiguous()
    else:
        words = pack_g_words_plain(g, spec)
        totals = torch.empty(spec.n_params - off_m, 2 * C,
                             dtype=torch.float32, device=g.device)
    for i, (lv, w0, nw) in enumerate(level_windows(spec, m)):
        off = spec.offsets[lv]
        rows = spec.offsets[lv + 1] - off
        bits = max((rows - 1).bit_length(), 1)
        keys_s, perm = (sort_keys if flat else sort_keys_plain)(
            base[w0:w0 + nw].reshape(-1), bits, offset=off)
        stream = (keys_s, perm, w_word[w0:w0 + nw].reshape(-1))
        if flat:
            segment_grad_outer(*stream, g, rows, C, g_col=lv * C,
                               out=grad[off * C:(off + rows) * C])
        else:
            segment_totals_outer_plain(
                *stream, words[i], rows, C,
                out=totals[off - off_m:off - off_m + rows])
    if not flat:
        combine_totals_plain(totals, out=grad[off_m * C:])
    return grad


def _axis_terms(x, res: int, spec: HashGridSpec):
    """Per-axis lower corner (int64), fraction f (f32) and df/dx (f32),
    with JAX's clip semantics: a clip bound met exactly passes half the
    gradient (``jnp.clip`` is ``minimum(maximum(.))``), beyond it none."""
    if spec.align_corners:
        pos = x * (res - 1)
        g0 = torch.clamp_max(torch.floor(pos), res - 2)
        dpos = torch.full_like(x, float(res - 1))
    else:
        raw = x * res - 0.5
        top = float(res - 1)
        pos = torch.clamp(raw, 0.0, top)
        g0 = torch.floor(pos)
        inside = ((raw > 0.0) & (raw < top)).float()
        tie = ((raw == 0.0) | (raw == top)).float()
        dpos = (inside + 0.5 * tie) * float(res)
    t = pos - g0
    if spec.interpolation == "smoothstep":
        return g0.to(torch.int64), _smoothstep(t), \
            dpos * (6.0 * t * (1.0 - t))
    return g0.to(torch.int64), t, dpos


def _dot_rounded(g_lv, rows, rnd):
    """sum_c rnd(g_c * rows[:, c]) in f32, channels in order."""
    acc = torch.zeros_like(rows[:, 0])
    for c in range(rows.shape[1]):
        acc = acc + rnd(g_lv[:, c] * rows[:, c])
    return acc


def _window_level_ct(tab, g_lv, g0s, fs, res, spec, lv, rnd):
    """d(out_lv . g_lv) / d f_d of a window level: the corner values
    V = sum_c rnd(g_c * T[row, c]) (JAX's per-window cotangent, the
    rounded lanes of ``_window_forward``'s product summed in f32), then
    (V[bit_d = 1] - V[bit_d = 0]) times the other axes' weights."""
    D = len(g0s)
    V = []
    for corner in range(1 << D):
        coords = torch.stack([torch.clamp_max(g0s[d] + ((corner >> d) & 1),
                                              res - 1) for d in range(D)],
                             -1)
        V.append(_dot_rounded(g_lv, tab[_level_indices(spec, lv, coords)],
                              rnd))
    ct = []
    for d in range(D):
        others = [o for o in range(D) if o != d]
        acc = torch.zeros_like(V[0])
        for h in range(1 << (D - 1)):
            w, c1 = None, 1 << d
            for j, o in enumerate(others):
                bit = (h >> j) & 1
                fo = fs[o] if bit else 1.0 - fs[o]
                w = fo if w is None else w * fo
                c1 |= bit << o
            diff = V[c1] - V[c1 & ~(1 << d)]
            acc = acc + (diff if w is None else diff * w)
        ct.append(acc)
    return ct


def _mm_level_ct(tab, g_lv, g0s, fs, res, spec, lv, rnd):
    """d(out_lv . g_lv) / d f_d of a matmul level, through JAX's chain
    (``_mm_forward``): per axis two lanes with weights (1 - f, f), or one
    lane (1 - f) + f where the upper corner is clamped onto the lower;
    Z = rnd(sum_yz rnd(wz wy) T) per x lane; d/d wx = sum_c rnd(g_c Z_c);
    d/d wyz = rnd(sum_{x, c} rnd(g_c rnd(wx)) T); then the one-hot lane
    derivatives. ``rnd`` is the bf16 rounding under bf16, else identity."""
    (cx, ax, px), (cy, ay, py), (cz, az, pz) = (
        _mm_lanes(g0s[d], fs[d], res) for d in range(3))

    def rows(xi, yi, zi):
        coords = torch.stack([cx[xi], cy[yi], cz[zi]], -1)
        return tab[_level_indices(spec, lv, coords)]

    C = g_lv.shape[1]
    wyz = [[rnd(az[zi] * ay[yi]) for yi in range(2)] for zi in range(2)]
    acc_wyz = [[torch.zeros_like(fs[0]) for _ in range(2)] for _ in range(2)]
    ct_wx = []
    for xi in range(2):
        gw = rnd(g_lv * rnd(ax[xi])[:, None])                 # [B, C]
        z_acc = torch.zeros_like(g_lv)
        for zi in range(2):
            for yi in range(2):
                r = rows(xi, yi, zi)                          # [B, C]
                z_acc = z_acc + wyz[zi][yi][:, None] * r
                for c in range(C):
                    acc_wyz[zi][yi] = acc_wyz[zi][yi] + gw[:, c] * r[:, c]
        ct_wx.append(_dot_rounded(g_lv, rnd(z_acc), rnd))
    cw = [[rnd(acc_wyz[zi][yi]) for yi in range(2)] for zi in range(2)]
    zero = torch.zeros_like(fs[0])
    ct_fx = torch.where(px, ct_wx[1] - ct_wx[0], zero)
    ct_fy = torch.where(py, (cw[0][1] * az[0] + cw[1][1] * az[1])
                        - (cw[0][0] * az[0] + cw[1][0] * az[1]), zero)
    ct_fz = torch.where(pz, (cw[1][0] * ay[0] + cw[1][1] * ay[1])
                        - (cw[0][0] * ay[0] + cw[0][1] * ay[1]), zero)
    return [ct_fx, ct_fy, ct_fz]


def encode_input_grad_plain(params, x01, g, spec: HashGridSpec,
                            compute_dtype=None):
    """Gradient of ``sum(hash_encode(params, x01) * g)`` in x01 [B, D]
    with the table frozen (``hash_fused._fused_bwd``'s input gradient,
    the reference gridencoder's dy_dx contraction): [B, D] f32, 0 for
    points outside [0, 1]^D (and NaN).

    Under bf16 it takes JAX's rounding points: the table in bf16; on a
    window level each lane product g_c * T rounded to bf16 and summed in
    f32; on a matmul level the partial interpolations Z and the weight
    cotangents rounded as ``_mm_forward``'s bf16 matmuls round them (see
    :func:`_mm_level_ct`). What is left to differ from JAX is the order of
    f32 sums. The kernel computes the same expressions in the same order.
    """
    B, D = x01.shape
    C = spec.level_dim
    bf16 = compute_dtype == torch.bfloat16
    rnd = round_bf16 if bf16 else (lambda t: t)
    tab = rnd(params.detach().reshape(spec.n_params, C).float())
    gf = g.float()
    inb, xs = _in_bounds(x01.detach())
    m = matmul_split(spec)
    grad = [torch.zeros(B, dtype=torch.float32, device=x01.device)
            for _ in range(D)]
    for lv in range(spec.num_levels):
        res = spec.resolutions[lv]
        g0s, fs, dfs = zip(*(_axis_terms(x, res, spec) for x in xs))
        level_ct = _mm_level_ct if lv < m else _window_level_ct
        ct = level_ct(tab, gf[:, lv * C:(lv + 1) * C], list(g0s), list(fs),
                      res, spec, lv, rnd)
        for d in range(D):
            grad[d] = grad[d] + ct[d] * dfs[d]
    return torch.where(inb[:, None], torch.stack(grad, -1), 0.0)


def _window_level_jvp(tab, g0s, fs, us, res, spec, lv, rnd, bf16):
    """One window level of :func:`encode_input_jvp_plain`: each window's
    weight tangents (dw0, dw1), the product rule in the order of
    :func:`window_indices_weights`' products, through the forward's
    chain (``_window_forward``; under bf16 the lane products rounded, the
    window's two rows added and rounded), the windows summed in f32."""
    D = len(g0s)
    a = pair_axis(spec, lv)
    o0, o1 = [d for d in range(D) if d != a]
    top = spec.n_params - 2
    fa, ua = fs[a], us[a]
    a_lo = g0s[a]
    a_hi = torch.clamp_max(a_lo + 1, res - 1)
    out = torch.zeros(fa.shape[0], tab.shape[1], dtype=torch.float32,
                      device=fa.device)

    def window(b, w0, w1):
        rows0, rows1 = tab[b], tab[b + 1]
        if bf16:
            pa = rnd(rows0 * rnd(w0)[:, None])
            pb = rnd(rows1 * rnd(w1)[:, None])
            return out + rnd(pa + pb)
        return out + (w0[:, None] * rows0 + w1[:, None] * rows1)

    for h in range(1 << (D - 1)):
        lo, hi = [None] * D, [None] * D
        lo[a], hi[a] = a_lo, a_hi
        p, dp = [], []
        for j, d in enumerate((o0, o1)):
            bit = (h >> j) & 1
            lo[d] = hi[d] = torch.clamp_max(g0s[d] + bit, res - 1)
            p.append(fs[d] if bit else 1.0 - fs[d])
            dp.append(us[d] if bit else -us[d])
        w_rest = p[0] * p[1]
        dw_rest = dp[0] * p[1] + p[0] * dp[1]
        dw_u = (-ua) * w_rest + (1.0 - fa) * dw_rest
        dw_v = ua * w_rest + fa * dw_rest
        u = _level_indices(spec, lv, torch.stack(lo, -1))
        v = _level_indices(spec, lv, torch.stack(hi, -1))
        zero = torch.zeros_like(dw_u)
        if level_pairable(spec, lv):
            b = torch.clamp_max(torch.minimum(u, v), top)
            out = window(b, torch.where(u == b, dw_u, zero)
                         + torch.where(v == b, dw_v, zero),
                         torch.where(u == b + 1, dw_u, zero)
                         + torch.where(v == b + 1, dw_v, zero))
        else:
            for idx, dw in ((u, dw_u), (v, dw_v)):
                b = torch.clamp_max(idx, top)
                out = window(b, torch.where(idx == b, dw, zero),
                             torch.where(idx == b + 1, dw, zero))
    return out


def _mm_level_jvp(tab, g0s, fs, us, res, spec, lv, rnd):
    """One dense matmul level of :func:`encode_input_jvp_plain`: the
    transpose in g of :func:`_mm_level_ct`'s chain, per x lane
    rnd(rnd(dwx) rnd(Z) + rnd(Y) rnd(wx)) with Z = rnd(sum_yz rnd(wyz)
    rnd(T)) and Y = rnd(sum_yz rnd(dwyz) rnd(T)) (yz lanes z-major), the
    two x lanes added in f32."""
    lanes = [_mm_lanes(g0s[d], fs[d], res) for d in range(3)]
    (cx, ax, px), (cy, ay, py), (cz, az, pz) = lanes
    zero = torch.zeros_like(fs[0])
    dax, day, daz = ((torch.where(p, -us[d], zero), torch.where(p, us[d], zero))
                     for d, (_, _, p) in enumerate(lanes))
    out = torch.zeros(fs[0].shape[0], tab.shape[1], dtype=torch.float32,
                      device=fs[0].device)
    for xi in range(2):
        wx, dwx = rnd(ax[xi]), rnd(dax[xi])
        z = torch.zeros_like(out)
        y = torch.zeros_like(out)
        for zi in range(2):
            for yi in range(2):
                w = rnd(az[zi] * ay[yi])
                dw = rnd(daz[zi] * ay[yi] + az[zi] * day[yi])
                rows = rnd(tab[_level_indices(spec, lv, torch.stack(
                    [cx[xi], cy[yi], cz[zi]], -1))])
                z = z + w[:, None] * rows
                y = y + dw[:, None] * rows
        a = rnd(dwx[:, None] * rnd(z))
        b = rnd(rnd(y) * wx[:, None])
        out = out + rnd(a + b)
    return out


def encode_input_jvp_plain(params, x01, ct_x, spec: HashGridSpec,
                           compute_dtype=None):
    """The encode's input gradient (:func:`encode_input_grad_plain`)
    differentiated in its cotangent g, for a cotangent ``ct_x`` [B, D] of
    the gradient: ct_g [B, L*C] in the compute dtype (f32 or bf16), with
    ct_g[b, l C + c] = sum_d ct_x[b, d] df_{l,c}/dx01_d, the encode's JVP
    along ct_x with the table frozen. 0 outside [0, 1]^D and on NaN.

    It is the forward with each interpolation weight replaced by its
    directional derivative along u = ct_x df/dx (:func:`_axis_terms`).
    Under bf16 it rounds where XLA's transpose of JAX's bf16 input
    gradient rounds: the tangents and the table to bf16 at the forward's
    points, the forward's chain on them (see :func:`_window_level_jvp`,
    :func:`_mm_level_jvp`), the level's f32 sum rounded once. The kernel
    :func:`encode_input_jvp` computes the same expressions in the same
    order."""
    B, D = x01.shape
    C = spec.level_dim
    bf16 = compute_dtype == torch.bfloat16
    rnd = round_bf16 if bf16 else (lambda t: t)
    tab = params.detach().reshape(spec.n_params, C).float()
    ct = ct_x.detach().float()
    inb, xs = _in_bounds(x01.detach())
    m = matmul_split(spec)
    outs = []
    for lv in range(spec.num_levels):
        res = spec.resolutions[lv]
        g0s, fs, dfs = (list(t) for t in
                        zip(*(_axis_terms(x, res, spec) for x in xs)))
        us = [ct[:, d] * dfs[d] for d in range(D)]
        if lv < m:
            outs.append(_mm_level_jvp(tab, g0s, fs, us, res, spec, lv, rnd))
        else:
            tab_lv = rnd(tab) if bf16 else tab
            outs.append(_window_level_jvp(tab_lv, g0s, fs, us, res, spec, lv,
                                          rnd, bf16))
    out = torch.where(inb[:, None], torch.cat(outs, dim=1), 0.0)
    return out.to(torch.bfloat16 if bf16 else torch.float32)


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------

_ARGTYPES = {
    "hash_encode_fwd": [ctypes.c_void_p] * 6 + [ctypes.c_int64]
    + [ctypes.c_int] * 7 + [ctypes.c_void_p],
    "hash_encode_bwd_input": [ctypes.c_void_p] * 5 + [ctypes.c_int64]
    + [ctypes.c_int] * 6 + [ctypes.c_void_p],
    "hash_encode_input_jvp": [ctypes.c_void_p] * 5 + [ctypes.c_int64]
    + [ctypes.c_int] * 7 + [ctypes.c_void_p],
    "mm_grad_keys_fwd": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
    + [ctypes.c_void_p],
    "mm_grad_table_fwd": [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4
    + [ctypes.c_int64] + [ctypes.c_int] * 5 + [ctypes.c_void_p],
}


_fns = {}


def _lib(name):
    """A kernel's C entry point, bound once (argtypes and restype set at
    first use, then served from a dict); the table gradient's live in
    ``csrc/hash_grad.cu``, the rest in ``csrc/hash_encode.cu``."""
    fn = _fns.get(name)
    if fn is None:
        src = "hash_encode" if name.startswith("hash_encode") else "hash_grad"
        fn = getattr(_build.load(src), name)
        fn.argtypes, fn.restype = _ARGTYPES[name], ctypes.c_int
        _fns[name] = fn
    return fn


def _raise_if(err, who):
    if err != 0:
        raise RuntimeError(f"{who}: CUDA launch failed (error {err})")


def _check_x01(x01, spec: HashGridSpec, who: str):
    if x01.device.type != "cuda":
        raise ValueError(f"{who}: inputs must be on one CUDA device")
    if spec.input_dim != 3 or x01.ndim != 2 or x01.shape[1] != 3:
        raise ValueError(f"{who}: x01 must be [B, 3], got "
                         f"{tuple(x01.shape)}")
    if x01.dtype != torch.float32:
        raise TypeError(f"{who}: x01 must be float32")
    if not x01.is_contiguous():
        raise ValueError(f"{who}: x01 must be contiguous")


def _encode_forward(params, x01, spec: HashGridSpec, compute_dtype=None,
                    records: bool = False):
    """The forward: kernel for CUDA tensors, plain version on the CPU. With
    ``records`` -> (out, base, w_word), the window records from the same
    launch (:func:`hash_encode_records`)."""
    if params.device.type == "cpu":
        out = hash_encode_fused_plain(params, x01, spec, compute_dtype)
        return (out, *window_records_plain(x01, spec)) if records else out
    out_dtype = compute_dtype or params.dtype
    B = x01.shape[0]
    L, C = spec.num_levels, spec.level_dim
    _check_x01(x01, spec, "hash_encode")
    if x01.device != params.device:
        raise ValueError("hash_encode: params and x01 must be on one CUDA "
                         "device")
    if params.dtype != torch.float32:
        raise TypeError("hash_encode: params must be float32")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"hash_encode: compute_dtype {out_dtype} not in "
                        f"(float32, bfloat16)")
    if C not in _CHANNELS:
        raise ValueError(f"hash_encode: level_dim {C} not in {_CHANNELS}")
    if params.numel() != spec.n_params * C:
        raise ValueError("hash_encode: table size does not match the spec")
    if not params.is_contiguous() or params.data_ptr() % 16:
        raise ValueError("hash_encode: table must be contiguous and 16-byte "
                         "aligned")
    m = matmul_split(spec)
    out = torch.empty(B, L * C, dtype=out_dtype, device=x01.device)
    base = w_word = None
    if records:
        P = sum(nw for _, _, nw in level_windows(spec, m))
        base = torch.empty(P, B, dtype=torch.int32, device=x01.device)
        w_word = torch.empty(P, B, dtype=torch.int32, device=x01.device)
    if B:
        levels = _level_table(spec, m, x01.device)
        err = _lib("hash_encode_fwd")(
            x01.data_ptr(), params.data_ptr(), levels.data_ptr(),
            out.data_ptr(), base.data_ptr() if records else None,
            w_word.data_ptr() if records else None, B, L, C, m,
            spec.n_params - 2, int(spec.align_corners),
            int(spec.interpolation == "smoothstep"),
            int(out_dtype == torch.bfloat16),
            torch.cuda.current_stream(x01.device).cuda_stream)
        _raise_if(err, "hash_encode")
        (hash_encode_records if records else hash_encode).launches += 1
    return (out, base, w_word) if records else out


def hash_encode_records(params, x01, spec: HashGridSpec, compute_dtype=None):
    """The encode's forward together with its table gradient's records,
    from one launch of the encode kernel (its records mode) -> (out [B,
    L*C], base [P, B] i32, w_word [P, B] i32), as JAX's ``_fused_fwd``
    returns its residuals with the output. CPU tensors take
    :func:`hash_encode_fused_plain` and :func:`window_records_plain`."""
    return _encode_forward(params, x01, spec, compute_dtype, records=True)


hash_encode_records.launches = 0   # kernel launches, counted where they happen


def encode_input_grad(params, x01, g, spec: HashGridSpec,
                      compute_dtype=None):
    """Gradient of the encode in x01 [B, 3] for the cotangent g [B, L*C]
    (in the encode's output dtype), with the table frozen -> [B, 3] f32.
    CPU tensors take :func:`encode_input_grad_plain`; CUDA tensors launch
    the kernel (ceil(C/4) threads per point, no atomics)."""
    if x01.device.type == "cpu":
        return encode_input_grad_plain(params, x01, g, spec, compute_dtype)
    _check_x01(x01, spec, "encode_input_grad")
    bf16 = compute_dtype == torch.bfloat16
    B = x01.shape[0]
    L, C = spec.num_levels, spec.level_dim
    if params.device != x01.device or g.device != x01.device:
        raise ValueError("encode_input_grad: all inputs must be on one CUDA "
                         "device")
    if params.dtype != torch.float32 or g.dtype != (
            torch.bfloat16 if bf16 else torch.float32):
        raise TypeError("encode_input_grad: params f32, g in the compute "
                        "dtype (bf16 or f32)")
    if C not in _CHANNELS or params.numel() != spec.n_params * C \
            or g.shape != (B, L * C):
        raise ValueError("encode_input_grad: need level_dim in "
                         f"{_CHANNELS}, the spec's table and g [B, L*C]")
    if not (params.is_contiguous() and g.is_contiguous()):
        raise ValueError("encode_input_grad: params and g must be "
                         "contiguous")
    out = torch.empty(B, 3, dtype=torch.float32, device=x01.device)
    if B == 0:
        return out
    m = matmul_split(spec)
    levels = _level_table(spec, m, x01.device)
    err = _lib("hash_encode_bwd_input")(
        x01.data_ptr(), params.data_ptr(), g.data_ptr(), levels.data_ptr(),
        out.data_ptr(), B, L, C, m, int(spec.align_corners),
        int(spec.interpolation == "smoothstep"), int(bf16),
        torch.cuda.current_stream(x01.device).cuda_stream)
    _raise_if(err, "encode_input_grad")
    encode_input_grad.launches += 1
    return out


encode_input_grad.launches = 0   # kernel launches, counted where they happen


def encode_input_jvp(params, x01, ct_x, spec: HashGridSpec,
                     compute_dtype=None):
    """:func:`encode_input_grad` differentiated in g: for the cotangent
    ``ct_x`` [B, 3] f32 of the input gradient, the cotangent of g [B,
    L*C] in the compute dtype (bf16 or f32), the table frozen. CPU tensors
    take :func:`encode_input_jvp_plain`; CUDA tensors launch the kernel
    (the forward's groups of ceil(C/4) threads a point, each writing its
    channels once, below C = 8 through shared memory as whole rows: no
    atomics)."""
    if x01.device.type == "cpu":
        return encode_input_jvp_plain(params, x01, ct_x, spec, compute_dtype)
    _check_x01(x01, spec, "encode_input_jvp")
    bf16 = compute_dtype == torch.bfloat16
    B = x01.shape[0]
    L, C = spec.num_levels, spec.level_dim
    if params.device != x01.device or ct_x.device != x01.device:
        raise ValueError("encode_input_jvp: all inputs must be on one CUDA "
                         "device")
    if params.dtype != torch.float32 or ct_x.dtype != torch.float32:
        raise TypeError("encode_input_jvp: params and ct_x must be float32")
    if C not in _CHANNELS or params.numel() != spec.n_params * C \
            or ct_x.shape != (B, 3):
        raise ValueError("encode_input_jvp: need level_dim in "
                         f"{_CHANNELS}, the spec's table and ct_x [B, 3]")
    if not (params.is_contiguous() and ct_x.is_contiguous()) \
            or params.data_ptr() % 16:
        raise ValueError("encode_input_jvp: params (16-byte aligned) and "
                         "ct_x must be contiguous")
    out = torch.empty(B, L * C, dtype=torch.bfloat16 if bf16
                      else torch.float32, device=x01.device)
    if B == 0:
        return out
    m = matmul_split(spec)
    levels = _level_table(spec, m, x01.device)
    err = _lib("hash_encode_input_jvp")(
        x01.data_ptr(), params.data_ptr(), ct_x.data_ptr(), levels.data_ptr(),
        out.data_ptr(), B, L, C, m, spec.n_params - 2,
        int(spec.align_corners), int(spec.interpolation == "smoothstep"),
        int(bf16), torch.cuda.current_stream(x01.device).cuda_stream)
    _raise_if(err, "encode_input_jvp")
    encode_input_jvp.launches += 1
    return out


encode_input_jvp.launches = 0   # kernel launches, counted where they happen


class _FrozenInputGradFn(torch.autograd.Function):
    """:func:`frozen_input_grad`: the input gradient forward, its JVP in g
    backward."""

    @staticmethod
    def forward(ctx, g, params, x01, spec, compute_dtype, plain):
        ctx.save_for_backward(params, x01)
        ctx.spec, ctx.compute_dtype, ctx.plain = spec, compute_dtype, plain
        fn = encode_input_grad_plain if plain else encode_input_grad
        return fn(params, x01, g.contiguous(), spec, compute_dtype)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, ct):
        params, x01 = ctx.saved_tensors
        fn = encode_input_jvp_plain if ctx.plain else encode_input_jvp
        return (fn(params, x01, ct.float().contiguous(), ctx.spec,
                   ctx.compute_dtype), None, None, None, None, None)


def frozen_input_grad(params, x01, g, spec: HashGridSpec, compute_dtype=None,
                      plain: bool = False):
    """The encode's gradient in x01 [B, 3] for the cotangent g [B, L*C] (in
    the encode's output dtype) with the table frozen -> [B, 3] f32,
    differentiable in g: its backward is :func:`encode_input_jvp`. This is
    JAX's input gradient as ``jax.grad`` differentiates it a second time
    (``_fused_bwd`` takes it through ``stop_gradient(params)``): the
    cotangent reaches g, never the table or x01, whose gradients stay
    None. ``plain=True`` runs the plain versions on any device."""
    return _FrozenInputGradFn.apply(g, params.detach(), x01.detach(), spec,
                                    compute_dtype, plain)


def _check_g(g, spec: HashGridSpec, B: int, who: str):
    if g.device.type != "cuda" or g.dtype not in (torch.float32,
                                                   torch.bfloat16):
        raise TypeError(f"{who}: g must be a CUDA f32 or bf16 tensor")
    if g.shape != (B, spec.output_dim) or not g.is_contiguous():
        raise ValueError(f"{who}: g must be a contiguous [B, L*C] tensor")
    if spec.level_dim not in _CHANNELS:
        raise ValueError(f"{who}: level_dim {spec.level_dim} not in "
                         f"{_CHANNELS}")


def mm_grad_level(x01, g, spec: HashGridSpec, lv: int, compute_dtype=None,
                  out=None):
    """Table gradient of dense level ``lv`` (res^3 <= its rows) for the
    encode's cotangent g [B, L*C] -> flat [hmap * C] f32 (into ``out`` if
    given). CPU tensors take :func:`mm_grad_level_plain`; CUDA tensors
    launch the kernels of ``csrc/hash_grad.cu`` (one counted launch of
    :func:`mm_grad_table`): the points' cells, the stable radix sort by
    cell over the cells' ``(res ** 3).bit_length()`` bits
    (:func:`~raw_ngp_torch.kernels.sort.sort_keys`, one counted launch of
    its own), per-cell corner sums and the per-row gather, every sum in a
    fixed order without atomics, so two calls give the same bits. Against
    the plain version: the same exact products, f32 sums in another order,
    rounded once under bf16."""
    if x01.device.type == "cpu":
        flat = mm_grad_level_plain(x01, g, spec, lv, compute_dtype)
        return flat if out is None else out.copy_(flat)
    _check_x01(x01, spec, "mm_grad_table")
    bf16 = compute_dtype == torch.bfloat16
    B, C = x01.shape[0], spec.level_dim
    g = g.to(torch.bfloat16 if bf16 else torch.float32).contiguous()
    _check_g(g, spec, B, "mm_grad_table")
    res, off = spec.resolutions[lv], spec.offsets[lv]
    hmap = spec.offsets[lv + 1] - off
    if res ** 3 > hmap or B >= 2 ** 31:
        raise ValueError(f"mm_grad_table: level {lv} is not dense or B "
                         f"({B}) exceeds 2^31 - 1")
    if out is None:
        out = torch.empty(hmap * C, dtype=torch.float32, device=x01.device)
    elif (out.shape != (hmap * C,) or out.dtype != torch.float32
          or out.device != x01.device or not out.is_contiguous()):
        raise ValueError("mm_grad_table: out must be a contiguous [hmap * C] "
                         "f32 tensor on x01's device")
    if B == 0:
        return out.zero_()
    stream = torch.cuda.current_stream(x01.device).cuda_stream
    align = int(spec.align_corners)
    smooth = int(spec.interpolation == "smoothstep")
    keys = torch.empty(B, dtype=torch.int32, device=x01.device)
    cellsum = torch.empty(res ** 3 * 8 * C, dtype=torch.float32,
                          device=x01.device)
    _raise_if(_lib("mm_grad_keys_fwd")(
        x01.data_ptr(), keys.data_ptr(), cellsum.data_ptr(), B, res, C,
        align, smooth, stream), "mm_grad_table")
    keys_s, perm = sort_keys(keys, (res ** 3).bit_length())
    edges, n_edge = edge_buffer(B, 8 * C, x01.device)
    _raise_if(_lib("mm_grad_table_fwd")(
        keys_s.data_ptr(), perm.data_ptr(), x01.data_ptr(), g.data_ptr(),
        cellsum.data_ptr(), edges.data_ptr(), out.data_ptr(), B, res, C,
        hmap, spec.output_dim, lv * C, n_edge, align, smooth, int(bf16),
        stream), "mm_grad_table")
    mm_grad_table.launches += 1
    return out


def mm_grad_table(x01, g, spec: HashGridSpec, compute_dtype=None, out=None):
    """Table gradient of the dense matmul levels (``_mm_grad_table``) for
    the encode's cotangent g [B, L*C] -> flat [offsets[m] * C] f32 (into
    ``out`` if given), one :func:`mm_grad_level` a level. CPU tensors take
    :func:`mm_grad_table_plain`; CUDA tensors launch the kernels (one
    counted launch a dense level)."""
    if x01.device.type == "cpu":
        return mm_grad_table_plain(x01, g, spec, compute_dtype, out=out)
    C = spec.level_dim
    m = matmul_split(spec)
    n = spec.offsets[m] * C
    if out is None:
        out = torch.empty(n, dtype=torch.float32, device=x01.device)
    elif (out.shape != (n,) or out.dtype != torch.float32
          or out.device != x01.device or not out.is_contiguous()):
        raise ValueError("mm_grad_table: out must be a contiguous "
                         "[offsets[m] * C] f32 tensor on x01's device")
    for lv in range(m):
        mm_grad_level(x01, g, spec, lv, compute_dtype,
                      out=out[spec.offsets[lv] * C:spec.offsets[lv + 1] * C])
    return out


mm_grad_table.launches = 0   # kernel launches, counted where they happen


class _EncodeFn(torch.autograd.Function):
    """The encode with its table and input gradients; ``plain`` runs the
    plain versions of every kernel on any device."""

    @staticmethod
    def forward(ctx, params, x01, spec, compute_dtype, plain):
        base = w_word = None
        if not ctx.needs_input_grad[0]:
            # the input gradient alone (normals of a fixed field) reads no
            # records: the forward without them
            out = (hash_encode_fused_plain if plain else _encode_forward)(
                params, x01, spec, compute_dtype)
        elif plain:
            out = hash_encode_fused_plain(params, x01, spec, compute_dtype)
            base, w_word = window_records_plain(x01, spec)
        else:
            out, base, w_word = hash_encode_records(params, x01, spec,
                                                    compute_dtype)
        ctx.save_for_backward(params, x01, base, w_word)
        ctx.spec, ctx.compute_dtype, ctx.plain = spec, compute_dtype, plain
        return out

    @staticmethod
    def backward(ctx, g):
        params, x01, base, w_word = ctx.saved_tensors
        spec, dtype = ctx.spec, ctx.compute_dtype
        grad_table = grad_x = None
        if ctx.needs_input_grad[0]:
            grad_table = table_grad(spec, x01, base, w_word, g, dtype,
                                    plain=ctx.plain)
        if ctx.needs_input_grad[1]:
            g_in = g.to(torch.bfloat16 if dtype == torch.bfloat16
                        else torch.float32).contiguous()
            fn = encode_input_grad_plain if ctx.plain else encode_input_grad
            grad_x = fn(params.detach(), x01.detach(), g_in, spec, dtype)
        return grad_table, grad_x, None, None, None


def _encode(params, x01, spec, compute_dtype, plain):
    if torch.is_grad_enabled() and (params.requires_grad
                                    or x01.requires_grad):
        return _EncodeFn.apply(params, x01, spec, compute_dtype, plain)
    if plain:
        return hash_encode_fused_plain(params, x01, spec, compute_dtype)
    return _encode_forward(params, x01, spec, compute_dtype)


def hash_encode(params, x01, spec: HashGridSpec, compute_dtype=None):
    """Encode x01 [B, 3] in [0, 1]^3 against the flat table ``params``
    [n_params*C] f32 -> [B, L*C] in ``compute_dtype`` (f32 or bf16;
    default the table's f32), differentiable in ``params`` and in
    ``x01``. CPU tensors take the plain versions."""
    return _encode(params, x01, spec, compute_dtype, plain=False)


hash_encode.launches = 0   # kernel launches, counted where they happen


def hash_encode_plain(params, x01, spec: HashGridSpec, compute_dtype=None):
    """The plain version of :func:`hash_encode` on any device, with the
    same table gradient (plain records, plain segment totals)."""
    return _encode(params, x01, spec, compute_dtype, plain=True)
