"""The render's budget decimation and streaming compaction, folded: the
wrapper of the CUDA kernels in ``csrc/compact.cu``, and their plain
versions.

Replaces ``raw_ngp_tpu/kernels/compact_pallas.py``: the forward
``_compact_words_impl`` (``:118``, reached by ``compact_attrs_pallas``
``:190``) and its VJP ``_compact_attrs_bwd`` (``:224``), together with the
work the JAX package runs around them: the budget decimation
(``raw_ngp_tpu/render/occupancy.py:880-885``) and the count, keys and
attribute stack of ``compact_positions_attrs`` (``:632-638``).
:func:`decimate_compact` does all of it in one per-ray pipeline, forward
and backward, with the same bits as that chain, whose plain version is
:func:`decimate_compact_plain`; the wrapper takes the plain version only
for tensors on the CPU. On a CUDA tensor the kernels launch or the call
raises. Bound on the card: bytes (see the source notes in
``csrc/compact.cu``).

:func:`compact_attrs` (with :func:`compact_attrs_bwd`) and
:func:`compact_positions_attrs` are the plain torch counterparts of the
JAX interface ``compact_attrs_pallas`` and of ``compact_positions_attrs``
(ports of ``render/occupancy.py:576``, ``:618`` and ``:727``), on any
device; the plain version of the fold is built on them.
"""

from __future__ import annotations

import ctypes

import torch

from raw_ngp_torch.kernels import _build

# key of a dropped record: larger than any real rank
SENTINEL = 0x7F000000


def compact_positions(mask, m_pad: int):
    """Plain compaction: the flat source index of every kept sample.

    The static-shape monotone scheme of the JAX package: kept sample
    number c (1-based) writes row 2c of a [2*m_pad + 2] buffer, dropped
    samples write odd rows, and the even rows are the result.

    Returns (kept [mask.shape] bool: the first m_pad valid samples,
    inv [M] i32: packed row per flat sample (m_pad for dropped ones),
    pos [m_pad] i32: flat source index per packed row, ascending;
    unfilled rows hold the sentinel M).
    """
    flat = mask.reshape(-1)
    M = flat.shape[0]
    c = torch.cumsum(flat.to(torch.int32), 0, dtype=torch.int32)
    kept = flat & (c <= m_pad)
    dest = torch.where(kept, 2 * c, torch.clamp_max(2 * c + 1, 2 * m_pad + 1))
    inv = torch.where(kept, c - 1, m_pad).to(torch.int32)
    buf = torch.full((2 * m_pad + 2,), M, dtype=torch.int32,
                     device=mask.device)
    # even rows get one writer each; odd rows collect dropped samples,
    # whichever lands last, and are discarded
    buf.scatter_(0, dest.to(torch.int64),
                 torch.arange(M, dtype=torch.int32, device=mask.device))
    return kept.reshape(mask.shape), inv, buf[2::2]


def gather_flat_sorted(values, pos):
    """``values[pos]`` for a flat [M] array at ascending positions
    [m_pad]; the sentinel M reads 0."""
    M = values.shape[0]
    v = values[torch.clamp_max(pos, M - 1).to(torch.int64)]
    return torch.where(pos < M, v, torch.zeros((), dtype=v.dtype,
                                               device=v.device))


def compact_attrs_bwd(g_attrs, pos, M: int):
    """Gradient of :func:`compact_attrs` in its attributes (JAX's
    scatter-set): the cotangent of each filled slot [n_attr, m_pad]
    written to its source index ``pos``, 0 at every other of the M flat
    records."""
    filled = torch.nonzero(pos < M).squeeze(1)
    out = torch.zeros(g_attrs.shape[0], M, dtype=g_attrs.dtype,
                      device=g_attrs.device)
    return out.index_copy_(1, pos[filled].to(torch.int64),
                           g_attrs[:, filled])


class _CompactFn(torch.autograd.Function):
    """:func:`compact_attrs` with its attribute gradient."""

    @staticmethod
    def forward(ctx, attrs, keys, m_pad):
        pos, attrs_c = _compact_forward(attrs, keys, m_pad)
        ctx.save_for_backward(pos)
        ctx.M = keys.shape[0]
        ctx.mark_non_differentiable(pos)
        return pos, attrs_c

    @staticmethod
    def backward(ctx, g_pos, g_attrs):
        (pos,) = ctx.saved_tensors
        grad = compact_attrs_bwd(g_attrs.contiguous(), pos, ctx.M)
        return grad, None, None


def compact_attrs(attrs, keys, m_pad: int):
    """Compact the kept records of a flat stream (plain torch, any device).

    attrs: [n_attr, M] f32 per-record attributes; keys: [M] i32 rank
    (inclusive count - 1) of each kept record with rank < m_pad, SENTINEL
    otherwise (the JAX interface also takes the inclusive count; the keys
    alone decide the result).
    Returns (pos [m_pad] i32, attrs_c [n_attr, m_pad] f32): the flat source
    index of the rank-r kept record, ascending, with sentinel M in unfilled
    slots, and the attributes at that index (0 in unfilled slots),
    bit-exact. Differentiable in ``attrs`` (:func:`compact_attrs_bwd`).
    """
    if torch.is_grad_enabled() and attrs.requires_grad:
        return _CompactFn.apply(attrs, keys, m_pad)
    return _compact_forward(attrs, keys, m_pad)


def _compact_forward(attrs, keys, m_pad: int):
    _, _, pos = compact_positions(keys < m_pad, m_pad)
    return pos, torch.stack([gather_flat_sorted(a, pos) for a in attrs])


def compact_positions_attrs(mask, m_pad: int, attrs):
    """Compaction of the kept samples fused with their attribute gathers,
    differentiable in the attributes (``compact_positions_attrs``,
    ``raw_ngp_tpu/render/occupancy.py:618``).

    The inclusive count and the keys are computed here, as the JAX package
    does outside its Pallas kernel, and handed to :func:`compact_attrs`.
    Returns (kept [N, K], inv [M], pos [m_pad], attrs_c list of [m_pad]).
    """
    flat = mask.reshape(-1)
    c = torch.cumsum(flat.to(torch.int32), 0, dtype=torch.int32)
    kept = flat & (c <= m_pad)
    inv = torch.where(kept, c - 1, m_pad).to(torch.int32)
    keys = torch.where(kept, c - 1, SENTINEL).to(torch.int32)
    pos, attrs_c = compact_attrs(
        torch.stack([a.float() for a in attrs]).contiguous(), keys, m_pad)
    return kept.reshape(mask.shape), inv, pos, list(attrs_c.unbind(0))


def decimate_compact_plain(mask, miss, ts, deltas, m_pad: int,
                           positions: bool = False):
    """Plain version of :func:`decimate_compact`: the render's chain as the
    JAX package runs it (``render/occupancy.py:880-885``, then
    ``compact_positions_attrs``, ``:618``), in eager
    torch ops, differentiable in ``ts`` and ``deltas``; with
    ``positions`` also the ``pos`` of ``compact_positions_attrs``."""
    N, K = mask.shape
    mask = mask & ~miss.reshape(N, 1)
    # over budget: decimate uniformly along each ray and scale dt by the
    # stride (all on the device: no host sync)
    valid_total = mask.sum()
    stride = torch.clamp_min((valid_total + m_pad - 1) // m_pad, 1)
    k_idx = torch.cumsum(mask.to(torch.int32), dim=1, dtype=torch.int32) - 1
    mask = mask & ((k_idx % stride) == 0)
    deltas = deltas * stride.float()
    attrs = [ts.reshape(-1), deltas.expand(N, K).reshape(-1)]
    mask, _, pos, (t_c, dt_c) = compact_positions_attrs(mask, m_pad, attrs)
    M = N * K
    # unfilled slots (pos == M) read the dummy ray row N; the sentinel also
    # keeps rid ascending
    filled = pos < M
    rid = torch.where(filled, torch.clamp_max(pos, M - 1) // K, N)
    out = (t_c, dt_c, rid, filled, mask.sum(dim=-1), valid_total,
           mask.sum())
    return out + (pos.contiguous(),) if positions else out


_ARGTYPES = {
    "decimate_compact_fwd": [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 2
    + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p],
    "decimate_compact_bwd": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
    + [ctypes.c_void_p],
}
_fns = {}


def _lib(name):
    """A C entry point of ``csrc/compact.cu``, bound once (argtypes and
    restype set at first use, then served from a dict)."""
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(_build.load("compact"), name)
        fn.argtypes, fn.restype = _ARGTYPES[name], ctypes.c_int
        _fns[name] = fn
    return fn


def _decimate_check(mask, miss, ts, deltas, m_pad: int):
    """What the fold's kernels take; raises on anything else."""
    dev = mask.device
    if dev.type != "cuda" or miss.device != dev or ts.device != dev \
            or deltas.device != dev:
        raise ValueError("decimate_compact: all inputs must be on one CUDA "
                         "device")
    if mask.dtype != torch.bool or miss.dtype != torch.bool \
            or ts.dtype != torch.float32 or deltas.dtype != torch.float32:
        raise TypeError("decimate_compact: mask and miss bool, ts and deltas "
                        "f32")
    if mask.ndim != 2 or ts.shape != mask.shape \
            or deltas.shape != mask.shape or miss.numel() != mask.shape[0]:
        raise ValueError("decimate_compact: need mask, ts and deltas [N, K] "
                         "and miss [N] or [N, 1]")
    N, K = mask.shape
    if not 0 < N * K < 2 ** 31 or m_pad <= 0:
        raise ValueError(f"decimate_compact: need 0 < N * K < 2^31 and "
                         f"m_pad > 0, got N={N}, K={K}, m_pad={m_pad}")
    if not (mask.is_contiguous() and ts.is_contiguous()
            and miss.is_contiguous()):
        raise ValueError("decimate_compact: mask, ts and miss must be "
                         "contiguous")


def _decimate_alloc(N: int, K: int, m_pad: int, dev):
    """The fold's outputs and its scratch (the valid words, per-ray counts
    and bases, the stride and the passes' partial counts: at most N *
    ceil(K / 32) + 3N + 2 int32 words, csrc/compact.cu lays them out),
    kept for the backward."""
    return (torch.empty(2, m_pad, dtype=torch.float32, device=dev),
            torch.empty(m_pad, dtype=torch.int32, device=dev),
            torch.empty(m_pad, dtype=torch.bool, device=dev),
            torch.empty(N + 2, dtype=torch.int64, device=dev),
            torch.empty(N * ((K + 31) // 32) + 3 * N + 2, dtype=torch.int32,
                        device=dev))


def _decimate_forward(mask, miss, ts, deltas, m_pad: int,
                      positions: bool = False):
    """The three launches of the fold -> (tdt [2, m_pad], rid, filled,
    counts [N + 2] (per ray, valid_total, num_points), scratch, pos [m_pad]
    i32 with ``positions``, else None)."""
    _decimate_check(mask, miss, ts, deltas, m_pad)
    N, K = mask.shape
    dev = mask.device
    tdt, rid, filled, counts, scratch = _decimate_alloc(N, K, m_pad, dev)
    pos = (torch.empty(m_pad, dtype=torch.int32, device=dev) if positions
           else None)
    err = _lib("decimate_compact_fwd")(
        mask.data_ptr(), miss.data_ptr(), ts.data_ptr(), deltas.data_ptr(),
        deltas.stride(0), deltas.stride(1), tdt.data_ptr(), rid.data_ptr(),
        filled.data_ptr(), counts.data_ptr(), scratch.data_ptr(),
        None if pos is None else pos.data_ptr(), N, K, m_pad,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"decimate_compact: CUDA launch failed "
                           f"(error {err})")
    decimate_compact.launches += 1
    return tdt, rid, filled, counts, scratch, pos


def decimate_compact_bwd(g, scratch, N: int, K: int, m_pad: int):
    """Gradient of :func:`decimate_compact` in ts and deltas: g [2, m_pad]
    f32 (the cotangents of t_c and dt_c) and the forward's scratch ->
    (g_ts, g_deltas) [N, K] f32: each kept sample's slot cotangent (dt's
    times the stride), 0 elsewhere. CUDA tensors only."""
    dev = g.device
    if dev.type != "cuda" or scratch.device != dev:
        raise ValueError("decimate_compact_bwd: all inputs must be on one "
                         "CUDA device")
    if g.dtype != torch.float32 or g.shape != (2, m_pad) \
            or not g.is_contiguous():
        raise ValueError("decimate_compact_bwd: need g [2, m_pad] f32, "
                         "contiguous")
    # two allocations, as the chain it replaces leaves them: the sum over
    # K of g_deltas (the expand's backward) then reads the same layout
    g_ts = torch.empty(N, K, dtype=torch.float32, device=dev)
    g_deltas = torch.empty(N, K, dtype=torch.float32, device=dev)
    err = _lib("decimate_compact_bwd")(
        g.data_ptr(), scratch.data_ptr(), g_ts.data_ptr(),
        g_deltas.data_ptr(), N, K, m_pad,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"decimate_compact_bwd: CUDA launch failed "
                           f"(error {err})")
    decimate_compact_bwd.launches += 1
    return g_ts, g_deltas


decimate_compact_bwd.launches = 0   # launches, counted where they happen


class _DecimateCompactFn(torch.autograd.Function):
    """The fold with its gradient in ts and deltas (a full [N, K] gradient
    for the march's stride-0 deltas view; autograd's expand backward sums
    it over K)."""

    @staticmethod
    def forward(ctx, mask, miss, ts, deltas, m_pad, positions):
        tdt, rid, filled, counts, scratch, pos = _decimate_forward(
            mask, miss, ts, deltas, m_pad, positions)
        ctx.save_for_backward(scratch)
        ctx.shape = (mask.shape[0], mask.shape[1], m_pad)
        ctx.mark_non_differentiable(rid, filled, counts)
        if pos is None:
            return tdt, rid, filled, counts
        ctx.mark_non_differentiable(pos)
        return tdt, rid, filled, counts, pos

    @staticmethod
    def backward(ctx, g_tdt, *_):
        (scratch,) = ctx.saved_tensors
        g_ts, g_deltas = decimate_compact_bwd(g_tdt.contiguous(), scratch,
                                              *ctx.shape)
        return None, None, g_ts, g_deltas, None, None


def decimate_compact(mask, miss, ts, deltas, m_pad: int, plain: bool = False,
                     positions: bool = False):
    """The render's budget decimation and compaction, folded.

    mask [N, K] bool (the march's occupancy), miss [N] or [N, 1] bool (rays
    that miss the box), ts [N, K] f32, deltas [N, K] f32 (the march's
    ``dt.expand(N, K)``, read through its strides), m_pad the slot budget.
    The valid samples (mask & ~miss) are decimated uniformly along each ray
    by stride = max(ceil(valid_total / m_pad), 1) and the kept ones packed
    ray-major into m_pad slots. Returns (t_c [m_pad], dt_c [m_pad] (dt *
    stride), rid [m_pad] i32 (N in unfilled slots, so ascending), filled
    [m_pad] bool, counts [N] i64 (samples kept a ray), valid_total (0-d
    i64, before decimation), num_points (0-d i64, slots filled)); unfilled
    slots hold t_c = dt_c = 0. With ``positions`` an eighth output, pos
    [m_pad] i32: each slot's flat source index r * K + k, N * K where
    unfilled (the place kernel's one extra store). Differentiable in ts
    and deltas. CPU tensors or ``plain=True`` take
    :func:`decimate_compact_plain`; CUDA tensors launch the kernels
    (three forward, one backward), bit-exact with it.
    """
    if plain or mask.device.type == "cpu":
        return decimate_compact_plain(mask, miss, ts, deltas, m_pad,
                                      positions)
    if torch.is_grad_enabled() and (ts.requires_grad
                                    or deltas.requires_grad):
        tdt, rid, filled, counts, *pos = _DecimateCompactFn.apply(
            mask, miss, ts, deltas, m_pad, positions)
    else:
        tdt, rid, filled, counts, _, pos = _decimate_forward(
            mask, miss, ts, deltas, m_pad, positions)
        pos = [pos] if positions else []
    N = mask.shape[0]
    t_c, dt_c = tdt.unbind(0)
    return (t_c, dt_c, rid, filled, counts[:N], counts[N],
            counts[N + 1], *pos)


decimate_compact.launches = 0   # forward calls that launched the kernels
