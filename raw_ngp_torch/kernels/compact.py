"""Streaming compaction and its backward: wrappers of the CUDA kernels in
``csrc/compact.cu``.

Replaces ``raw_ngp_tpu/kernels/compact_pallas.py``: the forward
``_compact_words_impl`` (``:118``, reached by ``compact_attrs_pallas``
``:190``) and its VJP ``_compact_attrs_bwd`` (``:224``).
:func:`compact_attrs` is differentiable in the attributes (pose refinement
sends gradients back through the compacted t and dt). The plain versions
are ``compact_positions`` + ``gather_flat_sorted`` (ports of
``render/occupancy.py:576`` and ``:727``) forward and
:func:`compact_attrs_bwd_plain` backward; the wrappers take them only for
tensors on the CPU. On a CUDA tensor the kernels launch or the call
raises. Bound on the card: bytes (see the source notes in
``csrc/compact.cu``).
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


def compact_attrs_bwd_plain(g_attrs, pos, M: int):
    """Plain backward (JAX's scatter-set): the cotangent of each filled
    slot [n_attr, m_pad] written to its source index ``pos``, 0 at every
    other of the M flat records."""
    filled = torch.nonzero(pos < M).squeeze(1)
    out = torch.zeros(g_attrs.shape[0], M, dtype=g_attrs.dtype,
                      device=g_attrs.device)
    return out.index_copy_(1, pos[filled].to(torch.int64),
                           g_attrs[:, filled])


def _lib(name="compact_attrs_fwd"):
    lib = _build.load("compact")
    fn = getattr(lib, name)
    if name == "compact_attrs_fwd":
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 \
            + [ctypes.c_void_p]
    else:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 \
            + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def compact_attrs_bwd(g_attrs, keys, pos, m_pad: int):
    """Gradient of :func:`compact_attrs` in its attributes: g_attrs
    [n_attr, m_pad] f32 slot cotangents, keys [M] i32 and pos [m_pad] i32
    of the forward -> [n_attr, M] f32. CPU tensors take
    :func:`compact_attrs_bwd_plain`; CUDA tensors launch the kernel, which
    gathers by ``keys`` (bit-exact with the plain version)."""
    M = keys.shape[0]
    if g_attrs.device.type == "cpu":
        return compact_attrs_bwd_plain(g_attrs, pos, M)
    n_attr = g_attrs.shape[0]
    dev = g_attrs.device
    if dev.type != "cuda" or keys.device != dev:
        raise ValueError("compact_attrs_bwd: all inputs must be on one CUDA "
                         "device")
    if g_attrs.dtype != torch.float32 or keys.dtype != torch.int32:
        raise TypeError("compact_attrs_bwd: g_attrs f32, keys i32")
    if g_attrs.shape != (n_attr, m_pad) or keys.ndim != 1:
        raise ValueError("compact_attrs_bwd: need g_attrs [n_attr, m_pad] "
                         "and keys [M]")
    if not (g_attrs.is_contiguous() and keys.is_contiguous()):
        raise ValueError("compact_attrs_bwd: inputs must be contiguous")
    out = torch.empty(n_attr, M, dtype=torch.float32, device=dev)
    if M == 0:
        return out
    err = _lib("compact_attrs_bwd")(
        g_attrs.data_ptr(), keys.data_ptr(), out.data_ptr(), M, m_pad,
        n_attr, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"compact_attrs_bwd: CUDA launch failed "
                           f"(error {err})")
    compact_attrs_bwd.launches += 1
    return out


compact_attrs_bwd.launches = 0   # kernel launches, counted where they happen


class _CompactFn(torch.autograd.Function):
    """:func:`compact_attrs` with its attribute gradient; ``plain`` runs
    the plain versions in both directions on any device."""

    @staticmethod
    def forward(ctx, attrs, keys, count_incl, m_pad, plain):
        pos, attrs_c = _compact_forward(attrs, keys, count_incl, m_pad,
                                        plain)
        ctx.save_for_backward(keys, pos)
        ctx.m_pad, ctx.plain = m_pad, plain
        ctx.mark_non_differentiable(pos)
        return pos, attrs_c

    @staticmethod
    def backward(ctx, g_pos, g_attrs):
        keys, pos = ctx.saved_tensors
        g = g_attrs.contiguous()
        if ctx.plain:
            grad = compact_attrs_bwd_plain(g, pos, keys.shape[0])
        else:
            grad = compact_attrs_bwd(g, keys, pos, ctx.m_pad)
        return grad, None, None, None, None


def compact_attrs(attrs, keys, count_incl, m_pad: int, plain: bool = False):
    """Compact the kept records of a flat stream.

    attrs: [n_attr, M] f32 per-record attributes; keys: [M] i32 rank
    (count_incl - 1) of each kept record with rank < m_pad, SENTINEL
    otherwise; count_incl: [M] i32 inclusive count of the keep mask.
    Returns (pos [m_pad] i32, attrs_c [n_attr, m_pad] f32): the flat source
    index of the rank-r kept record, ascending, with sentinel M in unfilled
    slots, and the attributes at that index (0 in unfilled slots),
    bit-exact. Differentiable in ``attrs`` (:func:`compact_attrs_bwd`).
    ``plain=True`` runs the plain versions on any device.
    """
    if torch.is_grad_enabled() and attrs.requires_grad:
        return _CompactFn.apply(attrs, keys, count_incl, m_pad, plain)
    return _compact_forward(attrs, keys, count_incl, m_pad, plain)


def _compact_forward(attrs, keys, count_incl, m_pad: int, plain=False):
    """The forward: kernel for CUDA tensors, plain version on the CPU (or
    for ``plain``)."""
    if plain or attrs.device.type == "cpu":
        _, _, pos = compact_positions(keys < m_pad, m_pad)
        return pos, torch.stack([gather_flat_sorted(a, pos) for a in attrs])
    n_attr, M = attrs.shape
    dev = attrs.device
    if dev.type != "cuda" or keys.device != dev or count_incl.device != dev:
        raise ValueError("compact_attrs: all inputs must be on one CUDA "
                         "device")
    if attrs.dtype != torch.float32 or keys.dtype != torch.int32 \
            or count_incl.dtype != torch.int32:
        raise TypeError("compact_attrs: attrs f32, keys and count_incl i32")
    if keys.shape != (M,) or count_incl.shape != (M,):
        raise ValueError("compact_attrs: keys and count_incl must be [M]")
    if not (attrs.is_contiguous() and keys.is_contiguous()
            and count_incl.is_contiguous()):
        raise ValueError("compact_attrs: inputs must be contiguous")
    if not 0 < M < 2 ** 31 or m_pad <= 0:
        raise ValueError(f"compact_attrs: need 0 < M < 2^31 and m_pad > 0, "
                         f"got M={M}, m_pad={m_pad}")
    pos = torch.empty(m_pad, dtype=torch.int32, device=dev)
    attrs_c = torch.empty(n_attr, m_pad, dtype=torch.float32, device=dev)
    err = _lib()(attrs.data_ptr(), keys.data_ptr(), count_incl.data_ptr(),
                 pos.data_ptr(), attrs_c.data_ptr(), M, m_pad, n_attr,
                 torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"compact_attrs: CUDA launch failed (error {err})")
    compact_attrs.launches += 1
    return pos, attrs_c


compact_attrs.launches = 0   # kernel launches, counted where they happen
