"""Streaming compaction: wrapper of the CUDA kernel ``csrc/compact.cu``.

Replaces ``raw_ngp_tpu/kernels/compact_pallas.py`` (``_compact_words_impl``
``:118``, reached by ``compact_attrs_pallas`` ``:190``), forward only:
attributes that require a gradient raise. The
plain version is ``compact_positions`` + ``gather_flat_sorted`` below
(ports of ``render/occupancy.py:576`` and ``:727``); the wrapper takes it
only for tensors on the CPU.
On a CUDA tensor the kernel launches or the call raises. Bound on the
card: bytes (see the source note in ``csrc/compact.cu``).
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


def _lib():
    lib = _build.load("compact")
    fn = lib.compact_attrs_fwd
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def compact_attrs(attrs, keys, count_incl, m_pad: int):
    """Compact the kept records of a flat stream.

    attrs: [n_attr, M] f32 per-record attributes; keys: [M] i32 rank
    (count_incl - 1) of each kept record with rank < m_pad, SENTINEL
    otherwise; count_incl: [M] i32 inclusive count of the keep mask.
    Returns (pos [m_pad] i32, attrs_c [n_attr, m_pad] f32): the flat source
    index of the rank-r kept record, ascending, with sentinel M in unfilled
    slots, and the attributes at that index (0 in unfilled slots),
    bit-exact.
    """
    if torch.is_grad_enabled() and attrs.requires_grad:
        raise NotImplementedError("compact_attrs: the attributes' gradient "
                                  "(B1's backward) is not ported")
    if attrs.device.type == "cpu":
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
