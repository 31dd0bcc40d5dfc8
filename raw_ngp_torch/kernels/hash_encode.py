"""Hash-grid encode forward: wrapper of the CUDA kernel ``csrc/hash_encode.cu``.

Replaces ``raw_ngp_tpu/kernels/hash_fused.py`` ``hash_encode_fused``
(forward, ``:497``) and its world-space wrapper ``hash_encode_fast``
(``:784``). The plain version is ``raw_ngp_torch.ops.hashgrid
.hash_encode_01``; it runs only for tensors on the CPU. On a CUDA tensor
the kernel launches or the call raises. Bound on the card: bytes (a
gather; see the source note in ``csrc/hash_encode.cu``). The backward
(table gradient) is not ported yet, so the kernel refuses inputs that
would need one.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from raw_ngp_torch.kernels import _build
from raw_ngp_torch.ops.hashgrid import HashGridSpec, hash_encode_01, \
    level_layout

_MODES = {"stride": 0, "xor": 1, "additive": 2}
_CHANNELS = (1, 2, 4, 8, 16, 32)


@functools.lru_cache(maxsize=16)
def _level_table(spec: HashGridSpec, device: torch.device):
    """[L, 9] i64 rows the kernel reads per level: res, hmap, offset,
    n_strides, stride0..2, mode, pair axis."""
    rows = []
    for lv in range(spec.num_levels):
        res, hmap, offset, strides, mode, axis = level_layout(spec, lv)
        s = list(strides) + [0] * (3 - len(strides))
        rows.append([res, hmap, offset, len(strides), *s, _MODES[mode], axis])
    return torch.tensor(rows, dtype=torch.int64, device=device)


def _lib():
    lib = _build.load("hash_encode")
    fn = lib.hash_encode_fwd
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def hash_encode(params, x01, spec: HashGridSpec, compute_dtype=None):
    """Encode x01 [B, 3] in [0, 1]^3 against the flat table ``params``
    [n_params*C] f32 -> [B, L*C] in ``compute_dtype`` (f32 or bf16;
    default the table's f32). CPU tensors take the plain version."""
    if params.device.type == "cpu":
        return hash_encode_01(params, x01, spec, compute_dtype=compute_dtype)
    out_dtype = compute_dtype or params.dtype
    B = x01.shape[0]
    L, C = spec.num_levels, spec.level_dim
    if params.device.type != "cuda" or x01.device != params.device:
        raise ValueError("hash_encode: params and x01 must be on one CUDA "
                         "device")
    if torch.is_grad_enabled() and (params.requires_grad
                                    or x01.requires_grad):
        raise NotImplementedError("hash_encode: the kernel's backward is "
                                  "not ported; call under torch.no_grad()")
    if spec.input_dim != 3 or x01.ndim != 2 or x01.shape[1] != 3:
        raise ValueError(f"hash_encode: x01 must be [B, 3], got "
                         f"{tuple(x01.shape)}")
    if params.dtype != torch.float32 or x01.dtype != torch.float32:
        raise TypeError("hash_encode: params and x01 must be float32")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"hash_encode: compute_dtype {out_dtype} not in "
                        f"(float32, bfloat16)")
    if C not in _CHANNELS:
        raise ValueError(f"hash_encode: level_dim {C} not in {_CHANNELS}")
    if params.numel() != spec.n_params * C:
        raise ValueError("hash_encode: table size does not match the spec")
    if not (params.is_contiguous() and x01.is_contiguous()):
        raise ValueError("hash_encode: params and x01 must be contiguous")
    if params.data_ptr() % 16:
        raise ValueError("hash_encode: table must be 16-byte aligned")
    out = torch.empty(B, L * C, dtype=out_dtype, device=x01.device)
    if B == 0:
        return out
    levels = _level_table(spec, x01.device)
    fn = _lib()
    err = fn(x01.data_ptr(), params.data_ptr(), levels.data_ptr(),
             out.data_ptr(), B, L, C, int(spec.align_corners),
             int(spec.interpolation == "smoothstep"),
             int(out_dtype == torch.bfloat16),
             torch.cuda.current_stream(x01.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"hash_encode: CUDA launch failed (error {err})")
    hash_encode.launches += 1
    return out


hash_encode.launches = 0   # kernel launches, counted where they happen
