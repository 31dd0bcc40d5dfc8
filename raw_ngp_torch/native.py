"""ctypes bindings for the port's native host runtime
(``raw_ngp_torch/csrc/host_native.cpp``; counterpart of
``raw_ngp_tpu/native.py``) and for the JPEG entropy coder
(``raw_ngp_torch/csrc/jpeg_host.cpp``, :func:`jpeg_library`, used by
``data/jpeg.py`` and, for lossless JPEG DNGs, ``data/dng.py``, which keep
a pure-Python route for a machine without ``g++``).

Each library is built at first use with ``g++ -O3 -march=native -shared
-fPIC -fopenmp`` (and without ``-fopenmp`` where that fails), the flags of
the JAX package's build, into ``build/raw_ngp_torch/`` under a name keyed
by the source's hash; the build writes a temporary file and renames it, so
processes that build at once never load half a file. Every entry point
has a numpy fallback for a machine without ``g++``: the same numpy as the
JAX package's fallback, bit for bit (its Morton codes through the port's
``ops/morton.py``). The two routes can differ by an ulp:
``normalize_levels`` multiplies by the f32 reciprocal in C++ where numpy
divides, ``demosaic_rggb`` sums in another order, and ``linear_to_srgb``
clamps at 1e-9 in C++ where numpy clamps at f32 eps.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from raw_ngp_torch.kernels._build import BUILD_DIR, CSRC
from raw_ngp_torch.postprocess.raw import bilinear_demosaic

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False
_JPEG_LIB: Optional[ctypes.CDLL] = None
_JPEG_TRIED = False

SOURCE = CSRC / "host_native.cpp"
JPEG_SOURCE = CSRC / "jpeg_host.cpp"
FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")

_f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_u32p = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
_u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
_i16p = np.ctypeslib.ndpointer(np.int16, flags="C_CONTIGUOUS")
_i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_u16p = np.ctypeslib.ndpointer(np.uint16, flags="C_CONTIGUOUS")


def library_path(source: Path = SOURCE) -> Path:
    """Where the library of a source (the host library by default) is
    built."""
    h = hashlib.sha256(source.read_bytes()).hexdigest()[:12]
    stem = "host_native" if source == SOURCE else source.stem
    return BUILD_DIR / f"lib{stem}-{h}.so"


def _build(target: Optional[Path] = None,
           source: Path = SOURCE) -> Optional[str]:
    so = library_path() if target is None else target
    if so.exists():
        return str(so)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    for extra in (("-fopenmp",), ()):
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            subprocess.run(["g++", *FLAGS, *extra, str(source), "-o", tmp],
                           check=True, capture_output=True, timeout=120)
            os.replace(tmp, so)
            return str(so)
        except (subprocess.CalledProcessError, FileNotFoundError,
                subprocess.TimeoutExpired):
            continue
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return None


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    with _LOCK:
        if _LIB is not None or _TRIED:
            return _LIB
        _TRIED = True
        so = _build()
        if so is None:
            return None
        lib = ctypes.CDLL(so)
        lib.demosaic_rggb.argtypes = [_f32p, ctypes.c_int64,
                                      ctypes.c_int64, _f32p]
        lib.normalize_levels.argtypes = [_f32p, ctypes.c_int64,
                                         ctypes.c_float, ctypes.c_float,
                                         ctypes.c_int]
        lib.morton3d_encode.argtypes = [_i32p, ctypes.c_int64, _u32p]
        lib.morton3d_decode.argtypes = [_u32p, ctypes.c_int64, _i32p]
        lib.packbits.argtypes = [_f32p, ctypes.c_int64, ctypes.c_float,
                                 _u8p]
        lib.linear_to_srgb.argtypes = [_f32p, ctypes.c_int64]
        lib.version.restype = ctypes.c_int
        _LIB = lib
        return _LIB


def jpeg_library() -> Optional[ctypes.CDLL]:
    """The JPEG entropy coder (``csrc/jpeg_host.cpp``: the JPEG scan
    decode and encode and the lossless JPEG scan decode), built at first
    use; None where it does not build."""
    global _JPEG_LIB, _JPEG_TRIED
    with _LOCK:
        if _JPEG_LIB is not None or _JPEG_TRIED:
            return _JPEG_LIB
        _JPEG_TRIED = True
        so = _build(library_path(JPEG_SOURCE), JPEG_SOURCE)
        if so is None:
            return None
        lib = ctypes.CDLL(so)
        i64, i32 = ctypes.c_int64, ctypes.c_int
        lib.jpeg_decode_scan.argtypes = [
            ctypes.c_char_p, i64, i64, i32, _i32p, _u8p, i32, i32, i32, i32,
            i32, i32, i32, _i16p, _i64p]
        lib.jpeg_decode_scan.restype = i32
        lib.jpeg_encode_blocks.argtypes = [_i16p, _i32p, i64, _u32p, i32,
                                           i32, i32, _u8p, i64]
        lib.jpeg_encode_blocks.restype = i64
        lib.lj92_decode_scan.argtypes = [
            ctypes.c_char_p, i64, i64, i32, _i32p, _u8p, i32, i32, i32, i32,
            i32, i32, _u16p, _i64p]
        lib.lj92_decode_scan.restype = i32
        lib.jpeg_host_version.restype = i32
        _JPEG_LIB = lib
        return _JPEG_LIB


def available() -> bool:
    """Whether the C++ library is built and loaded (builds it if not)."""
    return _load() is not None


def demosaic_rggb(bayer: np.ndarray) -> np.ndarray:
    """Bilinear RGGB demosaic of a [H, W] mosaic -> [H, W, 3] float32
    (wrap-around at the edges)."""
    lib = _load()
    bayer = np.ascontiguousarray(bayer, np.float32)
    if lib is None:
        return bilinear_demosaic(bayer).astype(np.float32)
    H, W = bayer.shape
    out = np.empty((H, W, 3), np.float32)
    lib.demosaic_rggb(bayer, H, W, out)
    return out


def normalize_levels(img: np.ndarray, black: float, white: float,
                     clip: bool = True) -> np.ndarray:
    """(img - black) / (white - black) in float32, after clipping img to
    [0, 1] when ``clip``; returns a new array."""
    lib = _load()
    img = np.ascontiguousarray(img, np.float32).copy()
    if lib is None:
        if clip:
            img = np.clip(img, 0.0, 1.0)
        return (img - black) / (white - black)
    lib.normalize_levels(img.reshape(-1), img.size, black, white,
                         int(clip))
    return img


def morton3d_encode(coords: np.ndarray) -> np.ndarray:
    """[N, 3] int32 coords -> [N] uint32 Morton codes."""
    lib = _load()
    coords = np.ascontiguousarray(coords, np.int32)
    if lib is None:
        import torch

        from raw_ngp_torch.ops.morton import morton3d
        codes = morton3d(torch.from_numpy(coords.astype(np.int64)
                                          & 0xFFFFFFFF))
        return (codes & 0xFFFFFFFF).numpy().astype(np.uint32)
    out = np.empty(len(coords), np.uint32)
    lib.morton3d_encode(coords, len(coords), out)
    return out


def morton3d_decode(codes: np.ndarray) -> np.ndarray:
    """[N] uint32 Morton codes -> [N, 3] int32 coords."""
    lib = _load()
    codes = np.ascontiguousarray(codes, np.uint32)
    if lib is None:
        import torch

        from raw_ngp_torch.ops.morton import morton3d_invert
        return morton3d_invert(torch.from_numpy(
            codes.astype(np.int64))).numpy()
    out = np.empty((len(codes), 3), np.int32)
    lib.morton3d_decode(codes, len(codes), out)
    return out


def packbits(grid: np.ndarray, thresh: float) -> np.ndarray:
    """Density grid -> bitfield, 8 cells a byte (cell i of a byte at bit
    i), a cell set where its density is above ``thresh``."""
    lib = _load()
    flat = np.ascontiguousarray(grid.reshape(-1), np.float32)
    if lib is None:
        occ = (flat > thresh).reshape(-1, 8)
        return (occ.astype(np.uint8)
                * (2 ** np.arange(8)).astype(np.uint8)).sum(-1)\
            .astype(np.uint8)
    out = np.empty(flat.size // 8, np.uint8)
    lib.packbits(flat, flat.size, thresh, out)
    return out


def linear_to_srgb(img: np.ndarray) -> np.ndarray:
    """The sRGB curve of ``postprocess.raw.linear_to_srgb`` in float32."""
    lib = _load()
    img = np.ascontiguousarray(img, np.float32).copy()
    if lib is None:
        from raw_ngp_torch.postprocess.raw import linear_to_srgb as ref
        return ref(img).astype(np.float32)
    lib.linear_to_srgb(img.reshape(-1), img.size)
    return img
