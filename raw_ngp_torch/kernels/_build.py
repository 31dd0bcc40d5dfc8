"""Build the port's CUDA kernels from ``raw_ngp_torch/csrc/`` and load them.

Each ``csrc/<name>.cu`` (with the headers ``csrc/*.cuh`` it includes) has
a plain C interface and is compiled by
``nvcc`` for Hopper (``sm_90a``) into ``build/raw_ngp_torch/lib<name>.so``
at the repository root, then bound with ctypes. Nothing is built at
import time: the first launch builds, or a caller builds every source at
once with :func:`build_all` (one ``nvcc`` process per source, all started
together). A missing ``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "raw_ngp_torch"
SOURCES = ("compact", "hash_encode", "hash_grad", "radix_sort", "segsum")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("raw_ngp_torch: nvcc not found (set CUDA_HOME or put "
                       "nvcc on PATH); the CUDA kernels cannot be built")


def _target(name: str) -> Path:
    """Library path keyed by the content of the source and of the headers
    beside it (``csrc/*.cuh``), so an edited source is never served by a
    stale build."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build_all(names: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Compile every named source not yet built, all in parallel; returns
    {name: ptxas report}. Raises with nvcc's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in names:
        out = _target(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    reports, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        reports[name] = log
        if proc.returncode != 0:
            failed.append(f"--- {name}.cu (exit {proc.returncode}) ---\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("raw_ngp_torch: kernel build failed\n"
                           + "\n".join(failed))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of ``lib<name>.so``, building it on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build_all([name])
            lib = ctypes.CDLL(str(_target(name)))
            _libs[name] = lib
        return lib
