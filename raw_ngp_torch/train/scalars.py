"""A train step's per-step scalars on the device.

JAX's step computes its scalars (the LR at the optimizer's count, Adam's
bias corrections, the BARF / BAA-NGP annealing, the ``-O2`` proposal
gate, the pose freeze) from ``state.step`` and the count inside the
compiled program. The port's eager step computed them on the host as
numpy f32 scalars and handed them to each op as Python numbers, which a
CUDA graph would freeze at capture. Here each is a table of the host
values, built once in exactly that f32 arithmetic up to the count from
which the value no longer changes, copied to the device and read at a
device counter, so a captured step replayed at any step reads that
step's values with the eager step's bits. Integer rules (the gate, the
freeze) are device arithmetic on the counter.
"""

from __future__ import annotations

import math
from typing import Callable, Dict

import numpy as np
import torch

from raw_ngp_torch.config import Config
from raw_ngp_torch.models.ngp import DeviceAnnealing, _anneal_alpha

_F32 = np.float32


def annealing_at(cfg: Config, step: int):
    """The BARF / BAA-NGP annealing of a train step, clip(step / iters, 0,
    1) in f32 at the step before its increment."""
    return min(max(_F32(step) / _F32(cfg.train.iters), _F32(0.0)),
               _F32(1.0))


def first_count_at(fn: Callable[[int], float], value) -> int:
    """The first count at which ``fn`` reads exactly ``value``, by
    bisection: ``fn`` moves monotonically toward ``value`` and stays there
    once it reads it (a bias correction reaching 1.0, a decaying LR
    reaching 0.0)."""
    lo, hi = 0, 1
    while fn(hi) != value:
        hi *= 2
    while lo < hi:
        mid = (lo + hi) // 2
        if fn(mid) == value:
            hi = mid
        else:
            lo = mid + 1
    return lo


class CountTable:
    """``fn(count)`` for every count >= 0 on the device: the host values
    ``fn(0 .. const_from)`` (numpy f32 scalars, computed one by one as the
    eager step computed them) as an f32 tensor, built once and read at a
    device counter clamped to ``const_from``, the count from which ``fn``
    no longer changes.

    ``divisor``: the values divide tensors (:func:`divide`). PyTorch
    divides a CUDA tensor by a Python number as a multiply by the
    number's f32 reciprocal (``BinaryDivTrueKernel.cu``), a CPU tensor by
    true division; a divisor table on CUDA holds the f32 reciprocals
    (``reciprocal``), so the device step keeps the eager step's bits on
    either."""

    def __init__(self, fn: Callable[[int], float], device, const_from: int,
                 divisor: bool = False):
        device = torch.device(device)
        self.reciprocal = divisor and device.type == "cuda"
        host = [_F32(fn(c)) for c in range(const_from + 1)]
        if self.reciprocal:
            host = [_F32(1.0) / v for v in host]
        self.values = torch.from_numpy(np.asarray(host, np.float32)).to(
            device)

    def at(self, count_t: torch.Tensor) -> torch.Tensor:
        """The 0-d f32 value at the device counter ``count_t`` (0-d
        int64), no host read."""
        idx = torch.clamp_max(count_t, self.values.shape[0] - 1).reshape(1)
        return self.values.index_select(0, idx).reshape(())

    def entry(self, name: str, count_t: torch.Tensor) -> Dict[str,
                                                              torch.Tensor]:
        """{``name``: the value at ``count_t``}, or where the table holds
        reciprocals {``name`` + "_reciprocal": it}: a step's scalars say
        which of the two they hold."""
        return {name + ("_reciprocal" if self.reciprocal else ""):
                self.at(count_t)}


def divide(x: torch.Tensor, scalars: Dict[str, torch.Tensor], name: str):
    """x / ``scalars[name]`` as the eager step divided a tensor by the
    Python number: by true division, or where the scalars hold the
    reciprocal (CUDA, :meth:`CountTable.entry`) by a multiply."""
    r = scalars.get(name + "_reciprocal")
    return x / scalars[name] if r is None else x * r


class AnnealingTables:
    """The field's annealing a step reads (pose refinement only): the ramp
    position alpha of BARF (L = num_levels) or BAA-NGP (L = num_levels -
    1) at :func:`annealing_at`, and BAA-NGP's finest active level, each a
    :class:`CountTable` over the step (constant from ``train.iters``)."""

    def __init__(self, cfg: Config, device):
        mode = cfg.pose_opt.mode
        levels = cfg.model.num_levels
        self.L = levels if mode == "barf" else levels - 1
        iters = cfg.train.iters

        def alpha(s):
            return _anneal_alpha(cfg, annealing_at(cfg, s), self.L)

        self.alpha = CountTable(alpha, device, const_from=iters)
        self.j_star = None
        if mode == "baangp":
            self.j_star = CountTable(
                lambda s: min(max(math.ceil(float(alpha(s))), 0),
                              levels - 1), device, const_from=iters)

    def at(self, step_t: torch.Tensor) -> DeviceAnnealing:
        j = None if self.j_star is None else \
            self.j_star.at(step_t).to(torch.int64)
        return DeviceAnnealing(L=self.L, alpha=self.alpha.at(step_t),
                               j_star=j)


def on_device(make: Callable):
    """device -> ``make(device)``, made the first time a device is asked
    for and kept (an optimizer's tables: one set a device)."""
    made: Dict = {}

    def get(device):
        device = torch.device(device)
        if device not in made:
            made[device] = make(device)
        return made[device]
    return get


def sync_counter(holder, attr: str, device) -> torch.Tensor:
    """The device counter ``<attr>_t`` of ``holder`` set to its host int
    ``attr`` (a fill: no copy, no sync), made where it is missing."""
    value = getattr(holder, attr)
    t = getattr(holder, attr + "_t", None)
    if t is None:
        t = torch.full((), value, dtype=torch.int64, device=device)
        setattr(holder, attr + "_t", t)
    else:
        t.fill_(value)
    return t
