"""Observability: console/file logging, tensorboard scalars,
profiler traces (port of ``raw_ngp_tpu/utils/logging.py``: ``RunLogger``
``:20``, ``ThroughputMeter`` ``:67``, ``profiler_trace`` ``:93``).

Covers the reference's logging surface (train_utils.py:428-432 rich console
+ log file; :919-937 tensorboardX scalars/histograms) and adds what it
lacks (SURVEY.md §5.1): profiler trace capture and explicit rays/sec /
points/sec counters. The tensorboard writer is optional: where
tensorboardX does not import, scalars and histograms go nowhere and the
console and ``log_ngp.txt`` still get every line.
"""

from __future__ import annotations

import contextlib
import os
import time
import weakref
from typing import Dict

import numpy as np


class RunLogger:
    """Console + ``log_ngp.txt`` + tensorboard where tensorboardX imports.
    The tensorboard writer (an event file under ``<workspace>/run`` and a
    thread) opens at the first scalar or histogram and closes with
    ``close()`` or when the logger is collected. ``active`` says whether
    scalars and histograms go anywhere: a writer is open or can be."""

    def __init__(self, workspace: str, enabled: bool = True):
        self.workspace = workspace
        # a disabled logger (a rank other than 0) writes nothing, and says
        # as the others whether tensorboard is there, so that work done
        # for it (collective on a mesh) runs on every rank alike
        self.enabled = enabled
        self.log_path = os.path.join(workspace, "log_ngp.txt")
        os.makedirs(workspace, exist_ok=True)
        self.writer = None
        self._closer = None
        try:
            import tensorboardX  # noqa: F401
            self.tensorboard = True
        except Exception:
            self.tensorboard = False

    @property
    def active(self) -> bool:
        return self.writer is not None or self.tensorboard

    def _tb(self):
        if self.writer is None:
            from tensorboardX import SummaryWriter
            self.writer = SummaryWriter(os.path.join(self.workspace, "run"))
            self._closer = weakref.finalize(self, self.writer.close)
        return self.writer

    def log(self, *args):
        if not self.enabled:
            return
        msg = " ".join(str(a) for a in args)
        print(msg)
        with open(self.log_path, "a") as f:
            f.write(msg + "\n")

    def scalar(self, tag: str, value: float, step: int):
        if self.active and self.enabled:
            self._tb().add_scalar(tag, float(value), step)

    def scalars(self, values: Dict[str, float], step: int,
                prefix: str = "train"):
        for k, v in values.items():
            try:
                self.scalar(f"{prefix}/{k}", float(v), step)
            except (TypeError, ValueError):
                pass

    def histogram(self, tag: str, values, step: int):
        if self.active and self.enabled:
            self._tb().add_histogram(tag, np.asarray(values), step)

    def close(self):
        if self._closer is not None:
            self._closer()
        elif self.writer is not None:
            self.writer.close()
        self.writer = self._closer = None


class ThroughputMeter:
    """rays/sec and points/sec counters (the reference only surfaces tqdm
    it/s, SURVEY.md §5.1)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.t0 = time.time()
        self.rays = 0
        self.points = 0
        self.steps = 0

    def update(self, num_rays: int, num_points: int = 0):
        self.rays += num_rays
        self.points += num_points
        self.steps += 1

    def rates(self) -> Dict[str, float]:
        dt = max(time.time() - self.t0, 1e-9)
        return {"rays_per_sec": self.rays / dt,
                "points_per_sec": self.points / dt,
                "steps_per_sec": self.steps / dt}


@contextlib.contextmanager
def profiler_trace(log_dir: str, enabled: bool = True):
    """``torch.profiler`` capture of the block (CPU and, where there is a
    card, CUDA activity), written as a Chrome trace
    ``<log_dir>/trace.json`` (viewable in Perfetto or chrome://tracing)."""
    if not enabled:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
