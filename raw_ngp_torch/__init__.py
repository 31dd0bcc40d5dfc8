"""raw_ngp_torch — the PyTorch + CUDA port of raw_ngp_tpu for NVIDIA Hopper.

The JAX package ``raw_ngp_tpu`` stays the reference; this package imports
nothing of it (nor of JAX) and keeps its own copies of the configuration
and the synthetic scene. Plain tensor code is PyTorch; every kernel on the
ported path is hand-written CUDA C++ for ``sm_90a`` under ``csrc/``, built
on first use by :mod:`raw_ngp_torch.kernels._build`.

Ported so far (slice 1): the occupancy-grid full-image render at fixed
parameters, :func:`raw_ngp_torch.render.eval.render_image`.
"""

__version__ = "0.1.0"

from raw_ngp_torch.config import Config, default_config
from raw_ngp_torch.device import resolve_device
