"""Scene containers: explicit, typed replacements for the reference's
``opt.metadict`` side-channel (reference main.py:197-201 and the runtime
namespace mutations catalogued in SURVEY.md §5.6).

``SceneData`` holds the device-resident training tensors (images preloaded
once, reference colmap_provider.py:576-583); ``SceneMeta`` holds host-side
metadata (filenames, shutter speeds, color matrices, exposure levels).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np


@dataclass
class SceneMeta:
    """Host-side metadata (reference opt.metadict)."""

    filenames: List[str] = field(default_factory=list)
    shutter_speeds: List[float] = field(default_factory=list)
    cam2rgb: Any = None                           # [3, 3] or list of them
    ldirs: Optional[np.ndarray] = None            # [n_leds, 3]
    exposure_levels: Dict[float, float] = field(default_factory=dict)
    # per-image exposure index/value (image_utils.py:107-122)
    exposure_idx: Optional[np.ndarray] = None     # [n_images] int
    exposure_values: Optional[np.ndarray] = None  # [n_images] float
    unique_shutters: Optional[np.ndarray] = None
    train_ids: Optional[np.ndarray] = None
    val_ids: Optional[np.ndarray] = None

    def __post_init__(self):
        if self.cam2rgb is None:
            self.cam2rgb = []

    def finalize_exposures(self):
        """Relative exposures, 1.0 = brightest (image_utils.py:107-121)."""
        ss = np.array(self.shutter_speeds, dtype=np.float64)
        if len(ss) == 0:
            return
        unique = np.sort(np.unique(ss))[::-1]
        idx = np.zeros(len(ss), np.int32)
        for i, s in enumerate(unique):
            idx[ss == s] = i
        self.exposure_idx = idx
        self.unique_shutters = unique
        self.exposure_values = (ss / unique[0]).astype(np.float32)


@dataclass
class SceneData:
    """One split of a dataset, ready for the jitted sampler.

    All arrays are numpy on construction; the trainer moves them to device
    once (preload) — there are no per-step host->device transfers.
    """

    images: np.ndarray                  # [n, H, W, C] float32 (linear)
    poses: np.ndarray                   # [n, 4, 4] cam2world (OpenGL conv.)
    intrinsics: np.ndarray              # [4] fx fy cx cy
    H: int
    W: int
    # optional per-image data
    exposures: Optional[np.ndarray] = None      # [n, 1] relative exposure
    cam_near_far: Optional[np.ndarray] = None   # [n, 2]
    ldirs: Optional[np.ndarray] = None          # [n, 3] light dir per image
    # scene geometry
    pts_aabb: Optional[np.ndarray] = None       # [6] from sparse points
    poses_gt: Optional[np.ndarray] = None       # [n, 4, 4] for pose eval
    # masks applied already; mvps for visibility culling
    mvps: Optional[np.ndarray] = None           # [n, 4, 4]
    meta: SceneMeta = field(default_factory=SceneMeta)

    @property
    def n_images(self) -> int:
        return int(self.images.shape[0])

    @property
    def num_channels(self) -> int:
        return int(self.images.shape[-1])

    def __post_init__(self):
        assert self.images.ndim == 4
        assert self.poses.shape[1:] == (4, 4)
        assert self.images.shape[0] == self.poses.shape[0]
