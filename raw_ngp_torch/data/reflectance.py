"""Light-stage LED calibration -> unit light directions (a numpy copy of
``raw_ngp_tpu/data/reflectance.py``).

Port of reflectance/reflectance_utils.py:30-60 with the researcher's
hard-coded calibration path replaced by an explicit argument (SURVEY.md
§7 "quirks to not replicate"). File format: one LED per line,
``<id> <x> <y> <z> ...``.
"""

from __future__ import annotations

import numpy as np


def load_light_dirs(calibration_path: str) -> np.ndarray:
    """Read LED positions, subtract the rig's center of mass, and return
    unit direction vectors pointing AT the origin [n_leds, 3]."""
    with open(calibration_path) as f:
        lines = [ln for ln in f.readlines() if ln.strip()]
    coords = np.array([[float(t) for t in ln.split()[1:4]] for ln in lines])
    centered = coords - coords.mean(axis=0)
    dirs = -centered                       # light points toward the origin
    return (dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)
            ).astype(np.float32)


def write_light_dirs_calibration(path: str, positions: np.ndarray):
    """Write a calibration file in the rig format (for tests/tools)."""
    with open(path, "w") as f:
        for i, p in enumerate(positions):
            f.write(f"led{i}_w {p[0]} {p[1]} {p[2]}\n")
