"""Checkpoint save/load with the reference's retention policy (port of
``raw_ngp_tpu/train/checkpoint.py``: ``save_checkpoint`` ``:38``,
``load_checkpoint`` ``:63``, ``resolve_checkpoint`` ``:89``).

Equivalent of Trainer.save_checkpoint / load_checkpoint
(nerf/train_utils.py:1141-1299): full state (params, optimizer, EMA, pose
refinement, occupancy grid, step) with rolling ``max_keep`` retention, a
separate metric-keyed best checkpoint holding EMA weights, and
scratch/latest/latest_model/best/path resume modes.

Format, as in the JAX package: one ``.npz`` per checkpoint (read back with
``allow_pickle=False``) + a JSON sidecar of scalars (``step``, ``stats``).
The arrays are keyed by the port's ``TrainState`` fields and parameter
names: ``params.<name>``, ``ema_params.<name>``, ``opt_state.mu.<name>``,
``opt_state.nu.<name>``, ``opt_state.count``, ``step``, the four grid
tensors (``density_grid``, ``density_bitfield``, ``mean_density``,
``iter_density``) and under pose refinement ``pose_params``,
``pose_opt_state.mu.pose`` / ``.nu.pose`` / ``.count`` and
``pose_noise``. What the caller adds beside the state (the Trainer's
generator state) goes under ``extra.<name>``; what it adds to the sidecar
goes under the sidecar's own keys. Loading is tolerant, like the
reference's try/except component loading (train_utils.py:1245-1299): a
missing key, or one whose shape differs, keeps the initialised value.
"""

from __future__ import annotations

import glob
import json
import os
import re
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from raw_ngp_torch.train.state import TrainState

_EXTRA = "extra."


def state_tensors(state: TrainState) -> Dict[str, torch.Tensor]:
    """The state's tensors under their checkpoint keys (the state's own
    tensors, not copies; the fields that are None are left out)."""
    out = {}
    for prefix, tensors in (("params", state.params),
                            ("ema_params", state.ema_params),
                            ("opt_state.mu", state.opt_state.mu),
                            ("opt_state.nu", state.opt_state.nu)):
        for k, t in tensors.items():
            out[f"{prefix}.{k}"] = t
    for k, t in state.grid_state().items():
        if t is not None:
            out[k] = t
    if state.pose_params is not None:
        out["pose_params"] = state.pose_params
    if state.pose_opt_state is not None:
        out["pose_opt_state.mu.pose"] = state.pose_opt_state.mu["pose"]
        out["pose_opt_state.nu.pose"] = state.pose_opt_state.nu["pose"]
    if state.pose_noise is not None:
        out["pose_noise"] = state.pose_noise
    return out


def _counts(state: TrainState) -> Dict[str, Tuple[Any, str]]:
    """The state's host integers (stored as 0-d int64 arrays) by key, each
    as the (object, attribute) that holds it."""
    out = {"step": (state, "step"),
           "opt_state.count": (state.opt_state, "count")}
    if state.pose_opt_state is not None:
        out["pose_opt_state.count"] = (state.pose_opt_state, "count")
    return out


def save_checkpoint(state: TrainState, ckpt_dir: str, name: str,
                    stats: Optional[Dict[str, Any]] = None,
                    max_keep: int = 2,
                    extra: Optional[Dict[str, np.ndarray]] = None,
                    meta: Optional[Dict[str, Any]] = None,
                    tensors: Optional[Dict[str, torch.Tensor]] = None) -> str:
    """Write ``<ckpt_dir>/<name>.npz`` (+ .json) and prune old rolling
    checkpoints (train_utils.py:1182-1188). ``extra`` arrays are stored
    under ``extra.<name>``; ``meta`` entries join the sidecar. ``tensors``
    (by checkpoint key) are written in place of the state's own
    (:func:`state_tensors`): a channel-sharded run's whole tables."""
    os.makedirs(ckpt_dir, exist_ok=True)
    tensors = state_tensors(state) if tensors is None else tensors
    arrays = {k: t.detach().cpu().numpy() for k, t in tensors.items()}
    arrays.update({k: np.asarray(getattr(obj, attr), np.int64)
                   for k, (obj, attr) in _counts(state).items()})
    for k, v in (extra or {}).items():
        arrays[_EXTRA + k] = np.asarray(v)
    path = os.path.join(ckpt_dir, f"{name}.npz")
    np.savez(path, **arrays)
    sidecar = {"step": int(state.step), "stats": stats or {}}
    sidecar.update(meta or {})
    with open(os.path.join(ckpt_dir, f"{name}.json"), "w") as f:
        json.dump(sidecar, f)

    # rolling retention for step-named checkpoints
    step_ckpts = sorted(
        glob.glob(os.path.join(ckpt_dir, "ngp_step*.npz")),
        key=lambda p: int(re.findall(r"step(\d+)", p)[0]))
    for old in step_ckpts[:-max_keep] if max_keep > 0 else []:
        os.remove(old)
        sidecar_path = old[:-4] + ".json"
        if os.path.exists(sidecar_path):
            os.remove(sidecar_path)
    return path


@torch.no_grad()
def load_checkpoint(state: TrainState, path: str,
                    transform: Optional[Callable] = None
                    ) -> Tuple[TrainState, Dict]:
    """Restore into an initialized state, in place (the tensors keep their
    device and dtype, so the field's parameters stay its own). Missing or
    mismatched entries keep their initialized values (tolerant resume,
    train_utils.py:1245-1299). ``transform(key, array)`` gives the array
    to restore from each one read (a channel-sharded run's slice of a
    table). Returns (state, meta): the sidecar's
    entries, ``loaded`` (the keys of the arrays restored), ``n_loaded``
    (their count) and ``extra`` (the
    ``extra.<name>`` arrays)."""
    loaded = []
    with np.load(path, allow_pickle=False) as data:
        files = set(data.files)
        for key, t in state_tensors(state).items():
            if key not in files:
                continue
            arr = data[key] if transform is None else transform(key,
                                                                data[key])
            if arr.shape == tuple(t.shape):
                t.copy_(torch.from_numpy(arr))
                loaded.append(key)
        for key, (obj, attr) in _counts(state).items():
            if key in files and data[key].shape == ():
                setattr(obj, attr, int(data[key]))
                loaded.append(key)
        extra = {k[len(_EXTRA):]: data[k] for k in files
                 if k.startswith(_EXTRA)}
    meta: Dict[str, Any] = {}
    sidecar = path[:-4] + ".json"
    if os.path.exists(sidecar):
        with open(sidecar) as f:
            meta = json.load(f)
    meta["loaded"] = loaded
    meta["n_loaded"] = len(loaded)
    meta["extra"] = extra
    return state, meta


def resolve_checkpoint(ckpt_dir: str, mode: str) -> Optional[str]:
    """scratch/latest/latest_model/best/<path> resolution
    (train_utils.py:444-463)."""
    if mode == "scratch":
        return None
    if mode in ("latest", "latest_model"):
        ckpts = sorted(
            glob.glob(os.path.join(ckpt_dir, "ngp_step*.npz")),
            key=lambda p: int(re.findall(r"step(\d+)", p)[0]))
        return ckpts[-1] if ckpts else None
    if mode == "best":
        best = os.path.join(ckpt_dir, "ngp_best.npz")
        return best if os.path.exists(best) else \
            resolve_checkpoint(ckpt_dir, "latest")
    return mode if os.path.exists(mode) else None
