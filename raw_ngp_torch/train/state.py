"""Training state (port of ``raw_ngp_tpu/train/state.py`` ``TrainState``)
as a plain dataclass of tensors. The parameter dicts map the field's
parameter names (``grid``, ``grid_mlp.0``, ...) to its tensors, so an
update in place is an update of the field. Under pose refinement the
state also holds the per-camera se(3) refinements, their Adam state and
the synthetic pose noise of the self-test. On the proposal path
(``render.occupancy`` False) there is no density grid: its four fields
stay None."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import torch


@dataclass
class AdamState:
    """Moments of :func:`raw_ngp_torch.train.trainer.fused_adam_ema`;
    ``count`` is the number of updates taken (a host integer)."""

    count: int
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]


@dataclass
class TrainState:
    params: Dict[str, torch.Tensor]
    opt_state: AdamState
    ema_params: Dict[str, torch.Tensor]
    step: int                                # host integer
    # the occupancy grid (None on the proposal path)
    density_grid: Optional[torch.Tensor] = None      # [CAS, H^3] f32
    density_bitfield: Optional[torch.Tensor] = None  # [CAS * H^3 // 8] u8
    mean_density: Optional[torch.Tensor] = None      # scalar f32
    iter_density: Optional[torch.Tensor] = None      # scalar i32
    # pose refinement (None when cfg.pose_opt.mode == "none")
    pose_params: Optional[torch.Tensor] = None       # [n_cameras, 6] f32
    pose_opt_state: Optional[AdamState] = None       # moments under "pose"
    pose_noise: Optional[torch.Tensor] = None        # [n_cameras, 3, 4] f32

    def grid_state(self) -> Dict[str, torch.Tensor]:
        return dict(density_grid=self.density_grid,
                    density_bitfield=self.density_bitfield,
                    mean_density=self.mean_density,
                    iter_density=self.iter_density)
