"""Training on one device, on the occupancy path with or without pose
refinement and on the proposal path of the ``-O2`` preset (port of
``raw_ngp_tpu/train/trainer.py``: ``network_lr_schedule`` ``:51``,
``pose_lr_schedule`` ``:63``, ``skip_nonfinite`` ``:73``,
``fused_adam_ema`` ``:95-164``, the pose optimizer of ``make_optimizers``
``:176``, ``init_train_state`` ``:186``, ``_bg_color`` ``:223``,
``make_batch_loss_fn`` ``:249`` with ``render_any`` ``:232``,
``make_loss_fn`` ``:304``,
``make_train_step`` ``:351``, ``dataclasses_replace_scene`` ``:451`` and
``Trainer`` ``:459``, with ``estimate_exposure_levels`` ``:930`` and the
HDR branch of ``evaluate`` ``:1032-1058``).

JAX jits the step and chains steps with ``lax.scan``; here a step is one
eager Python call that updates the state in place. The random streams
differ (Philox ``torch.Generator`` against threefry keys); a ``None``
generator gives the deterministic path of ``key=None``.

Pose refinement (``pose_opt.mode`` "barf" or "baangp", ``noise``,
``identity``): the per-camera se(3) refinements enter the sampler inside
the differentiated step, the annealing ``clip(step / iters, 0, 1)`` drives
the field's level mask, and a second optimizer (skip-nonfinite, then
optax's Adam with the exponential pose LR) updates them until
``end_annealing * iters``.

Light-stage training: HDR images (``data.image_mode="HDR"``) train with
the RawNeRF loss under each image's exposure, the ``train.loss_weight``
weighting and, for mosaiced images, the Bayer loss mask; an rfield field
(``model.rfield``) takes each image's light direction. HDR evaluation
estimates the exposure levels from the first exposure-1.0 view and
scores min(1, rgb * exposure) against min(1, gt).

The proposal path (``render.occupancy`` False, the ``-O2`` preset): the
render is :func:`raw_ngp_torch.render.proposal.render_proposal` (chosen
by :func:`raw_ngp_torch.render.dispatch.render_any`), the loss
adds ``lambda_proposal`` times the proposal loss and ``lambda_distort``
times the distortion loss, and the proposal networks' gradients are
multiplied by the gate (step <= 3000) | (step % 5 == 0) before the
update (Adam's momentum still moves them on gated steps). There is no
density grid, so no grid refresh, untrained-cell marking, coarse cache or
adaptive batching.

Not ported (each raises ``NotImplementedError``): the entropy / TV /
weight-decay / orientation regularizers, the unfused encoder,
multi-device meshes, per-camera near/far; absent: checkpoints,
artifacts and the logger (so ``pose_opt.log_poses``), the HDR artifact
dumps, histograms and metrics other than PSNR.
"""

from __future__ import annotations

import copy
import dataclasses
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from raw_ngp_torch.config import Config
from raw_ngp_torch.data.sampler import sample_ray_batch
from raw_ngp_torch.data.scene import SceneData
from raw_ngp_torch.device import resolve_device
from raw_ngp_torch.models.ngp import FieldSpec, init_field, make_field_spec
from raw_ngp_torch.ops.lie import se3_to_SE3
from raw_ngp_torch.ops.grid import (init_grid_state, make_grid_update,
                                    mark_untrained_grid)
from raw_ngp_torch.render.eval import coarse_volume, render_image, scene_aabb
from raw_ngp_torch.render.dispatch import render_any
from raw_ngp_torch.train.losses import (blend_gt_background, ldr_loss,
                                       loss_weight_fn, rawnerf_loss)
from raw_ngp_torch.train.metrics import PSNRMeter
from raw_ngp_torch.train.state import AdamState, TrainState

_F32 = np.float32


def network_lr_schedule(cfg: Config):
    """step -> lr (f32): 0.1^(step/iters) decay of the base LR, or a
    cosine decay over 6000 steps when ``anneal_lr``."""
    lr = _F32(cfg.train.lr)
    if cfg.train.anneal_lr:
        def sched(step):
            c = _F32(min(step, 6000))
            cos = _F32(0.5) * (_F32(1.0) + np.cos(_F32(np.pi) * c
                                                  / _F32(6000)))
            return lr * (_F32(1.0) * cos + _F32(0.0))
        return sched

    def sched(step):
        x = min(_F32(step) / _F32(cfg.train.iters), _F32(1.0))
        return lr * _F32(0.1) ** _F32(x)
    return sched


def pose_lr_schedule(cfg: Config):
    """step -> lr (f32): c_lr decaying exponentially to 1e-2 * c_lr over
    ``train.iters`` steps (f32 pow, as JAX computes it)."""
    gamma = _F32((1e-2) ** (1.0 / cfg.train.iters))
    c_lr = _F32(cfg.pose_opt.c_lr)

    def sched(step):
        return c_lr * gamma ** _F32(step)
    return sched


class _Optimizer:
    """init / update_apply pair from :func:`fused_adam_ema` or
    :func:`pose_adam`."""

    def __init__(self, init, update_apply):
        self.init = init
        self.update_apply = update_apply


def fused_adam_ema(cfg: Config) -> _Optimizer:
    """Adam + skip-nonfinite + EMA in one pass over every parameter.

    Not ``torch.optim.Adam``: eps is ``cfg.train.adam_eps`` (1e-7) outside
    the square root, the LR is read at ``count`` before the increment, the
    EMA (decay ``cfg.train.ema_decay``) moves every step, and a step whose
    gradients hold any non-finite value leaves the params *and* the
    moments as they were (the EMA still moves toward the params). The
    decision is taken on the device: no host sync.

    ``update_apply(grads, state, params, ema)`` updates params, ema and
    the moments in place and returns (params, ema, state).
    """
    lr_fn = network_lr_schedule(cfg)
    b1, b2 = 0.9, 0.999
    eps = cfg.train.adam_eps
    d = cfg.train.ema_decay

    def init(params):
        return AdamState(
            count=0, mu={k: torch.zeros_like(p) for k, p in params.items()},
            nu={k: torch.zeros_like(p) for k, p in params.items()})

    @torch.no_grad()
    def update_apply(grads, state: AdamState, params, ema):
        ok = torch.stack([torch.isfinite(g).all()
                          for g in grads.values()]).all()
        okf = ok.float()
        cf = _F32(state.count + 1)
        scale = float(lr_fn(state.count) / (_F32(1.0) - _F32(b1) ** cf))
        nu_corr = float(_F32(1.0) - _F32(b2) ** cf)
        step_scale = okf * scale
        for k, p in params.items():
            m, v, e = state.mu[k], state.nu[k], ema[k]
            # select, not multiply: inf * 0 == NaN would poison the step
            g = torch.where(ok, grads[k], 0.0)
            m2 = b1 * m + (1.0 - b1) * g
            v2 = b2 * v + (1.0 - b2) * g * g
            p2 = p - step_scale * m2 / (torch.sqrt(v2 / nu_corr) + eps)
            m.copy_(okf * m2 + (1.0 - okf) * m)
            v.copy_(okf * v2 + (1.0 - okf) * v)
            e.copy_(d * e + (1.0 - d) * p2)
            p.copy_(p2)
        state.count += 1
        return params, ema, state

    return _Optimizer(init=init, update_apply=update_apply)


def pose_adam(cfg: Config) -> _Optimizer:
    """The pose optimizer: ``optax.chain(skip_nonfinite(),
    optax.adam(pose_lr_schedule, eps=1e-8))`` with optax's semantics.

    Not ``torch.optim.Adam`` and not :func:`fused_adam_ema`: b1 0.9, b2
    0.999, eps 1e-8 outside the square root, the LR read at the count
    before the increment, no EMA. A step whose gradient holds a non-finite
    value *zeroes the gradient before Adam* (skip_nonfinite), so the
    moments still decay and the pose still moves by the momentum.

    ``update_apply(grad, state, params)`` updates params and the moments
    in place and returns (params, state)."""
    lr_fn = pose_lr_schedule(cfg)
    b1, b2, eps = 0.9, 0.999, 1e-8

    def init(params):
        return AdamState(count=0, mu={"pose": torch.zeros_like(params)},
                         nu={"pose": torch.zeros_like(params)})

    @torch.no_grad()
    def update_apply(grad, state: AdamState, params):
        # skip_nonfinite: select, not multiply (inf * 0 == NaN)
        g = torch.where(torch.isfinite(grad).all(), grad, 0.0)
        mu, nu = state.mu["pose"], state.nu["pose"]
        mu.copy_((1 - b1) * g + b1 * mu)
        nu.copy_((1 - b2) * (g * g) + b2 * nu)
        cf = _F32(state.count + 1)
        mu_hat = mu / float(_F32(1.0) - _F32(b1) ** cf)
        nu_hat = nu / float(_F32(1.0) - _F32(b2) ** cf)
        step = float(-lr_fn(state.count))
        params.add_(step * (mu_hat / (torch.sqrt(nu_hat) + eps)))
        state.count += 1
        return params, state

    return _Optimizer(init=init, update_apply=update_apply)


def init_train_state(cfg: Config, spec: FieldSpec, device="cuda",
                     num_cameras: int = 0):
    """(field, TrainState): a field from ``cfg.train.seed``, its EMA as a
    copy, zero moments and, on the occupancy path, zero grid buffers;
    under pose refinement also
    zero refinements [num_cameras, 6] (a leaf that requires a gradient),
    their optimizer state and, when ``pose_opt.noise > 0``, the synthetic
    perturbation se3_to_SE3([r | t]) of seeded normal r and t scaled by
    the noise (t also by ``data.scale`` when it is set)."""
    dev = resolve_device(device)
    field = init_field(spec, seed=cfg.train.seed, device=dev)
    params = dict(field.named_parameters())
    ema = {k: p.detach().clone() for k, p in params.items()}
    grid = init_grid_state(cfg, dev) if cfg.render.occupancy else {}
    state = TrainState(params=params,
                       opt_state=fused_adam_ema(cfg).init(params),
                       ema_params=ema, step=0, **grid)
    if cfg.pose_opt.mode != "none":
        pose = torch.zeros(num_cameras, 6, dtype=torch.float32, device=dev)
        state.pose_params = pose.requires_grad_()
        state.pose_opt_state = pose_adam(cfg).init(pose.detach())
        if cfg.pose_opt.noise > 0:
            gen = torch.Generator().manual_seed(cfg.train.seed + 1)
            scale = cfg.data.scale if cfg.data.scale > 0 else 1.0
            se3_t = (torch.randn(num_cameras, 3, generator=gen)
                     * cfg.pose_opt.noise * scale)
            se3_r = torch.randn(num_cameras, 3, generator=gen) \
                * cfg.pose_opt.noise
            state.pose_noise = se3_to_SE3(
                torch.cat([se3_r, se3_t], dim=-1)).to(dev)
    return field, state


def _bg_color(cfg: Config, generator, n: int, device):
    mode = cfg.render.background
    if mode == "random":
        if generator is None:
            raise ValueError("a random background needs a generator")
        return torch.rand(n, 3, generator=generator, device=device)
    if mode in ("white", "last_sample"):
        return 1.0
    return 0.0


def _check_ported(cfg: Config):
    t = cfg.train
    if (t.lambda_entropy > 0 or t.lambda_tv > 0 or t.lambda_wd > 0
            or t.lambda_orientation > 0):
        raise NotImplementedError("the entropy, TV, weight-decay and "
                                  "orientation regularizers are not ported")
    if not cfg.model.fused_encoder:
        raise NotImplementedError("training with the unfused encoder is "
                                  "not ported")


def make_batch_loss_fn(cfg: Config, spec: FieldSpec):
    """Render + loss over an explicit ray batch:
    ``batch_loss_fn(field, state, batch, aabb, generator=None,
    plain=False, point_budget=None, annealing=1.0) -> (loss, aux)``,
    rendering through :func:`raw_ngp_torch.render.dispatch.render_any`.
    A ``None`` generator is the deterministic mode (march jitter 0.5;
    unjittered proposal sampling). HDR batches carry
    ``exposure`` [N, 1] and, when mosaiced, ``lossmult`` [N, 3]; an
    rfield field's batch carries ``rays_ldir`` [N, 3]. On the proposal
    path the loss adds ``lambda_proposal`` times the proposal loss and
    ``lambda_distort`` times the distortion loss where the render returns
    them."""
    _check_ported(cfg)
    hdr = cfg.data.image_mode == "HDR"

    def batch_loss_fn(field, state: TrainState, batch, aabb, generator=None,
                      plain: bool = False, point_budget=None,
                      annealing=1.0):
        rays_o, rays_d = batch["rays_o"], batch["rays_d"]
        bg = _bg_color(cfg, generator, rays_o.shape[0], rays_o.device)
        gt_rgb = blend_gt_background(batch["images"], bg)
        out = render_any(
            field, rays_o, rays_d, aabb, state.density_bitfield,
            bg_color=bg, rays_ldir=batch.get("rays_ldir"),
            annealing=annealing, training=True, generator=generator,
            plain=plain, coarse_lin=batch.get("coarse_lin"),
            point_budget=point_budget)
        if hdr:
            lw = loss_weight_fn(cfg.train.loss_weight, gt_rgb)
            loss = rawnerf_loss(out["image"], gt_rgb, batch["exposure"],
                                batch.get("lossmult", 1.0), lw)
        else:
            loss = ldr_loss(out["image"], gt_rgb)
        if "proposal_loss" in out:
            loss = loss + cfg.train.lambda_proposal * out["proposal_loss"]
        if "distort_loss" in out:
            loss = loss + cfg.train.lambda_distort * out["distort_loss"]
        aux = {"num_points": out["num_points"],
               "num_points_raw": out.get("num_points_raw",
                                         out["num_points"]),
               "weights_sum": out["weights_sum"].mean()}
        return loss, aux

    return batch_loss_fn


def make_loss_fn(cfg: Config, spec: FieldSpec, num_rays: int):
    """Batch sampling + :func:`make_batch_loss_fn`:
    ``loss_fn(field, state, scene, aabb, generator, plain=False,
    point_budget=None, annealing=1.0)``; ``scene`` holds images, poses,
    intrinsics, the light-stage scene's exposures and ldirs where it has
    them and, when the Trainer has cached it, coarse_lin. The rays
    are made inside the differentiated function from the state's pose
    refinements and noise, so the loss's gradient reaches
    ``state.pose_params``."""
    batch_loss_fn = make_batch_loss_fn(cfg, spec)

    def loss_fn(field, state, scene, aabb, generator, plain: bool = False,
                point_budget=None, annealing=1.0):
        batch = sample_ray_batch(
            generator, scene["images"], scene["poses"], scene["intrinsics"],
            num_rays, random_image_batch=cfg.train.random_image_batch,
            se3_refine=state.pose_params, pose_noise=state.pose_noise,
            exposures=scene.get("exposures"), ldirs=scene.get("ldirs"),
            mosaiced=cfg.data.mosaiced)
        if "coarse_lin" in scene:
            batch["coarse_lin"] = scene["coarse_lin"]
        return batch_loss_fn(field, state, batch, aabb, generator, plain,
                             point_budget, annealing)

    return loss_fn


def annealing_at(cfg: Config, step: int):
    """The BARF / BAA-NGP annealing of a train step, clip(step / iters, 0,
    1) in f32 at the step before its increment."""
    return min(max(_F32(step) / _F32(cfg.train.iters), _F32(0.0)),
               _F32(1.0))


def proposal_gate(step: int) -> float:
    """The factor of the proposal networks' gradients at a step (counted
    before its increment): 1 on the first 3001 steps and on every fifth
    step after, else 0."""
    return 1.0 if step <= 3000 or step % 5 == 0 else 0.0


def make_train_step(cfg: Config, spec: FieldSpec, net_tx: _Optimizer,
                    num_rays: int, point_budget=None,
                    pose_tx: Optional[_Optimizer] = None):
    """One training step, ``train_step(field, state, scene, aabb,
    generator) -> metrics``: sample, render, loss, backward and the fused
    Adam + EMA update, in place on ``state`` (whose params are the
    field's); under pose refinement also the pose update, its gradient
    multiplied by 0 from ``int(end_annealing * iters)`` on (Adam's
    momentum still moves the poses). On the proposal path the proposal
    networks' gradients are multiplied by :func:`proposal_gate` (a
    multiply, not a skip: a non-finite gradient times 0 stays NaN and
    makes the fused update skip the step, as in JAX). Metrics stay on the
    device."""
    loss_fn = make_loss_fn(cfg, spec, num_rays)
    pose_freeze_step = int(cfg.pose_opt.end_annealing * cfg.train.iters)

    def train_step(field, state: TrainState, scene, aabb, generator):
        for p in state.params.values():
            p.grad = None
        pose = state.pose_params
        if pose is not None:
            pose.grad = None
        loss, aux = loss_fn(field, state, scene, aabb, generator,
                            point_budget=point_budget,
                            annealing=annealing_at(cfg, state.step))
        loss.backward()
        grads = {k: p.grad if p.grad is not None else torch.zeros_like(p)
                 for k, p in state.params.items()}
        if spec.prop_specs:
            gate = proposal_gate(state.step)
            for k in grads:
                if k.startswith("prop_"):
                    grads[k] = grads[k] * gate
        net_tx.update_apply(grads, state.opt_state, state.params,
                            state.ema_params)
        if pose is not None:
            g = pose.grad if pose.grad is not None else torch.zeros_like(pose)
            freeze = 1.0 if state.step >= pose_freeze_step else 0.0
            pose_tx.update_apply(g * (1.0 - freeze), state.pose_opt_state,
                                 pose.data)
        state.step += 1
        return {"loss": loss.detach(), **aux}

    return train_step


def dataclasses_replace_scene(scene: SceneData, new_poses):
    """SceneData with replaced poses (keeps poses_gt for evaluation)."""
    if scene.poses_gt is None:
        scene = dataclasses.replace(scene, poses_gt=scene.poses.copy())
    return dataclasses.replace(scene, poses=new_poses)


class Trainer:
    """Host-side orchestration of training on one device, on the occupancy
    or the proposal path: ``train(iters)``, ``render_image(pose)`` with the
    EMA parameters and ``evaluate()`` (PSNR). Runs on the card unless
    ``device="cpu"``."""

    def __init__(self, cfg: Config, train_scene: SceneData,
                 val_scene: Optional[SceneData] = None, device="cuda"):
        if cfg.parallel.num_devices > 1 or cfg.parallel.tp_devices > 1:
            raise NotImplementedError("multi-device training is not ported")
        _check_ported(cfg)
        if train_scene.cam_near_far is not None:
            raise NotImplementedError("scenes with cam_near_far are not "
                                      "ported")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.spec = make_field_spec(cfg)
        if cfg.pose_opt.identity:
            # BARF from scratch: every camera starts at the identity pose;
            # the ground truth stays in poses_gt
            ident = np.tile(np.eye(4, dtype=np.float32),
                            (train_scene.n_images, 1, 1))
            train_scene = dataclasses_replace_scene(train_scene, ident)
        self.train_scene = train_scene
        self.val_scene = val_scene
        dev = self.device
        self.scene_arrays: Dict[str, torch.Tensor] = {
            "images": torch.as_tensor(train_scene.images, device=dev),
            "poses": torch.as_tensor(train_scene.poses, device=dev),
            "intrinsics": torch.as_tensor(train_scene.intrinsics,
                                          device=dev),
        }
        for name in ("exposures", "ldirs"):
            if getattr(train_scene, name) is not None:
                self.scene_arrays[name] = torch.as_tensor(
                    getattr(train_scene, name), device=dev)
        self.aabb = scene_aabb(cfg, train_scene.pts_aabb, device=dev)
        self.field, self.state = init_train_state(cfg, self.spec, dev,
                                                  train_scene.n_images)
        # the EMA field renders from the state's EMA tensors (shared)
        self.ema_field = copy.deepcopy(self.field)
        for k, p in self.ema_field.named_parameters():
            p.requires_grad_(False)
            p.data = self.state.ema_params[k]
        self.net_tx = fused_adam_ema(cfg)
        self.pose_tx = pose_adam(cfg) if cfg.pose_opt.mode != "none" \
            else None
        self.generator = torch.Generator(device=dev).manual_seed(
            cfg.train.seed)
        self.num_rays = cfg.train.num_rays
        self._grid_update = (make_grid_update(cfg) if cfg.render.occupancy
                             else None)
        if cfg.render.mark_untrained and cfg.render.occupancy:
            grid = mark_untrained_grid(
                cfg, np.asarray(train_scene.poses),
                np.asarray(train_scene.intrinsics), self.aabb.cpu().numpy(),
                cam_near_far=train_scene.cam_near_far)
            self.state.density_grid = torch.from_numpy(grid).to(dev)
        self.stats: Dict[str, Any] = {"loss": [], "psnr": []}
        # HDR eval exposure levels {percentile: value}, set by
        # estimate_exposure_levels
        self.exposure_levels: Dict[float, float] = {}
        self.host_step = 0
        self.host_grid_updates = 0
        self._pts_ema = None
        self._point_budget = None      # None = base (config-derived)
        self._adapt_stash = None
        self._metrics = None
        self._train_step = self._make_step()

    # ------------------------------------------------------------------
    def base_point_budget(self) -> int:
        """The config-derived compacted point budget."""
        cfg = self.cfg
        return max(int(cfg.train.num_rays * cfg.render.samples_per_ray
                       * cfg.render.compact_ratio) // 128 * 128, 128)

    def _make_step(self):
        """The train step for the current adaptive-batch key (num_rays,
        point budget; budget None = the config-derived base)."""
        return make_train_step(self.cfg, self.spec, self.net_tx,
                               self.num_rays, point_budget=self._point_budget,
                               pose_tx=self.pose_tx)

    def _adapt_batch(self, metrics):
        """Adaptive batching (``trainer.py:694``): grow num_rays by powers
        of two while the live-sample EMA uses under half the base budget,
        shrink the point budget toward 1.3x the EMA (power-of-two
        fractions, at least 1/8), re-grow it when demand saturates it."""
        cfg = self.cfg
        pts = float(metrics.get("num_points_raw", metrics["num_points"]))
        self._pts_ema = (pts if self._pts_ema is None
                         else 0.7 * self._pts_ema + 0.3 * pts)
        base_budget = self.base_point_budget()
        cap = cfg.train.max_num_rays or 4 * cfg.train.num_rays
        num_rays = self.num_rays
        if (num_rays * 2 <= cap
                and self._pts_ema * 2.0 <= 0.9 * base_budget):
            num_rays *= 2
            self._pts_ema *= 2.0     # same scene, twice the rays
        budget = base_budget
        while (budget // 2 >= base_budget // 8
               and 1.3 * self._pts_ema <= budget // 2):
            budget //= 2
        if 1.1 * self._pts_ema > budget:
            budget = min(budget * 2, base_budget)
        budget_key = None if budget == base_budget else budget
        if (num_rays, budget_key) == (self.num_rays, self._point_budget):
            return
        self.num_rays, self._point_budget = num_rays, budget_key
        self._train_step = self._make_step()

    def _refresh_coarse_cache(self):
        """The probe coarse-occupancy volume of the current bitfield, valid
        for the whole refresh interval."""
        if self.cfg.render.coarse_probes <= 0:
            return
        self.scene_arrays["coarse_lin"] = coarse_volume(
            self.cfg, self.state.density_bitfield)

    def adaptation_quiescent(self, margin: float = 1.1) -> bool:
        """True when no adaptive-batch change is within ``margin`` of
        firing at the current live-sample EMA (``trainer.py:765``)."""
        cfg = self.cfg
        if not self._adaptive():
            return True
        if self._pts_ema is None:
            return False
        base_budget = self.base_point_budget()
        budget = self._point_budget or base_budget
        cap = cfg.train.max_num_rays or 4 * cfg.train.num_rays
        growth_pending = (
            self.num_rays * 2 <= cap
            and self._pts_ema * 2.0 <= margin * 0.9 * base_budget)
        shrink_pending = (
            budget // 2 >= base_budget // 8
            and 1.3 * self._pts_ema <= margin * (budget // 2))
        regrow_pending = (
            budget < base_budget
            and 1.1 * self._pts_ema * margin > budget)
        return not (growth_pending or shrink_pending or regrow_pending)

    def _adaptive(self) -> bool:
        """Whether adaptive batching runs: it adapts the occupancy path's
        point budget, so never on the proposal path."""
        cfg = self.cfg
        return (cfg.train.adaptive_num_rays and cfg.render.occupancy
                and cfg.render.compact_ratio > 0)

    def step(self):
        """One training step, preceded on the occupancy path at every
        ``update_extra_interval`` boundary by the grid refresh, the coarse
        cache and (after the 16 full sweeps) the batch adaptation from the
        previous interval's metrics. Returns the step's metrics (device
        tensors)."""
        cfg = self.cfg
        if (cfg.render.occupancy
                and self.host_step % cfg.render.update_extra_interval == 0):
            grid = self._grid_update(self.field, self.state.grid_state(),
                                     self.host_grid_updates, self.generator)
            for k, v in grid.items():
                setattr(self.state, k, v)
            self.host_grid_updates += 1
            self._refresh_coarse_cache()
            if self._adaptive() and self.host_grid_updates > 16:
                if self._adapt_stash is not None:
                    self._adapt_batch(self._adapt_stash)
                self._adapt_stash = self._metrics
        self._metrics = self._train_step(self.field, self.state,
                                         self.scene_arrays, self.aabb,
                                         self.generator)
        self.host_step += 1
        return self._metrics

    def train(self, iters: Optional[int] = None, log_every: int = 100):
        """``iters`` steps; returns wall time and rays/s (the clock stops
        after the last step's loss has reached the host)."""
        iters = iters or self.cfg.train.iters
        t0 = time.time()
        total_rays = 0
        for i in range(iters):
            metrics = self.step()
            total_rays += self.num_rays
            if i == 0 or i // log_every != (i + 1) // log_every:
                self.stats["loss"].append(float(metrics["loss"]))
        self.stats["loss"].append(float(metrics["loss"]))
        dt = time.time() - t0
        return {"wall_time": dt, "rays_per_sec": total_rays / dt}

    # ------------------------------------------------------------------
    def render_image(self, pose, intrinsics=None, H=None, W=None,
                     use_ema: bool = True, ldir=None):
        """Full-image chunked render with the EMA parameters (raw ones
        with ``use_ema=False``) at the current annealing,
        min(host_step / iters, 1), under light direction ``ldir`` [3] (an
        rfield field's) -> numpy (rgb [H, W, 3], depth [H, W])."""
        scene = self.train_scene
        intrinsics = intrinsics if intrinsics is not None \
            else scene.intrinsics
        field = self.ema_field if use_ema else self.field
        annealing = min(self.host_step / max(self.cfg.train.iters, 1), 1.0)
        rgb, depth = render_image(field, self.state.density_bitfield, pose,
                                  intrinsics, H or scene.H, W or scene.W,
                                  self.aabb, device=self.device,
                                  annealing=annealing, ldir=ldir)
        return rgb.cpu().numpy(), depth.cpu().numpy()

    def estimate_exposure_levels(self, scene: SceneData) -> Dict:
        """The HDR exposure levels: ``cfg.exposure_percentiles`` of the
        render of the scene's first exposure-1.0 view (with its light
        direction), kept in ``self.exposure_levels`` and on
        ``scene.meta``. A scene without exposures, or without an
        exposure-1.0 view, leaves the levels as they were."""
        if scene.exposures is None:
            return self.exposure_levels
        ones = np.where(np.asarray(scene.exposures).reshape(-1) == 1.0)[0]
        if len(ones) == 0:
            return self.exposure_levels
        i = int(ones[0])
        rgb, _ = self.render_image(
            scene.poses[i], scene.intrinsics, scene.H, scene.W,
            ldir=scene.ldirs[i] if scene.ldirs is not None else None)
        self.exposure_levels = {
            p: float(np.percentile(rgb, p))
            for p in self.cfg.exposure_percentiles}
        if scene.meta is not None:
            scene.meta.exposure_levels = dict(self.exposure_levels)
        return self.exposure_levels

    def evaluate(self, scene: Optional[SceneData] = None,
                 use_ema: bool = True) -> Dict[str, float]:
        """Mean PSNR of the renders of ``scene`` (default the val scene),
        each under its image's light direction, against its images. HDR:
        the exposure levels are estimated first, and the PSNR compares
        min(1, rgb * exposure) with min(1, gt)."""
        scene = scene or self.val_scene
        if scene is None:
            raise ValueError("evaluate: no scene")
        hdr = self.cfg.data.image_mode == "HDR"
        if hdr:
            self.estimate_exposure_levels(scene)
        meter = PSNRMeter()
        for i in range(scene.n_images):
            rgb, _ = self.render_image(
                scene.poses[i], scene.intrinsics, scene.H, scene.W,
                use_ema=use_ema,
                ldir=scene.ldirs[i] if scene.ldirs is not None else None)
            gt = scene.images[i][..., :3]
            if hdr and scene.exposures is not None:
                rgb = np.minimum(1.0, rgb * scene.exposures[i])
                gt = np.minimum(1.0, gt)
            meter.update(rgb, gt)
        result = {"psnr": meter.measure()}
        self.stats["psnr"].append(result["psnr"])
        return result
