"""Training on one device, on the occupancy path with or without pose
refinement and on the proposal path of the ``-O2`` preset (port of
``raw_ngp_tpu/train/trainer.py``: ``network_lr_schedule`` ``:51``,
``pose_lr_schedule`` ``:63``, ``skip_nonfinite`` ``:73``,
``fused_adam_ema`` ``:95-164``, the pose optimizer of ``make_optimizers``
``:176``, ``init_train_state`` ``:186``, ``_bg_color`` ``:223``,
``make_batch_loss_fn`` ``:249`` with ``render_any`` ``:232``,
``make_loss_fn`` ``:304``,
``make_train_step`` ``:351``, ``dataclasses_replace_scene`` ``:451`` and
``Trainer`` ``:459``, with ``estimate_exposure_levels`` ``:930``,
``log_histograms`` ``:953``, ``log_optimized_poses`` ``:995``,
``evaluate`` ``:1021``, ``save_checkpoint`` / ``load_checkpoint``
``:1102-1140``, ``fit`` ``:1141`` and ``test`` ``:1169``).

JAX jits the step and chains steps with ``lax.scan``; here a step is one
Python call that updates the state in place, and ``Trainer.train`` runs
JAX's chains on one card as replays of a CUDA graph of the step
(:mod:`raw_ngp_torch.train.dispatch`), reading every per-step scalar on
the device (:mod:`raw_ngp_torch.train.scalars`). The random streams
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

On the occupancy path every march branch trains and renders (the
reference ``-O`` preset: the span march of 512 candidates into 64 slots,
no probes, so no coarse cache); ``render_image(...,
return_normals=True)`` adds the normal map when
``cfg.render.compute_normals``.

The regularizers train on both paths: ``train.lambda_orientation``
(occupancy path: Ref-NeRF's orientation loss through a second-order
gradient of the density), ``lambda_entropy`` (the rays' opacity),
``lambda_tv`` (total variation of the radiance grid at 65,536 points
drawn from the step's generator) and ``lambda_wd`` (its level-meaned
weight decay). ``model.fused_encoder`` False trains every grid through
the plain encoder.

A scene with per-camera near/far (``SceneData.cam_near_far``, the
COLMAP loader's sparse-depth ranges under ``data.enable_cam_near_far``)
clamps each training ray to its camera's [near, far] on both paths and in
the untrained-cell marking; the eval renders take no near/far, as JAX's.

Persistence and the run's outputs: the Trainer works in a workspace
(``cfg.workspace`` unless given), logs to the console, its
``log_ngp.txt`` and tensorboardX where that imports, and resumes from
the checkpoint ``cfg.ckpt`` names (``"latest"`` by default: a workspace
that holds ``checkpoints/ngp_step*.npz`` is resumed; ``"scratch"``
never). A checkpoint carries the state, the generator's state, the grid
refresh count and the adaptive-batch key, so a resumed run takes the
steps the unbroken run would have taken. ``evaluate`` writes the
validation PNGs (the port's own PNG writer, ``data.image_io.write_png``)
and ``test`` writes PNG frames where the JAX package writes a video when
it has a backend for one.

Several GPUs (``trainer.py:515-556``, ``:607-620``, ``:644-678``): with
``parallel.num_devices`` > 1 or ``tp_devices`` > 1 the Trainer is one rank
of a (dp, tp) layout (:mod:`raw_ngp_torch.parallel`) of the process group
the caller initialized, one Trainer a rank, every rank calling the same
methods in the same order. Each dp row draws its own rays
(``num_rays / n_dp`` of them, from a stream of its own) under a point
budget of ``max(budget // n_dp // 128 * 128, 128)``; the gradients are
averaged over the rows; under tp each rank holds its channel shard of the
table. The grid refresh draws from a stream every rank shares, so the
density grids stay equal; the eval render splits each chunk's rays over
the rows and gathers the results. Rank 0 alone logs and writes files;
checkpoints hold the whole flat table on every layout.

``test`` writes an HDR scene's merged frames (``hdr_<i>.png``,
``postprocess_raw_hdr``: numpy copies of cv2's HDR calibration, merge and
tonemaps) where the configuration's ``hdr_merge_algo`` is not "none".
"""

from __future__ import annotations

import copy
import dataclasses
import os
import time
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from raw_ngp_torch.config import Config
from raw_ngp_torch.data.image_io import write_png
from raw_ngp_torch.data.sampler import sample_ray_batch
from raw_ngp_torch.data.scene import SceneData
from raw_ngp_torch.device import resolve_device
from raw_ngp_torch.models.ngp import (DeviceAnnealing, FieldSpec, init_field,
                                     make_field_spec)
from raw_ngp_torch.ops.hashgrid import (total_variation_loss,
                                        weight_decay_loss)
from raw_ngp_torch.ops.lie import se3_to_SE3
from raw_ngp_torch.ops.grid import (init_grid_state, make_grid_update,
                                    mark_untrained_grid)
from raw_ngp_torch.parallel import mesh as pmesh
from raw_ngp_torch.parallel import tp as ptp
from raw_ngp_torch.postprocess.raw import postprocess_raw, postprocess_raw_hdr
from raw_ngp_torch.render.eval import coarse_volume, render_image, scene_aabb
from raw_ngp_torch.render.dispatch import render_any
from raw_ngp_torch.train.losses import (blend_gt_background, entropy_loss,
                                       ldr_loss, loss_weight_fn,
                                       rawnerf_loss)
from raw_ngp_torch.train import checkpoint
from raw_ngp_torch.train.dispatch import GraphedSteps
from raw_ngp_torch.train.metrics import PSNRMeter
from raw_ngp_torch.train.scalars import (AnnealingTables, CountTable,
                                        annealing_at, divide,
                                        first_count_at, on_device,
                                        sync_counter)
from raw_ngp_torch.train.state import AdamState, TrainState
from raw_ngp_torch.utils.logging import RunLogger, ThroughputMeter

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
    :func:`pose_adam`, with their host-side ``prepare(state)``: the
    state's device counter set to its host count and the per-count tables
    made on its device (run before a step or a chain of steps, outside any
    capture); ``scalars(state)`` gives the per-count device scalars the
    next update reads, which ``update_apply`` takes (``scalars=``) or
    reads itself. An optimizer without ``scalars`` (a wrapper that keeps
    only init / update_apply) reads its own in ``update_apply``."""

    def __init__(self, init, update_apply, prepare=None, scalars=None,
                 annealing=None):
        self.init = init
        self.update_apply = update_apply
        self.prepare = prepare
        self.scalars = scalars
        self.annealing = annealing


def _bias_correction(b):
    """count -> 1 - b^(count + 1) in f32, as the eager update computed
    Adam's bias correction."""
    return lambda c: _F32(1.0) - _F32(b) ** _F32(c + 1)


def fused_adam_ema(cfg: Config) -> _Optimizer:
    """Adam + skip-nonfinite + EMA in one pass over every parameter.

    Not ``torch.optim.Adam``: eps is ``cfg.train.adam_eps`` (1e-7) outside
    the square root, the LR is read at ``count`` before the increment, the
    EMA (decay ``cfg.train.ema_decay``) moves every step, and a step whose
    gradients hold any non-finite value leaves the params *and* the
    moments as they were (the EMA still moves toward the params). The
    decision is taken on the device: no host sync.

    ``update_apply(grads, state, params, ema, ok=None, scalars=None)``
    updates params, ema and the moments in place and returns (params, ema,
    state); ``ok`` (a bool tensor), where given, takes the place of the
    gradients' own finite check (a mesh's global gate). The LR over the
    bias correction and the second moment's correction are read at the
    device counter ``state.count_t`` from tables of the f32 host values
    (:class:`raw_ngp_torch.train.scalars.CountTable`), so the update can
    be captured in a CUDA graph; it advances ``count_t`` and its host
    mirror ``count``. ``prepare(state)`` sets ``count_t`` from ``count``.
    """
    lr_fn = network_lr_schedule(cfg)
    b1, b2 = 0.9, 0.999
    eps = cfg.train.adam_eps
    d = cfg.train.ema_decay

    mu_corr, nu_corr = _bias_correction(b1), _bias_correction(b2)

    def scale_at(c):        # lr(c) / (1 - b1^(c + 1)), f32
        return lr_fn(c) / mu_corr(c)

    lr_const = 6000 if cfg.train.anneal_lr else cfg.train.iters
    one = _F32(1.0)
    tables = on_device(lambda dev: (
        CountTable(scale_at, dev, const_from=max(
            lr_const, first_count_at(mu_corr, one))),
        CountTable(nu_corr, dev, const_from=first_count_at(nu_corr, one),
                   divisor=True)))

    def init(params):
        dev = next(iter(params.values())).device if params else "cpu"
        return AdamState(
            count=0, mu={k: torch.zeros_like(p) for k, p in params.items()},
            nu={k: torch.zeros_like(p) for k, p in params.items()},
            count_t=torch.zeros((), dtype=torch.int64, device=dev))

    def prepare(state: AdamState):
        dev = next(iter(state.mu.values())).device
        sync_counter(state, "count", dev)
        tables(dev)

    def read_scalars(state: AdamState):
        scale, nu = tables(state.count_t.device)
        return {"lr_over_bias_correction": scale.at(state.count_t),
                **nu.entry("nu_correction", state.count_t)}

    @torch.no_grad()
    def update_apply(grads, state: AdamState, params, ema, ok=None,
                     scalars=None):
        if state.count_t is None:
            prepare(state)
        sc = scalars if scalars is not None else read_scalars(state)
        if ok is None:
            ok = torch.stack([torch.isfinite(g).all()
                              for g in grads.values()]).all()
        okf = ok.float()
        step_scale = okf * sc["lr_over_bias_correction"]
        for k, p in params.items():
            m, v, e = state.mu[k], state.nu[k], ema[k]
            # select, not multiply: inf * 0 == NaN would poison the step
            g = torch.where(ok, grads[k], 0.0)
            m2 = b1 * m + (1.0 - b1) * g
            v2 = b2 * v + (1.0 - b2) * g * g
            p2 = p - step_scale * m2 / (torch.sqrt(
                divide(v2, sc, "nu_correction")) + eps)
            m.copy_(okf * m2 + (1.0 - okf) * m)
            v.copy_(okf * v2 + (1.0 - okf) * v)
            e.copy_(d * e + (1.0 - d) * p2)
            p.copy_(p2)
        state.count_t.add_(1)
        state.count += 1
        return params, ema, state

    return _Optimizer(init=init, update_apply=update_apply, prepare=prepare,
                      scalars=read_scalars)


def pose_adam(cfg: Config) -> _Optimizer:
    """The pose optimizer: ``optax.chain(skip_nonfinite(),
    optax.adam(pose_lr_schedule, eps=1e-8))`` with optax's semantics.

    Not ``torch.optim.Adam`` and not :func:`fused_adam_ema`: b1 0.9, b2
    0.999, eps 1e-8 outside the square root, the LR read at the count
    before the increment, no EMA. A step whose gradient holds a non-finite
    value *zeroes the gradient before Adam* (skip_nonfinite), so the
    moments still decay and the pose still moves by the momentum.

    ``update_apply(grad, state, params, scalars=None)`` updates params and
    the moments in place and returns (params, state). Its bias
    corrections and LR are read at ``state.count_t`` as
    :func:`fused_adam_ema`'s are (the LR table runs to the count where the
    decaying f32 LR reaches 0). ``annealing(device)`` gives the
    refinement's coarse-to-fine annealing tables
    (:class:`raw_ngp_torch.train.scalars.AnnealingTables`), which the
    train step reads at its own counter."""
    lr_fn = pose_lr_schedule(cfg)
    b1, b2, eps = 0.9, 0.999, 1e-8

    def minus_lr(c):
        return -lr_fn(c)

    corrs = [_bias_correction(b) for b in (b1, b2)]
    tables = on_device(lambda dev: tuple(
        CountTable(f, dev, const_from=first_count_at(f, _F32(1.0)),
                   divisor=True) for f in corrs) + (
        CountTable(minus_lr, dev,
                   const_from=first_count_at(minus_lr, _F32(0.0))),))
    annealing = on_device(lambda dev: AnnealingTables(cfg, dev))

    def init(params):
        return AdamState(count=0, mu={"pose": torch.zeros_like(params)},
                         nu={"pose": torch.zeros_like(params)},
                         count_t=torch.zeros((), dtype=torch.int64,
                                             device=params.device))

    def prepare(state: AdamState):
        dev = state.mu["pose"].device
        sync_counter(state, "count", dev)
        tables(dev)
        annealing(dev)

    def read_scalars(state: AdamState):
        mu_c, nu_c, lr = tables(state.count_t.device)
        return {**mu_c.entry("mu_correction", state.count_t),
                **nu_c.entry("nu_correction", state.count_t),
                "minus_lr": lr.at(state.count_t)}

    @torch.no_grad()
    def update_apply(grad, state: AdamState, params, scalars=None):
        if state.count_t is None:
            prepare(state)
        sc = scalars if scalars is not None else read_scalars(state)
        # skip_nonfinite: select, not multiply (inf * 0 == NaN)
        g = torch.where(torch.isfinite(grad).all(), grad, 0.0)
        mu, nu = state.mu["pose"], state.nu["pose"]
        mu.copy_((1 - b1) * g + b1 * mu)
        nu.copy_((1 - b2) * (g * g) + b2 * nu)
        mu_hat = divide(mu, sc, "mu_correction")
        nu_hat = divide(nu, sc, "nu_correction")
        params.add_(sc["minus_lr"] * (mu_hat / (torch.sqrt(nu_hat) + eps)))
        state.count_t.add_(1)
        state.count += 1
        return params, state

    return _Optimizer(init=init, update_apply=update_apply, prepare=prepare,
                      scalars=read_scalars, annealing=annealing)


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


def make_batch_loss_fn(cfg: Config, spec: FieldSpec):
    """Render + loss over an explicit ray batch:
    ``batch_loss_fn(field, state, batch, aabb, generator=None,
    plain=False, point_budget=None, annealing=1.0) -> (loss, aux)``,
    rendering through :func:`raw_ngp_torch.render.dispatch.render_any`.
    A ``None`` generator is the deterministic mode (march jitter 0.5;
    unjittered proposal sampling), in which ``lambda_tv > 0`` raises
    ``ValueError`` (no points to draw). HDR batches carry
    ``exposure`` [N, 1] and, when mosaiced, ``lossmult`` [N, 3]; an
    rfield field's batch carries ``rays_ldir`` [N, 3], and a batch with
    ``cam_near_far`` [N, 2] clamps each ray to it. The loss adds, in
    JAX's order, ``lambda_proposal`` times the proposal loss and
    ``lambda_distort`` times the distortion loss where the render returns
    them, ``lambda_orientation`` times the orientation loss, and where
    their weights are > 0 the entropy of ``weights_sum`` and the TV and
    weight decay of the radiance grid."""
    hdr = cfg.data.image_mode == "HDR"
    t = cfg.train

    def batch_loss_fn(field, state: TrainState, batch, aabb, generator=None,
                      plain: bool = False, point_budget=None,
                      annealing=1.0):
        rays_o, rays_d = batch["rays_o"], batch["rays_d"]
        bg = _bg_color(cfg, generator, rays_o.shape[0], rays_o.device)
        gt_rgb = blend_gt_background(batch["images"], bg)
        out = render_any(
            field, rays_o, rays_d, aabb, state.density_bitfield,
            bg_color=bg, rays_ldir=batch.get("rays_ldir"),
            cam_near_far=batch.get("cam_near_far"), annealing=annealing,
            training=True, generator=generator, plain=plain,
            coarse_lin=batch.get("coarse_lin"),
            point_budget=point_budget)
        if hdr:
            lw = loss_weight_fn(cfg.train.loss_weight, gt_rgb)
            loss = rawnerf_loss(out["image"], gt_rgb, batch["exposure"],
                                batch.get("lossmult", 1.0), lw)
        else:
            loss = ldr_loss(out["image"], gt_rgb)
        if "proposal_loss" in out:
            loss = loss + t.lambda_proposal * out["proposal_loss"]
        if "distort_loss" in out:
            loss = loss + t.lambda_distort * out["distort_loss"]
        if "orientation_loss" in out:
            loss = loss + t.lambda_orientation * out["orientation_loss"]
        if t.lambda_entropy > 0:
            loss = loss + t.lambda_entropy * entropy_loss(out["weights_sum"])
        # the reference's in-place gradient regularizers as loss terms
        if t.lambda_tv > 0:
            loss = loss + t.lambda_tv * total_variation_loss(
                field.grid, spec.grid_spec, generator)
        if t.lambda_wd > 0:
            loss = loss + t.lambda_wd * weight_decay_loss(field.grid,
                                                          spec.grid_spec)
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
    intrinsics, the light-stage scene's exposures and ldirs and the
    cameras' cam_near_far where it has them and, when the Trainer has
    cached it, coarse_lin. The rays
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
            cam_near_far=scene.get("cam_near_far"),
            mosaiced=cfg.data.mosaiced)
        if "coarse_lin" in scene:
            batch["coarse_lin"] = scene["coarse_lin"]
        return batch_loss_fn(field, state, batch, aabb, generator, plain,
                             point_budget, annealing)

    return loss_fn


def proposal_gate(step: int) -> float:
    """The factor of the proposal networks' gradients at a step (counted
    before its increment): 1 on the first 3001 steps and on every fifth
    step after, else 0. The step reads it on the device
    (:func:`proposal_gate_t`)."""
    return 1.0 if step <= 3000 or step % 5 == 0 else 0.0


def proposal_gate_t(step_t: torch.Tensor) -> torch.Tensor:
    """:func:`proposal_gate` at the device counter ``step_t`` (0-d f32):
    (step <= 3000) | (step % 5 == 0), as JAX's step computes it."""
    return ((step_t <= 3000) | (step_t % 5 == 0)).float()


def make_train_step(cfg: Config, spec: FieldSpec, net_tx: _Optimizer,
                    num_rays: int, point_budget=None,
                    pose_tx: Optional[_Optimizer] = None, reduce=None):
    """One training step, ``train_step(field, state, scene, aabb,
    generator) -> metrics``: sample, render, loss, backward and the fused
    Adam + EMA update, in place on ``state`` (whose params are the
    field's); under pose refinement also the pose update, its gradient
    multiplied by 0 from ``int(end_annealing * iters)`` on (Adam's
    momentum still moves the poses). On the proposal path the proposal
    networks' gradients are multiplied by :func:`proposal_gate` (a
    multiply, not a skip: a non-finite gradient times 0 stays NaN and
    makes the fused update skip the step, as in JAX). Metrics stay on the
    device. ``reduce`` (a mesh's, :func:`raw_ngp_torch.parallel.mesh.
    make_reduce`) takes (grads, pose gradient, loss, aux) after the
    backward and returns them reduced over the ranks with the update's
    finite gate.

    The step reads every per-step scalar (annealing, gate, freeze, the
    optimizers' LR and bias corrections) on the device at the state's
    counters (``state.step_t``, the optimizers' ``count_t``), which it
    advances with their host mirrors: ``train_step.device_step`` is that
    part, the one a CUDA graph captures
    (:mod:`raw_ngp_torch.train.dispatch`), and ``train_step.prepare(state)``
    the host work before a step or a chain of them (the device counters
    set from the host ones, the tables made). ``train_step`` is
    ``prepare(state)`` then ``device_step``. ``train_step.scalars(state)``
    gives the device scalars the next step reads: ``device_step`` reads
    them there, once, and hands the optimizers theirs."""
    loss_fn = make_loss_fn(cfg, spec, num_rays)
    pose_freeze_step = int(cfg.pose_opt.end_annealing * cfg.train.iters)
    annealed = cfg.pose_opt.mode != "none"
    txs = (("net", net_tx, lambda st: st.opt_state),
           ("pose", pose_tx, lambda st: st.pose_opt_state))

    def prepare(state: TrainState):
        sync_counter(state, "step", next(iter(state.params.values())).device)
        for _, tx, st in txs:
            if st(state) is not None and tx.prepare is not None:
                tx.prepare(st(state))

    def scalars(state: TrainState) -> Dict[str, torch.Tensor]:
        step_t = state.step_t
        out = {}
        if annealed:
            a = pose_tx.annealing(step_t.device).at(step_t)
            out["annealing_alpha"] = a.alpha
            if a.j_star is not None:
                out["j_star"] = a.j_star
        if spec.prop_specs:
            out["proposal_gate"] = proposal_gate_t(step_t)
        if state.pose_params is not None:
            out["pose_freeze"] = (step_t >= pose_freeze_step).float()
        for name, tx, st in txs:
            if st(state) is not None and tx.scalars is not None:
                out.update({f"{name}.{k}": v
                            for k, v in tx.scalars(st(state)).items()})
        return out

    def of(sc, name, tx):
        """update_apply's keyword: ``tx``'s scalars out of the step's."""
        if tx.scalars is None:
            return {}
        n = len(name) + 1
        return {"scalars": {k[n:]: v for k, v in sc.items()
                            if k.startswith(name + ".")}}

    def device_step(field, state: TrainState, scene, aabb, generator):
        sc = scalars(state)
        for p in state.params.values():
            p.grad = None
        pose = state.pose_params
        if pose is not None:
            pose.grad = None
        annealing = (DeviceAnnealing(
            L=pose_tx.annealing(state.step_t.device).L,
            alpha=sc["annealing_alpha"], j_star=sc.get("j_star"))
            if annealed else 1.0)
        loss, aux = loss_fn(field, state, scene, aabb, generator,
                            point_budget=point_budget, annealing=annealing)
        loss.backward()
        grads = {k: p.grad if p.grad is not None else torch.zeros_like(p)
                 for k, p in state.params.items()}
        g_pose = ok = None
        if pose is not None:
            g_pose = (pose.grad if pose.grad is not None
                      else torch.zeros_like(pose))
        if reduce is not None:
            grads, g_pose, loss, aux, ok = reduce(grads, g_pose, loss, aux)
        if spec.prop_specs:
            for k in grads:
                if k.startswith("prop_"):
                    grads[k] = grads[k] * sc["proposal_gate"]
        # a mesh's global finite gate, where it has one
        gate_kw = {} if ok is None else {"ok": ok}
        net_tx.update_apply(grads, state.opt_state, state.params,
                            state.ema_params, **of(sc, "net", net_tx),
                            **gate_kw)
        if pose is not None:
            pose_tx.update_apply(g_pose * (1.0 - sc["pose_freeze"]),
                                 state.pose_opt_state, pose.data,
                                 **of(sc, "pose", pose_tx))
        state.step_t.add_(1)
        state.step += 1
        # detached: a metric that kept the step's autograd graph would keep
        # its activations, and its AccumulateGrad nodes on their stream
        return {"loss": loss.detach(),
                **{k: v.detach() if torch.is_tensor(v) else v
                   for k, v in aux.items()}}

    def train_step(field, state: TrainState, scene, aabb, generator):
        prepare(state)
        return device_step(field, state, scene, aabb, generator)

    train_step.prepare = prepare
    train_step.device_step = device_step
    train_step.scalars = scalars
    return train_step


def dataclasses_replace_scene(scene: SceneData, new_poses):
    """SceneData with replaced poses (keeps poses_gt for evaluation)."""
    if scene.poses_gt is None:
        scene = dataclasses.replace(scene, poses_gt=scene.poses.copy())
    return dataclasses.replace(scene, poses=new_poses)


class Trainer:
    """Host-side orchestration of training on one device or as one rank of
    several, on the occupancy or the proposal path: ``train(iters)``,
    ``fit()`` (training with the eval and checkpoint schedule),
    ``render_image(pose)`` with the EMA parameters, ``evaluate()`` (PSNR,
    or the meters given, with optional artifacts), ``test(scene)`` and
    ``save_checkpoint`` / ``load_checkpoint``, in ``workspace`` (default
    ``cfg.workspace``). Runs on the card unless ``device="cpu"``.

    The device count follows JAX's rule: ``parallel.num_devices`` 0 takes
    every rank of the initialized process group (one device without
    one), N takes min(N, ranks), which must then be all of them; with
    more than one the Trainer is this rank's part of a (dp, tp) layout,
    ``tp_devices`` innermost (``mesh``, ``n_dp``, ``n_tp``)."""

    def __init__(self, cfg: Config, train_scene: SceneData,
                 val_scene: Optional[SceneData] = None, device="cuda",
                 workspace: Optional[str] = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.workspace = workspace or cfg.workspace
        os.makedirs(os.path.join(self.workspace, "checkpoints"),
                    exist_ok=True)
        self.mesh = self._make_mesh(cfg)
        self.is_main = self.mesh is None or self.mesh.is_main
        self.n_dp = self.mesh.n_dp if self.mesh else 1
        self.n_tp = self.mesh.n_tp if self.mesh else 1
        self.spec = make_field_spec(cfg)
        if self.n_tp > 1:
            self.spec = ptp.tp_spec(self.spec, self.mesh)
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
        for name in ("exposures", "ldirs", "cam_near_far"):
            if getattr(train_scene, name) is not None:
                self.scene_arrays[name] = torch.as_tensor(
                    getattr(train_scene, name), device=dev)
        self.aabb = scene_aabb(cfg, train_scene.pts_aabb, device=dev)
        self.field, self.state = init_train_state(cfg, self.spec, dev,
                                                  train_scene.n_images)
        if self.mesh is not None:
            with torch.no_grad():   # rank 0's initial state on every rank
                pmesh.replicate(checkpoint.state_tensors(self.state).values())
            if self.n_tp > 1:
                ptp.place_state_tp(self.field, self.state, self.mesh)
        # the EMA field renders from the state's EMA tensors (shared)
        self.ema_field = copy.deepcopy(self.field)
        for k, p in self.ema_field.named_parameters():
            p.requires_grad_(False)
            p.data = self.state.ema_params[k]
        self.net_tx = fused_adam_ema(cfg)
        self.pose_tx = pose_adam(cfg) if cfg.pose_opt.mode != "none" \
            else None
        # one stream on one device; on a mesh the grid refresh draws from a
        # stream every rank shares (``generator``) and the batches from
        # the dp row's own (``batch_generator``)
        self.generator = torch.Generator(device=dev).manual_seed(
            cfg.train.seed)
        self.batch_generator = self.generator
        if self.mesh is not None:
            self.batch_generator = torch.Generator(device=dev).manual_seed(
                pmesh.batch_seed(cfg.train.seed, self.mesh.dp_rank))
        self.num_rays = cfg.train.num_rays
        if self.num_rays % self.n_dp:
            raise ValueError(f"num_rays {self.num_rays} must divide by the "
                             f"dp size {self.n_dp}")
        self._grid_update = (make_grid_update(cfg) if cfg.render.occupancy
                             else None)
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
        # JAX's chained dispatch on one card: a CUDA graph of the step a
        # key (a mesh's gloo collectives stay eager)
        self._graphs = (GraphedSteps(self) if self.device.type == "cuda"
                        and self.mesh is None else None)
        # observability (train_utils.py:428-432 console+file, :919-937
        # tensorboard) and the auto-resume policy (train_utils.py:444-463)
        self.logger = RunLogger(self.workspace, enabled=self.is_main)
        self.throughput = ThroughputMeter()
        self._restored = ()
        if cfg.ckpt != "scratch":
            self.load_checkpoint()
        # a checkpoint that restored the density grid makes the marking moot
        if (cfg.render.mark_untrained and cfg.render.occupancy
                and "density_grid" not in self._restored):
            if self.is_main:   # on a mesh rank 0's, then replicated
                grid = mark_untrained_grid(
                    cfg, np.asarray(train_scene.poses),
                    np.asarray(train_scene.intrinsics),
                    self.aabb.cpu().numpy(),
                    cam_near_far=train_scene.cam_near_far)
                self.state.density_grid = torch.from_numpy(grid).to(dev)
            if self.mesh is not None:
                pmesh.replicate([self.state.density_grid])

    @staticmethod
    def _make_mesh(cfg: Config):
        """The rank layout, None on one device (``trainer.py:519-524``)."""
        n_req, n_tp = cfg.parallel.num_devices, cfg.parallel.tp_devices
        world = dist.get_world_size() if dist.is_initialized() else 1
        n = world if n_req == 0 else min(n_req, world)
        if n_tp > 1 and n <= 1:
            raise RuntimeError(
                f"tp_devices {n_tp} needs a torch.distributed process group "
                f"of {n_tp} ranks or more (ranks: {world})")
        if n <= 1:
            return None
        if n != world:
            raise ValueError(f"num_devices {n_req}: the process group has "
                             f"{world} ranks, and a mesh takes all of them")
        if n % n_tp:
            raise ValueError(f"tp_devices {n_tp} must divide the device "
                             f"count {n}")
        if n_tp > 1:
            return ptp.make_tp_mesh(n // n_tp, n_tp)
        return pmesh.make_mesh(n)

    # ------------------------------------------------------------------
    def base_point_budget(self) -> int:
        """The config-derived compacted point budget."""
        cfg = self.cfg
        return max(int(cfg.train.num_rays * cfg.render.samples_per_ray
                       * cfg.render.compact_ratio) // 128 * 128, 128)

    def _make_step(self):
        """The train step for the current adaptive-batch key (num_rays,
        point budget; budget None = the config-derived base). On a mesh
        the budget a rank renders under is always explicit, the global one
        split over the dp rows (``trainer.py:644-678``)."""
        if self.mesh is None:
            return make_train_step(self.cfg, self.spec, self.net_tx,
                                   self.num_rays,
                                   point_budget=self._point_budget,
                                   pose_tx=self.pose_tx)
        make = (ptp.make_tp_train_step if self.n_tp > 1
                else pmesh.make_parallel_train_step)
        return make(self.cfg, self.spec, self.net_tx, self.num_rays,
                    self.mesh, point_budget=self.local_point_budget(),
                    pose_tx=self.pose_tx)

    def local_point_budget(self):
        """The point budget one rank's render runs under: on one device
        the adaptive-batch key's (None at the config-derived base: the
        render's own), on a mesh the global one split over the dp rows."""
        cfg, budget = self.cfg, self._point_budget
        if self.mesh is None:
            return budget
        if (budget is None and cfg.render.occupancy
                and cfg.render.compact_ratio > 0):
            budget = self.base_point_budget()
        return (None if budget is None
                else pmesh.local_point_budget(budget, self.n_dp))

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
        for the whole refresh interval: written into the cached tensor in
        place once there is one (a captured step reads that buffer)."""
        if self.cfg.render.coarse_probes <= 0:
            return
        vol = coarse_volume(self.cfg, self.state.density_bitfield)
        old = self.scene_arrays.get("coarse_lin")
        if (old is not None and old.shape == vol.shape
                and old.dtype == vol.dtype and old.device == vol.device):
            old.copy_(vol)
        else:
            self.scene_arrays["coarse_lin"] = vol

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

    def _refresh(self):
        """The work at an ``update_extra_interval`` boundary of the
        occupancy path, between chains: the grid refresh, copied into the
        state's own grid buffers (a captured step reads those), the coarse
        cache and (after the 16 full sweeps) the batch adaptation from the
        previous interval's last metrics."""
        grid = self._grid_update(self.field, self.state.grid_state(),
                                 self.host_grid_updates, self.generator)
        with torch.no_grad():
            for k, v in grid.items():
                getattr(self.state, k).copy_(v)
        self.host_grid_updates += 1
        self._refresh_coarse_cache()
        if self._adaptive() and self.host_grid_updates > 16:
            if self._adapt_stash is not None:
                self._adapt_batch(self._adapt_stash)
            self._adapt_stash = self._metrics

    def step(self):
        """One eager training step, preceded on the occupancy path at every
        ``update_extra_interval`` boundary by :meth:`_refresh`. Returns the
        step's metrics (device tensors)."""
        cfg = self.cfg
        if (cfg.render.occupancy
                and self.host_step % cfg.render.update_extra_interval == 0):
            self._refresh()
        self._metrics = self._train_step(self.field, self.state,
                                         self.scene_arrays, self.aabb,
                                         self.batch_generator)
        self.host_step += 1
        return self._metrics

    def steps_per_dispatch(self) -> int:
        """The dispatch chain length (``trainer.py:809-811``):
        ``train.steps_per_dispatch``, or where it is 0 the refresh
        interval on the occupancy path and 16 on the proposal path."""
        n = self.cfg.train.steps_per_dispatch
        if n == 0:
            n = (self.cfg.render.update_extra_interval
                 if self.cfg.render.occupancy else 16)
        return n

    def _dispatch(self, n: int, chained: bool):
        """n steps at the current key with nothing between them on the
        host: a chain's replays of the step's CUDA graph where ``chained``
        on one card, else n eager steps. Returns the last step's
        metrics."""
        if chained and self._graphs is not None:
            return self._graphs.run(n)
        for _ in range(n):
            metrics = self._train_step(self.field, self.state,
                                       self.scene_arrays, self.aabb,
                                       self.batch_generator)
        return metrics

    def train(self, iters: Optional[int] = None, log_every: int = 100):
        """``iters`` steps in JAX's dispatch chains (``Trainer.train``,
        ``trainer.py:797-848``): chains of :meth:`steps_per_dispatch`
        steps, cut at the refresh boundaries of the occupancy path, where
        :meth:`_refresh` runs between them; a chain of the full length runs
        as one dispatch, a shorter remainder step by step. On one card a
        chain of more than one step is replays of a CUDA graph of the step
        (:mod:`raw_ngp_torch.train.dispatch`, one graph an adaptive-batch
        key, bitwise the eager steps); ``steps_per_dispatch=1`` runs every
        step eagerly, as on the CPU and on a mesh (whose gloo collectives a
        graph cannot hold). The loss is logged after the first chain and
        where a chain crosses a multiple of ``log_every``; returns wall
        time and rays/s (the clock stops after the last step's loss has
        reached the host)."""
        iters = iters or self.cfg.train.iters
        cfg = self.cfg
        occupancy = cfg.render.occupancy
        interval = cfg.render.update_extra_interval
        scan_n = self.steps_per_dispatch()
        chained = scan_n > 1
        t0 = time.time()
        total_rays = 0
        metrics = None
        i = 0
        while i < iters:
            if occupancy and self.host_step % interval == 0:
                self._refresh()
            n = min(scan_n, iters - i)
            if occupancy:
                n = min(n, interval - self.host_step % interval)
            if n == scan_n or n == 1:
                metrics = self._dispatch(n, chained)
            else:
                for _ in range(n):
                    metrics = self._dispatch(1, chained)
            self._metrics = metrics
            prev_i, i = i, i + n
            self.host_step += n
            total_rays += n * self.num_rays
            self.throughput.update(n * self.num_rays)
            if prev_i == 0 or prev_i // log_every != i // log_every:
                loss = float(metrics["loss"])
                self.stats["loss"].append(loss)
                self.logger.log(
                    f"[train] step {self.host_step:6d} loss {loss:.6f} "
                    f"({i / (time.time() - t0):.1f} it/s)")
                self.logger.scalar("train/loss", loss, self.host_step)
                if self.logger.active:   # a read for tensorboard
                    self.logger.scalar("train/num_points",
                                       float(metrics["num_points"]),
                                       self.host_step)
                self.logger.scalars(self.throughput.rates(), self.host_step,
                                    prefix="throughput")
        self.stats["loss"].append(float(metrics["loss"]))
        dt = time.time() - t0
        rays_per_sec = total_rays / dt
        if self.is_main:
            print(f"[train] {iters} steps in {dt:.1f}s = "
                  f"{rays_per_sec:,.0f} rays/s")
        return {"wall_time": dt, "rays_per_sec": rays_per_sec}

    # ------------------------------------------------------------------
    def render_image(self, pose, intrinsics=None, H=None, W=None,
                     use_ema: bool = True, ldir=None,
                     return_normals: bool = False):
        """Full-image chunked render with the EMA parameters (raw ones
        with ``use_ema=False``) at the current annealing,
        min(host_step / iters, 1), under light direction ``ldir`` [3] (an
        rfield field's) -> numpy (rgb [H, W, 3], depth [H, W]); with
        ``return_normals`` a third, the normal map [H, W, 3] (None unless
        ``cfg.render.compute_normals`` on the occupancy path)."""
        scene = self.train_scene
        intrinsics = intrinsics if intrinsics is not None \
            else scene.intrinsics
        field = self.ema_field if use_ema else self.field
        annealing = min(self.host_step / max(self.cfg.train.iters, 1), 1.0)
        out = render_image(field, self.state.density_bitfield, pose,
                           intrinsics, H or scene.H, W or scene.W,
                           self.aabb, device=self.device,
                           annealing=annealing, ldir=ldir,
                           return_normals=return_normals, mesh=self.mesh)
        return tuple(None if t is None else t.cpu().numpy() for t in out)

    def gathered_field(self):
        """The radiance field (raw parameters) whole on this rank: under
        tensor parallelism a copy with the table gathered from the row's
        shards and an unsharded spec (every rank of the row calls it),
        else the field itself."""
        if self.n_tp == 1:
            return self.field
        field = copy.deepcopy(self.field)
        field.spec = dataclasses.replace(self.spec, tp_group=None,
                                         tp_devices=1)
        with torch.no_grad():
            field.grid = torch.nn.Parameter(
                ptp.gather_table(self.field.grid, self.spec.grid_spec,
                                 self.mesh), requires_grad=False)
        return field

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
        self.logger.log("[eval] exposure levels for consistent LDR "
                        f"output: {self.exposure_levels}")
        return self.exposure_levels

    def log_histograms(self):
        """Tensorboard histograms at eval cadence: the gradients of the
        hash grid and the grid / view MLPs on a fresh ray batch
        (train_utils.py:919-930), tagged as the JAX package tags its tree
        paths (``grad/grid/w``, ``grad/grid_mlp/[0]w``, ...), plus the
        density grid and mean density (train_utils.py:1155-1164). The batch
        comes from a generator of its own, seeded from the step, and the
        gradient is taken with ``torch.autograd.grad``: training's
        generator and the parameters' ``.grad`` are left as they were. On a
        mesh every rank takes the gradient of its share of the rays (the
        same draws on every rank: the tp all-gather's backward needs the
        whole row) and rank 0 writes its own, the whole table's under
        tp."""
        if not self.logger.active:
            return
        cfg, step = self.cfg, self.host_step
        gen = torch.Generator(device=self.device).manual_seed(
            cfg.train.seed + step)
        loss_fn = make_loss_fn(cfg, self.spec, self.num_rays // self.n_dp)
        loss, _ = loss_fn(self.field, self.state, self.scene_arrays,
                          self.aabb, gen,
                          annealing=annealing_at(cfg, self.state.step))
        names = list(self.state.params)
        grads = torch.autograd.grad(
            loss, [self.state.params[k] for k in names], allow_unused=True)
        for k, g in zip(names, grads):
            top, _, idx = k.partition(".")
            if top not in ("grid", "grid_mlp", "view_mlp") or g is None:
                continue
            if k == "grid" and self.n_tp > 1:
                g = ptp.gather_table(g / self.n_tp, self.spec.grid_spec,
                                     self.mesh)
            name = f"[{idx}]w" if idx else "w"
            self.logger.histogram(f"grad/{top}/{name}",
                                  g.float().cpu().numpy(), step)
        if self.state.density_grid is not None:
            self.logger.histogram("train/density_grid",
                                  self.state.density_grid.cpu().numpy(), step)
            self.logger.scalar("train/mean_density",
                               float(self.state.mean_density), step)

    def log_optimized_poses(self):
        """--log_poses: dump the current optimized poses to
        workspace/poses/ and log the Procrustes-aligned errors (reference
        main.py:112, train_utils.py:737-738)."""
        if self.state.pose_params is None:
            return None
        from raw_ngp_torch.train.pose_analysis import (
            analyze_pose_optimization,
            refined_poses,
        )
        poses = refined_poses(self)
        if self.is_main:
            pose_dir = os.path.join(self.workspace, "poses")
            os.makedirs(pose_dir, exist_ok=True)
            np.save(os.path.join(pose_dir,
                                 f"poses_step{self.host_step:06d}.npy"),
                    poses[:, :3, :4])
        errs = analyze_pose_optimization(self)
        for k, v in errs.items():
            self.logger.scalar(f"pose/{k}", v, self.host_step)
        self.logger.log(
            f"[pose] step {self.host_step}: "
            f"rot {errs['rotation_deg']:.4f} deg, "
            f"trans {errs['translation']:.5f}")
        return errs

    def evaluate(self, scene: Optional[SceneData] = None,
                 use_ema: bool = True, save_artifacts: bool = False,
                 metrics: Optional[list] = None,
                 export_npy: bool = False) -> Dict[str, float]:
        """The meters (default PSNR) over the renders of ``scene`` (default
        the val scene), each under its image's light direction, against
        its images; returns {meter name in lower case: value}. HDR: the
        exposure levels are estimated first, and the meters compare
        min(1, rgb * exposure) with min(1, gt). ``save_artifacts`` writes
        the rgb, depth, error and (where the configuration computes them)
        normal PNGs to ``<workspace>/validation``, an HDR scene's rgb and
        truth postprocessed at one exposure level; ``export_npy`` the raw
        prediction and truth to ``<workspace>/eval``
        (train_utils.py:977-1139). On a mesh every rank renders and
        measures; rank 0 writes."""
        scene = scene or self.val_scene
        if scene is None:
            raise ValueError("evaluate: no scene")
        hdr = self.cfg.data.image_mode == "HDR"
        if hdr:
            self.estimate_exposure_levels(scene)
        meters = metrics if metrics is not None else [PSNRMeter()]
        val_dir = os.path.join(self.workspace, "validation")
        eval_dir = os.path.join(self.workspace, "eval")
        save_artifacts = save_artifacts and self.is_main
        export_npy = export_npy and self.is_main
        if save_artifacts:
            os.makedirs(val_dir, exist_ok=True)
        if export_npy:
            os.makedirs(eval_dir, exist_ok=True)
        cam2rgb = _cam2rgb(scene) if hdr else None
        step = self.host_step
        for i in range(scene.n_images):
            rgb, depth, normal = self.render_image(
                scene.poses[i], scene.intrinsics, scene.H, scene.W,
                use_ema=use_ema,
                ldir=scene.ldirs[i] if scene.ldirs is not None else None,
                return_normals=True)
            gt = scene.images[i][..., :3]
            rgb_m, gt_m = rgb, gt
            if hdr and scene.exposures is not None:
                rgb_m = np.minimum(1.0, rgb * scene.exposures[i])
                gt_m = np.minimum(1.0, gt)
            for m in meters:
                m.update(rgb_m, gt_m)
            if export_npy:       # offline-eval protocol (:1023-1031)
                np.save(os.path.join(eval_dir, f"pred_{i:03d}.npy"), rgb)
                np.save(os.path.join(eval_dir, f"gt_{i:03d}.npy"), gt)
            if save_artifacts:   # validation dumps (:1062-1111)
                rgb_a, gt_a = rgb_m, gt_m
                if hdr and cam2rgb is not None and self.exposure_levels:
                    # predictions and truth at the SAME exposure level
                    # (train_utils.py:1075-1096)
                    level = self.exposure_levels.get(
                        self.cfg.data.exposure_percentile)
                    rgb_a = postprocess_raw(rgb, cam2rgb, level)
                    gt_a = postprocess_raw(gt, cam2rgb, level)
                d = depth / (depth.max() + 1e-8)
                err = np.abs(np.clip(rgb_a, 0, 1)
                             - np.clip(gt_a, 0, 1)).mean(-1)
                images = {"rgb": rgb_a, "depth": d, "error": err}
                if normal is not None:
                    images["normal"] = normal
                for kind, img in images.items():
                    write_png(os.path.join(val_dir,
                                           f"{kind}_{step}_{i:03d}.png"),
                              _to_u8(img))
        result = {m.name.lower(): m.measure() for m in meters}
        if "psnr" in result:
            self.stats["psnr"].append(result["psnr"])
        return result

    # ------------------------------------------------------------------
    # checkpointing (train_utils.py:1141-1299)
    def save_checkpoint(self, name: Optional[str] = None,
                        best: bool = False) -> str:
        """``ngp_step<step>`` (or ``name``) under ``<workspace>/checkpoints``
        with the rolling ``train.max_keep_ckpt`` retention; ``best`` writes
        ``ngp_best`` with the EMA weights as its params
        (train_utils.py:1192-1215). Beside the state: the generator's
        state, the grid refresh count and the adaptive-batch key. On a mesh
        every rank calls it and rank 0 writes the file a single device
        would: the whole flat table (gathered under tp), and beside the
        shared generator the dp rows' batch streams (``batch_generators``,
        [n_dp, ...]); the other ranks wait for it and get the path."""
        ckpt_dir = os.path.join(self.workspace, "checkpoints")
        extra = {"generator": self.generator.get_state().numpy()}
        if self.mesh is not None:
            gen = self.batch_generator.get_state().to(self.device)
            extra["batch_generators"] = pmesh.gather_rows(
                gen[None], self.mesh.dp_group, self.n_dp).cpu().numpy()
        meta = {"host_grid_updates": self.host_grid_updates,
                "adapt": {"num_rays": self.num_rays,
                          "point_budget": self._point_budget,
                          "pts_ema": self._pts_ema,
                          "stash": _host_points(self._adapt_stash),
                          "metrics": _host_points(self._metrics)}}
        state, stats = self.state, {"loss": self.stats["loss"][-1:]}
        if best:
            state = dataclasses.replace(self.state,
                                        params=self.state.ema_params)
            name, stats = "ngp_best", {"psnr": self.stats["psnr"][-1:]}
        name = name or f"ngp_step{self.host_step:06d}"
        tensors = checkpoint.state_tensors(state)
        if self.n_tp > 1:
            for k in ptp.SHARDED:
                tensors[k] = ptp.gather_table(tensors[k],
                                              self.spec.grid_spec, self.mesh)
        path = os.path.join(ckpt_dir, f"{name}.npz")
        if self.is_main:
            path = checkpoint.save_checkpoint(
                state, ckpt_dir, name, stats=stats,
                max_keep=self.cfg.train.max_keep_ckpt, extra=extra,
                meta=meta, tensors=tensors)
        if self.mesh is not None:
            dist.barrier()
        return path

    def load_checkpoint(self, mode: Optional[str] = None) -> bool:
        """Restore the checkpoint ``mode`` resolves to (default
        ``cfg.ckpt``; :func:`raw_ngp_torch.train.checkpoint.
        resolve_checkpoint`), in place; False when there is none. The
        step counters, the generator and the adaptive-batch key come back
        where the checkpoint has them, and the coarse cache is rebuilt
        from the restored bitfield. On a mesh every rank reads the file and
        takes its channel shard of the tables (any layout's file loads on
        any layout) and its dp row's batch stream where the file has one
        for this layout."""
        mode = mode or self.cfg.ckpt
        path = checkpoint.resolve_checkpoint(
            os.path.join(self.workspace, "checkpoints"), mode)
        if path is None:
            return False
        shard = None
        if self.n_tp > 1:
            def shard(key, arr):
                if key not in ptp.SHARDED:
                    return arr
                return ptp.shard_of(torch.from_numpy(arr),
                                    self.spec.grid_spec, self.n_tp,
                                    self.mesh.tp_rank).numpy()
        _, meta = checkpoint.load_checkpoint(self.state, path,
                                             transform=shard)
        self._restored = meta["loaded"]
        self.host_step = int(meta.get("step", self.state.step))
        interval = max(self.cfg.render.update_extra_interval, 1)
        self.host_grid_updates = int(meta.get(
            "host_grid_updates", self.host_step // interval))
        gen = meta["extra"].get("generator")
        if gen is not None and gen.shape == tuple(
                self.generator.get_state().shape):
            self.generator.set_state(torch.from_numpy(gen))
        rows = meta["extra"].get("batch_generators")
        if (self.mesh is not None and rows is not None
                and rows.shape == (self.n_dp,) + tuple(
                    self.batch_generator.get_state().shape)):
            self.batch_generator.set_state(
                torch.from_numpy(rows[self.mesh.dp_rank].copy()))
        adapt = meta.get("adapt")
        if adapt:
            self.num_rays = adapt["num_rays"]
            self._point_budget = adapt["point_budget"]
            self._pts_ema = adapt["pts_ema"]
            self._adapt_stash = adapt["stash"]
            self._metrics = adapt["metrics"]
            self._train_step = self._make_step()
        # the restored bitfield invalidates the cached coarse volume
        if self.cfg.render.occupancy:
            self._refresh_coarse_cache()
        self.logger.log(f"[ckpt] restored {path} at step {self.host_step} "
                        f"({meta['n_loaded']} arrays)")
        return True

    # ------------------------------------------------------------------
    # training with eval/save cadence (train_utils.py:724-766 semantics)
    def fit(self, iters: Optional[int] = None):
        """Train with the reference's periodic eval + checkpoint schedule
        (save ~save_cnt times, eval ~eval_cnt times per run; the best val
        PSNR's EMA weights kept as ``ngp_best``)."""
        iters = iters or self.cfg.train.iters
        save_every = max(1, iters // max(1, self.cfg.train.save_cnt))
        eval_every = max(1, iters // max(1, self.cfg.train.eval_cnt))
        best_psnr = -1.0
        done = 0
        while done < iters:
            chunk = min(min(save_every, eval_every), iters - done)
            self.train(iters=chunk, log_every=max(chunk, 1))
            done += chunk
            if done % save_every < chunk:
                self.save_checkpoint()
            if self.cfg.pose_opt.log_poses:
                self.log_optimized_poses()
            if done % eval_every < chunk and self.val_scene is not None:
                self.log_histograms()
                r = self.evaluate()
                self.logger.log(f"[eval] step {self.host_step}: " + " ".join(
                    f"{k}={v:.4f}" for k, v in r.items()))
                if r.get("psnr", -1) > best_psnr:
                    best_psnr = r["psnr"]
                    self.save_checkpoint(best=True)
        return {"best_psnr": best_psnr}

    # ------------------------------------------------------------------
    # test-trajectory frames (train_utils.py:774-861)
    def test(self, scene: SceneData, save_dir: Optional[str] = None,
             write_video: bool = True):
        """Render every view of ``scene`` with the EMA parameters into
        ``save_dir`` (default ``<workspace>/results``) as PNG frames:
        ``rgb_<i>.png`` and, with ``write_video`` and more than one view,
        ``depth_<i>.png`` and (where the configuration computes them)
        ``normals_<i>.png`` too; the JAX package writes these as videos
        where it has a backend for them and as these frames where it does
        not. An HDR scene's frames are postprocessed at one exposure level;
        where ``cfg.hdr_merge_algo`` is not "none" each view's render is
        also merged across ``cfg.exposure_percentiles`` and tonemapped
        (``postprocess_raw_hdr``) into ``hdr_<i>.png`` beside them, under
        the same condition as the depth frames. Returns the rgb frames
        (uint8); on a mesh every rank renders them and rank 0 writes."""
        hdr = self.cfg.data.image_mode == "HDR"
        cam2rgb = _cam2rgb(scene) if hdr else None
        merge = cam2rgb is not None and self.cfg.hdr_merge_algo != "none"
        save_dir = save_dir or os.path.join(self.workspace, "results")
        if self.is_main:
            os.makedirs(save_dir, exist_ok=True)
        if hdr and not self.exposure_levels:
            # consistent-LDR exposure levels (train_utils.py:1008-1017);
            # normally populated by the eval loop, estimated here when
            # test runs standalone
            self.estimate_exposure_levels(scene)
        frames: Dict[str, list] = {"rgb": [], "depth": [], "normals": [],
                                   "hdr": []}
        for i in range(scene.n_images):
            rgb, depth, normal = self.render_image(
                scene.poses[i], scene.intrinsics, scene.H, scene.W,
                ldir=scene.ldirs[i] if scene.ldirs is not None else None,
                return_normals=True)
            if merge:
                # HDR-merged frames feed their OWN frames next to the
                # consistently exposed LDR ones (train_utils.py:851-857)
                frames["hdr"].append(_to_u8(postprocess_raw_hdr(
                    rgb, cam2rgb, self.cfg.exposure_percentiles,
                    self.cfg.hdr_merge_algo, self.cfg.data.hdr_tonemap)))
            if cam2rgb is not None:
                level = self.exposure_levels.get(
                    self.cfg.data.exposure_percentile)
                rgb = postprocess_raw(rgb, cam2rgb, level)
            frames["rgb"].append(_to_u8(rgb))
            frames["depth"].append(_to_u8(depth / (depth.max() + 1e-8)))
            if normal is not None:
                frames["normals"].append(_to_u8(normal))
        if not (write_video and len(frames["rgb"]) > 1):
            frames = {"rgb": frames["rgb"]}
        for name, imgs in frames.items() if self.is_main else ():
            for i, f in enumerate(imgs):
                write_png(os.path.join(save_dir, f"{name}_{i:03d}.png"), f)
        return frames["rgb"]


def _cam2rgb(scene: SceneData) -> Optional[np.ndarray]:
    """The colour matrix [3, 3] of an HDR scene's outputs, or None: the
    first image's where the meta holds one an image (the loaders), the
    scene's where it holds one (the synthetic scenes; the JAX package
    takes that one's first row there, and its postprocess raises)."""
    meta = scene.meta
    if meta is None or meta.cam2rgb is None or len(meta.cam2rgb) == 0:
        return None
    m = np.asarray(meta.cam2rgb)
    return m[0] if m.ndim == 3 else m


def _to_u8(img: np.ndarray) -> np.ndarray:
    """[0, 1] floats -> uint8, as the JAX package writes its images."""
    return (np.clip(img, 0, 1) * 255).astype(np.uint8)


def _host_points(metrics) -> Optional[Dict[str, float]]:
    """The point counts of a step's metrics (what the adaptive batching
    reads) as host floats, for a checkpoint's sidecar."""
    if metrics is None:
        return None
    return {k: float(metrics[k]) for k in ("num_points", "num_points_raw")
            if k in metrics}
