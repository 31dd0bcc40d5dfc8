"""Command-line entry point of the port (port of ``raw_ngp_tpu/cli.py``:
``build_parser`` ``:21``, ``args_to_config`` ``:200``, ``main`` ``:322``).

The same argparse surface as the JAX package's (reference main.py:9-127),
parsed into the same Config for the same argv, and its train -> evaluate
-> test -> mesh flow (main.py:224-285); its final evaluation reports SSIM
beside PSNR (the JAX CLI's reports PSNR). It runs on the card; on the CPU
only when the environment sets ``RAW_NGP_PLATFORM=cpu`` (``JAX_PLATFORMS``
is not read: a setting meant for JAX does not move the port off the
card). The test frames are PNGs (``results/rgb_000.png``, ...), not a
video.

Several GPUs: ``--n_devices N`` (0, the default, means every GPU present;
N is clamped to the GPUs present, JAX's rule) starts one rank a GPU
itself, each a process with NCCL, meeting through a file in the
workspace; with ``RAW_NGP_PLATFORM=cpu`` it starts N gloo ranks on the
CPU. ``--tp_devices`` shards the hash table's channels over that many of
them (:mod:`raw_ngp_torch.parallel`). Rank 0 logs and writes every file.

Usage:
  python -m raw_ngp_torch.cli <data_path> -O --iters 20000 --workspace ws
  python -m raw_ngp_torch.cli <data_path> --test --ckpt latest
"""

from __future__ import annotations

import argparse
import os
import time
from dataclasses import replace
from typing import Optional

import torch

from raw_ngp_torch.device import resolve_device


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="raw_ngp_torch: raw/HDR Instant-NGP on one NVIDIA GPU")
    p.add_argument("path", type=str)
    p.add_argument("-O", action="store_true",
                   help="occupancy-grid NGP preset (reference -O)")
    p.add_argument("-O2", dest="O2", action="store_true",
                   help="contracted proposal-network preset (reference -O2)")
    p.add_argument("--workspace", type=str, default="workspace")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--ckpt", type=str, default="latest")
    p.add_argument("--fp16", action="store_true")

    # testing
    p.add_argument("--save_cnt", type=int, default=50)
    p.add_argument("--eval_cnt", type=int, default=10)
    p.add_argument("--test", action="store_true")
    p.add_argument("--test_no_video", action="store_true")
    p.add_argument("--test_no_mesh", action="store_true")
    p.add_argument("--camera_traj", type=str, default="interp",
                   choices=["interp", "circle"])

    # dataset
    p.add_argument("--data_format", type=str, default="colmap",
                   choices=["nerf", "colmap", "dtu", "synthetic"])
    p.add_argument("--train_split", type=str, default="train",
                   choices=["train", "trainval", "all"])
    p.add_argument("--preload", action="store_true")
    p.add_argument("--downscale", type=int, default=1)
    p.add_argument("--bound", type=float, default=2.0)
    p.add_argument("--scale", type=float, default=-1.0)
    p.add_argument("--offset", type=float, nargs="*", default=[0, 0, 0])
    p.add_argument("--enable_cam_near_far", action="store_true")
    p.add_argument("--enable_cam_center", action="store_true")
    p.add_argument("--min_near", type=float, default=0.05)
    p.add_argument("--T_thresh", type=float, default=1e-8)

    # training
    p.add_argument("--iters", type=int, default=20000)
    p.add_argument("--lr", type=float, default=1e-2)
    p.add_argument("--cuda_ray", "--occupancy", dest="occupancy",
                   action="store_true",
                   help="occupancy-grid marching (reference --cuda_ray)")
    p.add_argument("--max_steps", type=int, default=1024)
    p.add_argument("--num_steps", type=int, nargs="*", default=[256, 96, 48])
    p.add_argument("--contract", action="store_true")
    p.add_argument("--background", type=str, default="black",
                   choices=["white", "random", "last_sample", "black"])
    p.add_argument("--update_extra_interval", type=int, default=16)
    p.add_argument("--max_ray_batch", type=int, default=4096 * 4)
    p.add_argument("--grid_size", type=int, default=128)
    p.add_argument("--mark_untrained", action="store_true")
    p.add_argument("--dt_gamma", type=float, default=0.0)
    p.add_argument("--density_thresh", type=float, default=10.0)
    p.add_argument("--hashgrid_resolution", type=int, default=2048)
    p.add_argument("--hashmap_size", type=int, default=19)
    # model-size overrides (0 = keep the preset/default value); applied
    # AFTER preset composition so e.g. `-O --num_levels 4` shrinks the
    # occupancy-mode model
    p.add_argument("--num_levels", type=int, default=0)
    p.add_argument("--level_dim", type=int, default=0)
    p.add_argument("--hash_variant", default="",
                   choices=["", "xor", "additive"],
                   help="override the hash mixer (the TPU profile ships "
                        "additive; xor = reference gridencoder.cu:46-58 "
                        "for reference-exact comparisons)")
    p.add_argument("--grid_mlp_hidden", type=int, default=0)
    p.add_argument("--view_mlp_hidden", type=int, default=0)
    p.add_argument("--samples_per_ray", type=int, default=64,
                   help="TPU static per-ray sample budget")
    p.add_argument("--march_candidates", type=int, default=512)
    p.add_argument("--coarse_probes", type=int, default=0,
                   help="two-level march: probes per ray against the 4^3 "
                        "max-pooled occupancy before fine candidates "
                        "(0 = off)")
    p.add_argument("--march_cdf", action="store_true",
                   help="distribute fine candidates over the occupied "
                        "coarse probe intervals only (needs "
                        "--coarse_probes > 0)")
    p.add_argument("--probe_log", action="store_true",
                   help="geometric (disparity-style) probe intervals for "
                        "contracted/unbounded scenes (needs "
                        "--coarse_probes > 0)")
    p.add_argument("--cdf_floor", type=float, default=0.0,
                   help="epsilon candidate weight over unoccupied probe "
                        "intervals in the CDF march (free-space "
                        "supervision for contracted scenes; 0 = pure "
                        "occupied-only placement)")
    p.add_argument("--tpu_profile", action="store_true",
                   help="apply the TPU-optimized flagship profile on top "
                        "of the chosen preset (L2xC16 grid, CDF march; "
                        "the configuration bench.py measures)")

    # batch size
    p.add_argument("--num_rays", type=int, default=4096)
    p.add_argument("--adaptive_num_rays", action="store_true")
    p.add_argument("--num_points", type=int, default=2 ** 18)

    # parallelism: data-parallel ray sharding over the device mesh
    p.add_argument("--n_devices", type=int, default=0,
                   help="number of ranks for data-parallel training: one "
                        "rank a GPU (NCCL), clamped to the GPUs present; "
                        "0 = every GPU, 1 = a single device; with "
                        "RAW_NGP_PLATFORM=cpu that many gloo ranks on the "
                        "CPU (0 = one)")
    p.add_argument("--tp_devices", type=int, default=1,
                   help="tensor-parallel factor: shard the hash table's "
                        "channel axis over this many devices (must divide "
                        "n_devices and level_dim); the mesh becomes "
                        "(n_devices/tp, tp)")

    # regularizers
    p.add_argument("--lambda_entropy", type=float, default=0.0)
    p.add_argument("--lambda_tv", type=float, default=0.0)
    p.add_argument("--lambda_wd", type=float, default=0.0)
    p.add_argument("--lambda_orientation", type=float, default=0.0)
    p.add_argument("--lambda_proposal", type=float, default=1.0)
    p.add_argument("--lambda_distort", type=float, default=0.0)

    # mesh
    p.add_argument("--mcubes_reso", type=int, default=512)
    p.add_argument("--env_reso", type=int, default=256)
    p.add_argument("--decimate_target", type=int, default=300000)
    p.add_argument("--mesh_visibility_culling", action="store_true")
    p.add_argument("--visibility_mask_dilation", type=int, default=5)
    p.add_argument("--clean_min_f", type=int, default=8)
    p.add_argument("--clean_min_d", type=int, default=5)

    # RAW / HDR
    p.add_argument("--image_mode", type=str, default="LDR",
                   choices=["LDR", "HDR"])
    p.add_argument("--expose", action="store_true")
    p.add_argument("--exposure_range", type=str, default="minimal",
                   choices=["minimal", "wide"])
    p.add_argument("--clip", action="store_true")
    p.add_argument("--internal_activation", type=str, default="relu",
                   choices=["relu", "softplus"])
    p.add_argument("--color_activation", type=str, default="clamped_exp",
                   choices=["exp", "sigmoid", "clamped_exp"])
    p.add_argument("--density_activation", type=str, default="clamped_exp",
                   choices=["softplus", "clamped_exp"])
    p.add_argument("--exposure_percentile", type=float, default=99.0)
    p.add_argument("--mosaiced", action="store_true")
    p.add_argument("--hdr_merge", default="none",
                   choices=["robertson", "debevec", "none"])
    p.add_argument("--hdr_tonemap", default="reinhard",
                   choices=["reinhard", "mantiuk", "drago"])

    # lightstage
    p.add_argument("--lightstage", action="store_true")
    p.add_argument("--bracketing", action="store_true")
    p.add_argument("--rfield", action="store_true")
    p.add_argument("--masked", action="store_true")
    p.add_argument("--r_mode", default="none",
                   choices=["all", "downsample3", "downsample6", "replace",
                            "none"])

    # pose refinement
    p.add_argument("--pose_opt", default="none",
                   choices=["barf", "baangp", "none"])
    p.add_argument("--num_cameras", type=int, default=-1)
    p.add_argument("--start_annealing", type=float, default=0.0)
    p.add_argument("--end_annealing", type=float, default=0.33)
    p.add_argument("--c_lr", type=float, default=1e-3)
    p.add_argument("--noise", type=float, default=0.0)
    p.add_argument("--log_poses", action="store_true")
    p.add_argument("--identity", action="store_true")

    # experimental
    p.add_argument("--compute_normals", action="store_true")
    p.add_argument("--loss_weight", default="none",
                   choices=["gaussian", "planck", "hanning", "none"])
    p.add_argument("--reduce_set", action="store_true")
    p.add_argument("--anneal_lr", action="store_true")
    p.add_argument("--beta", type=float, default=2.0)
    p.add_argument("--eval_batch", type=int, default=1)
    p.add_argument("--eval", dest="eval_export", action="store_true",
                   help="save raw predictions for offline evaluation")
    p.add_argument("--no_fused_encoder", action="store_true")
    return p


def args_to_config(args) :
    """argparse namespace -> immutable Config (+ preset composition,
    reference main.py:129-210)."""
    from raw_ngp_torch.config import (
        Config,
        DataConfig,
        MeshConfig,
        ModelConfig,
        ParallelConfig,
        PoseOptConfig,
        RenderConfig,
        TrainConfig,
    )

    cfg = Config(
        model=ModelConfig(
            log2_hashmap_size=args.hashmap_size,
            hashgrid_resolution=args.hashgrid_resolution,
            internal_activation=args.internal_activation,
            color_activation=args.color_activation,
            density_activation=args.density_activation,
            beta=args.beta, rfield=args.rfield,
            fused_encoder=not args.no_fused_encoder),
        render=RenderConfig(
            bound=args.bound, contract=args.contract,
            grid_size=args.grid_size, min_near=args.min_near,
            t_thresh=args.T_thresh, density_thresh=args.density_thresh,
            occupancy=args.occupancy, max_steps=args.max_steps,
            samples_per_ray=args.samples_per_ray,
            march_candidates=args.march_candidates,
            coarse_probes=args.coarse_probes,
            march_cdf=args.march_cdf, probe_log=args.probe_log,
            cdf_floor=args.cdf_floor,
            num_steps=tuple(args.num_steps), dt_gamma=args.dt_gamma,
            background=args.background,
            update_extra_interval=args.update_extra_interval,
            max_ray_batch=args.max_ray_batch,
            mark_untrained=args.mark_untrained,
            compute_normals=args.compute_normals),
        train=TrainConfig(
            iters=args.iters, lr=args.lr, anneal_lr=args.anneal_lr,
            num_rays=args.num_rays,
            adaptive_num_rays=args.adaptive_num_rays,
            num_points=args.num_points, fp16=args.fp16,
            lambda_entropy=args.lambda_entropy, lambda_tv=args.lambda_tv,
            lambda_wd=args.lambda_wd,
            lambda_orientation=args.lambda_orientation,
            lambda_proposal=args.lambda_proposal,
            lambda_distort=args.lambda_distort,
            loss_weight=args.loss_weight, save_cnt=args.save_cnt,
            eval_cnt=args.eval_cnt, eval_batch=args.eval_batch,
            seed=args.seed),
        pose_opt=PoseOptConfig(
            mode=args.pose_opt, num_cameras=args.num_cameras,
            start_annealing=args.start_annealing,
            end_annealing=args.end_annealing, c_lr=args.c_lr,
            noise=args.noise, identity=args.identity,
            log_poses=args.log_poses),
        data=DataConfig(
            path=args.path, data_format=args.data_format,
            train_split=args.train_split, downscale=args.downscale,
            scale=args.scale, offset=tuple(args.offset),
            enable_cam_near_far=args.enable_cam_near_far,
            enable_cam_center=args.enable_cam_center,
            preload=args.preload, camera_traj=args.camera_traj,
            image_mode=args.image_mode, expose=args.expose,
            exposure_range=args.exposure_range, clip=args.clip,
            exposure_percentile=args.exposure_percentile,
            mosaiced=args.mosaiced, hdr_merge=args.hdr_merge,
            hdr_tonemap=args.hdr_tonemap, bracketing=args.bracketing,
            masked=args.masked, r_mode=args.r_mode,
            reduce_set=args.reduce_set),
        mesh=MeshConfig(
            mcubes_reso=args.mcubes_reso, env_reso=args.env_reso,
            decimate_target=args.decimate_target,
            visibility_culling=args.mesh_visibility_culling,
            visibility_mask_dilation=args.visibility_mask_dilation,
            clean_min_f=args.clean_min_f, clean_min_d=args.clean_min_d),
        parallel=ParallelConfig(num_devices=args.n_devices,
                                tp_devices=args.tp_devices),
        workspace=args.workspace, ckpt=args.ckpt)

    if args.lightstage:
        cfg = cfg.with_preset_lightstage()
    elif args.O:
        cfg = cfg.with_preset_O()
    elif args.O2:
        cfg = cfg.with_preset_O2()
    if args.tpu_profile:
        cfg = cfg.with_tpu_profile()
    size_over = {k: getattr(args, k) for k in
                 ("num_levels", "level_dim", "grid_mlp_hidden",
                  "view_mlp_hidden", "hash_variant") if getattr(args, k)}
    if size_over:
        cfg = replace(cfg, model=replace(cfg.model, **size_over))
    if args.pose_opt != "none":
        n = args.num_cameras
        if n == -1:
            for sub in ("images", "raw", "image", "train"):
                d = os.path.join(args.path, sub)
                if os.path.exists(d):
                    n = len(os.listdir(d))
                    break
        cfg = cfg.with_pose_opt(args.pose_opt, n)
    return cfg.validate()


def cli_device() -> torch.device:
    """The CLI's device: the card, or the CPU when ``RAW_NGP_PLATFORM`` is
    "cpu" (JAX's CLI reads the same variable, cli.py:313-314). Asking for
    the card where there is none raises (``resolve_device``)."""
    plat = os.environ.get("RAW_NGP_PLATFORM", "").strip().lower()
    if plat == "cpu":
        return resolve_device("cpu")
    if plat in ("", "cuda", "gpu"):
        return resolve_device("cuda")
    raise ValueError(f"RAW_NGP_PLATFORM={plat!r}: expected cpu or cuda")


def rank_count(cfg, device: torch.device) -> int:
    """The number of ranks to start (``trainer.py:519-524``'s rule): on
    the card ``num_devices`` clamped to the GPUs present, every GPU for
    0; on the CPU ``num_devices`` gloo ranks, one for 0."""
    n_req = cfg.parallel.num_devices
    if device.type == "cuda":
        avail = torch.cuda.device_count()
        return avail if n_req == 0 else min(n_req, avail)
    return max(n_req, 1)


def main(argv: Optional[list] = None):
    args = build_parser().parse_args(argv)
    cfg = args_to_config(args)
    device = cli_device()
    n = rank_count(cfg, device)
    if n > 1:
        return launch(argv, cfg, device, n)
    if cfg.parallel.num_devices > 1:   # clamped to one device
        cfg = replace(cfg, parallel=replace(cfg.parallel, num_devices=1))
    return run(args, cfg, device)


def launch(argv, cfg, device: torch.device, n: int) -> int:
    """Start n ranks of :func:`run` (one process each: NCCL and one GPU
    a rank on the card, gloo on the CPU) that meet through a file in the
    workspace, and wait for them; a rank that fails raises here."""
    import sys

    import torch.multiprocessing as mp
    os.makedirs(cfg.workspace, exist_ok=True)
    store = os.path.abspath(os.path.join(cfg.workspace,
                                         f".rendezvous_{os.getpid()}"))
    if os.path.exists(store):
        os.remove(store)
    backend = "nccl" if device.type == "cuda" else "gloo"
    # CPU ranks share the launcher's threads (torch's default of one a
    # core in each rank oversubscribes the cores many times over)
    threads = max(torch.get_num_threads() // n, 1)
    try:
        mp.spawn(_rank, args=(n, list(sys.argv[1:] if argv is None
                                      else argv), backend, store, threads),
                 nprocs=n, join=True)
    finally:
        if os.path.exists(store):
            os.remove(store)
    return 0


def _rank(rank: int, n: int, argv, backend: str, store: str, threads: int):
    """One rank of :func:`launch`: join the process group, take GPU
    ``rank`` on the card (``threads`` CPU threads on the CPU), run the
    CLI's flow."""
    import torch.distributed as dist
    args = build_parser().parse_args(argv)
    cfg = args_to_config(args)
    cfg = replace(cfg, parallel=replace(cfg.parallel, num_devices=n))
    device = cli_device()
    if device.type == "cuda":
        torch.cuda.set_device(rank)
        device = torch.device("cuda", rank)
    else:
        torch.set_num_threads(threads)
    dist.init_process_group(backend, init_method=f"file://{store}",
                            rank=rank, world_size=n)
    try:
        run(args, cfg, device)
    finally:
        dist.destroy_process_group()


def run(args, cfg, device: torch.device) -> int:
    """The CLI's flow on ``device``, as one rank of several where a
    process group is initialized (rank 0 writes)."""
    from raw_ngp_torch.data.providers import load_scene
    from raw_ngp_torch.mesh.extract import export_meshes
    from raw_ngp_torch.train.metrics import PSNRMeter, SSIMMeter
    from raw_ngp_torch.train.trainer import Trainer
    from raw_ngp_torch.utils.logging import RunLogger

    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    import torch.distributed as dist
    main_rank = not dist.is_initialized() or dist.get_rank() == 0
    logger = RunLogger(cfg.workspace, enabled=main_rank)
    logger.log(f"[cli] device {device} ({name}), workspace {cfg.workspace}")
    t0 = time.perf_counter()

    def stage(what):      # the seconds since the last stage ended
        nonlocal t0
        t1 = time.perf_counter()
        logger.log(f"[cli] {what}: {t1 - t0:.3f} s")
        t0 = t1

    train_scene = load_scene(cfg, cfg.data.train_split)
    if args.test:
        trainer = Trainer(cfg, train_scene, device=device)
        stage("scene and trainer")
        if not args.test_no_video:
            test_scene = load_scene(cfg, "test")
            trainer.test(test_scene, write_video=True)
            stage("test frames")
    else:
        val_scene = load_scene(cfg, "val")
        trainer = Trainer(cfg, train_scene, val_scene, device=device)
        stage("scene and trainer")
        trainer.fit()
        stage("fit")
        result = trainer.evaluate(save_artifacts=True,
                                  metrics=[PSNRMeter(), SSIMMeter()],
                                  export_npy=args.eval_export)
        trainer.logger.log(f"[final eval] {result}")
        stage("final eval")
        test_scene = load_scene(cfg, "test")
        trainer.test(test_scene, write_video=not args.test_no_video)
        stage("test frames")
    if not args.test_no_mesh:
        field = trainer.gathered_field()   # every rank, for tp's gather
        if main_rank:
            export_meshes(trainer, os.path.join(cfg.workspace, "mesh"),
                          dataset=train_scene
                          if cfg.mesh.visibility_culling else None,
                          field=field)
        stage("meshes")
    trainer.logger.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
