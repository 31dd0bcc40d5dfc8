"""Typed, immutable configuration for raw_ngp_torch.

A copy of the JAX package's ``raw_ngp_tpu/config.py`` (the port imports
nothing of that package), kept field for field identical so that one set
of settings drives both packages in the parity tests.

The reference threads a mutable ``argparse.Namespace`` through every class and
rewrites it at runtime (reference: main.py:9-127, and §5.6 of SURVEY.md notes
the latent AttributeError traps this causes). Here the static configuration is
a frozen dataclass; runtime-mutable values (adaptive ray counts, exposure
levels, scene metadata) live in explicit state objects
(:class:`raw_ngp_torch.data.scene.SceneMeta`, trainer state).

Preset composition mirrors the reference CLI presets:
  * ``lightstage`` — reference main.py:129-143
  * ``O``          — occupancy-grid ("cuda ray" in the reference) mode,
                     reference main.py:145-151
  * ``O2``         — contracted proposal-network mode, reference main.py:153-158
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field, replace
from typing import List, Optional, Tuple


@dataclass(frozen=True)
class ModelConfig:
    """Field architecture (reference: nerf/network.py:37-72)."""

    # hash grid (reference network.py:47-49, grid.py:103-146)
    num_levels: int = 16
    level_dim: int = 2
    base_resolution: int = 16
    log2_hashmap_size: int = 19
    hashgrid_resolution: int = 2048   # desired_resolution = this * bound
    gridtype: str = "hash"            # "hash" | "tiled"
    # "xor" = reference hash; "additive" = TPU pair-aligned hash making
    # every level 2-row-window gatherable (ops/hashgrid.HashGridSpec)
    hash_variant: str = "xor"
    interpolation: str = "linear"     # "linear" | "smoothstep"
    align_corners: bool = False

    # MLPs (reference network.py:49-56)
    grid_mlp_hidden: int = 64
    grid_mlp_layers: int = 3
    grid_mlp_out: int = 16            # 1 sigma + 15 features
    view_mlp_hidden: int = 64
    view_mlp_layers: int = 3
    sh_degree: int = 4

    # activations (reference main.py:90-92, network.py:112-138)
    internal_activation: str = "relu"       # "relu" | "softplus"
    color_activation: str = "clamped_exp"   # "exp" | "sigmoid" | "clamped_exp"
    density_activation: str = "clamped_exp"  # "softplus" | "clamped_exp"
    beta: float = 2.0                        # softplus beta (main.py:121)

    # reflectance field: condition color on light direction (network.py:55-56)
    rfield: bool = False
    # use the fused sort-backward hash encoder (kernels/hash_fused.py)
    # instead of plain XLA gather + scatter-add autodiff
    fused_encoder: bool = True

    # proposal networks, used only in non-occupancy mode (network.py:59-72)
    prop_num_levels: int = 5
    prop_level_dim: int = 2
    prop_log2_hashmap_size: int = 17
    prop_resolutions: Tuple[int, ...] = (128, 256)
    prop_mlp_hidden: int = 16
    prop_mlp_layers: int = 2


@dataclass(frozen=True)
class RenderConfig:
    """Rendering / sampling options (reference: nerf/renderer.py, main.py)."""

    bound: float = 2.0                # main.py:31
    contract: bool = False            # main.py:45; overrides bound to 2
    grid_size: int = 128              # main.py:50
    min_near: float = 0.05            # main.py:36
    t_thresh: float = 1e-8            # main.py:37
    density_thresh: float = 10.0      # main.py:53
    occupancy: bool = False           # reference `cuda_ray` (main.py:42)
    max_steps: int = 1024             # main.py:43 (occupancy mode)
    # TPU-specific: fixed per-ray sample budget after occupancy compaction.
    # The CUDA reference compacts exactly (raymarching.cu:338-491); on TPU we
    # keep a static [num_rays, K] sample grid instead.
    samples_per_ray: int = 64
    # candidate marching resolution before compaction (multiple of K)
    march_candidates: int = 512
    # two-level march: probes per ray against a 4^3 max-pooled + dilated
    # coarse occupancy grid tighten [near, far] BEFORE fine candidate
    # generation — the static-shape analogue of the reference's DDA
    # empty-space skipping (raymarching.cu:446-460). The same
    # march_candidates then concentrate inside the occupied span (finer
    # effective sampling), or march_candidates can be halved at equal
    # effective resolution. 0 disables. Requires grid_size % 4 == 0.
    coarse_probes: int = 0
    # distribute march candidates over OCCUPIED probe intervals only
    # (inverse-CDF of the per-ray probe hits, render/occupancy.py
    # cdf_candidates) instead of one contiguous tightened span — the
    # closer analogue of DDA skipping; lets march_candidates shrink at
    # equal effective density. Needs coarse_probes > 0. Composes with
    # dt_gamma > 0: occupied intervals are then weighted by the local
    # reference step count (spacing / clamp(t*gamma, dt_min, dt_max)),
    # so candidate density follows the geometric schedule inside the
    # skipping, like raymarching.cu:396-401 + :468-480 compose. CAVEAT
    # (measured, ROADMAP round-4 contract gates): on CONTRACTED scenes
    # prefer march_cdf=False — occupied-only placement skips the void
    # samples that double as free-space supervision there (span+gamma
    # 25.8 held-out vs cdf+gamma 16.1 / cdf-alone 20.7), and at small
    # fixed S the faithful 1/dt allocation additionally starves far
    # content. On bounded scenes the CDF is the flagship (34.4 held-out).
    march_cdf: bool = False
    # geometric (log-uniform / disparity-style) probe intervals instead
    # of uniform-t (render/occupancy._probe_grid). On contracted or
    # unbounded scenes uniform probes put nearly all of coarse_probes in
    # the far field, so near-camera content loses skip resolution; log
    # spacing mirrors the reference's geometrically growing dt_gamma
    # schedule (raymarching.cu:396-401). Composes with both the span
    # tightening and the CDF distribution.
    probe_log: bool = False
    # CDF epsilon floor: unoccupied probe intervals keep this fraction of
    # their occupied-case candidate weight, so intervals whose CENTER
    # probe missed off-center fine-occupied content (fog in
    # under-observed regions) still get sampled and carved — the measured
    # failure mode behind the CDF's 5 dB held-out gap vs the span march
    # on contracted scenes (ROADMAP round-4 contract gates). 0 = pure
    # occupied-only placement (the bounded-scene flagship).
    cdf_floor: float = 0.0
    # cross-ray sample compaction: evaluate the field only on a static
    # buffer of num_rays*K*compact_ratio points (the CSR equivalent of the
    # reference's exact compaction + adaptive_num_rays point budget,
    # train_utils.py:563-564). 0 disables.
    compact_ratio: float = 0.5
    # explicit compacted point budget (static shape). None = derived from
    # num_rays * samples_per_ray * compact_ratio. The Trainer's adaptive
    # machinery re-specializes the train step with a SMALLER budget when
    # the occupancy grid leaves the default one mostly dummy slots — the
    # static-shape counterpart of the reference's exact CSR compaction
    # (raymarching.cu:486-490 allocates exactly-counted buffers per step)
    point_budget: Optional[int] = None
    # fraction of grid cells per refresh half (random / occupancy-biased)
    # in the partial density-grid refresh. The reference resamples
    # H^3/4 + H^3/4 per cascade (renderer.py:853-880) = 0.25; each
    # density query costs ~130 ns of table gathers on TPU so the refresh
    # is a first-order step cost (~15 ms/step amortized at 0.25) —
    # lowering the fraction trades occupancy-grid freshness for step
    # time (EMA decay 0.95 is forgiving; quality-gate any change).
    grid_partial_fraction: float = 0.25
    num_steps: Tuple[int, ...] = (256, 96, 48)  # proposal mode, main.py:44
    dt_gamma: float = 0.0             # main.py:52
    background: str = "black"         # main.py:46: white|random|last_sample|black
    update_extra_interval: int = 16   # main.py:48
    max_ray_batch: int = 4096 * 4     # main.py:49
    mark_untrained: bool = False      # main.py:51
    compute_normals: bool = False     # main.py:117


@dataclass(frozen=True)
class TrainConfig:
    """Optimization schedule (reference: main.py:39-69, 243-266)."""

    iters: int = 20000                # main.py:40
    lr: float = 1e-2                  # main.py:41
    # The reference uses Adam eps=1e-15 (main.py:245, the instant-ngp
    # value chosen for fp16-scaled gradients). With our f32 gradients
    # that eps makes every touched hash-table entry step ~±lr regardless
    # of gradient size (second moments on sparsely-hit rows are ~1e-13),
    # which goes edge-of-stability unstable once the fit is tight:
    # measured loss 3e-4 -> 0.11 IRRECOVERABLE collapse at step ~636 of
    # the flagship bench config, reproduced deterministically on TPU and
    # CPU and independent of the backward implementation. The eps ladder
    # at flagship scale over 5k-step curves (tools/quality_run.py):
    # 1e-15 collapses ~636, 1e-10 collapses ~1300 (and held-out stalls
    # at 17), 1e-8 is stable through 5k AND generalizes ~3 dB better
    # (train 36.3 / held-out 19.6-21.0 — damping the ~zero-gradient
    # tail rows suppresses hash-collision noise on unseen views). The
    # tiny-config result that 1e-8 costs 1 dB does NOT transfer to
    # flagship scale. Round-3 follow-up: 1e-8's stability is MARGINAL —
    # bit-level reassociation changes (a different sort chunking, a
    # reassociated composite) flip nearby configs (96-candidate march,
    # the compacted composite) into the same irrecoverable collapse.
    # The 1500-step flagship ladder (tools/quality_run.py, EMA eval):
    # 1e-8/lr 1e-2 = COLLAPSE (4.5 / -8.6 dB), 1e-8/lr 5e-3 = 31.9/29.7,
    # **1e-7/lr 1e-2 = 36.2/34.8** — 1e-7 both stabilizes robustly and
    # generalizes best, consistent with tail-row damping suppressing
    # hash-collision noise. See ROADMAP.md "Stability".
    adam_eps: float = 1e-7
    anneal_lr: bool = False           # main.py:120 (cosine restarts)
    num_rays: int = 4096              # main.py:59
    # TPU reformulation of the reference's adaptive ray batching
    # (main.py:60, train_utils.py:563-564): the reference re-sizes every
    # batch so num_rays * mean_samples_per_ray ~= num_points; XLA needs
    # static shapes, so the Trainer instead GROWS num_rays by powers of
    # two (up to max_num_rays, 0 = 4 * num_rays) whenever the measured
    # live-sample count falls under half the compacted point budget —
    # one extra compile per size, steady-state throughput scales with
    # the occupancy-grid pruning exactly like the reference's scheme.
    adaptive_num_rays: bool = False   # main.py:60
    max_num_rays: int = 0
    num_points: int = 2 ** 18         # main.py:61
    ema_decay: float = 0.95           # main.py:264
    fp16: bool = False                # AMP in the reference; bf16 compute here
    random_image_batch: bool = False  # preset-only flag in the reference
    # regularizers (main.py:63-69)
    lambda_entropy: float = 0.0
    lambda_tv: float = 0.0
    lambda_wd: float = 0.0
    lambda_orientation: float = 0.0
    lambda_proposal: float = 1.0
    lambda_distort: float = 0.0
    loss_weight: str = "none"         # gaussian|planck|hanning|none (main.py:118)
    # eval/checkpoint cadence (main.py:19-20)
    save_cnt: int = 50
    eval_cnt: int = 10
    eval_batch: int = 1               # main.py:123
    max_keep_ckpt: int = 2            # train_utils.py:347
    seed: int = 0
    diffuse_step: int = 0
    # train steps a dispatch chains (Trainer.train): on one card a chain
    # is that many replays of a CUDA graph of the step, with no host work
    # between them (raw_ngp_torch/train/dispatch.py), cut at the grid
    # refreshes. 0 = auto (the grid-refresh interval in occupancy mode,
    # 16 otherwise); 1 = every step eager.
    steps_per_dispatch: int = 0


@dataclass(frozen=True)
class PoseOptConfig:
    """BARF-style camera refinement (reference: main.py:105-113,
    barf/camera_optimizers.py)."""

    mode: str = "none"                # "barf" | "baangp" | "none"
    num_cameras: int = -1
    start_annealing: float = 0.0
    end_annealing: float = 0.33
    c_lr: float = 1e-3
    noise: float = 0.0                # synthetic perturbation for self-test
    identity: bool = False
    log_poses: bool = False


@dataclass(frozen=True)
class DataConfig:
    """Dataset options (reference: main.py:26-37, 85-103)."""

    path: str = ""
    data_format: str = "colmap"       # colmap | nerf | dtu | synthetic
    train_split: str = "train"        # train | trainval | all
    downscale: int = 1
    scale: float = -1.0               # -1 = auto from poses (main.py:32)
    offset: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    enable_cam_near_far: bool = False
    enable_cam_center: bool = False
    preload: bool = True
    camera_traj: str = "interp"       # interp | circle
    # RAW / HDR options (main.py:85-96)
    image_mode: str = "LDR"           # LDR | HDR
    expose: bool = False
    exposure_range: str = "minimal"   # minimal | wide
    clip: bool = False
    exposure_percentile: float = 99.0
    mosaiced: bool = False
    hdr_merge: str = "none"           # robertson | debevec | none
    hdr_tonemap: str = "reinhard"     # reinhard | mantiuk | drago
    # lightstage options (main.py:98-103)
    bracketing: bool = False
    masked: bool = False
    r_mode: str = "none"              # all | downsample3 | downsample6 | replace
    reduce_set: bool = False


@dataclass(frozen=True)
class MeshConfig:
    """Mesh extraction (reference: main.py:71-78)."""

    mcubes_reso: int = 512
    env_reso: int = 256
    decimate_target: int = 300000
    visibility_culling: bool = False
    visibility_mask_dilation: int = 5
    clean_min_f: int = 8
    clean_min_d: int = 5


@dataclass(frozen=True)
class ParallelConfig:
    """Device mesh layout. The reference's latent DDP scaffolding
    (train_utils.py:384-386) becomes a first-class ray-batch data-parallel
    axis over an ICI mesh here."""

    num_devices: int = 0              # 0 = all local devices
    mesh_axis: str = "dp"
    shard_rays: bool = True
    # tensor parallelism over the hash table's channel axis: num_devices
    # (or all local devices) split as a (dp, tp) 2-D mesh with
    # dp = total // tp_devices. tp shards the [n_params, C] table on C
    # (each device owns C/tp channels of every row; one feature
    # all_gather per encode) — for tables too large to replicate.
    # Requires model.level_dim % tp_devices == 0 and occupancy mode.
    tp_devices: int = 1


@dataclass(frozen=True)
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    render: RenderConfig = field(default_factory=RenderConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    pose_opt: PoseOptConfig = field(default_factory=PoseOptConfig)
    data: DataConfig = field(default_factory=DataConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    parallel: ParallelConfig = field(default_factory=ParallelConfig)
    workspace: str = "workspace"
    ckpt: str = "latest"              # scratch | latest | latest_model | best | path

    # -------- derived quantities --------
    @property
    def grid_bound(self) -> float:
        """Bound used for grid queries; contraction forces 2
        (reference renderer.py:171-174)."""
        return 2.0 if self.render.contract else self.render.bound

    @property
    def cascades(self) -> int:
        """Number of multi-scale occupancy cascades
        (reference renderer.py:176)."""
        return 1 + math.ceil(math.log2(max(self.grid_bound, 1.0)))

    @property
    def desired_resolution(self) -> float:
        """Finest hash-grid resolution (reference network.py:48)."""
        return self.model.hashgrid_resolution * self.grid_bound

    @property
    def exposure_percentiles(self) -> Tuple[float, ...]:
        """Percentile set for HDR exposure estimation
        (reference main.py:203-210)."""
        if self.data.exposure_range == "wide" or self.data.bracketing:
            return (70.0, 80.0, 90.0, 97.0, 99.0, 99.9, 100.0)
        return (97.0, 99.0, 99.9, 100.0)

    @property
    def hdr_merge_algo(self) -> str:
        """Bracketing defaults to robertson merge (reference main.py:207-208)."""
        if (self.data.exposure_range == "wide" or self.data.bracketing) and \
                self.data.hdr_merge == "none":
            return "robertson"
        return self.data.hdr_merge

    # -------- preset composition (reference main.py:129-188) --------
    def with_preset_O(self) -> "Config":
        """Occupancy-grid NGP mode (reference main.py:145-151)."""
        return replace(
            self,
            render=replace(self.render, occupancy=True, mark_untrained=True),
            train=replace(self.train, fp16=True, adaptive_num_rays=True,
                          random_image_batch=True),
            data=replace(self.data, preload=True),
        )

    def with_preset_O2(self) -> "Config":
        """Contracted proposal-network mode (reference main.py:153-158)."""
        return replace(
            self,
            render=replace(self.render, contract=True, occupancy=False,
                           mark_untrained=False),
            train=replace(self.train, fp16=True, adaptive_num_rays=True,
                          random_image_batch=True),
            data=replace(self.data, preload=True),
        )

    def with_preset_lightstage(self) -> "Config":
        """Light-stage HDR capture preset (reference main.py:129-143)."""
        cfg = self.with_preset_O()
        return replace(
            cfg,
            render=replace(cfg.render, bound=2.0),
            model=replace(cfg.model, color_activation="clamped_exp"),
            data=replace(cfg.data, scale=2.0, masked=True, clip=True,
                         image_mode="HDR", data_format="colmap",
                         camera_traj="circle", preload=True),
        )

    def with_tpu_profile(self) -> "Config":
        """TPU-optimized hash-grid shape: 2 levels x 16 channels instead of
        the reference's 16 x 2 (same parameter count, same 32-wide MLP
        input). XLA:TPU gather cost is per-SLICE and flat in slice width
        up to a vrow, so each level-halving at constant L*C halves the
        dominant encode-gather and table-gradient sort-record volume. The
        additive hash variant makes every level 2-row-window gatherable
        (kernels/hash_fused.py), halving gather and sort volume again on
        the hashed levels. Grid-shape ladder, 5k-step curves on v5e
        (tools/quality_run.py, train-view / held-out dB):
        8x4 = 36.3 / 19.6 @ 43.6k rays/s; 4x8 = 44.5 / 26.4 @ 90.8k;
        **2x16 = 35.4 / 33.6 @ 132.6k** on the flat bench scene, and on
        the high-frequency textured scene 2x16 = 31.5 / 30.0 vs 4x8's
        38.3 / 23.6 — every halving of the level ladder at constant
        params trades train-view overfit for held-out generalization
        AND speed. Held-out PSNR is the product metric (reference
        debug/eval.py protocol), so 2x16 ships.

        March shape: S == K == 64 candidates distributed over OCCUPIED
        probe intervals only (march_cdf inverse-CDF placement,
        render/occupancy.cdf_candidates). S == K means every candidate
        IS a sample slot, so the march's [N, K+1] compaction scatter
        disappears entirely (march_rays fast path). Round-3c ladder
        under the stable eps-1e-7 optimizer (tools/perf_sweep.py, 480
        steps, EMA eval, train-view / held-out): 128:32 CDF K64 =
        33.09 / 29.12 @ ~54.6 ms; 96:96 CDF K96 r1/3 = 31.28 / 30.89 @
        48.7 ms; **64:32 CDF K64 = 32.32 / 32.84 @ ~46 ms** — the
        fewer-but-denser candidates LEAD held-out (the product metric)
        while being fastest. 5k-step curves match: 64:32 = 37.9 train /
        34.9-35.4 held-out vs 128:32's 37.6 / 35.5 (earlier round-3b
        sweeps that showed a held-out penalty for 64:32 were measuring
        the eps-1e-8 instability, not the sampling).

        Probes: 16 (round-4 sweep at the settled 16384-ray batch,
        honest trainer-meter timing): 64:16 = 386.9k rays/s @ 42.3 ms,
        PSNR 35.35 / 34.38 vs 64:32's 367.3k @ 44.6, 35.31 / 34.39 —
        half the probe gathers, identical quality."""
        return replace(
            self,
            model=replace(self.model, num_levels=2, level_dim=16,
                          hash_variant="additive"),
            render=replace(self.render, march_candidates=64,
                           coarse_probes=16, march_cdf=True))

    def with_pose_opt(self, mode: str, num_cameras: int) -> "Config":
        """Pose refinement rewires batching (reference main.py:160-172)."""
        return replace(
            self,
            pose_opt=replace(self.pose_opt, mode=mode, num_cameras=num_cameras),
            train=replace(self.train, random_image_batch=False),
            data=replace(self.data, train_split="trainval"),
        )

    def validate(self) -> "Config":
        if (self.render.contract and self.render.march_cdf
                and self.render.cdf_floor <= 0.0):
            # measured-bad composition (ROADMAP round-4 contract gates):
            # pure occupied-only CDF placement loses the void samples
            # that carve fog in center-missed intervals on contracted
            # scenes (span+gamma 25.8 dB held-out vs cdf+gamma 16.1).
            # cdf_floor > 0 is the mitigation (round-5 contract gates);
            # without it, auto-fall back to the span march rather than
            # let a preset select the known-bad pairing silently.
            import warnings
            warnings.warn(
                "march_cdf=True with render.contract=True and no "
                "cdf_floor is a measured quality regression (see "
                "config.march_cdf docstring); falling back to the span "
                "march (march_cdf=False).",
                stacklevel=2)
            self = replace(self, render=replace(self.render,
                                                march_cdf=False))
        r = self.render
        assert r.samples_per_ray > 0 and r.march_candidates >= r.samples_per_ray
        assert r.coarse_probes == 0 or r.grid_size % 4 == 0
        assert 0.0 <= r.cdf_floor < 1.0
        assert self.model.gridtype in ("hash", "tiled")
        assert self.model.interpolation in ("linear", "smoothstep")
        assert self.model.color_activation in ("exp", "sigmoid", "clamped_exp")
        assert self.model.density_activation in ("softplus", "clamped_exp")
        assert r.background in ("white", "random", "last_sample", "black")
        assert self.pose_opt.mode in ("barf", "baangp", "none")
        if self.render.contract:
            assert not self.render.mark_untrained, \
                "mark_untrained is incorrect under contraction (main.py:174-176)"
        tp = self.parallel.tp_devices
        assert tp >= 1
        if tp > 1:
            assert self.model.level_dim % tp == 0, \
                "tp_devices must divide model.level_dim (channel sharding)"
            assert self.render.occupancy, \
                "tensor parallelism requires occupancy mode (no prop grids)"
            assert self.train.lambda_tv == 0 and self.train.lambda_wd == 0, \
                "grid regularizers are not tp-aware yet (per-shard loss " \
                "terms would break the identical-loss invariant)"
        return self


def default_config() -> Config:
    return Config()
