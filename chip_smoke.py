#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (raw_ngp_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--b2-parent TREE]
    python3 chip_smoke.py --against TREE [TREE ...]
    python3 chip_smoke.py --deterministic-ops

Phases, each of which fails the run (non-zero exit, no result line):
  1. build  — compile every kernel of the path from raw_ngp_torch/csrc/
              (five sources) with nvcc for sm_90a (one nvcc per source, in
              parallel), print each kernel's registers, stack frame and
              spills (ptxas), and fail if an instantiation of the encode
              forward (with and without records), input gradient or its
              JVP, of
              B2's flat form (main pass, fix-up, join), of the fold
              (phase 2) or of the radix sort (histogram, digit pass)
              spills or keeps a stack frame;
  2. decimate — the render's budget decimation and compaction folded
              (decimate_compact: three launches forward, one backward;
              B1 and its backward redesigned) against its plain version
              (decimate_compact_plain and its autograd), bit for bit,
              forward and the gradients in ts, deltas and dt, two calls
              bitwise equal, and with positions=True (the expand path's
              slot positions) pos bit for bit the plain version's and the
              other outputs unchanged, at the train shape (8,192 rays x 64, m_pad
              262,144) at stride 1 and 2, full and empty, and a 16,384-ray
              chunk at stride 1 and 3; timed at stride 1 (device time,
              launches a call and time by kernel) beside the plain
              version, nonzero (+ nonzero_static) + index_select and
              zero_ + index_copy_, with the wrapper's host time a call by
              parts;
  3. encode — the hash-encode kernel against its plain version on the
              flagship grid (2 levels x 16 channels, additive hash) at the
              inputs the path gives it: 262,144 uniform points (some
              outside [0, 1]^3 or NaN), 262,144 ray-ordered points (the
              train forward's) and one 65,536-point grid refresh chunk
              (Morton-ordered jittered cell centres): f32 within atol 1e-6
              of hash_encode_01, bf16 bit-exact with
              hash_encode_fused_plain (the JAX fused encoder's rounding
              chain), each timed beside its own bound;
  4. slice  — the flagship configuration (Config().with_preset_O()
              .with_tpu_profile(), fp16, num_rays 8192) at full width with
              a seeded random field and a bitfield occupying the bench
              scene's spheres: render_image of the val view at 128x128
              (one 16,384-ray chunk) and 512x512 (16 chunks), with every
              launch counter reset just before and read just after; the
              images must be finite and one chunk must agree with the same
              render on the plain path on the card;
  5. segsum — kernel B2's outer mode at the flagship's level-1 shape
              (1,048,576 records of 262,144 points into 524,288 rows, 16
              channels, read in place from level 1's columns of a bf16
              cotangent [B, 32]) in both forms: the [n_rows, 2C] totals
              (off the training path) and the flat form the table gradient
              calls (G0[r] + G1[r - 1] written into the flat rows), each
              against its plain version (on the packed words), random keys within rtol 1e-5 and a
              dense-skew stream within rtol 1e-5 plus 2^-20 of each row's
              absolute sum (within_sum_error); the flat form bit for bit
              the totals plus combine_totals_plain (one f32 add a row);
              two calls bitwise equal on each; both streams timed, split
              by stage; the plain versions and zero_ + index_add_ timed
              beside them; then the flat form at the narrow widths the
              walk of several chunks a warp takes (NARROW_STREAMS: C = 2
              at -O2's finest field level, the tp shards' C = 1 and C =
              8), random and skew: bit for bit the 2C totals (the one-
              chunk-a-warp walk) plus combine_totals_plain, two calls the
              same bits, its plain version's values, device time by stage
              beside the bound and zero_ + index_add_ (with --b2-parent
              TREE beside that tree's kernel too, here and over a
              proposal and an O step's own B2 calls);
  6. encode_bwd — the encode forward's records mode (the window records
              written by the forward's launch) at uniform and ray-ordered
              points, f32 and bf16: records bit for bit
              window_records_plain, output bit for bit the forward
              without records, two calls the same bits, timed with and
              without records; the encode's table gradient (dense-level
              kernels: cell keys, the radix sort by cell, cell sums, edge
              fix-up, gather; the radix sort and B2's flat form reading g
              in place) on the kernel path against the plain path at B =
              262,144, uniform and ray-ordered points, f32 and bf16: the
              window rows within rtol 1e-5 of the largest entry, the dense
              rows by dense_rows_agree (rtol 1e-5 plus 2^-20 of the
              entry's absolute mass before rounding); then the table
              gradient and the dense level alone (two calls bitwise equal;
              its device time split into the keys, the sort and the
              passes; the sort alone on CUDA events; zero_ + index_add_ of
              its exact products as the library yardstick) timed;
  6b. sort — the table gradient's radix sort (sort_keys, csrc/
              radix_sort.cu: a cooperative histogram kernel, then one
              onesweep pass a digit of at most 10 bits) on its edge cases
              at the card's sizes (1 key, around the 8,192-key tile, 4 Mi
              keys; uniform, one value, descending, runs; 1, 13, 19 and 31
              bits): bit for bit torch.sort(keys - offset, stable=True)
              with int32 indices and its plain version, two calls alike,
              none out of range; keys outside the range counted; an empty
              stream launches nothing. The training phases hold it on
              their own step's streams (sort_stream_checks: the flagship's
              dense and window level in phase 7, the -O2 step's 26 in
              phase 12, -O's 16 in phase 13), each timed (CUDA events,
              profiler device time and launches a call, at most 3 for 20
              bits or fewer) beside its byte bound (12 B a record), its
              plain version and its library yardstick (the subtraction,
              torch.sort(stable=True) and .to(torch.int32)); every
              training phase's sorts launch once a B2 call and once a
              dense level (check_sort_launches);
  7. train  — the flagship Trainer on make_synthetic_scene(36, 2, 128,
              128) for 128 steps (8 grid refreshes) with every launch
              counter reset just before and read just after: all five
              kernels launched (the forward with records, the dense-level
              kernel and B2's flat form once a step; the 2C totals
              never), finite
              losses that fall (last 8 below the first 8), finite params
              and EMA, the val PSNR (EMA), one step on a fixed batch
              that agrees between the kernel path and the plain path, and
              the repro check: the Trainer's state from before step 1
              restored and 32 steps (two grid refreshes) run again
              through Trainer.train's chains of CUDA-graph replays,
              params, EMA, Adam moments, poses, grid, bitfield and
              generator state bitwise equal to the eager run's, a second
              graphed run bitwise the first; then the line's `dispatch`:
              graphed beside eager ms a step, the captures, peak memory,
              one profiled chain's busy and idle share and its
              hand-written kernels' device launches a step (equal to an
              eager step's, profiler events by kernel name), and the
              synchronizing calls of one eager step (none);
  7b. disk — the flagship trained from a COLMAP scene on disk: the train
              phase's scene (its 38 views) written with the port's writers
              (cameras.bin, images.bin, points3D.bin with each view's
              sparse surface points, 8-bit PNGs; write_colmap_scene),
              loaded by raw_ngp_torch.data.load_scene ("train" 33 views,
              "val" 5) with enable_cam_near_far and data.scale 1.0, the
              load timed by stage (COLMAP parse, PNG decode, near/far), the
              images bit for bit round(255 img) / 255; the untrained val
              PSNR (EMA); 128 steps with every launch counter reset just
              before and read just after: the fold, the encode with and
              without records, B2's flat form and the dense level
              launched as many times as in phase 7; finite falling
              losses, the val PSNR above the untrained field's; on a fixed
              batch every live sample's t within its camera's [near, far]
              (march jitter 0.5 and drawn); the fixed batch on the kernel
              and the plain path; one 512x512 render of a val view; the
              step's stages and profile; the repro check of phase 7;
  7c. jpeg — the flagship trained from a COLMAP scene of JPEGs: phase
              7b's 38 views written as `.jpg` files at quality 95
              (write_colmap_scene, image_format "jpg"; cv2.imwrite's bytes
              from the port's encoder), every file decoded by the C++ and
              the Python entropy decode bit for bit alike, the views' PSNR
              against the 8-bit views, the load timed by stage (COLMAP
              parse, JPEG decode, near/far) and its images bit for bit the
              decodes / 255, the JPEG library built here (no quiet
              fallback); 128 steps with every launch counter reset just
              before and read just after, the train phase's launches, the
              val PSNR above the untrained field's and the repro check;
              downscale --factor 2 and 3 on the folder (JPEG out) and
              loads at downscale 2 and 3 (the tool's 42 x 42 files
              enlarged to 43 x 43 by the area resize); the encode and the
              baseline and progressive decodes of one 4032 x 3024 image
              drawn from --seed, by route, in seconds a megapixel;
  8. encode_input — the encode's input gradient against its plain version
              at 262,144 uniform and ray-ordered points on the flagship
              grid, f32 and bf16, within rtol 1e-5 of the largest entry,
              0 outside [0, 1]^3, two calls bitwise equal; each timed;
  9. segsum_channel — B2's channel mode against segment_totals_plain at
              the level-1 shape (1,048,576 records into 524,288 rows, 32
              channels), random keys within rtol 1e-5 and a dense-skew
              stream within the bound of phase 5;
 10. pose   — pose refinement: the flagship with with_pose_opt("barf", 36),
              pose_opt.noise 0.05 and train.iters = 128 (so the annealing
              ramp and the pose freeze at int(0.33 * 128) fall inside)
              trained 128 steps by its Trainer, every launch counter reset
              just before and read just after: all seven kernels of the
              path launched (the fold forward and backward, encode, the
              forward with records, B2's flat form and the dense-level
              gradient once a step, encode input gradient), finite losses
              that
              fall, finite params, EMA and pose params, nonzero pose
              params, the Procrustes pose errors before and after (printed, not
              gated), one fixed-batch step whose loss, net gradients and
              pose gradient agree between the kernel and the plain path,
              and the repro check of phase 7 (pose params and moments
              included);
 11. lightstage — the light-stage path (HDR training with the RawNeRF
              loss, exposures and the Bayer loss mask, HDR evaluation,
              rfield light conditioning): the flagship with image_mode
              HDR, color_activation clamped_exp and rfield on
              make_synthetic_scene(36, 2, 128, 128, hdr=True,
              rfield=True), 128 steps by its Trainer with every launch
              counter reset just before and read just after: the fold
              forward, the forward with records, B2's flat form and the
              dense-level gradient once a step, the refresh and eval
              encode forwards launched, B2's 2C totals, the fold's
              backward and the input gradient never; finite losses that
              fall, finite params and EMA, the HDR val PSNR (min(1, rgb *
              exposure) against min(1, gt)), the exposure levels (finite,
              monotone), one fixed batch with exposure, light direction
              and Bayer lossmult on the kernel and the plain path, a val
              view at 128x128 under its own and the mirrored light (the
              images must differ), the 512x512 render with a light
              direction, the step's stages and profile, and the repro
              check of phase 7;
 12. proposal — the -O2 preset (Config().with_preset_O2(): contraction,
              bf16, 4,096 rays, num_steps (256, 96, 48); the radiance
              field's 16 x 2 xor grid and two proposal grids of 5 x 2) on
              make_synthetic_scene(36, 2, 128, 128): the val PSNR (EMA) of
              the untrained field; the forward with records and the table
              gradient (the radix sort and B2's flat form; no dense level
              on these grids) against their plain versions on each of the
              three grids at the points a train step gives it (the
              forward and records bit for bit, the gradient within rtol
              1e-5), each timed beside its bound and zero_ + index_add_
              of the window levels' rounded products; 128 Trainer steps
              with every launch counter reset just before and read just
              after: the forward with records 3 a step, B2's flat form 26
              a step (16 + 5 + 5 window levels), the forward without
              records, the dense level, the fold, its backward, the input
              gradient and the 2C totals never; finite losses that fall,
              finite params and EMA, the val PSNR (EMA) above the
              untrained field's, 3 encodes an evaluation chunk, one fixed
              batch on the kernel and the plain path, the 512x512 render
              (timed; one chunk's encodes counted and profiled), the
              step's stages and profile, and the repro check of phase 7;
 13. O      — the reference -O configuration (Config().with_preset_O()
              .validate(): the 16 x 2 xor grid, bf16, 4,096 rays with
              adaptive batching, the span march of 512 candidates packed
              into 64 slots, no probes, compact_ratio 0.5, mark_untrained)
              on make_synthetic_scene(36, 2, 128, 128): the val PSNR (EMA)
              untrained; 128 Trainer steps with every launch counter reset
              just before and read just after: the fold and the forward
              with records once a step, B2's flat form once a window level
              (16 a step), the refresh encodes, the dense level, the fold's
              backward, the input gradient and the 2C totals never; finite
              falling losses; the PSNR (EMA) of two train views above the
              untrained field's, the val PSNR (EMA) before and after
              (reported: it stays near the untrained field's on this
              scene, in the JAX package too); one fixed batch on the
              kernel and the plain path;
              the 512x512 render of the EMA field with compute_normals
              (the expand path: the fold's pos, the input-gradient kernel)
              against the same render with plain=True, the normal map
              finite and in [0, 1], timed, one chunk's launches counted and
              profiled; five 16,384-ray branch chunks with normals, kernels
              against plain (span + uniform probes, span + log probes, the
              CDF with dt_gamma 1/128 and cdf_floor 0.05, contraction,
              compact_ratio 0); the step's stages and profile, the
              repro check of phase 7, the adaptive-batch key forced to
              change (forced_key: the graphed steps bitwise the eager
              ones at the new key) and a sweep across keys (key_sweep:
              one graph held at the end, the memory after each chain);
 13b. exr  — the light-stage preset trained from EXR captures on disk,
              read without imageio or cv2: Config().with_preset_lightstage()
              with rfield (capture_config) on a capture folder
              (write_capture_folder): the COLMAP model of 9 views x 4
              LEDs (make_rfield_grid_scene), raw/img_VVV_lL.exr each an
              RGGB mosaic at 256x256 as one HALF channel in the codecs of
              CAPTURE_EXR_CODECS round robin, DWAA and DWAB among them
              (write_exr, OpenEXR's layout), mask/img_VVV.png and
              led_positions.txt; loaded by load_scene at 128x128 (the
              float area resize), the load timed by stage (COLMAP parse,
              EXR decode, the rest of load_hdr_image, near/far), every
              decode bit for bit the written halves as float32 (DWA
              captures inside the tests' tolerance of the writer's float64
              decode, both routes bit for bit), the light directions the
              scene's; 128 steps with every launch counter
              reset just before and read just after: the fold, the forward
              with records and B2's flat form launched as in the O phase
              (128, 128, 2,048; the dense level never); finite falling
              losses, the HDR val PSNR (EMA) above the untrained field's,
              the repro check; the EXR decode of one 4032 x 3024 frame
              from --seed in seconds a megapixel, in each codec, DWAA and
              PIZ by route on a crop, and of an RGB frame as DWAA and as
              Y / RY / BY (capture_host_timings);
 13c. dng  — the same preset without rfield and with clip off (black and
              white from each capture's .json sidecar) on the same
              captures at 0.3 of their brightness (DNG_BRIGHTNESS: a raw
              camera's headroom; at full brightness the preset without
              rfield freezes, port_tools/lightstage_freeze_probe.py) as
              DNG files (write_dng: an 8-bit thumbnail in IFD0,
              the 14-bit counts in a SubIFD, lossless JPEG tiles of 256 x
              256 for half the captures, uncompressed for the rest), read
              without rawpy: the checks of 13b with the decodes bit for bit
              the counts (its Trainer reuses 13b's mark_untrained grid:
              the same cameras); the lossless JPEG decode of one 4032 x
              3024 frame by route (C++; C++ and Python on a 1,024 x 1,024
              crop, bit for bit alike);
 14. encode_jvp — the encode's input gradient differentiated in its
              cotangent g (encode_input_jvp, the orientation loss's
              second-order term) on the -O grid (16 x 2, xor), its C = 1
              shard under tp = 2 and the flagship's (2 x 16, one dense
              matmul level) at 262,144
              uniform and ray-ordered points, f32 and bf16: bit for bit
              its plain version, two calls bitwise equal, timed beside
              its bound (with the ratio) and its plain version;
 15. reg    — the -O configuration with the four regularizers
              (reg_config: lambda_orientation 0.1, lambda_wd 0.1,
              lambda_entropy 1e-4, lambda_tv 1e-6) on the O phase's scene
              and seed, 128 Trainer steps with every launch counter reset
              just before and read just after: the fold (with slot
              positions, the expand path) once a step, the forward with
              records twice (the compacted field and the N K orientation
              points), the input gradient and its JVP once, B2's flat
              form twice a window level (32 a step); the dense level, the
              fold's backward and the 2C totals never; each term's value
              at the first and the last step; finite falling losses; the
              PSNR of two train views (reported); a fixed batch on the
              kernel and the plain path, the whole loss and the
              orientation term alone; the step's stages and profile; the
              repro check of phase 7;
 16. unfused — reg_config on the unfused encoder (plain encodes, autograd
              gradients, the full second order) for 32 steps: the fold
              once a step and no other kernel, finite falling losses, a
              fixed batch on the kernel and the plain path, its ms a step
              beside the reg phase's, a profile and the repro check;
 17. pose_recovery — JAX's pose-recovery test (tests/test_pose_opt.py,
              marked slow there): the proposal path on the unfused
              encoder with BARF and pose noise 0.05 for 400 steps on
              make_synthetic_scene(36, 2, 48, 48), at seeds 0-3, a
              process a seed, all four sharing the card while the cli
              phase runs (both host-bound; its seconds are the wait
              after the cli phase); every
              run's refinements move, and the rotation error falls below
              0.92 of its start in the mean over the seeds (the
              translation errors are reported: at 400 steps they fall in
              about 2 of 3 of JAX's own runs). The train, pose,
              lightstage, O, reg and unfused phases share one
              mark_untrained grid (cached_mark_untrained; the same
              cameras and grid), the cli phase's two Trainers another;
 18. cli    — the port's entry point end to end (phase_cli):
              raw_ngp_torch.cli.main in process on the flagship's argv
              (-O --tpu_profile --fp16 --num_rays 8192, --iters 128,
              --save_cnt 2, --eval_cnt 2) and the CLI's own synthetic
              scene (24 train and 4 val views of 64x64), in a temporary
              workspace, with every launch counter reset just before and
              read just after: the fold, B2's flat form, the dense level
              and the encode with and without records launched; the
              seconds of its stages (Trainer build, fit, final eval, test
              frames, the density sweeps, marching tetrahedra); the final
              eval's PSNR and SSIM; the checkpoints (two ngp_step and
              ngp_best), validation PNGs, result frames and mesh_0.ply
              with faces; the step-128 checkpoint bit for bit the state of
              an in-process Trainer that took train(128) unbroken; and,
              overlapping that run, `python -m raw_ngp_torch.cli ...
              --test --ckpt latest` as a subprocess: exit 0, restored at
              step 128, the frames and the inner mesh written again;
 19. multi  — multi-GPU training (raw_ngp_torch.parallel) on the one card:
              the flagship on two gloo ranks sharing cuda:0 (two processes,
              the train phase's mark_untrained grid handed to them). (a)
              dp = 2: the field after training run in f32 with
              compact_ratio 0, each rank's gradient of its half of a fixed
              8,192-ray batch averaged (the step's reduction) against
              rank 0's gradient of the whole batch, rtol 2e-5, atol 2e-6
              of each leaf's largest entry plus 1e-6; 64 Trainer steps
              with every launch counter reset just before and read just
              after on each rank (run_steps' checks), every training
              tensor bitwise equal across the ranks, and the 64 steps run
              again from the state before step 1, bitwise (repro). (b)
              (dp = 1, tp = 2): the C = 8 shards' gathered features (f32,
              bf16) and the bf16 table gradient of each rank's channels
              bit for bit the C = 16 kernel's on the whole table; 64
              steps as in (a), the replicated tensors bitwise equal
              across the ranks, repro; rank 0's checkpoint loaded into a
              single-device Trainer renders the first val view against
              the tp eval render (bitwise or its difference). (c) a
              one-rank NCCL world in this process: 8 flagship steps
              through make_parallel_train_step bitwise the single-device
              steps. (d) the orientation loss under (dp = 1, tp = 2) at
              the reference -O width (orient_config: reg_config() with
              JAX's tp guard, lambda_tv and lambda_wd 0; 16 levels x 2
              channels, so C = 1 a shard): 32 steps with the regularised
              step's launches a step (the fold, two forwards with
              records, the input gradient and its JVP at C = 1, B2 twice
              a window level), the orientation term finite and nonzero at
              the first and last step and the same on both ranks, the
              replicated tensors bitwise across the ranks, repro; then a
              fixed 4,096-ray batch's gradient against the single
              device's (a field with the gathered table), the loss within
              rtol 1e-3 and each leaf within 2e-2 of its largest entry.
              Then the encode's kernels at the shards' widths (the
              flagship's C = 8 and the -O grid's C = 1: forward with and
              without records, input gradient, its JVP, the dense level
              where the grid has one, B2's flat form) against their plain
              versions, timed beside their bounds. Each rank's step time
              is printed as that of 2 ranks sharing one H100 (gloo): not a
              scaling figure;
 20. hdr    — HDR-merged test frames: the light-stage configuration with
              exposure_range "wide" (hdr_config: 7 percentiles, Robertson
              by default) on the light-stage scene, 128 Trainer steps with
              every launch counter reset just before and read just after
              (the train path's kernels), then Trainer.test of the val
              views under each merge (robertson, debevec) x tonemap
              (reinhard, mantiuk, drago): hdr_000.png and hdr_001.png
              written, each bit for bit the uint8 postprocess_raw_hdr
              (raw_ngp_torch/postprocess/hdr.py, cv2's algorithms in
              numpy) of the same render on the host, 7 exposures or fewer,
              Debevec's response non-decreasing; the NaN count of each
              pair and the host seconds of each calibration, merge and
              tonemap for one 128x128 frame and one 512x512 render;
 21. host   — the native host library (raw_ngp_torch.native, csrc/
              host_native.cpp built with g++): available() true, each of
              its six functions against its numpy form on a 2048x2048
              mosaic or 2^21 codes (Morton codes and packbits bit for bit,
              the demosaic, normalize_levels and the sRGB curve within
              tests/test_torch_native.py's tolerances), both routes timed;
 22. tools  — the port's offline tools on this machine: offline_eval on
              the hdr phase's evaluation dumps (plain, --raw, --raw
              --hdr_merge robertson; finite PSNR and SSIM), colmap2nerf
              and downscale --factor 2 on a COLMAP folder written by
              write_colmap_scene, quality_run --iters 256 --eval_every 128
              on the card with every launch counter reset just before and
              read just after, summarize_quality on its JSON;
 23. timing — each kernel, its plain version and a PyTorch yardstick where
              one exists (torch.nonzero + index_select for the
              compaction, index_copy_ for its backward, index_add_ for the
              dense-level gradient and for B2's two modes) with CUDA
              events and device times; the 512x512 render in ms
              per chunk and rays/s (median of 7 images, each time listed);
              the train and pose steps in ms and rays/s (median of the
              last 32 steps, CUDA events, each listed) with their stages;
              a torch.profiler breakdown of one chunk and of one step of
              each (device busy and idle share, launches, top kernels,
              host-to-device copies and the runtime's copy, synchronize
              and launch calls).
The train, pose, lightstage and proposal phases also count the encode's
launches by caller (train forwards, grid refresh chunks, evaluation).
It prints `render`, `train`, `disk`, `jpeg`, `pose`, `lightstage`,
`proposal`, `O`, `exr`, `dng`, `reg`, `unfused` (the disk, jpeg, exr and
dng lines and the last five with the card's name and power limit),
`pose_recovery`, `cli`, `multi` (with the card's name and power limit),
`hdr` (with the card's name and power limit), `host`, `tools`,
`table_grad` and `kernels` JSON lines (each kernel's
`launches` are the reg phase's, also as `launches_reg`, `reg_launched`
says whether it ran there; `launches_O` and `O_launched` the -O
phase's, its launches in one chunk of the normal render ride as
`launches_O_normal_render_chunk`, the other phases' counts beside them,
`launches_disk` the disk phase's, `launches_jpeg` the jpeg phase's,
`launches_exr` and `launches_dng` the exr and dng phases',
`launches_cli` the cli phase's,
`launches_hdr` the hdr phase's 128 steps, `launches_tools_quality_run`
the tools phase's quality_run (the cli's and quality_run's training runs
in chained CUDA-graph replays, so these two count the wrappers' calls on
the host: the eager steps' launches and one for each call a capture
records, not the replays', which each training phase counts on the
device in its `dispatch.profile_chain`),
`launches_multi` each rank's in the multi phase's dp and tp runs, and
`shard_C8` the encode's kernels' numbers at the tp shard's width;
the numbers of the proposal path's three kernels are at its shapes, a
step's or a serving chunk's calls summed, with the flagship's under
`flagship`) and the
card's name and power limit, and ends with one line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
The `kernels` line marks `deterministic: true` on each kernel whose two
calls on the same inputs gave the same bits.
It exits non-zero without a result when torch.cuda is not available, or
when the raw_ngp_torch package is not beside it.

With --against, it only builds and compares: each TREE's
raw_ngp_torch/csrc/hash_encode.cu (another version of this repository,
e.g. a git archive of a parent commit; the same C entry points) is built
beside this tree's (all at once), and the encode forward and input
gradient of both run on the phase-3 and phase-8 inputs, the forward also
on the -O grid's, and the JVP on the phase-14 inputs of both grids,
through this tree's wrappers (a TREE whose kernels read the level table's
first 11 columns gets those), outputs compared and times taken in turns
(other, this, this, other); one `ab` JSON line per TREE.

With --deterministic-ops, a diagnostic only: two train steps and two pose
steps of the flagship and two steps each of the -O2 and -O presets and
of the regularised -O on the fused and the unfused encoder (4 cameras)
under
torch.use_deterministic_algorithms(True, warn_only=True), printing each
warning PyTorch gives for an op on the path that has no deterministic
CUDA implementation; one `deterministic_ops` line.
"""

from __future__ import annotations

import atexit
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
import traceback
from dataclasses import replace
from typing import Any, NamedTuple

# published peaks of one H100 SXM (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12


class PhaseError(RuntimeError):
    pass


def scratch_workspace():
    """A fresh temporary workspace for a Trainer (removed when the script
    exits): with the default ckpt "latest" a Trainer resumes from the
    checkpoints of its workspace, so each one gets an empty one."""
    path = tempfile.mkdtemp(prefix="chip_smoke_ws_")
    atexit.register(shutil.rmtree, path, True)
    return path


def check(cond, msg):
    if not cond:
        raise PhaseError(msg)


def same_bits(a, b):
    """Whether two tensors hold the same bits (NaN-safe)."""
    import torch
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))


def within_sum_error(out, ref, mass, rtol):
    """|out - ref| <= rtol |ref| + 1e-5 + 2^-20 mass: two f32 sums of the
    same terms in different orders differ by a small multiple of 2^-24
    times the terms' absolute sum ``mass``; 2^-20 leaves a factor 16. A
    dense-skew row's ~940k signed terms cancel to a total some 1e5 times
    smaller than their absolute sum, so an rtol alone cannot hold it."""
    return bool(((out - ref).abs()
                 <= rtol * ref.abs() + 1e-5 + 2.0 ** -20 * mass).all())


def time_ms(fn, reps, warmup=3):
    """Mean time of fn() over reps back-to-back calls (CUDA events): the
    device time, or the host time of a call where that is longer."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def device_ms(fn, reps=20):
    """Device busy time of one call of fn (torch.profiler, mean over
    `reps` calls). Unlike CUDA events around back-to-back calls it leaves
    out the wrapper's host time where that exceeds the kernel's."""
    return profile_device(fn, reps, "call").get("device_busy_ms_per_call")


def _kernel_name(mangled):
    """A readable name of a mangled kernel symbol: the innermost name of
    its (nested) name and its integer / bool template arguments
    (hash_encode_kernel<16, true>)."""
    import re
    pos = 3 if mangled.startswith("_ZN") else 2
    name = None
    while True:
        m = re.match(r"\d+", mangled[pos:])
        if not m:
            break
        n = int(m.group())
        start = pos + m.end()
        name, pos = mangled[start:start + n], start + n
    if name is None:
        return mangled
    rest = mangled[pos:]
    if rest.startswith("I"):
        args = re.findall(r"L([a-z])(n?\d+)E", rest.split("EE", 1)[0] + "E")
        if args:
            name += "<" + ", ".join(
                ("true" if v == "1" else "false") if k == "b"
                else v.replace("n", "-") for k, v in args) + ">"
    return name


def ptxas_report(log):
    """[{kernel, registers, stack_frame, spill_stores, spill_loads}] of
    every entry function in an nvcc -Xptxas -v log."""
    import re
    frames, kernels, entry = {}, [], None
    current = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry = m.group(1)
            continue
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            current = m.group(1)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and current:
            frames[current] = tuple(int(v) for v in m.groups())
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and entry:
            stack, st, ld = frames.get(entry, (0, 0, 0))
            kernels.append(dict(kernel=_kernel_name(entry),
                                registers=int(m.group(1)), stack_frame=stack,
                                spill_stores=st, spill_loads=ld))
            entry = None
    return kernels


def phase_build():
    """Build every source; print each kernel's registers, stack frame and
    spills (ptxas), and return them by source."""
    from raw_ngp_torch.kernels import _build
    t0 = time.time()
    reports = _build.build_all()
    ptxas = {}
    for name, log in sorted(reports.items()):
        ptxas[name] = ptxas_report(log)
        for k in ptxas[name]:
            print(f"[build] {name}: {k['kernel']}: {k['registers']} registers, "
                  f"{k['stack_frame']} bytes stack frame, {k['spill_stores']} "
                  f"bytes spill stores, {k['spill_loads']} bytes spill loads")
    print(f"[build] {sorted(_build.SOURCES)} ready in "
          f"{time.time() - t0:.1f} s")
    return ptxas


# kernel entry -> (source, instantiations, (template argument, value) they
# must have or None) that must keep everything in registers: the encode's
# two gathers (every channel quad, window and row; the forward without
# and with records, its third argument), B2's flat form (its running
# totals and the previous segment's G1: the one-chunk-a-warp walk's flat
# instantiations, its second argument, at C = 32; below, the walk's every
# instantiation, as a (prefix, argument) entry gives; its fix-up and
# join), the fold's four kernels and the radix sort's two (its keys,
# ranks and look-back)
REGISTER_CHECKED = {
    "hash_encode": ("hash_encode", ("hash_encode_kernel<",), (2, "false")),
    "hash_encode_records": ("hash_encode", ("hash_encode_kernel<",),
                            (2, "true")),
    "encode_input_grad": ("hash_encode", ("encode_input_grad_kernel",), None),
    "encode_input_jvp": ("hash_encode", ("encode_input_jvp_kernel",), None),
    "segment_grad_outer": ("segsum", (("segsum_flat_walk_kernel<", None),
                                      "segsum_outer_kernel<",
                                      "segsum_flat_fixup_kernel<",
                                      "segsum_flat_join_kernel"), (1, "true")),
    "decimate_compact": ("compact", ("decimate_count_kernel",
                                     "decimate_scan_kernel",
                                     "decimate_place_kernel"), None),
    "decimate_compact_bwd": ("compact", ("decimate_bwd_kernel",), None),
    "sort_keys": ("radix_sort", ("radix_histogram_kernel",
                                 "radix_pass_kernel<"), None),
}


def checked_instantiations(ptxas, entry):
    """The ptxas reports of REGISTER_CHECKED[entry]."""
    source, prefixes, arg = REGISTER_CHECKED[entry]

    def wanted(name):
        for prefix in prefixes:
            prefix, need = prefix if isinstance(prefix, tuple) \
                else (prefix, arg)
            if name.startswith(prefix):
                args = name.partition("<")[2].rstrip(">").split(", ")
                return (need is None or len(args) <= 1
                        or args[need[0]] == need[1])
        return False

    return [k for k in ptxas.get(source, ()) if wanted(k["kernel"])]


def check_registers(ptxas):
    """No instantiation of REGISTER_CHECKED spills or keeps a stack
    frame."""
    for entry in REGISTER_CHECKED:
        for k in checked_instantiations(ptxas, entry):
            check(k["spill_stores"] == 0 and k["spill_loads"] == 0
                  and k["stack_frame"] == 0,
                  f"build: {k['kernel']} spills or keeps a stack frame {k}")


def host_us(fn, reps=200):
    """Host time of one call of fn, microseconds (perf_counter over `reps`
    calls, not synchronized inside: the enqueue)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / reps * 1e6


def decimate_inputs(dev, N, K, rate, seed, miss_rate=0.1):
    """Seeded inputs of the fold on the card: mask [N, K] at keep `rate`,
    miss [N, 1], ts [N, K] (-1 where dead), dt [N, 1]."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(seed)
    mask = torch.rand(N, K, generator=gen, device=dev) < rate
    miss = torch.rand(N, 1, generator=gen, device=dev) < miss_rate
    ts = torch.where(mask, torch.rand(N, K, generator=gen, device=dev) * 3
                     + 0.5, -1.0)
    dt = torch.rand(N, 1, generator=gen, device=dev) * 0.1 + 1e-3
    return mask, miss, ts, dt


def phase_decimate(dev, m_pad=262144, K=64, n_train=8192, n_chunk=16384):
    """The fold (budget decimation + compaction, forward and backward)
    against its plain version, bit for bit, at the train shape (8,192
    rays) and a serving chunk (16,384 rays), stride 1 and above, full and
    empty; then timed at stride 1: its launches, time by kernel, the
    plain version, the library calls and the wrapper's host time by
    parts."""
    import re

    import torch
    from raw_ngp_torch.kernels import compact as ck
    cases = {"train stride 1": (n_train, 0.25, 0.1),
             "train stride 2": (n_train, 0.7, 0.1),
             "train full": (n_train, 1.0, 0.0),
             "train empty": (n_train, 0.0, 0.1),
             "chunk stride 1": (n_chunk, 0.2, 0.1),
             "chunk stride 3": (n_chunk, 0.6, 0.1)}
    names = ("t_c", "dt_c", "rid", "filled", "counts", "valid_total",
             "num_points")
    inputs = {}
    for i, (name, (N, rate, miss_rate)) in enumerate(cases.items()):
        mask, miss, ts, dt = decimate_inputs(dev, N, K, rate, 20 + i,
                                             miss_rate)
        inputs[name] = (mask, miss, ts, dt)
        g = torch.randn(2, m_pad, generator=torch.Generator(
            device=dev).manual_seed(30 + i), device=dev)
        outs, grads = [], []
        for plain in (False, False, True):
            ts_r = ts.clone().requires_grad_()
            dt_r = dt.clone().requires_grad_()
            deltas = dt_r.expand(N, K)
            deltas.retain_grad()
            out = ck.decimate_compact(mask, miss, ts_r, deltas, m_pad,
                                      plain=plain)
            (out[0] * g[0] + out[1] * g[1]).sum().backward()
            outs.append([o.detach() for o in out])
            grads.append((ts_r.grad, deltas.grad, dt_r.grad))
        torch.cuda.synchronize()
        for a, b, what in zip(outs[0], outs[1], names):
            check(same_bits(a, b), f"decimate {name}: two calls differ in "
                                   f"{what}")
        for a, b, what in zip(outs[0], outs[2], names):
            check(same_bits(a, b), f"decimate {name}: {what} differs from "
                                   f"the plain version")
        for a, b, what in zip(grads[0], grads[1], ("ts", "deltas", "dt")):
            check(same_bits(a, b), f"decimate {name}: two backward calls "
                                   f"differ in d {what}")
        for a, b, what in zip(grads[0], grads[2], ("ts", "deltas", "dt")):
            check(same_bits(a, b), f"decimate {name}: d {what} differs from "
                                   f"the plain version")
        # the expand path's slot positions: the place kernel's extra store
        with torch.no_grad():
            deltas = dt.expand(N, K)
            with_pos = ck.decimate_compact(mask, miss, ts, deltas, m_pad,
                                           positions=True)
            plain_pos = ck.decimate_compact(mask, miss, ts, deltas, m_pad,
                                            plain=True, positions=True)
        torch.cuda.synchronize()
        check(same_bits(with_pos[7], plain_pos[7]),
              f"decimate {name}: pos differs from the plain version")
        for a, b, what in zip(with_pos, outs[0], names):
            check(same_bits(a, b), f"decimate {name}: {what} with pos "
                                   f"differs from the fold without it")
        total, n_pts = int(outs[0][5]), int(outs[0][6])
        print(f"[decimate] {name}: N={N} K={K} m_pad={m_pad}, valid "
              f"{total}, stride {max(-(-total // m_pad), 1)}, filled "
              f"{n_pts}: forward and backward bit for bit the plain "
              f"version, two calls bitwise equal; with positions, pos bit "
              f"for bit the plain version's and the other outputs "
              f"unchanged")

    def timing(name):
        mask, miss, ts, dt = inputs[name]
        N = mask.shape[0]
        deltas = dt.expand(N, K)
        fold = lambda: ck.decimate_compact(mask, miss, ts, deltas, m_pad)
        plain = lambda: ck.decimate_compact_plain(mask, miss, ts, deltas,
                                                  m_pad)
        live = (mask & ~miss).reshape(-1)
        ts_flat = ts.reshape(-1)
        M = live.numel()

        def nonzero_lib():
            idx = torch.nonzero(live).squeeze(1)[:m_pad]
            return ts_flat.index_select(0, idx)

        def nonzero_static_lib():
            idx = torch.nonzero_static(live, size=m_pad,
                                       fill_value=M).squeeze(1)
            return ts_flat.index_select(0, idx.clamp_max(M - 1))

        n_pts = int(fold()[6])
        prof_fold = profile_device(fold, 20, "call")
        row = {"ms": time_ms(fold, 50),
               "device_ms": prof_fold.get("device_busy_ms_per_call"),
               "launches_per_call": prof_fold.get("kernel_launches_per_call"),
               "kernels": {(re.findall(r"(\w+)\(", k["name"])
                            or [k["name"]])[0]: k["ms_per_call"]
                           for k in prof_fold.get("top_kernels", ())},
               "plain_ms": time_ms(plain, 10),
               "nonzero_index_select_ms": time_ms(nonzero_lib, 20),
               "nonzero_index_select_device_ms": device_ms(nonzero_lib)}
        try:
            row["nonzero_static_index_select_ms"] = time_ms(
                nonzero_static_lib, 20)
            row["nonzero_static_index_select_device_ms"] = device_ms(
                nonzero_static_lib)
        except (RuntimeError, NotImplementedError) as e:
            row["nonzero_static_index_select_ms"] = None
            row["nonzero_static"] = f"not run on the card: {e}"[:200]
        # least traffic: the mask, miss, the kept records' t, dt, and
        # t_c, dt_c, rid, filled, the counts and the two totals
        n_bytes = (N * K + N + 4 * n_pts + 4 * N + 13 * m_pad + 8 * N
                   + 16)
        row["bound_ms"] = n_bytes / HBM_BYTES_PER_S * 1e3
        row["bound_bytes"] = n_bytes
        row["filled"] = n_pts
        # the wrapper's host time by parts
        tdt, rid, filled, counts, scratch = ck._decimate_alloc(N, K, m_pad,
                                                               dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        fn = ck._lib("decimate_compact_fwd")
        args = (mask.data_ptr(), miss.data_ptr(), ts.data_ptr(),
                deltas.data_ptr(), deltas.stride(0), deltas.stride(1),
                tdt.data_ptr(), rid.data_ptr(), filled.data_ptr(),
                counts.data_ptr(), scratch.data_ptr(), None, N, K, m_pad,
                stream)
        row["host_us"] = {
            "wrapper": host_us(fold),
            "checks": host_us(lambda: ck._decimate_check(
                mask, miss, ts, deltas, m_pad)),
            "torch_empty_x5": host_us(lambda: ck._decimate_alloc(
                N, K, m_pad, dev)),
            "current_stream": host_us(
                lambda: torch.cuda.current_stream(dev).cuda_stream),
            "ctypes_call_3_launches": host_us(lambda: fn(*args)),
            "output_views": host_us(lambda: (tdt.unbind(0), counts[:N],
                                             counts[N], counts[N + 1]))}
        print(f"[decimate] {name}: fold {row['ms']:.4f} ms (device "
              f"{row['device_ms']} ms, {row['launches_per_call']} launches "
              f"a call, by kernel {json.dumps(row['kernels'])}); plain "
              f"{row['plain_ms']:.4f} ms; nonzero + index_select "
              f"{row['nonzero_index_select_ms']:.4f} ms (device "
              f"{row['nonzero_index_select_device_ms']} ms), nonzero_static "
              f"+ index_select {row['nonzero_static_index_select_ms']} ms "
              f"(device {row.get('nonzero_static_index_select_device_ms')} "
              f"ms); bound {row['bound_ms'] * 1e3:.2f} us ({n_bytes} bytes, "
              f"three launches set the floor); host us a call "
              f"{json.dumps(row['host_us'])}")
        return row, (mask, miss, ts, deltas, n_pts)

    rows = {}
    for name in ("chunk stride 1", "train stride 1"):
        rows[name], train_inputs = timing(name)
    mask, miss, ts, deltas, n_pts = train_inputs
    N = mask.shape[0]
    M = N * K
    row = rows["train stride 1"]

    # the backward at the train shape, stride 1
    scratch = ck._decimate_forward(mask, miss, ts, deltas, m_pad)[4]
    g = torch.randn(2, m_pad, generator=torch.Generator(
        device=dev).manual_seed(40), device=dev)
    bwd = lambda: ck.decimate_compact_bwd(g, scratch, N, K, m_pad)
    ts_r = ts.clone().requires_grad_()
    dl = deltas.clone().requires_grad_()
    out_p = ck.decimate_compact_plain(mask, miss, ts_r, dl, m_pad)
    plain_bwd = lambda: torch.autograd.grad(out_p[:2], (ts_r, dl), g.unbind(0),
                                            retain_graph=True)
    live = (mask & ~miss).reshape(-1)
    dest = torch.nonzero(live).squeeze(1)[:m_pad]
    g_kept = g[:, :dest.numel()].contiguous()
    buf = torch.empty(2, M, device=dev)
    lib = lambda: buf.zero_().index_copy_(1, dest, g_kept)
    nw = (K + 31) // 32
    b_bytes = 2 * 4 * n_pts + 2 * 4 * M + 4 * (N * nw + N + 1)
    brow = {"ms": time_ms(bwd, 50), "device_ms": device_ms(bwd),
            "plain_ms": time_ms(plain_bwd, 10),
            "library_ms": time_ms(lib, 20), "library_device_ms":
                device_ms(lib),
            "bound_ms": b_bytes / HBM_BYTES_PER_S * 1e3,
            "bound_bytes": b_bytes,
            "host_us": host_us(bwd)}
    print(f"[decimate] backward, train stride 1: kernel {brow['ms']:.4f} ms "
          f"(device {brow['device_ms']} ms, host {brow['host_us']:.1f} us a "
          f"call), plain (autograd of the plain chain) "
          f"{brow['plain_ms']:.4f} ms, zero_ + index_copy_ "
          f"{brow['library_ms']:.4f} ms (device {brow['library_device_ms']} "
          f"ms), bound {brow['bound_ms'] * 1e3:.2f} us ({b_bytes} bytes)")
    fwd = dict(name="decimate_compact", route="cuda",
               source="raw_ngp_torch/csrc/compact.cu",
               replaces="raw_ngp_tpu/kernels/compact_pallas.py:118",
               max_abs_err=0.0, ms=row["ms"], device_ms=row["device_ms"],
               plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
               bound_by="bytes",
               library_ms=row["nonzero_static_index_select_ms"]
               or row["nonzero_index_select_ms"],
               library="nonzero_static + index_select of t (the stride-1 "
                       "positions), else nonzero + index_select",
               deterministic=True, shapes=rows)
    back = dict(name="decimate_compact_bwd", route="cuda",
                source="raw_ngp_torch/csrc/compact.cu",
                replaces="raw_ngp_tpu/kernels/compact_pallas.py:224",
                max_abs_err=0.0, ms=brow["ms"], device_ms=brow["device_ms"],
                plain_ms=brow["plain_ms"], bound_ms=brow["bound_ms"],
                bound_by="bytes", library_ms=brow["library_ms"],
                library_device_ms=brow["library_device_ms"],
                library="zero_ + index_copy_ at the kept flat indices",
                host_us=brow["host_us"], deterministic=True)
    return fwd, back


def refresh_chunk(cfg, gen, dev):
    """The first 65,536-point chunk of a full grid sweep as
    ops/grid.full_sweep builds it: Morton-ordered cell centres of cascade
    0, jittered by uniform noise, as the field's x01 = (x + grid_bound) /
    (2 grid_bound)."""
    import torch
    from raw_ngp_torch.ops.grid import _CHUNK, cascade_coords_to_world
    from raw_ngp_torch.ops.morton import morton3d_invert
    n = cfg.render.grid_size
    codes = torch.arange(_CHUNK, device=dev)
    cas_bound = min(1.0, cfg.grid_bound)
    noise = torch.rand(_CHUNK, 3, generator=gen, device=dev)
    xyz = cascade_coords_to_world(morton3d_invert(codes), cas_bound,
                                  cas_bound / n, n, noise)
    return ((xyz + cfg.grid_bound) / (2.0 * cfg.grid_bound)).contiguous()


def encode_inputs(cfg, gen, dev, B, kinds=("uniform", "ray", "refresh")):
    """The encode's inputs on the path: B uniform points (the first 64
    outside [0, 1]^3, 8 with a NaN), B ray-ordered points (the train
    forward's), one refresh chunk (the grid refresh's)."""
    import torch
    out = {}
    if "uniform" in kinds:
        x = torch.rand(B, 3, generator=gen, device=dev)
        x[:64] = x[:64] * 3.0 - 1.0
        x[64:72, 1] = float("nan")
        out["uniform"] = x
    if "ray" in kinds:
        out["ray"] = ray_points(B, gen, dev)
    if "refresh" in kinds:
        out["refresh"] = refresh_chunk(cfg, gen, dev)
    return out


def encode_bound(spec, x01, out_bytes, extra_bytes=0, ops_per_term=2):
    """(bound ms, bound_by, bytes, touched rows) of one encode call on x01:
    the points, the table rows this input touches (once each), the output
    (`out_bytes` an element) and `extra_bytes`; `ops_per_term` f32
    operations per corner and channel of every in-bounds point and
    level."""
    B = x01.shape[0]
    L, C = spec.num_levels, spec.level_dim
    rows, n_in = touched_rows(spec, x01)
    n_bytes = B * 3 * 4 + rows * C * 4 + B * L * C * out_bytes + extra_bytes
    n_ops = ops_per_term * 8 * C * L * n_in
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = n_ops / F32_FLOP_PER_S * 1e3
    return (max(bytes_ms, ops_ms),
            "bytes" if bytes_ms >= ops_ms else "operations", n_bytes, rows)


def phase_encode(dev, cfg, B=262144):
    """The encode kernel against its plain version at each input the path
    gives it (uniform and ray-ordered points, a refresh chunk), f32 and
    bf16, each timed (CUDA events and device time) beside its own bound."""
    import torch
    from raw_ngp_torch.kernels.hash_encode import (hash_encode,
                                                   hash_encode_fused_plain)
    from raw_ngp_torch.models.ngp import make_field_spec
    from raw_ngp_torch.ops.hashgrid import hash_encode_01
    spec = make_field_spec(cfg).grid_spec
    L, C = spec.num_levels, spec.level_dim
    gen = torch.Generator(device=dev).manual_seed(2)
    table = torch.rand(spec.n_params * C, generator=gen, device=dev) * 2 - 1
    inputs = encode_inputs(cfg, gen, dev, B)
    per_input = {}
    # f32 against hash_encode_01 within atol 1e-6 (another f32 sum order
    # where nvcc fuses); bf16 against the fused encoder's chain, bit-exact
    for kind, x01 in inputs.items():
        per_input[kind] = {}
        for dtype, atol in ((torch.float32, 1e-6), (torch.bfloat16, 0.0)):
            name = str(dtype)[6:]
            k = hash_encode(table, x01, spec, compute_dtype=dtype)
            k2 = hash_encode(table, x01, spec, compute_dtype=dtype)
            p = (hash_encode_01(table, x01, spec) if dtype == torch.float32
                 else hash_encode_fused_plain(table, x01, spec, dtype))
            torch.cuda.synchronize()
            check(same_bits(k, k2), f"encode {kind} {name}: two calls differ")
            n = x01.shape[0]
            check(k.dtype == dtype and k.shape == (n, L * C),
                  f"encode {kind} {name}: got {k.dtype} {tuple(k.shape)}")
            err = float((k.float() - p.float()).abs().max())
            check(err <= atol, f"encode {kind} {name}: max abs err {err} "
                               f"exceeds {atol}")

            def call(x01=x01, dtype=dtype):
                return hash_encode(table, x01, spec, compute_dtype=dtype)

            ms, dev_ms = time_ms(call, 50), device_ms(call)
            bound_ms, bound_by, n_bytes, rows = encode_bound(
                spec, x01, 2 if dtype == torch.bfloat16 else 4)
            per_input[kind][name] = dict(
                points=n, max_abs_err=err, ms=ms, device_ms=dev_ms,
                bound_ms=bound_ms, bound_by=bound_by, bytes=n_bytes,
                touched_rows=rows)
            print(f"[encode] {kind} B={n} {name}: max abs err {err:.3e} "
                  f"(tolerance {atol}{', bit-exact' if atol == 0 else ''}); "
                  f"kernel {ms:.4f} ms (device {dev_ms} ms), bound "
                  f"{bound_ms * 1e3:.2f} us ({bound_by}: touched rows {rows}, "
                  f"{n_bytes} bytes)")
    bf16 = torch.bfloat16
    x01 = inputs["uniform"]
    plain_ms = time_ms(
        lambda: hash_encode_fused_plain(table, x01, spec, bf16), 3)
    top = per_input["uniform"]["bfloat16"]
    print(f"[encode] uniform B={B} bf16 plain {plain_ms:.4f} ms")
    return dict(name="hash_encode", route="cuda",
                source="raw_ngp_torch/csrc/hash_encode.cu",
                replaces="raw_ngp_tpu/kernels/hash_fused.py:497",
                max_abs_err=top["max_abs_err"],
                max_abs_err_f32=per_input["uniform"]["float32"]["max_abs_err"],
                ms=top["ms"], device_ms=top["device_ms"], plain_ms=plain_ms,
                bound_ms=top["bound_ms"], bound_by=top["bound_by"],
                library_ms=None, inputs=per_input, deterministic=True)


def _outer_stream(dev, M, B, n_rows, C, skew):
    """A sorted outer-product record stream as the table gradient builds
    it: keys sorted by torch.sort with their permutation, a (w0, w1) word
    per record, and the flagship's bf16 cotangent g [B, 2C], whose level-1
    channels (column C) B2 reads in place -> (the kernel's stream, the
    plain version's stream with those channels packed)."""
    import torch
    from raw_ngp_torch.kernels import segsum as ts
    gen = torch.Generator(device=dev).manual_seed(3)
    keys = torch.randint(0, n_rows, (M,), generator=gen, device=dev,
                         dtype=torch.int32)
    if skew:        # a dense level's funnel: 90% of records into one row
        keys = torch.where(torch.rand(M, generator=gen, device=dev) < 0.9,
                           7, keys).to(torch.int32)
    keys_s, perm = torch.sort(keys, stable=True)
    w = torch.rand(2, M, generator=gen, device=dev)
    g = torch.randn(B, 2 * C, generator=gen, device=dev).to(torch.bfloat16)
    head = (keys_s, perm.to(torch.int32), ts.pack_bf16_pairs([w[0], w[1]])[0])
    return (head + (g, n_rows, C),
            head + (ts.g_words_plain(g, C, C), n_rows, C))


# B2's flat form below 16 channels, on _outer_stream's streams: (C,
# records, points, rows, the shape): the -O2 field grid's finest level (a
# step's 196,608 points, 8 windows a point: 8 x 196,608 records into its
# 2^19 rows), the -O grid's C = 1 tp shard at its finest level (131,072
# points, 8 windows), the flagship's C = 8 tp shard at level 1
NARROW_STREAMS = (
    (2, 1572864, 196608, 1 << 19, "-O2's field grid, its finest level"),
    (1, 1 << 20, 131072, 1 << 19, "the -O grid's C = 1 shard, level 15"),
    (8, 1 << 20, 1 << 18, 1 << 19, "the flagship's C = 8 shard, level 1"),
)


def phase_segsum(dev, M=1 << 20, B=1 << 18, n_rows=1 << 19, C=16):
    """B2's outer mode at level 1 in both of its forms, random keys and the
    skew stream: the 2C totals (segment_totals_outer; off the training
    path, the flat form's oracle) and the flat form the table gradient
    calls (segment_grad_outer: G0[r] + G1[r - 1] written straight into the
    flat rows), each against its plain version, the flat form also bit for
    bit against the 2C totals plus combine_totals_plain; then the times of
    both, the plain versions' and the library yardsticks'. Returns the two
    `kernels` entries."""
    import torch
    from raw_ngp_torch.kernels import segsum as ts
    errs, flat_errs, skew_dev, flat_skew = {}, {}, None, None
    for skew, rtol in ((False, 1e-5), (True, 1e-5)):
        stream, packed = _outer_stream(dev, M, B, n_rows, C, skew)
        keys_s, perm, w_word, g_words = packed[:4]
        k = ts.segment_totals_outer(*stream, g_col=C)
        k2 = ts.segment_totals_outer(*stream, g_col=C)
        p = ts.segment_totals_outer_plain(*packed)
        torch.cuda.synchronize()
        check(same_bits(k, k2), f"segsum skew={skew}: two calls differ")
        empty = torch.ones(n_rows, dtype=torch.bool, device=dev)
        empty[keys_s.long()] = False
        check(bool((k[empty] == 0).all()), "segsum: an empty row is not 0")
        err = float((k - p).abs().max())
        mass = torch.zeros_like(p).index_add_(
            0, keys_s.long(), ts._outer_products(perm, w_word, g_words,
                                                 C).abs())
        ok = (within_sum_error(k, p, mass, rtol) if skew
              else torch.allclose(k, p, rtol=rtol, atol=1e-5))
        check(ok, f"segsum skew={skew}: max abs err {err} exceeds the "
                  f"bound (rtol {rtol})")
        errs[skew] = err
        longest = int(torch.unique_consecutive(keys_s, return_counts=True)[1]
                      .max())
        prof = profile_device(lambda: ts.segment_totals_outer(
            *stream, g_col=C, out=k), 20, "call")
        dev_ms = prof.get("device_busy_ms_per_call")
        split = stage_split(prof, SEGSUM_STAGES, "zero_fill")
        if skew:
            skew_dev = dev_ms
        print(f"[segsum] M={M} rows={n_rows} C={C} skew={skew}: max abs err "
              f"{err:.3e} (rtol {rtol}, atol 1e-5"
              f"{', + 2^-20 x row absolute sum' if skew else ''}), "
              f"{int(empty.sum())} empty rows exactly 0, two calls bitwise "
              f"equal; longest row {longest} records "
              f"({-(-longest // 128)} chunks); device {dev_ms} ms "
              f"{json.dumps(split)}: ok")

        # the flat form: the oracle's bits, its plain version's values
        flat = ts.segment_grad_outer(*stream, g_col=C)
        flat_2 = ts.segment_grad_outer(*stream, g_col=C)
        oracle = ts.combine_totals_plain(k, torch.empty(n_rows * C,
                                                         device=dev))
        flat_p = ts.segment_grad_outer_plain(*packed)
        torch.cuda.synchronize()
        check(same_bits(flat, oracle), f"segment_grad_outer skew={skew}: "
              "differs in its bits from segment_totals_outer + "
              "combine_totals_plain")
        check(same_bits(flat, flat_2),
              f"segment_grad_outer skew={skew}: two calls differ")
        flat_mass = (mass[:, :C] + torch.cat(
            [mass.new_zeros(1, C), mass[:-1, C:]])).reshape(-1)
        ferr = float((flat - flat_p).abs().max())
        ok = (within_sum_error(flat, flat_p, flat_mass, rtol) if skew
              else torch.allclose(flat, flat_p, rtol=rtol, atol=1e-5))
        check(ok, f"segment_grad_outer skew={skew}: max abs err {ferr} "
                  f"exceeds the bound (rtol {rtol})")
        flat_errs[skew] = ferr
        prof = profile_device(lambda: ts.segment_grad_outer(
            *stream, g_col=C, out=flat), 20, "call")
        f_dev = prof.get("device_busy_ms_per_call")
        f_split = stage_split(prof, FLAT_STAGES, "zero_fill")
        if skew:
            flat_skew = f_dev
        print(f"[segsum] flat form skew={skew}, g read in place: bitwise "
              f"equal to the 2C totals + combine_totals_plain and between "
              f"two calls; max abs err "
              f"to its plain version {ferr:.3e}; device {f_dev} ms, "
              f"{prof.get('kernel_launches_per_call')} device launches "
              f"{json.dumps(f_split)}: ok")

    stream, packed = _outer_stream(dev, M, B, n_rows, C, False)
    keys_s, perm, w_word, g_words = packed[:4]
    out = torch.empty(n_rows, 2 * C, device=dev)
    ms = time_ms(lambda: ts.segment_totals_outer(*stream, g_col=C, out=out),
                 50)
    dev_ms = device_ms(lambda: ts.segment_totals_outer(*stream, g_col=C,
                                                       out=out))
    plain_ms = time_ms(lambda: ts.segment_totals_outer_plain(
        *packed, out=out), 5)
    prod = ts._outer_products(perm, w_word, g_words, C)
    keys64 = keys_s.long()
    library_ms = time_ms(lambda: out.zero_().index_add_(0, keys64, prod), 20)
    n_words = (C + 1) // 2
    rows_read = int(torch.unique(perm.long() % B).numel())
    n_bytes = 12 * M + 4 * n_words * rows_read + 4 * 2 * C * n_rows
    n_ops = 2 * 2 * C * M          # one multiply and one add per channel
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = n_ops / F32_FLOP_PER_S * 1e3
    print(f"[segsum] 2C totals {ms:.4f} ms (zero fill included; device "
          f"{dev_ms} ms), plain "
          f"{plain_ms:.4f} ms, index_add_ of the products {library_ms:.4f} "
          f"ms; {n_bytes} bytes ({bytes_ms * 1e3:.2f} us), {n_ops} flop "
          f"({ops_ms * 1e3:.2f} us)")
    k_2c = dict(name="segment_totals", route="cuda",
                source="raw_ngp_torch/csrc/segsum.cu",
                replaces="raw_ngp_tpu/kernels/segsum_pallas.py:124",
                max_abs_err=errs[False], max_abs_err_skew=errs[True], ms=ms,
                device_ms=dev_ms, plain_ms=plain_ms,
                bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                library_ms=library_ms,
                library="index_add_ of the bf16-rounded products",
                skew_device_ms=skew_dev, on_main_path=False,
                deterministic=True)

    # the flat form
    flat = torch.empty(n_rows * C, device=dev)
    f_ms = time_ms(lambda: ts.segment_grad_outer(*stream, g_col=C, out=flat),
                   50)
    f_dev = device_ms(lambda: ts.segment_grad_outer(*stream, g_col=C,
                                                    out=flat))
    f_plain = time_ms(lambda: ts.segment_grad_outer_plain(*packed, out=flat),
                      5)
    # the library call: one zero_ + index_add_ of the 2M rounded products
    # into the flat rows keys (w0 g) and keys + 1 (w1 g)
    lib_rows = torch.cat([keys64, keys64 + 1])
    lib_vals = torch.cat([prod[:, :C], prod[:, C:]])
    keep = lib_rows < n_rows
    lib_rows, lib_vals = lib_rows[keep], lib_vals[keep].contiguous()
    flat_rows = flat.view(n_rows, C)
    f_lib = time_ms(lambda: flat_rows.zero_().index_add_(0, lib_rows,
                                                          lib_vals), 20)
    f_lib_dev = device_ms(lambda: flat_rows.zero_().index_add_(
        0, lib_rows, lib_vals))
    f_parent = {}
    if b2_parent() is not None:
        turns = b2_step([dict(keys=keys_s, perm=perm, w_word=w_word,
                              g=stream[3], n_rows=n_rows, C=C, g_col=C)],
                        b2_parent(), reps=20)
        f_parent = {k: turns[k] for k in (
            "same_bits_as_parent", "turns_ms", "turns_device_ms", "ms",
            "parent_ms", "device_ms", "parent_device_ms")}
    f_bytes = 12 * M + 4 * n_words * rows_read + 4 * C * n_rows
    f_bytes_ms = f_bytes / HBM_BYTES_PER_S * 1e3
    print(f"[segsum] flat form {f_ms:.4f} ms (zero fill included; device "
          f"{f_dev} ms), plain {f_plain:.4f} ms, zero_ + "
          f"index_add_ of the products into rows keys and keys + 1 "
          f"{f_lib:.4f} ms (device {f_lib_dev} ms); {f_bytes} bytes "
          f"({f_bytes_ms * 1e3:.2f} us), {n_ops} flop "
          f"({ops_ms * 1e3:.2f} us)")
    k_flat = dict(name="segment_grad_outer", route="cuda",
                  source="raw_ngp_torch/csrc/segsum.cu",
                  replaces="raw_ngp_tpu/kernels/segsum_pallas.py:124",
                  max_abs_err=flat_errs[False],
                  max_abs_err_skew=flat_errs[True], ms=f_ms,
                  device_ms=f_dev, plain_ms=f_plain,
                  bound_ms=max(f_bytes_ms, ops_ms),
                  bound_by="bytes" if f_bytes_ms >= ops_ms else "operations",
                  library_ms=f_lib, library_device_ms=f_lib_dev,
                  library="zero_ + index_add_ of the bf16-rounded products "
                          "into rows keys and keys + 1",
                  skew_device_ms=flat_skew,
                  parent_same_call=f_parent or "no --b2-parent",
                  bit_equal_to_totals_plus_combine=True,
                  reads_g_in_place="bf16, level 1's columns of [B, 2C]",
                  deterministic=True)
    k_flat["narrow_widths"] = segsum_narrow(dev)
    return k_2c, k_flat


# a parent tree's segsum.cu to time B2 beside (--b2-parent), and its
# flat form once built (parent_flat)
B2_PARENT = {"tree": None, "call": None}
SEGSUM_FILES = ("segsum.cu", "segments.cuh")


def segsum_sources(tree):
    """The directory holding a tree's segsum.cu and segments.cuh: `tree`
    itself or its raw_ngp_torch/csrc."""
    for d in (tree, os.path.join(tree, "raw_ngp_torch", "csrc")):
        if all(os.path.exists(os.path.join(d, n)) for n in SEGSUM_FILES):
            return d
    raise PhaseError(f"no {' and '.join(SEGSUM_FILES)} under {tree}")


def build_segsum(tree, tag):
    """nvcc of a tree's segsum.cu (the port's flags) into
    build/segsum_trees/<tag>-<hash>/ -> (ctypes library, the ptxas log)."""
    import ctypes
    import hashlib
    from raw_ngp_torch.kernels import _build
    src = segsum_sources(tree)
    h = hashlib.sha256()
    for name in SEGSUM_FILES:
        with open(os.path.join(src, name), "rb") as f:
            h.update(f.read())
    where = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                         "segsum_trees", f"{tag}-{h.hexdigest()[:12]}")
    os.makedirs(where, exist_ok=True)
    for name in SEGSUM_FILES:
        shutil.copy(os.path.join(src, name), os.path.join(where, name))
    lib_path = os.path.join(where, "libsegsum.so")
    proc = subprocess.run(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-o", lib_path,
         os.path.join(where, "segsum.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    check(proc.returncode == 0, f"{tree}'s segsum.cu failed to build\n"
                                f"{proc.stdout}")
    return ctypes.CDLL(lib_path), proc.stdout


def parent_flat(tree, tag="parent"):
    """The flat form of another tree's segsum.cu, called as this tree's
    wrapper calls its own on CUDA tensors (the zero fill, then the C entry
    on the same edge scratch: `flat_edge_buffer`'s layout is unchanged
    since the flat form began) -> (call, ptxas log)."""
    import ctypes
    import torch
    from raw_ngp_torch.kernels import segsum as ts
    lib, log = build_segsum(tree, tag)
    fn = lib.segment_grad_outer_fwd
    fn.argtypes, fn.restype = ts._ARGTYPES["segment_grad_outer_fwd"], \
        ctypes.c_int

    def call(keys_s, perm, w_word, g, n_rows, C, *, g_col=0, out=None):
        dev = keys_s.device
        if out is None:
            out = torch.empty(n_rows * C, dtype=torch.float32, device=dev)
        out.zero_()
        M = keys_s.shape[0]
        if M == 0:
            return out
        scratch, n_edge = ts.flat_edge_buffer(M, C, dev)
        err = fn(keys_s.data_ptr(), perm.data_ptr(), w_word.data_ptr(),
                 g.data_ptr(), g.stride(0), g_col,
                 int(g.dtype == torch.bfloat16), out.data_ptr(),
                 scratch.data_ptr(), M, g.shape[0], C, n_rows, n_edge,
                 torch.cuda.current_stream(dev).cuda_stream)
        check(err == 0, f"{tree}'s segment_grad_outer_fwd: error {err}")
        return out
    return call, log


def b2_parent():
    """The parent tree's flat form (built on first use), None without
    --b2-parent."""
    if B2_PARENT["tree"] and B2_PARENT["call"] is None:
        B2_PARENT["call"] = parent_flat(B2_PARENT["tree"])[0]
    return B2_PARENT["call"]


def capture_b2(run, call=None):
    """Every segment_grad_outer call that run() makes through the table
    gradient: [dict(keys, perm, w_word, g, n_rows, C, g_col)], the
    streams cloned (one clone of each g); `call` (default: the wrapper)
    computes each."""
    from raw_ngp_torch.kernels import hash_encode as th
    fn = th.segment_grad_outer
    call = call or fn
    calls, gs = [], {}

    def capture(keys_s, perm, w_word, g, n_rows, C, *, g_col=0, out=None):
        key = (g.data_ptr(), tuple(g.shape))
        if key not in gs:
            gs[key] = g.detach().clone()
        calls.append(dict(keys=keys_s.clone(), perm=perm.clone(),
                          w_word=w_word.clone(), g=gs[key], n_rows=n_rows,
                          C=C, g_col=g_col))
        return call(keys_s, perm, w_word, g, n_rows, C, g_col=g_col, out=out)

    th.segment_grad_outer = capture
    try:
        run()
    finally:
        th.segment_grad_outer = fn
    return calls


def _mean_of(a, b):
    return None if a is None or b is None else (a + b) / 2


def b2_step(calls, parent=None, reps=5, fn=None):
    """B2's flat form over a list of calls (capture_b2's, or one stream's)
    by `fn` (default: this tree's wrapper), each into its own output: the
    CUDA-event ms and profiler device ms of all of them, the device time
    by stage (FLAT_STAGES: zero fill, main pass, group sums, fix-up,
    join), the bound (each record's key, index and w-word read once, each
    point's channels once at g's own width, the rows written once; or the
    multiplies and adds, where more) and one zero_ + index_add_ a call of
    its bf16-rounded products into rows k and k + 1. With `parent`
    (parent_flat's call): its bits checked against these and both timed in
    turns, parent, this, this, parent."""
    import torch
    from raw_ngp_torch.kernels import segsum as ts
    outs = [torch.empty(c["n_rows"] * c["C"], device=c["keys"].device)
            for c in calls]

    def runner(f):
        def run():
            for c, o in zip(calls, outs):
                f(c["keys"], c["perm"], c["w_word"], c["g"], c["n_rows"],
                  c["C"], g_col=c["g_col"], out=o)
        return run

    this = runner(fn or ts.segment_grad_outer)
    this()
    res = {"calls": len(calls)}
    order = (this,)
    if parent is not None:
        mine = [o.clone() for o in outs]
        par = runner(parent)
        par()
        torch.cuda.synchronize()
        check(all(same_bits(a, b) for a, b in zip(mine, outs)),
              "segment_grad_outer differs in its bits from the parent "
              "tree's kernel")
        order = (par, this, this, par)
    events = [time_ms(f, reps) for f in order]
    profs = [profile_full(f, reps, 5 * len(calls)) for f in order]
    dev = [p.get("device_busy_ms_per_call") for p in profs]
    mine = 1 if parent is not None else 0
    res.update(ms=_mean_of(events[mine], events[-1 - mine]),
               device_ms=_mean_of(dev[mine], dev[-1 - mine]),
               stages_device_ms=stage_split(profs[mine], FLAT_STAGES,
                                            "zero_fill"),
               device_launches=profs[mine].get("kernel_launches_per_call"))
    if parent is not None:
        res.update(same_bits_as_parent=True, turns_ms=events,
                   turns_device_ms=dev,
                   parent_ms=_mean_of(events[0], events[3]),
                   parent_device_ms=_mean_of(dev[0], dev[3]),
                   parent_stages_device_ms=stage_split(
                       profs[0], FLAT_STAGES, "zero_fill"))
    n_bytes = n_ops = 0
    lib = []
    for c, o in zip(calls, outs):
        C, M, g = c["C"], c["keys"].numel(), c["g"]
        points = int(torch.unique(c["perm"].long() % g.shape[0]).numel())
        n_bytes += (12 * M + g.element_size() * C * points
                    + 4 * C * c["n_rows"])
        n_ops += 2 * 2 * C * M       # one multiply and one add a channel
        keys = c["keys"].long()
        words = ts.g_words_plain(g, c["g_col"], C)
        prod = ts._outer_products(c["perm"], c["w_word"], words, C)
        rows = torch.cat([keys, keys + 1])
        vals = torch.cat([prod[:, :C], prod[:, C:]])
        keep = rows < c["n_rows"]
        lib.append((o.view(c["n_rows"], C), rows[keep],
                    vals[keep].contiguous()))
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = n_ops / F32_FLOP_PER_S * 1e3

    def library():
        for o, r, v in lib:
            o.zero_().index_add_(0, r, v)

    res.update(bound_ms=max(bytes_ms, ops_ms),
               bound_by="bytes" if bytes_ms >= ops_ms else "operations",
               bytes=n_bytes, library_ms=time_ms(library, reps),
               library_device_ms=device_ms(library, reps))
    this()
    return res


def segsum_narrow(dev, streams=NARROW_STREAMS):
    """B2's flat form below 16 channels (the walk of 32 / C chunks a
    warp, lanes over chunks and channels) on NARROW_STREAMS, random keys
    and the skew stream (90% of records into one row): bit for bit the 2C
    totals (the one-chunk-a-warp walk) plus combine_totals_plain, two
    calls the same bits, within rtol 1e-5 (atol 1e-5; the f32 sum bound
    on the skew stream) of its plain version; then b2_step's times, bound
    and library yardstick, with --b2-parent the parent tree's kernel in
    the same call. -> [a row a stream]"""
    import torch
    from raw_ngp_torch.kernels import segsum as ts
    rows = []
    for C, M, B, n_rows, what in streams:
        for skew in (False, True):
            stream, packed = _outer_stream(dev, M, B, n_rows, C, skew)
            keys_s, perm, w_word, g_words = packed[:4]
            flat = ts.segment_grad_outer(*stream, g_col=C)
            flat_2 = ts.segment_grad_outer(*stream, g_col=C)
            oracle = ts.combine_totals_plain(
                ts.segment_totals_outer(*stream, g_col=C),
                torch.empty(n_rows * C, device=dev))
            flat_p = ts.segment_grad_outer_plain(*packed)
            torch.cuda.synchronize()
            label = f"segment_grad_outer C={C} skew={skew}"
            check(same_bits(flat, oracle), f"{label}: differs in its bits "
                  "from segment_totals_outer + combine_totals_plain")
            check(same_bits(flat, flat_2), f"{label}: two calls differ")
            prod = ts._outer_products(perm, w_word, g_words, C)
            mass = torch.zeros(n_rows, 2 * C, device=dev).index_add_(
                0, keys_s.long(), prod.abs())
            flat_mass = (mass[:, :C] + torch.cat(
                [mass.new_zeros(1, C), mass[:-1, C:]])).reshape(-1)
            err = float((flat - flat_p).abs().max())
            ok = (within_sum_error(flat, flat_p, flat_mass, 1e-5) if skew
                  else torch.allclose(flat, flat_p, rtol=1e-5, atol=1e-5))
            check(ok, f"{label}: max abs err {err} exceeds the bound")
            call = dict(keys=keys_s, perm=perm, w_word=w_word, g=stream[3],
                        n_rows=n_rows, C=C, g_col=C)
            row = dict(C=C, records=M, points=B, rows=n_rows, skew=skew,
                       shape=what, max_abs_err=err,
                       **b2_step([call], b2_parent(), reps=20))
            print(f"[segsum] flat form at C = {C}, {what}, skew={skew}: "
                  f"bitwise equal to the 2C totals + combine_totals_plain "
                  f"and between two calls; {json.dumps(row)}")
            rows.append(row)
    return rows


def ray_points(B, gen, dev, per_ray=32):
    """B points in ray order, as the compaction leaves them: B / per_ray
    rays from random points in [0.1, 0.9]^3 in random directions, samples
    0.004 apart (32 samples span 2-4 cells of the res-16 level)."""
    import torch
    n = B // per_ray
    o = torch.rand(n, 3, generator=gen, device=dev) * 0.8 + 0.1
    d = torch.randn(n, 3, generator=gen, device=dev)
    d = d / d.norm(dim=-1, keepdim=True)
    t = torch.arange(per_ray, device=dev) * 0.004
    return (o[:, None] + t[None, :, None] * d[:, None]).reshape(-1, 3) \
        .clamp(0.0, 1.0).contiguous()


def dense_products(x01, g, spec, bf16):
    """The dense level's exact products rnd(wyz) * rnd(g * rnd(wx)) per
    in-bounds point and lane (8 a point: [n, C] f32), their flat table
    rows [n], their absolute-sum ``mass`` per entry, and the number of
    nonzero lane products this input needs (clamped lanes weigh 0)."""
    import torch
    from raw_ngp_torch.kernels import hash_encode as th
    from raw_ngp_torch.kernels.segsum import round_bf16
    res, C = spec.resolutions[0], spec.level_dim
    rnd = round_bf16 if bf16 else (lambda t: t)
    inb, xs = th._in_bounds(x01)
    lanes = [th._mm_lanes(*th._corner_axis(x[inb], res, spec), res)
             for x in xs]
    gl = rnd(g[inb, :C].float())
    (cx, ax, px), (cy, ay, py), (cz, az, pz) = lanes
    rows, prods = [], []
    for i in range(8):
        xi, yi, zi = i & 1, (i >> 1) & 1, i >> 2
        rows.append(cx[xi] + res * (cy[yi] + res * cz[zi]))
        w = rnd(az[zi] * ay[yi])
        prods.append(w[:, None] * rnd(gl * rnd(ax[xi])[:, None]))
    rows, prods = torch.cat(rows), torch.cat(prods)
    mass = torch.zeros(res ** 3, C, device=x01.device).index_add_(
        0, rows, prods.abs())
    n_terms = int(((1 + px.long()) * (1 + py.long()) * (1 + pz.long()))
                  .sum())
    return rows, prods, mass, n_terms * C


def dense_rows_agree(out, ref_total, mass, bf16):
    """The dense-row rule: the kernel's totals before rounding lie within
    rtol 1e-5 plus 2^-20 of the entry's absolute mass of the exact f32
    total (the f32 sum order; atomics vary it between runs); under bf16
    the output is then a rounding of a value in that band (equal to the
    plain version's or one bf16 ulp from it)."""
    from raw_ngp_torch.kernels.segsum import round_bf16
    err = 1e-5 * ref_total.abs() + 2.0 ** -20 * mass
    if not bf16:
        return bool(((out - ref_total).abs() <= err).all())
    return bool(((out >= round_bf16(ref_total - err))
                 & (out <= round_bf16(ref_total + err))).all())


# the stages of mm_grad_table, of the radix sort and of B2 by kernel name;
# every other launch of either is counted apart
SORT_STAGES = (("radix_histogram_kernel", "sort"),
               ("radix_pass_kernel", "sort"))
DENSE_STAGES = (("cell_keys_kernel", "keys"),
                ("cell_sums_kernel", "cell_sums"),
                ("cell_edge_group_kernel", "group_sums"),
                ("cell_edge_fixup_kernel", "fixup"),
                ("cell_gather_kernel", "gather")) + SORT_STAGES
SEGSUM_STAGES = (("segsum_outer_kernel", "main"),
                 ("segsum_edge_group_kernel", "group_sums"),
                 ("segsum_edge_fixup_kernel", "fixup"))
# (the 2C mode's kernels, which the flat form at C = 32 and an older
# tree's flat form launch too, then the flat form's own)
FLAT_STAGES = SEGSUM_STAGES + (("segsum_flat_walk_kernel", "main"),
                               ("segsum_flat_fixup_kernel", "fixup"),
                               ("segsum_flat_join_kernel", "join"))


def stage_split(prof, stages, rest):
    """Device ms a call spends in each stage, from a profile_device of it:
    each kernel whose name holds a stage's kernel name counts there, every
    other one under `rest`."""
    out = {v: 0.0 for _, v in stages}
    out[rest] = 0.0
    for k in prof.get("top_kernels", ()):
        stage = next((v for n, v in stages if n in k["name"]), rest)
        out[stage] += k["ms_per_call"]
    return out


def device_launches(fn, reps, expected=None, tries=4):
    """torch.profiler windows over `reps` calls of fn (after a warm-up
    call): (device ms a call, kernel launches a call). In a long run the
    profiler now and then drops a window's device events, whole or in
    part: a window short of `expected` launches a call is taken again (up
    to `tries`); without `expected` the fuller of two windows is kept.
    (None, None) where no window caught a device event."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    best = (None, None)
    for i in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        got = (sum(e.self_device_time_total for e in kernels) / reps / 1e3,
               sum(e.count for e in kernels) / reps)
        if kernels and (best[1] is None or got[1] > best[1]):
            best = got
        if best[1] is not None and (best[1] == expected
                                    or (expected is None and i >= 1)):
            break
    return best


def library_sort(keys, offset):
    """The library yardstick of the radix sort: the calls it replaced,
    the subtraction, torch.sort(stable=True) and the narrowing to int32."""
    import torch
    ks, perm = torch.sort(keys - offset, stable=True)
    return ks, perm.to(torch.int32)


def sort_stream_checks(streams, what, reps=10):
    """The radix sort on each (label, keys, bits, offset) stream:
    (keys_sorted, perm) bit for bit torch.sort(keys - offset, stable=True)
    with int32 indices and the plain version's, two calls alike, no key
    outside the range, at most 3 launches a call for bits <= 20; its time
    (CUDA events and profiler device time) beside the library yardstick's
    (library_sort), the plain version's and its byte bound (12 B a
    record: the key read, the sorted key and its index written). Returns
    {"streams": [rows], "summed": the rows' sums, "checks_s": the seconds
    these checks took}."""
    import torch
    from raw_ngp_torch.kernels.sort import (digit_passes, sort_keys,
                                            sort_keys_plain)
    t_checks = time.perf_counter()
    rows = []
    for label, keys, bits, off in streams:
        M = keys.numel()
        ks, perm, oor = sort_keys(keys, bits, off, out_of_range=True)
        again = sort_keys(keys, bits, off)
        ref = library_sort(keys, off)
        plain = sort_keys_plain(keys, bits, off)
        torch.cuda.synchronize()
        check(all(same_bits(a, b) for a, b in zip((ks, perm), ref)),
              f"{what} sort {label}: differs from torch.sort(stable=True)")
        check(all(same_bits(a, b) for a, b in zip((ks, perm), plain)),
              f"{what} sort {label}: differs from its plain version")
        check(all(same_bits(a, b) for a, b in zip((ks, perm), again)),
              f"{what} sort {label}: two calls differ")
        check(int(oor) == 0, f"{what} sort {label}: {int(oor)} keys outside "
              f"[0, 2^{bits})")
        del ks, perm, again, ref, plain

        def run(keys=keys, bits=bits, off=off):
            return sort_keys(keys, bits, off)

        def lib(keys=keys, off=off):
            return library_sort(keys, off)

        dev_ms, launches = device_launches(
            run, 3, expected=1 + len(digit_passes(bits)))
        lib_dev, lib_launches = device_launches(lib, 3)
        bound = 12 * M / HBM_BYTES_PER_S * 1e3
        row = dict(stream=label, keys=M, bits=bits, offset=off,
                   ms=time_ms(run, reps), device_ms=dev_ms,
                   launches_per_call=launches,
                   plain_ms=time_ms(lambda: sort_keys_plain(keys, bits, off),
                                    1, warmup=1),
                   library_ms=time_ms(lib, reps), library_device_ms=lib_dev,
                   library_launches_per_call=lib_launches, bound_ms=bound,
                   bound_by="bytes", max_abs_err=0.0, out_of_range=0)
        check(launches is None or bits > 20 or launches <= 3,
              f"{what} sort {label}: {launches} launches a call")
        rows.append(row)
        print(f"[{what}] sort {label}: {M} keys, {bits} bits, bit for bit "
              f"torch.sort and the plain version, two calls alike, none out "
              f"of range; {json.dumps(row)}")

    def total(key):
        vals = [r[key] for r in rows]
        return None if any(v is None for v in vals) else sum(vals)

    summed = {k: total(k) for k in ("keys", "ms", "device_ms",
                                    "launches_per_call", "plain_ms",
                                    "library_ms", "library_device_ms",
                                    "library_launches_per_call",
                                    "bound_ms")}
    summed.update(streams=len(rows), bound_by="bytes", max_abs_err=0.0)
    seconds = time.perf_counter() - t_checks
    print(f"[{what}] sorts summed over {len(rows)} streams: "
          f"{json.dumps(summed)}; the checks took {seconds:.1f} s")
    return {"streams": rows, "summed": summed, "checks_s": seconds}


def captured_sorts(tr, batch, grid_names, **loss_kw):
    """The streams every sort_keys call of one loss and backward on `batch`
    sorts (the kernel path; the gradients cleared after): [(label, keys,
    bits, offset)], the label naming the grid (`grid_names`: [(spec,
    name)]) and its level, dense or window."""
    from raw_ngp_torch.kernels import hash_encode as th
    from raw_ngp_torch.train.trainer import make_batch_loss_fn
    loss_fn = make_batch_loss_fn(tr.cfg, tr.spec)
    where = {}
    calls = []
    sort, table_grad, mm_level = th.sort_keys, th.table_grad, th.mm_grad_level

    def capture(keys, bits, offset=0, **kwargs):
        spec = where.get("spec")
        name = next((n for s, n in grid_names if s == spec), "grid")
        part = (f"dense level {where['dense']}" if "dense" in where
                else f"window level {spec.offsets.index(offset)}")
        calls.append((f"{name} {part}", keys.clone(), bits, offset))
        return sort(keys, bits, offset, **kwargs)

    def grad_capture(spec, *args, **kwargs):
        where["spec"] = spec
        return table_grad(spec, *args, **kwargs)

    def level_capture(x01, g, spec, lv, *args, **kwargs):
        where["dense"] = lv
        try:
            return mm_level(x01, g, spec, lv, *args, **kwargs)
        finally:
            del where["dense"]

    capture.launches = 0
    th.sort_keys, th.table_grad, th.mm_grad_level = (capture, grad_capture,
                                                     level_capture)
    try:
        loss, _ = loss_fn(tr.field, tr.state, batch, tr.aabb, None,
                          **loss_kw)
        loss.backward()
    finally:
        th.sort_keys, th.table_grad, th.mm_grad_level = (sort, table_grad,
                                                         mm_level)
        for p in tr.field.parameters():
            p.grad = None
        if tr.state.pose_params is not None:
            tr.state.pose_params.grad = None
    return calls


SORT_EDGE_SIZES = (1, 8191, 8192, 8193, 3 * 8192 + 5, 1 << 22)
SORT_EDGE_BITS = (1, 13, 19, 31)
SORT_EDGE_KINDS = ("random", "all_equal", "descending", "runs")


def sort_edge_keys(kind, M, bits, gen, dev):
    """The edge cases' keys (all in [0, 2^bits)): uniform, one value, a
    descending ramp, runs of 1-40 equal keys."""
    import torch
    top = (1 << bits) - 1
    if kind == "random":
        return torch.randint(0, top + 1, (M,), generator=gen, device=dev,
                             dtype=torch.int64).to(torch.int32)
    if kind == "all_equal":
        return torch.full((M,), top // 3, dtype=torch.int32, device=dev)
    if kind == "descending":
        step = max(top // M, 1)
        return ((torch.arange(M - 1, -1, -1, device=dev) * step) % (top + 1)
                ).to(torch.int32)
    values = torch.randint(0, top + 1, (M // 10 + 1,), generator=gen,
                           device=dev, dtype=torch.int64)
    lengths = torch.randint(1, 41, (M // 10 + 1,), generator=gen,
                            device=dev)
    return torch.repeat_interleave(values, lengths)[:M].to(torch.int32)


def phase_sort(dev):
    """The radix sort on its edge cases at the card's sizes: 1 key,
    around the 8,192-key tile (one less, one, one more, three and a
    partial one) and 4,194,304 keys (an -O2 proposal grid's window level:
    4 windows x 4,096 rays x 256 samples); uniform keys, one value (equal
    keys straddling every tile edge), a descending ramp, runs of 1-40; 1
    bit, 13 (a dense level's cells, two passes), 19 (a window level's
    rows) and 31 (four passes, an even count; 1 and 13 one and two): each
    bit for bit torch.sort(keys - offset, stable=True) with int32
    indices and its plain version, two calls alike (the tickets and
    status words zeroed again by each call's first kernel), the
    out-of-range count 0; keys outside the range counted and sorted as
    the plain version sorts them; an empty stream launches nothing.
    Returns the `kernels` entry's frame (numbers come from the training
    phases' streams)."""
    import torch
    from raw_ngp_torch.kernels.sort import (out_of_range_plain, sort_keys,
                                            sort_keys_plain)
    gen = torch.Generator(device=dev).manual_seed(21)
    n = 0
    for M in SORT_EDGE_SIZES:
        for bits in SORT_EDGE_BITS:
            for kind in SORT_EDGE_KINDS:
                off = 12345 if bits < 31 else -3
                keys = sort_edge_keys(kind, M, bits, gen, dev) + off
                got = [sort_keys(keys, bits, off, out_of_range=True)
                       for _ in range(2)]
                ref = library_sort(keys, off)
                plain = sort_keys_plain(keys, bits, off)
                torch.cuda.synchronize()
                for ks, perm, oor in got:
                    check(same_bits(ks, ref[0]) and same_bits(perm, ref[1])
                          and same_bits(ks, plain[0])
                          and same_bits(perm, plain[1]) and int(oor) == 0,
                          f"sort {kind} M={M} bits={bits}: differs from "
                          f"torch.sort or its plain version, or counts "
                          f"{int(oor)} keys out of range")
                n += 1
    for bits in (9, 13, 19):
        keys = torch.randint(-50, (1 << bits) + 50, (3 * 8192 + 7,),
                             generator=gen, device=dev, dtype=torch.int32)
        ks, perm, oor = sort_keys(keys, bits, out_of_range=True)
        pk, pp = sort_keys_plain(keys, bits)
        torch.cuda.synchronize()
        check(same_bits(ks, pk) and same_bits(perm, pp)
              and int(oor) == int(out_of_range_plain(keys, bits)) > 0,
              f"sort: keys outside {bits} bits sorted or counted otherwise")
    before = sort_keys.launches
    empty = sort_keys(torch.empty(0, dtype=torch.int32, device=dev), 13)
    check(sort_keys.launches == before and all(t.numel() == 0
                                               for t in empty),
          "sort: an empty stream launched or returned keys")
    print(f"[sort] {n} edge cases (sizes {SORT_EDGE_SIZES}, bits "
          f"{SORT_EDGE_BITS}, {SORT_EDGE_KINDS}) bit for bit torch.sort and "
          f"the plain version, two calls alike, none out of range; keys "
          f"outside the range counted; an empty stream launches nothing")
    return dict(name="sort_keys", route="cuda",
                source="raw_ngp_torch/csrc/radix_sort.cu",
                replaces="raw_ngp_tpu/kernels/hash_fused.py:659",
                deterministic=True,
                edge_cases=dict(cases=n, sizes=SORT_EDGE_SIZES,
                                bits=SORT_EDGE_BITS, kinds=SORT_EDGE_KINDS))


def phase_encode_bwd(dev, spec, B=262144):
    """The encode forward's records mode, then the table gradient. The
    records (uniform and ray-ordered points, f32 and bf16): bit for bit
    window_records_plain, the output bit for bit the forward's without
    records, two calls the same bits; the forward timed with and without
    them. The table gradient, kernel path against plain path (same
    inputs), then its time in bf16 (the flagship's compute dtype), the
    window levels' part (the sort and B2's flat form reading g in place)
    and the dense level's gradient on its own (with index_add_ of its
    exact products as the library yardstick). Returns the `kernels`
    entries of the records mode and of the dense level, and the table
    gradient's numbers."""
    import torch
    from raw_ngp_torch.kernels import hash_encode as th
    from raw_ngp_torch.kernels.sort import sort_keys
    gen = torch.Generator(device=dev).manual_seed(4)
    table = (torch.rand(spec.n_params * spec.level_dim, generator=gen,
                        device=dev) * 2 - 1) * 1e-2
    inputs = {"uniform": torch.rand(B, 3, generator=gen, device=dev),
              "ray": ray_points(B, gen, dev)}
    inputs["uniform"][:64] = inputs["uniform"][:64] * 3.0 - 1.0
    inputs["uniform"][64:72, 1] = float("nan")
    cot = torch.randn(B, spec.output_dim, generator=gen, device=dev)
    res, C = spec.resolutions[0], spec.level_dim
    n_dense = spec.offsets[th.matmul_split(spec)] * C
    check(n_dense == spec.offsets[1] * C, "encode_bwd: the flagship grid "
          "should have one dense level")
    m = th.matmul_split(spec)
    P = sum(nw for _, _, nw in th.level_windows(spec, m))
    bf16 = torch.bfloat16

    # the forward's records mode, against the plain records and the
    # forward without records, then both forwards timed
    records = {}
    for kind, x01 in inputs.items():
        base_p, w_word_p = th.window_records_plain(x01, spec)
        for dtype in (torch.float32, bf16):
            name = str(dtype)[6:]
            out, base, w_word = th.hash_encode_records(table, x01, spec,
                                                       dtype)
            again = th.hash_encode_records(table, x01, spec, dtype)
            plain_out = th.hash_encode(table, x01, spec, dtype)
            torch.cuda.synchronize()
            check(torch.equal(base, base_p) and torch.equal(w_word, w_word_p),
                  f"encode_bwd records {kind} {name}: the records differ "
                  "from window_records_plain")
            check(same_bits(out, plain_out), f"encode_bwd records {kind} "
                  f"{name}: the output differs from the forward without "
                  "records")
            check(all(same_bits(a, b) for a, b in zip((out, base, w_word),
                                                      again)),
                  f"encode_bwd records {kind} {name}: two calls differ")

            def with_rec(x01=x01, dtype=dtype):
                return th.hash_encode_records(table, x01, spec, dtype)

            def without(x01=x01, dtype=dtype):
                return th.hash_encode(table, x01, spec, compute_dtype=dtype)

            bound_ms, bound_by, n_bytes, rows = encode_bound(
                spec, x01, 2 if dtype == bf16 else 4, extra_bytes=8 * P * B)
            row = dict(ms=time_ms(with_rec, 50), device_ms=device_ms(with_rec),
                       without_records_ms=time_ms(without, 50),
                       without_records_device_ms=device_ms(without),
                       bound_ms=bound_ms, bound_by=bound_by, bytes=n_bytes)
            records[(kind, name)] = row
            print(f"[encode_bwd] forward with records {kind} B={B} {name}: "
                  f"records bit for bit window_records_plain, output bit for "
                  f"bit the forward without records, two calls bitwise "
                  f"equal; {row['ms']:.4f} ms (device {row['device_ms']} ms) "
                  f"against {row['without_records_ms']:.4f} ms (device "
                  f"{row['without_records_device_ms']} ms) without records; "
                  f"bound {bound_ms * 1e3:.2f} us ({bound_by}: touched rows "
                  f"{rows}, {n_bytes} bytes)")
    x01 = inputs["uniform"]
    rec_plain_ms = time_ms(lambda: (
        th.hash_encode_fused_plain(table, x01, spec, bf16),
        th.window_records_plain(x01, spec)), 3)
    top = records[("uniform", "bfloat16")]
    k_records = dict(name="hash_encode_records", route="cuda",
                     source="raw_ngp_torch/csrc/hash_encode.cu",
                     replaces="raw_ngp_tpu/kernels/hash_fused.py:513",
                     max_abs_err=0.0, ms=top["ms"],
                     device_ms=top["device_ms"], plain_ms=rec_plain_ms,
                     bound_ms=top["bound_ms"], bound_by=top["bound_by"],
                     library_ms=None,
                     without_records_ms=top["without_records_ms"],
                     without_records_device_ms=top[
                         "without_records_device_ms"],
                     inputs={f"{k} {n}": v for (k, n), v in records.items()},
                     deterministic=True)

    errs = {}
    for kind, x01 in inputs.items():
        for dtype in (torch.float32, torch.bfloat16):
            grads = []
            for fn in (th.hash_encode, th.hash_encode_plain):
                p = table.clone().requires_grad_()
                (fn(p, x01, spec, compute_dtype=dtype).float() * cot
                 ).sum().backward()
                grads.append(p.grad)
            bf16 = dtype == torch.bfloat16
            rows, prods, mass, _ = dense_products(x01, cot.to(dtype), spec,
                                                  bf16)
            total = torch.zeros_like(mass).index_add_(0, rows, prods)
            torch.cuda.synchronize()
            nr = res ** 3 * C
            dense_ok = (dense_rows_agree(grads[0][:nr], total.reshape(-1),
                                         mass.reshape(-1), bf16)
                        and bool((grads[0][nr:n_dense] == 0).all()))
            scale = float(grads[1].abs().max())
            err_d = float((grads[0][:n_dense] - grads[1][:n_dense]).abs()
                          .max())
            err_w = float((grads[0][n_dense:] - grads[1][n_dense:]).abs()
                          .max())
            check(scale > 0 and dense_ok and torch.allclose(
                grads[0][n_dense:], grads[1][n_dense:], rtol=1e-5,
                atol=1e-6 * scale),
                f"encode_bwd {kind} {dtype}: dense rows ok {dense_ok}, "
                f"dense err {err_d}, window err {err_w} (scale {scale})")
            errs[(kind, dtype)] = (err_d, err_w)
            print(f"[encode_bwd] {kind} {str(dtype)[6:]}: dense rows within "
                  f"the rule (max abs err to plain {err_d:.3e}), window rows "
                  f"max abs err {err_w:.3e} of largest {scale:.3e} (rtol "
                  f"1e-5, atol 1e-6 x largest): ok")

    bf16 = torch.bfloat16
    x01 = inputs["uniform"]
    g = cot.to(bf16)
    _, base, w_word = th.hash_encode_records(table, x01, spec, bf16)
    base_p, w_word_p = th.window_records_plain(x01, spec)

    def kernel_path():
        return th.table_grad(spec, x01, base, w_word, g, bf16)

    def plain_path():
        return th.table_grad(spec, x01, base_p, w_word_p, g, bf16, plain=True)

    check(same_bits(kernel_path(), kernel_path()),
          "encode_bwd: two calls of the table gradient differ")
    ms = time_ms(kernel_path, 20)
    prof = profile_device(kernel_path, 20, "call")
    dev_ms = prof.get("device_busy_ms_per_call")
    plain_ms = time_ms(plain_path, 3)
    n_aten = aten_ops(kernel_path)
    lv, w0, nw = th.level_windows(spec, m)[-1]
    keys, off = base[w0:w0 + nw].reshape(-1), spec.offsets[lv]
    bits = (spec.offsets[lv + 1] - off - 1).bit_length()
    window_sort_ms = time_ms(lambda: sort_keys(keys, bits, off), 20)
    n_bytes = (B * 3 * 4 + B * spec.output_dim * 2
               + spec.n_params * spec.level_dim * 4)
    n_ops = 2 * 8 * spec.level_dim * spec.num_levels * B
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = n_ops / F32_FLOP_PER_S * 1e3
    print(f"[encode_bwd] B={B} bf16: table gradient {ms:.4f} ms "
          f"(device {dev_ms} ms, {prof.get('kernel_launches_per_call')} "
          f"device launches and {n_aten} aten ops a call), "
          f"plain {plain_ms:.4f} ms; "
          f"the radix sort of the level-{lv} keys ({keys.numel()}, "
          f"{bits} bits) {window_sort_ms:.4f} "
          f"ms; {n_bytes} bytes ({bytes_ms * 1e3:.2f} us), {n_ops} flop "
          f"({ops_ms * 1e3:.2f} us)")
    print(f"[encode_bwd] profile of one call: {json.dumps(prof)}")
    # the dense level alone, on both inputs: two calls bitwise equal, then
    # its time, the device time of each stage (the keys, the radix sort,
    # the cell sums, the edge fix-up, the gather) and the sort alone on
    # CUDA events
    out = torch.empty(n_dense, device=dev)
    dense = {}
    for kind, xk in inputs.items():
        first = th.mm_grad_table(xk, g, spec, bf16)
        second = th.mm_grad_table(xk, g, spec, bf16)
        torch.cuda.synchronize()
        check(same_bits(first, second),
              f"mm_grad_table {kind}: two calls differ")
        rows, prods, _, n_terms = dense_products(xk, g, spec, True)
        acc = torch.empty(res ** 3, C, device=dev)
        mm_ms = time_ms(lambda: th.mm_grad_table(xk, g, spec, bf16, out=out),
                        50)
        mm_prof = profile_device(
            lambda: th.mm_grad_table(xk, g, spec, bf16, out=out), 20, "call")
        mm_dev = mm_prof.get("device_busy_ms_per_call")
        keys = th.dense_cell_keys(xk, spec, 0).to(torch.int32)
        sort_ms = time_ms(lambda: sort_keys(keys, (res ** 3).bit_length()),
                          50)
        lib_ms = time_ms(lambda: acc.zero_().index_add_(0, rows, prods), 20)
        lib_dev = device_ms(lambda: acc.zero_().index_add_(0, rows, prods))
        mm_plain = time_ms(lambda: th.mm_grad_table_plain(xk, g, spec, bf16),
                           5)
        nb = B * 3 * 4 + B * C * 2 + n_dense * 4
        b_ms, o_ms = (nb / HBM_BYTES_PER_S * 1e3,
                      2 * n_terms / F32_FLOP_PER_S * 1e3)
        dense[kind] = dict(ms=mm_ms, device_ms=mm_dev, plain_ms=mm_plain,
                           library_ms=lib_ms, library_device_ms=lib_dev,
                           bound_ms=max(b_ms, o_ms),
                           bound_by="bytes" if b_ms >= o_ms else "operations",
                           bytes=nb, flop=2 * n_terms,
                           stages_device_ms=stage_split(
                               mm_prof, DENSE_STAGES, "other"),
                           sort_ms=sort_ms,
                           device_launches_per_call=mm_prof.get(
                               "kernel_launches_per_call"))
        print(f"[encode_bwd] dense level ({kind} points) bf16: two calls "
              f"bitwise equal; kernels {mm_ms:.4f} ms (device {mm_dev} ms, "
              f"{dense[kind]['device_launches_per_call']} device launches: "
              f"{json.dumps(dense[kind]['stages_device_ms'])}), the radix "
              f"sort alone {sort_ms:.4f} ms, plain (matmul) {mm_plain:.4f} ms, "
              f"zero_ + index_add_ of the exact products {lib_ms:.4f} ms "
              f"(device {lib_dev} ms); {nb} bytes ({b_ms * 1e3:.2f} us), "
              f"{2 * n_terms} flop ({o_ms * 1e3:.2f} us)")
    mm_k = dict(name="mm_grad_table", route="cuda",
                source="raw_ngp_torch/csrc/hash_grad.cu",
                replaces="raw_ngp_tpu/kernels/hash_fused.py:349",
                max_abs_err=errs[("uniform", bf16)][0],
                max_abs_err_ray=errs[("ray", bf16)][0],
                library="zero_ + index_add_ of the exact products",
                ray_ordered=dense["ray"], deterministic=True,
                **dense["uniform"])

    # the window levels' part: the path less the dense level (its device
    # time measured alone on the same input: its stages share the radix
    # sort's kernels with the window levels' sort); its bound reads x01
    # and the window levels' g and writes their rows
    window_dev = (None if dev_ms is None or dense["uniform"]["device_ms"]
                  is None else dev_ms - dense["uniform"]["device_ms"])
    window_bound = (B * 12 + B * (spec.num_levels - m) * C * 2
                    + (spec.n_params - spec.offsets[m]) * C * 4
                    ) / HBM_BYTES_PER_S * 1e3
    window_lib = window_library(spec, base, w_word, g)
    print(f"[encode_bwd] window levels' part: device {window_dev} ms, bound "
          f"{window_bound * 1e3:.2f} us (bytes); zero_ + index_add_ of its "
          f"rounded products {window_lib['ms']:.4f} ms (device "
          f"{window_lib['device_ms']} ms)")
    whole = dict(what="the table gradient (table_grad) without the "
                      "records, which the forward writes",
                 replaces="raw_ngp_tpu/kernels/hash_fused.py:756",
                 max_abs_err=max(errs[("uniform", bf16)]),
                 max_abs_err_f32=max(errs[("uniform", torch.float32)]),
                 ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                 bound_ms=max(bytes_ms, ops_ms),
                 bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                 sort_ms=window_sort_ms,
                 device_launches_per_call=prof.get(
                     "kernel_launches_per_call"),
                 aten_ops_per_call=n_aten,
                 window_part_device_ms=window_dev,
                 window_part_bound_ms=window_bound,
                 window_part_library_ms=window_lib["ms"],
                 window_part_library_device_ms=window_lib["device_ms"],
                 window_part_library=window_lib["library"],
                 top_kernels=prof.get("top_kernels"), deterministic=True)

    return k_records, mm_k, whole


def window_library(spec, base, w_word, g):
    """The library yardstick of the table gradient's window part: one
    zero_ + index_add_ into the window levels' flat rows of the bf16-rounded
    products w0 g (into row key) and w1 g (into row key + 1, dropped past
    its level's last row) of every record, unsorted as the forward writes
    them. The products and rows are made before the timing, as B2's own
    yardstick's are. Returns its time (CUDA events) and device time."""
    import torch
    from raw_ngp_torch.kernels import hash_encode as th
    from raw_ngp_torch.kernels.segsum import round_bf16, unpack_bf16_pairs
    C = spec.level_dim
    m = th.matmul_split(spec)
    first = spec.offsets[m]
    rows, prods = [], []
    for lv, w0, nw in th.level_windows(spec, m):
        keys = base[w0:w0 + nw].reshape(-1).long()
        wa, wb = unpack_bf16_pairs([w_word[w0:w0 + nw].reshape(-1)], 2)
        g_lv = g[:, lv * C:(lv + 1) * C].float().repeat(nw, 1)
        keep = keys + 1 < spec.offsets[lv + 1]
        rows += [keys - first, (keys + 1 - first)[keep]]
        prods += [round_bf16(wa[:, None] * g_lv),
                  round_bf16(wb[:, None] * g_lv)[keep]]
    rows, prods = torch.cat(rows), torch.cat(prods)
    flat = torch.empty(spec.n_params - first, C, device=g.device)

    def call():
        return flat.zero_().index_add_(0, rows, prods)

    return {"ms": time_ms(call, 20), "device_ms": device_ms(call),
            "products": int(rows.numel()),
            "library": "zero_ + index_add_ of the window levels' bf16-rounded "
                       "products from the unsorted records into rows key "
                       "and key + 1"}


def aten_ops(fn):
    """The aten operators one call of fn dispatches (torch.profiler, CPU
    activity): the host-side count that launches follow."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return sum(e.count for e in prof.key_averages()
               if e.key.startswith("aten::"))


def touched_rows(spec, x01):
    """Distinct table rows the in-bounds points of x01 read (8 corners a
    level), and the number of in-bounds points."""
    import torch
    from raw_ngp_torch.ops.hashgrid import _level_indices
    inb = ((x01 >= 0) & (x01 <= 1)).all(-1)
    xin = x01[inb]
    rows = 0
    for lv in range(spec.num_levels):
        res = spec.resolutions[lv]
        pos = torch.clamp(xin * res - 0.5, 0.0, res - 1)
        g = torch.floor(pos).to(torch.int64)
        corners = torch.stack([torch.clamp_max(
            g + torch.tensor([(c >> d) & 1 for d in range(3)],
                             device=x01.device), res - 1)
            for c in range(8)], dim=1)
        rows += int(torch.unique(_level_indices(spec, lv, corners)).numel())
    return rows, int(inb.sum())


def phase_encode_input(dev, cfg, B=262144):
    """The encode's input gradient at the flagship shape: kernel against
    plain version at uniform and ray-ordered points, f32 and bf16 (two
    calls bitwise equal), each timed beside its own bound."""
    import torch
    from raw_ngp_torch.kernels import hash_encode as th
    from raw_ngp_torch.models.ngp import make_field_spec
    spec = make_field_spec(cfg).grid_spec
    L, C = spec.num_levels, spec.level_dim
    gen = torch.Generator(device=dev).manual_seed(7)
    table = (torch.rand(spec.n_params * C, generator=gen, device=dev) * 2
             - 1) * 1e-2
    inputs = encode_inputs(cfg, gen, dev, B, kinds=("uniform", "ray"))
    cot = torch.randn(B, L * C, generator=gen, device=dev)
    per_input = {}
    for kind, x01 in inputs.items():
        per_input[kind] = {}
        outside = ~((x01 >= 0) & (x01 <= 1)).all(-1)      # NaN rows too
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype)[6:]
            g = cot.to(dtype)
            k = th.encode_input_grad(table, x01, g, spec, dtype)
            k2 = th.encode_input_grad(table, x01, g, spec, dtype)
            p = th.encode_input_grad_plain(table, x01, g, spec, dtype)
            torch.cuda.synchronize()
            scale = float(p.abs().max())
            err = float((k - p).abs().max())
            check(scale > 0 and bool((k[outside] == 0).all())
                  and torch.equal(k.view(torch.int32), k2.view(torch.int32))
                  and torch.allclose(k, p, rtol=1e-5, atol=1e-5 * scale),
                  f"encode_input {kind} {name}: max abs err {err} (scale "
                  f"{scale}), or two calls differ")

            def call(x01=x01, g=g, dtype=dtype):
                return th.encode_input_grad(table, x01, g, spec, dtype)

            ms, dev_ms = time_ms(call, 50), device_ms(call)
            # g in, grad_x [B, 3] out; products and sums, 8 corners
            bound_ms, bound_by, n_bytes, rows = encode_bound(
                spec, x01, 2 if dtype == torch.bfloat16 else 4,
                extra_bytes=B * 12, ops_per_term=4)
            per_input[kind][name] = dict(
                max_abs_err=err, scale=scale, ms=ms, device_ms=dev_ms,
                bound_ms=bound_ms, bound_by=bound_by, bytes=n_bytes,
                touched_rows=rows)
            print(f"[encode_input] {kind} B={B} {name}: max abs err "
                  f"{err:.3e} of largest {scale:.3e} (rtol 1e-5 of the "
                  f"largest), two calls bitwise equal; kernel {ms:.4f} ms "
                  f"(device {dev_ms} ms), bound {bound_ms * 1e3:.2f} us "
                  f"({bound_by}: touched rows {rows}, {n_bytes} bytes)")
    bf16 = torch.bfloat16
    x01, g = inputs["uniform"], cot.to(bf16)
    plain_ms = time_ms(
        lambda: th.encode_input_grad_plain(table, x01, g, spec, bf16), 3)
    top = per_input["uniform"]["bfloat16"]
    print(f"[encode_input] uniform B={B} bf16 plain {plain_ms:.4f} ms")
    return dict(name="encode_input_grad", route="cuda",
                source="raw_ngp_torch/csrc/hash_encode.cu",
                replaces="raw_ngp_tpu/kernels/hash_fused.py:760",
                max_abs_err=top["max_abs_err"],
                max_abs_err_f32=per_input["uniform"]["float32"]["max_abs_err"],
                ms=top["ms"], device_ms=top["device_ms"], plain_ms=plain_ms,
                bound_ms=top["bound_ms"], bound_by=top["bound_by"],
                library_ms=None, inputs=per_input, deterministic=True)


def _channel_stream(dev, M, n_rows, n_chan, skew):
    import torch
    from raw_ngp_torch.kernels import segsum as ts
    gen = torch.Generator(device=dev).manual_seed(8)
    keys = torch.randint(0, n_rows, (M,), generator=gen, device=dev,
                         dtype=torch.int32)
    if skew:        # a dense level's funnel: 90% of records into one row
        keys = torch.where(torch.rand(M, generator=gen, device=dev) < 0.9,
                           7, keys).to(torch.int32)
    keys_s, _ = torch.sort(keys)
    vals = torch.randn(n_chan, M, generator=gen, device=dev)
    return (keys_s.to(torch.int32).contiguous(),
            torch.stack(ts.pack_bf16_pairs(list(vals))).contiguous())


def phase_segsum_channel(dev, M=1 << 20, n_rows=1 << 19, n_chan=32):
    """B2's channel mode at the level-1 shape against its plain version."""
    import torch
    from raw_ngp_torch.kernels import segsum as ts
    errs = {}
    for skew, rtol in ((False, 1e-5), (True, 1e-5)):
        keys_s, packed = _channel_stream(dev, M, n_rows, n_chan, skew)
        k = ts.segment_totals(keys_s, packed, n_rows, n_chan)
        k2 = ts.segment_totals(keys_s, packed, n_rows, n_chan)
        p = ts.segment_totals_plain(keys_s, packed, n_rows, n_chan)
        torch.cuda.synchronize()
        check(same_bits(k, k2),
              f"segsum_channel skew={skew}: two calls differ")
        empty = torch.ones(n_rows, dtype=torch.bool, device=dev)
        empty[keys_s.long()] = False
        check(bool((k[empty] == 0).all()),
              "segsum_channel: an empty row is not 0")
        err = float((k - p).abs().max())
        vals = torch.stack(ts.unpack_bf16_pairs(list(packed), n_chan), 1)
        mass = torch.zeros_like(p).index_add_(0, keys_s.long(), vals.abs())
        ok = (within_sum_error(k, p, mass, rtol) if skew
              else torch.allclose(k, p, rtol=rtol, atol=1e-5))
        check(ok, f"segsum_channel skew={skew}: max abs err {err} exceeds "
                  f"the bound (rtol {rtol})")
        errs[skew] = err
        print(f"[segsum_channel] M={M} rows={n_rows} n_chan={n_chan} "
              f"skew={skew}: max abs err {err:.3e} (rtol {rtol}, atol "
              f"1e-5), two calls bitwise equal: ok")
    keys_s, packed = _channel_stream(dev, M, n_rows, n_chan, False)
    ms = time_ms(lambda: ts.segment_totals(keys_s, packed, n_rows, n_chan),
                 50)
    dev_ms = device_ms(lambda: ts.segment_totals(keys_s, packed, n_rows,
                                                 n_chan))
    plain_ms = time_ms(lambda: ts.segment_totals_plain(
        keys_s, packed, n_rows, n_chan), 5)
    vals = torch.stack(ts.unpack_bf16_pairs(list(packed), n_chan), dim=1)
    keys64 = keys_s.long()
    out = torch.empty(n_rows, n_chan, device=dev)
    library_ms = time_ms(lambda: out.zero_().index_add_(0, keys64, vals), 20)
    n_bytes = 4 * M + 4 * packed.shape[0] * M + 4 * n_rows * n_chan
    n_ops = n_chan * M
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = n_ops / F32_FLOP_PER_S * 1e3
    print(f"[segsum_channel] kernel {ms:.4f} ms (zero fill included; "
          f"device {dev_ms} ms), plain "
          f"{plain_ms:.4f} ms, index_add_ of the values {library_ms:.4f} ms; "
          f"{n_bytes} bytes ({bytes_ms * 1e3:.2f} us)")
    return dict(name="segment_totals_channel", route="cuda",
                source="raw_ngp_torch/csrc/segsum.cu",
                replaces="raw_ngp_tpu/kernels/segsum_pallas.py:182",
                max_abs_err=errs[False], max_abs_err_skew=errs[True], ms=ms,
                device_ms=dev_ms, plain_ms=plain_ms,
                bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                library_ms=library_ms,
                library="index_add_ of the unpacked values",
                on_main_path=False, deterministic=True)


def sphere_bitfield(cfg, dev):
    """packbits of a density grid that occupies the bench scene's three
    spheres (world positions of the cell centers, per cascade)."""
    import torch
    from raw_ngp_torch.data.synthetic import _SPHERES
    from raw_ngp_torch.ops.grid import packbits
    from raw_ngp_torch.ops.morton import morton3d
    n = cfg.render.grid_size
    ar = torch.arange(n, device=dev)
    xyz = torch.stack(torch.meshgrid(ar, ar, ar, indexing="ij"),
                      -1).reshape(-1, 3)
    code = morton3d(xyz)
    spheres = torch.as_tensor(_SPHERES, dtype=torch.float32, device=dev)
    dg = torch.zeros(cfg.cascades, n ** 3, device=dev)
    for cas in range(cfg.cascades):
        cas_bound = min(2 ** cas, cfg.grid_bound)
        p = (2.0 * xyz.float() / (n - 1) - 1.0) * (cas_bound - cas_bound / n)
        d = torch.linalg.norm(p[:, None, :] - spheres[None, :, :3], dim=-1)
        inside = (d < spheres[None, :, 3] + 2.0 * cas_bound / n).any(-1)
        dg[cas, code] = torch.where(inside, 100.0, 0.0)
    return packbits(dg, cfg.render.density_thresh)


def flagship_config():
    from raw_ngp_torch import Config
    cfg = Config().with_preset_O().with_tpu_profile()
    cfg = replace(cfg, train=replace(cfg.train, fp16=True, num_rays=8192))
    return cfg.validate()


def phase_slice(dev, cfg, small=128, large=512):
    import torch
    from raw_ngp_torch.data import make_synthetic_scene
    from raw_ngp_torch.models.ngp import init_field, make_field_spec
    from raw_ngp_torch.ops.rays import full_image_rays
    from raw_ngp_torch.render.eval import (coarse_volume, make_eval_render,
                                           render_image, scene_aabb)

    spec = make_field_spec(cfg)
    gs = spec.grid_spec
    print(f"[slice] flagship: {gs.num_levels} levels x {gs.level_dim} ch, "
          f"table {gs.n_params} rows, res {gs.resolutions}, S=K="
          f"{cfg.render.samples_per_ray}, probes {cfg.render.coarse_probes}, "
          f"grid {cfg.render.grid_size} x {cfg.cascades} cascades, chunk "
          f"{cfg.render.max_ray_batch}")
    field = init_field(spec, seed=0, device=dev)
    bitfield = sphere_bitfield(cfg, dev)
    _, val = make_synthetic_scene(n_train=36, n_val=2, H=128, W=128)
    aabb = scene_aabb(cfg, val.pts_aabb, device=dev)
    pose = val.poses[0]
    intr = val.intrinsics
    intr_l = intr * (large / 128.0)
    intr_s = intr * (small / 128.0)
    bits = (bitfield[:, None].to(torch.int32)
            >> torch.arange(8, device=dev)) & 1
    occupied = float(bits.float().mean())
    print(f"[slice] bitfield {bitfield.numel()} bytes, occupied share "
          f"{occupied:.4f}")

    # the serving path, with every launch counter reset just before it
    counters = _counters()
    torch.cuda.synchronize()
    for c in counters.values():
        c.launches = 0
    rgb_s, d_s = render_image(field, bitfield, pose, intr_s, small, small,
                              aabb, device=dev)
    rgb_l, d_l = render_image(field, bitfield, pose, intr_l, large, large,
                              aabb, device=dev)
    torch.cuda.synchronize()
    launches = {k: c.launches for k, c in counters.items()}
    print(f"[slice] launches on the serving path: {launches}")
    for name in ("decimate_compact", "hash_encode"):
        check(launches[name] > 0, f"slice: kernel {name} was never launched")
    check(launches["decimate_compact_bwd"] == 0, f"slice: the fold's "
          f"backward launched {launches['decimate_compact_bwd']} times")
    for name, t, shape in (("rgb small", rgb_s, (small, small, 3)),
                           ("depth small", d_s, (small, small)),
                           ("rgb large", rgb_l, (large, large, 3)),
                           ("depth large", d_l, (large, large))):
        check(tuple(t.shape) == shape, f"slice: {name} shape {t.shape}")
        check(bool(torch.isfinite(t).all()), f"slice: {name} not finite")
    hit = float((d_l > 0).float().mean())
    print(f"[slice] {small}x{small} rgb mean {float(rgb_s.mean()):.6f}; "
          f"{large}x{large} rgb mean {float(rgb_l.mean()):.6f}, depth>0 on "
          f"{hit:.4f} of pixels")
    check(hit > 0.05, "slice: the render sees none of the occupied spheres")

    # one chunk (the large image's middle rows) against the plain path
    rays_o, rays_d = full_image_rays(
        torch.as_tensor(pose, device=dev), torch.as_tensor(intr_l,
                                                           device=dev),
        large, large)
    n = min(cfg.render.max_ray_batch, large * large)
    s = (large * large - n) // 2
    ro, rd = rays_o[s:s + n], rays_d[s:s + n]
    coarse = coarse_volume(cfg, bitfield)
    out_k = make_eval_render(cfg)(field, bitfield, ro, rd, aabb, coarse)
    out_p = make_eval_render(cfg, plain=True)(field, bitfield, ro, rd, aabb,
                                              coarse)
    chunk_err = render_agrees(out_k, out_p, ("image", "depth", "weights_sum"),
                              "slice")
    print(f"[slice] chunk kernel-vs-plain max abs err {chunk_err}")

    # render timing of the large image: host clock around each of `reps`
    # synchronized whole-image renders (the render is host-bound, so the
    # spread is reported with the median)
    render_image(field, bitfield, pose, intr_l, large, large, aabb,
                 device=dev)
    reps = 7
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        render_image(field, bitfield, pose, intr_l, large, large, aabb,
                     device=dev)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    img_ms = sorted(times)[reps // 2]
    n_chunks = -(-large * large // cfg.render.max_ray_batch)
    render = {"image": f"{large}x{large}", "chunks": n_chunks,
              "chunk_rays": cfg.render.max_ray_batch,
              "ms_per_image": img_ms, "ms_per_image_runs": times,
              "ms_per_chunk": img_ms / n_chunks,
              "rays_per_s": large * large / (img_ms / 1e3),
              "chunk_max_abs_err_vs_plain": chunk_err,
              "profile": profile_chunk(cfg, field, bitfield, ro, rd, aabb,
                                       coarse)}
    return launches, render


def profile_chunk(cfg, field, bitfield, ro, rd, aabb, coarse, reps=3):
    """Where one chunk's time goes: torch.profiler over `reps` chunk
    renders."""
    from raw_ngp_torch.render.eval import make_eval_render
    render = make_eval_render(cfg)
    return profile_device(
        lambda: render(field, bitfield, ro, rd, aabb, coarse), reps, "chunk")


def profile_device(fn, reps, unit, tries=3):
    """torch.profiler over `reps` calls of fn (after one warm-up call): the
    device kernels by total time and the device's busy share of the
    host-clock window, per `unit`. A profile that caught no device event
    (it happens now and then on the card) is taken again, up to `tries`
    times."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        events = prof.key_averages()
        kernels = [e for e in events
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        busy_us = sum(e.self_device_time_total for e in kernels)
        if busy_us > 0:
            break
    else:
        return {"device_time": "not measured (no device events)"}
    runtime = {name: sum(e.count for e in events if e.key == name) / reps
               for name in ("cudaMemcpyAsync", "cudaStreamSynchronize",
                            "cudaDeviceSynchronize", "cudaLaunchKernel")}
    top = sorted(kernels, key=lambda e: e.self_device_time_total,
                 reverse=True)[:12]
    return {f"{unit}s": reps, f"wall_ms_per_{unit}": wall_us / reps / 1e3,
            f"device_busy_ms_per_{unit}": busy_us / reps / 1e3,
            "device_idle_share": max(0.0, 1.0 - busy_us / wall_us),
            f"kernel_launches_per_{unit}":
                sum(e.count for e in kernels) / reps,
            f"htod_copies_per_{unit}":
                sum(e.count for e in kernels if "HtoD" in e.key) / reps,
            f"runtime_calls_per_{unit}": runtime,
            "top_kernels": [{"name": e.key[:70], "calls": e.count // reps,
                             f"ms_per_{unit}":
                                 e.self_device_time_total / reps / 1e3}
                            for e in top]}


def profile_full(fn, reps, launches, tries=4):
    """profile_device of fn a call, taken again (up to `tries` times)
    while the profiler dropped device events: a window short of
    `launches` kernel launches a call."""
    best = {}
    for _ in range(tries):
        prof = profile_device(fn, reps, "call")
        got = prof.get("kernel_launches_per_call") or 0
        if got >= (best.get("kernel_launches_per_call") or 0):
            best = prof
        if got >= launches:
            break
    return best


def _counters():
    from raw_ngp_torch.kernels.compact import (decimate_compact,
                                               decimate_compact_bwd)
    from raw_ngp_torch.kernels.hash_encode import (encode_input_grad,
                                                   encode_input_jvp,
                                                   hash_encode,
                                                   hash_encode_records,
                                                   mm_grad_table)
    from raw_ngp_torch.kernels.segsum import (segment_grad_outer,
                                              segment_totals,
                                              segment_totals_outer)
    from raw_ngp_torch.kernels.sort import sort_keys
    return {"decimate_compact": decimate_compact,
            "decimate_compact_bwd": decimate_compact_bwd,
            "hash_encode": hash_encode,
            "hash_encode_records": hash_encode_records,
            "segment_grad_outer": segment_grad_outer,
            "segment_totals": segment_totals_outer,
            "encode_input_grad": encode_input_grad,
            "encode_input_jvp": encode_input_jvp,
            "segment_totals_channel": segment_totals,
            "mm_grad_table": mm_grad_table,
            "sort_keys": sort_keys}


def check_sort_launches(launches, what):
    """The table gradient sorts once a B2 flat-form call (a window level)
    and once a dense level, through the radix sort and nothing else."""
    want = launches["segment_grad_outer"] + launches["mm_grad_table"]
    check(launches["sort_keys"] == want, f"{what}: the radix sort launched "
          f"{launches['sort_keys']} times, B2's flat form and the dense "
          f"level {want}")


# the kernels each path must launch, and those it must not: the forward
# writes the records, B2's flat form reads g in place and writes the
# window rows, so its 2C totals are off the path
TRAIN_KERNELS = ("decimate_compact", "hash_encode", "hash_encode_records",
                 "segment_grad_outer", "mm_grad_table")
OFF_PATH_KERNELS = ("segment_totals",)
POSE_KERNELS = TRAIN_KERNELS + ("decimate_compact_bwd", "encode_input_grad")


def step_breakdown(tr, reps=5):
    """Where a train step's time goes: the stages of Trainer.step run one
    by one, each ended by a synchronize, on the host clock (median of
    `reps` steps, ms), plus one grid refresh and coarse-volume rebuild
    (every update_extra_interval steps) on its own where there is a grid
    (not on the proposal path). Under pose refinement the sample stage
    composes the noise and refinements, and the pose optimizer is a stage
    of its own. A light-stage scene's exposures and light directions ride
    in the batch."""
    import torch
    from raw_ngp_torch.data.sampler import sample_ray_batch
    from raw_ngp_torch.render.eval import coarse_volume
    from raw_ngp_torch.train.trainer import annealing_at, make_batch_loss_fn
    loss_fn = make_batch_loss_fn(tr.cfg, tr.spec)
    sa, st = tr.scene_arrays, tr.state
    pose = st.pose_params
    names = ("sample", "render_and_loss", "backward", "adam_ema")
    stages = {k: [] for k in names + (("pose_adam",) if pose is not None
                                      else ())}

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        stages[name].append((time.perf_counter() - t0) * 1e3)
        return out

    for _ in range(reps):
        torch.cuda.synchronize()
        batch = timed("sample", lambda: sample_ray_batch(
            tr.generator, sa["images"], sa["poses"], sa["intrinsics"],
            tr.num_rays, random_image_batch=tr.cfg.train.random_image_batch,
            se3_refine=pose, pose_noise=st.pose_noise,
            exposures=sa.get("exposures"), ldirs=sa.get("ldirs"),
            cam_near_far=sa.get("cam_near_far"),
            mosaiced=tr.cfg.data.mosaiced))
        if "coarse_lin" in sa:
            batch["coarse_lin"] = sa["coarse_lin"]
        for p in st.params.values():
            p.grad = None
        if pose is not None:
            pose.grad = None
        loss, _ = timed("render_and_loss", lambda: loss_fn(
            tr.field, st, batch, tr.aabb, tr.generator,
            point_budget=tr._point_budget,
            annealing=annealing_at(tr.cfg, st.step)))
        timed("backward", loss.backward)
        grads = {k: p.grad for k, p in st.params.items()}
        timed("adam_ema", lambda: tr.net_tx.update_apply(
            grads, st.opt_state, st.params, st.ema_params))
        if pose is not None:
            timed("pose_adam", lambda: tr.pose_tx.update_apply(
                pose.grad, st.pose_opt_state, pose.data))
    out = {k: sorted(v)[reps // 2] for k, v in stages.items()}
    if tr._grid_update is None:
        return out
    t0 = time.perf_counter()
    tr._grid_update(tr.field, st.grid_state(), tr.host_grid_updates,
                    tr.generator)
    coarse_volume(tr.cfg, st.density_bitfield)
    torch.cuda.synchronize()
    out["grid_refresh"] = (time.perf_counter() - t0) * 1e3
    out["grid_refresh_per_step"] = (out["grid_refresh"]
                                    / tr.cfg.render.update_extra_interval)
    return out


def training_tensors(tr):
    """Copies of what training steps leave behind: params, EMA, Adam
    moments, the density grid and, under pose refinement, the pose params
    and their moments."""
    st = tr.state
    out = {}
    for name, tensors in (("param", st.params), ("ema", st.ema_params),
                          ("mu", st.opt_state.mu), ("nu", st.opt_state.nu)):
        for k, t in tensors.items():
            out[f"{name}.{k}"] = t.detach().clone()
    if st.density_grid is not None:
        out["density_grid"] = st.density_grid.clone()
    if st.pose_params is not None:
        out["pose"] = st.pose_params.detach().clone()
        out["pose.mu"] = st.pose_opt_state.mu["pose"].clone()
        out["pose.nu"] = st.pose_opt_state.nu["pose"].clone()
    return out


def graphed_tensors(tr):
    """training_tensors plus the density bitfield and the generators'
    states: what the chained run must leave as the eager steps do."""
    out = training_tensors(tr)
    if tr.state.density_bitfield is not None:
        out["density_bitfield"] = tr.state.density_bitfield.clone()
    out["generator"] = tr.generator.get_state()
    if tr.batch_generator is not tr.generator:
        out["batch_generator"] = tr.batch_generator.get_state()
    return out


def trainer_snapshot(tr):
    """Everything Trainer.step reads and changes, taken before a step: the
    training tensors and the grid state, the optimizers' counts, the step
    and host counters, the coarse cache and the generators' states (on a
    mesh the batch stream is the dp row's own)."""
    st = tr.state
    coarse = tr.scene_arrays.get("coarse_lin")
    return {"tensors": training_tensors(tr),
            "grid": {k: v.clone() for k, v in st.grid_state().items()
                     if v is not None},
            "counts": (st.opt_state.count,
                       None if st.pose_opt_state is None
                       else st.pose_opt_state.count),
            "step": st.step,
            "host": (tr.host_step, tr.host_grid_updates, tr._pts_ema,
                     tr._point_budget, tr.num_rays, tr._adapt_stash,
                     tr._metrics, tr._train_step),
            "coarse": None if coarse is None else coarse.clone(),
            "generator": tr.generator.get_state(),
            "batch_generator": tr.batch_generator.get_state()}


def trainer_restore(tr, snap):
    """Puts the Trainer back to `snap` (trainer_snapshot), in place: into
    the state's own buffers and the cached coarse volume, which a
    captured step reads."""
    import torch
    st, t = tr.state, snap["tensors"]
    with torch.no_grad():
        for name, tensors in (("param", st.params), ("ema", st.ema_params),
                              ("mu", st.opt_state.mu),
                              ("nu", st.opt_state.nu)):
            for k, v in tensors.items():
                v.copy_(t[f"{name}.{k}"])
        if st.pose_params is not None:
            st.pose_params.copy_(t["pose"])
            st.pose_opt_state.mu["pose"].copy_(t["pose.mu"])
            st.pose_opt_state.nu["pose"].copy_(t["pose.nu"])
        for k, v in snap["grid"].items():
            getattr(st, k).copy_(v)
        if snap["coarse"] is None:
            # a fresh Trainer's: its first step's refresh writes the cache
            # before anything reads it, so the live one (whose buffer a
            # graph may read) stays
            pass
        elif "coarse_lin" in tr.scene_arrays:
            tr.scene_arrays["coarse_lin"].copy_(snap["coarse"])
        else:
            tr.scene_arrays["coarse_lin"] = snap["coarse"].clone()
    st.opt_state.count = snap["counts"][0]
    if st.pose_opt_state is not None:
        st.pose_opt_state.count = snap["counts"][1]
    st.step = snap["step"]
    (tr.host_step, tr.host_grid_updates, tr._pts_ema, tr._point_budget,
     tr.num_rays, tr._adapt_stash, tr._metrics, tr._train_step) = snap["host"]
    tr.generator.set_state(snap["generator"])
    tr.batch_generator.set_state(snap["batch_generator"])


def bit_diff(now, ref):
    """{name: max abs diff} of the tensors of `ref` whose bits `now`
    does not hold."""
    return {k: float((now[k].double() - v.double()).abs().max())
            for k, v in ref.items() if not same_bits(now[k], v)}


# each run_steps' eager numbers by its `what`: the step ms and the peak
# device memory, which the dispatch report sets beside the graphed run's
EAGER_RUNS = {}


def repro_check(tr, snap, ref, steps, what):
    """The repro check. On one card through the chained path: the Trainer
    put back to `snap` (taken before step 1), `steps` steps through
    Trainer.train at the default chain length (CUDA-graph replays) and
    what they leave (graphed_tensors) compared bit for bit with `ref`,
    the eager steps' after the same steps; then the same again, bitwise
    equal to the first graphed run; then dispatch_report. A mesh's
    Trainer (no graphs: its gloo collectives stay eager) reruns its
    steps eagerly. -> (repro, dispatch)."""
    import torch
    trainer_restore(tr, snap)
    if tr._graphs is None:
        for _ in range(steps):
            tr.step()
        torch.cuda.synchronize()
        diff = bit_diff(graphed_tensors(tr), ref)
        differ = f"; max abs diff {json.dumps(diff)}" if diff else ""
        print(f"[{what}] repro: {steps} eager steps again from the state "
              f"before step 1: {len(ref) - len(diff)} of {len(ref)} "
              f"tensors bitwise equal to the first run's{differ}")
        check(not diff, f"{what}: training did not reproduce at a fixed "
              f"seed")
        return ({"steps": steps, "grid_refreshes": tr.host_grid_updates,
                 "tensors": sorted(ref), "bitwise_equal": not diff},
                {"chained": False, "why": "a mesh: gloo collectives are "
                 "host calls a CUDA graph cannot hold, so every step runs "
                 "eagerly"})
    graphs = tr._graphs
    captured = len(graphs.captures)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    walls, runs = [], []
    for run in range(2):
        trainer_restore(tr, snap)
        graphs.record = [] if run == 1 else None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr.train(steps, log_every=10 ** 9)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        runs.append(graphed_tensors(tr))
    diff = bit_diff(runs[0], ref)
    again = bit_diff(runs[1], runs[0])
    differ = f"; max abs diff {json.dumps(diff)}" if diff else ""
    print(f"[{what}] repro: {steps} steps again from the state before step "
          f"1 through Trainer.train, chains of {tr.steps_per_dispatch()} "
          f"CUDA-graph replays ({tr.host_grid_updates} grid refreshes): "
          f"{len(ref) - len(diff)} of {len(ref)} tensors bitwise equal to "
          f"the eager steps'{differ}; a second graphed run "
          f"{len(ref) - len(again)} of {len(ref)} bitwise equal to the "
          f"first")
    check(not diff, f"{what}: the graphed steps differ from the eager "
          f"steps in {sorted(diff)}")
    check(not again, f"{what}: two graphed runs differ in {sorted(again)}")
    repro = {"steps": steps, "grid_refreshes": tr.host_grid_updates,
             "tensors": sorted(ref), "bitwise_equal": not diff,
             "path": "Trainer.train, chained (CUDA-graph replays)",
             "second_graphed_run_bitwise_equal": not again}
    return repro, dispatch_report(tr, what, steps, walls, captured)


def _refresh_if_due(tr):
    """The refresh a step at tr.host_step would run first, run now."""
    cfg = tr.cfg
    if (cfg.render.occupancy
            and tr.host_step % cfg.render.update_extra_interval == 0):
        tr._refresh()


def _profiled_dispatch(tr, n, chained):
    """n steps as one dispatch (chained: the graph's replays; else eager
    steps) under torch.profiler, the refresh due before them run outside
    it -> (host-clock wall us, the device's kernel events)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    _refresh_if_due(tr)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tr._metrics = tr._dispatch(n, chained)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    tr.host_step += n
    return wall_us, [e for e in prof.key_averages()
                     if e.device_type == torch.autograd.DeviceType.CUDA]


def hand_kernel_launches(kernels, n=1):
    """{CUDA_KERNELS name: device launches a step} of profiler events."""
    from raw_ngp_torch.kernels import kernel_of
    out = {}
    for e in kernels:
        name = kernel_of(e.key)
        if name is not None:
            out[name] = out.get(name, 0) + e.count / n
    return out


def profile_chain(tr, tries=3):
    """One eager step, then one whole chain of replays, each under
    torch.profiler (a refresh due before either left out): the chain's
    busy share of the host-clock window (unclamped: a busy time above the
    wall shows as a share above 1), its kernels a step, and each
    hand-written kernel's device launches a step in the chain beside the
    eager step's, which the caller holds equal (the replays launch what
    the eager step launches). The profiler now and then drops a window's
    device events (device_launches), so a pair whose counts differ is
    taken again, up to `tries` pairs."""
    cfg = tr.cfg
    interval = cfg.render.update_extra_interval
    for attempt in range(1, tries + 1):
        eager_us, eager_kernels = _profiled_dispatch(tr, 1, False)
        n = tr.steps_per_dispatch()
        if cfg.render.occupancy:
            n = min(n, interval - tr.host_step % interval)
        wall_us, kernels = _profiled_dispatch(tr, n, True)
        launches = {"chain_per_step": hand_kernel_launches(kernels, n),
                    "eager_step": hand_kernel_launches(eager_kernels),
                    "pairs_profiled": attempt}
        if (launches["eager_step"]
                and launches["chain_per_step"] == launches["eager_step"]):
            break
    busy_us = sum(e.self_device_time_total for e in kernels)
    if busy_us <= 0:
        return {"steps": n, "wall_ms": wall_us / 1e3,
                "device_time": "not measured (no device events)",
                "hand_kernel_launches": launches}
    top = sorted(kernels, key=lambda e: e.self_device_time_total,
                 reverse=True)[:12]
    return {"steps": n, "wall_ms": wall_us / 1e3,
            "wall_ms_per_step": wall_us / n / 1e3,
            "device_busy_ms_per_step": busy_us / n / 1e3,
            "device_busy_share": busy_us / wall_us,
            "device_idle_share": 1.0 - busy_us / wall_us,
            "kernel_launches_per_step":
                sum(e.count for e in kernels) / n,
            "hand_kernel_launches": launches,
            "eager_step_wall_ms": eager_us / 1e3,
            "top_kernels": [{"name": e.key[:70], "calls": e.count / n,
                             "ms_per_step":
                                 e.self_device_time_total / n / 1e3}
                            for e in top]}


def sync_calls_of_step(tr):
    """The synchronizing CUDA calls of one eager train step (the refresh
    due before it run first, outside the check) under
    torch.cuda.set_sync_debug_mode: their count and where each was
    made."""
    import warnings
    import torch
    _refresh_if_due(tr)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            tr._metrics = tr._dispatch(1, False)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    tr.host_step += 1
    torch.cuda.synchronize()
    syncs = [f"{os.path.basename(w.filename)}:{w.lineno}: "
             f"{str(w.message)[:80]}" for w in caught
             if "called a synchronizing CUDA operation" in str(w.message)]
    return {"count": len(syncs), "calls": syncs}


def dispatch_report(tr, what, steps, walls, captured):
    """The phase line's `dispatch`: the chain length, the graphs captured
    (keys, seconds), graphed ms/step (CUDA events around each chain of
    the second graphed run / its replays, each sample listed) beside the
    eager ms/step over the same steps, the peak device memory of the
    eager and the graphed runs, one profiled chain's busy and idle share
    and its hand-written kernels' device launches a step (must equal an
    eager step's), and the synchronizing calls of one eager step (must
    be 0)."""
    import torch
    graphs = tr._graphs
    samples = [(r.n, r.start.elapsed_time(r.end) / r.n)
               for r in graphs.record]
    graphs.record = None
    peak = {"graphed_allocated_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "graphed_reserved_gib": torch.cuda.max_memory_reserved() / 2 ** 30}
    eager = EAGER_RUNS.get(what, {})
    peak.update({k: v for k, v in eager.items() if k.endswith("_gib")})
    per_step = sorted(ms for _, ms in samples)
    eager_ms = eager.get("step_ms", [])[:steps]
    out = {"chained": True,
           "chain_length": tr.steps_per_dispatch(),
           "graphs_captured": graphs.captures[captured:],
           "graphs_held": [list(k) for k in graphs.graphs],
           "capture_s": sum(c["seconds"] for c in graphs.captures[captured:]),
           "graphed_ms_per_step": (per_step[len(per_step) // 2]
                                   if per_step else None),
           "graphed_ms_per_step_samples": samples,
           "eager_ms_per_step_same_steps": (sorted(eager_ms)[len(eager_ms) // 2]
                                            if eager_ms else None),
           "wall_s": {"graphed_runs": walls,
                      "eager_same_steps": sum(eager_ms) / 1e3},
           # the second graphed run (no capture) on the host clock, its
           # refreshes included, as the eager steps' events include them
           "graphed_wall_ms_per_step": walls[1] / steps * 1e3,
           "peak_memory": peak}
    out["profile_chain"] = chain = profile_chain(tr)
    out["sync_calls_eager_step"] = sync_calls_of_step(tr)
    print(f"[{what}] dispatch: chains of {out['chain_length']}, graphed "
          f"{out['graphed_ms_per_step']} ms/step against eager "
          f"{out['eager_ms_per_step_same_steps']} over the same steps; "
          f"captures {out['graphs_captured']}; peak memory {peak}; chain "
          f"profile {out['profile_chain']}; synchronizing calls of an "
          f"eager step {out['sync_calls_eager_step']}")
    launches = chain["hand_kernel_launches"]
    check(launches["chain_per_step"] == launches["eager_step"]
          and launches["eager_step"],
          f"{what}: the chain's replays launched the hand-written kernels "
          f"{launches['chain_per_step']} times a step on the card, an eager "
          f"step {launches['eager_step']}")
    check(out["sync_calls_eager_step"]["count"] == 0,
          f"{what}: an eager step made synchronizing calls: "
          f"{out['sync_calls_eager_step']['calls']}")
    return out


def forced_key_check(tr, snap, steps=32):
    """The adaptive-batch key changed by hand: from `snap`, _adapt_batch
    fed a stash of few live points (num_rays grows, the point budget
    shrinks: a new key, a new graph), then `steps` eager steps against
    `steps` steps through Trainer.train from the same state, bitwise."""
    import torch
    trainer_restore(tr, snap)
    before = (tr.num_rays, tr._point_budget)
    tr._adapt_batch({"num_points": 100.0, "num_points_raw": 100.0})
    key = (tr.num_rays, tr._point_budget)
    check(key != before and tr.num_rays > before[0],
          f"forced key: _adapt_batch left the key at {key}")
    snap2 = trainer_snapshot(tr)
    for _ in range(steps):
        tr.step()
    torch.cuda.synchronize()
    eager = graphed_tensors(tr)
    trainer_restore(tr, snap2)
    captured = len(tr._graphs.captures)
    tr.train(steps, log_every=10 ** 9)
    torch.cuda.synchronize()
    diff = bit_diff(graphed_tensors(tr), eager)
    print(f"[O] forced key change {before} -> {key}: {steps} graphed steps "
          f"{len(eager) - len(diff)} of {len(eager)} tensors bitwise equal "
          f"to {steps} eager steps; captures "
          f"{tr._graphs.captures[captured:]}")
    check(not diff, f"O: after the key change the graphed steps differ "
          f"from the eager ones in {sorted(diff)}")
    return {"key_before": list(before), "key": [key[0], key[1]],
            "steps": steps, "bitwise_equal": not diff,
            "graphs_captured": tr._graphs.captures[captured:],
            "graphs_held": [list(k) for k in tr._graphs.graphs]}


def key_sweep_memory(tr, snap, chain=16):
    """The memory of a graphed run that crosses several adaptive-batch
    keys: from `snap`, _adapt_batch fed three stashes of few live points
    (num_rays doubles to its cap, the point budget halves toward its
    floor), then one of many (the budget grows back), each followed by
    `chain` steps through Trainer.train (its own refreshes may move the
    key again). -> the keys crossed and those captured (a key whose graph
    is held already is not captured again), the graphs held at the end
    (the last key's alone), the reserved memory after each chain and the
    peak allocated / reserved of the sweep, beside the eager run's
    peak."""
    import torch
    trainer_restore(tr, snap)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    captured = len(tr._graphs.captures)
    few = {"num_points": 100.0, "num_points_raw": 100.0}
    many = {"num_points": 1e9, "num_points_raw": 1e9}
    reserved = []
    for stash in (few, few, few, many):
        tr._adapt_batch(stash)
        tr.train(chain, log_every=10 ** 9)
        torch.cuda.synchronize()
        reserved.append({"key": [tr.num_rays, tr._point_budget],
                         "reserved_gib": torch.cuda.memory_reserved()
                         / 2 ** 30})
    caps = tr._graphs.captures[captured:]
    crossed = [r["key"] for r in reserved]
    out = {"keys_crossed": crossed,
           "keys_captured": [c["key"] for c in caps],
           "capture_s": [c["seconds"] for c in caps],
           "graphs_held": [list(k) for k in tr._graphs.graphs],
           "reserved_after_each_chain": reserved,
           "peak_allocated_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "peak_reserved_gib": torch.cuda.max_memory_reserved() / 2 ** 30,
           "eager_run": {k: v for k, v in EAGER_RUNS.get("O", {}).items()
                         if k.endswith("_gib")}}
    print(f"[O] key sweep: {json.dumps(out)}")
    check(len({tuple(k) for k in crossed}) >= 3
          and out["graphs_held"] == [crossed[-1]],
          f"O: the key sweep crossed {crossed} and holds "
          f"{out['graphs_held']}")
    return out


# launches a step of the kernels each train step must launch an exact
# number of times: on the occupancy path one forward with records and one
# backward, one dense and one window level on the flagship grid
OCCUPANCY_PER_STEP = {"hash_encode_records": 1, "mm_grad_table": 1,
                      "segment_grad_outer": 1}


def run_steps(tr, steps, kernels, what, capture_at=None,
              per_step=OCCUPANCY_PER_STEP):
    """`steps` Trainer steps with every launch counter reset just before
    and read just after; checks that each of `kernels` launched, that each
    kernel of `per_step` launched exactly that many times a step, that
    the losses are finite and fall (last 8 below the first 8) and that
    the params and EMA are finite. Returns (launches, losses, step ms,
    the training_tensors after `capture_at` steps)."""
    import torch
    from raw_ngp_torch.kernels.hash_encode import hash_encode
    from raw_ngp_torch.ops.grid import _CHUNK
    counters = _counters()
    # the encode's launches inside the grid refreshes, counted around them
    refresh = {"calls": 0, "encode_launches": 0}
    update = tr._grid_update

    def counted_update(*args, **kwargs):
        before = hash_encode.launches
        out = update(*args, **kwargs)
        refresh["calls"] += 1
        refresh["encode_launches"] += hash_encode.launches - before
        return out

    if update is not None:
        tr._grid_update = counted_update
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in counters.values():
        c.launches = 0
    events = [torch.cuda.Event(enable_timing=True) for _ in range(steps + 1)]
    losses = []
    captured = None
    t0 = time.perf_counter()
    try:
        for i in range(steps):
            events[i].record()
            losses.append(tr.step()["loss"])
            if i + 1 == capture_at:
                captured = graphed_tensors(tr)
        events[steps].record()
        torch.cuda.synchronize()
    finally:
        tr._grid_update = update
    wall_s = time.perf_counter() - t0
    launches = {k: c.launches for k, c in counters.items()}
    if tr.cfg.render.occupancy:
        points = tr._point_budget or tr.base_point_budget()
    else:   # a forward with records a level, N * T points each
        points = [tr.num_rays * t for t in tr.cfg.render.num_steps]
    by_caller = {
        "train_forwards": launches["hash_encode_records"],
        "other_forwards_without_records":
            launches["hash_encode"] - refresh["encode_launches"],
        "train_forward_points": points,
        "refresh_chunks": refresh["encode_launches"],
        "refresh_chunk_points": _CHUNK, "refreshes": refresh["calls"]}
    print(f"[{what}] {steps} steps in {wall_s:.2f} s, "
          f"{tr.host_grid_updates} grid refreshes; launches {launches}; "
          f"encode launches by caller {by_caller}")
    launches["hash_encode_by_caller"] = by_caller
    for name in kernels:
        check(launches[name] > 0, f"{what}: kernel {name} was never launched")
    for name in OFF_PATH_KERNELS:
        check(launches[name] == 0, f"{what}: kernel {name} is off the path "
              f"but launched {launches[name]} times")
    for name, n in per_step.items():
        check(launches[name] == n * steps, f"{what}: kernel {name} "
              f"launched {launches[name]} times in {steps} steps, not "
              f"{n} a step")
    check_sort_launches(launches, what)
    loss = torch.stack(losses).float().cpu()
    check(bool(torch.isfinite(loss).all()), f"{what}: a loss is not finite")
    first, last = float(loss[:8].mean()), float(loss[-8:].mean())
    print(f"[{what}] loss mean of the first 8 steps {first:.6f}, of the "
          f"last 8 {last:.6f}")
    check(last < first, f"{what}: the loss did not fall")
    for kind, tensors in (("params", tr.state.params),
                          ("ema", tr.state.ema_params)):
        for k, t in tensors.items():
            check(bool(torch.isfinite(t).all()),
                  f"{what}: {kind} {k} not finite")
    step_ms = [events[i].elapsed_time(events[i + 1]) for i in range(steps)]
    EAGER_RUNS[what] = {
        "step_ms": step_ms,
        "eager_allocated_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
        "eager_reserved_gib": torch.cuda.max_memory_reserved() / 2 ** 30}
    return launches, (first, last), step_ms, captured


def evaluate_counted(tr):
    """The val PSNR (EMA) and the encode launches of that evaluation."""
    from raw_ngp_torch.kernels.hash_encode import hash_encode
    before = hash_encode.launches
    psnr = tr.evaluate()["psnr"]
    return psnr, hash_encode.launches - before


def fixed_batch_check(tr, batch_fn, what, annealing=1.0, grad_tol=5e-2,
                      generator_fn=lambda: None, loss_fn=None):
    """One step on a fixed batch (march jitter 0.5, or the draws of the
    generator `generator_fn` makes anew for each side), kernel path
    against plain path: the same points, loss within 1e-2 relative and
    every gradient leaf (the pose refinements' too) within `grad_tol` of
    its largest entry. bf16 encode outputs may round one ulp apart between
    the kernel and the plain version (f32 sum order), which the bf16 MLPs
    and their bf16-rounded gradients carry into every leaf. `loss_fn`
    (default make_batch_loss_fn's) takes (field, state, batch, aabb,
    generator, plain=, annealing=) and returns (loss, aux)."""
    from raw_ngp_torch.train.trainer import make_batch_loss_fn
    loss_fn = loss_fn or make_batch_loss_fn(tr.cfg, tr.spec)
    leaves = dict(tr.field.named_parameters())
    if tr.state.pose_params is not None:
        leaves["pose"] = tr.state.pose_params
    out = {}
    for plain in (False, True):
        for p in leaves.values():
            p.grad = None
        batch = batch_fn()
        l, aux = loss_fn(tr.field, tr.state, batch, tr.aabb, generator_fn(),
                         plain=plain, annealing=annealing)
        l.backward()
        out[plain] = (float(l.detach()), int(aux["num_points"]),
                      {k: p.grad.clone() for k, p in leaves.items()
                       if p.grad is not None})
    for p in leaves.values():
        p.grad = None
    loss_err = abs(out[False][0] - out[True][0]) / abs(out[True][0])
    grad_err = {k: float((g - out[True][2][k]).abs().max()
                         / out[True][2][k].abs().max().clamp_min(1e-30))
                for k, g in out[False][2].items() if k in out[True][2]}
    print(f"[{what}] fixed batch, kernel vs plain: loss {out[False][0]:.6f} "
          f"vs {out[True][0]:.6f} (rel {loss_err:.2e}), points "
          f"{out[False][1]} vs {out[True][1]}, grad max err / leaf max "
          f"{grad_err}")
    check(out[False][1] == out[True][1] and loss_err <= 1e-2
          and set(out[False][2]) == set(out[True][2])
          and max(grad_err.values()) <= grad_tol,
          f"{what}: kernel path disagrees with the plain path")
    return {"loss_rel": loss_err, "grad_rel": grad_err}


def phase_train(dev, cfg, steps=128, timed=32, repro=32):
    """The flagship Trainer through its entry points: `steps` steps with
    every launch counter reset just before and read just after, then the
    checks, the val PSNR, a fixed-batch kernel-vs-plain step, a profile of
    one step and the repro check over the first `repro` steps."""
    import torch
    from raw_ngp_torch.data import make_synthetic_scene
    from raw_ngp_torch.data.sampler import sample_ray_batch
    from raw_ngp_torch.train.trainer import Trainer

    train_s, val_s = make_synthetic_scene(n_train=36, n_val=2, H=128, W=128)
    t0 = time.perf_counter()
    tr = Trainer(cfg, train_s, val_s, device=dev,
                 workspace=scratch_workspace())
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    print(f"[train] Trainer ready in {init_s:.2f} s")
    snap = trainer_snapshot(tr)
    launches, (first, last), step_ms, ref = run_steps(
        tr, steps, TRAIN_KERNELS, "train", capture_at=repro)
    window = step_ms[-timed:]
    med = sorted(window)[timed // 2]
    psnr, launches["hash_encode_by_caller"]["eval"] = evaluate_counted(tr)
    print(f"[train] last {timed} steps: median {med:.3f} ms/step, "
          f"{tr.num_rays / med * 1e3:.0f} rays/s; val PSNR (EMA) "
          f"{psnr:.3f} dB")

    gen = torch.Generator(device=dev).manual_seed(5)
    sa = tr.scene_arrays
    batch = sample_ray_batch(gen, sa["images"], sa["poses"],
                             sa["intrinsics"], tr.num_rays)
    batch["coarse_lin"] = sa["coarse_lin"]
    fixed = fixed_batch_check(tr, lambda: batch, "train")
    sorts = sort_stream_checks(captured_sorts(
        tr, batch, [(tr.spec.grid_spec, "flagship")]), "train")
    check([r["stream"] for r in sorts["streams"]]
          == ["flagship dense level 0", "flagship window level 1"],
          f"train: the step sorted {[r['stream'] for r in sorts['streams']]}")

    train = {"config": "flagship (with_preset_O + with_tpu_profile, fp16, "
                       "num_rays 8192)",
             "scene": "make_synthetic_scene(36, 2, 128, 128)",
             "steps": steps, "grid_refreshes": tr.host_grid_updates,
             "num_rays": tr.num_rays,
             "point_budget": tr._point_budget or tr.base_point_budget(),
             "ms_per_step": med, "rays_per_s": tr.num_rays / med * 1e3,
             "ms_per_step_runs": window, "val_psnr_ema": psnr,
             "loss_first8": first, "loss_last8": last,
             "fixed_batch_kernel_vs_plain": fixed, "sorts": sorts,
             "stages_ms": step_breakdown(tr),
             "profile": profile_device(tr.step, 1, "step")}
    train["repro"], train["dispatch"] = repro_check(tr, snap, ref, repro, "train")
    return launches, train


def write_colmap_scene(root, images, poses, intrinsics, step=2,
                       image_format="png", quality=95, names=None,
                       units=1.0, size=None):
    """Writes a scene (images [n, H, W, 3] in [0, 1], OpenGL cam2world
    poses [n, 4, 4], intrinsics [4]) as a COLMAP dataset with the port's
    writers: sparse/0/cameras.bin (one PINHOLE camera), images.bin (the
    OpenCV-convention world-to-camera poses, tests/test_providers.py's
    construction), points3D.bin (the first surface point of the synthetic
    spheres on the ray of every `step`-th pixel of each image, observed by
    that image alone at that pixel) and images/<name>.<image_format> (8
    bits, round(255 img); "png", or "jpg" at `quality` as cv2.imwrite
    writes it; None writes no images, and `images` may be None with
    `size` (H, W) given). `names` are the images' stems (default
    img_XXX); `units` scales the world (camera centres and points), so a
    loader's data.scale of 1 / units gives back the scene's own units.
    Returns the number of points."""
    import os
    import numpy as np
    from raw_ngp_torch.data.colmap_io import (ColmapCamera, ColmapImage,
                                              ColmapPoint3D, rotmat_to_qvec,
                                              write_cameras_binary,
                                              write_images_binary,
                                              write_points3d_binary)
    from raw_ngp_torch.data.image_io import write_png
    from raw_ngp_torch.data.jpeg import write_jpeg
    from raw_ngp_torch.data.synthetic import _trace
    if image_format not in ("png", "jpg", None):
        raise ValueError(f"image_format {image_format!r}: png, jpg or None")
    n = len(poses)
    H, W = images.shape[1:3] if size is None else size
    if names is None:
        names = [f"img_{i:03d}" for i in range(n)]
    os.makedirs(os.path.join(root, "sparse", "0"), exist_ok=True)
    if image_format is not None:
        os.makedirs(os.path.join(root, "images"), exist_ok=True)
    fx, fy, cx, cy = (float(v) for v in intrinsics)
    write_cameras_binary({1: ColmapCamera(1, "PINHOLE", W, H,
                                          np.array([fx, fy, cx, cy]))},
                         os.path.join(root, "sparse", "0", "cameras.bin"))
    rows, cols = np.meshgrid(np.arange(0, H, step), np.arange(0, W, step),
                             indexing="ij")
    rows, cols = rows.reshape(-1), cols.reshape(-1)
    cam_dirs = np.stack([(cols + 0.5 - cx) / fx, -(rows + 0.5 - cy) / fy,
                         -np.ones(rows.size)], -1)
    ims, pts = {}, {}
    for i in range(n):
        c2w = np.asarray(poses[i], np.float64)
        d = cam_dirs @ c2w[:3, :3].T
        o = np.broadcast_to(c2w[:3, 3], d.shape)
        _, t = _trace(o, d / np.linalg.norm(d, axis=-1, keepdims=True))
        hit = np.isfinite(t)
        # the hit along the unnormalized direction (z = -1 in the camera)
        xyz = o[hit] + d[hit] * (t[hit] / np.linalg.norm(d[hit], axis=-1)
                                 )[:, None]
        ids = np.arange(len(pts) + 1, len(pts) + 1 + hit.sum())
        for k, p in zip(ids, xyz):
            pts[int(k)] = ColmapPoint3D(int(k), p * units, np.zeros(3), 0.5)
        c2w_u = c2w.copy()
        c2w_u[:3, 3] *= units
        w2c = np.linalg.inv(c2w_u @ np.diag([1.0, -1.0, -1.0, 1.0]))
        xys = np.stack([cols[hit] + 0.5, rows[hit] + 0.5], -1)
        name = f"{names[i]}.{image_format or 'png'}"
        ims[i + 1] = ColmapImage(i + 1, rotmat_to_qvec(w2c[:3, :3]),
                                 w2c[:3, 3], 1, name, xys,
                                 ids.astype(np.int64))
        if image_format is None:
            continue
        pixels = np.round(images[i] * 255.0).astype(np.uint8)
        if image_format == "png":
            write_png(os.path.join(root, "images", name), pixels)
        else:
            write_jpeg(os.path.join(root, "images", name), pixels, quality)
    write_images_binary(ims, os.path.join(root, "sparse", "0", "images.bin"))
    write_points3d_binary(pts, os.path.join(root, "sparse", "0",
                                            "points3D.bin"))
    return len(pts)


EXR_COMPRESSIONS = {"NONE": (0, 1), "RLE": (1, 1), "ZIPS": (2, 1),
                    "ZIP": (3, 16), "PIZ": (4, 32), "PXR24": (5, 16),
                    "B44": (6, 32), "B44A": (7, 32), "DWAA": (8, 32),
                    "DWAB": (9, 256)}
EXR_PIXELS = {"HALF": (1, "<f2"), "FLOAT": (2, "<f4")}
# zlib's level in OpenEXR's ZIP compressor (its default)
EXR_ZIP_LEVEL = 4


def _exr_predict(raw):
    """The ZIP / RLE byte predictor of OpenEXR's writer: the even bytes,
    then the odd ones, each byte stored as its difference with the one
    before plus 128 (mod 256)."""
    import numpy as np
    t = np.concatenate([raw[0::2], raw[1::2]])
    d = t.copy()
    d[1:] = t[1:] - t[:-1] + np.uint8(128)
    return d


def _exr_rle(t):
    """OpenEXR's run-length code of the bytes `t`: a run of 3 to 128 equal
    bytes as (count - 1, byte), anything else as literals after -count."""
    out = bytearray()
    data = t.tobytes()
    n, i = len(data), 0
    while i < n:
        j = i + 1
        while j < n and j - i < 128 and data[j] == data[i]:
            j += 1
        if j - i >= 3:
            out += bytes([j - i - 1, data[i]])
            i = j
            continue
        j = i
        while j < n and j - i < 127 and not (
                j + 2 < n and data[j] == data[j + 1] == data[j + 2]):
            j += 1
        out += bytes([256 - (j - i)]) + data[i:j]
        i = j
    return bytes(out)


def _pack_msb(values, nbits):
    """The bit stream of the codes `values` (each `nbits` long, MSB
    first, up to 58 bits) and its length in bits, zero-padded to bytes:
    each code shifted into the 64-bit word where it starts and, for the
    bits past that word's end, the next; the words' parts ORed together
    (the codes' bits are disjoint) by one reduceat over each run of codes
    in the same word, then written big-endian."""
    import numpy as np
    values = np.asarray(values, np.uint64)
    nbits = np.asarray(nbits, np.int64)
    end = np.cumsum(nbits)
    start = end - nbits
    total = int(end[-1]) if len(end) else 0
    if total == 0:
        return b"", 0
    word = start >> 6
    room = 64 - (start & 63)                  # bits left in the first word
    lead = room - nbits
    head = np.where(lead >= 0, values << np.maximum(lead, 0).astype(
        np.uint64), values >> np.maximum(-lead, 0).astype(np.uint64))
    spill = nbits - room                      # bits into the next word
    tail = values << (64 - np.maximum(spill, 1)).astype(np.uint64)
    words = np.zeros(-(-total // 64), np.uint64)
    for at, part in ((word, head), (word[spill > 0] + 1, tail[spill > 0])):
        if len(at):
            heads = np.concatenate([[0], np.flatnonzero(np.diff(at)) + 1])
            words[at[heads]] |= np.bitwise_or.reduceat(part, heads)
    return words.byteswap().tobytes()[:-(-total // 8)], total


def _huffman_lengths(counts):
    """Huffman code lengths of symbols with the given counts (> 0), by the
    two-queue merge: the leaves sorted by (count, index), the merged nodes
    made in order of nondecreasing count, each merge taking the two
    smallest (count, node) at the queues' fronts (a leaf before a merged
    node of the same count: the order of a heap of (count, node), so the
    same tree and lengths, without the heap's cost); a leaf's length is
    its depth."""
    import numpy as np
    n = len(counts)
    if n == 1:
        return np.ones(1, np.int64)
    c = np.asarray(counts, np.int64)
    order = np.argsort(c, kind="stable")
    leaf_c, leaf_id = c[order].tolist(), order.tolist()
    node_c = []
    parent = [0] * (2 * n - 1)
    i = j = 0
    for node in range(n, 2 * n - 1):
        made = node - n                       # merged nodes so far
        if j == made or (i < n and leaf_c[i] <= node_c[j]):
            a, ca, i = leaf_id[i], leaf_c[i], i + 1
        else:
            a, ca, j = n + j, node_c[j], j + 1
        if j == made or (i < n and leaf_c[i] <= node_c[j]):
            b, cb, i = leaf_id[i], leaf_c[i], i + 1
        else:
            b, cb, j = n + j, node_c[j], j + 1
        parent[a] = parent[b] = node
        node_c.append(ca + cb)
    depth = [0] * (2 * n - 1)
    for k in range(2 * n - 3, -1, -1):       # parents come after children
        depth[k] = depth[parent[k]] + 1
    return np.array(depth[:n], np.int64)


def piz_huffman(values):
    """OpenEXR's hufCompress of uint16 `values`: the counts (and the run
    symbol iM = max + 1, count 1), Huffman lengths, canonical codes
    (shorter codes numerically higher), the packed table (6-bit lengths,
    59-62 and 63 + 8 bits for runs of unused symbols), then each run of
    equal values in pieces of at most 256, a piece of n sent as its code,
    the run code and n - 1 in 8 bits where that is shorter than n codes."""
    import struct
    import numpy as np
    values = np.asarray(values, np.int64)
    if not len(values):
        return b""
    counts = np.bincount(values, minlength=65537)
    im, iM = int(values.min()), int(values.max()) + 1
    counts[iM] = 1
    syms = np.flatnonzero(counts)
    L = np.zeros(65537, np.int64)
    L[syms] = _huffman_lengths(counts[syms])
    n_len = np.bincount(L[syms], minlength=59)
    first, c = np.zeros(59, np.int64), 0
    for length in range(58, 0, -1):
        first[length], c = c, (c + int(n_len[length])) >> 1
    order = syms[np.lexsort((syms, L[syms]))]
    rank = np.arange(len(order)) - np.searchsorted(L[order], L[order])
    code = np.zeros(65537, np.int64)
    code[order] = first[L[order]] + rank
    # the table: lengths of im..iM, zero runs in pieces of at most 261
    lens = L[im:iM + 1]
    zero = lens == 0
    edges = np.flatnonzero(np.diff(np.concatenate([[0], zero, [0]])))
    z_start, z_len = edges[0::2], edges[1::2] - edges[0::2]
    pieces = -(-z_len // 261)
    p_start = np.repeat(z_start, pieces) + 261 * (
        np.arange(pieces.sum()) - np.repeat(np.cumsum(pieces) - pieces,
                                            pieces))
    p_len = np.minimum(np.repeat(z_start + z_len, pieces) - p_start, 261)
    pv = np.where(p_len >= 6, (63 << 8) | (p_len - 6),
                  np.where(p_len >= 2, 59 + p_len - 2, 0))
    pb = np.where(p_len >= 6, 14, 6)
    nz = np.flatnonzero(~zero)
    pos = np.concatenate([nz, p_start])
    tv = np.concatenate([lens[nz], pv])[np.argsort(pos, kind="stable")]
    tb = np.concatenate([np.full(len(nz), 6), pb])[np.argsort(
        pos, kind="stable")]
    table, _ = _pack_msb(tv, tb)
    # the codes: runs of equal values in pieces of at most 256
    cut = np.flatnonzero(values[1:] != values[:-1]) + 1
    r_start = np.concatenate([[0], cut])
    r_len = np.diff(np.concatenate([r_start, [len(values)]]))
    per = -(-r_len // 256)
    piece_sym = np.repeat(values[r_start], per)
    piece_n = np.minimum(np.repeat(r_len, per) - 256 * (
        np.arange(per.sum()) - np.repeat(np.cumsum(per) - per, per)), 256)
    ls, lr = L[piece_sym], L[iM]
    run = ls + lr + 8 < ls * (piece_n - 1)
    n_tok = np.where(run, 3, piece_n)
    tok_piece = np.repeat(np.arange(len(piece_n)), n_tok)
    k = np.arange(n_tok.sum()) - np.repeat(np.cumsum(n_tok) - n_tok, n_tok)
    s = piece_sym[tok_piece]
    is_run = run[tok_piece]
    tok_v = np.where(is_run & (k == 1), code[iM],
                     np.where(is_run & (k == 2), piece_n[tok_piece] - 1,
                              code[s]))
    tok_b = np.where(is_run & (k == 1), lr,
                     np.where(is_run & (k == 2), 8, ls[tok_piece]))
    data, nbits = _pack_msb(tok_v, tok_b)
    return struct.pack("<5i", im, iM, len(table), nbits, 0) + table + data


def _wav_enc14(a, b):
    a_s, b_s = (a ^ 0x8000) - 0x8000, (b ^ 0x8000) - 0x8000
    return ((a_s + b_s) >> 1) & 0xFFFF, (a_s - b_s) & 0xFFFF


def _wav_enc16(a, b):
    import numpy as np
    ao = (a + 0x8000) & 0xFFFF
    m = (ao + b) >> 1
    d = ao - b
    return np.where(d < 0, (m + 0x8000) & 0xFFFF, m), d & 0xFFFF


def wav2_encode_np(v, mx):
    """OpenEXR's wav2Encode of a 2-D int64 array [ny, nx] in place, level
    by level (the pairs of every 2 x 2 group horizontally then
    vertically, the odd column, the odd line); the 14-bit form where `mx`
    < 2^14, else the 16-bit modular one."""
    import numpy as np
    ny, nx = v.shape
    enc = _wav_enc14 if mx < (1 << 14) else _wav_enc16
    n = min(nx, ny)
    p, p2 = 1, 2
    while p2 <= n:
        ys = np.arange(0, ny - p2 + 1, p2)
        xs = np.arange(0, nx - p2 + 1, p2)
        if len(ys) and len(xs):
            Y, X = np.ix_(ys, xs)
            i00, i01 = enc(v[Y, X], v[Y, X + p])
            i10, i11 = enc(v[Y + p, X], v[Y + p, X + p])
            v[Y, X], v[Y + p, X] = enc(i00, i10)
            v[Y, X + p], v[Y + p, X + p] = enc(i01, i11)
        if nx & p and len(ys):
            x = len(xs) * p2
            v[ys, x], v[ys + p, x] = enc(v[ys, x], v[ys + p, x])
        if ny & p and len(xs):
            y = len(ys) * p2
            v[y, xs], v[y, xs + p] = enc(v[y, xs], v[y, xs + p])
        p, p2 = p2, p2 << 1
    return v


def _piz_chunk(block):
    """A PIZ chunk of `block` [(pixel type, bits [lines, width])]: the
    bitmap of the 16-bit values used (a 32-bit sample's low and high
    halves), the LUT to their ranks, each channel's each half through
    wav2Encode, piz_huffman."""
    import struct
    import numpy as np
    planes = []
    for ptype, bits in block:
        b = bits.astype(np.int64)[..., None]
        planes.append(b if ptype == "HALF" else
                      np.concatenate([b & 0xFFFF, b >> 16], 2))
    flat = np.concatenate([p.reshape(-1) for p in planes])
    used = np.unique(np.concatenate([[0], flat]))
    bitmap = np.zeros(8192, np.uint8)
    np.bitwise_or.at(bitmap, used[used > 0] >> 3,
                     (1 << (used[used > 0] & 7)).astype(np.uint8))
    nonzero = np.flatnonzero(bitmap)
    lo, hi = (int(nonzero[0]), int(nonzero[-1])) if len(nonzero) else \
        (8191, 0)
    mx = len(used) - 1
    out = []
    for p in planes:
        q = np.searchsorted(used, p)
        for j in range(q.shape[2]):
            q[:, :, j] = wav2_encode_np(np.ascontiguousarray(q[:, :, j]), mx)
        out.append(q.reshape(-1))
    huf = piz_huffman(np.concatenate(out))
    head = struct.pack("<HH", lo, hi) + (bitmap[lo:hi + 1].tobytes()
                                         if lo <= hi else b"")
    return head + struct.pack("<i", len(huf)) + huf


def float24(bits):
    """OpenEXR's floatToFloat24 of float32 bits (uint32): the top 24 bits
    rounded (a NaN keeps its sign and top 15 mantissa bits, a finite value
    that would round to infinity is truncated)."""
    import numpy as np
    b = bits.astype(np.int64)
    s, e, m = b & 0x80000000, b & 0x7F800000, b & 0x007FFFFF
    rounded = ((e | m) + (m & 0x80)) >> 8
    finite = np.where(rounded >= 0x7F8000, (e | m) >> 8, rounded)
    nan = (e >> 8) | (m >> 8) | ((m >> 8) == 0)
    i = np.where(e == 0x7F800000, np.where(m > 0, nan, e >> 8), finite)
    return (s >> 8) | i


def _pxr24_chunk(block):
    """A PXR24 chunk of `block`: each line's each channel's differences
    (24-bit for FLOAT, from float24) in big-endian byte planes, deflated.
    Returns (the chunk, each channel's bits as a reader gets them)."""
    import zlib
    import numpy as np
    rows, back = [], []
    for ptype, bits in block:
        v = bits.astype(np.int64)
        nb = 2 if ptype == "HALF" else 3
        if ptype != "HALF":
            v = float24(bits)
            back.append((v << 8).astype(np.uint32))
        else:
            back.append(bits)
        d = np.diff(v, axis=1, prepend=0) & ((1 << (8 * nb)) - 1)
        rows.append(np.stack([(d >> (8 * (nb - 1 - k))) & 255
                              for k in range(nb)], 1).reshape(len(v), -1))
    return zlib.compress(np.concatenate(rows, 1).astype(np.uint8)
                         .tobytes()), back


# B44's pairs of differences, in its byte order
_B44_PAIRS = ((0, 4), (4, 8), (8, 12), (0, 1), (4, 5), (8, 9), (12, 13),
              (1, 2), (5, 6), (9, 10), (13, 14), (2, 3), (6, 7), (10, 11),
              (14, 15))


def b44_pack_blocks(s, flat_ok):
    """B44's pack of 4 x 4 blocks of half bits s [n, 16] (not pLinear, so
    the block's maximum is exact): the ordered values t, the least shift
    whose rounded differences d from the maximum fit 6-bit steps, t0 and
    the 15 steps in 14 bytes, or a 3-byte flat block where `flat_ok`
    (B44A) and every step is 0. Returns (the blocks' bytes in order, the
    bits each block decodes to [n, 16]: t0 plus the steps, ordered back)."""
    import numpy as np
    s = s.astype(np.int64)
    t = np.where(s & 0x7C00 == 0x7C00, 0x8000,
                 np.where(s & 0x8000, ~s & 0xFFFF, s | 0x8000))
    t_max = t.max(1)
    a, b = np.array(_B44_PAIRS).T
    n = len(s)
    shift = np.zeros(n, np.int64)
    d = np.zeros((n, 16), np.int64)
    todo = np.arange(n)
    for sh in range(16):
        x = (t_max[todo, None] - t[todo]) << 1
        dd = (x + (1 << sh) - 1 + ((x >> (sh + 1)) & 1)) >> (sh + 1)
        r = dd[:, a] - dd[:, b] + 32
        ok = (r.min(1) >= 0) & (r.max(1) <= 63)
        shift[todo[ok]] = sh
        d[todo[ok]] = dd[ok]
        todo = todo[~ok]
        if not len(todo):
            break
    r = d[:, a] - d[:, b] + 32
    flat = flat_ok & (r == 32).all(1)
    t0 = (t_max - (d[:, 0] << shift)) & 0xFFFF
    t0 = np.where(flat, t[:, 0], t0)
    out = np.zeros((n, 14), np.int64)
    out[:, 0], out[:, 1] = t0 >> 8, t0 & 255
    out[:, 2] = np.where(flat, 0xFC, (shift << 2) | (r[:, 0] >> 4))
    out[:, 3] = (r[:, 0] << 4) | (r[:, 1] >> 2)
    out[:, 4] = (r[:, 1] << 6) | r[:, 2]
    for g in range(3):                  # r3-r6, r7-r10, r11-r14
        i, at = 3 + 4 * g, 5 + 3 * g
        out[:, at] = (r[:, i] << 2) | (r[:, i + 1] >> 4)
        out[:, at + 1] = (r[:, i + 1] << 4) | (r[:, i + 2] >> 2)
        out[:, at + 2] = (r[:, i + 2] << 6) | r[:, i + 3]
    keep = np.ones((n, 14), bool)
    keep[flat, 3:] = False
    data = (out & 255).astype(np.uint8)[keep].tobytes()
    back = (t0[:, None] + ((d[:, :1] - d) << shift[:, None])) & 0xFFFF
    back = np.where(flat[:, None], t0[:, None], back)
    back = np.where(back & 0x8000, back & 0x7FFF, ~back & 0xFFFF)
    return data, back.astype(np.uint16)


def _b44_chunk(block, flat_ok):
    """A B44 (B44A where `flat_ok`) chunk of `block`: each HALF channel's
    4 x 4 blocks (the last line and column repeated to fill them), FLOAT
    channels raw. Returns (the chunk, each channel's bits as read)."""
    import numpy as np
    out, back = [], []
    for ptype, bits in block:
        if ptype != "HALF":
            out.append(bits.astype("<u4").tobytes())
            back.append(bits)
            continue
        ny, nx = bits.shape
        by, bx = -(-ny // 4), -(-nx // 4)
        full = np.pad(bits, ((0, 4 * by - ny), (0, 4 * bx - nx)), "edge")
        blocks = full.reshape(by, 4, bx, 4).transpose(0, 2, 1, 3).reshape(
            -1, 16)
        data, got = b44_pack_blocks(blocks, flat_ok)
        out.append(data)
        back.append(got.reshape(by, bx, 4, 4).transpose(0, 2, 1, 3)
                    .reshape(4 * by, 4 * bx)[:ny, :nx])
    return b"".join(out), back


class DwaRead(NamedTuple):
    """What a reader must give for a DWA-coded channel or image: `values`,
    the writer's own float64 decode of the coefficients it stored (each
    sample's half through toLinear), and [`lo`, `hi`], the values that
    the tolerance of tests/test_torch_exr_dwa.py allows (one half-ulp of
    the float64 decode plus 2^-20 times the block's sum of absolute
    coefficients, before toLinear). Where a chunk was stored raw the
    three are its exact values."""
    values: Any
    lo: Any
    hi: Any


# the DWA quantiser: an AC coefficient at zig-zag index k is zeroed below
# DWA_STEP (1 + k / 8) (nonlinear units), the rest rounded to half
DWA_STEP = 2.0 ** -8
_DWA = {}
# the blocks _dwa_decoder has written since this was last cleared, by the
# decoder's cases of the zig-zag index of a block's last AC literal (its
# dctInverse8x8 variants: no literal, 1, 2, 3-8, 9, 10-19, 20, 21-34,
# 35-63)
DWA_ROW_CASES = {}
DWA_ROW_BOUNDS = (0, 1, 2, 3, 9, 10, 20, 21, 35, 64)


def dwa_tables():
    """The DWA tables: "nonlinear" (dwaLookups.cpp's toNonlinear from its
    formula: sign(h) |h|^(1 / 2.2f) up to 1, sign(h) (ln |h| / ln L + 1)
    above, L = float(2.7182818^2.2); 0 for 0 and non-finite halves),
    "linear" (raw_ngp_torch.data.exr_dwa.to_linear_table), "zigzag" (the
    zig-zag index of each raster index), "dct" (the orthonormal 8-point
    DCT matrix) and "idct" (dctInverse8x8_scalar's 1-D step as a float64
    matrix of its float32 constants)."""
    import numpy as np
    from raw_ngp_torch.data import exr_dwa
    if not _DWA:
        with np.errstate(all="ignore"):
            h = np.arange(1 << 16, dtype=np.uint32).astype(np.uint16).view(
                np.float16).astype(np.float32)
            a = np.abs(h).astype(np.float64)
            log_base = float(np.float32(2.7182818 ** 2.2))
            small = np.power(a, float(np.float32(1) / np.float32(2.2)))
            large = np.log(a) / np.log(log_base) + 1.0
            v = np.where(a <= 1, small, large).astype(np.float32)
            v = np.where(h < 0, -v, v).astype(np.float16).view(np.uint16)
        v[~np.isfinite(h) | (a == 0)] = 0
        n = np.arange(8)
        dct = np.where(n[:, None] == 0, np.sqrt(1 / 8), 0.5) * np.cos(
            (2 * n[None, :] + 1) * n[:, None] * np.pi / 16)
        k = [float(c) for c in (exr_dwa.IDCT_A, exr_dwa.IDCT_B,
                                exr_dwa.IDCT_C, exr_dwa.IDCT_D,
                                exr_dwa.IDCT_E, exr_dwa.IDCT_F,
                                exr_dwa.IDCT_G)]
        a_, b_, c_, d_, e_, f_, g_ = k
        # out = M r: the step's sums of each input, rows the outputs
        beta = np.array([[0, b_, 0, d_, 0, e_, 0, g_],
                         [0, d_, 0, -g_, 0, -b_, 0, -e_],
                         [0, e_, 0, -b_, 0, g_, 0, d_],
                         [0, g_, 0, -e_, 0, d_, 0, -b_]])
        even = np.array([[a_, 0, c_, 0, a_, 0, f_, 0],
                         [a_, 0, f_, 0, -a_, 0, -c_, 0],
                         [a_, 0, -f_, 0, -a_, 0, c_, 0],
                         [a_, 0, -c_, 0, a_, 0, -f_, 0]])
        idct = np.concatenate([even + beta, (even - beta)[::-1]])
        _DWA.update(nonlinear=v, linear=exr_dwa.to_linear_table(),
                    zigzag=exr_dwa.ZIGZAG, dct=dct, idct=idct)
    return _DWA


def _dwa_ac_tokens(zz):
    """rleAc of zig-zag half bits [n, 64] (DC at 0), block after block:
    each AC literal, a lone zero as a literal 0, a longer run of zeros as
    0xff00 | its length, or 0xff00 where it runs to the block's end."""
    import numpy as np
    ac = zz[:, 1:].astype(np.int64)
    z = ac == 0
    idx = np.arange(63)
    nxt = np.minimum.accumulate(np.where(z, 63, idx)[:, ::-1], 1)[:, ::-1]
    run = nxt - idx
    start = z & ~np.concatenate([np.zeros((len(ac), 1), bool), z[:, :-1]],
                                1)
    tok = np.where(~z, ac, np.where(run == 1, 0, np.where(
        idx + run == 63, 0xFF00, 0xFF00 | run)))
    return tok[~z | start].astype(np.uint16)


def _dwa_decoder(planes, csc, nonlinear):
    """One decoder's coefficients and its writer-side decode: `planes`
    its channels' halves [ny, nx] (R, G, B for a CSC set), `csc` whether
    they are one, `nonlinear` whether they go through toNonlinear. Returns
    (DC half bits [comps, blocks], AC tokens, [DwaRead-ready (values,
    lo, hi) halves-as-float32 planes, before toLinear])."""
    import numpy as np
    t = dwa_tables()
    ny, nx = planes[0].shape
    nby, nbx = -(-ny // 8), -(-nx // 8)

    def mirror(n, m):
        i = np.arange(8 * m)
        i = np.where(i >= n, n - (i - (n - 1)), i)
        return np.where(i < 0, n - 1, i)

    yi, xi = mirror(ny, nby), mirror(nx, nbx)
    x = []
    for h in planes:
        h = t["nonlinear"][h] if nonlinear else h
        full = h[np.ix_(yi, xi)].view(np.float16).astype(np.float32)
        x.append(full.reshape(nby, 8, nbx, 8).transpose(0, 2, 1, 3)
                 .reshape(-1, 8, 8))
    if csc:
        r, g, b = x
        x = [np.float32(0.2126) * r + np.float32(0.7152) * g
             + np.float32(0.0722) * b,
             np.float32(-0.1146) * r - np.float32(0.3854) * g
             + np.float32(0.5) * b,
             np.float32(0.5) * r - np.float32(0.4542) * g
             - np.float32(0.0458) * b]
    X = t["dct"] @ np.stack(x, 1).astype(np.float64) @ t["dct"].T
    nb, m = X.shape[:2]
    raster = X.reshape(nb, m, 64)
    k = t["zigzag"]
    keep = (k == 0) | (np.abs(raster) >= DWA_STEP * (1 + k / 8))
    with np.errstate(over="ignore"):
        q = np.where(keep, raster, 0).astype(np.float16)
    zz = np.zeros((nb, m, 64), np.uint16)
    zz[:, :, k] = q.view(np.uint16)
    # the last literal: the last nonzero AC value, or 63 where only
    # position 63 is zero after it (rleAc writes a lone zero as a literal)
    nz = zz[:, :, 1:] != 0
    last = np.where(nz.any(-1), 63 - np.argmax(nz[..., ::-1], -1), 0)
    last = np.where(last == 62, 63, last)
    for lo, hi, n in zip(DWA_ROW_BOUNDS[:-1], DWA_ROW_BOUNDS[1:],
                         np.histogram(last, DWA_ROW_BOUNDS)[0]):
        key = "dc_only" if hi == 1 else f"{lo}" if hi == lo + 1 else \
            f"{lo}-{hi - 1}"
        DWA_ROW_CASES[key] = DWA_ROW_CASES.get(key, 0) + int(n)
    coef = q.astype(np.float64).reshape(nb, m, 8, 8)
    ref = t["idct"] @ coef @ t["idct"].T
    if csc:
        y, cb, cr = ref[:, 0], ref[:, 1], ref[:, 2]
        k1, k2, k3, k4 = (float(np.float32(v)) for v in (1.5747, 0.1873,
                                                         0.4682, 1.8556))
        ref = np.stack([y + k1 * cr, y - k2 * cb - k3 * cr, y + k4 * cb], 1)
    tol = 2.0 ** -20 * np.abs(coef).sum((1, 2, 3))[:, None, None, None]
    with np.errstate(all="ignore"):
        ulp = np.spacing(np.abs(ref).astype(np.float16)).astype(np.float64)
        out = [ref.astype(np.float16), (ref - ulp - tol).astype(np.float16),
               (ref + ulp + tol).astype(np.float16)]
    planes_out = []
    for j in range(m):
        planes_out.append([
            o[:, j].reshape(nby, nbx, 8, 8).transpose(0, 2, 1, 3).reshape(
                8 * nby, 8 * nbx)[:ny, :nx].view(np.uint16) for o in out])
    return zz[:, :, 0].T.reshape(-1), _dwa_ac_tokens(zz.reshape(-1, 64)), \
        planes_out


def _dwa_chunk(block, names, huffman=True):
    """A DWA chunk (version 2, OpenEXR's default rules stored) of
    `block` [(pixel type, bits [rows, samples])] named `names`: B, G, R
    a CSC set, every other channel (Y, RY, BY) DCT-coded alone, all
    through toNonlinear; AC values by piz_huffman (STATIC_HUFFMAN) or
    zlib, DC values through the ZIP predictor. Returns (the chunk, each
    channel's (values, lo, hi) as a reader gets them, float32)."""
    import struct
    import zlib
    import numpy as np
    from raw_ngp_torch.data import exr_dwa
    t = dwa_tables()
    halves = []
    for ptype, bits in block:
        if ptype == "HALF":
            halves.append(bits)
        else:
            f = np.clip(bits.view(np.float32), -65504, 65504)
            halves.append(f.astype(np.float16).view(np.uint16))
    decoders = [[names.index(c) for c in "RGB"]] if sorted(names) == \
        ["B", "G", "R"] else [[k] for k in range(len(names))]
    dc, ac, back = [], [], [None] * len(block)
    for comps in decoders:
        d, a, out = _dwa_decoder([halves[c] for c in comps],
                                 len(comps) == 3, True)
        dc.append(d)
        ac.append(a)
        for c, planes in zip(comps, out):
            back[c] = [t["linear"][p].view(np.float16).astype(np.float32)
                       for p in planes]
    dc = np.concatenate(dc).astype("<u2")
    ac = np.concatenate(ac)
    ac_z = piz_huffman(ac) if huffman else zlib.compress(
        ac.astype("<u2").tobytes(), EXR_ZIP_LEVEL)
    dc_z = zlib.compress(_exr_predict(dc.view(np.uint8)).tobytes(),
                         EXR_ZIP_LEVEL)
    rules = b"".join(r.encode() + b"\0" + bytes(
        [(((csc + 1) & 15) << 4) | (scheme << 2) | int(nocase), ptype])
        for r, scheme, ptype, csc, nocase in exr_dwa.DEFAULT_RULES)
    counts = struct.pack("<11Q", 2, 0, 0, len(ac_z), len(dc_z), 0, 0, 0,
                         len(ac), len(dc), 0 if huffman else 1)
    return counts + struct.pack("<H", len(rules) + 2) + rules + ac_z + \
        dc_z, back


def _exr_chunk(block, code, names=None, present=None):
    """One chunk's data of `block` [(pixel type, bits [rows, samples])]
    named `names` compressed with `code` (stored raw where that is not
    smaller, as OpenEXR's writer does) and each channel's bits as a
    reader gets them; for DWA each channel's (values, lo, hi) (see
    DwaRead). `present` marks, for each channel, the chunk's lines that
    hold a row of it (a subsampled channel; None: every line)."""
    import zlib
    import numpy as np
    rows = [b.astype("<u2" if t == "HALF" else "<u4").view(np.uint8)
            .reshape(len(b), -1) for t, b in block]
    if present is None:
        raw = np.concatenate(rows, 1).reshape(-1)
    else:
        at = [0] * len(rows)
        parts = []
        for line in range(len(present[0])):
            for c, p in enumerate(present):
                if p[line]:
                    parts.append(rows[c][at[c]])
                    at[c] += 1
        raw = np.concatenate(parts)
    back = [b for _, b in block]
    packed = raw.tobytes()
    if code == 1:
        packed = _exr_rle(_exr_predict(raw))
    elif code in (2, 3):
        packed = zlib.compress(_exr_predict(raw).tobytes(), EXR_ZIP_LEVEL)
    elif code == 4:
        packed = _piz_chunk(block)
    elif code == 5:
        packed, lossy = _pxr24_chunk(block)
    elif code in (6, 7):
        packed, lossy = _b44_chunk(block, code == 7)
    elif code in (8, 9):
        packed, lossy = _dwa_chunk(block, names)
        back = [[b.view(np.float16 if t == "HALF" else np.float32).astype(
            np.float32)] * 3 for t, b in block]
    if len(packed) >= raw.size:
        return raw.tobytes(), back
    return packed, (lossy if code >= 5 else back)


def luminance_chroma(img):
    """OpenEXR's luminance-chroma channels of an RGB image [H, W, 3] (H, W
    even): Y = 0.2126 R + 0.7152 G + 0.0722 B (Rec. 709's luminance), RY
    = (R - Y) / Y and BY = (B - Y) / Y (0 where Y is 0), these two as the
    means of 2 x 2 pixels. Returns (names, planes, sampling) in the file's
    order BY, RY, Y."""
    import numpy as np
    img = np.asarray(img, np.float64)
    H, W = img.shape[:2]
    y = img @ np.array([0.2126, 0.7152, 0.0722])
    with np.errstate(all="ignore"):
        chroma = [np.where(y > 0, (img[..., c] - y) / y, 0.0)
                  for c in (2, 0)]
    chroma = [c.reshape(H // 2, 2, W // 2, 2).mean((1, 3)) for c in chroma]
    return (["BY", "RY", "Y"], [c.astype(np.float32) for c in chroma]
            + [y.astype(np.float32)], [(2, 2), (2, 2), (1, 1)])


def exr_chroma_rgb(y, ry, by):
    """cv2's EXR decoder on Y, RY and BY float32 samples (RY and BY at 2 x
    2, UpSample repeating each over its pixels), ChromaToBGR's float64
    arithmetic with Rec. 709's chromaticity y weights (0.33, 0.6, 0.06 as
    float32), as RGB float32 [H, W, 3]."""
    import numpy as np
    up = [np.repeat(np.repeat(c, 2, 0), 2, 1).astype(np.float64)
          for c in (ry, by)]
    lum = y.astype(np.float64)
    r, b = (up[0] + 1) * lum, (up[1] + 1) * lum
    wr, wg, wb = (float(np.float32(v)) for v in (0.33, 0.60, 0.06))
    g = (lum - b * wb - r * wr) / wg
    return np.stack([r, g, b], -1).astype(np.float32)


def _exr_levels(W, H, mode, rounding):
    """The (level x, level y, width, height) of a tiled part's levels in
    offset-table order (ONE_LEVEL, MIPMAP_LEVELS, RIPMAP_LEVELS)."""
    def log2(x):
        y, up = 0, 0
        while x > 1:
            up |= x & 1
            y, x = y + 1, x >> 1
        return y + (up if rounding else 0)

    def size(n, level):
        m = n >> level
        return max(m + (1 if rounding and m << level < n else 0), 1)

    if mode == 0:
        levels = [(0, 0)]
    elif mode == 1:
        levels = [(l, l) for l in range(log2(max(W, H)) + 1)]
    else:
        levels = [(lx, ly) for ly in range(log2(H) + 1)
                  for lx in range(log2(W) + 1)]
    return [(lx, ly, size(W, lx), size(H, ly)) for lx, ly in levels]


def _exr_part(img, compression, pixel, tiles, yc=False):
    """The channels' header bytes and the chunks (in offset-table order)
    of one part of a float image [H, W] ("Y") or [H, W, 3] (B, G, R; with
    `yc` BY, RY and Y, luminance_chroma), and what a reader gets back: the
    image, for DWA as DwaRead, for `yc` a dict of the channels at their
    sampling."""
    import struct
    import numpy as np
    img = np.asarray(img, np.float32)
    code, per = EXR_COMPRESSIONS[compression]
    ptype, dtype = EXR_PIXELS[pixel]
    H, W = img.shape[:2]
    if yc:
        names, planes, sampling = luminance_chroma(img)
    else:
        names = ["Y"] if img.ndim == 2 else ["B", "G", "R"]
        planes = [img] if img.ndim == 2 else [img[..., "RGB".index(c)]
                                              for c in names]
        sampling = [(1, 1)] * len(names)
    bits = [np.ascontiguousarray(p.astype(dtype)).view(
        "<u2" if pixel == "HALF" else "<u4") for p in planes]
    dwa = code in (8, 9)
    back = [[np.empty(b.shape, np.float32) for _ in range(3)] if dwa else
            np.empty_like(b) for b in bits]

    chunks = []
    if tiles is None:
        for y in range(0, H, per):
            lines = min(per, H - y)
            present = [(y + np.arange(lines)) % ys == 0 for _, ys in
                       sampling]
            first = [-(-y // ys) for _, ys in sampling]
            block = [(pixel, b[f:f + int(p.sum())])
                     for b, f, p in zip(bits, first, present)]
            data, got = _exr_chunk(block, code, names, present if yc else
                                   None)
            for dst, g, f in zip(back, got, first):
                for d, v in (zip(dst, g) if dwa else [(dst, g)]):
                    d[f:f + len(v)] = v
            chunks.append(struct.pack("<ii", y, len(data)) + data)
    else:
        tw, th, mode, rounding = tiles
        for lx, ly, lw, lh in _exr_levels(W, H, mode, rounding):
            lev = [b[::1 << ly, ::1 << lx][:lh, :lw] for b in bits]
            for dy in range(-(-lh // th)):
                for dx in range(-(-lw // tw)):
                    ys = slice(dy * th, (dy + 1) * th)
                    xs = slice(dx * tw, (dx + 1) * tw)
                    data, got = _exr_chunk(
                        [(pixel, np.ascontiguousarray(b[ys, xs]))
                         for b in lev], code, names)
                    if (lx, ly) == (0, 0):
                        for dst, g in zip(back, got):
                            for d, v in (zip(dst, g) if dwa else
                                         [(dst, g)]):
                                d[ys, xs] = v
                    chunks.append(struct.pack("<5i", dx, dy, lx, ly,
                                              len(data)) + data)
    read = [DwaRead(*b) if dwa else b.view(dtype).astype(np.float32)
            for b in back]
    if yc:
        read = dict(zip(names, read))
    elif img.ndim == 2:
        read = read[0]
    elif dwa:
        read = DwaRead(*(np.stack([getattr(read[names.index(c)], f)
                                   for c in "RGB"], -1)
                         for f in DwaRead._fields))
    else:
        read = np.stack([read[names.index(c)] for c in "RGB"], -1)
    chlist = b"".join(c.encode() + b"\0" + struct.pack("<iB3xii", ptype, 0,
                                                        *sc)
                      for c, sc in zip(names, sampling)) + b"\0"
    return chlist, code, (W, H), chunks, read


def write_exr(path, img, compression="ZIP", pixel="HALF", tiles=None,
              second=None, values=False, yc=False):
    """Writes a float [H, W] (one channel, "Y") or [H, W, 3] (R, G, B)
    image as an OpenEXR file: `compression` NONE, RLE, ZIPS, ZIP (zlib at
    EXR_ZIP_LEVEL), PIZ, PXR24, B44, B44A, DWAA or DWAB (_dwa_chunk),
    `pixel` HALF or FLOAT, little-endian, increasing y, the data window at
    the origin; a chunk that does not shrink is stored raw, as OpenEXR's
    writer does. `yc` writes an RGB image as luminance and chroma (Y, and
    RY and BY at 2 x 2: luminance_chroma). `tiles` (width, height, level
    mode 0-2, rounding 0-1) writes a tiled part with every level (level l
    the image's every 2^l-th pixel); `second` (image, compression, pixel,
    tiles) makes a two-part file with that image as part 1, its chunks
    interleaved with part 0's. Returns the bytes written, and with
    `values` also what a reader gets from part 0: the array (B44's
    blocks and PXR24's FLOAT are lossy), a DwaRead for DWA, and for `yc`
    a dict of each channel's samples (exr_chroma_rgb converts them)."""
    import struct

    def attr(name, kind, value):
        return (name.encode() + b"\0" + kind.encode() + b"\0"
                + struct.pack("<i", len(value)) + value)

    parts = [(img, compression, pixel, tiles)]
    if second is not None:
        parts.append(second)
    heads, tables, read = [], [], None
    for i, (im, comp, pix, tl) in enumerate(parts):
        chlist, code, (W, H), chunks, got = _exr_part(im, comp, pix, tl,
                                                      yc and i == 0)
        read = got if i == 0 else read
        window = struct.pack("<4i", 0, 0, W - 1, H - 1)
        head = (attr("channels", "chlist", chlist)
                + attr("compression", "compression", bytes([code]))
                + attr("dataWindow", "box2i", window)
                + attr("displayWindow", "box2i", window)
                + attr("lineOrder", "lineOrder", b"\0")
                + attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
                + attr("screenWindowCenter", "v2f",
                       struct.pack("<2f", 0, 0))
                + attr("screenWindowWidth", "float", struct.pack("<f", 1.0)))
        if tl is not None:
            head += attr("tiles", "tiledesc", struct.pack(
                "<IIB", tl[0], tl[1], tl[2] | (tl[3] << 4)))
        if second is not None:
            head += (attr("name", "string", f"part{i}".encode())
                     + attr("type", "string", b"tiledimage" if tl else
                            b"scanlineimage")
                     + attr("chunkCount", "int",
                            struct.pack("<i", len(chunks))))
            chunks = [struct.pack("<i", i) + c for c in chunks]
        heads.append(head + b"\0")
        tables.append(chunks)
    flags = 0x1000 if second is not None else (0x200 if tiles else 0)
    header = b"v/1\x01" + struct.pack("<I", 2 | flags) + b"".join(heads) + \
        (b"\0" if second is not None else b"")
    order = [(0, k) for k in range(len(tables[0]))]
    if second is not None:
        for k in range(len(tables[1])):
            order.insert(min(2 * k + 1, len(order)), (1, k))
    at = len(header) + 8 * sum(len(t) for t in tables)
    offsets = [[0] * len(t) for t in tables]
    body = []
    for i, k in order:
        offsets[i][k] = at
        body.append(tables[i][k])
        at += len(tables[i][k])
    data = header + b"".join(struct.pack(f"<{len(o)}Q", *o)
                             for o in offsets) + b"".join(body)
    with open(path, "wb") as f:
        f.write(data)
    return (data, read) if values else data


def huffman_table(counts):
    """libjpeg's jpeg_gen_optimal_table (jchuff.c) for symbol counts [n
    <= 256]: (bits [16], symbols) of a canonical Huffman table with no
    code longer than 16 bits and no all-ones code."""
    import numpy as np
    freq = [int(c) for c in counts] + [0] * (257 - len(counts))
    freq[256] = 1                     # reserves the all-ones code
    codesize = [0] * 257
    others = [-1] * 257
    while True:
        c1 = c2 = -1
        v = v2 = 1 << 62
        for i in range(257):
            if freq[i] and freq[i] <= v:
                v, c1 = freq[i], i
        for i in range(257):
            if freq[i] and freq[i] <= v2 and i != c1:
                v2, c2 = freq[i], i
        if c2 < 0:
            break
        freq[c1] += freq[c2]
        freq[c2] = 0
        codesize[c1] += 1
        while others[c1] >= 0:
            c1 = others[c1]
            codesize[c1] += 1
        others[c1] = c2
        codesize[c2] += 1
        while others[c2] >= 0:
            c2 = others[c2]
            codesize[c2] += 1
    bits = [0] * 33
    for i in range(257):
        if codesize[i]:
            bits[codesize[i]] += 1
    for i in range(32, 16, -1):
        while bits[i] > 0:
            j = i - 2
            while bits[j] == 0:
                j -= 1
            bits[i] -= 2
            bits[i - 1] += 1
            bits[j + 1] += 2
            bits[j] -= 1
    i = 16
    while bits[i] == 0:
        i -= 1
    bits[i] -= 1                      # drops the reserved code
    symbols = [s for length in range(1, 33) for s in range(256)
               if codesize[s] == length]
    return np.array(bits[1:17], np.uint8), bytes(symbols)


def _bit_length_table():
    import numpy as np
    return np.array([int(i).bit_length() for i in range(1 << 16)],
                    np.int64)


def lj92_encode_tiles(raw, tile=256, precision=16):
    """Lossless JPEG (T.81 process 14) streams of the `tile` x `tile`
    tiles of a uint16 mosaic [H, W] (row-major tiles; edge tiles padded
    by repeating the last row and column), as DNG writers code them: two
    components of tile / 2 samples a line, predictor 1, no point
    transform, one Huffman table built from the mosaic's differences."""
    import numpy as np
    H, W = raw.shape
    ty, tx = -(-H // tile), -(-W // tile)
    full = np.pad(raw, ((0, ty * tile - H), (0, tx * tile - W)), "edge")
    t = full.reshape(ty, tile, tx, tile).transpose(0, 2, 1, 3).astype(
        np.int64)
    pred = np.empty_like(t)
    pred[..., 0, :2] = 1 << (precision - 1)
    pred[..., 0, 2:] = t[..., 0, :-2]
    pred[..., 1:, :2] = t[..., :-1, :2]
    pred[..., 1:, 2:] = t[..., 1:, :-2]
    d = ((t - pred + 32768) & 0xFFFF) - 32768
    cat = _bit_length_table()[np.abs(d)]
    # SSSS 16 is 32768 and carries no extra bits
    n_extra = np.where(cat == 16, 0, cat)
    extra = np.where(d >= 0, d, d + (1 << cat) - 1) & ((1 << n_extra) - 1)
    bits, symbols = huffman_table(np.bincount(cat.reshape(-1),
                                              minlength=17))
    code = np.zeros(17, np.int64)
    size = np.zeros(17, np.int64)
    c, k = 0, 0
    for length in range(1, 17):
        for _ in range(bits[length - 1]):
            code[symbols[k]], size[symbols[k]] = c, length
            c, k = c + 1, k + 1
        c <<= 1
    word = (code[cat] << n_extra) | extra
    nbits = size[cat] + n_extra
    dht = bytes([0]) + bits.tobytes() + symbols
    half = tile // 2
    head = (b"\xff\xd8" + b"\xff\xc4" + (2 + len(dht)).to_bytes(2, "big")
            + dht + b"\xff\xc3" + (8 + 6).to_bytes(2, "big")
            + bytes([precision]) + tile.to_bytes(2, "big")
            + half.to_bytes(2, "big") + bytes([2, 1, 0x11, 0, 2, 0x11, 0])
            + b"\xff\xda" + (6 + 4).to_bytes(2, "big")
            + bytes([2, 1, 0, 2, 0, 1, 0, 0]))
    streams = []
    for w, n in zip(word.reshape(ty * tx, -1), nbits.reshape(ty * tx, -1)):
        total = int(n.sum())
        start = np.cumsum(n) - n
        owner = np.repeat(np.arange(len(n)), n)
        k = np.arange(total) - start[owner]
        stream = (w[owner] >> (n[owner] - 1 - k)) & 1
        stream = np.concatenate([stream, np.ones(-total % 8, np.int64)])
        packed = np.packbits(stream.astype(np.uint8))
        ff = np.flatnonzero(packed == 0xFF)
        packed = np.insert(packed, ff + 1, 0)
        streams.append(head + packed.tobytes() + b"\xff\xd9")
    return streams


def _tiff_ifd(entries, offset, bo="<"):
    """One TIFF IFD at `offset`: entries (tag, type, values) sorted by
    tag, values of more than 4 bytes placed after the IFD; next IFD 0.
    Types 1 BYTE, 2 ASCII (values a bytes string), 3 SHORT, 4 LONG, 5
    RATIONAL and 10 SRATIONAL (values (num, den) pairs flattened)."""
    import struct
    codes = {1: "B", 2: "B", 3: "H", 4: "I", 5: "I", 10: "i"}
    per = {1: 1, 2: 1, 3: 1, 4: 1, 5: 2, 10: 2}
    entries = sorted(entries)
    extra_at = offset + 2 + 12 * len(entries) + 4
    body, extra = b"", b""
    for tag, kind, values in entries:
        values = list(values)
        payload = struct.pack(f"{bo}{len(values)}{codes[kind]}", *values)
        count = len(values) // per[kind]
        if len(payload) <= 4:
            field = payload.ljust(4, b"\0")
        else:
            field = struct.pack(bo + "I", extra_at + len(extra))
            extra += payload + b"\0" * (len(payload) % 2)
        body += struct.pack(bo + "HHI", tag, kind, count) + field
    return (struct.pack(bo + "H", len(entries)) + body
            + struct.pack(bo + "I", 0) + extra)


def pack_bits(raw, bits):
    """The rows of a uint [H, W] array as `bits`-bit samples packed MSB
    first, each row padded to a whole byte (TIFF 6.0, FillOrder 1)."""
    import numpy as np
    H, W = raw.shape
    b = (raw.astype(np.uint32)[..., None] >> np.arange(bits - 1, -1, -1,
                                                       dtype=np.uint32)) & 1
    return np.packbits(b.reshape(H, W * bits).astype(np.uint8),
                       axis=1).tobytes()


def linearization_table(n, white):
    """A LinearizationTable of `n` entries: a square law from 0 to
    `white`, the curve of a camera that stores fewer bits than it
    measures (rounded; non-decreasing)."""
    import numpy as np
    x = np.arange(n, dtype=np.float64) / (n - 1)
    return np.round(white * x * x).astype(np.uint16)


def linearize_inverse(table, counts):
    """The stored samples whose table entries are nearest the counts (the
    first such where several are): what a writer stores so that a reader
    applying `table` gets table[stored] back."""
    import numpy as np
    t = table.astype(np.int64)
    hi = np.clip(np.searchsorted(t, counts, side="left"), 0, len(t) - 1)
    lo = np.clip(hi - 1, 0, len(t) - 1)
    c = counts.astype(np.int64)
    pick = np.where(np.abs(t[lo] - c) <= np.abs(t[hi] - c), lo, hi)
    # the first index of the chosen entry's value
    return np.searchsorted(t, t[pick], side="left").astype(np.uint16)


def write_dng(path, raw, compression="lj92", black=0, white=65535,
              color_matrix=None, neutral=(1.0, 1.0, 1.0), tile=256,
              bits=16, table=None):
    """Writes a uint16 RGGB mosaic [H, W] as a DNG 1.4 file laid out as
    cameras write them: IFD0 an 8-bit RGB thumbnail (NewSubFileType 1, a
    quarter of the size, every 4th pixel of the mosaic's green sites
    scaled to 8 bits), its SubIFD the raw (NewSubFileType 0, CFA,
    BlackLevel and WhiteLevel, a LinearizationTable where `table` is
    given), `compression` "none" (one strip of 16-bit samples, or of
    `bits`-bit samples packed MSB first, pack_bits) or "lj92" (`tile` x
    `tile` lossless JPEG tiles of 16 bits, lj92_encode_tiles). `raw` is
    the stored samples. Little-endian. Returns the bytes written."""
    import numpy as np
    raw = np.ascontiguousarray(raw, np.uint16)
    if compression == "lj92" and bits != 16:
        raise ValueError("write_dng: lossless JPEG tiles are 16 bits")
    H, W = raw.shape
    cm = np.eye(3) if color_matrix is None else np.asarray(color_matrix)
    thumb = (raw[1::4, 0::4].astype(np.float64) * (255.0 / 65535.0))
    thumb = np.round(thumb).astype(np.uint8)
    thumb = np.repeat(thumb[..., None], 3, -1)
    th, tw = thumb.shape[:2]
    if compression == "lj92":
        blocks = lj92_encode_tiles(raw, tile)
        layout = [(322, 4, [tile]), (323, 4, [tile])]
    elif compression == "none":
        blocks = [raw.astype("<u2").tobytes() if bits == 16 else
                  pack_bits(raw, bits)]
        layout = [(278, 4, [H])]
    else:
        raise ValueError(f"compression {compression!r}: none or lj92")
    srat = [v for x in cm.reshape(-1) for v in (int(round(x * 10000)),
                                                10000)]
    rat = [v for x in neutral for v in (int(round(x * 10000)), 10000)]
    ifd0 = [(254, 4, [1]), (256, 4, [tw]), (257, 4, [th]),
            (258, 3, [8, 8, 8]), (259, 3, [1]), (262, 3, [2]),
            (273, 4, [0]), (277, 3, [3]), (278, 4, [th]),
            (279, 4, [thumb.size]), (284, 3, [1]), (330, 4, [0]),
            (50706, 1, [1, 4, 0, 0]), (50707, 1, [1, 1, 0, 0]),
            (50708, 2, list(b"raw_ngp synthetic\0")),
            (50721, 10, srat), (50722, 10, srat), (50728, 5, rat),
            (50778, 3, [21])]
    offsets_tag, counts_tag = (324, 325) if compression == "lj92" else \
        (273, 279)
    if table is not None:
        layout = layout + [(50712, 3, [int(v) for v in table])]
    sub = [(254, 4, [0]), (256, 4, [W]), (257, 4, [H]), (258, 3, [bits]),
           (259, 3, [7 if compression == "lj92" else 1]),
           (262, 3, [32803]), (277, 3, [1]), (284, 3, [1]),
           (33421, 3, [2, 2]), (33422, 1, [0, 1, 1, 2]),
           (50714, 4, [int(black)]), (50717, 4, [int(white)]),
           (offsets_tag, 4, [0] * len(blocks)),
           (counts_tag, 4, [len(b) for b in blocks])] + layout
    # sizes do not depend on the offsets: lay out once, then fill them in
    at0 = 8
    size0 = len(_tiff_ifd(ifd0, at0))
    at1 = at0 + size0
    size1 = len(_tiff_ifd(sub, at1))
    data_at = at1 + size1
    thumb_at = data_at
    block_at = []
    at = thumb_at + thumb.size
    for b in blocks:
        at += at % 2
        block_at.append(at)
        at += len(b)
    ifd0 = [(t, k, [thumb_at] if t == 273 else [at1] if t == 330 else v)
            for t, k, v in ifd0]
    sub = [(t, k, block_at if t == offsets_tag else v) for t, k, v in sub]
    out = bytearray(b"II*\0" + (8).to_bytes(4, "little"))
    out += _tiff_ifd(ifd0, at0) + _tiff_ifd(sub, at1) + thumb.tobytes()
    for b, where in zip(blocks, block_at):
        out += b"\0" * (where - len(out)) + b
    with open(path, "wb") as f:
        f.write(out)
    return bytes(out)


class timed_calls:
    """While active, each call of the targeted functions (module or class
    attributes, given as (stage, owner, attribute name)) is timed on the
    host clock and kept in order as (stage, seconds, result) in `calls`."""

    def __init__(self, targets):
        self.targets = targets
        self.calls = []
        self.first_args = []

    def __enter__(self):
        self.saved = []
        for stage, owner, name in self.targets:
            fn = getattr(owner, name)
            self.saved.append((owner, name, fn))
            setattr(owner, name, self._timed(stage, fn))
        return self

    def _timed(self, stage, fn):
        def call(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            self.calls.append((stage, time.perf_counter() - t0, out))
            self.first_args.append(args[0] if args else None)
            return out
        return call

    def __exit__(self, *exc):
        for owner, name, fn in self.saved:
            setattr(owner, name, fn)

    def totals(self):
        """{stage: seconds summed over its calls}, every stage named."""
        out = {stage: 0.0 for stage, _, _ in self.targets}
        for stage, seconds, _ in self.calls:
            out[stage] += seconds
        return out


LOAD_STAGES = {"colmap_parse": ("providers", ("read_cameras_binary",
                                              "read_images_binary",
                                              "read_points3d_binary")),
               "png_decode": ("image_io", ("load_ldr_image",)),
               "near_far": ("providers", ("sparse_depth_near_far",))}


# the HDR loads' stages: the decode of each capture (EXR or DNG) and the
# whole of load_hdr_image, which holds it (levels, demosaic, resize, mask)
HDR_LOAD_STAGES = {"colmap_parse": LOAD_STAGES["colmap_parse"],
                   "decode": ("image_io", ("load_exr_image",
                                           "load_dng_raw")),
                   "hdr_image": ("image_io", ("load_hdr_image",)),
                   "near_far": LOAD_STAGES["near_far"]}


def timed_load_stages(stages=LOAD_STAGES):
    """While active, the COLMAP loader's stages are timed: the binary
    parses (colmap_io readers), the image decodes (image_io.load_ldr_image:
    PNG decode, and resize where the size differs) and the sparse-depth
    near/far (timed_calls: `totals()` sums each stage's calls), or the
    stages of `stages`."""
    import importlib
    targets = []
    for stage, (module, names) in stages.items():
        mod = importlib.import_module(f"raw_ngp_torch.data.{module}")
        targets += [(stage, mod, name) for name in names]
    return timed_calls(targets)


def march_recorder():
    """Wraps the occupancy render's march_rays (the module attribute that
    render_occupancy calls) to keep each call's nears, fars, ts and mask;
    returns (the records, a function that puts march_rays back)."""
    from raw_ngp_torch.render import occupancy
    march = occupancy.march_rays
    calls = []

    def recorded(rays_o, rays_d, bitfield, nears, fars, *args, **kwargs):
        out = march(rays_o, rays_d, bitfield, nears, fars, *args, **kwargs)
        calls.append({"nears": nears.detach(), "fars": fars.detach(),
                      "ts": out["ts"].detach(), "mask": out["mask"]})
        return out

    occupancy.march_rays = recorded

    def restore():
        occupancy.march_rays = march

    return calls, restore


def clamp_check(tr, batch, generator_fn):
    """Every live sample (march mask, ray not missing the box) of one
    training render of `batch` lies within its ray's camera's [near, far]
    (batch["cam_near_far"]), its t within [near, far] of the camera and
    the render's span; returns the counts."""
    import torch
    from raw_ngp_torch.ops.rays import near_far_from_aabb
    from raw_ngp_torch.train.trainer import make_batch_loss_fn
    calls, restore = march_recorder()
    try:
        with torch.no_grad():
            make_batch_loss_fn(tr.cfg, tr.spec)(
                tr.field, tr.state, batch, tr.aabb, generator_fn())
    finally:
        restore()
    check(len(calls) == 1, f"disk: {len(calls)} marches in one render")
    c = calls[0]
    cnf = batch["cam_near_far"]
    # the render's own miss test, after the clamp
    _, fars = near_far_from_aabb(batch["rays_o"], batch["rays_d"], tr.aabb,
                                 tr.cfg.render.min_near)
    live = c["mask"] & ~(torch.minimum(fars, cnf[:, 1:]) >= 1e8)
    near = cnf[:, :1].expand_as(c["ts"])[live]
    far = cnf[:, 1:].expand_as(c["ts"])[live]
    t = c["ts"][live]
    inside = (t >= near) & (t <= far)
    spans = bool(((c["nears"] >= cnf[:, :1]) & (c["fars"] <= cnf[:, 1:])
                  ).all())
    out = {"rays": int(cnf.shape[0]), "live_samples": int(live.sum()),
           "rays_with_empty_span": int((c["nears"] > c["fars"]).sum()),
           "outside": int((~inside).sum()),
           "spans_within_camera_range": spans,
           "min_t_minus_near": float((t - near).min()) if t.numel() else None,
           "min_far_minus_t": float((far - t).min()) if t.numel() else None}
    print(f"[disk] clamp: {out}")
    check(out["live_samples"] > 0 and out["outside"] == 0 and spans,
          "disk: a live sample lies outside its camera's [near, far]")
    return out


def disk_config(root):
    """The flagship on the COLMAP scene at `root`, with per-camera
    near/far; data.scale 1.0 keeps the synthetic scene's units (cameras on
    a ring of radius 2.2, the spheres within 1 of the points' mean, so
    inside the bound 2), where the default -1 would shrink the mean camera
    distance to 1."""
    cfg = flagship_config()
    return replace(cfg, data=replace(
        cfg.data, path=str(root), data_format="colmap",
        enable_cam_near_far=True, scale=1.0)).validate()


def phase_disk(dev, train_launches, steps=128, timed=32, repro=32,
               large=512):
    """The flagship trained from a COLMAP scene on disk: the scene of the
    train phase (make_synthetic_scene(36, 2, 128, 128), its 38 views in
    order) written with the port's writers (write_colmap_scene), loaded by
    raw_ngp_torch.data.load_scene for "train" and "val" (every 8th view)
    with enable_cam_near_far, each stage timed, the images checked bit for
    bit against round(255 img) / 255 of the written scene; the val PSNR
    (EMA) untrained; `steps` steps with every launch counter reset just
    before and read just after: the fold, the encode with and without
    records, B2's flat form and the dense level launched as many times as
    in the train phase (`train_launches`); finite falling losses; the val
    PSNR (EMA) above the untrained field's; the clamp check on a fixed
    batch (march jitter 0.5 and drawn); the fixed batch on the kernel and
    the plain path; one 512x512 render of a val view; the step's stages
    and profile; and the repro check over the first `repro` steps."""
    import shutil
    import numpy as np
    import torch
    from raw_ngp_torch.data import load_scene, make_synthetic_scene
    from raw_ngp_torch.data.sampler import sample_ray_batch
    from raw_ngp_torch.kernels import _build
    from raw_ngp_torch.train.trainer import Trainer

    t_phase = time.perf_counter()
    train_s, val_s = make_synthetic_scene(n_train=36, n_val=2, H=128, W=128)
    images = np.concatenate([train_s.images, val_s.images])
    poses = np.concatenate([train_s.poses, val_s.poses])
    root = _build.BUILD_DIR.parent / "disk_scene"
    shutil.rmtree(root, ignore_errors=True)
    try:
        t0 = time.perf_counter()
        n_points = write_colmap_scene(str(root), images, poses,
                                      train_s.intrinsics)
        write_s = time.perf_counter() - t0
        cfg = disk_config(root)
        load = {}
        scenes = {}
        for split in ("train", "val"):
            # center_poses takes a random perturbation where the cameras'
            # mean up vector is opposite to +z: seed numpy's global stream
            np.random.seed(0)
            t0 = time.perf_counter()
            with timed_load_stages() as stages:
                scenes[split] = load_scene(cfg, split)
            total = time.perf_counter() - t0
            seconds = stages.totals()
            load[split] = dict(seconds, total=total,
                               other=total - sum(seconds.values()))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    train_d, val_d = scenes["train"], scenes["val"]
    ids = np.arange(len(images))
    want = {"train": np.setdiff1d(ids, ids[::8]), "val": ids[::8]}
    for split, scene in scenes.items():
        ref = (np.round(images[want[split]] * 255.0).astype(np.uint8)
               .astype(np.float32) / 255.0)
        check(scene.images.shape == ref.shape
              and scene.images.dtype == np.float32
              and same_bits(torch.from_numpy(scene.images),
                            torch.from_numpy(ref)),
              f"disk: the loaded {split} images are not the written ones")
    cnf = train_d.cam_near_far
    check(cnf is not None and cnf.shape == (train_d.n_images, 2)
          and bool(np.isfinite(cnf).all()) and bool((cnf[:, 0] > 0).all())
          and bool((cnf[:, 1] > cnf[:, 0]).all()),
          "disk: no per-camera near/far")
    pixels = len(images) * images.shape[1] * images.shape[2]
    decode_s = load["train"]["png_decode"] + load["val"]["png_decode"]
    print(f"[disk] wrote {len(images)} views and {n_points} points in "
          f"{write_s:.2f} s; loaded (s) {json.dumps(load)}; PNG decode "
          f"{decode_s / pixels * 1e6:.4f} s a megapixel; cam_near_far near "
          f"{cnf[:, 0].min():.4f}..{cnf[:, 0].max():.4f}, far "
          f"{cnf[:, 1].min():.4f}..{cnf[:, 1].max():.4f}; images bitwise "
          f"round(255 img) / 255; pts_aabb {train_d.pts_aabb.tolist()}")

    t0 = time.perf_counter()
    tr = Trainer(cfg, train_d, val_d, device=dev,
                 workspace=scratch_workspace())
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    check("cam_near_far" in tr.scene_arrays,
          "disk: the Trainer left out cam_near_far")
    psnr_0, _ = evaluate_counted(tr)
    print(f"[disk] Trainer ready in {init_s:.2f} s; val PSNR (EMA) "
          f"untrained {psnr_0:.3f} dB over {val_d.n_images} views")
    snap = trainer_snapshot(tr)
    launches, (first, last), step_ms, ref = run_steps(
        tr, steps, TRAIN_KERNELS, "disk", capture_at=repro)
    same = {k: (launches[k], train_launches[k]) for k in TRAIN_KERNELS}
    check(all(a == b for a, b in same.values()),
          f"disk: launches differ from the train phase's {same}")
    window = step_ms[-timed:]
    med = sorted(window)[timed // 2]
    psnr, launches["hash_encode_by_caller"]["eval"] = evaluate_counted(tr)
    print(f"[disk] last {timed} steps: median {med:.3f} ms/step; val PSNR "
          f"(EMA) {psnr_0:.3f} -> {psnr:.3f} dB")
    check(psnr > psnr_0, "disk: val PSNR did not rise above the untrained "
          "field's")

    sa = tr.scene_arrays
    gen = torch.Generator(device=dev).manual_seed(5)
    batch = sample_ray_batch(gen, sa["images"], sa["poses"],
                             sa["intrinsics"], tr.num_rays,
                             cam_near_far=sa["cam_near_far"])
    check(torch.equal(batch["cam_near_far"],
                      sa["cam_near_far"][batch["index"]]),
          "disk: the batch's near/far are not its cameras'")
    clamp = {"jitter_0.5": clamp_check(tr, batch, lambda: None),
             "jitter_drawn": clamp_check(
                 tr, batch,
                 lambda: torch.Generator(device=dev).manual_seed(6))}
    fixed = fixed_batch_check(tr, lambda: batch, "disk")

    intr = np.asarray(val_d.intrinsics) * (large / val_d.W)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rgb, depth = tr.render_image(val_d.poses[0], intr, large, large)
    torch.cuda.synchronize()
    render_ms = (time.perf_counter() - t0) * 1e3
    check(rgb.shape == (large, large, 3) and bool(np.isfinite(rgb).all())
          and bool(np.isfinite(depth).all()),
          "disk: the 512x512 render is not finite")
    print(f"[disk] {large}x{large} render of val view 0 in "
          f"{render_ms:.2f} ms")
    disk = {"config": "flagship (with_preset_O + with_tpu_profile, fp16, "
                      "num_rays 8192), data_format colmap, "
                      "enable_cam_near_far, scale 1.0",
            "scene": "make_synthetic_scene(36, 2, 128, 128) written as a "
                     "COLMAP dataset (38 views, 8-bit PNG), loaded by "
                     "load_scene (train 33, val 5)",
            "gpu": gpu_line(), "points": n_points,
            "write_s": write_s, "load_s": load,
            "png_decode_s_per_megapixel": decode_s / pixels * 1e6,
            "cam_near_far": {"near_min": float(cnf[:, 0].min()),
                             "near_max": float(cnf[:, 0].max()),
                             "far_min": float(cnf[:, 1].min()),
                             "far_max": float(cnf[:, 1].max())},
            "images_bitwise": True, "trainer_init_s": init_s,
            "steps": steps, "grid_refreshes": tr.host_grid_updates,
            "num_rays": tr.num_rays,
            "ms_per_step": med, "ms_per_step_runs": window,
            "val_psnr_ema_untrained": psnr_0, "val_psnr_ema": psnr,
            "loss_first8": first, "loss_last8": last,
            "launches_as_train_phase": same, "clamp": clamp,
            "fixed_batch_kernel_vs_plain": fixed,
            "render_512_ms": render_ms,
            "stages_ms": step_breakdown(tr),
            "profile": profile_device(tr.step, 1, "step")}
    disk["repro"], disk["dispatch"] = repro_check(tr, snap, ref, repro, "disk")
    disk["seconds"] = time.perf_counter() - t_phase
    return launches, disk


def decode_agrees(got, want):
    """Whether a decode `got` is what a reader must give, `want` (an array:
    bit for bit; a DwaRead: inside its band), and the share of samples bit
    for bit `want`'s (values)."""
    import numpy as np
    if not isinstance(want, DwaRead):
        return same_bits_np(got, want), 1.0
    if got.shape != want.values.shape:
        return False, 0.0
    ok = bool(((want.lo <= got) & (got <= want.hi)).all())
    return ok, float((got.view(np.uint32)
                      == want.values.view(np.uint32)).mean())


def same_bits_np(a, b):
    """Two numpy arrays of the same dtype, shape and values."""
    import numpy as np
    return a.dtype == b.dtype and a.shape == b.shape and \
        bool(np.array_equal(a, b))


def host_image(seed, H=3024, W=4032):
    """A photo-like H x W RGB uint8 image drawn from `seed`: a random
    field at 1/32 of the size enlarged by resize_area (cv2's INTER_AREA
    upscale: smooth shading) plus N(0, 6) grain, so the JPEG carries
    every DCT frequency as a camera frame does."""
    import numpy as np
    from raw_ngp_torch.data.image_io import resize_area
    rng = np.random.default_rng(seed)
    field = rng.random((H // 32, W // 32, 3)).astype(np.float32)
    img = resize_area(field, H, W) * 255 + rng.normal(0, 6, (H, W, 3))
    return np.clip(img, 0, 255).astype(np.uint8)


def jpeg_host_timings(seed, quality=95):
    """The JPEG work on one 4032 x 3024 image (host_image(seed)) by route,
    the C++ entropy coder (native) and the pure-Python one, in seconds a
    megapixel on the host clock: the encode at `quality` (4:2:0 baseline,
    cv2.imwrite's bytes), and the decode of that file and of the same
    coefficients written progressively (spectral selection, the port's
    writer); both routes give the same bytes and pixels, and the two
    files the same pixels."""
    from raw_ngp_torch.data import jpeg
    img = host_image(seed)
    mp = img.shape[0] * img.shape[1] / 1e6
    files, out, pixels = {}, {}, {}
    t0 = time.perf_counter()
    files["progressive"] = jpeg.encode_jpeg(img, quality, "native",
                                            progressive=True)
    prog_s = time.perf_counter() - t0
    for route in ("native", "python"):
        row = {}
        t0 = time.perf_counter()
        data = jpeg.encode_jpeg(img, quality, route)
        row["encode_s_per_megapixel"] = (time.perf_counter() - t0) / mp
        check(files.setdefault("baseline", data) == data,
              f"jpeg: the {route} encode's bytes differ")
        for kind in ("baseline", "progressive"):
            t0 = time.perf_counter()
            got = jpeg.decode_jpeg(files[kind], kind, route)
            row[f"decode_{kind}_s_per_megapixel"] = \
                (time.perf_counter() - t0) / mp
            ref = pixels.setdefault("any", got)
            check(got.shape == img.shape and same_bits_np(got, ref),
                  f"jpeg: the {route} decode of the {kind} file differs")
        out[route] = row
        print(f"[jpeg] host {img.shape[1]}x{img.shape[0]} by route "
              f"{route}: {json.dumps(row)}")
    return {"image": f"host_image(seed={seed}): {img.shape[1]}x"
                     f"{img.shape[0]} RGB, quality {quality}, 4:2:0",
            "megapixels": mp, "baseline_bytes": len(files["baseline"]),
            "progressive_bytes": len(files["progressive"]),
            "progressive_encode_native_s": prog_s, "routes": out,
            "routes_same_bytes_and_pixels": True}


def phase_jpeg(dev, train_launches, seed=0, steps=128, timed=32,
               repro=32, quality=95):
    """The flagship trained from a COLMAP scene of JPEGs, read without
    cv2: the disk phase's 38 views written as a COLMAP folder of
    `.jpg` files at `quality` (write_colmap_scene, image_format "jpg":
    cv2.imwrite's bytes), every file decoded by both routes (the C++ and
    the Python entropy decode) bit for bit alike, the decoded views' PSNR
    against the scene's 8-bit views, the load (load_scene, train and val)
    timed by stage and its images bit for bit the decodes / 255; the
    untrained val PSNR (EMA); `steps` steps with every launch counter
    reset just before and read just after: the fold, the encode with and
    without records, B2's flat form and the dense level launched as many
    times as in the train phase (`train_launches`), finite falling
    losses, the val PSNR (EMA) above the untrained field's, the repro
    check over the first `repro` steps; then `downscale --factor 2` and
    `--factor 3` on the folder (JPEG in, JPEG out) and loads at
    downscale 2 (64 x 64, the files' size) and 3 (43 x 43 from the tool's
    42 x 42 files: the area resize's upscale); and the host timings of
    jpeg_host_timings(seed). The JPEG library must build here: no quiet
    fallback. Returns (launches, numbers)."""
    import shutil
    import numpy as np
    import torch
    from raw_ngp_torch import native
    from raw_ngp_torch.data import jpeg, load_scene, make_synthetic_scene
    from raw_ngp_torch.data.image_io import resize_area
    from raw_ngp_torch.kernels import _build
    from raw_ngp_torch.tools import downscale
    from raw_ngp_torch.train.trainer import Trainer

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    check(native.jpeg_library() is not None and native.available(),
          "jpeg: the JPEG library or the host library did not build")
    build_s = time.perf_counter() - t0
    train_s, val_s = make_synthetic_scene(n_train=36, n_val=2, H=128, W=128)
    images = np.concatenate([train_s.images, val_s.images])
    poses = np.concatenate([train_s.poses, val_s.poses])
    eight_bit = np.round(images * 255.0).astype(np.uint8)
    root = _build.BUILD_DIR.parent / "jpeg_scene"
    shutil.rmtree(root, ignore_errors=True)
    try:
        t0 = time.perf_counter()
        n_points = write_colmap_scene(str(root), images, poses,
                                      train_s.intrinsics,
                                      image_format="jpg", quality=quality)
        write_s = time.perf_counter() - t0
        paths = [str(root / "images" / f"img_{i:03d}.jpg")
                 for i in range(len(images))]
        decoded, route_s = {}, {}
        for route in ("native", "python"):
            t0 = time.perf_counter()
            decoded[route] = np.stack([jpeg.read_jpeg(p, route)
                                       for p in paths])
            route_s[route] = time.perf_counter() - t0
        check(same_bits_np(decoded["native"], decoded["python"]),
              "jpeg: the C++ and Python routes decode the views differently")
        views = decoded["native"]
        mse = float(np.mean((views.astype(np.float64)
                             - eight_bit.astype(np.float64)) ** 2))
        view_psnr = 10 * math.log10(255.0 ** 2 / mse)
        cfg = disk_config(root)
        load, scenes = {}, {}
        for split in ("train", "val"):
            np.random.seed(0)
            t0 = time.perf_counter()
            with timed_load_stages() as stages:
                scenes[split] = load_scene(cfg, split)
            total = time.perf_counter() - t0
            seconds = stages.totals()
            seconds["jpeg_decode"] = seconds.pop("png_decode")
            load[split] = dict(seconds, total=total,
                               other=total - sum(seconds.values()))
        ids = np.arange(len(images))
        want = {"train": np.setdiff1d(ids, ids[::8]), "val": ids[::8]}
        for split, scene in scenes.items():
            ref = views[want[split]].astype(np.float32) / 255.0
            check(scene.images.dtype == np.float32
                  and same_bits_np(scene.images, ref),
                  f"jpeg: the loaded {split} images are not the decodes")
        smaller = {}
        for factor in (2, 3):
            size = int(round(images.shape[1] / factor))
            downscale.main([str(root), "--factor", str(factor)])
            files = sorted(os.listdir(root / f"images_{factor}"))
            check(files == sorted(os.listdir(root / "images")),
                  f"jpeg: downscale --factor {factor} wrote {files[:3]}...")
            small = jpeg.read_jpeg(str(root / f"images_{factor}" / files[0]))
            np.random.seed(0)
            scene = load_scene(replace(cfg, data=replace(
                cfg.data, downscale=factor)), "val")
            ref = resize_area(small, size, size).astype(np.float32) / 255.0
            check(scene.images.shape == (len(want["val"]), size, size, 3)
                  and same_bits_np(scene.images[0], ref),
                  f"jpeg: the load at downscale {factor}")
            smaller[factor] = {"file_size": list(small.shape[:2]),
                               "loaded_size": [size, size],
                               "upscaled": small.shape[0] < size}
        check(smaller[3]["upscaled"], "jpeg: no load needed the upscale")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    train_d, val_d = scenes["train"], scenes["val"]
    pixels = len(images) * images.shape[1] * images.shape[2]
    print(f"[jpeg] wrote {len(images)} views (quality {quality}) and "
          f"{n_points} points in {write_s:.2f} s; decode s a megapixel by "
          f"route {json.dumps({k: v / pixels * 1e6 for k, v in route_s.items()})}"
          f" (bitwise alike); views' PSNR against the 8-bit views "
          f"{view_psnr:.3f} dB; loaded (s) {json.dumps(load)}; downscaled "
          f"{json.dumps(smaller)}")

    t0 = time.perf_counter()
    tr = Trainer(cfg, train_d, val_d, device=dev,
                 workspace=scratch_workspace())
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    psnr_0, _ = evaluate_counted(tr)
    print(f"[jpeg] Trainer ready in {init_s:.2f} s; val PSNR (EMA) "
          f"untrained {psnr_0:.3f} dB over {val_d.n_images} views")
    snap = trainer_snapshot(tr)
    launches, (first, last), step_ms, ref = run_steps(
        tr, steps, TRAIN_KERNELS, "jpeg", capture_at=repro)
    same = {k: (launches[k], train_launches[k]) for k in TRAIN_KERNELS}
    check(all(a == b for a, b in same.values()),
          f"jpeg: launches differ from the train phase's {same}")
    window = step_ms[-timed:]
    med = sorted(window)[timed // 2]
    psnr, launches["hash_encode_by_caller"]["eval"] = evaluate_counted(tr)
    print(f"[jpeg] last {timed} steps: median {med:.3f} ms/step; val PSNR "
          f"(EMA) {psnr_0:.3f} -> {psnr:.3f} dB")
    check(psnr > psnr_0, "jpeg: val PSNR did not rise above the untrained "
          "field's")
    out = {"config": "the disk phase's: flagship, data_format colmap, "
                     "enable_cam_near_far, scale 1.0",
           "scene": f"make_synthetic_scene(36, 2, 128, 128) written as a "
                    f"COLMAP dataset of JPEGs (quality {quality}, 4:2:0; "
                    f"38 views), loaded by load_scene (train 33, val 5)",
           "gpu": gpu_line(), "library_first_use_s": build_s,
           "points": n_points, "write_s": write_s,
           "decode_s_per_megapixel_by_route": {
               k: v / pixels * 1e6 for k, v in route_s.items()},
           "routes_bitwise": True, "views_psnr_vs_8bit_db": view_psnr,
           "load_s": load, "images_bitwise_decodes": True,
           "downscaled": smaller, "trainer_init_s": init_s,
           "steps": steps, "num_rays": tr.num_rays, "ms_per_step": med,
           "ms_per_step_runs": window, "val_psnr_ema_untrained": psnr_0,
           "val_psnr_ema": psnr, "loss_first8": first, "loss_last8": last,
           "launches_as_train_phase": same}
    out["repro"], out["dispatch"] = repro_check(tr, snap, ref, repro, "jpeg")
    del tr
    out["host"] = jpeg_host_timings(seed, quality)
    out["seconds"] = time.perf_counter() - t_phase
    return launches, out


def pose_config(steps, n_cameras=36):
    """The flagship with BARF refinement and the noise self-test; iters =
    `steps`, so the annealing ramp and the pose freeze fall in the run."""
    cfg = flagship_config().with_pose_opt("barf", n_cameras)
    cfg = replace(cfg, train=replace(cfg.train, iters=steps),
                  pose_opt=replace(cfg.pose_opt, noise=0.05))
    return cfg.validate()


def phase_pose(dev, steps=128, timed=32, repro=32):
    """Pose refinement through the Trainer's entry points: `steps` steps
    with every launch counter reset just before and read just after, the
    checks, the Procrustes pose errors before and after, a fixed-batch
    kernel-vs-plain step (pose gradient included), a profile of one step
    and the repro check over the first `repro` steps (pose params and
    moments included)."""
    import torch
    from raw_ngp_torch.data import make_synthetic_scene
    from raw_ngp_torch.data.sampler import sample_ray_batch
    from raw_ngp_torch.train.pose_analysis import analyze_pose_optimization
    from raw_ngp_torch.train.trainer import Trainer, annealing_at

    cfg = pose_config(steps)
    train_s, val_s = make_synthetic_scene(n_train=36, n_val=2, H=128, W=128)
    t0 = time.perf_counter()
    tr = Trainer(cfg, train_s, val_s, device=dev,
                 workspace=scratch_workspace())
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    err0 = analyze_pose_optimization(tr)
    print(f"[pose] Trainer ready in {init_s:.2f} s; pose errors before: "
          f"{err0}; freeze at step "
          f"{int(cfg.pose_opt.end_annealing * cfg.train.iters)}")
    snap = trainer_snapshot(tr)
    launches, (first, last), step_ms, ref = run_steps(
        tr, steps, POSE_KERNELS, "pose", capture_at=repro)
    pose = tr.state.pose_params.detach()
    check(bool(torch.isfinite(pose).all()), "pose: pose params not finite")
    check(float(pose.abs().max()) > 0, "pose: the pose params never moved")
    err1 = analyze_pose_optimization(tr)
    print(f"[pose] pose errors after {steps} steps: {err1} (before {err0}); "
          f"largest refinement {float(pose.abs().max()):.3e}")
    window = step_ms[-timed:]
    med = sorted(window)[timed // 2]
    psnr, launches["hash_encode_by_caller"]["eval"] = evaluate_counted(tr)
    print(f"[pose] last {timed} steps: median {med:.3f} ms/step, "
          f"{tr.num_rays / med * 1e3:.0f} rays/s; val PSNR (EMA) "
          f"{psnr:.3f} dB")

    gen = torch.Generator(device=dev).manual_seed(9)
    sa, st = tr.scene_arrays, tr.state
    n = tr.num_rays
    coords = torch.stack([torch.randint(0, 128, (n,), generator=gen,
                                        device=dev),
                          torch.randint(0, 128, (n,), generator=gen,
                                        device=dev)], -1)
    idx = torch.randint(0, 36, (n,), generator=gen, device=dev)

    def batch_fn():
        batch = sample_ray_batch(
            None, sa["images"], sa["poses"], sa["intrinsics"], n,
            random_image_batch=False, se3_refine=st.pose_params,
            pose_noise=st.pose_noise, coords=coords,
            coord_image_indices=idx)
        batch["coarse_lin"] = sa["coarse_lin"]
        return batch

    fixed = fixed_batch_check(tr, batch_fn, "pose",
                              annealing=annealing_at(cfg, steps // 4))
    out = {"config": "flagship + with_pose_opt('barf', 36), "
                     "pose_opt.noise 0.05, train.iters 128",
           "scene": "make_synthetic_scene(36, 2, 128, 128)",
           "steps": steps, "grid_refreshes": tr.host_grid_updates,
           "pose_freeze_step": int(cfg.pose_opt.end_annealing
                                   * cfg.train.iters),
           "num_rays": tr.num_rays, "ms_per_step": med,
           "rays_per_s": tr.num_rays / med * 1e3,
           "ms_per_step_runs": window, "val_psnr_ema": psnr,
           "loss_first8": first, "loss_last8": last,
           "pose_errors_before": err0, "pose_errors_after": err1,
           "largest_refinement": float(pose.abs().max()),
           "trainer_init_s": init_s,
           "fixed_batch_kernel_vs_plain": fixed}
    out["stages_ms"] = step_breakdown(tr)
    out["profile"] = profile_device(tr.step, 1, "step")
    out["repro"], out["dispatch"] = repro_check(tr, snap, ref, repro, "pose")
    return launches, out


def lightstage_config():
    """The light-stage slice: the flagship with HDR images, the clamped_exp
    colour head and rfield light conditioning (tools/quality_run.py --hdr
    --rfield)."""
    cfg = flagship_config()
    cfg = replace(cfg, data=replace(cfg.data, image_mode="HDR"),
                  model=replace(cfg.model, color_activation="clamped_exp",
                                rfield=True))
    return cfg.validate()


def phase_lightstage(dev, steps=128, timed=32, repro=32, large=512,
                     reps=7):
    """The light-stage path through the Trainer's entry points: `steps`
    HDR + rfield steps with every launch counter reset just before and
    read just after, the checks (the five kernels of the train path, the
    fold forward, the forward with records, B2's flat form and the dense
    level once a step; B2's 2C totals, the fold's backward and the input
    gradient never), the HDR val PSNR, the exposure levels, a fixed batch
    (exposure, ldir, Bayer lossmult) on the kernel and the plain path, a
    relit render, a profile of one step, the 512x512 render with a light
    direction (timed, and one chunk profiled) and the repro check over
    the first `repro` steps."""
    import numpy as np
    import torch
    from raw_ngp_torch.data import make_synthetic_scene
    from raw_ngp_torch.data.sampler import sample_ray_batch
    from raw_ngp_torch.ops.rays import full_image_rays
    from raw_ngp_torch.render.eval import (coarse_volume, make_eval_render,
                                           render_image)
    from raw_ngp_torch.train.trainer import Trainer

    t_phase = time.perf_counter()
    cfg = lightstage_config()
    train_s, val_s = make_synthetic_scene(n_train=36, n_val=2, H=128,
                                          W=128, hdr=True, rfield=True)
    t0 = time.perf_counter()
    tr = Trainer(cfg, train_s, val_s, device=dev,
                 workspace=scratch_workspace())
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    view_in = tr.field.view_mlp[0].shape
    print(f"[lightstage] Trainer ready in {init_s:.2f} s; view MLP "
          f"{[tuple(w.shape) for w in tr.field.view_mlp]}")
    check(tuple(view_in) == (15 + 16 + 16, 64 + 16),
          f"lightstage: view MLP input layer {tuple(view_in)}")
    snap = trainer_snapshot(tr)
    launches, (first, last), step_ms, ref = run_steps(
        tr, steps, TRAIN_KERNELS, "lightstage", capture_at=repro)
    check(launches["decimate_compact"] == steps, f"lightstage: the fold "
          f"launched {launches['decimate_compact']} times in {steps} steps")
    for name in ("decimate_compact_bwd", "encode_input_grad",
                 "segment_totals_channel"):
        check(launches[name] == 0, f"lightstage: kernel {name} is off the "
              f"path but launched {launches[name]} times")
    by_caller = launches["hash_encode_by_caller"]
    check(by_caller["refresh_chunks"] > 0,
          "lightstage: no grid refresh chunk was encoded")
    window = step_ms[-timed:]
    med = sorted(window)[timed // 2]
    psnr, by_caller["eval"] = evaluate_counted(tr)
    check(by_caller["eval"] > 0, "lightstage: evaluate encoded nothing")
    check(bool(np.isfinite(psnr)), f"lightstage: val PSNR {psnr}")
    # the val views' exposures are 4.0, so evaluate finds no exposure-1.0
    # view there; the levels come from the train scene's first one
    levels = tr.estimate_exposure_levels(train_s)
    vals = [levels[p] for p in sorted(levels)]
    check(set(levels) == set(cfg.exposure_percentiles)
          and all(np.isfinite(v) for v in vals) and vals == sorted(vals),
          f"lightstage: exposure levels {levels}")
    print(f"[lightstage] last {timed} steps: median {med:.3f} ms/step, "
          f"{tr.num_rays / med * 1e3:.0f} rays/s; HDR val PSNR (EMA, "
          f"min(1, rgb * exposure) vs min(1, gt)) {psnr:.3f} dB; exposure "
          f"levels {levels}")

    gen = torch.Generator(device=dev).manual_seed(7)
    sa = tr.scene_arrays
    batch = sample_ray_batch(gen, sa["images"], sa["poses"],
                             sa["intrinsics"], tr.num_rays,
                             exposures=sa["exposures"], ldirs=sa["ldirs"],
                             mosaiced=True)
    batch["coarse_lin"] = sa["coarse_lin"]
    fixed = fixed_batch_check(tr, lambda: batch, "lightstage")

    # relighting: one val view under its own and the mirrored light
    pose, ld = val_s.poses[0], val_s.ldirs[0]
    ld_m = -ld * np.array([1.0, 1.0, -1.0], np.float32)
    rgb_a, _ = tr.render_image(pose, ldir=ld)
    rgb_b, _ = tr.render_image(pose, ldir=ld_m)
    relit = float(np.abs(rgb_a - rgb_b).mean())
    print(f"[lightstage] relighting at 128x128: mean |diff| {relit:.6f}")
    check(np.isfinite(rgb_a).all() and np.isfinite(rgb_b).all(),
          "lightstage: a relit render is not finite")
    check(relit > 0, "lightstage: the light direction changes nothing")

    # the 512x512 render with a light direction, each of `reps` timed
    intr_l = val_s.intrinsics * (large / 128.0)

    def render_large():
        return render_image(tr.ema_field, tr.state.density_bitfield, pose,
                            intr_l, large, large, tr.aabb, device=dev,
                            ldir=ld)

    rgb_l, _ = render_large()
    check(bool(torch.isfinite(rgb_l).all()),
          "lightstage: the 512x512 render is not finite")
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        render_large()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    img_ms = sorted(times)[reps // 2]
    n_chunks = -(-large * large // cfg.render.max_ray_batch)
    # where one chunk's time goes: the large image's middle rows
    rays_o, rays_d = full_image_rays(
        torch.as_tensor(pose, device=dev), torch.as_tensor(intr_l,
                                                           device=dev),
        large, large)
    n = cfg.render.max_ray_batch
    s = (large * large - n) // 2
    ro, rd = rays_o[s:s + n], rays_d[s:s + n]
    ld_chunk = torch.as_tensor(ld, device=dev).expand(n, 3)
    bitfield = tr.state.density_bitfield
    coarse = coarse_volume(cfg, bitfield)
    render_chunk = make_eval_render(cfg)
    chunk_profile = profile_device(
        lambda: render_chunk(tr.ema_field, bitfield, ro, rd, tr.aabb,
                             coarse, 1.0, ld_chunk), 3, "chunk")

    out = {"config": "flagship (with_preset_O + with_tpu_profile, fp16, "
                     "num_rays 8192) + image_mode HDR, color_activation "
                     "clamped_exp, rfield",
           "scene": "make_synthetic_scene(36, 2, 128, 128, hdr=True, "
                    "rfield=True)",
           "steps": steps, "grid_refreshes": tr.host_grid_updates,
           "num_rays": tr.num_rays,
           "point_budget": tr._point_budget or tr.base_point_budget(),
           "ms_per_step": med, "rays_per_s": tr.num_rays / med * 1e3,
           "ms_per_step_runs": window, "hdr_val_psnr_ema": psnr,
           "exposure_levels": {str(k): v for k, v in levels.items()},
           "loss_first8": first, "loss_last8": last,
           "trainer_init_s": init_s,
           "fixed_batch_kernel_vs_plain": fixed,
           "relight_mean_abs_diff": relit,
           "render": {"image": f"{large}x{large}", "chunks": n_chunks,
                      "ms_per_image": img_ms, "ms_per_image_runs": times,
                      "ms_per_chunk": img_ms / n_chunks,
                      "rays_per_s": large * large / (img_ms / 1e3),
                      "profile": chunk_profile},
           "stages_ms": step_breakdown(tr),
           "profile": profile_device(tr.step, 1, "step"),
           "gpu": gpu_line()}
    out["repro"], out["dispatch"] = repro_check(tr, snap, ref, repro, "lightstage")
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"[lightstage] phase took {out['phase_s']:.1f} s")
    return launches, out


def proposal_config():
    """The -O2 preset at its reference width, unchanged: contraction (grid
    bound 2), fp16 (bf16 compute), 4,096 rays, num_steps (256, 96, 48),
    16 levels x 2 channels xor hash log2 19 for the radiance field, two
    proposal grids of 5 levels x 2 channels log2 17 at resolutions 128 and
    256."""
    from raw_ngp_torch import Config
    return Config().with_preset_O2().validate()


def captured_encodes(name, run):
    """The (table, x01, spec) of every call of
    ``raw_ngp_torch.kernels.hash_encode.<name>`` that run() makes: an
    encode's inputs at the shapes and positions the path gives it."""
    from raw_ngp_torch.kernels import hash_encode as th
    calls = []
    fn = getattr(th, name)

    def capture(params, x01, spec, *args, **kwargs):
        calls.append((params.detach(), x01.detach(), spec))
        return fn(params, x01, spec, *args, **kwargs)

    capture.launches = 0      # a wrapper counts on whatever it is bound to
    setattr(th, name, capture)
    try:
        run()
    finally:
        setattr(th, name, fn)
    return calls


def proposal_grid_checks(tr, batch):
    """The encode forward with records and the table gradient (the radix
    sort and B2's flat form, no dense level) held against their plain versions
    on the three -O2 grids at the points a train step gives them: the
    bf16 output and the records bit for bit, two calls the same bits; the
    table gradient for a seeded bf16 cotangent within rtol 1e-5 of the
    plain path's rows (atol 1e-6 of the largest); then each timed (CUDA
    events and device time) beside its bound, the plain versions and the
    window part's library yardstick."""
    import torch
    from raw_ngp_torch.kernels import hash_encode as th
    from raw_ngp_torch.train.trainer import make_batch_loss_fn
    bf16 = torch.bfloat16
    names = ["proposal 0", "proposal 1", "radiance field"]
    out = {}
    loss_fn = make_batch_loss_fn(tr.cfg, tr.spec)
    calls = captured_encodes("hash_encode_records", lambda: loss_fn(
        tr.field, tr.state, batch, tr.aabb, None))
    for name, (table, x01, spec) in zip(names, calls):
        B = x01.shape[0]
        L, C = spec.num_levels, spec.level_dim
        m = th.matmul_split(spec)
        wins = th.level_windows(spec, m)
        P = sum(nw for _, _, nw in wins)
        check(m == 0, f"proposal {name}: {m} dense matmul levels, expected 0")
        o, base, w_word = th.hash_encode_records(table, x01, spec, bf16)
        again = th.hash_encode_records(table, x01, spec, bf16)
        base_p, w_word_p = th.window_records_plain(x01, spec)
        o_p = th.hash_encode_fused_plain(table, x01, spec, bf16)
        torch.cuda.synchronize()
        check(same_bits(o, o_p) and torch.equal(base, base_p)
              and torch.equal(w_word, w_word_p),
              f"proposal {name}: the forward with records differs from its "
              "plain version")
        check(all(same_bits(a, b) for a, b in zip((o, base, w_word), again)),
              f"proposal {name}: two forwards differ")
        gen = torch.Generator(device=x01.device).manual_seed(11)
        g = torch.randn(B, L * C, generator=gen, device=x01.device).to(bf16)
        grad = th.table_grad(spec, x01, base, w_word, g, bf16)
        grad_2 = th.table_grad(spec, x01, base, w_word, g, bf16)
        grad_p = th.table_grad(spec, x01, base_p, w_word_p, g, bf16,
                               plain=True)
        torch.cuda.synchronize()
        scale = float(grad_p.abs().max())
        err = float((grad - grad_p).abs().max())
        check(same_bits(grad, grad_2), f"proposal {name}: two table "
              "gradients differ")
        check(scale > 0 and torch.allclose(grad, grad_p, rtol=1e-5,
                                           atol=1e-6 * scale),
              f"proposal {name}: table gradient max abs err {err} of "
              f"largest {scale}")

        def fwd():
            return th.hash_encode_records(table, x01, spec, bf16)

        def bwd():
            return th.table_grad(spec, x01, base, w_word, g, bf16)

        f_bound, f_by, f_bytes, rows = encode_bound(spec, x01, 2,
                                                    extra_bytes=8 * P * B)
        # the table gradient's inputs read once (the points, the records'
        # rows and weight words, the bf16 cotangent) and its rows written
        # once; its sorts move more (each record's key read, its sorted
        # key and int32 index written), which sort_bound_ms counts apart,
        # beside B2's own bound on the sorted streams
        b_bytes = (B * 12 + 8 * P * B + B * L * C * 2
                   + spec.n_params * C * 4)
        sort_bytes = 12 * P * B
        b_prof = profile_device(bwd, 5, "call")
        lib = window_library(spec, base, w_word, g)
        b2 = b2_alone(spec, base, w_word, g, grad_p)
        b2.update(library_ms=lib["ms"], library_device_ms=lib["device_ms"])
        row = dict(
            points=B, levels=L, windows_per_point=P, window_levels=len(wins),
            records=P * B, table_rows=spec.n_params, touched_rows=rows,
            forward=dict(ms=time_ms(fwd, 20), device_ms=device_ms(fwd, 5),
                         plain_ms=time_ms(lambda: (
                             th.hash_encode_fused_plain(table, x01, spec,
                                                        bf16),
                             th.window_records_plain(x01, spec)), 2),
                         bound_ms=f_bound, bound_by=f_by, bytes=f_bytes,
                         max_abs_err=0.0),
            table_grad=dict(
                ms=time_ms(bwd, 10),
                device_ms=b_prof.get("device_busy_ms_per_call"),
                device_launches_per_call=b_prof.get(
                    "kernel_launches_per_call"),
                stages_device_ms=stage_split(b_prof, FLAT_STAGES
                                             + SORT_STAGES, "other"),
                plain_ms=time_ms(lambda: th.table_grad(
                    spec, x01, base_p, w_word_p, g, bf16, plain=True), 2),
                bound_ms=b_bytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
                bytes=b_bytes,
                sort_bound_ms=sort_bytes / HBM_BYTES_PER_S * 1e3,
                sort_bytes=sort_bytes, max_abs_err=err, largest=scale,
                library_ms=lib["ms"], library_device_ms=lib["device_ms"],
                library=lib["library"]),
            b2=b2)
        out[name] = row
        print(f"[proposal] {name}: {L} levels x {C} ch, {P} windows a point "
              f"in {len(wins)} window levels, {B} points ({P * B} records): "
              f"the forward with records bit for bit its plain version, the "
              f"table gradient within rtol 1e-5 (max abs err {err:.3e} of "
              f"{scale:.3e}), two calls bitwise equal; {json.dumps(row)}")
    return out


def b2_step_check(tr, batch, what, n_calls):
    """B2's flat form over one train step's own calls (capture_b2 of a
    loss and backward on `batch`), timed by b2_step: the step's device
    time by stage (zero fill, main pass, group sums, fix-up, join), CUDA
    events, the bound, one zero_ + index_add_ a call, and with
    --b2-parent the parent tree's kernel in the same call (the same bits,
    in turns parent, this, this, parent)."""
    from raw_ngp_torch.train.trainer import make_batch_loss_fn
    loss_fn = make_batch_loss_fn(tr.cfg, tr.spec)

    def run():
        loss, _ = loss_fn(tr.field, tr.state, batch, tr.aabb, None)
        loss.backward()
        for p in tr.field.parameters():
            p.grad = None

    calls = capture_b2(run)
    check(len(calls) == n_calls, f"{what}: {len(calls)} B2 calls a step, "
                                 f"not {n_calls}")
    res = b2_step(calls, b2_parent())
    res["records"] = sum(c["keys"].numel() for c in calls)
    res["C"] = sorted({c["C"] for c in calls})
    print(f"[{what}] B2's flat form over a step's {len(calls)} calls "
          f"({res['records']} records): {json.dumps(res)}")
    return res


def b2_alone(spec, base, w_word, g, grad_plain):
    """B2's flat form alone over every window level of a grid (the 26
    calls of an -O2 step are 5 + 5 + 16 of these), on streams sorted
    before the timing: its output against the plain path's table gradient
    (rtol 1e-5, atol 1e-6 of the largest), its time (CUDA events and
    device time), its plain version's and its bound (each record's key,
    index and word read once, each point's level channels read once, the
    level's rows written once; one bf16 multiply and one add a channel
    and record)."""
    import torch
    from raw_ngp_torch.kernels import hash_encode as th
    from raw_ngp_torch.kernels import segsum as ts
    C = spec.level_dim
    B = g.shape[0]
    streams = []
    n_bytes = n_ops = 0
    for lv, w0, nw in th.level_windows(spec, th.matmul_split(spec)):
        off = spec.offsets[lv]
        rows = spec.offsets[lv + 1] - off
        keys_s, perm = torch.sort(base[w0:w0 + nw].reshape(-1) - off,
                                  stable=True)
        streams.append((lv, off, rows, keys_s, perm.to(torch.int32),
                        w_word[w0:w0 + nw].reshape(-1)))
        M = keys_s.numel()
        n_bytes += 12 * M + 4 * ((C + 1) // 2) * B + 4 * C * rows
        n_ops += 4 * C * M
    flat = torch.empty(spec.n_params * C, device=g.device)
    words = {lv: ts.g_words_plain(g, lv * C, C) for lv, *_ in streams}

    def kernel():
        for lv, off, rows, ks, pm, ww in streams:
            ts.segment_grad_outer(ks, pm, ww, g, rows, C, g_col=lv * C,
                                  out=flat[off * C:(off + rows) * C])

    def plain():
        for lv, off, rows, ks, pm, ww in streams:
            ts.segment_grad_outer_plain(ks, pm, ww, words[lv], rows, C,
                                        out=flat[off * C:(off + rows) * C])

    kernel()
    torch.cuda.synchronize()
    scale = float(grad_plain.abs().max())
    err = float((flat - grad_plain).abs().max())
    check(torch.allclose(flat, grad_plain, rtol=1e-5, atol=1e-6 * scale),
          f"B2 on {spec.num_levels} window levels: max abs err {err}")
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = n_ops / F32_FLOP_PER_S * 1e3
    out = dict(calls=len(streams), max_abs_err=err, ms=time_ms(kernel, 10),
               device_ms=device_ms(kernel, 5), plain_ms=time_ms(plain, 2),
               bound_ms=max(bytes_ms, ops_ms),
               bound_by="bytes" if bytes_ms >= ops_ms else "operations")
    kernel()
    return out


def serving_encode_checks(calls):
    """The forward without records on a serving chunk's three encodes:
    bf16 bit for bit its plain version, two calls the same bits; each
    timed beside its bound and its plain version."""
    import torch
    from raw_ngp_torch.kernels import hash_encode as th
    bf16 = torch.bfloat16
    out = []
    for table, x01, spec in calls:
        k = th.hash_encode(table, x01, spec, compute_dtype=bf16)
        k2 = th.hash_encode(table, x01, spec, compute_dtype=bf16)
        p = th.hash_encode_fused_plain(table, x01, spec, bf16)
        torch.cuda.synchronize()
        check(same_bits(k, p) and same_bits(k, k2), "proposal: a serving "
              "encode differs from its plain version or between two calls")

        def call(table=table, x01=x01, spec=spec):
            return th.hash_encode(table, x01, spec, compute_dtype=bf16)

        bound_ms, bound_by, n_bytes, rows = encode_bound(spec, x01, 2)
        out.append(dict(points=x01.shape[0], levels=spec.num_levels,
                        ms=time_ms(call, 10), device_ms=device_ms(call, 5),
                        plain_ms=time_ms(lambda: th.hash_encode_fused_plain(
                            table, x01, spec, bf16), 2),
                        bound_ms=bound_ms, bound_by=bound_by, bytes=n_bytes,
                        max_abs_err=0.0))
    print(f"[proposal] serving chunk encodes, bit for bit their plain "
          f"versions: {json.dumps(out)}")
    return out


def proposal_kernel_rows(grids, serving, sorts):
    """The `kernels` line's numbers at the proposal path's shapes, a step's
    (or a serving chunk's) calls summed: the forward with records (3 a
    step), B2's flat form (26 a step), the forward without records (3 a
    chunk) and the radix sort (`sorts`: sort_stream_checks' sums over a
    step's 26 streams)."""
    def total(rows, key):
        vals = [r[key] for r in rows]
        return None if any(v is None for v in vals) else sum(vals)

    def summed(rows, what):
        return dict(ms=total(rows, "ms"), device_ms=total(rows, "device_ms"),
                    plain_ms=total(rows, "plain_ms"),
                    bound_ms=total(rows, "bound_ms"),
                    bound_by=("bytes" if all(r["bound_by"] == "bytes"
                                             for r in rows)
                              else "operations"),
                    max_abs_err=max(r["max_abs_err"] for r in rows),
                    shapes=what)

    fwd = [g["forward"] for g in grids.values()]
    b2 = [g["b2"] for g in grids.values()]
    rows = {"hash_encode_records": summed(
                fwd, "the 3 forwards with records of an -O2 train step"),
            "segment_grad_outer": summed(
                b2, "the 26 calls of an -O2 train step (16 + 5 + 5 window "
                    "levels), streams sorted"),
            "hash_encode": summed(
                serving, "the 3 forwards of an -O2 serving chunk of 16,384 "
                         "rays")}
    rows["segment_grad_outer"].update(
        library_ms=total(b2, "library_ms"),
        library_device_ms=total(b2, "library_device_ms"),
        library="zero_ + index_add_ of the window levels' bf16-rounded "
                "products, one call a grid")
    for k in ("hash_encode_records", "hash_encode"):
        rows[k]["library_ms"] = None
    rows["sort_keys"] = dict(
        sorts, shapes="the 26 sorts of an -O2 train step (16 + 5 + 5 window "
                      "levels)",
        library="torch.sort(keys - offset, stable=True) and the indices' "
                ".to(torch.int32)")
    return rows


def proposal_sorts(tr, batch, specs, n_windows):
    """The radix sort on the 26 streams of an -O2 step (captured_sorts of
    a loss and backward on `batch`): sort_stream_checks' rows, summed
    over the step and by grid; the largest stream is a proposal grid's
    window level, its windows x the rays x 256 samples."""
    from raw_ngp_torch.kernels import hash_encode as th
    names = [(tr.spec.grid_spec, "radiance field")] + [
        (s, f"proposal {i}") for i, s in enumerate(tr.spec.prop_specs)]
    streams = captured_sorts(tr, batch, names)
    check(len(streams) == n_windows, f"proposal: the step sorted "
          f"{len(streams)} streams, not {n_windows}")
    steps = tr.cfg.render.num_steps
    largest = max(
        max(nw for _, _, nw in th.level_windows(s, th.matmul_split(s)))
        * tr.num_rays * (steps[i] if i < len(specs) - 1 else steps[-1])
        for i, s in enumerate(tr.spec.prop_specs + (tr.spec.grid_spec,)))
    sizes = [keys.numel() for _, keys, _, _ in streams]
    check(max(sizes) == largest, f"proposal: the largest sort has "
          f"{max(sizes)} keys, not {largest}")
    sorts = sort_stream_checks(streams, "proposal")
    del streams
    sorts["largest_keys"] = largest
    sorts["by_grid"] = {}
    for _, name in names:
        rows = [r for r in sorts["streams"] if r["stream"].startswith(name)]
        sorts["by_grid"][name] = {
            k: (None if any(r[k] is None for r in rows)
                else sum(r[k] for r in rows))
            for k in ("keys", "ms", "device_ms", "launches_per_call",
                      "library_ms", "library_device_ms", "bound_ms")}
        sorts["by_grid"][name]["streams"] = len(rows)
    print(f"[proposal] sorts by grid: {json.dumps(sorts['by_grid'])}")
    return sorts


def phase_proposal(dev, steps=128, timed=32, repro=32, large=512, reps=7):
    """The -O2 proposal path through the Trainer's entry points: the val
    PSNR (EMA) of the untrained field; the encode and the table gradient
    held against their plain versions on the three grids at a train step's
    points; `steps` steps with every launch counter reset just before and
    read just after (the forward with records 3 a step, B2's flat form 26
    a step, one per window level; no forward without records, no dense
    level, no fold or its backward, no input gradient, no 2C totals);
    finite falling losses, finite params and EMA; the val PSNR (EMA)
    above the untrained field's; evaluation's encodes 3 a chunk (read from
    the same counters after it, so the forward without records counts the
    serving that follows the steps); one
    fixed batch on the kernel and the plain path; the 512x512 render
    (timed, one chunk profiled and its encodes counted); the step's stages
    and profile; and the repro check over the first `repro` steps."""
    import numpy as np
    import torch
    from raw_ngp_torch.data import make_synthetic_scene
    from raw_ngp_torch.data.sampler import sample_ray_batch
    from raw_ngp_torch.kernels.hash_encode import hash_encode
    from raw_ngp_torch.ops.rays import full_image_rays
    from raw_ngp_torch.render.eval import make_eval_render, render_image
    from raw_ngp_torch.train.trainer import Trainer

    t_phase = time.perf_counter()
    cfg = proposal_config()
    train_s, val_s = make_synthetic_scene(n_train=36, n_val=2, H=128, W=128)
    t0 = time.perf_counter()
    tr = Trainer(cfg, train_s, val_s, device=dev,
                 workspace=scratch_workspace())
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    specs = (tr.spec.grid_spec,) + tr.spec.prop_specs
    print(f"[proposal] Trainer ready in {init_s:.2f} s; grids "
          f"{[(s.num_levels, s.level_dim, s.log2_hashmap_size, s.n_params) for s in specs]}")
    check(tr.state.density_grid is None, "proposal: a density grid exists")
    psnr_0, _ = evaluate_counted(tr)

    gen = torch.Generator(device=dev).manual_seed(9)
    sa = tr.scene_arrays
    batch = sample_ray_batch(gen, sa["images"], sa["poses"],
                             sa["intrinsics"], tr.num_rays)
    grids = proposal_grid_checks(tr, batch)
    from raw_ngp_torch.kernels import hash_encode as th
    n_windows = sum(len(th.level_windows(s, th.matmul_split(s)))
                    for s in specs)
    sorts = proposal_sorts(tr, batch, specs, n_windows)
    b2_step = b2_step_check(tr, batch, "proposal", n_windows)

    snap = trainer_snapshot(tr)
    launches, (first, last), step_ms, ref = run_steps(
        tr, steps, ("hash_encode_records", "segment_grad_outer"), "proposal",
        capture_at=repro, per_step={"hash_encode_records": len(specs),
                                    "segment_grad_outer": n_windows})
    for name in ("hash_encode", "mm_grad_table", "decimate_compact",
                 "decimate_compact_bwd", "encode_input_grad",
                 "segment_totals_channel"):
        check(launches[name] == 0, f"proposal: kernel {name} is off the "
              f"path but launched {launches[name]} times")
    window = step_ms[-timed:]
    med = sorted(window)[timed // 2]
    psnr, eval_launches = evaluate_counted(tr)
    by_caller = launches["hash_encode_by_caller"]
    by_caller["eval"] = eval_launches
    # the path serves what it trained: the forward without records counts
    # the evaluation that follows the steps (which launch none of it)
    launches["hash_encode"] = hash_encode.launches
    chunk = cfg.render.max_ray_batch
    eval_chunks = sum(-(-val_s.H * val_s.W // min(chunk, val_s.H * val_s.W))
                      for _ in range(val_s.n_images))
    check(eval_launches == len(specs) * eval_chunks, f"proposal: evaluate "
          f"launched {eval_launches} encodes for {eval_chunks} chunks")
    check(bool(np.isfinite(psnr)) and psnr > psnr_0,
          f"proposal: val PSNR {psnr} after training, {psnr_0} before")
    print(f"[proposal] last {timed} steps: median {med:.3f} ms/step, "
          f"{tr.num_rays / med * 1e3:.0f} rays/s; val PSNR (EMA) "
          f"{psnr:.3f} dB after {steps} steps, {psnr_0:.3f} dB untrained")

    fixed = fixed_batch_check(tr, lambda: batch, "proposal")

    # the 512x512 render, each of `reps` timed
    pose = val_s.poses[0]
    intr_l = val_s.intrinsics * (large / 128.0)

    def render_large():
        return render_image(tr.ema_field, None, pose, intr_l, large, large,
                            tr.aabb, device=dev)

    rgb_l, depth_l = render_large()
    check(bool(torch.isfinite(rgb_l).all() and torch.isfinite(depth_l).all())
          and rgb_l.shape == (large, large, 3),
          "proposal: the 512x512 render is not finite")
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        render_large()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    img_ms = sorted(times)[reps // 2]
    n_chunks = -(-large * large // chunk)
    # one chunk of the large image's middle rows: its encodes, its profile
    rays_o, rays_d = full_image_rays(
        torch.as_tensor(pose, device=dev),
        torch.as_tensor(intr_l, device=dev), large, large)
    s = (large * large - chunk) // 2
    ro, rd = rays_o[s:s + chunk], rays_d[s:s + chunk]
    render_chunk = make_eval_render(cfg)
    before = hash_encode.launches
    render_chunk(tr.ema_field, None, ro, rd, tr.aabb)
    chunk_encodes = hash_encode.launches - before
    serving = serving_encode_checks(captured_encodes(
        "_encode_forward",
        lambda: render_chunk(tr.ema_field, None, ro, rd, tr.aabb)))
    check(chunk_encodes == len(specs), f"proposal: a chunk launched "
          f"{chunk_encodes} encodes")
    chunk_profile = profile_device(
        lambda: render_chunk(tr.ema_field, None, ro, rd, tr.aabb), 3,
        "chunk")
    print(f"[proposal] 512x512: median {img_ms:.2f} ms an image, "
          f"{img_ms / n_chunks:.3f} ms a {chunk}-ray chunk, "
          f"{large * large / (img_ms / 1e3):.0f} rays/s; a chunk "
          f"{chunk_encodes} encodes; {json.dumps(chunk_profile)}")

    out = {"config": "Config().with_preset_O2() (contract, fp16, num_rays "
                     "4096, num_steps (256, 96, 48), 16 x 2 xor log2 19; "
                     "proposal grids 5 x 2 log2 17 at 128 and 256)",
           "scene": "make_synthetic_scene(36, 2, 128, 128)",
           "steps": steps, "num_rays": tr.num_rays,
           "points_per_step": tr.num_rays * sum(cfg.render.num_steps),
           "ms_per_step": med, "rays_per_s": tr.num_rays / med * 1e3,
           "ms_per_step_runs": window, "val_psnr_ema": psnr,
           "val_psnr_ema_untrained": psnr_0,
           "loss_first8": first, "loss_last8": last,
           "trainer_init_s": init_s, "grids": grids,
           "serving_encodes": serving,
           "kernel_rows": proposal_kernel_rows(grids, serving,
                                               sorts["summed"]),
           "sorts": sorts, "b2_step": b2_step,
           "fixed_batch_kernel_vs_plain": fixed,
           "render": {"image": f"{large}x{large}", "chunks": n_chunks,
                      "ms_per_image": img_ms, "ms_per_image_runs": times,
                      "ms_per_chunk": img_ms / n_chunks,
                      "rays_per_s": large * large / (img_ms / 1e3),
                      "encodes_per_chunk": chunk_encodes,
                      "profile": chunk_profile},
           "stages_ms": step_breakdown(tr),
           "profile": profile_device(tr.step, 1, "step"),
           "gpu": gpu_line()}
    out["repro"], out["dispatch"] = repro_check(tr, snap, ref, repro, "proposal")
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"[proposal] phase took {out['phase_s']:.1f} s")
    return launches, out


def o_config():
    """The reference -O configuration unchanged, the README's quick start:
    16 levels x 2 channels xor hash log2 19 (grid bound 2, finest
    resolution 4096), bf16, 4,096 rays with adaptive batching, S = 512
    march candidates packed into K = 64 slots with no coarse probes (the
    span march), compact_ratio 0.5 (m_pad 131,072), mark_untrained, grid
    128 x 2 cascades."""
    from raw_ngp_torch import Config
    return Config().with_preset_O().validate()


def with_render(field, **render):
    """A view of `field` (the same parameter tensors) whose configuration
    differs in render options only: the render reads them from
    field.spec.cfg."""
    import copy
    cfg = field.spec.cfg
    out = copy.copy(field)
    out.spec = replace(field.spec, cfg=replace(
        cfg, render=replace(cfg.render, **render)).validate())
    return out


# the branch chunks of phase_o: each a 16,384-ray chunk with normals (the
# expand path, so the fold's pos), kernels against the plain versions
O_BRANCHES = {
    "span_uniform_probes": dict(coarse_probes=16),
    "span_log_probes": dict(coarse_probes=16, probe_log=True),
    "cdf_dt_gamma_floor": dict(coarse_probes=16, march_cdf=True,
                               dt_gamma=1 / 128, cdf_floor=0.05),
    "contract": dict(contract=True, mark_untrained=False),
    "compact_ratio_0": dict(compact_ratio=0.0),
}


def render_agrees(out_k, out_p, names, what):
    """Max abs error of each output of a kernel-path render against the
    plain path; bf16 encode outputs may round one ulp apart (f32 sum
    order), which the bf16 MLPs carry to densities, colours and the
    normals' directions: image, weights_sum and normals within 2e-2,
    depth within 5e-2 (the slice phase's bounds)."""
    import torch
    torch.cuda.synchronize()
    err = {n: float((a.float() - b.float()).abs().max())
           for n, a, b in zip(names, out_k, out_p)}
    for n, a in zip(names, out_k):
        check(bool(torch.isfinite(a).all()), f"{what}: {n} not finite")
    check(all(v <= (5e-2 if n == "depth" else 2e-2)
              for n, v in err.items()),
          f"{what}: kernel path disagrees with the plain path {err}")
    return err


def psnr_of(tr, scene, views, field=None):
    """Mean PSNR of `field`'s renders (default the EMA field) of `views`
    of `scene` against their images, through render_image."""
    from raw_ngp_torch.render.eval import render_image
    from raw_ngp_torch.train.metrics import PSNRMeter
    meter = PSNRMeter()
    for i in views:
        rgb, _ = render_image(field or tr.ema_field, tr.state.density_bitfield,
                              scene.poses[i], scene.intrinsics, scene.H,
                              scene.W, tr.aabb, device=tr.device)
        meter.update(rgb.cpu().numpy(), scene.images[i][..., :3])
    return float(meter.measure())


def phase_o(dev, steps=128, timed=32, repro=32, large=512, reps=7):
    """The reference -O path through the Trainer's entry points: the val
    PSNR (EMA) of the untrained field; `steps` steps with every launch
    counter reset just before and read just after (the fold forward and
    the forward with records once a step, B2's flat form once a window
    level; the refresh encodes; no dense level, no fold backward, no
    input gradient, no 2C totals); finite falling losses, finite params
    and EMA; the PSNR (EMA) of two train views above the untrained
    field's on them, and the val PSNR (EMA) before and after, reported:
    on this scene the -O preset's val PSNR stays near the untrained
    field's (a black render of a black-background scene) for hundreds of
    steps, in the JAX package too (port_tools/o_learning_curve.py); one
    fixed batch on the kernel and the plain path; the 512x512 render of the EMA
    field with compute_normals (finite, the normal map in [0, 1], against
    the same render with plain=True; timed; one chunk's launches and
    profile); five branch chunks (O_BRANCHES) with normals, each against
    its plain run; the step's stages and profile; and the repro check
    over the first `repro` steps. Returns (the steps' launches, the
    normal render's launches a chunk, the JSON record)."""
    import numpy as np
    import torch
    from raw_ngp_torch.data import make_synthetic_scene
    from raw_ngp_torch.data.sampler import sample_ray_batch
    from raw_ngp_torch.kernels import hash_encode as th
    from raw_ngp_torch.models.ngp import make_field_spec
    from raw_ngp_torch.ops.rays import full_image_rays
    from raw_ngp_torch.render.eval import (coarse_volume, make_eval_render,
                                           render_image)
    from raw_ngp_torch.train.trainer import Trainer

    t_phase = time.perf_counter()
    cfg = o_config()
    train_s, val_s = make_synthetic_scene(n_train=36, n_val=2, H=128, W=128)
    t0 = time.perf_counter()
    tr = Trainer(cfg, train_s, val_s, device=dev,
                 workspace=scratch_workspace())
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    spec = tr.spec.grid_spec
    n_windows = len(th.level_windows(spec, th.matmul_split(spec)))
    r = cfg.render
    print(f"[O] Trainer ready in {init_s:.2f} s; grid {spec.num_levels} x "
          f"{spec.level_dim} {spec.hash_variant} log2 "
          f"{spec.log2_hashmap_size} ({spec.n_params} rows, res "
          f"{spec.resolutions[0]}..{spec.resolutions[-1]}), {n_windows} "
          f"window levels; S {r.march_candidates} -> K "
          f"{r.samples_per_ray}, probes {r.coarse_probes}, compact_ratio "
          f"{r.compact_ratio}, point budget {tr.base_point_budget()}, "
          f"{tr.num_rays} rays, adaptive {cfg.train.adaptive_num_rays}")
    check("coarse_lin" not in tr.scene_arrays,
          "O: a coarse volume without probes")
    psnr_0, _ = evaluate_counted(tr)
    train_views = (0, 1)
    psnr_train_0 = psnr_of(tr, train_s, train_views)

    snap = trainer_snapshot(tr)
    launches, (first, last), step_ms, ref = run_steps(
        tr, steps, ("decimate_compact", "hash_encode", "hash_encode_records",
                    "segment_grad_outer"), "O", capture_at=repro,
        per_step={"decimate_compact": 1, "hash_encode_records": 1,
                  "segment_grad_outer": n_windows})
    for name in ("mm_grad_table", "decimate_compact_bwd",
                 "encode_input_grad", "segment_totals_channel"):
        check(launches[name] == 0, f"O: kernel {name} is off the path but "
                                   f"launched {launches[name]} times")
    check(launches["hash_encode_by_caller"]["refresh_chunks"] > 0,
          "O: no grid refresh chunk was encoded")
    window = step_ms[-timed:]
    med = sorted(window)[timed // 2]
    psnr, launches["hash_encode_by_caller"]["eval"] = evaluate_counted(tr)
    psnr_train = psnr_of(tr, train_s, train_views)
    check(bool(np.isfinite(psnr)) and psnr_train > psnr_train_0,
          f"O: train views PSNR {psnr_train} after {steps} steps, "
          f"{psnr_train_0} untrained")
    print(f"[O] last {timed} steps: median {med:.3f} ms/step, "
          f"{tr.num_rays / med * 1e3:.0f} rays/s; PSNR (EMA) of train views "
          f"{train_views} {psnr_train:.3f} dB after {steps} steps, "
          f"{psnr_train_0:.3f} dB untrained; val PSNR (EMA) {psnr:.3f} dB, "
          f"{psnr_0:.3f} dB untrained")

    gen = torch.Generator(device=dev).manual_seed(11)
    sa = tr.scene_arrays
    batch = sample_ray_batch(gen, sa["images"], sa["poses"],
                             sa["intrinsics"], tr.num_rays)
    fixed = fixed_batch_check(tr, lambda: batch, "O")
    sorts = sort_stream_checks(captured_sorts(tr, batch, [(spec, "-O")]),
                               "O")
    check(len(sorts["streams"]) == n_windows, f"O: the step sorted "
          f"{len(sorts['streams'])} streams, not {n_windows}")
    b2_step = b2_step_check(tr, batch, "O", n_windows)

    # the serving render of the EMA field with normals, each of `reps` timed
    field_n = with_render(tr.ema_field, compute_normals=True)
    bitfield = tr.state.density_bitfield
    pose = val_s.poses[0]
    intr_l = val_s.intrinsics * (large / 128.0)

    def render_large(plain=False):
        return render_image(field_n, bitfield, pose, intr_l, large, large,
                            tr.aabb, device=dev, plain=plain,
                            return_normals=True)

    out_k = render_large()
    nm = out_k[2]
    check(nm is not None and tuple(nm.shape) == (large, large, 3)
          and bool((nm >= 0).all() and (nm <= 1).all()),
          "O: the normal map is missing or outside [0, 1]")
    image_err = render_agrees(out_k, render_large(plain=True),
                              ("image", "depth", "normals"),
                              "O 512x512 with normals")
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        render_large()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    img_ms = sorted(times)[reps // 2]
    chunk = r.max_ray_batch
    n_chunks = -(-large * large // chunk)
    # one chunk of the large image's middle rows: its launches, its profile
    rays_o, rays_d = full_image_rays(
        torch.as_tensor(pose, device=dev),
        torch.as_tensor(intr_l, device=dev), large, large)
    s0 = (large * large - chunk) // 2
    ro, rd = rays_o[s0:s0 + chunk], rays_d[s0:s0 + chunk]
    render_chunk = make_eval_render(field_n.spec.cfg)
    counters = _counters()
    torch.cuda.synchronize()
    for c in counters.values():
        c.launches = 0
    render_chunk(field_n, bitfield, ro, rd, tr.aabb)
    torch.cuda.synchronize()
    chunk_launches = {k: c.launches for k, c in counters.items()}
    for name in ("decimate_compact", "hash_encode", "encode_input_grad"):
        check(chunk_launches[name] > 0, f"O: a normal-render chunk did not "
                                        f"launch {name}")
    chunk_profile = profile_device(
        lambda: render_chunk(field_n, bitfield, ro, rd, tr.aabb), 3,
        "chunk")
    print(f"[O] 512x512 with normals: median {img_ms:.2f} ms an image, "
          f"{img_ms / n_chunks:.3f} ms a {chunk}-ray chunk, "
          f"{large * large / (img_ms / 1e3):.0f} rays/s; kernel vs plain "
          f"max abs err {image_err}; a chunk's launches {chunk_launches}; "
          f"{json.dumps(chunk_profile)}")

    # the other march branches and the expand / uncompacted paths, each a
    # chunk with normals on the kernel path against the plain path
    branches = {}
    for name, opts in O_BRANCHES.items():
        fb = with_render(tr.ema_field, compute_normals=True, **opts)
        bcfg = fb.spec.cfg
        # contraction keeps the grid at bound 2 (grid_bound 2 either way)
        check(make_field_spec(bcfg).grid_spec == spec,
              f"O branch {name}: the grid differs from the trained one")
        coarse = coarse_volume(bcfg, bitfield)
        for c in counters.values():
            c.launches = 0
        outs = [make_eval_render(bcfg, plain=plain)(
            fb, bitfield, ro, rd, tr.aabb, coarse) for plain in (False,
                                                                 True)]
        b_launch = {k: c.launches for k, c in counters.items() if c.launches}
        err = render_agrees(outs[0], outs[1], ("image", "depth",
                                               "weights_sum", "normals"),
                            f"O branch {name}")
        check(b_launch.get("encode_input_grad", 0) > 0
              and (bcfg.render.compact_ratio <= 0
                   or b_launch.get("decimate_compact", 0) > 0),
              f"O branch {name}: kernels not launched {b_launch}")
        hit = float((outs[0][2] > 0).float().mean())
        branches[name] = {"render": opts, "max_abs_err_vs_plain": err,
                          "launches": b_launch, "rays_hit": hit}
        print(f"[O] branch {name} {opts}: kernel vs plain {err}, launches "
              f"{b_launch}, weights_sum > 0 on {hit:.4f} of the rays")

    out = {"config": "Config().with_preset_O().validate() (16 x 2 xor log2 "
                     "19, fp16, num_rays 4096, adaptive, S 512 -> K 64, no "
                     "probes, compact_ratio 0.5, mark_untrained)",
           "scene": "make_synthetic_scene(36, 2, 128, 128)",
           "steps": steps, "grid_refreshes": tr.host_grid_updates,
           "num_rays": tr.num_rays,
           "point_budget": tr._point_budget or tr.base_point_budget(),
           "ms_per_step": med, "rays_per_s": tr.num_rays / med * 1e3,
           "ms_per_step_runs": window, "val_psnr_ema": psnr,
           "val_psnr_ema_untrained": psnr_0,
           "train_views_psnr_ema": psnr_train,
           "train_views_psnr_ema_untrained": psnr_train_0,
           "loss_first8": first, "loss_last8": last,
           "trainer_init_s": init_s,
           "fixed_batch_kernel_vs_plain": fixed, "sorts": sorts,
           "b2_step": b2_step,
           "render": {"image": f"{large}x{large}", "normals": True,
                      "chunks": n_chunks, "ms_per_image": img_ms,
                      "ms_per_image_runs": times,
                      "ms_per_chunk": img_ms / n_chunks,
                      "rays_per_s": large * large / (img_ms / 1e3),
                      "max_abs_err_vs_plain": image_err,
                      "launches_per_chunk": chunk_launches,
                      "profile": chunk_profile},
           "branches": branches,
           "stages_ms": step_breakdown(tr),
           "profile": profile_device(tr.step, 1, "step"),
           "gpu": gpu_line()}
    out["repro"], out["dispatch"] = repro_check(tr, snap, ref, repro, "O")
    out["forced_key"] = forced_key_check(tr, snap, repro)
    out["key_sweep"] = key_sweep_memory(tr, snap)
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"[O] phase took {out['phase_s']:.1f} s")
    return launches, chunk_launches, out


# the light-stage captures of the exr and dng phases: a ring of views, each
# under each LED, rendered at twice the training size
CAPTURE_VIEWS, CAPTURE_LEDS, CAPTURE_SIZE = 9, 4, 128
# the DNG captures' 14-bit levels and their exiftool-style sidecar; the
# captures are written at DNG_BRIGHTNESS of the scene's linear values, the
# headroom a raw camera keeps below its white level (the brightest pixels
# near 0.26 of it): at full brightness the preset without rfield freezes
# in its first steps, every hit ray past the RawNeRF clip where the loss
# has no gradient (port_tools/lightstage_freeze_probe.py)
DNG_BLACK, DNG_WHITE, DNG_BRIGHTNESS = 512, 16383, 0.3
DNG_EXIF = {"AsShotNeutral": "0.4521 1 0.6738",
            "ColorMatrix2": "0.6722 -0.0635 -0.0963 -0.4287 1.2460 0.2028 "
                            "-0.0908 0.2162 0.5668",
            "BlackLevel": DNG_BLACK, "WhiteLevel": DNG_WHITE}
CAPTURE_KERNELS = ("decimate_compact", "hash_encode", "hash_encode_records",
                   "segment_grad_outer")


def capture_scene(n_views=CAPTURE_VIEWS, n_leds=CAPTURE_LEDS,
                  size=CAPTURE_SIZE):
    """The light-stage capture set: make_rfield_grid_scene's ring of
    `n_views` cameras (radius 2.2, the textured spheres), each under
    `n_leds` spiral LEDs, rendered at twice `size`. Returns (images [V *
    L, 2 size, 2 size, 3] view by view, their poses, the intrinsics at
    `size`, the LEDs' light directions [L, 3])."""
    from raw_ngp_torch.data import make_rfield_grid_scene
    train, _ = make_rfield_grid_scene(n_views=n_views, n_lights=n_leds,
                                      n_heldout_lights=1, n_val_views=1,
                                      H=2 * size, W=2 * size)
    return (train.images, train.poses, train.intrinsics / 2.0,
            train.ldirs[:n_leds])


def rggb(img):
    """The RGGB Bayer mosaic [H, W] of an RGB image [H, W, 3]."""
    import numpy as np
    m = np.empty(img.shape[:2], np.float32)
    m[0::2, 0::2] = img[0::2, 0::2, 0]
    m[0::2, 1::2] = img[0::2, 1::2, 1]
    m[1::2, 0::2] = img[1::2, 0::2, 1]
    m[1::2, 1::2] = img[1::2, 1::2, 2]
    return m


def led_positions(ldirs):
    """LED positions whose load_light_dirs are `ldirs` (unit, pointing at
    the scene): -d for each LED, and one LED more at the directions' sum,
    which puts the rig's centre of mass at the origin (no capture uses
    it)."""
    import numpy as np
    d = np.asarray(ldirs, np.float64)
    return np.concatenate([-d, d.sum(0, keepdims=True)])


# the EXR captures' codecs, round robin over the captures, and the three
# captures written as a tiled PIZ file and a tiled DWAA file (MIPMAP
# levels, 48 x 40 tiles, which divide no capture size) and as a two-part
# file (part 1 a FLOAT preview at half the size, tiled, ZIP)
CAPTURE_EXR_CODECS = ("PIZ", "PXR24", "B44", "B44A", "ZIP", "DWAA", "DWAB")
CAPTURE_EXR_TILED, CAPTURE_EXR_TWO_PART, CAPTURE_EXR_TILED_DWA = 7, 11, 19
CAPTURE_EXR_TILES = (48, 40, 1, 0)
# the DNG captures' layouts by capture index mod 6: lossless JPEG tiles;
# 14-bit samples packed, uncompressed; 12-bit samples packed, uncompressed,
# through a square-law LinearizationTable of 4,096 entries; lossless JPEG
# tiles of 14-bit stored samples through a square-law table of 16,384;
# 16-bit samples, uncompressed; 16-bit samples, uncompressed, through a
# square-law table of 65,536 (a table on half the files, its inverse
# applied on write)
CAPTURE_DNG_LAYOUTS = (("lj92", 16, None), ("none", 14, None),
                       ("none", 12, 1 << 12), ("lj92", 16, 1 << 14),
                       ("none", 16, None), ("none", 16, 1 << 16))


def capture_exr_layout(i):
    """The EXR codec, tiles and second part of capture `i`."""
    codec = CAPTURE_EXR_CODECS[i % len(CAPTURE_EXR_CODECS)]
    if i == CAPTURE_EXR_TILED:
        return "PIZ", CAPTURE_EXR_TILES, False
    if i == CAPTURE_EXR_TILED_DWA:
        return "DWAA", CAPTURE_EXR_TILES, False
    return codec, None, i == CAPTURE_EXR_TWO_PART


def write_capture_folder(root, kind, images, poses, intrinsics, ldirs):
    """Writes a light-stage capture folder at `root`: the COLMAP model
    (write_colmap_scene: one image a capture, named img_VVV_lL, the world
    at half scale so that the preset's data.scale 2 gives back the scene's
    units; no LDR images), mask/img_VVV.png (the view's surface pixels at
    the training size), led_positions.txt (led_positions) and
    raw/img_VVV_lL.<kind>: "exr" the capture's RGGB mosaic as one HALF
    channel (write_exr: the codecs of CAPTURE_EXR_CODECS round robin, a
    tiled PIZ and a tiled DWAA file and one two-part file,
    capture_exr_layout); "dng" its
    14-bit counts (DNG_BLACK + mosaic (DNG_WHITE - DNG_BLACK), rounded)
    in a DNG (write_dng, the layouts of CAPTURE_DNG_LAYOUTS: lossless
    JPEG tiles, packed 14 and 12-bit and plain 16-bit strips, and a
    LinearizationTable on half the files, the stored samples linearize_inverse of the counts)
    with a .json sidecar (DNG_EXIF). Returns {capture path: the float32
    array its reader must give, or for a DWA capture its DwaRead}."""
    import json
    import numpy as np
    from raw_ngp_torch.data.image_io import write_png
    from raw_ngp_torch.data.reflectance import write_light_dirs_calibration
    n_leds = len(ldirs)
    size = images.shape[1] // 2
    names = [f"img_{i // n_leds:03d}_l{i % n_leds}"
             for i in range(len(images))]
    write_colmap_scene(str(root), None, poses, intrinsics, image_format=None,
                       names=names, units=0.5, size=(size, size))
    for sub in ("raw", "mask"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    write_light_dirs_calibration(os.path.join(root, "led_positions.txt"),
                                 led_positions(ldirs))
    matrix = np.array(DNG_EXIF["ColorMatrix2"].split(), float).reshape(3, 3)
    neutral = [float(v) for v in DNG_EXIF["AsShotNeutral"].split()]
    written = {}
    for i, name in enumerate(names):
        mosaic = rggb(images[i])
        if i % n_leds == 0:
            hit = (images[i].max(-1) > 0).reshape(size, 2, size, 2)
            write_png(os.path.join(root, "mask", name.split("_l")[0]
                                   + ".png"),
                      hit.any((1, 3)).astype(np.uint8) * 255)
        path = os.path.join(root, "raw", f"{name}.{kind}")
        if kind == "exr":
            codec, tiles, two_part = capture_exr_layout(i)
            second = (mosaic[::2, ::2], "ZIP", "FLOAT", (32, 32, 0, 0)) \
                if two_part else None
            _, written[path] = write_exr(path, mosaic, codec, "HALF",
                                         tiles=tiles, second=second,
                                         values=True)
            continue
        counts = np.clip(np.round(DNG_BLACK + mosaic * (DNG_WHITE
                                                        - DNG_BLACK)),
                         0, 65535).astype(np.uint16)
        compression, bits, n_table = \
            CAPTURE_DNG_LAYOUTS[i % len(CAPTURE_DNG_LAYOUTS)]
        table, stored = None, counts
        if n_table:
            table = linearization_table(n_table, DNG_WHITE)
            stored = linearize_inverse(table, counts)
        write_dng(path, stored, compression, DNG_BLACK, DNG_WHITE, matrix,
                  neutral, bits=bits, table=table)
        with open(os.path.join(root, "raw", f"{name}.json"), "w") as f:
            json.dump([dict(DNG_EXIF, SourceFile=f"{name}.dng")], f)
        written[path] = (stored if table is None else table[stored]).astype(
            np.float32)
    return written


def capture_config(root, kind):
    """The light-stage preset, Config().with_preset_lightstage() (the -O
    grid and span march, HDR, clamped_exp, COLMAP, masked, data.scale 2,
    clip), on the capture folder at `root`: "exr" with rfield (each
    capture's light direction from its _l<led> name and
    led_positions.txt); "dng" without rfield and with clip off, so black
    and white come from each capture's .json sidecar."""
    from raw_ngp_torch import Config
    cfg = Config().with_preset_lightstage()
    data, model = replace(cfg.data, path=str(root)), cfg.model
    if kind == "exr":
        model = replace(model, rfield=True)
    else:
        data = replace(data, clip=False)
    return replace(cfg, data=data, model=model).validate()


def raw_frame(seed, H=3024, W=4032):
    """A camera-sized 14-bit mosaic of counts [H, W] drawn from `seed`: a
    random field at 1/32 of the size enlarged by resize_area (smooth
    shading) plus N(0, 30) noise, between DNG_BLACK and DNG_WHITE."""
    import numpy as np
    from raw_ngp_torch.data.image_io import resize_area
    rng = np.random.default_rng(seed)
    field = rng.random((H // 32, W // 32)).astype(np.float32)
    img = resize_area(field, H, W) * (0.9 * (DNG_WHITE - DNG_BLACK)) \
        + DNG_BLACK + rng.normal(0, 30, (H, W))
    return np.clip(np.round(img), DNG_BLACK, DNG_WHITE).astype(np.uint16)


def capture_host_timings(kind, seed, crop=1024, size=(3024, 4032)):
    """The decode of one 4032 x 3024 capture (raw_frame(seed)) on the host
    clock, in seconds a megapixel: "exr" its levels as one HALF channel in
    each of ZIP, PIZ, PXR24, B44, B44A, DWAA and DWAB (read_exr, the
    serial loops of PIZ and DWA in C++; the samples bit for bit what
    write_exr stored, DWA's inside the writer's band, the share bit for
    bit its values), PIZ and DWAA by route on its `crop` x `crop` corner
    (C++ and Python, a second file; the routes alike); one RGB frame
    (host_image(seed) in linear light) as DWAA (the CSC set), whole by
    the C++ route and by route on its corner, and as Y, RY, BY (RY and BY
    at 2 x 2) in ZIP (bit for bit exr_chroma_rgb of the stored samples)
    and DWAA (each channel inside its band, the conversion bit for bit
    exr_chroma_rgb of the decoded channels); "dng" its counts in lossless
    JPEG tiles
    (read_dng_raw by route: C++ on the whole frame, and C++ and Python on
    its `crop` x `crop` corner, a second file; the samples bit for bit
    the counts, the routes alike), as packed 14-bit samples, and as packed
    12-bit samples through a LinearizationTable (the table's values at the
    stored samples)."""
    import numpy as np
    from raw_ngp_torch.data.dng import read_dng_raw
    from raw_ngp_torch.data.exr import read_exr, read_exr_channels
    from raw_ngp_torch.kernels import _build
    counts = raw_frame(seed, *size)
    mp = counts.size / 1e6
    root = _build.BUILD_DIR.parent / f"{kind}_frame"
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    out = {"frame": f"raw_frame(seed={seed}): {counts.shape[1]}x"
                    f"{counts.shape[0]} RGGB, 14-bit counts",
           "megapixels": mp, "gpu": gpu_line()}
    part = np.ascontiguousarray(counts[:crop, :crop])
    try:
        if kind == "exr":
            levels = ((counts.astype(np.float32) - DNG_BLACK)
                      / np.float32(DNG_WHITE - DNG_BLACK))
            path = str(root / "frame.exr")
            out["codecs"] = {}
            DWA_ROW_CASES.clear()
            for codec in ("ZIP",) + tuple(c for c in CAPTURE_EXR_CODECS
                                         if c != "ZIP"):
                t0 = time.perf_counter()
                data, want = write_exr(path, levels, codec, "HALF",
                                       values=True)
                write_s = time.perf_counter() - t0
                t0 = time.perf_counter()
                got = read_exr(path, "native" if codec in ("PIZ", "DWAA",
                                                           "DWAB") else None)
                out["codecs"][codec] = dict(
                    decode_s_per_megapixel=(time.perf_counter() - t0) / mp,
                    write_s=write_s, bytes=len(data))
                ok, share = decode_agrees(got, want)
                check(ok, f"exr: the frame's {codec} decode differs")
                if codec.startswith("DWA"):
                    out["codecs"][codec]["bit_equal_share"] = share
            small = str(root / "crop.exr")
            rgb = (host_image(seed, *size).astype(np.float32)
                   / np.float32(255)) ** np.float32(2.2)
            frames = {"piz": (levels[:crop, :crop], "PIZ"),
                      "dwaa": (levels[:crop, :crop], "DWAA"),
                      "rgb_dwaa": (rgb[:crop, :crop], "DWAA")}
            for name, (img, codec) in frames.items():
                _, want = write_exr(small, img, codec, "HALF", values=True)
                by_route = {}
                for route in ("native", "python"):
                    t0 = time.perf_counter()
                    by_route[route] = read_exr(small, route)
                    out[f"{name}_crop_{route}_s_per_megapixel"] = \
                        (time.perf_counter() - t0) / (crop * crop / 1e6)
                check(same_bits_np(by_route["native"], by_route["python"])
                      and decode_agrees(by_route["python"], want)[0],
                      f"exr: the C++ and Python routes decode the {name} "
                      f"crop differently")
            out.update(crop=f"{crop}x{crop}", piz_routes_bitwise=True,
                       dwa_routes_bitwise=True)
            frame = str(root / "rgb.exr")
            out["rgb"] = {"frame": f"host_image(seed={seed}) ** 2.2, "
                                   f"{size[1]}x{size[0]} RGB HALF"}
            for name, codec, yc in (("dwaa", "DWAA", False),
                                    ("yc_zip", "ZIP", True),
                                    ("yc_dwaa", "DWAA", True)):
                t0 = time.perf_counter()
                data, want = write_exr(frame, rgb, codec, "HALF",
                                       values=True, yc=yc)
                write_s = time.perf_counter() - t0
                t0 = time.perf_counter()
                got = read_exr(frame, "native")
                entry = dict(decode_s_per_megapixel=(time.perf_counter()
                                                     - t0) / mp,
                             write_s=write_s, bytes=len(data))
                if not yc:
                    ok, entry["bit_equal_share"] = decode_agrees(got, want)
                elif codec == "ZIP":
                    ok = same_bits_np(got, exr_chroma_rgb(
                        want["Y"], want["RY"], want["BY"]))
                else:
                    chans = read_exr_channels(frame, "native")
                    agree = {c: decode_agrees(chans[c], want[c])
                             for c in want}
                    ok = all(a for a, _ in agree.values()) and same_bits_np(
                        got, exr_chroma_rgb(chans["Y"], chans["RY"],
                                            chans["BY"]))
                    entry["bit_equal_share"] = {c: s for c, (_, s) in
                                                agree.items()}
                check(ok, f"exr: the RGB frame's {name} decode differs")
                out["rgb"][name] = entry
            out["dwa_row_cases"] = dict(DWA_ROW_CASES)
            check(len(DWA_ROW_CASES) == len(DWA_ROW_BOUNDS) - 1
                  and min(DWA_ROW_CASES.values()) > 0,
                  f"exr: the DWA frames miss a lastNonZero case "
                  f"{DWA_ROW_CASES}")
        else:
            path, small = str(root / "frame.dng"), str(root / "crop.dng")
            t0 = time.perf_counter()
            data = write_dng(path, counts, "lj92", DNG_BLACK, DNG_WHITE)
            out["write_s"] = time.perf_counter() - t0
            out["bytes"] = len(data)
            write_dng(small, part, "lj92", DNG_BLACK, DNG_WHITE)
            t0 = time.perf_counter()
            got = read_dng_raw(path, "native")
            native_s = time.perf_counter() - t0
            check(same_bits_np(got, counts), "dng: the frame's decode "
                                             "differs from its counts")
            by_route = {}
            for route in ("native", "python"):
                t0 = time.perf_counter()
                by_route[route] = read_dng_raw(small, route)
                out[f"crop_{route}_s_per_megapixel"] = \
                    (time.perf_counter() - t0) / (part.size / 1e6)
            check(same_bits_np(by_route["native"], by_route["python"])
                  and same_bits_np(by_route["python"], part),
                  "dng: the C++ and Python routes decode the crop "
                  "differently")
            out.update(native_s_per_megapixel=native_s / mp,
                       crop=f"{crop}x{crop}", routes_bitwise=True)
            table = linearization_table(1 << 12, DNG_WHITE)
            for name, bits, lut in (("packed14", 14, None),
                                    ("packed12_table", 12, table)):
                stored = counts if lut is None else \
                    linearize_inverse(lut, counts)
                data = write_dng(path, stored, "none", DNG_BLACK, DNG_WHITE,
                                 bits=bits, table=lut)
                t0 = time.perf_counter()
                got = read_dng_raw(path)
                out[f"{name}_s_per_megapixel"] = \
                    (time.perf_counter() - t0) / mp
                out[f"{name}_bytes"] = len(data)
                check(same_bits_np(got, stored if lut is None else
                                   lut[stored]),
                      f"dng: the frame's {name} decode differs")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"[{kind}] host {json.dumps(out)}")
    return out


def phase_capture(dev, kind, o_launches, captures, seed=0, steps=128,
                  timed=32, repro=32):
    """The light-stage preset trained from a capture folder on disk, read
    without imageio, cv2 or rawpy: the capture set (capture_scene) written
    as a folder of `kind` "exr" or "dng" captures (write_capture_folder;
    the DNG captures at DNG_BRIGHTNESS),
    loaded by load_scene (capture_config; "train" and "val", every 8th
    capture) with the load timed by stage, every decoded capture bit for
    bit the written array before the loader's levels, demosaic, resize
    and mask (EXR: the halves as float32; DNG: the counts), rfield's
    light directions those of the scene; the val PSNR (EMA, HDR)
    untrained; `steps` steps with every launch counter reset just before
    and read just after: the fold, the forward with records once a step
    and B2's flat form once a window level, as many as the O phase's
    steps launched (`o_launches`), the dense level, the fold's backward,
    the input gradient and the 2C totals never; finite falling losses;
    the val PSNR above the untrained field's; the repro check over the
    first `repro` steps; then capture_host_timings(kind, seed). The JPEG
    library must build here for the DNG captures and the EXR library for
    the EXR ones: no quiet fallback.
    Returns (launches, numbers)."""
    import numpy as np
    import torch
    from raw_ngp_torch import native
    from raw_ngp_torch.data import load_scene
    from raw_ngp_torch.kernels import _build
    from raw_ngp_torch.kernels import hash_encode as th
    from raw_ngp_torch.train.trainer import Trainer

    t_phase = time.perf_counter()
    if kind == "dng":
        check(native.jpeg_library() is not None,
              "dng: the JPEG library (lossless JPEG decode) did not build")
    else:
        check(native.exr_library() is not None,
              "exr: the EXR library (PIZ's Huffman decode) did not build")
    images, poses, intrinsics, ldirs = captures
    if kind == "dng":
        images = images * DNG_BRIGHTNESS
    size = images.shape[1] // 2
    root = _build.BUILD_DIR.parent / f"{kind}_scene"
    shutil.rmtree(root, ignore_errors=True)
    try:
        t0 = time.perf_counter()
        written = write_capture_folder(root, kind, images, poses,
                                       intrinsics, ldirs)
        write_s = time.perf_counter() - t0
        cfg = capture_config(root, kind)
        load, scenes, decoded = {}, {}, {}
        for split in ("train", "val"):
            np.random.seed(0)
            t0 = time.perf_counter()
            with timed_load_stages(HDR_LOAD_STAGES) as stages:
                scenes[split] = load_scene(cfg, split)
            total = time.perf_counter() - t0
            seconds = stages.totals()
            seconds["hdr_chain"] = seconds.pop("hdr_image") \
                - seconds["decode"]
            seconds[f"{kind}_decode"] = seconds.pop("decode")
            load[split] = dict(seconds, total=total,
                               other=total - sum(seconds.values()))
            for (stage, _, got), path in zip(stages.calls,
                                             stages.first_args):
                if stage == "decode":
                    decoded[str(path)] = got
        # each DWA capture by both routes of the AC stream's loops
        dwa_routes = {}
        for path, want in written.items():
            if isinstance(want, DwaRead):
                from raw_ngp_torch.data.exr import read_exr
                dwa_routes[path] = same_bits_np(read_exr(path, "native"),
                                                read_exr(path, "python"))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    check(sorted(decoded) == sorted(written),
          f"{kind}: the loads decoded {len(decoded)} of the {len(written)} "
          f"captures")
    agree = {p: decode_agrees(decoded[p], written[p]) for p in written}
    check(all(ok for ok, _ in agree.values()),
          f"{kind}: a decoded capture is not what was written (bit for bit; "
          f"DWA within the tolerance)")
    check(all(dwa_routes.values()),
          f"{kind}: the C++ and Python routes decode a DWA capture "
          f"differently")
    dwa_share = [agree[p][1] for p in dwa_routes]
    if dwa_routes:
        print(f"[{kind}] {len(dwa_routes)} DWA captures: routes bitwise, "
              f"every sample within the tolerance of the writer's float64 "
              f"decode; bit-equal share min {min(dwa_share):.6f} mean "
              f"{sum(dwa_share) / len(dwa_share):.6f}")
    train_d, val_d = scenes["train"], scenes["val"]
    ids = np.arange(len(images))
    want = {"train": np.setdiff1d(ids, ids[::8]), "val": ids[::8]}
    for split, scene in scenes.items():
        check(scene.images.shape == (len(want[split]), size, size, 3)
              and scene.images.dtype == np.float32
              and bool(np.isfinite(scene.images).all()),
              f"{kind}: the {split} images are {scene.images.shape}")
    ldir_err = None
    if kind == "exr":
        ref = ldirs[want["train"] % len(ldirs)]
        ldir_err = float(np.abs(train_d.ldirs - ref).max())
        check(ldir_err < 1e-6, f"{kind}: light directions off by "
                               f"{ldir_err}")
    pixels = sum(decoded[p].size for p in written)
    decode_s = load["train"][f"{kind}_decode"] \
        + load["val"][f"{kind}_decode"]
    print(f"[{kind}] wrote {len(written)} captures of {2 * size}x"
          f"{2 * size} in {write_s:.2f} s; loaded (s) {json.dumps(load)}; "
          f"{kind.upper()} decode {decode_s / pixels * 1e6:.4f} s a "
          f"megapixel; decodes agree with the written arrays; light "
          f"directions max err {ldir_err}")

    t0 = time.perf_counter()
    tr = Trainer(cfg, train_d, val_d, device=dev,
                 workspace=scratch_workspace())
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    spec = tr.spec.grid_spec
    n_windows = len(th.level_windows(spec, th.matmul_split(spec)))
    psnr_0, _ = evaluate_counted(tr)
    print(f"[{kind}] Trainer ready in {init_s:.2f} s; grid "
          f"{spec.num_levels} x {spec.level_dim} {spec.hash_variant}, "
          f"{n_windows} window levels; HDR val PSNR (EMA) untrained "
          f"{psnr_0:.3f} dB over {val_d.n_images} captures")
    snap = trainer_snapshot(tr)
    launches, (first, last), step_ms, ref = run_steps(
        tr, steps, CAPTURE_KERNELS, kind, capture_at=repro,
        per_step={"decimate_compact": 1, "hash_encode_records": 1,
                  "segment_grad_outer": n_windows})
    same = {k: (launches[k], o_launches[k])
            for k in ("decimate_compact", "hash_encode_records",
                      "segment_grad_outer", "mm_grad_table")}
    check(all(a == b for a, b in same.values()),
          f"{kind}: launches differ from the O phase's {same}")
    for name in ("mm_grad_table", "decimate_compact_bwd",
                 "encode_input_grad", "segment_totals_channel"):
        check(launches[name] == 0, f"{kind}: kernel {name} is off the path "
                                   f"but launched {launches[name]} times")
    window = step_ms[-timed:]
    med = sorted(window)[timed // 2]
    psnr, launches["hash_encode_by_caller"]["eval"] = evaluate_counted(tr)
    print(f"[{kind}] last {timed} steps: median {med:.3f} ms/step; HDR val "
          f"PSNR (EMA) {psnr_0:.3f} -> {psnr:.3f} dB")
    check(bool(np.isfinite(psnr)) and psnr > psnr_0,
          f"{kind}: val PSNR {psnr} did not rise above the untrained "
          f"field's {psnr_0}")
    out = {"config": "Config().with_preset_lightstage() (the -O grid 16 x "
                     "2 xor log2 19, span march, HDR, clamped_exp, colmap, "
                     "masked, scale 2) "
                     + ("+ rfield, clip" if kind == "exr" else
                        "with clip off (levels from the sidecars)"),
           "captures": f"make_rfield_grid_scene: {CAPTURE_VIEWS} views x "
                       f"{CAPTURE_LEDS} LEDs at {2 * size}x{2 * size}, "
                       + ("RGGB mosaics as one HALF channel, "
                          + ", ".join(CAPTURE_EXR_CODECS) + " round robin, "
                          "a tiled PIZ and a tiled DWAA (MIPMAP) and one "
                          "two-part file"
                          if kind == "exr" else f"14-bit RGGB counts at "
                          f"{DNG_BRIGHTNESS} of the scene's brightness in "
                          f"DNGs (LJ92 tiles, packed 14 and 12-bit and "
                          f"16-bit strips, a LinearizationTable on half) "
                          f"with .json "
                          f"sidecars")
                       + f", trained at {size}x{size}",
           "gpu": gpu_line(), "write_s": write_s, "load_s": load,
           f"{kind}_decode_s_per_megapixel": decode_s / pixels * 1e6,
           "decodes_bitwise_written": all(
               same_bits_np(decoded[p], written[p]) for p in written
               if p not in dwa_routes),
           "dwa_captures": len(dwa_routes),
           "dwa_routes_bitwise": all(dwa_routes.values()),
           "dwa_bit_equal_share": dwa_share, "ldir_max_err": ldir_err,
           "train_captures": train_d.n_images,
           "val_captures": val_d.n_images, "trainer_init_s": init_s,
           "steps": steps, "grid_refreshes": tr.host_grid_updates,
           "num_rays": tr.num_rays, "ms_per_step": med,
           "ms_per_step_runs": window, "val_psnr_ema_untrained": psnr_0,
           "val_psnr_ema": psnr, "loss_first8": first, "loss_last8": last,
           "launches_as_O_phase": same}
    out["repro"], out["dispatch"] = repro_check(tr, snap, ref, repro, kind)
    del tr
    out["host"] = capture_host_timings(kind, seed)
    out["seconds"] = time.perf_counter() - t_phase
    print(f"[{kind}] phase took {out['seconds']:.1f} s")
    return launches, out


def reg_config(fused=True):
    """The reference -O configuration with the four regularizers on:
    lambda_orientation 0.1 (Ref-NeRF's orientation_loss_mult), lambda_wd
    0.1 (Zip-NeRF's hash-decay multiplier, which weight_decay_loss
    follows), lambda_entropy 1e-4 and lambda_tv 1e-6 (large enough to see
    their terms); with `fused` False on the unfused encoder."""
    cfg = o_config()
    cfg = replace(cfg, train=replace(
        cfg.train, lambda_orientation=0.1, lambda_wd=0.1,
        lambda_entropy=1e-4, lambda_tv=1e-6))
    if not fused:
        cfg = replace(cfg, model=replace(cfg.model, fused_encoder=False))
    return cfg.validate()


class cached_mark_untrained:
    """While active, the Trainer's mark_untrained_grid (host numpy, about
    37 s at the 128^3 grids) is computed once for each grid and scene and
    then served from a cache: the train, pose, lightstage, O, reg and
    unfused phases build their Trainers on one camera rig and grid, and
    the cli phase its two in-process Trainers on another. The grid depends
    only on the keyed inputs."""

    def __enter__(self):
        import hashlib

        import numpy as np
        from raw_ngp_torch.train import trainer
        self.module, self.orig, cache = trainer, trainer.mark_untrained_grid, {}

        def cached(cfg, poses, intrinsics, aabb, cam_near_far=None):
            key = [cfg.render.grid_size, cfg.grid_bound, cfg.cascades,
                   cfg.render.min_near]
            for a in (poses, intrinsics, aabb, cam_near_far):
                key.append(None if a is None else hashlib.sha1(
                    np.ascontiguousarray(a).tobytes()).hexdigest())
            key = tuple(key)
            if key not in cache:
                cache[key] = self.orig(cfg, poses, intrinsics, aabb,
                                       cam_near_far)
            return cache[key].copy()

        trainer.mark_untrained_grid = cached
        return self

    def __exit__(self, *exc):
        self.module.mark_untrained_grid = self.orig


def phase_encode_jvp(dev, cfg, B=262144, flagship=None):
    """The input gradient's JVP in g (encode_input_jvp, the orientation
    loss's second-order term) at the orientation's shape (B = N K points)
    on the -O grid (`cfg`'s), its C = 1 shard under tp = 2 (the tp
    orientation's width, parallel.tp.local_grid_spec) and the flagship's
    (`flagship`'s, C = 16 with one dense matmul level): kernel against
    plain version at uniform and ray-ordered points, f32 and bf16, bit
    for bit and two calls bitwise equal, each timed beside its bound (and
    the ratio); the plain version timed. The kernels line's numbers are
    the -O grid's at ray-ordered points in bf16; the shard's ride under
    `O_shard_C1`, the flagship's under `flagship_grid`."""
    import torch
    from raw_ngp_torch.kernels import hash_encode as th
    from raw_ngp_torch.models.ngp import make_field_spec
    from raw_ngp_torch.parallel.tp import local_grid_spec
    o_spec = make_field_spec(cfg).grid_spec
    grids = {"O": (cfg, o_spec),
             "O_shard_C1": (cfg, local_grid_spec(o_spec, 2))}
    if flagship is not None:
        grids["flagship"] = (flagship, make_field_spec(flagship).grid_spec)
    per_grid = {}
    for grid, (grid_cfg, spec) in grids.items():
        C = spec.level_dim
        gen = torch.Generator(device=dev).manual_seed(13)
        table = (torch.rand(spec.n_params * C, generator=gen, device=dev)
                 * 2 - 1) * 1e-2
        inputs = encode_inputs(grid_cfg, gen, dev, B, kinds=("uniform",
                                                             "ray"))
        ct = torch.randn(B, 3, generator=gen, device=dev)
        per_input = {}
        for kind, x01 in inputs.items():
            per_input[kind] = {}
            outside = ~((x01 >= 0) & (x01 <= 1)).all(-1)
            for dtype in (torch.float32, torch.bfloat16):
                name = str(dtype)[6:]
                k = th.encode_input_jvp(table, x01, ct, spec, dtype)
                k2 = th.encode_input_jvp(table, x01, ct, spec, dtype)
                p = th.encode_input_jvp_plain(table, x01, ct, spec, dtype)
                torch.cuda.synchronize()
                err = float((k.float() - p.float()).abs().max())
                scale = float(p.float().abs().max())
                check(scale > 0 and bool((k[outside] == 0).all())
                      and same_bits(k, p) and same_bits(k, k2),
                      f"encode_jvp {grid} {kind} {name}: max abs err {err} "
                      f"(scale {scale}), not bit for bit, or two calls "
                      f"differ")

                def call(x01=x01, dtype=dtype, table=table, ct=ct,
                         spec=spec):
                    return th.encode_input_jvp(table, x01, ct, spec, dtype)

                ms, dev_ms = time_ms(call, 50), device_ms(call)
                # ct_x in, ct_g [B, L*C] out; per corner and channel a
                # weight tangent product and the accumulate
                bound_ms, bound_by, n_bytes, rows = encode_bound(
                    spec, x01, 2 if dtype == torch.bfloat16 else 4,
                    extra_bytes=B * 12, ops_per_term=4)
                per_input[kind][name] = dict(
                    max_abs_err=err, scale=scale, ms=ms, device_ms=dev_ms,
                    bound_ms=bound_ms, bound_by=bound_by, bytes=n_bytes,
                    touched_rows=rows, ms_over_bound=ms / bound_ms)
                print(f"[encode_jvp] {grid} {kind} B={B} {name}: bit for "
                      f"bit the plain version (largest {scale:.3e}), two "
                      f"calls bitwise equal; kernel {ms:.4f} ms (device "
                      f"{dev_ms} ms), bound {bound_ms * 1e3:.2f} us "
                      f"({bound_by}: touched rows {rows}, {n_bytes} "
                      f"bytes), {ms / bound_ms:.2f}x the bound")
        bf16 = torch.bfloat16
        x01 = inputs["ray"]
        plain_ms = time_ms(
            lambda: th.encode_input_jvp_plain(table, x01, ct, spec, bf16), 3)
        print(f"[encode_jvp] {grid} ray B={B} bf16 plain {plain_ms:.4f} ms")
        per_grid[grid] = dict(inputs=per_input, plain_ms=plain_ms,
                              levels=spec.num_levels, channels=C)
    top = per_grid["O"]["inputs"]["ray"]["bfloat16"]
    row = dict(name="encode_input_jvp", route="cuda",
               source="raw_ngp_torch/csrc/hash_encode.cu",
               replaces="raw_ngp_tpu/kernels/hash_fused.py:772 (the input "
                        "gradient differentiated again under jax.grad, "
                        "render/occupancy.py:999)",
               max_abs_err=top["max_abs_err"],
               max_abs_err_f32=per_grid["O"]["inputs"]["ray"]["float32"][
                   "max_abs_err"],
               ms=top["ms"], device_ms=top["device_ms"],
               plain_ms=per_grid["O"]["plain_ms"],
               bound_ms=top["bound_ms"], bound_by=top["bound_by"],
               ms_over_bound=top["ms_over_bound"], library_ms=None,
               inputs=per_grid["O"]["inputs"], deterministic=True)
    row["O_shard_C1"] = per_grid["O_shard_C1"]
    if "flagship" in per_grid:
        row["flagship_grid"] = per_grid["flagship"]
    return row


class recorded_terms:
    """While active, the regularised loss's terms (the orientation loss
    from the render, the entropy, TV and weight-decay values) are kept,
    one device scalar a step each, by wrapping the names the train step
    calls."""

    NAMES = ("entropy_loss", "total_variation_loss", "weight_decay_loss")

    def __enter__(self):
        from raw_ngp_torch.train import trainer
        self.module = trainer
        self.orig = {n: getattr(trainer, n) for n in self.NAMES + (
            "render_any",)}
        self.values = {"orientation": [], "entropy": [], "tv": [], "wd": []}

        def keep(key, fn):
            def wrapped(*args, **kwargs):
                out = fn(*args, **kwargs)
                self.values[key].append(out.detach())
                return out
            return wrapped

        def render_any(*args, **kwargs):
            out = self.orig["render_any"](*args, **kwargs)
            if "orientation_loss" in out:
                self.values["orientation"].append(
                    out["orientation_loss"].detach())
            return out

        for key, name in zip(("entropy", "tv", "wd"), self.NAMES):
            setattr(trainer, name, keep(key, self.orig[name]))
        trainer.render_any = render_any
        return self

    def __exit__(self, *exc):
        for name, fn in self.orig.items():
            setattr(self.module, name, fn)

    def first_last(self):
        return {k: (float(v[0]), float(v[-1])) for k, v in self.values.items()
                if v}


def reg_batch(tr, seed):
    """A fixed batch of the Trainer's scene and a maker of generators that
    draw the same march jitter and TV points on both sides."""
    import torch
    from raw_ngp_torch.data.sampler import sample_ray_batch
    gen = torch.Generator(device=tr.device).manual_seed(seed)
    sa = tr.scene_arrays
    batch = sample_ray_batch(gen, sa["images"], sa["poses"],
                             sa["intrinsics"], tr.num_rays)
    return batch, (lambda: torch.Generator(device=tr.device).manual_seed(
        seed + 1))


def orientation_only(field, state, batch, aabb, generator, plain=False,
                     annealing=1.0):
    """The orientation term of a training render alone, as a loss."""
    from raw_ngp_torch.render.dispatch import render_any
    out = render_any(field, batch["rays_o"], batch["rays_d"], aabb,
                     state.density_bitfield, bg_color=0.0, training=True,
                     generator=generator, plain=plain, annealing=annealing)
    return out["orientation_loss"], {"num_points": out["num_points"]}


# the kernels of a regularised -O step (no dense level on the -O grid)
REG_KERNELS = ("decimate_compact", "hash_encode", "hash_encode_records",
               "segment_grad_outer", "encode_input_grad", "encode_input_jvp")


def reg_per_step(tr):
    """Launches a step of the regularised -O step's kernels: the fold once,
    the forward with records twice (the compacted field, the N K
    orientation points), the input gradient and its JVP once, B2 twice a
    window level (of the tp shard's spec under tp)."""
    from raw_ngp_torch.kernels import hash_encode as th
    from raw_ngp_torch.parallel.tp import local_grid_spec
    spec = tr.spec.grid_spec
    if tr.n_tp > 1:
        spec = local_grid_spec(spec, tr.n_tp)
    n_windows = len(th.level_windows(spec, th.matmul_split(spec)))
    return {"decimate_compact": 1, "hash_encode_records": 2,
            "encode_input_grad": 1, "encode_input_jvp": 1,
            "segment_grad_outer": 2 * n_windows}


def phase_reg(dev, steps=128, timed=32, repro=32):
    """The reference -O path with the four regularizers (reg_config) through
    the Trainer's entry points, on the O phase's scene and seed: `steps`
    steps with every launch counter reset just before and read just
    after (the fold with slot positions once a step, the forward with
    records twice: the compacted field and the N K orientation points,
    the input gradient and its JVP once, B2's flat form twice a window
    level; no dense level, fold backward or 2C totals); each term's value
    at the first and the last step; finite falling losses; the PSNR of
    two train views (reported); a fixed batch on the kernel and the plain
    path, the whole loss and the orientation term alone (every gradient);
    the step's stages and profile; and the repro check over the first
    `repro` steps. Returns (the steps' launches, the JSON record, the
    Trainer's ms a step)."""
    import torch
    from raw_ngp_torch.data import make_synthetic_scene
    from raw_ngp_torch.train.trainer import Trainer

    t_phase = time.perf_counter()
    cfg = reg_config()
    train_s, val_s = make_synthetic_scene(n_train=36, n_val=2, H=128, W=128)
    t0 = time.perf_counter()
    tr = Trainer(cfg, train_s, val_s, device=dev,
                 workspace=scratch_workspace())
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    print(f"[reg] Trainer ready in {init_s:.2f} s; lambdas orientation "
          f"{cfg.train.lambda_orientation}, wd {cfg.train.lambda_wd}, "
          f"entropy {cfg.train.lambda_entropy}, tv {cfg.train.lambda_tv}; "
          f"{tr.num_rays} rays x K {cfg.render.samples_per_ray} = "
          f"{tr.num_rays * cfg.render.samples_per_ray} orientation points")
    train_views = (0, 1)
    psnr_train_0 = psnr_of(tr, train_s, train_views)
    snap = trainer_snapshot(tr)
    with recorded_terms() as terms:
        launches, (first, last), step_ms, ref = run_steps(
            tr, steps, REG_KERNELS, "reg", capture_at=repro,
            per_step=reg_per_step(tr))
    for name in ("mm_grad_table", "decimate_compact_bwd",
                 "segment_totals_channel"):
        check(launches[name] == 0, f"reg: kernel {name} is off the path but "
                                   f"launched {launches[name]} times")
    values = terms.first_last()
    check(set(values) == {"orientation", "entropy", "tv", "wd"}
          and all(all(map(math.isfinite, v)) for v in values.values()),
          f"reg: a term is missing or not finite {values}")
    print(f"[reg] terms (first step, last step): {values}")
    window = step_ms[-timed:]
    med = sorted(window)[timed // 2]
    psnr_train = psnr_of(tr, train_s, train_views)
    print(f"[reg] last {timed} steps: median {med:.3f} ms/step, "
          f"{tr.num_rays / med * 1e3:.0f} rays/s; PSNR (EMA) of train views "
          f"{train_views} {psnr_train:.3f} dB after {steps} steps, "
          f"{psnr_train_0:.3f} dB untrained")
    batch, gen_fn = reg_batch(tr, 17)
    fixed = fixed_batch_check(tr, lambda: batch, "reg", generator_fn=gen_fn)
    fixed_orient = fixed_batch_check(tr, lambda: batch, "reg orientation",
                                     generator_fn=gen_fn,
                                     loss_fn=orientation_only)
    out = {"config": "reg_config(): Config().with_preset_O() with "
                     "lambda_orientation 0.1, lambda_wd 0.1, lambda_entropy "
                     "1e-4, lambda_tv 1e-6",
           "scene": "make_synthetic_scene(36, 2, 128, 128)",
           "steps": steps, "grid_refreshes": tr.host_grid_updates,
           "num_rays": tr.num_rays,
           "point_budget": tr._point_budget or tr.base_point_budget(),
           "orientation_points": tr.num_rays * cfg.render.samples_per_ray,
           "ms_per_step": med, "rays_per_s": tr.num_rays / med * 1e3,
           "ms_per_step_runs": window, "terms_first_last": values,
           "train_views_psnr_ema": psnr_train,
           "train_views_psnr_ema_untrained": psnr_train_0,
           "loss_first8": first, "loss_last8": last,
           "trainer_init_s": init_s,
           "fixed_batch_kernel_vs_plain": fixed,
           "fixed_batch_orientation_kernel_vs_plain": fixed_orient,
           "stages_ms": step_breakdown(tr),
           "profile": profile_device(tr.step, 1, "step"),
           "gpu": gpu_line()}
    out["repro"], out["dispatch"] = repro_check(tr, snap, ref, repro, "reg")
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"[reg] phase took {out['phase_s']:.1f} s")
    return launches, out, med


def phase_unfused(dev, fused_ms, steps=32, repro=32):
    """reg_config on the unfused encoder (the plain encode of every grid,
    its gradients autograd's, the orientation's full second order): a
    Trainer on the reg phase's scene, `steps` steps with every launch
    counter reset just before and read just after (the fold once a step;
    no encode kernel, no B2); finite falling losses; a fixed batch on the
    kernel and the plain path (the fold is the only kernel that
    differs); its ms a step beside the fused run's (`fused_ms`); the
    repro check over its `repro` steps."""
    import torch
    from raw_ngp_torch.data import make_synthetic_scene
    from raw_ngp_torch.train.trainer import Trainer

    t_phase = time.perf_counter()
    cfg = reg_config(fused=False)
    train_s, val_s = make_synthetic_scene(n_train=36, n_val=2, H=128, W=128)
    t0 = time.perf_counter()
    tr = Trainer(cfg, train_s, val_s, device=dev,
                 workspace=scratch_workspace())
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    snap = trainer_snapshot(tr)
    launches, (first, last), step_ms, ref = run_steps(
        tr, steps, ("decimate_compact",), "unfused", capture_at=repro,
        per_step={"decimate_compact": 1})
    for name, n in launches.items():
        if name not in ("decimate_compact", "hash_encode_by_caller"):
            check(n == 0, f"unfused: kernel {name} launched {n} times")
    med = sorted(step_ms[-(steps // 2):])[steps // 4]
    print(f"[unfused] Trainer ready in {init_s:.2f} s; median of the last "
          f"{steps // 2} steps {med:.3f} ms/step against {fused_ms:.3f} "
          f"fused")
    batch, gen_fn = reg_batch(tr, 19)
    fixed = fixed_batch_check(tr, lambda: batch, "unfused",
                              generator_fn=gen_fn)
    out = {"config": "reg_config(fused=False)",
           "steps": steps, "ms_per_step": med,
           "ms_per_step_fused": fused_ms,
           "ms_per_step_runs": step_ms[-(steps // 2):],
           "loss_first8": first, "loss_last8": last,
           "trainer_init_s": init_s,
           "fixed_batch_kernel_vs_plain": fixed,
           "profile": profile_device(tr.step, 1, "step"),
           "gpu": gpu_line()}
    out["repro"], out["dispatch"] = repro_check(tr, snap, ref, repro, "unfused")
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"[unfused] phase took {out['phase_s']:.1f} s")
    return launches, out


def pose_recovery_config():
    """tests/test_pose_opt.py's pose_cfg: the proposal path on the unfused
    encoder (8 levels x 2 log2 14, finest 256; proposal grids 3 x 2 log2
    10 at 32 and 64; num_steps (32, 16, 12)), f32, 1,024 rays, lr 1e-2,
    400 iterations, BARF on 36 cameras with noise 0.05, c_lr 3e-3,
    end_annealing 0.8."""
    from raw_ngp_torch import Config
    cfg = Config()
    cfg = replace(cfg, model=replace(
        cfg.model, num_levels=8, log2_hashmap_size=14,
        hashgrid_resolution=128, grid_mlp_hidden=32, view_mlp_hidden=32,
        prop_num_levels=3, prop_log2_hashmap_size=10,
        prop_resolutions=(32, 64), fused_encoder=False))
    cfg = replace(cfg, render=replace(
        cfg.render, num_steps=(32, 16, 12), occupancy=False, bound=2.0))
    cfg = replace(cfg, train=replace(
        cfg.train, iters=400, num_rays=1024, lr=1e-2, fp16=False))
    cfg = cfg.with_pose_opt("barf", 36)
    cfg = replace(cfg, pose_opt=replace(
        cfg.pose_opt, noise=0.05, c_lr=3e-3, end_annealing=0.8))
    return cfg.validate()


def _pose_recovery_seed(rank, seeds, steps, tmp, dev_name):
    """One seed of the pose_recovery phase in a process of its own on
    `dev_name` (every seed's process shares the card): the run's errors
    before and after, its ratios, its largest refinement and losses,
    pickled to `tmp`/seed<seed>.pkl."""
    import pickle

    import torch
    from raw_ngp_torch.data import make_synthetic_scene
    from raw_ngp_torch.train.pose_analysis import analyze_pose_optimization
    from raw_ngp_torch.train.trainer import Trainer
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    seed = seeds[rank]
    train_s, val_s = make_synthetic_scene(n_train=36, n_val=2, H=48, W=48)
    cfg = pose_recovery_config()
    cfg = replace(cfg, train=replace(cfg.train, seed=seed)).validate()
    tr = Trainer(cfg, train_s, val_s, device=torch.device(dev_name),
                 workspace=os.path.join(tmp, f"workspace_{seed}"))
    err0 = analyze_pose_optimization(tr)
    run = tr.train(iters=steps, log_every=100)
    torch.cuda.synchronize()
    err1 = analyze_pose_optimization(tr)
    out = {"seed": seed, "errors_before": err0, "errors_after": err1,
           "rotation_ratio": err1["rotation_deg"] / err0["rotation_deg"],
           "translation_ratio": err1["translation"] / err0["translation"],
           "largest_refinement": float(
               tr.state.pose_params.detach().abs().max()),
           "losses": tr.stats["loss"],
           "ms_per_step": run["wall_time"] / steps * 1e3,
           "wall_s": run["wall_time"]}
    with open(os.path.join(tmp, f"seed{seed}.pkl"), "wb") as f:
        pickle.dump(out, f)


def pose_recovery_start(dev, steps=400, seeds=(0, 1, 2, 3)):
    """JAX's pose-recovery test (tests/test_pose_opt.py:85-106, marked slow
    there) on the card: pose_recovery_config on make_synthetic_scene(36,
    2, 48, 48) for `steps` steps at each of `seeds` (train.seed: the
    field, the pose noise and the batches), each seed in a process of its
    own, all sharing the card at once. The processes are spawned and not
    waited for: the host-bound runs overlap a phase that is host-bound too
    (main runs the cli phase meanwhile); each run gives the bits it gives
    alone (no float atomics, nothing shared). -> what
    pose_recovery_finish takes."""
    import torch.multiprocessing as mp
    tmp = tempfile.mkdtemp(prefix="chip_smoke_pose_recovery_")
    atexit.register(shutil.rmtree, tmp, True)
    context = mp.spawn(_pose_recovery_seed,
                       args=(tuple(seeds), steps, tmp, str(dev)),
                       nprocs=len(seeds), join=False)
    return context, tmp, steps, tuple(seeds), time.perf_counter()


def pose_recovery_finish(started):
    """Wait for pose_recovery_start's processes and check their runs: each
    run's refinements must move (largest above 1e-4), and the rotation
    error must fall below 0.92 of its start in the mean over the seeds.
    One run is not enough to gate on: JAX's own test passes both of its
    bars (rotation below 0.92, translation falling) at 5 of 14 seeds on
    the CPU (PERF.md §6); the translation errors are reported, not
    gated. A run's ms/step is that of its seeds' runs sharing one card
    (and the cli phase's process)."""
    import pickle
    context, tmp, steps, seeds, t_start = started
    while not context.join():
        pass
    runs = []
    for seed in seeds:
        with open(os.path.join(tmp, f"seed{seed}.pkl"), "rb") as f:
            runs.append(pickle.load(f))
        r = runs[-1]
        err0, err1 = r["errors_before"], r["errors_after"]
        print(f"[pose_recovery] seed {seed}: {steps} steps in "
              f"{r['wall_s']:.1f} s ({len(seeds)} runs sharing the card): "
              f"rotation {err0['rotation_deg']:.4f} -> "
              f"{err1['rotation_deg']:.4f} deg (ratio "
              f"{r['rotation_ratio']:.4f}), translation "
              f"{err0['translation']:.5f} -> {err1['translation']:.5f} "
              f"(ratio {r['translation_ratio']:.4f}), largest "
              f"refinement {r['largest_refinement']:.3e}")
    rot = sum(r["rotation_ratio"] for r in runs) / len(runs)
    trans = sum(r["translation_ratio"] for r in runs) / len(runs)
    print(f"[pose_recovery] mean over seeds {list(seeds)}: rotation ratio "
          f"{rot:.4f}, translation ratio {trans:.4f}")
    check(all(r["largest_refinement"] > 1e-4 for r in runs),
          "pose_recovery: a run's refinements never moved")
    check(rot < 0.92, f"pose_recovery: the mean rotation error ratio {rot} "
                      f"is not below 0.92")
    return {"config": "pose_recovery_config() (tests/test_pose_opt.py:25-40)",
            "scene": "make_synthetic_scene(36, 2, 48, 48)", "steps": steps,
            "seeds": list(seeds), "runs": runs,
            "processes": f"one a seed, {len(seeds)} sharing the card",
            "mean_rotation_ratio": rot, "mean_translation_ratio": trans,
            "phase_s": time.perf_counter() - t_start}


# the flagship through the port's command line on its own synthetic scene
# (load_scene -> make_synthetic_scene(): 24 train and 4 val views of 64^2),
# the configuration of bench.py:184-186
CLI_ARGV = ["unused", "--data_format", "synthetic", "-O", "--tpu_profile",
            "--fp16", "--num_rays", "8192"]
# what the CLI phase's training must launch (its evaluations, test frames
# and density sweeps launch the encode forward without records too)
CLI_KERNELS = ("decimate_compact", "segment_grad_outer", "hash_encode",
               "hash_encode_records", "mm_grad_table")


def phase_cli(dev, steps=128):
    """The port's entry point end to end: raw_ngp_torch.cli.main in
    process on CLI_ARGV with --iters `steps`, --save_cnt 2, --eval_cnt 2
    in a temporary workspace, every launch counter reset just before and
    read just after (the kernels of CLI_KERNELS must have been called: its
    training runs in chained CUDA-graph replays, so the counters count
    the eager steps' launches and each capture's recorded calls, not the
    replays'); the
    Trainer's logger given a recording writer in place of tensorboardX's
    (which the card's machine lacks), so that fit's gradient histograms
    run at each of its evaluations, finite and under JAX's tags; the
    seconds of its stages (Trainer build, fit, histograms, final eval,
    test frames, density sweeps, marching tetrahedra); the final eval's
    PSNR and SSIM;
    the checkpoints, validation PNGs, result frames and the inner mesh
    (faces > 0) in place. Then the step-`steps` checkpoint's tensors
    (params, EMA, moments, grid) and counters held bit for bit against an
    in-process Trainer of the same configuration and scene that took
    train(`steps`) unbroken, both through the chained path (CUDA-graph
    replays; the CLI's evaluations, histograms and saves between its
    chains do not disturb training), the generator's state too, and
    `python -m raw_ngp_torch.cli --test --ckpt latest` run as a
    subprocess in the same workspace: exit 0, restored at step `steps`,
    the result frames and the inner mesh written again, and the seconds
    of its stages as its log lines give them."""
    import collections
    import re

    import numpy as np
    import torch
    from raw_ngp_torch import cli
    from raw_ngp_torch.data import load_scene
    from raw_ngp_torch.mesh import extract
    from raw_ngp_torch.train import checkpoint
    from raw_ngp_torch.train import trainer as trainer_mod
    from raw_ngp_torch.train.trainer import Trainer

    class Recorder:
        """Stands in for tensorboardX's SummaryWriter: the tags written
        and how often, each histogram checked finite."""

        def __init__(self):
            self.histograms, self.scalars = collections.Counter(), set()

        def add_scalar(self, tag, value, step):
            self.scalars.add(tag)

        def add_histogram(self, tag, values, step):
            check(np.isfinite(values).all(), f"cli: histogram {tag} is "
                  "not finite")
            self.histograms[tag] += 1

        def close(self):
            pass

    recorder = Recorder()
    plain_logger = trainer_mod.RunLogger

    class RecordingLogger(plain_logger):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.writer = recorder

    t_phase = time.perf_counter()
    ws = scratch_workspace()
    argv = CLI_ARGV + ["--iters", str(steps), "--save_cnt", "2",
                       "--eval_cnt", "2", "--workspace", ws]
    counters = _counters()
    stages = timed_calls([
        ("trainer_build", Trainer, "__init__"), ("fit", Trainer, "fit"),
        ("histograms", Trainer, "log_histograms"),
        ("evaluate", Trainer, "evaluate"), ("test", Trainer, "test"),
        ("mesh_query", extract, "query_density_grid"),
        ("marching_tetrahedra", extract, "marching_tetrahedra"),
        ("mesh_export", extract, "export_meshes")])
    with stages:
        torch.cuda.synchronize()
        for c in counters.values():
            c.launches = 0
        t0 = time.perf_counter()
        trainer_mod.RunLogger = RecordingLogger
        try:
            rc = cli.main(argv)
        finally:
            trainer_mod.RunLogger = plain_logger
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
        launches = {k: c.launches for k, c in counters.items()}
        check(rc == 0, f"cli: main returned {rc}")
        final = [out for name, _, out in stages.calls
                 if name == "evaluate"][-1]
        evals = [s for name, s, _ in stages.calls if name == "evaluate"]
        seconds = stages.totals()
        del seconds["evaluate"]
        seconds.update(cli_main=cli_s, fit_evaluations=sum(evals[:-1]),
                       final_eval=evals[-1])
        print(f"[cli] main: {cli_s:.1f} s; seconds by stage "
              f"{json.dumps(seconds)}; final eval {final}; launches "
              f"{launches}")
        for name in CLI_KERNELS:
            check(launches[name] > 0,
                  f"cli: kernel {name} was never called")
        check_sort_launches(launches, "cli")
        check(np.isfinite(final["psnr"]) and np.isfinite(final["ssim"]),
              f"cli: the final eval is not finite: {final}")
        grad_tags = sorted(t for t in recorder.histograms
                           if t.startswith("grad/"))
        print(f"[cli] histograms at {len(evals) - 1} fit evaluations: "
              f"{dict(recorder.histograms)}")
        check(len(evals) > 1 and "grad/grid/w" in grad_tags
              and all(recorder.histograms[t] == len(evals) - 1
                      for t in grad_tags + ["train/density_grid"]),
              "cli: fit's gradient histograms did not run at each "
              f"evaluation: {dict(recorder.histograms)}")

        ckpt_dir = os.path.join(ws, "checkpoints")
        files = sorted(os.listdir(ckpt_dir))
        last = os.path.join(ckpt_dir, f"ngp_step{steps:06d}.npz")
        check(os.path.exists(last) and "ngp_best.npz" in files
              and sum(f.startswith("ngp_step") and f.endswith(".npz")
                      for f in files) == 2,
              f"cli: checkpoints {files}")
        val = os.listdir(os.path.join(ws, "validation"))
        results = sorted(os.listdir(os.path.join(ws, "results")))
        check(any(f.startswith(f"rgb_{steps}_") for f in val)
              and "rgb_000.png" in results, f"cli: validation {val}, "
              f"results {results}")
        faces = len(extract.load_ply(os.path.join(ws, "mesh",
                                                  "mesh_0.ply"))[1])
        meshes = sorted(os.listdir(os.path.join(ws, "mesh")))
        print(f"[cli] checkpoints {files}; {len(val)} validation PNGs; "
              f"results {results}; meshes {meshes}, mesh_0 {faces} faces")
        check(faces > 0, "cli: mesh_0.ply has no faces")

        # the real entry point, resumed in --test mode (a subprocess,
        # started now: it overlaps the unbroken run below)
        for d in ("results", "mesh"):
            shutil.rmtree(os.path.join(ws, d))
        root = os.path.dirname(os.path.abspath(__file__))
        env = dict(os.environ, PYTHONPATH=root)
        env.pop("RAW_NGP_PLATFORM", None)
        t_test = time.perf_counter()
        proc = subprocess.Popen([sys.executable, "-m", "raw_ngp_torch.cli",
                                 *CLI_ARGV, "--test", "--ckpt", "latest",
                                 "--workspace", ws], cwd=root, env=env,
                                stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        atexit.register(lambda: proc.poll() is None and proc.kill())

        # the same run unbroken, in process
        cfg = cli.args_to_config(cli.build_parser().parse_args(argv))
        tr = Trainer(cfg, load_scene(cfg, "train"), load_scene(cfg, "val"),
                     device=dev, workspace=scratch_workspace())
        tr.train(steps, log_every=steps)
        torch.cuda.synchronize()
    mine = checkpoint.state_tensors(tr.state)
    mine["extra.generator"] = tr.generator.get_state()
    with np.load(last, allow_pickle=False) as data:
        differ = [k for k, t in mine.items()
                  if k not in data.files or not np.array_equal(
                      t.detach().cpu().numpy(), data[k])]
        counts = (int(data["step"]), int(data["opt_state.count"]))
    print(f"[cli] step-{steps} checkpoint against train({steps}) unbroken: "
          f"{len(mine) - len(differ)} of {len(mine)} tensors bitwise "
          f"equal{'; differ: ' + str(differ) if differ else ''}; step and "
          f"Adam count {counts}")
    check(not differ and counts == (steps, steps),
          "cli: the CLI's checkpoint differs from an unbroken train()")

    try:
        stdout, stderr = proc.communicate(timeout=600)
    except subprocess.TimeoutExpired:
        proc.kill()
        raise
    r = subprocess.CompletedProcess(proc.args, proc.returncode, stdout,
                                    stderr)
    test_s = time.perf_counter() - t_test
    tail = "\n".join(r.stdout.splitlines()[-6:])
    # its lines "[cli] <stage>: <t> s" and "[mesh] <what>: <x> <t> s, ..."
    test_stages = {}
    for line in r.stdout.splitlines():
        m = re.match(r"\[(?:cli|mesh)\] ([^:]+): (.*)$", line)
        for part in m[2].split(", ") if m else ():
            t = re.fullmatch(r"(.*?) ?([0-9.]+) s", part)
            if t:
                test_stages[f"{m[1]} {t[1]}".strip()] = float(t[2])
    print(f"[cli] --test --ckpt latest: exit {r.returncode} in "
          f"{test_s:.1f} s; its stages {json.dumps(test_stages)}; its last "
          f"lines:\n{tail}")
    check(r.returncode == 0, f"cli --test failed: {r.stderr[-3000:]}")
    check(f"ngp_step{steps:06d}.npz at step {steps}" in r.stdout,
          "cli --test: not restored at the saved step")
    resumed = sorted(os.listdir(os.path.join(ws, "results")))
    faces_test = len(extract.load_ply(os.path.join(ws, "mesh",
                                                   "mesh_0.ply"))[1])
    check(resumed == results and faces_test > 0,
          f"cli --test: results {resumed}, mesh_0 {faces_test} faces")
    return launches, {
        "argv": argv[:-1] + ["<temporary workspace>"],
        "scene": "load_scene (make_synthetic_scene(): 24 train and 4 val "
                 "views of 64x64)",
        "steps": steps, "seconds": seconds, "final_eval": final,
        "eval_seconds": evals, "checkpoints": files,
        "validation_pngs": len(val), "results": results, "meshes": meshes,
        "mesh_0_faces": faces, "histograms": dict(recorder.histograms),
        "checkpoint_vs_unbroken_train": {
            "tensors": len(mine), "bitwise_equal": not differ},
        "test_mode": {"seconds": test_s, "stages": test_stages,
                      "mesh_0_faces": faces_test,
                      "results": resumed},
        "phase_s": time.perf_counter() - t_phase}


# ---------------------------------------------------------------------------
# multi: the flagship on two ranks of one card (raw_ngp_torch.parallel)
# ---------------------------------------------------------------------------

MULTI_STEPS = 64
MULTI_LABEL = "2 ranks sharing one H100 (gloo)"


def multi_config(n_tp=1):
    """The flagship on two ranks: dp = 2, or (dp = 1, tp = 2)."""
    from raw_ngp_torch.config import ParallelConfig
    return replace(flagship_config(),
                   parallel=ParallelConfig(num_devices=2, tp_devices=n_tp)
                   ).validate()


def digests(tensors):
    """{name: sha256 of the tensor's bytes}: bitwise equality across
    processes without moving the tensors."""
    import hashlib

    import torch
    return {k: hashlib.sha256(t.detach().contiguous().reshape(-1).view(
        torch.uint8).cpu().numpy().tobytes()).hexdigest()
        for k, t in tensors.items()}


def replicated(tensors):
    """The tensors every rank of a (dp, tp) layout holds alike: all but
    the radiance table's channel shards."""
    return {k: v for k, v in tensors.items() if not k.endswith(".grid")}


def rows_of(batch, s, n):
    """The batch's per-ray tensors sliced to `s` (the coarse volume is
    the scene's, kept whole)."""
    return {k: (v[s] if k != "coarse_lin" and v.shape[:1] == (n,) else v)
            for k, v in batch.items()}


def dp_grad_check(tr, dev):
    """(a) The flagship field after training, run in f32 with compact_ratio
    0 (rays independent of each other, as tests/test_parallel.py:101-162
    runs it): each rank the deterministic render's gradient of its half of
    one fixed 8,192-ray batch, averaged by the step's reduction, against
    rank 0's gradient of the whole batch; rtol 2e-5, atol 2e-6 of each
    leaf's largest entry plus 1e-6 (records pre-rounded to bf16). -> the
    max error / largest entry of each leaf (rank 0), or None."""
    import copy

    import torch
    import torch.distributed as dist
    from raw_ngp_torch.data.sampler import sample_ray_batch
    from raw_ngp_torch.models.ngp import make_field_spec
    from raw_ngp_torch.parallel.mesh import make_reduce
    from raw_ngp_torch.train.trainer import make_batch_loss_fn
    cfg = replace(tr.cfg, train=replace(tr.cfg.train, fp16=False),
                  render=replace(tr.cfg.render, compact_ratio=0.0))
    spec = make_field_spec(cfg)
    field = copy.deepcopy(tr.field)
    field.spec = spec
    sa = tr.scene_arrays
    gen = torch.Generator(device=dev).manual_seed(5)
    batch = sample_ray_batch(gen, sa["images"], sa["poses"],
                             sa["intrinsics"], tr.num_rays)
    if "coarse_lin" in sa:
        batch["coarse_lin"] = sa["coarse_lin"]
    loss_fn = make_batch_loss_fn(cfg, spec)
    n, r = tr.num_rays, tr.mesh.dp_rank
    params = dict(field.named_parameters())

    def grads_of(part):
        for p in params.values():
            p.grad = None
        loss, aux = loss_fn(field, tr.state, part, tr.aabb, None)
        loss.backward()
        return {k: p.grad.clone() for k, p in params.items()}, loss, aux

    g, loss, aux = grads_of(rows_of(batch, slice(r * n // 2,
                                                 (r + 1) * n // 2), n))
    g, _, loss, aux, _ = make_reduce(tr.mesh)(g, None, loss, aux)
    torch.cuda.synchronize()
    if dist.get_rank() != 0:
        return None
    whole, _, _ = grads_of(batch)
    err = {}
    for k, ref in whole.items():
        scale = float(ref.abs().max())
        err[k] = float((g[k] - ref).abs().max()) / max(scale, 1e-30)
        check(scale > 0 and torch.allclose(g[k], ref, rtol=2e-5,
                                           atol=2e-6 * scale + 1e-6),
              f"multi dp: the all-reduced gradient of {k} is off the whole "
              f"batch's (max err / largest {err[k]:.3e})")
    print(f"[multi dp] the fixed 8,192-ray batch (f32, compact_ratio 0): "
          f"the 2 ranks' averaged gradient against the whole batch's, max "
          f"err / largest entry {json.dumps(err)}; loss {float(loss):.6f}")
    return err


def tp_encode_checks(tr, dev, B=262144):
    """(b) The tp encode at C = 8 a shard against the C = 16 kernel on the
    whole table (gathered from the row), at ray-ordered points: the
    gathered features bit for bit in f32 and bf16; the bf16 table
    gradient of a fixed cotangent (the all-gather's backward, the shard's
    gradient divided by n_tp) bit for bit the whole table's on this rank's
    channels."""
    import torch
    from raw_ngp_torch.kernels.hash_encode import hash_encode
    from raw_ngp_torch.parallel.tp import (gather_channels, gather_table,
                                           local_grid_spec, shard_of)
    mesh, gs = tr.mesh, tr.spec.grid_spec
    local = local_grid_spec(gs, mesh.n_tp)
    shard = tr.field.grid.detach()
    full = gather_table(shard, gs, mesh)
    gen = torch.Generator(device=dev).manual_seed(11)
    x = ray_points(B, gen, dev)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype)[6:]
        ref = hash_encode(full, x, gs, compute_dtype=dtype)
        got = gather_channels(hash_encode(shard, x, local,
                                          compute_dtype=dtype),
                              gs.num_levels, mesh.tp_group, mesh.n_tp)
        torch.cuda.synchronize()
        out[f"features_{name}_bitwise"] = same_bits(got, ref)
        check(out[f"features_{name}_bitwise"], f"multi tp: the C = "
              f"{local.level_dim} features ({name}) differ from the C = "
              f"{gs.level_dim} encode")
    g = torch.randn(B, gs.output_dim, generator=gen, device=dev).to(
        torch.bfloat16)
    pf = full.clone().requires_grad_(True)
    hash_encode(pf, x, gs, compute_dtype=torch.bfloat16).backward(g)
    ps = shard.clone().requires_grad_(True)
    gather_channels(hash_encode(ps, x, local, compute_dtype=torch.bfloat16),
                    gs.num_levels, mesh.tp_group, mesh.n_tp).backward(g)
    want = shard_of(pf.grad, gs, mesh.n_tp, mesh.tp_rank)
    got = ps.grad / mesh.n_tp
    torch.cuda.synchronize()
    out["table_grad_bitwise"] = same_bits(got, want)
    check(out["table_grad_bitwise"], "multi tp: the shard's table gradient "
          "differs from the whole table's on its channels (max abs diff "
          f"{float((got - want).abs().max())})")
    print(f"[multi tp] rank {mesh.rank}: features at C = {local.level_dim} "
          f"(f32 and bf16) bit for bit the C = {gs.level_dim} encode at "
          f"{B} ray-ordered points; the bf16 table gradient of its "
          f"channels bit for bit the whole table's")
    return out


def multi_train(tr, what, steps, kernels=TRAIN_KERNELS,
                per_step=OCCUPANCY_PER_STEP):
    """`steps` Trainer steps with every launch counter reset just before
    and read just after (run_steps' checks of `kernels` and `per_step`),
    then the repro check: the state before step 1 restored, the steps run
    again, bitwise. -> the launches, the losses, the median step ms and
    the digests of what the run leaves."""
    snap = trainer_snapshot(tr)
    launches, (first, last), step_ms, ref = run_steps(
        tr, steps, kernels, what, capture_at=steps, per_step=per_step)
    launches.pop("hash_encode_by_caller")
    after = digests(training_tensors(tr))
    repro, dispatch = repro_check(tr, snap, ref, steps, what)
    return {"launches": launches, "loss_first8": first, "loss_last8": last,
            "ms_per_step": sorted(step_ms)[steps // 2],
            "ms_per_step_runs": step_ms, "digests": after,
            "repro_bitwise": repro["bitwise_equal"], "dispatch": dispatch}


ORIENT_STEPS = 32


def orient_config():
    """(d) The regularised -O configuration under JAX's tp guard
    (reg_config() with lambda_tv and lambda_wd 0: the orientation and
    entropy terms) on (dp = 1, tp = 2): the reference -O width, 16 levels
    x 2 channels, so a C = 1 shard a rank."""
    from raw_ngp_torch.config import ParallelConfig
    cfg = reg_config()
    return replace(cfg, train=replace(cfg.train, lambda_tv=0.0,
                                      lambda_wd=0.0),
                   parallel=ParallelConfig(num_devices=2, tp_devices=2)
                   ).validate()


def tp_orient_grad_check(tr, dev):
    """(d i) One fixed 4,096-ray batch's gradient on (dp = 1, tp = 2) with
    the orientation loss (the same march jitter on both sides), through
    the step's reduction, the table gathered whole, against the single
    device's on rank 0 (a field with the whole table and the same MLPs):
    the loss within rtol 1e-3 and every leaf within 2e-2 of its largest
    entry (bf16: tests/test_torch_regularizers.py's bf16 orientation
    tolerances). -> (loss rel err, {leaf: max err / largest}), or None
    on rank 1."""
    import torch
    import torch.distributed as dist
    from raw_ngp_torch.models.ngp import init_field, make_field_spec
    from raw_ngp_torch.parallel.mesh import make_reduce
    from raw_ngp_torch.parallel.tp import gather_table
    from raw_ngp_torch.train.trainer import make_batch_loss_fn
    batch, gen_fn = reg_batch(tr, 23)
    gs = tr.spec.grid_spec

    def grads_of(field, cfg, spec):
        params = dict(field.named_parameters())
        for p in params.values():
            p.grad = None
        loss, aux = make_batch_loss_fn(cfg, spec)(field, tr.state, batch,
                                                  tr.aabb, gen_fn())
        loss.backward()
        out = {k: p.grad.clone() for k, p in params.items()}
        for p in params.values():
            p.grad = None
        return out, loss, aux

    g, loss, aux = grads_of(tr.field, tr.cfg, tr.spec)
    g, _, loss, aux, _ = make_reduce(tr.mesh)(g, None, loss, aux)
    g["grid"] = gather_table(g["grid"], gs, tr.mesh)
    whole = gather_table(tr.field.grid.detach(), gs, tr.mesh)
    torch.cuda.synchronize()
    if dist.get_rank() != 0:
        return None
    cfg1 = replace(tr.cfg, parallel=replace(tr.cfg.parallel, num_devices=1,
                                            tp_devices=1))
    spec1 = make_field_spec(cfg1)
    field = init_field(spec1, device=dev)
    field.load_state_dict({**tr.field.state_dict(), "grid": whole})
    ref, loss1, _ = grads_of(field, cfg1, spec1)
    loss, loss1 = float(loss), float(loss1.detach())
    loss_err = abs(loss - loss1) / abs(loss1)
    err = {}
    for k, r in ref.items():
        scale = float(r.abs().max())
        err[k] = float((g[k] - r).abs().max()) / max(scale, 1e-30)
        check(scale > 0 and err[k] <= 2e-2,
              f"multi orient: the tp gradient of {k} is off the single "
              f"device's (max err / largest {err[k]:.3e})")
    check(loss_err <= 1e-3, f"multi orient: the tp loss {loss} is off the "
          f"single device's {loss1}")
    print(f"[multi orient] the fixed {tr.num_rays:,}-ray batch with the "
          f"orientation loss on (dp 1, tp 2), C = {gs.level_dim // tr.n_tp} "
          f"a shard: loss {loss:.6f} vs the single device's {loss1:.6f} "
          f"(rel {loss_err:.2e}); gradient max err / largest entry "
          f"{json.dumps(err)}")
    return {"loss_rel": loss_err, "grad_err_over_largest": err}


def _multi_rank(rank, world, tmp, grid_paths, dev_name):
    """One of the two ranks of the multi phase (a process of its own on
    `dev_name`, cuda:0 for both): the dp = 2 world, the (dp = 1, tp = 2)
    one, then (dp = 1, tp = 2) with the orientation loss at the -O width
    (orient_config)."""
    import pickle

    import numpy as np
    import torch
    import torch.distributed as dist
    from raw_ngp_torch.data import make_synthetic_scene
    from raw_ngp_torch.train import trainer as trainer_mod
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(dev_name)
    # the train and O phases' mark_untrained grids
    grids = {k: np.load(p) for k, p in grid_paths.items()}
    train_s, val_s = make_synthetic_scene(n_train=36, n_val=2, H=128, W=128)
    out = {}
    for kind, cfg in (("dp", multi_config(1)), ("tp", multi_config(2)),
                      ("orient", orient_config())):
        grid = grids["O" if kind == "orient" else "flagship"]
        trainer_mod.mark_untrained_grid = lambda *a, g=grid, **k: g.copy()
        dist.init_process_group(
            "gloo", init_method=f"file://{tmp}/store_{kind}", rank=rank,
            world_size=world)
        try:
            t0 = time.perf_counter()
            tr = trainer_mod.Trainer(cfg, train_s, val_s, device=dev,
                                     workspace=os.path.join(tmp, kind))
            torch.cuda.synchronize()
            res = {"trainer_s": time.perf_counter() - t0,
                   "layout": [tr.n_dp, tr.n_tp],
                   "point_budget": tr.local_point_budget(),
                   "grid_numel": tr.field.grid.numel()}
            if kind == "tp":
                res["encode"] = tp_encode_checks(tr, dev)
            if kind == "orient":
                with recorded_terms() as terms:
                    res.update(multi_train(
                        tr, f"multi {kind} rank {rank}", ORIENT_STEPS,
                        REG_KERNELS, reg_per_step(tr)))
                o = [float(v) for v in terms.values["orientation"]]
                check(len(o) == 2 * ORIENT_STEPS, f"multi orient: "
                      f"{len(o)} orientation terms in 2 x {ORIENT_STEPS} "
                      f"steps")
                res["orientation_first_last"] = [o[0], o[ORIENT_STEPS - 1]]
                check(all(math.isfinite(v) and v > 0
                          for v in res["orientation_first_last"]),
                      f"multi orient: the orientation term is not finite "
                      f"and nonzero at the first and last step "
                      f"{res['orientation_first_last']}")
            else:
                res.update(multi_train(tr, f"multi {kind} rank {rank}",
                                       MULTI_STEPS))
            res["replicated"] = sorted(replicated(training_tensors(tr)))
            if kind == "dp":
                res["grad_err"] = dp_grad_check(tr, dev)
            elif kind == "tp":
                res["render"] = tp_render_check(tr, val_s, tmp)
            else:
                res["grad_check"] = tp_orient_grad_check(tr, dev)
            out[kind] = res
            dist.barrier()
        finally:
            dist.destroy_process_group()
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def tp_render_check(tr, val_s, tmp):
    """(b) The tp eval render of the first val view; rank 0's checkpoint
    (the whole table) loaded into a single-device Trainer, which renders
    the same view: rgb and depth compared (max abs difference)."""
    import numpy as np
    import torch.distributed as dist
    from raw_ngp_torch.train.trainer import Trainer
    rgb, depth = tr.render_image(val_s.poses[0])
    path = tr.save_checkpoint()
    if dist.get_rank() != 0:
        return None
    cfg = replace(tr.cfg, parallel=replace(tr.cfg.parallel, num_devices=1,
                                           tp_devices=1), ckpt=path)
    single = Trainer(cfg, tr.train_scene, val_s, device=tr.device,
                     workspace=os.path.join(tmp, "single"))
    check(single.mesh is None and single.host_step == tr.host_step,
          "multi tp: the checkpoint did not load into one device")
    rgb1, depth1 = single.render_image(val_s.poses[0])
    diff = {"rgb": float(np.abs(rgb1 - rgb).max()),
            "depth": float(np.abs(depth1 - depth).max())}
    bitwise = bool(np.array_equal(rgb1, rgb) and np.array_equal(depth1,
                                                                depth))
    print(f"[multi tp] rank 0's checkpoint in a single-device Trainer: the "
          f"val view {'bitwise equal to' if bitwise else 'differs from'} "
          f"the tp eval render (max abs diff {json.dumps(diff)})")
    check(diff["rgb"] <= 1e-2, "multi tp: the single-device render of the "
          "checkpoint is off the tp eval render")
    return {"bitwise": bitwise, "max_abs_diff": diff,
            "ckpt_bytes": os.path.getsize(path)}


def shard_kernel_times(dev, spec, n_tp=2, B=262144):
    """The encode's kernels at the shard's width (`spec`'s C / n_tp
    channels a rank: the flagship's 8, the -O grid's 1), at B ray-ordered
    points in bf16, each against its plain version and timed (CUDA
    events) beside its bound: the forward without and with records, the
    input gradient, its JVP, the dense level's table gradient (where the
    grid has one) and B2's flat form on the last window level. ->
    {kernel: numbers}."""
    import torch
    from raw_ngp_torch.kernels import hash_encode as th
    from raw_ngp_torch.kernels.segsum import segment_grad_outer
    from raw_ngp_torch.parallel.tp import local_grid_spec
    spec = local_grid_spec(spec, n_tp)
    L, C = spec.num_levels, spec.level_dim
    bf16 = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(13)
    table = (torch.rand(spec.n_params * C, generator=gen, device=dev) * 2
             - 1) * 1e-2
    x = ray_points(B, gen, dev)
    g = torch.randn(B, L * C, generator=gen, device=dev).to(bf16)
    m = th.matmul_split(spec)
    P = sum(nw for _, _, nw in th.level_windows(spec, m))
    rows = {}

    def row(name, call, plain, err, bound):
        ms = time_ms(call, 50)
        plain_ms = time_ms(plain, 3)
        rows[name] = dict(channels=C, points=B, ms=ms, plain_ms=plain_ms,
                          bound_ms=bound[0], bound_by=bound[1],
                          max_abs_err=err)
        print(f"[multi] {name} at C = {C}: {ms:.4f} ms (plain "
              f"{plain_ms:.4f}), bound {bound[0] * 1e3:.2f} us "
              f"({bound[1]}), max abs err to plain {err:.3e}")

    f = th.hash_encode(table, x, spec, compute_dtype=bf16)
    err = float((f.float() - th.hash_encode_fused_plain(
        table, x, spec, bf16).float()).abs().max())
    check(err == 0.0, f"multi: the C = {C} forward is off its plain version")
    row("hash_encode", lambda: th.hash_encode(table, x, spec,
                                              compute_dtype=bf16),
        lambda: th.hash_encode_fused_plain(table, x, spec, bf16), err,
        encode_bound(spec, x, 2)[:2])
    _, base, w_word = th.hash_encode_records(table, x, spec, bf16)
    base_p, w_word_p = th.window_records_plain(x, spec)
    check(torch.equal(base, base_p) and torch.equal(w_word, w_word_p),
          f"multi: the C = {C} records differ from window_records_plain")
    row("hash_encode_records",
        lambda: th.hash_encode_records(table, x, spec, bf16),
        lambda: (th.hash_encode_fused_plain(table, x, spec, bf16),
                 th.window_records_plain(x, spec)), 0.0,
        encode_bound(spec, x, 2, extra_bytes=8 * P * B)[:2])
    k = th.encode_input_grad(table, x, g, spec, bf16)
    p = th.encode_input_grad_plain(table, x, g, spec, bf16)
    scale = float(p.abs().max())
    err = float((k - p).abs().max())
    check(torch.allclose(k, p, rtol=1e-5, atol=1e-5 * scale),
          f"multi: the C = {C} input gradient is off its plain version "
          f"({err})")
    row("encode_input_grad",
        lambda: th.encode_input_grad(table, x, g, spec, bf16),
        lambda: th.encode_input_grad_plain(table, x, g, spec, bf16), err,
        encode_bound(spec, x, 2, extra_bytes=B * 12, ops_per_term=4)[:2])
    ct = torch.randn(B, 3, generator=gen, device=dev)
    k = th.encode_input_jvp(table, x, ct, spec, bf16)
    p = th.encode_input_jvp_plain(table, x, ct, spec, bf16)
    check(same_bits(k, p) and same_bits(k, th.encode_input_jvp(
        table, x, ct, spec, bf16)), f"multi: the C = {C} JVP is not bit for "
          f"bit its plain version, or two calls differ")
    row("encode_input_jvp",
        lambda: th.encode_input_jvp(table, x, ct, spec, bf16),
        lambda: th.encode_input_jvp_plain(table, x, ct, spec, bf16), 0.0,
        encode_bound(spec, x, 2, extra_bytes=B * 12, ops_per_term=4)[:2])
    if m > 0:   # the dense (matmul) levels: the flagship's level 0
        n_dense = spec.offsets[m] * C
        out = torch.empty(n_dense, device=dev)
        k = th.mm_grad_table(x, g, spec, bf16)
        p = th.mm_grad_table_plain(x, g, spec, bf16)
        rows_d, prods, mass, n_terms = dense_products(x, g, spec, True)
        total = torch.zeros_like(mass).index_add_(0, rows_d, prods)
        res = spec.resolutions[0]
        check(dense_rows_agree(k[:res ** 3 * C], total.reshape(-1),
                               mass.reshape(-1), True),
              f"multi: the C = {C} dense level's gradient is off its exact "
              f"sums")
        nb = B * 3 * 4 + B * C * 2 + n_dense * 4
        b_ms, o_ms = (nb / HBM_BYTES_PER_S * 1e3,
                      2 * n_terms / F32_FLOP_PER_S * 1e3)
        row("mm_grad_table",
            lambda: th.mm_grad_table(x, g, spec, bf16, out=out),
            lambda: th.mm_grad_table_plain(x, g, spec, bf16),
            float((k - p).abs().max()),
            (max(b_ms, o_ms), "bytes" if b_ms >= o_ms else "operations"))
    lv, w0, nw = th.level_windows(spec, m)[-1]
    off = spec.offsets[lv]
    n_rows = spec.offsets[lv + 1] - off
    keys_s, perm = torch.sort(base[w0:w0 + nw].reshape(-1) - off,
                              stable=True)
    stream = (keys_s, perm.to(torch.int32), w_word[w0:w0 + nw].reshape(-1))
    flat = torch.empty(n_rows * C, device=dev)
    full = th.table_grad(spec, x, base, w_word, g, bf16)
    ref = th.table_grad(spec, x, base_p, w_word_p, g, bf16, plain=True)
    sl = slice(off * C, (off + n_rows) * C)
    scale = float(ref[sl].abs().max())
    err = float((full[sl] - ref[sl]).abs().max())
    check(torch.allclose(full[sl], ref[sl], rtol=1e-5, atol=1e-6 * scale),
          f"multi: B2's flat form at C = {C} is off its plain version "
          f"({err})")
    nb = B * 12 + B * C * 2 + n_rows * C * 4
    row("segment_grad_outer",
        lambda: segment_grad_outer(*stream, g, n_rows, C, g_col=lv * C,
                                   out=flat),
        lambda: th.table_grad(spec, x, base_p, w_word_p, g, bf16,
                              plain=True), err,
        (nb / HBM_BYTES_PER_S * 1e3, "bytes"))
    return rows


def nccl_one_rank(dev, cfg, steps=8):
    """(c) A one-rank NCCL world in this process: the flagship Trainer's
    first `steps` steps on one device, then the same steps again from the
    same state through make_parallel_train_step on the one-rank mesh
    (its all-reduces run through NCCL): params, EMA, moments and the grid
    bitwise equal."""
    import tempfile as _tf

    import torch
    import torch.distributed as dist
    from raw_ngp_torch.data import make_synthetic_scene
    from raw_ngp_torch.parallel.mesh import make_mesh, make_parallel_train_step
    from raw_ngp_torch.train.trainer import Trainer
    store = os.path.join(_tf.mkdtemp(prefix="chip_smoke_nccl_"), "store")
    dist.init_process_group("nccl", init_method=f"file://{store}", rank=0,
                            world_size=1)
    try:
        train_s, val_s = make_synthetic_scene(n_train=36, n_val=2, H=128,
                                              W=128)
        tr = Trainer(cfg, train_s, val_s, device=dev,
                     workspace=scratch_workspace())
        check(tr.mesh is None, "multi nccl: one rank made a mesh")
        snap = trainer_snapshot(tr)
        for _ in range(steps):
            tr.step()
        ref = training_tensors(tr)
        trainer_restore(tr, snap)
        tr._train_step = make_parallel_train_step(
            cfg, tr.spec, tr.net_tx, tr.num_rays, make_mesh(1),
            point_budget=tr._point_budget, pose_tx=tr.pose_tx)
        for _ in range(steps):
            tr.step()
        torch.cuda.synchronize()
        now = training_tensors(tr)
        diff = sorted(k for k, v in ref.items() if not same_bits(now[k], v))
        backend = dist.get_backend()
    finally:
        dist.destroy_process_group()
    print(f"[multi nccl] one-rank {backend} world: {steps} steps through "
          f"make_parallel_train_step, {len(ref) - len(diff)} of {len(ref)} "
          f"tensors bitwise equal to the single-device steps'")
    check(not diff, f"multi nccl: the parallel step differs from the "
          f"single-device one in {diff}")
    return {"backend": backend, "steps": steps, "tensors": len(ref),
            "bitwise_equal": not diff}


def phase_multi(dev):
    """The flagship on two gloo ranks sharing cuda:0 (two processes, which
    reuse the train phase's mark_untrained grid): (a) dp = 2: the
    averaged gradient of a fixed batch against the whole batch's, 64
    steps with every launch counter reset just before and read just after
    on each rank, params, EMA, moments and the grid bitwise equal across
    the ranks, and the run repeated bitwise (the repro check); (b) tp = 2:
    the C = 8 features and table gradient bit for bit the C = 16 ones, 64
    steps, the replicated tensors bitwise equal across the ranks, rank 0's
    checkpoint rendered by a single-device Trainer against the tp eval
    render; (d) the orientation loss under tp = 2 at the reference -O
    width (orient_config: C = 1 a shard, the O phase's grid): 32 steps
    with the regularised step's launches a step, the orientation term
    finite and nonzero at the first and last step and the same on both
    ranks, the replicated tensors bitwise across the ranks, the repro
    check, then a fixed batch's gradient against the single device's;
    (c) a one-rank NCCL world through the parallel step, bitwise the
    single-device step; then the encode's kernels at the shards' widths
    (the flagship's C = 8, the -O grid's C = 1) timed. Per-rank step
    times are those of 2 ranks sharing one H100 (gloo), not a scaling
    figure."""
    import pickle

    import numpy as np
    import torch.multiprocessing as mp
    from raw_ngp_torch.models.ngp import make_field_spec
    from raw_ngp_torch.render.eval import scene_aabb
    from raw_ngp_torch.train import trainer as trainer_mod
    from raw_ngp_torch.data import make_synthetic_scene
    cfg = flagship_config()
    train_s, _ = make_synthetic_scene(n_train=36, n_val=2, H=128, W=128)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_multi_")
    atexit.register(shutil.rmtree, tmp, True)
    grid_paths = {}
    for name, grid_cfg in (("flagship", cfg), ("O", orient_config())):
        grid_paths[name] = os.path.join(tmp, f"grid_{name}.npy")
        np.save(grid_paths[name], trainer_mod.mark_untrained_grid(
            grid_cfg, np.asarray(train_s.poses),
            np.asarray(train_s.intrinsics),
            scene_aabb(grid_cfg, train_s.pts_aabb, device="cpu").numpy(),
            cam_near_far=train_s.cam_near_far))
    t0 = time.perf_counter()
    mp.spawn(_multi_rank, args=(2, tmp, grid_paths, str(dev)), nprocs=2,
             join=True)
    ranks_s = time.perf_counter() - t0
    ranks = []
    for r in range(2):
        with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
            ranks.append(pickle.load(f))
    result = {"label": MULTI_LABEL, "steps": MULTI_STEPS,
              "ranks_s": ranks_s,
              "dispatch": ranks[0]["dp"]["dispatch"]}
    for kind in ("dp", "tp", "orient"):
        a, b = ranks[0][kind], ranks[1][kind]
        steps = ORIENT_STEPS if kind == "orient" else MULTI_STEPS
        keys = a["replicated"] if kind != "dp" else sorted(a["digests"])
        differ = [k for k in keys if a["digests"][k] != b["digests"][k]]
        same = len(keys) - len(differ)
        print(f"[multi {kind}] after {steps} steps: {same} of "
              f"{len(keys)} "
              f"{'replicated ' if kind != 'dp' else ''}tensors bitwise "
              f"equal across the ranks; ms/step ({MULTI_LABEL}) "
              f"{a['ms_per_step']:.3f} / {b['ms_per_step']:.3f}; launches "
              f"rank 0 {a['launches']}")
        check(not differ, f"multi {kind}: the ranks differ in {differ}")
        check(a["repro_bitwise"] and b["repro_bitwise"],
              f"multi {kind}: the 2-rank run did not reproduce")
        result[kind] = {
            "layout": a["layout"], "steps": steps,
            "point_budget_per_rank": a["point_budget"],
            "grid_numel_per_rank": a["grid_numel"],
            "tensors_bitwise_across_ranks": len(keys),
            "repro_bitwise": True,
            "ms_per_step_by_rank": [a["ms_per_step"], b["ms_per_step"]],
            "ms_per_step_runs_rank0": a["ms_per_step_runs"],
            "trainer_s_by_rank": [a["trainer_s"], b["trainer_s"]],
            "loss_first8_last8": [a["loss_first8"], a["loss_last8"]],
            "launches_by_rank": [a["launches"], b["launches"]]}
    result["dp"]["grad_err_over_largest"] = ranks[0]["dp"]["grad_err"]
    result["tp"]["encode"] = [ranks[0]["tp"]["encode"],
                              ranks[1]["tp"]["encode"]]
    result["tp"]["render"] = ranks[0]["tp"]["render"]
    o0, o1 = (r["orient"]["orientation_first_last"] for r in ranks)
    print(f"[multi orient] the orientation term at the first and last step "
          f"{o0} (rank 1: {o1}); lambda_orientation "
          f"{orient_config().train.lambda_orientation}")
    check(o0 == o1, "multi orient: the ranks' orientation terms differ")
    result["orient"]["config"] = (
        "orient_config(): reg_config() with lambda_tv 0 and lambda_wd 0 on "
        "(dp 1, tp 2): lambda_orientation 0.1, lambda_entropy 1e-4")
    result["orient"]["orientation_first_last"] = o0
    result["orient"]["fixed_batch_vs_single_device"] = ranks[0]["orient"][
        "grad_check"]
    result["nccl"] = nccl_one_rank(dev, cfg)
    result["shard_kernels"] = shard_kernel_times(
        dev, make_field_spec(cfg).grid_spec)
    result["shard_kernels_C1"] = shard_kernel_times(
        dev, make_field_spec(orient_config()).grid_spec)
    result["gpu"] = gpu_line()
    return result


def deterministic_ops(dev):
    """A diagnostic: two train steps and two pose steps of the flagship and
    two steps each of the -O2 proposal path, the -O path and the
    regularised -O path on the fused and the unfused encoder, on 4 cameras
    under torch.use_deterministic_algorithms(True, warn_only=True) (the
    first occupancy step holds a grid refresh); the warnings PyTorch gives for
    ops on the path without a deterministic CUDA implementation, by path.
    Ops that have one (index_add_, scatter_add_, cumsum) take it in this
    mode silently: the repro check, not this list, shows that the normal
    mode reproduces."""
    import warnings

    import torch
    from raw_ngp_torch.data import make_synthetic_scene
    from raw_ngp_torch.train.trainer import Trainer
    train_s, val_s = make_synthetic_scene(n_train=4, n_val=1, H=128, W=128)
    # the probes: torch.histc has no deterministic CUDA implementation, so
    # it must warn here (the capture works); index_add_ into ascending ids,
    # as gather_ray_rows' backward summed before it took index_put_'s
    # accumulate, switches to a deterministic kernel in this mode without
    # a warning, so two calls outside it show whether its sums vary
    gen = torch.Generator(device=dev).manual_seed(10)
    ids = torch.sort(torch.randint(0, 8192, (262144,), generator=gen,
                                   device=dev)).values
    vals = torch.randn(262144, 8, generator=gen, device=dev)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.histc(vals, bins=16)
    finally:
        torch.use_deterministic_algorithms(False)
    sums = [torch.zeros(8192, 8, device=dev).index_add_(0, ids, vals)
            for _ in range(2)]
    torch.cuda.synchronize()
    found = {"probe": {
        "histc_warns": bool(caught),
        "index_add_two_calls_bitwise_equal": same_bits(*sums),
        "index_add_max_abs_diff": float((sums[0] - sums[1]).abs().max())}}
    print(f"[deterministic_ops] probe: {found['probe']}")
    check(found["probe"]["histc_warns"],
          "deterministic_ops: the warnings are not captured")
    for what, cfg in (("train", flagship_config()),
                      ("pose", pose_config(128, n_cameras=4)),
                      ("proposal", proposal_config()), ("O", o_config()),
                      ("reg", reg_config()),
                      ("unfused", reg_config(fused=False))):
        tr = Trainer(cfg, train_s, val_s, device=dev,
                     workspace=scratch_workspace())
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                for _ in range(2):
                    tr.step()
                torch.cuda.synchronize()
        finally:
            torch.use_deterministic_algorithms(False)
        found[what] = sorted({str(w.message).strip().splitlines()[0][:400]
                              for w in caught})
        for msg in found[what]:
            print(f"[deterministic_ops] {what}: {msg}")
        print(f"[deterministic_ops] {what}: {len(found[what])} distinct "
              f"warnings")
    return found


HDR_PAIRS = tuple((m, t) for m in ("robertson", "debevec")
                  for t in ("reinhard", "mantiuk", "drago"))


def hdr_config():
    """The light-stage configuration with the wide exposure range: 7
    percentiles, and the Robertson merge unless a merge is named."""
    cfg = lightstage_config()
    return replace(cfg, data=replace(cfg.data, exposure_range="wide")
                   ).validate()


def hdr_stages(rgb, cam2rgb, percentiles):
    """postprocess_raw_hdr's stages on one render, each run once in the
    order the function runs them: (host seconds of each calibration,
    merge and tonemap, the exposure count, {merge: response})."""
    from raw_ngp_torch.postprocess import hdr
    from raw_ngp_torch.postprocess.raw import exposure_stack
    exposed, times = exposure_stack(rgb @ cam2rgb.T, percentiles)
    seconds, responses, radiance = {}, {}, {}
    for merge in ("robertson", "debevec"):
        t0 = time.perf_counter()
        responses[merge] = getattr(hdr, f"calibrate_{merge}")(exposed, times)
        seconds[f"calibrate_{merge}_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        radiance[merge] = getattr(hdr, f"merge_{merge}")(exposed, times,
                                                         responses[merge])
        seconds[f"merge_{merge}_s"] = time.perf_counter() - t0
    for tonemap in ("reinhard", "mantiuk", "drago"):
        t0 = time.perf_counter()
        try:
            getattr(hdr, f"tonemap_{tonemap}")(radiance["robertson"])
        except ValueError:      # cv2's assertion: reported, not timed
            seconds[f"tonemap_{tonemap}_s"] = None
            continue
        seconds[f"tonemap_{tonemap}_s"] = time.perf_counter() - t0
    return seconds, len(exposed), responses


def phase_hdr(dev, steps=128, large=512):
    """HDR-merged test frames on the card: hdr_config() (the light-stage
    configuration, exposure_range "wide") on the light-stage scene,
    `steps` Trainer steps with every launch counter reset just before and
    read just after (run_steps' checks: the train path's kernels), then
    Trainer.test of the val views under each merge x tonemap pair: each
    writes hdr_000.png and hdr_001.png, each frame bit for bit the uint8
    form of postprocess_raw_hdr of the same render on the host, 7
    exposures or fewer; the count of NaN values of each pair; Debevec's
    response non-decreasing in each channel (cv2's is on the CPU test's
    7-exposure input; Robertson's, NaN at levels no pixel takes as in
    cv2, is reported only); the host seconds of each calibration, merge
    and tonemap for one 128x128 frame and one 512x512 render of the val
    view. Returns (launches, the trainer, the phase's numbers)."""
    import numpy as np
    from raw_ngp_torch.data import make_synthetic_scene
    from raw_ngp_torch.data.image_io import read_png
    from raw_ngp_torch.postprocess.raw import postprocess_raw_hdr
    from raw_ngp_torch.train.trainer import Trainer, _cam2rgb, _to_u8
    from raw_ngp_torch.render.eval import render_image

    t_phase = time.perf_counter()
    cfg = hdr_config()
    check(cfg.hdr_merge_algo == "robertson" and
          len(cfg.exposure_percentiles) == 7,
          f"hdr: merge {cfg.hdr_merge_algo}, percentiles "
          f"{cfg.exposure_percentiles}")
    train_s, val_s = make_synthetic_scene(n_train=36, n_val=2, H=128,
                                          W=128, hdr=True, rfield=True)
    tr = Trainer(cfg, train_s, val_s, device=dev,
                 workspace=scratch_workspace())
    launches, (first, last), _, _ = run_steps(tr, steps, TRAIN_KERNELS,
                                              "hdr")
    cam2rgb = _cam2rgb(val_s)
    renders = [tr.render_image(val_s.poses[i], val_s.intrinsics, val_s.H,
                               val_s.W, ldir=val_s.ldirs[i])[0]
               for i in range(val_s.n_images)]
    pairs = {}
    for merge, tonemap in HDR_PAIRS:
        tr.cfg = replace(cfg, data=replace(cfg.data, hdr_merge=merge,
                                           hdr_tonemap=tonemap))
        out = tempfile.mkdtemp(prefix="chip_smoke_hdr_")
        atexit.register(shutil.rmtree, out, True)
        t0 = time.perf_counter()
        frames = tr.test(val_s, save_dir=out)
        test_s = time.perf_counter() - t0
        names = sorted(os.listdir(out))
        check(names == ["depth_000.png", "depth_001.png", "hdr_000.png",
                        "hdr_001.png", "rgb_000.png", "rgb_001.png"],
              f"hdr {merge}/{tonemap}: frames written {names}")
        check(len(frames) == 2, f"hdr {merge}/{tonemap}: {len(frames)} rgb")
        nan = []
        for i, rgb in enumerate(renders):
            merged = postprocess_raw_hdr(rgb, cam2rgb,
                                         cfg.exposure_percentiles, merge,
                                         tonemap)
            nan.append(int(np.isnan(merged).sum()))
            check(np.array_equal(read_png(os.path.join(
                out, f"hdr_{i:03d}.png")), _to_u8(merged)),
                  f"hdr {merge}/{tonemap}: hdr_{i:03d}.png is not the "
                  "host's postprocess_raw_hdr of the same render")
        pairs[f"{merge}/{tonemap}"] = {"nan_values": nan,
                                       "test_s": test_s}
        print(f"[hdr] {merge}/{tonemap}: frames bit for bit the host's "
              f"merge; NaN values {nan}; Trainer.test {test_s:.2f} s")
    tr.cfg = cfg
    # the stages of the first val render's merge and of a 512x512 render
    intr_l = val_s.intrinsics * (large / val_s.H)
    rgb_l, _ = render_image(tr.ema_field, tr.state.density_bitfield,
                            val_s.poses[0], intr_l, large, large, tr.aabb,
                            device=dev, ldir=val_s.ldirs[0])
    rgb_l = rgb_l.float().cpu().numpy()
    check(bool(np.isfinite(rgb_l).all()), "hdr: the 512x512 render")
    seconds, n_exposed, responses = hdr_stages(renders[0], cam2rgb,
                                               cfg.exposure_percentiles)
    check(0 < n_exposed <= 7, f"hdr: {n_exposed} exposures")
    seconds = {"128x128": seconds, f"{large}x{large}": hdr_stages(
        rgb_l, cam2rgb, cfg.exposure_percentiles)[0]}
    monotone = {}
    for merge, crf in responses.items():
        crf = crf[:, 0]
        monotone[merge] = [bool((np.diff(crf[:, c]) >= 0).all())
                           for c in range(3)]
        monotone[f"{merge}_nan_levels"] = [int(np.isnan(crf[:, c]).sum())
                                           for c in range(3)]
    check(all(monotone["debevec"]), f"hdr: Debevec's response is not "
          f"non-decreasing in every channel: {monotone}")
    print(f"[hdr] exposures {n_exposed}; responses non-decreasing "
          f"{monotone}; host seconds {json.dumps(seconds)}")
    return launches, tr, {
        "config": "hdr_config(): lightstage_config() + exposure_range "
                  "wide (7 percentiles, robertson by default)",
        "scene": "make_synthetic_scene(36, 2, 128, 128, hdr=True, "
                 "rfield=True)", "steps": steps,
        "loss_first8": first, "loss_last8": last, "pairs": pairs,
        "exposures": n_exposed, "response_non_decreasing": monotone,
        "host_s": seconds, "launches": {k: v for k, v in launches.items()
                                        if k != "hash_encode_by_caller"},
        "gpu": gpu_line(), "phase_s": time.perf_counter() - t_phase}


def phase_host(size=2048, n_codes=1 << 21, reps=5):
    """The native host library (raw_ngp_torch.native over
    csrc/host_native.cpp, built with g++ at first use): available() on
    this machine, and each of its six functions against its numpy form
    on a size x size mosaic or n_codes codes / cells: Morton codes both
    ways and packbits bit for bit, the demosaic's interior within 1e-5,
    normalize_levels within 1e-6 and the sRGB curve within 1e-5 (the
    tolerances of tests/test_torch_native.py); both routes timed on the
    host (median of `reps`, ms)."""
    import numpy as np
    from raw_ngp_torch import native
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    check(native.available(), "host: the native library did not build")
    build_s = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    bayer = rng.uniform(0, 1.2, (size, size)).astype(np.float32)
    coords = rng.integers(0, 1024, (n_codes, 3)).astype(np.int32)
    codes = rng.integers(0, 1 << 30, n_codes).astype(np.uint32)
    grid = rng.uniform(0, 20, n_codes).astype(np.float32)
    calls = {
        "demosaic_rggb": lambda: native.demosaic_rggb(bayer),
        "normalize_levels": lambda: native.normalize_levels(
            bayer, 0.00024420026, 1.0, True),
        "morton3d_encode": lambda: native.morton3d_encode(coords),
        "morton3d_decode": lambda: native.morton3d_decode(codes),
        "packbits": lambda: native.packbits(grid, 10.0),
        "linear_to_srgb": lambda: native.linear_to_srgb(bayer)}

    def timed_ms(fn):
        out, ts = None, []
        for _ in range(reps):
            t = time.perf_counter()
            out = fn()
            ts.append((time.perf_counter() - t) * 1e3)
        return out, sorted(ts)[reps // 2]

    routes = {}
    for route in ("cpp", "numpy"):
        saved = native._LIB, native._TRIED
        if route == "numpy":
            native._LIB, native._TRIED = None, True
        try:
            routes[route] = {k: timed_ms(fn) for k, fn in calls.items()}
        finally:
            native._LIB, native._TRIED = saved
    result = {}
    for name in calls:
        got, want = routes["cpp"][name][0], routes["numpy"][name][0]
        if name == "demosaic_rggb":
            err = float(np.abs(got[2:-2, 2:-2] - want[2:-2, 2:-2]).max())
            ok = err <= 1e-5
        elif name in ("normalize_levels", "linear_to_srgb"):
            err = float(np.abs(got - want).max())
            ok = err <= (1e-6 if name == "normalize_levels" else 1e-5)
        else:
            ok = got.dtype == want.dtype and np.array_equal(got, want)
            err = 0.0 if ok else None
        check(ok, f"host: {name} C++ against numpy: {err}")
        result[name] = {"cpp_ms": routes["cpp"][name][1],
                        "numpy_ms": routes["numpy"][name][1],
                        "max_abs_err": err}
        print(f"[host] {name}: C++ {result[name]['cpp_ms']:.2f} ms, numpy "
              f"{result[name]['numpy_ms']:.2f} ms, max |diff| {err}")
    return {"library": str(native.library_path().name),
            "first_use_s": build_s, "inputs": f"{size}x{size} mosaic, "
            f"{n_codes} codes / cells", "functions": result,
            "cpu_count": os.cpu_count(),
            "phase_s": time.perf_counter() - t_phase}


def phase_tools(dev, tr, iters=256, eval_every=128):
    """The port's offline tools on this machine (no cv2, imageio or PIL):
    offline_eval on the hdr phase Trainer's evaluate(save_artifacts=True,
    export_npy=True) dumps, plain, --raw and --raw --hdr_merge robertson
    (with the configuration's 7 percentiles), finite PSNR and SSIM;
    colmap2nerf and downscale --factor 2 on a COLMAP folder that
    write_colmap_scene writes (removed after); quality_run --iters
    `iters` --eval_every `eval_every` on the card with every launch
    counter reset just before and read just after (the train path's
    kernels called: its training is chained, so the counters count the
    eager launches and each capture's recorded calls, not the replays'),
    then summarize_quality on its JSON. Returns (launches, numbers)."""
    import numpy as np
    import torch
    from raw_ngp_torch.data import make_synthetic_scene
    from raw_ngp_torch.data.image_io import read_png
    from raw_ngp_torch.kernels import _build
    from raw_ngp_torch.tools import (colmap2nerf, downscale, offline_eval,
                                     quality_run, summarize_quality)
    t_phase = time.perf_counter()
    tr.evaluate(save_artifacts=True, export_npy=True)
    eval_dir = os.path.join(tr.workspace, "eval")
    pct = [str(p) for p in tr.cfg.exposure_percentiles]
    evals = {}
    for name, flags in (("plain", []), ("raw", ["--raw"]),
                        ("raw_hdr_robertson", ["--raw", "--hdr_merge",
                                               "robertson", "--percentiles",
                                               *pct])):
        r = offline_eval.main([eval_dir, *flags])
        check(r["n_images"] == 2 and np.isfinite(r["psnr"])
              and np.isfinite(r["ssim"]),
              f"tools: offline_eval {name} gave {r}")
        evals[name] = r
    root = _build.BUILD_DIR.parent / "tools_scene"
    shutil.rmtree(root, ignore_errors=True)
    try:
        scene, _ = make_synthetic_scene(n_train=6, n_val=1, H=64, W=64)
        write_colmap_scene(str(root), scene.images, scene.poses,
                           scene.intrinsics, step=4)
        with open(colmap2nerf.main([str(root)])) as f:
            transforms = json.load(f)
        check(len(transforms["frames"]) == 6
              and (transforms["h"], transforms["w"]) == (scene.H, scene.W),
              "tools: colmap2nerf's transforms.json")
        downscale.main([str(root), "--factor", "2"])
        small = sorted(os.listdir(root / "images_2"))
        check(len(small) == 6 and all(
            read_png(str(root / "images_2" / n)).shape
            == (scene.H // 2, scene.W // 2, 3)
            for n in small), f"tools: downscale wrote {small}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out = tempfile.mkdtemp(prefix="chip_smoke_quality_")
    atexit.register(shutil.rmtree, out, True)
    path = os.path.join(out, "quality_run.json")
    counters = _counters()
    torch.cuda.synchronize()
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    run = quality_run.main(["--iters", str(iters), "--eval_every",
                            str(eval_every), "--out", path,
                            "--device", str(dev)])
    torch.cuda.synchronize()
    quality_s = time.perf_counter() - t0
    launches = {k: c.launches for k, c in counters.items()}
    for name in TRAIN_KERNELS:
        check(launches[name] > 0, f"tools: quality_run never called "
              f"{name}")
    check_sort_launches(launches, "tools")
    held = [c["psnr_heldout"] for c in run["curve"]]
    check(len(held) == iters // eval_every and all(np.isfinite(held)),
          f"tools: quality_run's held-out PSNRs {held}")
    table = summarize_quality.main([path])
    check(len(table) == 3 and "error" not in table[2],
          f"tools: summarize_quality gave {table}")
    print(f"[tools] quality_run {iters} steps in {quality_s:.1f} s: "
          f"held-out PSNR {held}; launches {launches}")
    for w in list(os.listdir(tempfile.gettempdir())):
        if w.startswith("raw_ngp_torch_quality_"):
            shutil.rmtree(os.path.join(tempfile.gettempdir(), w), True)
    return launches, {
        "offline_eval": evals, "colmap2nerf_frames": len(
            transforms["frames"]), "downscaled": len(small),
        "quality_run": {"argv": f"--iters {iters} --eval_every "
                                f"{eval_every}", "curve": run["curve"],
                        "heldout_psnr": held, "seconds": quality_s},
        "summarize_quality": table[2],
        "phase_s": time.perf_counter() - t_phase}


def gpu_line():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout else \
            f"nvidia-smi gave no output (exit {out.returncode})"
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e})"


def build_others(trees):
    """Build each tree's raw_ngp_torch/csrc/hash_encode.cu with this
    tree's nvcc flags into build/raw_ngp_torch/against/ (one nvcc each,
    all started together) and bind its forward, input-gradient and JVP
    entry points (the same C signatures as this tree's) -> {tree: (fns,
    the width of the level-table rows it reads)}."""
    import ctypes
    import hashlib
    import re
    from pathlib import Path
    from raw_ngp_torch.kernels import _build
    from raw_ngp_torch.kernels.hash_encode import _ARGTYPES
    out_dir = _build.BUILD_DIR / "against"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for tree in trees:
        src = Path(tree) / "raw_ngp_torch" / "csrc" / "hash_encode.cu"
        text = src.read_text()
        lib_path = out_dir / (f"libhash_encode-"
                              f"{hashlib.sha256(text.encode()).hexdigest()[:12]}"
                              f".so")
        width = int(re.search(r"constexpr int kLevelRow = (\d+);",
                              text).group(1))
        procs[tree] = (subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib_path),
             str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), lib_path, width)
    built = {}
    for tree, (proc, lib_path, width) in procs.items():
        log, _ = proc.communicate()
        check(proc.returncode == 0, f"against: {tree} does not build\n{log}")
        for k in ptxas_report(log):
            print(f"[against] {tree}: {k}")
        lib = ctypes.CDLL(str(lib_path))
        fns = {}
        for name in ("hash_encode_fwd", "hash_encode_bwd_input",
                     "hash_encode_input_jvp"):
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = _ARGTYPES[name], ctypes.c_int
            fns[name] = fn
        built[tree] = (fns, width)
    return built


def compare_encode(dev, cfg, o_cfg, tree, other, reps=20, B=262144):
    """Same-call A/B of the encode forward, input gradient and JVP: `tree`'s
    kernels (`other` from build_others, through this tree's wrappers)
    against this tree's on the inputs of phase_encode / phase_encode_input
    on the flagship grid (`cfg`'s), the forward also at ray-ordered and
    uniform points on the -O grid (`o_cfg`'s) and the JVP on
    phase_encode_jvp's inputs on both, device time (profiler) and CUDA
    events in turns other, this, this, other; outputs compared on the
    way."""
    import torch
    from raw_ngp_torch.kernels import hash_encode as th
    from raw_ngp_torch.models.ngp import make_field_spec
    fns, width = other
    mine, table_of = th._lib, th._level_table
    narrow = {}

    def narrow_table(spec, m, device):
        key = (spec, m, device)
        if key not in narrow:
            narrow[key] = table_of(spec, m, device)[:, :width].contiguous()
        return narrow[key]

    def use(which):
        if which == "this":
            th._lib, th._level_table = mine, table_of
        else:
            th._lib = lambda name: fns[name] if name in fns else mine(name)
            th._level_table = narrow_table

    cases = []
    for grid, grid_cfg in (("flagship", cfg), ("O", o_cfg)):
        spec = make_field_spec(grid_cfg).grid_spec
        L, C = spec.num_levels, spec.level_dim
        gen = torch.Generator(device=dev).manual_seed(2)
        table = torch.rand(spec.n_params * C, generator=gen, device=dev) \
            * 2 - 1
        inputs = encode_inputs(grid_cfg, gen, dev, B, kinds=(
            ("uniform", "ray", "refresh") if grid == "flagship"
            else ("uniform", "ray")))
        cot = torch.randn(B, L * C, generator=gen, device=dev)
        ct = torch.randn(B, 3, generator=gen, device=dev)
        for kind, x01 in inputs.items():
            for dtype in (torch.bfloat16, torch.float32):
                if grid == "O" and dtype == torch.float32:
                    continue
                cases.append((f"forward {grid} {kind} {str(dtype)[6:]}",
                              lambda x01=x01, dtype=dtype, table=table,
                              spec=spec: th.hash_encode(
                                  table, x01, spec, compute_dtype=dtype)))
        for kind in ("uniform", "ray"):
            for dtype in (torch.bfloat16, torch.float32):
                x01, g = inputs[kind], cot.to(dtype)
                if grid == "flagship":
                    cases.append((f"input_grad {grid} {kind} "
                                  f"{str(dtype)[6:]}",
                                  lambda x01=x01, g=g, dtype=dtype,
                                  table=table, spec=spec: (
                                      th.encode_input_grad(
                                          table, x01, g, spec, dtype))))
                cases.append((f"jvp {grid} {kind} {str(dtype)[6:]}",
                              lambda x01=x01, dtype=dtype, table=table,
                              spec=spec, ct=ct: th.encode_input_jvp(
                                  table, x01, ct, spec, dtype)))
    result = {"against": str(tree), "level_row_width": width}
    try:
        for name, fn in cases:
            row = {}
            outs = {}
            for which in ("other", "this"):
                use(which)
                outs[which] = fn()
            torch.cuda.synchronize()
            row["same_bits"] = same_bits(outs["this"], outs["other"])
            row["max_abs_diff"] = float((outs["this"].float()
                                         - outs["other"].float()).abs()
                                        .max())
            for i, which in enumerate(("other", "this", "this", "other")):
                use(which)
                row[f"{which}_device_ms_{i}"] = device_ms(fn, reps)
                row[f"{which}_ms_{i}"] = time_ms(fn, 50)
            # the means of each tree's two turns, and this tree's over the
            # other's (CUDA events)
            for which, turns in (("other", (0, 3)), ("this", (1, 2))):
                for unit in ("ms", "device_ms"):
                    row[f"{which}_{unit}"] = sum(
                        row[f"{which}_{unit}_{i}"] for i in turns) / 2
            row["this_over_other"] = row["this_ms"] / row["other_ms"]
            result[name] = row
            print(f"[against] {name}: {row}")
    finally:
        use("this")
    return result


def main() -> int:
    import argparse
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument(
        "--against", metavar="TREE", nargs="+", default=(),
        help="only build and compare the encode forward, input gradient "
             "and JVP of each TREE's raw_ngp_torch/csrc/hash_encode.cu with "
             "this tree's, in one process (prints one `ab` line per TREE)")
    parser.add_argument(
        "--seed", type=int, default=0,
        help="seed of the jpeg, exr and dng phases' 4032x3024 host-timing "
             "images")
    parser.add_argument(
        "--b2-parent", metavar="TREE",
        help="a parent tree (or a directory holding its segsum.cu and "
             "segments.cuh: port_tools/segsum_probe.py --extract) whose B2 "
             "flat form is built beside this one and timed with it in the "
             "segsum, proposal and O phases, the same bits checked")
    parser.add_argument(
        "--deterministic-ops", action="store_true",
        help="only build and run the deterministic-algorithms diagnostic: "
             "one train and one pose step under torch."
             "use_deterministic_algorithms(True, warn_only=True)")
    args = parser.parse_args()
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda is not available; this script needs "
              "one NVIDIA GPU", file=sys.stderr)
        return 2
    try:
        import raw_ngp_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the raw_ngp_torch package is missing ({e})",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda:0")
    B2_PARENT["tree"] = args.b2_parent
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    t_start = time.time()
    if args.against:
        try:
            phase_build()
            others = build_others(args.against)
            for tree in args.against:
                print(json.dumps({"ab": compare_encode(
                    dev, flagship_config(), o_config(), tree,
                    others[tree])}))
        except Exception:
            traceback.print_exc()
            print("chip_smoke: FAILED", file=sys.stderr)
            return 1
        print(gpu_line())
        return 0
    if args.deterministic_ops:
        try:
            phase_build()
            print(json.dumps({"deterministic_ops": deterministic_ops(dev)}))
        except Exception:
            traceback.print_exc()
            print("chip_smoke: FAILED", file=sys.stderr)
            return 1
        print(gpu_line())
        return 0
    seconds = {}

    def timed(name, fn, *args, **kwargs):
        """fn(*args, **kwargs), its seconds kept under `name`."""
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        seconds[name] = round(time.perf_counter() - t0, 1)
        return out

    try:
        ptxas = timed("build", phase_build)
        check_registers(ptxas)
        k_decimate, k_decimate_bwd = timed("decimate", phase_decimate, dev)
        from raw_ngp_torch.models.ngp import make_field_spec
        cfg = flagship_config()
        spec = make_field_spec(cfg).grid_spec
        k_encode = timed("encode", phase_encode, dev, cfg)
        k_segsum, k_flat = timed("segsum", phase_segsum, dev)
        k_records, k_mm, table_grad = timed("encode_bwd", phase_encode_bwd,
                                            dev, spec)
        k_sort = timed("sort", phase_sort, dev)
        k_input = timed("encode_input", phase_encode_input, dev, cfg)
        k_channel = timed("segsum_channel", phase_segsum_channel, dev)
        render_launches, render = timed("slice", phase_slice, dev, cfg)
        with cached_mark_untrained():
            train_launches, train = timed("train", phase_train, dev, cfg)
            disk_launches, disk = timed("disk", phase_disk, dev,
                                        train_launches)
            jpeg_launches, jpeg_phase = timed("jpeg", phase_jpeg, dev,
                                              train_launches, args.seed)
            pose_launches, pose = timed("pose", phase_pose, dev)
            light_launches, lightstage = timed("lightstage",
                                               phase_lightstage, dev)
            proposal_launches, proposal = timed("proposal", phase_proposal,
                                                dev)
            o_launches, o_render_launches, o_phase = timed("O", phase_o, dev)
            captures = timed("captures", capture_scene)
            exr_launches, exr_phase = timed("exr", phase_capture, dev, "exr",
                                            o_launches, captures, args.seed)
            dng_launches, dng_phase = timed("dng", phase_capture, dev, "dng",
                                            o_launches, captures, args.seed)
            del captures
            k_jvp = timed("encode_jvp", phase_encode_jvp, dev, o_config(),
                          flagship=cfg)
            launches, reg, reg_ms = timed("reg", phase_reg, dev)
            unfused_launches, unfused = timed("unfused", phase_unfused, dev,
                                              reg_ms)
            # the pose-recovery runs, host-bound, overlap the cli phase,
            # host-bound too
            started = pose_recovery_start(dev)
            cli_launches, cli = timed("cli", phase_cli, dev)
            pose_recovery = timed("pose_recovery", pose_recovery_finish,
                                  started)
            multi = timed("multi", phase_multi, dev)
            hdr_launches, hdr_tr, hdr_phase = timed("hdr", phase_hdr, dev)
            host = timed("host", phase_host)
            tools_launches, tools = timed("tools", phase_tools, dev,
                                          hdr_tr)
            del hdr_tr
    except Exception:  # every phase failure ends the run without a result
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    # the radix sort's numbers: the flagship step's two streams summed
    # (the -O2 step's 26 replace them below, as for B2), -O's 16 beside
    k_sort.update(train["sorts"]["summed"],
                  streams_flagship=train["sorts"]["streams"],
                  O=o_phase["sorts"]["summed"],
                  streams_O=o_phase["sorts"]["streams"],
                  proposal_by_grid=proposal["sorts"]["by_grid"],
                  streams_proposal=proposal["sorts"]["streams"],
                  library="torch.sort(keys - offset, stable=True) and the "
                          "indices' .to(torch.int32)")
    kernels = []
    for k in (k_decimate, k_decimate_bwd, k_encode, k_records, k_mm, k_input,
              k_jvp, k_flat, k_segsum, k_channel, k_sort):
        k = dict(k)
        # the -O2 proposal phase's kernels' numbers at its shapes (its
        # radiance grid is the -O grid), the flagship's beside them;
        # `launches` are the reg phase's: the path that runs the most
        # of them
        rows = proposal["kernel_rows"]
        if k["name"] in rows:
            keep = ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms", "library_device_ms", "max_abs_err",
                    "launches_per_call", "library_launches_per_call")
            k["flagship"] = {key: k.get(key) for key in keep}
            k.update(rows[k["name"]])
        k["launches"] = launches[k["name"]]
        k["launches_reg"] = launches[k["name"]]
        k["reg_launched"] = launches[k["name"]] > 0
        k["launches_unfused"] = unfused_launches[k["name"]]
        k["launches_O"] = o_launches[k["name"]]
        k["O_launched"] = o_launches[k["name"]] > 0
        k["launches_O_normal_render_chunk"] = o_render_launches[k["name"]]
        k["launches_proposal"] = proposal_launches[k["name"]]
        k["proposal_launched"] = proposal_launches[k["name"]] > 0
        k["launches_lightstage"] = light_launches[k["name"]]
        k["launches_pose"] = pose_launches[k["name"]]
        k["launches_train"] = train_launches[k["name"]]
        k["launches_disk"] = disk_launches[k["name"]]
        k["launches_jpeg"] = jpeg_launches[k["name"]]
        k["launches_exr"] = exr_launches[k["name"]]
        k["launches_dng"] = dng_launches[k["name"]]
        k["launches_cli"] = cli_launches[k["name"]]
        k["launches_hdr"] = hdr_launches[k["name"]]
        k["launches_tools_quality_run"] = tools_launches[k["name"]]
        k["launches_render"] = render_launches.get(k["name"], 0)
        # each rank's launches in the multi phase's runs (dp = 2 and tp =
        # 2 at C = 8 channels a rank, 64 steps each; the orientation loss
        # under tp = 2 at C = 1, 32 steps), and the kernel's numbers at
        # the shards' widths where it is one of the encode's
        k["launches_multi"] = {kind: [r[k["name"]] for r in
                                      multi[kind]["launches_by_rank"]]
                               for kind in ("dp", "tp", "orient")}
        for key, rows in (("shard_C8", multi["shard_kernels"]),
                          ("shard_C1", multi["shard_kernels_C1"])):
            if k["name"] in rows:
                k[key] = rows[k["name"]]
        if k["name"] in ("hash_encode", "hash_encode_records"):
            k["launches_by_caller"] = {
                "reg": launches["hash_encode_by_caller"],
                "O": o_launches["hash_encode_by_caller"],
                "proposal": proposal_launches["hash_encode_by_caller"],
                "lightstage": light_launches["hash_encode_by_caller"],
                "pose": pose_launches["hash_encode_by_caller"],
                "disk": disk_launches["hash_encode_by_caller"],
                "jpeg": jpeg_launches["hash_encode_by_caller"],
                "exr": exr_launches["hash_encode_by_caller"],
                "dng": dng_launches["hash_encode_by_caller"],
                "train": train_launches["hash_encode_by_caller"]}
        if k["name"] in REGISTER_CHECKED:
            k["ptxas"] = checked_instantiations(ptxas, k["name"])
        kernels.append(k)
    print(f"[done] {time.time() - t_start:.1f} s; seconds by phase "
          f"{json.dumps(seconds)}")
    print(json.dumps({"render": render}))
    print(json.dumps({"train": train}))
    print(json.dumps({"disk": disk}))
    print(json.dumps({"jpeg": jpeg_phase}))
    print(json.dumps({"pose": pose}))
    print(json.dumps({"lightstage": lightstage}))
    print(json.dumps({"proposal": proposal}))
    print(json.dumps({"O": o_phase}))
    print(json.dumps({"exr": exr_phase}))
    print(json.dumps({"dng": dng_phase}))
    print(json.dumps({"reg": reg}))
    print(json.dumps({"unfused": unfused}))
    print(json.dumps({"pose_recovery": pose_recovery}))
    print(json.dumps({"cli": cli}))
    print(json.dumps({"multi": {k: v for k, v in multi.items()
                                if not k.startswith("shard_kernels")}}))
    print(json.dumps({"hdr": hdr_phase}))
    print(json.dumps({"host": host}))
    print(json.dumps({"tools": tools}))
    print(json.dumps({"table_grad": table_grad}))
    print(json.dumps({"kernels": kernels}))
    print(gpu_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
