#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (raw_ngp_torch) on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --against TREE [TREE ...]
    python3 chip_smoke.py --deterministic-ops

Phases, each of which fails the run (non-zero exit, no result line):
  1. build  — compile every kernel of the path from raw_ngp_torch/csrc/
              (four sources) with nvcc for sm_90a (one nvcc per source, in
              parallel), print each kernel's registers, stack frame and
              spills (ptxas), and fail if an instantiation of the encode
              forward (with and without records) or input gradient, of
              B2's flat form (main pass, fix-up, join) or of the fold
              (phase 2), spills or keeps a stack frame;
  2. decimate — the render's budget decimation and compaction folded
              (decimate_compact: three launches forward, one backward;
              B1 and its backward redesigned) against its plain version
              (decimate_compact_plain and its autograd), bit for bit,
              forward and the gradients in ts, deltas and dt, two calls
              bitwise equal, at the train shape (8,192 rays x 64, m_pad
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
              beside them;
  6. encode_bwd — the encode forward's records mode (the window records
              written by the forward's launch) at uniform and ray-ordered
              points, f32 and bf16: records bit for bit
              window_records_plain, output bit for bit the forward
              without records, two calls the same bits, timed with and
              without records; the encode's table gradient (dense-level
              kernels: cell keys, torch.sort by cell, cell sums, edge
              fix-up, gather; torch.sort and B2's flat form reading g in
              place) on the kernel path against the plain path at B =
              262,144, uniform and ray-ordered points, f32 and bf16: the
              window rows within rtol 1e-5 of the largest entry, the dense
              rows by dense_rows_agree (rtol 1e-5 plus 2^-20 of the
              entry's absolute mass before rounding); then the table
              gradient and the dense level alone (two calls bitwise equal;
              its device time split into the keys, the sort and the
              passes; the sort alone on CUDA events; zero_ + index_add_ of
              its exact products as the library yardstick) timed;
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
              restored and 32 steps (two grid refreshes) run again, params,
              EMA and Adam moments bitwise equal to the first run's;
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
              gradient (torch.sort and B2's flat form; no dense level on
              these grids) against their plain versions on each of the
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
 13. timing — each kernel, its plain version and a PyTorch yardstick where
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
It prints `render`, `train`, `pose`, `lightstage`, `proposal` (the last
two with the card's name and power limit), `table_grad` and `kernels`
JSON lines (each kernel's `launches` are the proposal phase's,
`proposal_launched` says whether it ran there, the other phases' counts
ride beside them; the numbers of the proposal path's three kernels are
at its shapes, a step's or a serving chunk's calls summed, with the
flagship's under `flagship`) and the
card's name and power limit, and ends with one line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
The `kernels` line marks `deterministic: true` on each kernel whose two
calls on the same inputs gave the same bits.
It exits non-zero without a result when torch.cuda is not available, or
when the raw_ngp_torch package is not beside it.

With --against, it only builds and compares: each TREE's
raw_ngp_torch/csrc/hash_encode.cu (another version of this repository,
e.g. a git archive of a parent commit; the same C entry points) is built
beside this tree's, and the encode forward and input gradient of both run
on the phase-3 and phase-8 inputs through this tree's wrappers, outputs
compared and device times taken in turns (other, this, this, other); one
`ab` JSON line per TREE.

With --deterministic-ops, a diagnostic only: two train steps and two pose
steps of the flagship and two steps of the -O2 preset (4 cameras) under
torch.use_deterministic_algorithms(True, warn_only=True), printing each
warning PyTorch gives for an op on the path that has no deterministic
CUDA implementation; one `deterministic_ops` line.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
import traceback
from dataclasses import replace

# published peaks of one H100 SXM (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12


class PhaseError(RuntimeError):
    pass


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
# totals and the previous segment's G1; the second argument) and the
# fold's four kernels
REGISTER_CHECKED = {
    "hash_encode": ("hash_encode", ("hash_encode_kernel<",), (2, "false")),
    "hash_encode_records": ("hash_encode", ("hash_encode_kernel<",),
                            (2, "true")),
    "encode_input_grad": ("hash_encode", ("encode_input_grad_kernel",), None),
    "segment_grad_outer": ("segsum", ("segsum_outer_kernel<",
                                      "segsum_edge_fixup_kernel<",
                                      "segsum_flat_join_kernel"), (1, "true")),
    "decimate_compact": ("compact", ("decimate_count_kernel",
                                     "decimate_scan_kernel",
                                     "decimate_place_kernel"), None),
    "decimate_compact_bwd": ("compact", ("decimate_bwd_kernel",), None),
}


def checked_instantiations(ptxas, entry):
    """The ptxas reports of REGISTER_CHECKED[entry]."""
    source, prefixes, arg = REGISTER_CHECKED[entry]

    def wanted(name):
        if not name.startswith(prefixes):
            return False
        args = name.partition("<")[2].rstrip(">").split(", ")
        return arg is None or len(args) <= 1 or args[arg[0]] == arg[1]

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
        total, n_pts = int(outs[0][5]), int(outs[0][6])
        print(f"[decimate] {name}: N={N} K={K} m_pad={m_pad}, valid "
              f"{total}, stride {max(-(-total // m_pad), 1)}, filled "
              f"{n_pts}: forward and backward bit for bit the plain "
              f"version, two calls bitwise equal")

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
                counts.data_ptr(), scratch.data_ptr(), N, K, m_pad, stream)
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
    _, _, _, _, scratch = ck._decimate_forward(mask, miss, ts, deltas, m_pad)
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
                  bit_equal_to_totals_plus_combine=True,
                  reads_g_in_place="bf16, level 1's columns of [B, 2C]",
                  deterministic=True)
    return k_2c, k_flat


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


# the stages of mm_grad_table and of B2 by kernel name; every other
# launch of mm_grad_table is torch.sort's, every other one of B2 the
# wrapper's zero fill
DENSE_STAGES = (("cell_keys_kernel", "keys"),
                ("cell_sums_kernel", "cell_sums"),
                ("cell_edge_group_kernel", "group_sums"),
                ("cell_edge_fixup_kernel", "fixup"),
                ("cell_gather_kernel", "gather"))
SEGSUM_STAGES = (("segsum_outer_kernel", "main"),
                 ("segsum_edge_group_kernel", "group_sums"),
                 ("segsum_edge_fixup_kernel", "fixup"))
FLAT_STAGES = SEGSUM_STAGES + (("segsum_flat_join_kernel", "join"),)


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
    keys = (base[w0:w0 + nw].reshape(-1) - spec.offsets[lv]).contiguous()
    window_sort_ms = time_ms(lambda: torch.sort(keys, stable=True), 20)
    n_bytes = (B * 3 * 4 + B * spec.output_dim * 2
               + spec.n_params * spec.level_dim * 4)
    n_ops = 2 * 8 * spec.level_dim * spec.num_levels * B
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = n_ops / F32_FLOP_PER_S * 1e3
    print(f"[encode_bwd] B={B} bf16: table gradient {ms:.4f} ms "
          f"(device {dev_ms} ms, {prof.get('kernel_launches_per_call')} "
          f"device launches and {n_aten} aten ops a call), "
          f"plain {plain_ms:.4f} ms; "
          f"torch.sort of the level-{lv} keys ({keys.numel()}) "
          f"{window_sort_ms:.4f} "
          f"ms; {n_bytes} bytes ({bytes_ms * 1e3:.2f} us), {n_ops} flop "
          f"({ops_ms * 1e3:.2f} us)")
    print(f"[encode_bwd] profile of one call: {json.dumps(prof)}")
    # the dense level alone, on both inputs: two calls bitwise equal, then
    # its time, the device time of each stage (the keys, torch.sort's own
    # launches, the cell sums, the edge fix-up, the gather) and the sort
    # alone on CUDA events
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
        sort_ms = time_ms(lambda: torch.sort(keys, stable=True), 50)
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
                               mm_prof, DENSE_STAGES, "sort"),
                           sort_ms=sort_ms,
                           device_launches_per_call=mm_prof.get(
                               "kernel_launches_per_call"))
        print(f"[encode_bwd] dense level ({kind} points) bf16: two calls "
              f"bitwise equal; kernels {mm_ms:.4f} ms (device {mm_dev} ms, "
              f"{dense[kind]['device_launches_per_call']} device launches: "
              f"{json.dumps(dense[kind]['stages_device_ms'])}), torch.sort "
              f"alone {sort_ms:.4f} ms, plain (matmul) {mm_plain:.4f} ms, "
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
    # time measured alone on the same input: its stages share torch.sort's
    # kernels with the window levels' sort); its bound reads x01 and the
    # window levels' g and writes their rows
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
    torch.cuda.synchronize()
    chunk_err = {}
    for name, a, b in zip(("image", "depth", "weights_sum"), out_k, out_p):
        chunk_err[name] = float((a - b).abs().max())
    print(f"[slice] chunk kernel-vs-plain max abs err {chunk_err}")
    # bf16 encode outputs may round one ulp apart (f32 sum order), which
    # the bf16 MLPs carry to the colors and densities
    check(chunk_err["image"] <= 2e-2 and chunk_err["weights_sum"] <= 2e-2
          and chunk_err["depth"] <= 5e-2,
          f"slice: kernel path disagrees with the plain path {chunk_err}")

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


def _counters():
    from raw_ngp_torch.kernels.compact import (decimate_compact,
                                               decimate_compact_bwd)
    from raw_ngp_torch.kernels.hash_encode import (encode_input_grad,
                                                   hash_encode,
                                                   hash_encode_records,
                                                   mm_grad_table)
    from raw_ngp_torch.kernels.segsum import (segment_grad_outer,
                                              segment_totals,
                                              segment_totals_outer)
    return {"decimate_compact": decimate_compact,
            "decimate_compact_bwd": decimate_compact_bwd,
            "hash_encode": hash_encode,
            "hash_encode_records": hash_encode_records,
            "segment_grad_outer": segment_grad_outer,
            "segment_totals": segment_totals_outer,
            "encode_input_grad": encode_input_grad,
            "segment_totals_channel": segment_totals,
            "mm_grad_table": mm_grad_table}


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


def trainer_snapshot(tr):
    """Everything Trainer.step reads and changes, taken before a step: the
    training tensors and the grid state, the optimizers' counts, the step
    and host counters, the coarse cache and the generator's state."""
    st = tr.state
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
            "coarse": tr.scene_arrays.get("coarse_lin"),
            "generator": tr.generator.get_state()}


def trainer_restore(tr, snap):
    """Puts the Trainer back to `snap` (trainer_snapshot), in place."""
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
        setattr(st, k, v.clone())
    st.opt_state.count = snap["counts"][0]
    if st.pose_opt_state is not None:
        st.pose_opt_state.count = snap["counts"][1]
    st.step = snap["step"]
    (tr.host_step, tr.host_grid_updates, tr._pts_ema, tr._point_budget,
     tr.num_rays, tr._adapt_stash, tr._metrics, tr._train_step) = snap["host"]
    if snap["coarse"] is None:
        tr.scene_arrays.pop("coarse_lin", None)
    else:
        tr.scene_arrays["coarse_lin"] = snap["coarse"]
    tr.generator.set_state(snap["generator"])


def repro_check(tr, snap, ref, steps, what):
    """The repro check: the Trainer put back to `snap` (taken before step
    1), `steps` steps run again, and what they leave compared bit for bit
    with `ref`, captured after the same steps of the first run."""
    import torch
    trainer_restore(tr, snap)
    for _ in range(steps):
        tr.step()
    torch.cuda.synchronize()
    now = training_tensors(tr)
    diff = {k: float((now[k].double() - v.double()).abs().max())
            for k, v in ref.items() if not same_bits(now[k], v)}
    differ = f"; max abs diff {json.dumps(diff)}" if diff else ""
    print(f"[{what}] repro: {steps} steps ({tr.host_grid_updates} grid "
          f"refreshes) again from the state before step 1: "
          f"{len(ref) - len(diff)} of {len(ref)} tensors bitwise equal to "
          f"the first run's{differ}")
    check(not diff, f"{what}: training did not reproduce at a fixed seed")
    return {"steps": steps, "grid_refreshes": tr.host_grid_updates,
            "tensors": sorted(ref), "bitwise_equal": not diff}


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
                captured = training_tensors(tr)
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
    return launches, (first, last), step_ms, captured


def evaluate_counted(tr):
    """The val PSNR (EMA) and the encode launches of that evaluation."""
    from raw_ngp_torch.kernels.hash_encode import hash_encode
    before = hash_encode.launches
    psnr = tr.evaluate()["psnr"]
    return psnr, hash_encode.launches - before


def fixed_batch_check(tr, batch_fn, what, annealing=1.0, grad_tol=5e-2):
    """One step on a fixed batch (march jitter 0.5), kernel path against
    plain path: the same points, loss within 1e-2 relative and every
    gradient leaf (the pose refinements' too) within `grad_tol` of its
    largest entry. bf16 encode outputs may round one ulp apart between
    the kernel and the plain version (f32 sum order), which the bf16 MLPs
    and their bf16-rounded gradients carry into every leaf."""
    from raw_ngp_torch.train.trainer import make_batch_loss_fn
    loss_fn = make_batch_loss_fn(tr.cfg, tr.spec)
    leaves = dict(tr.field.named_parameters())
    if tr.state.pose_params is not None:
        leaves["pose"] = tr.state.pose_params
    out = {}
    for plain in (False, True):
        for p in leaves.values():
            p.grad = None
        batch = batch_fn()
        l, aux = loss_fn(tr.field, tr.state, batch, tr.aabb, None,
                         plain=plain, annealing=annealing)
        l.backward()
        out[plain] = (float(l.detach()), int(aux["num_points"]),
                      {k: p.grad.clone() for k, p in leaves.items()})
    for p in leaves.values():
        p.grad = None
    loss_err = abs(out[False][0] - out[True][0]) / abs(out[True][0])
    grad_err = {k: float((g - out[True][2][k]).abs().max()
                         / out[True][2][k].abs().max().clamp_min(1e-30))
                for k, g in out[False][2].items()}
    print(f"[{what}] fixed batch, kernel vs plain: loss {out[False][0]:.6f} "
          f"vs {out[True][0]:.6f} (rel {loss_err:.2e}), points "
          f"{out[False][1]} vs {out[True][1]}, grad max err / leaf max "
          f"{grad_err}")
    check(out[False][1] == out[True][1] and loss_err <= 1e-2
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
    tr = Trainer(cfg, train_s, val_s, device=dev)
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

    train = {"config": "flagship (with_preset_O + with_tpu_profile, fp16, "
                       "num_rays 8192)",
             "scene": "make_synthetic_scene(36, 2, 128, 128)",
             "steps": steps, "grid_refreshes": tr.host_grid_updates,
             "num_rays": tr.num_rays,
             "point_budget": tr._point_budget or tr.base_point_budget(),
             "ms_per_step": med, "rays_per_s": tr.num_rays / med * 1e3,
             "ms_per_step_runs": window, "val_psnr_ema": psnr,
             "loss_first8": first, "loss_last8": last,
             "fixed_batch_kernel_vs_plain": fixed,
             "stages_ms": step_breakdown(tr),
             "profile": profile_device(tr.step, 1, "step")}
    train["repro"] = repro_check(tr, snap, ref, repro, "train")
    return launches, train


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
    tr = Trainer(cfg, train_s, val_s, device=dev)
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
    out["repro"] = repro_check(tr, snap, ref, repro, "pose")
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
    tr = Trainer(cfg, train_s, val_s, device=dev)
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
    out["repro"] = repro_check(tr, snap, ref, repro, "lightstage")
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
    """The encode forward with records and the table gradient (torch.sort
    and B2's flat form, no dense level) held against their plain versions
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
        # key and int64 index written), which sort_bound_ms counts apart,
        # beside B2's own bound on the sorted streams
        b_bytes = (B * 12 + 8 * P * B + B * L * C * 2
                   + spec.n_params * C * 4)
        sort_bytes = 16 * P * B
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
                stages_device_ms=stage_split(b_prof, FLAT_STAGES, "sort"),
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


def proposal_kernel_rows(grids, serving):
    """The `kernels` line's numbers at the proposal path's shapes, a step's
    (or a serving chunk's) calls summed: the forward with records (3 a
    step), B2's flat form (26 a step) and the forward without records (3
    a chunk)."""
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
    return rows


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
    tr = Trainer(cfg, train_s, val_s, device=dev)
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
           "kernel_rows": proposal_kernel_rows(grids, serving),
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
    out["repro"] = repro_check(tr, snap, ref, repro, "proposal")
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"[proposal] phase took {out['phase_s']:.1f} s")
    return launches, out


def deterministic_ops(dev):
    """A diagnostic: two train steps and two pose steps of the flagship and
    two steps of the -O2 proposal path on 4 cameras under
    torch.use_deterministic_algorithms(True, warn_only=True) (the first
    occupancy step holds a grid refresh); the warnings PyTorch gives for
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
                      ("proposal", proposal_config())):
        tr = Trainer(cfg, train_s, val_s, device=dev)
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


def build_other(tree):
    """Build `tree`'s raw_ngp_torch/csrc/hash_encode.cu with this tree's
    nvcc flags into build/raw_ngp_torch/against/ and bind its forward and
    input-gradient entry points (the same C signatures as this tree's)."""
    import ctypes
    import hashlib
    from pathlib import Path
    from raw_ngp_torch.kernels import _build
    from raw_ngp_torch.kernels.hash_encode import _ARGTYPES
    src = Path(tree) / "raw_ngp_torch" / "csrc" / "hash_encode.cu"
    out_dir = _build.BUILD_DIR / "against"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib_path = out_dir / (f"libhash_encode-"
                          f"{hashlib.sha256(src.read_bytes()).hexdigest()[:12]}"
                          f".so")
    run = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o",
                          str(lib_path), str(src)], capture_output=True,
                         text=True)
    check(run.returncode == 0, f"against: {src} does not build\n"
                               f"{run.stdout}{run.stderr}")
    for k in ptxas_report(run.stdout + run.stderr):
        print(f"[against] {tree}: {k}")
    lib = ctypes.CDLL(str(lib_path))
    fns = {}
    for name in ("hash_encode_fwd", "hash_encode_bwd_input"):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = _ARGTYPES[name], ctypes.c_int
        fns[name] = fn
    return fns


def compare_encode(dev, cfg, tree, B=262144, reps=20):
    """Same-call A/B of the encode forward and input gradient: `tree`'s
    kernels (through this tree's wrappers) against this tree's on the same
    inputs as phase_encode / phase_encode_input, device time in turns
    other, this, this, other; outputs compared on the way."""
    import torch
    from raw_ngp_torch.kernels import hash_encode as th
    from raw_ngp_torch.models.ngp import make_field_spec
    spec = make_field_spec(cfg).grid_spec
    L, C = spec.num_levels, spec.level_dim
    other = build_other(tree)
    mine = th._lib

    def lib_of(which):
        return mine if which == "this" else (
            lambda name: other[name] if name in other else mine(name))

    gen = torch.Generator(device=dev).manual_seed(2)
    table = torch.rand(spec.n_params * C, generator=gen, device=dev) * 2 - 1
    inputs = encode_inputs(cfg, gen, dev, B)
    cot = torch.randn(B, L * C, generator=gen, device=dev)
    cases = []
    for kind, x01 in inputs.items():
        for dtype in (torch.bfloat16, torch.float32):
            cases.append((f"forward {kind} {str(dtype)[6:]}",
                          lambda x01=x01, dtype=dtype: th.hash_encode(
                              table, x01, spec, compute_dtype=dtype)))
    for kind in ("uniform", "ray"):
        for dtype in (torch.bfloat16, torch.float32):
            x01, g = inputs[kind], cot.to(dtype)
            cases.append((f"input_grad {kind} {str(dtype)[6:]}",
                          lambda x01=x01, g=g, dtype=dtype: (
                              th.encode_input_grad(table, x01, g, spec,
                                                   dtype))))
    result = {"against": str(tree)}
    try:
        for name, fn in cases:
            row = {}
            outs = {}
            for which in ("other", "this"):
                th._lib = lib_of(which)
                outs[which] = fn().float()
            torch.cuda.synchronize()
            row["max_abs_diff"] = float((outs["this"] - outs["other"]).abs()
                                        .max())
            for i, which in enumerate(("other", "this", "this", "other")):
                th._lib = lib_of(which)
                row[f"{which}_device_ms_{i}"] = device_ms(fn, reps)
                row[f"{which}_ms_{i}"] = time_ms(fn, 50)
            result[name] = row
            print(f"[against] {name}: {row}")
    finally:
        th._lib = mine
    return result


def main() -> int:
    import argparse
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument(
        "--against", metavar="TREE", nargs="+", default=(),
        help="only build and compare the encode forward and input gradient "
             "of each TREE's raw_ngp_torch/csrc/hash_encode.cu with this "
             "tree's, in one process (prints one `ab` line per TREE)")
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
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    t_start = time.time()
    if args.against:
        try:
            phase_build()
            for tree in args.against:
                print(json.dumps({"ab": compare_encode(
                    dev, flagship_config(), tree)}))
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
    try:
        ptxas = phase_build()
        check_registers(ptxas)
        k_decimate, k_decimate_bwd = phase_decimate(dev)
        from raw_ngp_torch.models.ngp import make_field_spec
        cfg = flagship_config()
        spec = make_field_spec(cfg).grid_spec
        k_encode = phase_encode(dev, cfg)
        k_segsum, k_flat = phase_segsum(dev)
        k_records, k_mm, table_grad = phase_encode_bwd(dev, spec)
        k_input = phase_encode_input(dev, cfg)
        k_channel = phase_segsum_channel(dev)
        render_launches, render = phase_slice(dev, cfg)
        train_launches, train = phase_train(dev, cfg)
        pose_launches, pose = phase_pose(dev)
        light_launches, lightstage = phase_lightstage(dev)
        launches, proposal = phase_proposal(dev)
    except Exception:  # every phase failure ends the run without a result
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    kernels = []
    for k in (k_decimate, k_decimate_bwd, k_encode, k_records, k_mm, k_input,
              k_flat, k_segsum, k_channel):
        k = dict(k)
        # this slice's main path is the proposal phase: its kernels' numbers
        # at its shapes, the earlier paths' beside them
        rows = proposal["kernel_rows"]
        if k["name"] in rows:
            keep = ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms", "library_device_ms", "max_abs_err")
            k["flagship"] = {key: k.get(key) for key in keep}
            k.update(rows[k["name"]])
        k["launches"] = launches[k["name"]]
        k["proposal_launched"] = launches[k["name"]] > 0
        k["launches_lightstage"] = light_launches[k["name"]]
        k["launches_pose"] = pose_launches[k["name"]]
        k["launches_train"] = train_launches[k["name"]]
        k["launches_render"] = render_launches.get(k["name"], 0)
        if k["name"] in ("hash_encode", "hash_encode_records"):
            k["launches_by_caller"] = {
                "proposal": launches["hash_encode_by_caller"],
                "lightstage": light_launches["hash_encode_by_caller"],
                "pose": pose_launches["hash_encode_by_caller"],
                "train": train_launches["hash_encode_by_caller"]}
        if k["name"] in REGISTER_CHECKED:
            k["ptxas"] = checked_instantiations(ptxas, k["name"])
        kernels.append(k)
    print(f"[done] {time.time() - t_start:.1f} s")
    print(json.dumps({"render": render}))
    print(json.dumps({"train": train}))
    print(json.dumps({"pose": pose}))
    print(json.dumps({"lightstage": lightstage}))
    print(json.dumps({"proposal": proposal}))
    print(json.dumps({"table_grad": table_grad}))
    print(json.dumps({"kernels": kernels}))
    print(gpu_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
