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
              forward or input gradient spills or keeps a stack frame;
  2. compact — the compaction kernel against its plain version at the
              render's shape (M = 1,048,576 records, m_pad = 262,144
              slots), keep rates 0.03 / 0.25 / 0.9 plus a full mask and an
              empty one: bit-exact;
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
              (one 16,384-ray chunk) and 512x512 (16 chunks), with both
              launch counters reset just before and read just after; the
              images must be finite and one chunk must agree with the same
              render on the plain path on the card;
  5. segsum — kernel B2 (sorted segment totals) against its plain version
              at the flagship's level-1 shape (1,048,576 records of
              262,144 points into 524,288 rows, 16 channels), random keys
              within rtol 1e-5, and a dense-skew stream within rtol 1e-5
              plus 2^-20 of each row's absolute sum (within_sum_error);
              two calls bitwise equal on each; both streams timed;
  6. encode_bwd — the encode's table gradient (dense-level kernels: cell
              keys, torch.sort by cell, cell sums, edge fix-up, gather;
              record kernel, g packing, torch.sort, B2, combine kernel) on
              the kernel path against the plain path at B = 262,144,
              uniform and ray-ordered points, f32 and bf16: the window
              rows within rtol 1e-5 of the largest entry, the dense rows
              by dense_rows_agree (rtol 1e-5 plus 2^-20 of the entry's
              absolute mass before rounding); then the whole path, the
              dense level alone (two calls bitwise equal; its device time
              split into the keys, the sort and the passes; the sort alone
              on CUDA events; zero_ + index_add_ of its exact products as
              the library yardstick) and the two glue kernels (bit-exact)
              timed;
  7. train  — the flagship Trainer on make_synthetic_scene(36, 2, 128,
              128) for 128 steps (8 grid refreshes) with every launch
              counter reset just before and read just after: all seven
              kernels launched (the dense-level kernel once a step), finite
              losses that fall (last 8 below the first 8), finite params
              and EMA, the val PSNR (EMA), one step on a fixed batch
              that agrees between the kernel path and the plain path, and
              the repro check: the Trainer's state from before step 1
              restored and 32 steps (two grid refreshes) run again, params,
              EMA and Adam moments bitwise equal to the first run's;
  8. compact_bwd — kernel B1's backward against its plain version (zeros +
              index_copy_) at the train shape (M = 524,288, m_pad =
              262,144), keep rates 0.03 / 0.25 / 0.9, full and empty (0.9
              and full overflow the budget): bit-exact; timed beside the
              device time of zero_ + index_copy_;
  9. encode_input — the encode's input gradient against its plain version
              at 262,144 uniform and ray-ordered points on the flagship
              grid, f32 and bf16, within rtol 1e-5 of the largest entry,
              0 outside [0, 1]^3, two calls bitwise equal; each timed;
 10. segsum_channel — B2's channel mode against segment_totals_plain at
              the level-1 shape (1,048,576 records into 524,288 rows, 32
              channels), random keys within rtol 1e-5 and a dense-skew
              stream within the bound of phase 5;
 11. pose   — pose refinement: the flagship with with_pose_opt("barf", 36),
              pose_opt.noise 0.05 and train.iters = 128 (so the annealing
              ramp and the pose freeze at int(0.33 * 128) fall inside)
              trained 128 steps by its Trainer, every launch counter reset
              just before and read just after: all nine kernels of the
              path launched (compaction forward and backward, encode,
              records, B2, the dense-level gradient once a step, g
              packing, combine, encode input gradient), finite losses that
              fall, finite params, EMA and pose params, nonzero pose
              params, the Procrustes pose errors before and after (printed, not
              gated), one fixed-batch step whose loss, net gradients and
              pose gradient agree between the kernel and the plain path,
              and the repro check of phase 7 (pose params and moments
              included);
 12. timing — each kernel, its plain version and a PyTorch yardstick where
              one exists (torch.nonzero + index_select for the
              compaction, index_copy_ for its backward, index_add_ for the
              dense-level gradient and for B2's two modes) with CUDA
              events and device times; the 512x512 render in ms
              per chunk and rays/s (median of 7 images, each time listed);
              the train and pose steps in ms and rays/s (median of the
              last 32 steps, CUDA events, each listed) with their stages;
              a torch.profiler breakdown of one chunk and of one step of
              each (device busy and idle share, launches, top kernels).
The train and pose phases also count the encode's launches by caller
(train forwards, grid refresh chunks, evaluation).
It prints `render`, `train`, `pose` and `kernels` JSON lines and the card's
name and power limit, and ends with one line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
The `kernels` line marks `deterministic: true` on each kernel whose two
calls on the same inputs gave the same bits.
It exits non-zero without a result when torch.cuda is not available, or
when the raw_ngp_torch package is not beside it.

With --against, it only builds and compares: each TREE's
raw_ngp_torch/csrc/hash_encode.cu (another version of this repository,
e.g. a git archive of a parent commit; the same C entry points) is built
beside this tree's, and the encode forward and input gradient of both run
on the phase-3 and phase-9 inputs through this tree's wrappers, outputs
compared and device times taken in turns (other, this, this, other); one
`ab` JSON line per TREE.

With --deterministic-ops, a diagnostic only: two train steps and two pose
steps of the flagship (4 cameras) under
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


def check_encode_registers(ptxas):
    """The encode's two gathers keep every channel quad, window and row in
    registers: no instantiation spills or keeps a stack frame."""
    for k in ptxas.get("hash_encode", ()):
        if k["kernel"].startswith(("hash_encode_kernel",
                                   "encode_input_grad_kernel")):
            check(k["spill_stores"] == 0 and k["spill_loads"] == 0
                  and k["stack_frame"] == 0,
                  f"build: {k['kernel']} spills or keeps a stack frame {k}")


def phase_compact(dev, M=1 << 20, m_pad=262144):
    import torch
    from raw_ngp_torch.kernels import compact as ck
    gen = torch.Generator(device=dev).manual_seed(1)
    attrs = torch.randn(2, M, generator=gen, device=dev)

    def inputs(mask):
        c = torch.cumsum(mask.to(torch.int32), 0, dtype=torch.int32)
        kept = mask & (c <= m_pad)
        keys = torch.where(kept, c - 1, ck.SENTINEL).to(torch.int32)
        return keys, c

    def plain(keys):
        _, _, pos = ck.compact_positions(keys < m_pad, m_pad)
        return pos, torch.stack([ck.gather_flat_sorted(a, pos)
                                 for a in attrs])

    cases = {f"keep {r}": torch.rand(M, generator=gen, device=dev) < r
             for r in (0.03, 0.25, 0.9)}
    cases["full"] = torch.ones(M, dtype=torch.bool, device=dev)
    cases["empty"] = torch.zeros(M, dtype=torch.bool, device=dev)
    for name, mask in cases.items():
        keys, c = inputs(mask)
        pos_k, att_k = ck.compact_attrs(attrs, keys, c, m_pad)
        pos_2, att_2 = ck.compact_attrs(attrs, keys, c, m_pad)
        pos_p, att_p = plain(keys)
        torch.cuda.synchronize()
        check(same_bits(pos_k, pos_2) and same_bits(att_k, att_2),
              f"compact {name}: two calls differ")
        check(torch.equal(pos_k, pos_p), f"compact {name}: pos differs")
        check(torch.equal(att_k.view(torch.int32), att_p.view(torch.int32)),
              f"compact {name}: attrs differ in their bits")
        n_kept = int(min(int(c[-1]), m_pad))
        print(f"[compact] {name}: kept {int(c[-1])}, filled {n_kept}/"
              f"{m_pad}: bit-exact, two calls bitwise equal")

    # timing at keep rate 0.25, the render's typical occupancy of the budget
    keys, c = inputs(cases["keep 0.25"])
    n_kept = int(min(int(c[-1]), m_pad))
    kept = keys < m_pad
    ms = time_ms(lambda: ck.compact_attrs(attrs, keys, c, m_pad), 50)
    dev_ms = device_ms(lambda: ck.compact_attrs(attrs, keys, c, m_pad))
    plain_ms = time_ms(lambda: plain(keys), 10)

    def library():
        idx = torch.nonzero(kept).squeeze(1)
        return idx, attrs.index_select(1, idx)

    library_ms = time_ms(library, 20)
    n_bytes = 4 * M + 4 + 4 * 2 * n_kept + 4 * 3 * m_pad
    bound_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    print(f"[compact] M={M} m_pad={m_pad} keep 0.25: kernel {ms:.4f} ms "
          f"(device {dev_ms} ms), "
          f"plain {plain_ms:.4f} ms, nonzero+index_select {library_ms:.4f} "
          f"ms, bound {bound_ms * 1e3:.2f} us ({n_bytes} bytes)")
    return dict(name="compact_attrs", route="cuda",
                source="raw_ngp_torch/csrc/compact.cu",
                replaces="raw_ngp_tpu/kernels/compact_pallas.py:118",
                max_abs_err=0.0, ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by="bytes", library_ms=library_ms,
                deterministic=True)


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
    per record, C g-channels per point."""
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
    g = torch.randn(B, C, generator=gen, device=dev)
    return (keys_s, perm.to(torch.int32), ts.pack_bf16_pairs([w[0], w[1]])[0],
            torch.stack(ts.pack_bf16_pairs(list(g.T)), dim=1).contiguous())


def phase_segsum(dev, M=1 << 20, B=1 << 18, n_rows=1 << 19, C=16):
    import torch
    from raw_ngp_torch.kernels import segsum as ts
    errs, skew_dev = {}, None
    for skew, rtol in ((False, 1e-5), (True, 1e-5)):
        keys_s, perm, w_word, g_words = _outer_stream(dev, M, B, n_rows, C,
                                                      skew)
        k = ts.segment_totals_outer(keys_s, perm, w_word, g_words, n_rows, C)
        k2 = ts.segment_totals_outer(keys_s, perm, w_word, g_words, n_rows,
                                     C)
        p = ts.segment_totals_outer_plain(keys_s, perm, w_word, g_words,
                                          n_rows, C)
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
            keys_s, perm, w_word, g_words, n_rows, C, out=k), 20, "call")
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

    keys_s, perm, w_word, g_words = _outer_stream(dev, M, B, n_rows, C,
                                                  False)
    out = torch.empty(n_rows, 2 * C, device=dev)
    ms = time_ms(lambda: ts.segment_totals_outer(
        keys_s, perm, w_word, g_words, n_rows, C, out=out), 50)
    dev_ms = device_ms(lambda: ts.segment_totals_outer(
        keys_s, perm, w_word, g_words, n_rows, C, out=out))
    plain_ms = time_ms(lambda: ts.segment_totals_outer_plain(
        keys_s, perm, w_word, g_words, n_rows, C, out=out), 5)
    prod = ts._outer_products(perm, w_word, g_words, C)
    keys64 = keys_s.long()
    library_ms = time_ms(lambda: out.zero_().index_add_(0, keys64, prod), 20)
    n_words = (C + 1) // 2
    rows_read = int(torch.unique(perm.long() % B).numel())
    n_bytes = 12 * M + 4 * n_words * rows_read + 4 * 2 * C * n_rows
    n_ops = 2 * 2 * C * M          # one multiply and one add per channel
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = n_ops / F32_FLOP_PER_S * 1e3
    print(f"[segsum] kernel {ms:.4f} ms (zero fill included; device "
          f"{dev_ms} ms), plain "
          f"{plain_ms:.4f} ms, index_add_ of the products {library_ms:.4f} "
          f"ms; {n_bytes} bytes ({bytes_ms * 1e3:.2f} us), {n_ops} flop "
          f"({ops_ms * 1e3:.2f} us)")
    return dict(name="segment_totals", route="cuda",
                source="raw_ngp_torch/csrc/segsum.cu",
                replaces="raw_ngp_tpu/kernels/segsum_pallas.py:124",
                max_abs_err=errs[False], max_abs_err_skew=errs[True], ms=ms,
                device_ms=dev_ms, plain_ms=plain_ms,
                bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                library_ms=library_ms,
                library="index_add_ of the bf16-rounded products",
                skew_device_ms=skew_dev, deterministic=True)


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
    """The table gradient, kernel path against plain path (uniform and
    ray-ordered points, f32 and bf16), then its time in bf16 (the
    flagship's compute dtype), that of its pieces, and the three kernels
    of the table gradient on their own: the dense level's scatter (with
    index_add_ of its exact products as the library yardstick), the
    packing of g and the combine."""
    import torch
    from raw_ngp_torch.kernels import hash_encode as th
    gen = torch.Generator(device=dev).manual_seed(4)
    table = (torch.rand(spec.n_params * spec.level_dim, generator=gen,
                        device=dev) * 2 - 1) * 1e-2
    inputs = {"uniform": torch.rand(B, 3, generator=gen, device=dev),
              "ray": ray_points(B, gen, dev)}
    inputs["uniform"][:64] = inputs["uniform"][:64] * 3.0 - 1.0
    cot = torch.randn(B, spec.output_dim, generator=gen, device=dev)
    res, C = spec.resolutions[0], spec.level_dim
    n_dense = spec.offsets[th.matmul_split(spec)] * C
    check(n_dense == spec.offsets[1] * C, "encode_bwd: the flagship grid "
          "should have one dense level")
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

    def kernel_path():
        base, w_word = th.window_records(x01, spec)
        return th.table_grad(spec, x01, base, w_word, g, bf16)

    def plain_path():
        base, w_word = th.window_records_plain(x01, spec)
        return th.table_grad(spec, x01, base, w_word, g, bf16, plain=True)

    check(same_bits(kernel_path(), kernel_path()),
          "encode_bwd: two calls of the table gradient differ")
    ms = time_ms(kernel_path, 20)
    prof = profile_device(kernel_path, 20, "call")
    dev_ms = prof.get("device_busy_ms_per_call")
    plain_ms = time_ms(plain_path, 3)
    n_aten = aten_ops(kernel_path)
    records_ms = time_ms(lambda: th.window_records(x01, spec), 20)
    base, _ = th.window_records(x01, spec)
    lv, w0, nw = th.level_windows(spec, th.matmul_split(spec))[-1]
    keys = (base[w0:w0 + nw].reshape(-1) - spec.offsets[lv]).contiguous()
    window_sort_ms = time_ms(lambda: torch.sort(keys, stable=True), 20)
    n_bytes = (B * 3 * 4 + B * spec.output_dim * 2
               + spec.n_params * spec.level_dim * 4)
    n_ops = 2 * 8 * spec.level_dim * spec.num_levels * B
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = n_ops / F32_FLOP_PER_S * 1e3
    print(f"[encode_bwd] B={B} bf16: records + table gradient {ms:.4f} ms "
          f"(device {dev_ms} ms, {prof.get('kernel_launches_per_call')} "
          f"device launches and {n_aten} aten ops a call), "
          f"plain {plain_ms:.4f} ms; records kernel {records_ms:.4f} ms, "
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
    m = th.matmul_split(spec)
    window_dev = (None if dev_ms is None or dense["uniform"]["device_ms"]
                  is None else dev_ms - dense["uniform"]["device_ms"])
    window_bound = (B * 12 + B * (spec.num_levels - m) * C * 2
                    + (spec.n_params - spec.offsets[m]) * C * 4
                    ) / HBM_BYTES_PER_S * 1e3
    print(f"[encode_bwd] window levels' part: device {window_dev} ms, bound "
          f"{window_bound * 1e3:.2f} us (bytes)")
    whole = dict(name="hash_encode_bwd", route="cuda",
                 source="raw_ngp_torch/csrc/hash_encode.cu",
                 replaces="raw_ngp_tpu/kernels/hash_fused.py:756",
                 max_abs_err=max(errs[("uniform", bf16)]),
                 max_abs_err_f32=max(errs[("uniform", torch.float32)]),
                 ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                 bound_ms=max(bytes_ms, ops_ms),
                 bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                 library_ms=None, records_ms=records_ms,
                 sort_ms=window_sort_ms,
                 device_launches_per_call=prof.get(
                     "kernel_launches_per_call"),
                 aten_ops_per_call=n_aten,
                 window_part_device_ms=window_dev,
                 window_part_bound_ms=window_bound,
                 top_kernels=prof.get("top_kernels"), deterministic=True)

    # the glue kernels at the flagship's shapes, against their plain versions
    words = th.pack_g_words(g, spec)
    check(torch.equal(words, th.pack_g_words_plain(g, spec))
          and same_bits(words, th.pack_g_words(g, spec)),
          "pack_g_words: words differ from the plain version or between "
          "two calls")
    R = spec.n_params - spec.offsets[th.matmul_split(spec)]
    totals = torch.randn(R, 2 * C, generator=gen, device=dev)
    comb = torch.empty(R * C, device=dev)
    th.combine_totals(totals, comb)
    comb_2 = th.combine_totals(totals, torch.empty_like(comb))
    comb_p = th.combine_totals_plain(totals, torch.empty_like(comb))
    torch.cuda.synchronize()
    check(same_bits(comb, comb_p) and same_bits(comb, comb_2),
          "combine_totals: differs from the plain version in its bits or "
          "between two calls")
    glue = []
    n_words = words.numel()
    for name, src, fn, plain_fn, nb in (
            ("pack_g_words", "raw_ngp_tpu/kernels/hash_fused.py:666",
             lambda: th.pack_g_words(g, spec),
             lambda: th.pack_g_words_plain(g, spec),
             B * (spec.num_levels - th.matmul_split(spec)) * C * 2
             + 4 * n_words),
            ("combine_totals", "raw_ngp_tpu/kernels/hash_fused.py:686",
             lambda: th.combine_totals(totals, comb),
             lambda: th.combine_totals_plain(totals, comb),
             R * 2 * C * 4 + R * C * 4)):
        k_ms, k_dev = time_ms(fn, 50), device_ms(fn)
        p_ms = time_ms(plain_fn, 10)
        b_ms = nb / HBM_BYTES_PER_S * 1e3
        print(f"[encode_bwd] {name}: kernel {k_ms:.4f} ms (device {k_dev} "
              f"ms), plain {p_ms:.4f} ms, bit-exact; {nb} bytes "
              f"({b_ms * 1e3:.2f} us)")
        glue.append(dict(name=name, route="cuda",
                         source="raw_ngp_torch/csrc/hash_grad.cu",
                         replaces=src, max_abs_err=0.0, ms=k_ms,
                         device_ms=k_dev, plain_ms=p_ms, bound_ms=b_ms,
                         bound_by="bytes", library_ms=None,
                         deterministic=True))
    return [whole, mm_k] + glue


def aten_ops(fn):
    """The aten operators one call of fn dispatches (torch.profiler, CPU
    activity): the host-side count that launches follow."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return sum(e.count for e in prof.key_averages()
               if e.key.startswith("aten::"))


def phase_compact_bwd(dev, M=1 << 19, m_pad=262144):
    """B1's backward at the train shape: kernel against plain version,
    bit-exact, then timed at keep rate 0.25."""
    import torch
    from raw_ngp_torch.kernels import compact as ck
    gen = torch.Generator(device=dev).manual_seed(6)
    g = torch.randn(2, m_pad, generator=gen, device=dev)

    def inputs(mask):
        c = torch.cumsum(mask.to(torch.int32), 0, dtype=torch.int32)
        keys = torch.where(mask & (c <= m_pad), c - 1,
                           ck.SENTINEL).to(torch.int32)
        pos, _ = ck.compact_attrs(torch.zeros(2, M, device=dev), keys, c,
                                  m_pad)
        return keys, pos, c

    cases = {f"keep {r}": torch.rand(M, generator=gen, device=dev) < r
             for r in (0.03, 0.25, 0.9)}
    cases["full"] = torch.ones(M, dtype=torch.bool, device=dev)
    cases["empty"] = torch.zeros(M, dtype=torch.bool, device=dev)
    for name, mask in cases.items():
        keys, pos, c = inputs(mask)
        k = ck.compact_attrs_bwd(g, keys, pos, m_pad)
        k2 = ck.compact_attrs_bwd(g, keys, pos, m_pad)
        p = ck.compact_attrs_bwd_plain(g, pos, M)
        torch.cuda.synchronize()
        check(same_bits(k, k2), f"compact_bwd {name}: two calls differ")
        check(torch.equal(k.view(torch.int32), p.view(torch.int32)),
              f"compact_bwd {name}: gradients differ in their bits")
        print(f"[compact_bwd] {name}: kept {int(c[-1])} of {M}, slots "
              f"{m_pad}: bit-exact")

    keys, pos, c = inputs(cases["keep 0.25"])
    n_kept = int(min(int(c[-1]), m_pad))
    ms = time_ms(lambda: ck.compact_attrs_bwd(g, keys, pos, m_pad), 50)
    dev_ms = device_ms(lambda: ck.compact_attrs_bwd(g, keys, pos, m_pad))
    plain_ms = time_ms(lambda: ck.compact_attrs_bwd_plain(g, pos, M), 20)
    filled = torch.nonzero(pos < M).squeeze(1)
    dest, g_kept = pos[filled].long(), g[:, filled].contiguous()
    out = torch.empty(2, M, device=dev)
    library_ms = time_ms(lambda: out.zero_().index_copy_(1, dest, g_kept),
                         20)
    library_dev = device_ms(lambda: out.zero_().index_copy_(1, dest, g_kept))
    n_bytes = 4 * M + 4 * 2 * M + 4 * 2 * n_kept
    bound_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    print(f"[compact_bwd] M={M} m_pad={m_pad} keep 0.25: kernel {ms:.4f} "
          f"ms (device {dev_ms} ms), plain {plain_ms:.4f} ms, "
          f"zero_ + index_copy_ "
          f"{library_ms:.4f} ms (device {library_dev} ms), bound "
          f"{bound_ms * 1e3:.2f} us ({n_bytes} "
          f"bytes)")
    return dict(name="compact_attrs_bwd", route="cuda",
                source="raw_ngp_torch/csrc/compact.cu",
                replaces="raw_ngp_tpu/kernels/compact_pallas.py:224",
                max_abs_err=0.0, ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by="bytes", library_ms=library_ms,
                library_device_ms=library_dev,
                library="zero_ + index_copy_ at the filled pos",
                deterministic=True)


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
    for name in ("compact_attrs", "hash_encode"):
        check(launches[name] > 0, f"slice: kernel {name} was never launched")
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


def profile_device(fn, reps, unit):
    """torch.profiler over `reps` calls of fn (after one warm-up call): the
    device kernels by total time and the device's busy share of the
    host-clock window, per `unit`."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    if busy_us <= 0:
        return {"device_time": "not measured (no device events)"}
    top = sorted(kernels, key=lambda e: e.self_device_time_total,
                 reverse=True)[:12]
    return {f"{unit}s": reps, f"wall_ms_per_{unit}": wall_us / reps / 1e3,
            f"device_busy_ms_per_{unit}": busy_us / reps / 1e3,
            "device_idle_share": max(0.0, 1.0 - busy_us / wall_us),
            f"kernel_launches_per_{unit}":
                sum(e.count for e in kernels) / reps,
            "top_kernels": [{"name": e.key[:70], "calls": e.count // reps,
                             f"ms_per_{unit}":
                                 e.self_device_time_total / reps / 1e3}
                            for e in top]}


def _counters():
    from raw_ngp_torch.kernels.compact import compact_attrs, compact_attrs_bwd
    from raw_ngp_torch.kernels.hash_encode import (combine_totals,
                                                   encode_input_grad,
                                                   hash_encode, mm_grad_table,
                                                   pack_g_words,
                                                   window_records)
    from raw_ngp_torch.kernels.segsum import (segment_totals,
                                              segment_totals_outer)
    return {"compact_attrs": compact_attrs, "hash_encode": hash_encode,
            "hash_encode_bwd": window_records,
            "segment_totals": segment_totals_outer,
            "compact_attrs_bwd": compact_attrs_bwd,
            "encode_input_grad": encode_input_grad,
            "segment_totals_channel": segment_totals,
            "mm_grad_table": mm_grad_table, "pack_g_words": pack_g_words,
            "combine_totals": combine_totals}


# the kernels each path must launch
TRAIN_KERNELS = ("compact_attrs", "hash_encode", "hash_encode_bwd",
                 "segment_totals", "mm_grad_table", "pack_g_words",
                 "combine_totals")
POSE_KERNELS = TRAIN_KERNELS + ("compact_attrs_bwd", "encode_input_grad")


def step_breakdown(tr, reps=5):
    """Where a train step's time goes: the stages of Trainer.step run one
    by one, each ended by a synchronize, on the host clock (median of
    `reps` steps, ms), plus one grid refresh and coarse-volume rebuild
    (every update_extra_interval steps) on its own. Under pose refinement
    the sample stage composes the noise and refinements, and the pose
    optimizer is a stage of its own."""
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
            se3_refine=pose, pose_noise=st.pose_noise))
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
            "grid": {k: v.clone() for k, v in st.grid_state().items()},
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


def run_steps(tr, steps, kernels, what, capture_at=None):
    """`steps` Trainer steps with every launch counter reset just before
    and read just after; checks that each of `kernels` launched, that
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
    budget = tr._point_budget or tr.base_point_budget()
    by_caller = {
        "train_forwards": launches["hash_encode"] - refresh["encode_launches"],
        "train_forward_points": budget,
        "refresh_chunks": refresh["encode_launches"],
        "refresh_chunk_points": _CHUNK, "refreshes": refresh["calls"]}
    print(f"[{what}] {steps} steps in {wall_s:.2f} s, "
          f"{tr.host_grid_updates} grid refreshes; launches {launches}; "
          f"encode launches by caller {by_caller}")
    launches["hash_encode_by_caller"] = by_caller
    for name in kernels:
        check(launches[name] > 0, f"{what}: kernel {name} was never launched")
    # one backward a step, one dense level on the flagship grid
    check(launches["mm_grad_table"] == steps,
          f"{what}: the dense-level kernel launched "
          f"{launches['mm_grad_table']} times in {steps} steps")
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


def deterministic_ops(dev):
    """A diagnostic: two train steps and two pose steps of the flagship on
    4 cameras under torch.use_deterministic_algorithms(True, warn_only=True)
    (the first step holds a grid refresh); the warnings PyTorch gives for
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
                      ("pose", pose_config(128, n_cameras=4))):
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
        check_encode_registers(ptxas)
        k_compact = phase_compact(dev)
        from raw_ngp_torch.models.ngp import make_field_spec
        cfg = flagship_config()
        spec = make_field_spec(cfg).grid_spec
        k_encode = phase_encode(dev, cfg)
        k_segsum = phase_segsum(dev)
        k_bwd, k_mm, k_pack, k_comb = phase_encode_bwd(dev, spec)
        k_compact_bwd = phase_compact_bwd(dev)
        k_input = phase_encode_input(dev, cfg)
        k_channel = phase_segsum_channel(dev)
        render_launches, render = phase_slice(dev, cfg)
        train_launches, train = phase_train(dev, cfg)
        launches, pose = phase_pose(dev)
    except Exception:  # every phase failure ends the run without a result
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    kernels = []
    for k in (k_compact, k_compact_bwd, k_encode, k_bwd, k_mm, k_pack, k_comb,
              k_input, k_segsum, k_channel):
        k = dict(k)
        # this slice's main path is the pose phase; the earlier paths'
        # counts ride beside it
        k["launches"] = launches[k["name"]]
        k["launches_train"] = train_launches[k["name"]]
        k["launches_render"] = render_launches.get(k["name"], 0)
        if k["name"] == "hash_encode":
            k["launches_by_caller"] = {
                "pose": launches["hash_encode_by_caller"],
                "train": train_launches["hash_encode_by_caller"]}
        kernel_fn = {"hash_encode": "hash_encode_kernel",
                     "encode_input_grad": "encode_input_grad_kernel"}.get(
                         k["name"])
        if kernel_fn:
            k["ptxas"] = [p for p in ptxas.get("hash_encode", ())
                          if p["kernel"].startswith(kernel_fn)]
        kernels.append(k)
    print(f"[done] {time.time() - t_start:.1f} s")
    print(json.dumps({"render": render}))
    print(json.dumps({"train": train}))
    print(json.dumps({"pose": pose}))
    print(json.dumps({"kernels": kernels}))
    print(gpu_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
