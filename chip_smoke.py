#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (raw_ngp_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):
  1. build  — compile every kernel of the path from raw_ngp_torch/csrc/
              with nvcc for sm_90a (one nvcc per source, in parallel);
  2. compact — the compaction kernel against its plain version at the
              render's shape (M = 1,048,576 records, m_pad = 262,144
              slots), keep rates 0.03 / 0.25 / 0.9 plus a full mask and an
              empty one: bit-exact;
  3. encode — the hash-encode kernel against its plain version at
              B = 262,144 points on the flagship grid (2 levels x 16
              channels, additive hash): f32 within atol 1e-6, bf16 within
              rtol 1e-2 (atol 1e-6);
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
  6. encode_bwd — the encode's table gradient (record kernel, torch.sort,
              B2, combine, dense-level matmul) on the kernel path against
              the plain path at B = 262,144, f32 and bf16, within rtol
              1e-5 of the largest entry;
  7. train  — the flagship Trainer on make_synthetic_scene(36, 2, 128,
              128) for 128 steps (8 grid refreshes) with every launch
              counter reset just before and read just after: all four
              kernels launched, finite losses that fall (last 8 below the
              first 8), finite params and EMA, the val PSNR (EMA), and one
              step on a fixed batch that agrees between the kernel path
              and the plain path;
  8. compact_bwd — kernel B1's backward against its plain version (zeros +
              index_copy_) at the train shape (M = 524,288, m_pad =
              262,144), keep rates 0.03 / 0.25 / 0.9, full and empty (0.9
              and full overflow the budget): bit-exact;
  9. encode_input — the encode's input gradient against its plain version
              at B = 262,144 on the flagship grid, f32 and bf16, within
              rtol 1e-5 of the largest entry;
 10. segsum_channel — B2's channel mode against segment_totals_plain at
              the level-1 shape (1,048,576 records into 524,288 rows, 32
              channels), random keys within rtol 1e-5 and a dense-skew
              stream within the bound of phase 5;
 11. pose   — pose refinement: the flagship with with_pose_opt("barf", 36),
              pose_opt.noise 0.05 and train.iters = 128 (so the annealing
              ramp and the pose freeze at int(0.33 * 128) fall inside)
              trained 128 steps by its Trainer, every launch counter reset
              just before and read just after: all six kernels of the path
              launched (compaction forward and backward, encode, records,
              B2, encode input gradient), finite losses that fall, finite
              params, EMA and pose params, nonzero pose params, the
              Procrustes pose errors before and after (printed, not
              gated), one fixed-batch step whose loss, net gradients and
              pose gradient agree between the kernel and the plain path;
 12. timing — each kernel, its plain version and a PyTorch yardstick where
              one exists (torch.nonzero + index_select for the
              compaction, index_copy_ for its backward, index_add_ for
              B2's two modes) with CUDA events; the 512x512 render in ms
              per chunk and rays/s (median of 7 images, each time listed);
              the train and pose steps in ms and rays/s (median of the
              last 32 steps, CUDA events, each listed) with their stages;
              a torch.profiler breakdown of one chunk and of one step of
              each (device busy and idle share, launches, top kernels).
It prints `render`, `train`, `pose` and `kernels` JSON lines and the card's
name and power limit, and ends with one line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
It exits non-zero without a result when torch.cuda is not available, or
when the raw_ngp_torch package is not beside it.
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


def phase_build():
    from raw_ngp_torch.kernels import _build
    t0 = time.time()
    reports = _build.build_all()
    for name, log in reports.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")
    print(f"[build] {sorted(_build.SOURCES)} ready in "
          f"{time.time() - t0:.1f} s")


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
        pos_p, att_p = plain(keys)
        torch.cuda.synchronize()
        check(torch.equal(pos_k, pos_p), f"compact {name}: pos differs")
        check(torch.equal(att_k.view(torch.int32), att_p.view(torch.int32)),
              f"compact {name}: attrs differ in their bits")
        n_kept = int(min(int(c[-1]), m_pad))
        print(f"[compact] {name}: kept {int(c[-1])}, filled {n_kept}/"
              f"{m_pad}: bit-exact")

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
                bound_ms=bound_ms, bound_by="bytes", library_ms=library_ms)


def phase_encode(dev, spec, B=262144):
    import torch
    from raw_ngp_torch.kernels.hash_encode import hash_encode
    from raw_ngp_torch.ops.hashgrid import hash_encode_01
    L, C = spec.num_levels, spec.level_dim
    gen = torch.Generator(device=dev).manual_seed(2)
    table = torch.rand(spec.n_params * C, generator=gen, device=dev) * 2 - 1
    x01 = torch.rand(B, 3, generator=gen, device=dev)
    # a few points outside [0, 1]^3 and NaN, which must encode to zeros
    x01[:64] = x01[:64] * 3.0 - 1.0
    x01[64:72, 1] = float("nan")
    errs = {}
    for dtype, tol in ((torch.float32, dict(rtol=0.0, atol=1e-6)),
                       (torch.bfloat16, dict(rtol=1e-2, atol=1e-6))):
        k = hash_encode(table, x01, spec, compute_dtype=dtype)
        p = hash_encode_01(table, x01, spec, compute_dtype=dtype)
        torch.cuda.synchronize()
        check(k.dtype == dtype and k.shape == (B, L * C),
              f"encode {dtype}: got {k.dtype} {tuple(k.shape)}")
        kf, pf = k.float(), p.float()
        err = float((kf - pf).abs().max())
        rel = float(((kf - pf).abs() / pf.abs().clamp_min(1e-30)).max())
        check(torch.allclose(kf, pf, **tol),
              f"encode {dtype}: max abs err {err} exceeds {tol}")
        errs[dtype] = err
        print(f"[encode] {str(dtype)[6:]}: max abs err {err:.3e}, max rel "
              f"err {rel:.3e} (tolerance {tol}): ok")

    bf16 = torch.bfloat16
    ms = time_ms(lambda: hash_encode(table, x01, spec, compute_dtype=bf16),
                 50)
    dev_ms = device_ms(lambda: hash_encode(table, x01, spec,
                                           compute_dtype=bf16))
    plain_ms = time_ms(
        lambda: hash_encode_01(table, x01, spec, compute_dtype=bf16), 10)
    # least traffic: the points, the table rows this input touches (once
    # each), the bf16 output; least work: one f32 multiply-add per corner
    # and channel
    rows, n_in = touched_rows(spec, x01)
    n_bytes = B * 3 * 4 + rows * C * 4 + B * L * C * 2
    n_ops = 2 * 8 * C * L * n_in
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = n_ops / F32_FLOP_PER_S * 1e3
    print(f"[encode] B={B} L={L} C={C} bf16: kernel {ms:.4f} ms (device "
          f"{dev_ms} ms), plain "
          f"{plain_ms:.4f} ms; touched rows {rows}, {n_bytes} bytes "
          f"({bytes_ms * 1e3:.2f} us), {n_ops} flop ({ops_ms * 1e3:.2f} us)")
    return dict(name="hash_encode", route="cuda",
                source="raw_ngp_torch/csrc/hash_encode.cu",
                replaces="raw_ngp_tpu/kernels/hash_fused.py:497",
                max_abs_err=errs[bf16], max_abs_err_f32=errs[torch.float32],
                ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                library_ms=None)


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
    errs = {}
    for skew, rtol in ((False, 1e-5), (True, 1e-5)):
        keys_s, perm, w_word, g_words = _outer_stream(dev, M, B, n_rows, C,
                                                      skew)
        k = ts.segment_totals_outer(keys_s, perm, w_word, g_words, n_rows, C)
        p = ts.segment_totals_outer_plain(keys_s, perm, w_word, g_words,
                                          n_rows, C)
        torch.cuda.synchronize()
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
        print(f"[segsum] M={M} rows={n_rows} C={C} skew={skew}: max abs err "
              f"{err:.3e} (rtol {rtol}, atol 1e-5"
              f"{', + 2^-20 x row absolute sum' if skew else ''}), "
              f"{int(empty.sum())} empty rows exactly 0: ok")

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
                library="index_add_ of the bf16-rounded products")


def phase_encode_bwd(dev, spec, B=262144):
    """The table gradient, kernel path against plain path, then its time
    in bf16 (the flagship's compute dtype) and that of its pieces."""
    import torch
    from raw_ngp_torch.kernels import hash_encode as th
    gen = torch.Generator(device=dev).manual_seed(4)
    table = (torch.rand(spec.n_params * spec.level_dim, generator=gen,
                        device=dev) * 2 - 1) * 1e-2
    x01 = torch.rand(B, 3, generator=gen, device=dev)
    x01[:64] = x01[:64] * 3.0 - 1.0
    cot = torch.randn(B, spec.output_dim, generator=gen, device=dev)
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        grads = []
        for fn in (th.hash_encode, th.hash_encode_plain):
            p = table.clone().requires_grad_()
            (fn(p, x01, spec, compute_dtype=dtype).float() * cot
             ).sum().backward()
            grads.append(p.grad)
        torch.cuda.synchronize()
        scale = float(grads[1].abs().max())
        err = float((grads[0] - grads[1]).abs().max())
        check(scale > 0 and torch.allclose(grads[0], grads[1], rtol=1e-5,
                                           atol=1e-6 * scale),
              f"encode_bwd {dtype}: max abs err {err} (scale {scale})")
        errs[dtype] = err
        print(f"[encode_bwd] {str(dtype)[6:]}: max abs err {err:.3e} of "
              f"largest {scale:.3e} (rtol 1e-5, atol 1e-6 x largest): ok")

    bf16 = torch.bfloat16
    g = cot.to(bf16)

    def kernel_path():
        base, w_word = th.window_records(x01, spec)
        return th.table_grad(spec, x01, base, w_word, g, bf16)

    def plain_path():
        base, w_word = th.window_records_plain(x01, spec)
        return th.table_grad(spec, x01, base, w_word, g, bf16, plain=True)

    ms = time_ms(kernel_path, 20)
    dev_ms = device_ms(kernel_path)
    plain_ms = time_ms(plain_path, 3)
    records_ms = time_ms(lambda: th.window_records(x01, spec), 20)
    base, _ = th.window_records(x01, spec)
    lv, w0, nw = th.level_windows(spec, th.matmul_split(spec))[-1]
    keys = (base[w0:w0 + nw].reshape(-1) - spec.offsets[lv]).contiguous()
    sort_ms = time_ms(lambda: torch.sort(keys, stable=True), 20)
    mm_ms = time_ms(lambda: th.mm_grad_table(x01, g, spec, bf16), 10)
    n_bytes = (B * 3 * 4 + B * spec.output_dim * 2
               + spec.n_params * spec.level_dim * 4)
    n_ops = 2 * 8 * spec.level_dim * spec.num_levels * B
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = n_ops / F32_FLOP_PER_S * 1e3
    print(f"[encode_bwd] B={B} bf16: records + table gradient {ms:.4f} ms "
          f"(device {dev_ms} ms), "
          f"plain {plain_ms:.4f} ms; records kernel {records_ms:.4f} ms, "
          f"torch.sort of the level-{lv} keys ({keys.numel()}) {sort_ms:.4f} "
          f"ms, dense-level matmul {mm_ms:.4f} ms; {n_bytes} bytes "
          f"({bytes_ms * 1e3:.2f} us), {n_ops} flop ({ops_ms * 1e3:.2f} us)")
    return dict(name="hash_encode_bwd", route="cuda",
                source="raw_ngp_torch/csrc/hash_encode.cu",
                replaces="raw_ngp_tpu/kernels/hash_fused.py:756",
                max_abs_err=errs[bf16], max_abs_err_f32=errs[torch.float32],
                ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                library_ms=None, records_ms=records_ms, sort_ms=sort_ms,
                mm_ms=mm_ms)


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
        p = ck.compact_attrs_bwd_plain(g, pos, M)
        torch.cuda.synchronize()
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
    n_bytes = 4 * M + 4 * 2 * M + 4 * 2 * n_kept
    bound_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    print(f"[compact_bwd] M={M} m_pad={m_pad} keep 0.25: kernel {ms:.4f} "
          f"ms (device {dev_ms} ms), plain {plain_ms:.4f} ms, "
          f"zero_ + index_copy_ "
          f"{library_ms:.4f} ms, bound {bound_ms * 1e3:.2f} us ({n_bytes} "
          f"bytes)")
    return dict(name="compact_attrs_bwd", route="cuda",
                source="raw_ngp_torch/csrc/compact.cu",
                replaces="raw_ngp_tpu/kernels/compact_pallas.py:224",
                max_abs_err=0.0, ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by="bytes", library_ms=library_ms,
                library="zero_ + index_copy_ at the filled pos")


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


def phase_encode_input(dev, spec, B=262144):
    """The encode's input gradient at the flagship shape: kernel against
    plain version in f32 and bf16, then timed in bf16."""
    import torch
    from raw_ngp_torch.kernels import hash_encode as th
    L, C = spec.num_levels, spec.level_dim
    gen = torch.Generator(device=dev).manual_seed(7)
    table = (torch.rand(spec.n_params * C, generator=gen, device=dev) * 2
             - 1) * 1e-2
    x01 = torch.rand(B, 3, generator=gen, device=dev)
    x01[:64] = x01[:64] * 3.0 - 1.0
    x01[64:72, 1] = float("nan")
    cot = torch.randn(B, L * C, generator=gen, device=dev)
    outside = ~((x01 >= 0) & (x01 <= 1)).all(-1)      # NaN rows too
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        g = cot.to(dtype)
        k = th.encode_input_grad(table, x01, g, spec, dtype)
        p = th.encode_input_grad_plain(table, x01, g, spec, dtype)
        torch.cuda.synchronize()
        scale = float(p.abs().max())
        err = float((k - p).abs().max())
        check(scale > 0 and bool((k[outside] == 0).all())
              and torch.allclose(k, p, rtol=1e-5, atol=1e-5 * scale),
              f"encode_input {dtype}: max abs err {err} (scale {scale})")
        errs[dtype] = err
        print(f"[encode_input] {str(dtype)[6:]}: max abs err {err:.3e} of "
              f"largest {scale:.3e} (rtol 1e-5 of the largest): ok")
    bf16 = torch.bfloat16
    g = cot.to(bf16)
    ms = time_ms(lambda: th.encode_input_grad(table, x01, g, spec, bf16), 50)
    dev_ms = device_ms(lambda: th.encode_input_grad(table, x01, g, spec,
                                                    bf16))
    plain_ms = time_ms(
        lambda: th.encode_input_grad_plain(table, x01, g, spec, bf16), 3)
    rows, n_in = touched_rows(spec, x01)
    n_bytes = B * 12 + rows * C * 4 + B * L * C * 2 + B * 12
    n_ops = 2 * 2 * 8 * C * L * n_in     # products and sums, 8 corners
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = n_ops / F32_FLOP_PER_S * 1e3
    print(f"[encode_input] B={B} bf16: kernel {ms:.4f} ms (device "
          f"{dev_ms} ms), plain "
          f"{plain_ms:.4f} ms; touched rows {rows}, {n_bytes} bytes "
          f"({bytes_ms * 1e3:.2f} us), {n_ops} flop ({ops_ms * 1e3:.2f} us)")
    return dict(name="encode_input_grad", route="cuda",
                source="raw_ngp_torch/csrc/hash_encode.cu",
                replaces="raw_ngp_tpu/kernels/hash_fused.py:760",
                max_abs_err=errs[bf16], max_abs_err_f32=errs[torch.float32],
                ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                library_ms=None)


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
        p = ts.segment_totals_plain(keys_s, packed, n_rows, n_chan)
        torch.cuda.synchronize()
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
              f"1e-5): ok")
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
                on_main_path=False)


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
    from raw_ngp_torch.kernels.hash_encode import (encode_input_grad,
                                                   hash_encode,
                                                   window_records)
    from raw_ngp_torch.kernels.segsum import (segment_totals,
                                              segment_totals_outer)
    return {"compact_attrs": compact_attrs, "hash_encode": hash_encode,
            "hash_encode_bwd": window_records,
            "segment_totals": segment_totals_outer,
            "compact_attrs_bwd": compact_attrs_bwd,
            "encode_input_grad": encode_input_grad,
            "segment_totals_channel": segment_totals}


# the kernels each path must launch
TRAIN_KERNELS = ("compact_attrs", "hash_encode", "hash_encode_bwd",
                 "segment_totals")
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


def run_steps(tr, steps, kernels, what):
    """`steps` Trainer steps with every launch counter reset just before
    and read just after; checks that each of `kernels` launched, that
    the losses are finite and fall (last 8 below the first 8) and that
    the params and EMA are finite. Returns (launches, losses, step ms)."""
    import torch
    counters = _counters()
    torch.cuda.synchronize()
    for c in counters.values():
        c.launches = 0
    events = [torch.cuda.Event(enable_timing=True) for _ in range(steps + 1)]
    losses = []
    t0 = time.perf_counter()
    for i in range(steps):
        events[i].record()
        losses.append(tr.step()["loss"])
    events[steps].record()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = {k: c.launches for k, c in counters.items()}
    print(f"[{what}] {steps} steps in {wall_s:.2f} s, "
          f"{tr.host_grid_updates} grid refreshes; launches {launches}")
    for name in kernels:
        check(launches[name] > 0, f"{what}: kernel {name} was never launched")
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
    return launches, (first, last), step_ms


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


def phase_train(dev, cfg, steps=128, timed=32):
    """The flagship Trainer through its entry points: `steps` steps with
    every launch counter reset just before and read just after, then the
    checks, the val PSNR, a fixed-batch kernel-vs-plain step and a
    profile of one step."""
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
    launches, (first, last), step_ms = run_steps(tr, steps, TRAIN_KERNELS,
                                                 "train")
    window = step_ms[-timed:]
    med = sorted(window)[timed // 2]
    psnr = tr.evaluate()["psnr"]
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
    return launches, train


def pose_config(steps):
    """The flagship with BARF refinement and the noise self-test; iters =
    `steps`, so the annealing ramp and the pose freeze fall in the run."""
    cfg = flagship_config().with_pose_opt("barf", 36)
    cfg = replace(cfg, train=replace(cfg.train, iters=steps),
                  pose_opt=replace(cfg.pose_opt, noise=0.05))
    return cfg.validate()


def phase_pose(dev, steps=128, timed=32):
    """Pose refinement through the Trainer's entry points: `steps` steps
    with every launch counter reset just before and read just after, the
    checks, the Procrustes pose errors before and after, a fixed-batch
    kernel-vs-plain step (pose gradient included) and a profile of one
    step."""
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
    launches, (first, last), step_ms = run_steps(tr, steps, POSE_KERNELS,
                                                 "pose")
    pose = tr.state.pose_params.detach()
    check(bool(torch.isfinite(pose).all()), "pose: pose params not finite")
    check(float(pose.abs().max()) > 0, "pose: the pose params never moved")
    err1 = analyze_pose_optimization(tr)
    print(f"[pose] pose errors after {steps} steps: {err1} (before {err0}); "
          f"largest refinement {float(pose.abs().max()):.3e}")
    window = step_ms[-timed:]
    med = sorted(window)[timed // 2]
    psnr = tr.evaluate()["psnr"]
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
    return launches, out


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


def main() -> int:
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
    try:
        phase_build()
        k_compact = phase_compact(dev)
        from raw_ngp_torch.models.ngp import make_field_spec
        cfg = flagship_config()
        spec = make_field_spec(cfg).grid_spec
        k_encode = phase_encode(dev, spec)
        k_segsum = phase_segsum(dev)
        k_bwd = phase_encode_bwd(dev, spec)
        k_compact_bwd = phase_compact_bwd(dev)
        k_input = phase_encode_input(dev, spec)
        k_channel = phase_segsum_channel(dev)
        render_launches, render = phase_slice(dev, cfg)
        train_launches, train = phase_train(dev, cfg)
        launches, pose = phase_pose(dev)
    except Exception:  # every phase failure ends the run without a result
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    kernels = []
    for k in (k_compact, k_compact_bwd, k_encode, k_bwd, k_input, k_segsum,
              k_channel):
        k = dict(k)
        # this slice's main path is the pose phase; the earlier paths'
        # counts ride beside it
        k["launches"] = launches[k["name"]]
        k["launches_train"] = train_launches[k["name"]]
        k["launches_render"] = render_launches.get(k["name"], 0)
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
