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
  5. timing — each kernel, its plain version and (compaction) the
              torch.nonzero + index_select yardstick with CUDA events; the
              512x512 render in ms per chunk and rays/s (median of 7
              images, each time listed), and a torch.profiler breakdown of
              one chunk (device busy and idle share, top kernels).
It prints a `kernels` JSON line, a `render` JSON line and the card's name
and power limit, and ends with one line
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


def time_ms(fn, reps, warmup=3):
    """Mean device time of fn() over reps calls (CUDA events)."""
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
    plain_ms = time_ms(lambda: plain(keys), 10)

    def library():
        idx = torch.nonzero(kept).squeeze(1)
        return idx, attrs.index_select(1, idx)

    library_ms = time_ms(library, 20)
    n_bytes = 4 * M + 4 + 4 * 2 * n_kept + 4 * 3 * m_pad
    bound_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    print(f"[compact] M={M} m_pad={m_pad} keep 0.25: kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, nonzero+index_select {library_ms:.4f} "
          f"ms, bound {bound_ms * 1e3:.2f} us ({n_bytes} bytes)")
    return dict(name="compact_attrs", route="cuda",
                source="raw_ngp_torch/csrc/compact.cu",
                replaces="raw_ngp_tpu/kernels/compact_pallas.py:118",
                max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by="bytes", library_ms=library_ms)


def phase_encode(dev, spec, B=262144):
    import torch
    from raw_ngp_torch.kernels.hash_encode import hash_encode
    from raw_ngp_torch.ops.hashgrid import _level_indices, hash_encode_01
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
    plain_ms = time_ms(
        lambda: hash_encode_01(table, x01, spec, compute_dtype=bf16), 10)
    # least traffic: the points, the table rows this input touches (once
    # each), the bf16 output; least work: one f32 multiply-add per corner
    # and channel
    res = [spec.resolutions[lv] for lv in range(L)]
    rows = 0
    inb = ((x01 >= 0) & (x01 <= 1)).all(-1)
    xin = x01[inb]
    for lv in range(L):
        pos = torch.clamp(xin * res[lv] - 0.5, 0.0, res[lv] - 1)
        g = torch.floor(pos).to(torch.int64)
        corners = torch.stack([torch.clamp_max(
            g + torch.tensor([(c >> d) & 1 for d in range(3)], device=dev),
            res[lv] - 1) for c in range(8)], dim=1)
        rows += int(torch.unique(_level_indices(spec, lv, corners)).numel())
    n_bytes = B * 3 * 4 + rows * C * 4 + B * L * C * 2
    n_ops = 2 * 8 * C * L * int(inb.sum())
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = n_ops / F32_FLOP_PER_S * 1e3
    print(f"[encode] B={B} L={L} C={C} bf16: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms; touched rows {rows}, {n_bytes} bytes "
          f"({bytes_ms * 1e3:.2f} us), {n_ops} flop ({ops_ms * 1e3:.2f} us)")
    return dict(name="hash_encode", route="cuda",
                source="raw_ngp_torch/csrc/hash_encode.cu",
                replaces="raw_ngp_tpu/kernels/hash_fused.py:497",
                max_abs_err=errs[bf16], max_abs_err_f32=errs[torch.float32],
                ms=ms, plain_ms=plain_ms, bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                library_ms=None)


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
    from raw_ngp_torch.kernels.compact import compact_attrs
    from raw_ngp_torch.kernels.hash_encode import hash_encode
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

    # the main path, with every launch counter reset just before it
    torch.cuda.synchronize()
    compact_attrs.launches = 0
    hash_encode.launches = 0
    rgb_s, d_s = render_image(field, bitfield, pose, intr_s, small, small,
                              aabb, device=dev)
    rgb_l, d_l = render_image(field, bitfield, pose, intr_l, large, large,
                              aabb, device=dev)
    torch.cuda.synchronize()
    launches = {"compact_attrs": compact_attrs.launches,
                "hash_encode": hash_encode.launches}
    print(f"[slice] launches on the main path: {launches}")
    for name, n in launches.items():
        check(n > 0, f"slice: kernel {name} was never launched")
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
    renders; the device kernels by total time and the device's busy share
    of the host-clock window."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from raw_ngp_torch.render.eval import make_eval_render
    render = make_eval_render(cfg)
    render(field, bitfield, ro, rd, aabb, coarse)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            render(field, bitfield, ro, rd, aabb, coarse)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    if busy_us <= 0:
        return {"device_time": "not measured (no device events)"}
    top = sorted(kernels, key=lambda e: e.self_device_time_total,
                 reverse=True)[:12]
    return {"chunks": reps, "wall_ms_per_chunk": wall_us / reps / 1e3,
            "device_busy_ms_per_chunk": busy_us / reps / 1e3,
            "device_idle_share": max(0.0, 1.0 - busy_us / wall_us),
            "kernel_launches_per_chunk": sum(e.count for e in kernels) / reps,
            "top_kernels": [{"name": e.key[:70], "calls": e.count // reps,
                             "ms_per_chunk":
                                 e.self_device_time_total / reps / 1e3}
                            for e in top]}


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
        k_encode = phase_encode(dev, make_field_spec(cfg).grid_spec)
        launches, render = phase_slice(dev, cfg)
    except Exception:  # every phase failure ends the run without a result
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    kernels = []
    for k in (k_compact, k_encode):
        k = dict(k)
        k["launches"] = launches[k["name"]]
        kernels.append(k)
    print(f"[done] {time.time() - t_start:.1f} s")
    print(json.dumps({"render": render}))
    print(json.dumps({"kernels": kernels}))
    print(gpu_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
