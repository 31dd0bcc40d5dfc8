#!/usr/bin/env python3
"""Design choices of the table gradient's radix sort on the card:
`raw_ngp_torch/csrc/radix_sort.cu` as committed against copies one choice
away from it, built beside it (one nvcc each, in parallel) and timed in
turns (committed, variants, committed) on uniform and run-shaped streams
at the path's sizes, each bit for bit torch.sort(stable=True):

    python3 port_tools/radix_sort_probe.py [--trace]

Variants: `tile4096` (256-thread blocks, 4,096-key tiles, two blocks an
SM) and `match_any` (the ranking's peer masks from __match_any_sync, not
from one ballot a digit bit). Each kernel's device time (torch.profiler)
and the call's CUDA-event time beside torch.sort's. With --trace, the
committed pass kernel with globaltimer stamps at its stages (ticket,
load and early counts, ranking, offsets and staging, look-back, write)
and the look-back's steps counted, per tile (thread 0), means printed.
Writes build/radix_sort_probe/ (listed in .gitignore); prints one
`radix_sort_probe` JSON line and the card's name and power limit."""
import ctypes
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

SOURCE = os.path.join(ROOT, "raw_ngp_torch", "csrc", "radix_sort.cu")
OUT = os.path.join(ROOT, "build", "radix_sort_probe")
CASES = ((262144, 13, "uniform"), (1 << 20, 19, "uniform"),
         (1 << 20, 19, "runs"), (4 << 20, 17, "uniform"),
         (8 << 20, 17, "uniform"))

BALLOTS = """    uint32_t same = __ballot_sync(kFull, w0 + it * 32 + lane < M);
#pragma unroll
    for (int b = 0; b < kMaxDigitBits; ++b) {
      if (b < width) {
        const uint32_t ones = __ballot_sync(kFull, (d >> b) & 1u);
        same &= (d >> b) & 1u ? ones : ~ones;
      }
    }
    peers[it] = same;"""
MATCH = """    peers[it] = __match_any_sync(
        kFull, w0 + it * 32 + lane < M ? d : kFull);"""


def variants(src):
    out = {"committed": src,
           "tile4096": src.replace("constexpr int kThreads = 512;",
                                   "constexpr int kThreads = 256;"),
           "match_any": src.replace(BALLOTS, MATCH)}
    for name, text in out.items():
        if name != "committed" and text == src:
            raise SystemExit(f"radix_sort_probe: variant {name} no longer "
                             "applies to the committed source")
    return out


def traced(src):
    """The committed source with globaltimer stamps a tile and the
    look-back's steps counted (thread 0)."""
    def stamp(k):
        return ("  if (threadIdx.x == 0) { unsigned long long t_; asm "
                "volatile(\"mov.u64 %0, %globaltimer;\" : \"=l\"(t_)); "
                f"g_trace[kFirst ? 0 : 1][tile_t][{k}] = t_; }}")
    marks = [("  const uint32_t tile = s_tile;", 1, True),
             ("  // stable rank of each key among the warp's keys", 2, False),
             ("  // per digit, the warps' counts to offsets in warp order", 3,
              False),
             ("  // look back over the tiles before this one", 4, False),
             ("  // publish the inclusive prefixes", 5, False)]
    for line, k, after in marks:
        if line not in src:
            raise SystemExit(f"radix_sort_probe: no `{line.strip()}` to "
                             "stamp")
        add = stamp(k) if k != 1 else (
            "  const uint32_t tile_t = s_tile < 4096 ? s_tile : 4095;\n"
            "  if (threadIdx.x == 0) g_trace[kFirst ? 0 : 1][tile_t][0] = "
            "t0_;\n" + stamp(1))
        src = src.replace(line, line + "\n" + add if after
                          else add + "\n" + line, 1)
    src = src.replace(
        "  const int lane = threadIdx.x & 31;\n  const int wid = threadIdx.x"
        " >> 5;\n  const int radix = 1 << width;",
        "  unsigned long long t0_; asm volatile(\"mov.u64 %0, %globaltimer;"
        "\" : \"=l\"(t0_));\n  const int lane = threadIdx.x & 31;\n  const "
        "int wid = threadIdx.x >> 5;\n  const int radix = 1 << width;", 1)
    src = src.replace(
        "  for (int64_t j = (int64_t)tile - 1; n_pending > 0; --j) {",
        "  int steps_ = 0;\n  for (int64_t j = (int64_t)tile - 1; "
        "n_pending > 0; --j) {\n    ++steps_;", 1)
    src = src.replace(
        "  // publish the inclusive prefixes",
        "  if (threadIdx.x == 0) g_trace[kFirst ? 0 : 1][tile_t][7] = "
        "steps_;\n  // publish the inclusive prefixes", 1)
    end = src.index("int g_hist_blocks[64]")
    body = src[:end].rstrip()
    close = body.rindex("}")
    src = (body[:close] + "  __syncthreads();\n" + stamp(6) + "\n}\n\n"
           + src[end:])
    src = src.replace("namespace {\n\nnamespace cg",
                      "namespace {\n__device__ unsigned long long "
                      "g_trace[2][4096][8];\nnamespace cg", 1)
    src += ("\nextern \"C\" int radix_trace(void* out) {\n  return (int)"
            "cudaMemcpyFromSymbol(out, g_trace, sizeof(g_trace));\n}\n")
    if src.count("g_trace[kFirst") != 8:
        raise SystemExit("radix_sort_probe: the trace stamps did not apply")
    return src


def build(sources):
    from raw_ngp_torch.kernels import _build
    os.makedirs(OUT, exist_ok=True)
    procs = {}
    for name, text in sources.items():
        path = os.path.join(OUT, f"{name}.cu")
        with open(path, "w") as f:
            f.write(text)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o",
             os.path.join(OUT, f"lib{name}.so"), path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"radix_sort_probe: {name} failed\n{log}")
        lib = ctypes.CDLL(os.path.join(OUT, f"lib{name}.so"))
        lib.radix_sort_layout.argtypes = [ctypes.c_int, ctypes.c_int,
                                          ctypes.c_void_p]
        lib.radix_sort_layout.restype = None
        lib.radix_sort.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                                   + [ctypes.c_void_p])
        lib.radix_sort.restype = ctypes.c_int
        libs[name] = (lib, [k for k in cs.ptxas_report(log)])
    return libs


def sorter(lib, keys, bits):
    import torch
    M = keys.numel()
    layout = (ctypes.c_int64 * 2)()
    lib.radix_sort_layout(M, bits, ctypes.addressof(layout))
    scratch = torch.empty(layout[0], dtype=torch.int32, device=keys.device)
    ks, perm = torch.empty_like(keys), torch.empty_like(keys)
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        err = lib.radix_sort(keys.data_ptr(), ks.data_ptr(), perm.data_ptr(),
                             scratch.data_ptr(), M, bits, 0, stream)
        if err:
            raise RuntimeError(f"radix_sort: error {err}")
        return ks, perm
    return run


def by_kernel(fn, reps=5):
    """Device ms a call of each kernel of fn (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            found = re.findall(r"([A-Za-z_]\w*(?:<[^()]*>)?)\(", e.key)
            name = found[0] if found else e.key[:60]
            out[name] = out.get(name, 0.0) + e.self_device_time_total \
                / reps / 1e3
    return out


def stream_keys(M, bits, kind, gen, dev):
    import torch
    if kind == "uniform":
        return torch.randint(0, 1 << bits, (M,), device=dev,
                             dtype=torch.int32, generator=gen)
    values = torch.randint(0, 1 << bits, (M // 10 + 1,), device=dev,
                           generator=gen)
    lengths = torch.randint(1, 41, (M // 10 + 1,), device=dev, generator=gen)
    return torch.repeat_interleave(values, lengths)[:M].to(torch.int32)


def main() -> int:
    import numpy as np
    import torch
    trace = "--trace" in sys.argv[1:]
    if not torch.cuda.is_available():
        print("radix_sort_probe: needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda:0")
    with open(SOURCE) as f:
        src = f.read()
    sources = variants(src)
    if trace:
        sources["trace"] = traced(src)
    libs = build(sources)
    gen = torch.Generator(device=dev).manual_seed(0)
    order = ["committed"] + [n for n in sources
                             if n not in ("committed", "trace")] + [
        "committed"]
    result = {"registers": {n: [(k["kernel"], k["registers"],
                                 k["spill_stores"]) for k in r]
                            for n, (_, r) in libs.items()}, "cases": []}
    for M, bits, kind in CASES:
        keys = stream_keys(M, bits, kind, gen, dev)
        ref = torch.sort(keys, stable=True)
        case = {"keys": M, "bits": bits, "kind": kind,
                "torch_sort_ms": cs.time_ms(
                    lambda: torch.sort(keys, stable=True), 20),
                "torch_sort_device_ms": by_kernel(
                    lambda: torch.sort(keys, stable=True)),
                "runs": []}
        for name in order:
            run = sorter(libs[name][0], keys, bits)
            ks, perm = run()
            torch.cuda.synchronize()
            if not (torch.equal(ks, ref.values)
                    and torch.equal(perm, ref.indices.to(torch.int32))):
                raise SystemExit(f"radix_sort_probe: {name} differs from "
                                 f"torch.sort at {M} keys, {bits} bits")
            case["runs"].append({"variant": name,
                                 "ms": cs.time_ms(run, 20),
                                 "device_ms": by_kernel(run)})
        if trace:
            lib = libs["trace"][0]
            sorter(lib, keys, bits)()
            torch.cuda.synchronize()
            buf = np.zeros((2, 4096, 8), np.uint64)
            lib.radix_trace.argtypes = [ctypes.c_void_p]
            if lib.radix_trace(buf.ctypes.data) != 0:
                raise SystemExit("radix_sort_probe: no trace")
            tiles = min(-(-M // 8192), 4096)
            names = ("ticket", "load_and_counts", "rank", "offsets_and_stage",
                     "look_back", "publish_and_write")
            case["trace"] = []
            for p in range(2):
                d = buf[p, :tiles].astype(np.int64)
                t = d[:, :7] - d[:, 0].min()
                stages = np.diff(t, axis=1).mean(0) / 1e3
                case["trace"].append({
                    "pass": p, "tiles": tiles,
                    "span_us": float(t[:, 6].max() / 1e3),
                    "tile_life_us": float((t[:, 6] - t[:, 0]).mean() / 1e3),
                    "stages_us": dict(zip(names, map(float, stages))),
                    "look_back_steps_mean": float(d[1:, 7].mean())
                    if tiles > 1 else 0.0})
        result["cases"].append(case)
        print(f"[radix_sort_probe] {json.dumps(case)}")
    result["gpu"] = cs.gpu_line()
    print(json.dumps({"radix_sort_probe": result}))
    print(result["gpu"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
