#!/usr/bin/env python3
"""B2's flat form (`segment_grad_outer`) on a training step's own streams,
this tree's kernel beside another tree's, built from that tree's
`raw_ngp_torch/csrc/segsum.cu` and `segments.cuh` and timed in the same
process (the other, this, this, the other):

    python3 port_tools/segsum_probe.py --extract REV DIR   # needs git
    python3 port_tools/segsum_probe.py [--parent DIR [--parent-only]]
        [shapes O2 O ...]

`--extract` writes REV's two sources into DIR (the card's machine has no
git: extract before the call, into a directory the copy keeps). The run
prints first each tree's B2 kernels: registers, static shared memory and
theoretical occupancy (ptxas and the block size, by H100's limits). Then
per preset one JSON line: `shapes`, one a stream of chip_smoke.py's
NARROW_STREAMS and the flagship's level 1, random keys and skew; `O2` and
`O`, every B2 call of one loss and backward of the preset's Trainer on a
seeded batch (`chip_smoke.proposal_config()`, `o_config()`). Each line:
the streams' shapes (records, rows, C, chunks, segments, the longest row,
the chunk edges a row crosses) and `chip_smoke.b2_step`'s reading: B2's
device time by stage (zero fill, main pass, group sums, fix-up, join) for
this tree and the parent, CUDA events, the bound, the library yardstick
(`zero_` + `index_add_` of each call's bf16-rounded products into rows k
and k + 1); the parent's bits are checked against this tree's. With
`--parent-only` the parent is timed alone and this tree only built.
Writes build/segsum_trees/ (listed in .gitignore); ends with the card's
name and power limit."""
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

# threads a block of each B2 kernel, by kernel name prefix
BLOCK_THREADS = {"segsum_flat_walk_kernel": 128}
DEFAULT_THREADS = 256
FLAGSHIP = (16, 1 << 20, 1 << 18, 1 << 19, "the flagship's level 1")


def extract(rev, dest):
    """REV's segsum.cu and segments.cuh (git show) into dest."""
    os.makedirs(dest, exist_ok=True)
    for name in cs.SEGSUM_FILES:
        text = subprocess.run(
            ["git", "-C", ROOT, "show", f"{rev}:raw_ngp_torch/csrc/{name}"],
            check=True, capture_output=True, text=True).stdout
        with open(os.path.join(dest, name), "w") as f:
            f.write(text)


def kernel_resources(log):
    """{kernel: registers, static shared memory, block threads and the
    theoretical occupancy (resident warps of an SM's 64)} of a ptxas
    log, by H100's limits: 65,536 registers an SM (256 a warp at a time),
    228 KB of shared memory (1 KB a block reserved), 32 blocks, 64 warps."""
    out, entry = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry = cs._kernel_name(m.group(1))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and entry:
            regs = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            smem = int(sm.group(1)) if sm else 0
            threads = next((t for p, t in BLOCK_THREADS.items()
                            if entry.startswith(p)), DEFAULT_THREADS)
            warps = threads // 32
            reg_warps = 65536 // (-(-regs * 32 // 256) * 256)
            by_regs = reg_warps // warps
            by_smem = (228 * 1024) // (smem + 1024) if smem else 32
            blocks = min(by_regs, by_smem, 32, 64 // warps)
            out[entry] = dict(registers=regs, smem_bytes=smem,
                              block_threads=threads,
                              resident_warps=blocks * warps,
                              theoretical_occupancy=blocks * warps / 64)
            entry = None
    return out


def stream_shape(c):
    """Records, rows, chunks, segments, the longest row and the rows that
    cross a 128-record chunk edge of one captured call."""
    import torch
    k = c["keys"]
    M = k.numel()
    _, counts = torch.unique_consecutive(k, return_counts=True)
    n_chunks = -(-M // 128)
    edges = torch.arange(1, n_chunks, device=k.device) * 128
    crossing = int((k[edges] == k[edges - 1]).sum()) if n_chunks > 1 else 0
    return dict(records=M, rows=c["n_rows"], C=c["C"], chunks=n_chunks,
                segments=int(counts.numel()),
                longest_row=int(counts.max()) if M else 0,
                chunk_edges_crossed=crossing, points=int(c["g"].shape[0]))


def preset_calls(preset, call):
    """Every B2 call (capture_b2, computed by `call`) of one loss and
    backward of the preset's Trainer on a seeded batch."""
    import torch
    from raw_ngp_torch.data import make_synthetic_scene
    from raw_ngp_torch.data.sampler import sample_ray_batch
    from raw_ngp_torch.train.trainer import Trainer, make_batch_loss_fn
    dev = torch.device("cuda")
    cfg = {"O2": cs.proposal_config, "O": cs.o_config}[preset]()
    train_s, val_s = make_synthetic_scene(n_train=36, n_val=2, H=128, W=128)
    tr = Trainer(cfg, train_s, val_s, device=dev,
                 workspace=cs.scratch_workspace())
    gen = torch.Generator(device=dev).manual_seed(9)
    sa = tr.scene_arrays
    batch = sample_ray_batch(gen, sa["images"], sa["poses"],
                             sa["intrinsics"], tr.num_rays)
    loss_fn = make_batch_loss_fn(tr.cfg, tr.spec)

    def run():
        loss, _ = loss_fn(tr.field, tr.state, batch, tr.aabb, None)
        loss.backward()
        for p in tr.field.parameters():
            p.grad = None

    return cs.capture_b2(run, call)


def main() -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("presets", nargs="*", default=["O2", "O"],
                    help="shapes, O2, O (default: O2 O)")
    ap.add_argument("--extract", nargs=2, metavar=("REV", "DIR"))
    ap.add_argument("--parent", metavar="DIR")
    ap.add_argument("--parent-only", action="store_true",
                    help="time the parent tree alone (this tree's segsum.cu "
                         "is built for its resources, never run)")
    args = ap.parse_args()
    if args.extract:
        extract(*args.extract)
        return 0
    import torch
    dev = torch.device("cuda")
    parent = None
    trees = {"this": os.path.join(ROOT, "raw_ngp_torch", "csrc")}
    if args.parent:
        parent = cs.parent_flat(args.parent)[0]
        trees["parent"] = args.parent
    for tag, tree in trees.items():
        try:
            _, log = cs.build_segsum(tree, tag)
        except cs.PhaseError as e:
            if not args.parent_only:
                raise
            print(json.dumps({"segsum_probe_build": tag,
                              "failed": str(e)[-3000:]}))
            continue
        print(json.dumps({"segsum_probe_build": tag,
                          "resources": kernel_resources(log)}))
    if not args.parent_only:
        cs.phase_build()
    # --parent-only: the parent computes and is timed as "this"
    only = parent if args.parent_only else None
    against = None if only else parent
    if "shapes" in args.presets:
        for C, M, B, n_rows, what in cs.NARROW_STREAMS + (FLAGSHIP,):
            for skew in (False, True):
                stream, _ = cs._outer_stream(dev, M, B, n_rows, C, skew)
                keys_s, perm, w_word, g = stream[:4]
                calls = [dict(keys=keys_s, perm=perm, w_word=w_word, g=g,
                              n_rows=n_rows, C=C, g_col=C)]
                res = cs.b2_step(calls, against, reps=20, fn=only)
                print(json.dumps({"segsum_probe": "shape", "shape": what,
                                  "skew": skew, **res,
                                  "streams": [stream_shape(calls[0])]}))
    for preset in [p for p in args.presets if p != "shapes"]:
        calls = preset_calls(preset, only)
        res = cs.b2_step(calls, against, fn=only)
        res["tree"] = "parent" if only else "this"
        res["streams"] = [stream_shape(c) for c in calls]
        print(json.dumps({"segsum_probe": preset, **res}))
        del calls
        torch.cuda.empty_cache()
    print(cs.gpu_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
