#!/usr/bin/env python3
"""Device times of a tree whose window records and g packing are kernels
of their own (`window_records`, `pack_g_words`), at `chip_smoke.py`'s
inputs, for a same-call comparison with this tree's `chip_smoke.py`:

    python3 port_tools/measure_unfolded.py TREE

TREE is another checkout of this repository (e.g. a `git archive` of an
earlier commit unpacked under `workspace/`, which .gitignore lists). It
builds TREE's kernels, times with this tree's `chip_smoke.py` helpers
(torch.profiler device time, mean of 20 calls) the records kernel, the
g packing, the bf16 and f32 forwards, the table gradient with and
without the records and B2's flat form on `phase_segsum`'s random
stream, then profiles three train steps of the flagship after 20
(device busy, launches, host-to-device copies, runtime calls). Prints
one `unfolded` JSON line.
"""
import importlib.util
import json
import os
import sys


def main() -> int:
    tree = os.path.abspath(sys.argv[1])
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, tree)
    import torch
    spec_cs = importlib.util.spec_from_file_location(
        "this_chip_smoke", os.path.join(here, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec_cs)
    spec_cs.loader.exec_module(cs)
    from raw_ngp_torch.kernels import _build, hash_encode as th, segsum as ts
    from raw_ngp_torch.models.ngp import make_field_spec
    if not th.__file__.startswith(tree):
        raise SystemExit(f"imported {th.__file__}, not TREE's package")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")
    _build.build_all()
    cfg = cs.flagship_config()
    spec = make_field_spec(cfg).grid_spec
    B, C = 262144, spec.level_dim
    bf16 = torch.bfloat16
    # phase_encode_bwd's inputs: seed 4, uniform points with 64 outside
    # [0, 1]^3 and 8 NaN
    gen = torch.Generator(device=dev).manual_seed(4)
    table = (torch.rand(spec.n_params * C, generator=gen, device=dev) * 2
             - 1) * 1e-2
    x01 = torch.rand(B, 3, generator=gen, device=dev)
    cs.ray_points(B, gen, dev)
    x01[:64] = x01[:64] * 3.0 - 1.0
    x01[64:72, 1] = float("nan")
    g = torch.randn(B, spec.output_dim, generator=gen, device=dev).to(bf16)
    base, w_word = th.window_records(x01, spec)
    out = {"tree": tree}
    calls = {
        "records": lambda: th.window_records(x01, spec),
        "pack_g_words": lambda: th.pack_g_words(g, spec),
        "forward_bf16": lambda: th.hash_encode(table, x01, spec, bf16),
        "forward_f32": lambda: th.hash_encode(table, x01, spec),
        "records_plus_table_grad": lambda: th.table_grad(
            spec, x01, *th.window_records(x01, spec), g, bf16),
        "table_grad_given_records": lambda: th.table_grad(
            spec, x01, base, w_word, g, bf16)}
    for name, fn in calls.items():
        prof = cs.profile_device(fn, 20, "call")
        out[name] = {"device_ms": prof.get("device_busy_ms_per_call"),
                     "launches": prof.get("kernel_launches_per_call")}
    # phase_segsum's random stream, its level-1 g channels packed
    M, n_rows = 1 << 20, 1 << 19
    g2 = torch.Generator(device=dev).manual_seed(3)
    keys = torch.randint(0, n_rows, (M,), generator=g2, device=dev,
                         dtype=torch.int32)
    keys_s, perm = torch.sort(keys, stable=True)
    w = torch.rand(2, M, generator=g2, device=dev)
    gg = torch.randn(1 << 18, 2 * C, generator=g2, device=dev).to(bf16)
    words = torch.stack(ts.pack_bf16_pairs(
        [gg[:, C + c] for c in range(C)]), 1)
    stream = (keys_s, perm.to(torch.int32),
              ts.pack_bf16_pairs([w[0], w[1]])[0], words, n_rows, C)
    flat = torch.empty(n_rows * C, device=dev)
    prof = cs.profile_device(
        lambda: ts.segment_grad_outer(*stream, out=flat), 20, "call")
    out["segment_grad_outer"] = {
        "device_ms": prof.get("device_busy_ms_per_call"),
        "stages": cs.stage_split(prof, cs.FLAT_STAGES, "zero_fill")}
    from raw_ngp_torch.data import make_synthetic_scene
    from raw_ngp_torch.train.trainer import Trainer
    train_s, val_s = make_synthetic_scene(n_train=36, n_val=2, H=128, W=128)
    tr = Trainer(cfg, train_s, val_s, device=dev)
    for _ in range(20):
        tr.step()
    torch.cuda.synchronize()
    steps = [cs.profile_device(tr.step, 1, "step") for _ in range(3)]
    for p in steps:
        p.pop("top_kernels", None)
    out["train_steps"] = steps
    print(json.dumps({"unfolded": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
