#!/usr/bin/env python3
"""Pose recovery's translation on the port, seed by seed: chip_smoke.py's
pose_recovery_config() (tests/test_pose_opt.py's configuration: the
proposal path on the unfused encoder, BARF on 36 cameras with pose noise
0.05) trained for 400 steps on make_synthetic_scene(36, 2, 48, 48) at each
seed (train.seed: the field, the pose noise and the batches), with the
Procrustes rotation and translation errors before and after.

    python3 port_tools/pose_translation_seeds.py [--seeds 0-13]
        [--steps 400] [--device cuda] [--out pose_seeds.json]

Prints one line a seed and a JSON summary: at how many seeds the
translation error fell (JAX's own test configuration on the CPU: 9 of 14
at seeds 0-13) and the rotation error fell below 0.92 of its start, and
the mean ratios. Imports no JAX.
"""

import argparse
import json
import sys
import time
from dataclasses import replace
from pathlib import Path


def seed_list(text):
    out = []
    for part in text.split(","):
        lo, _, hi = part.partition("-")
        out += list(range(int(lo), int(hi or lo) + 1))
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seeds", type=seed_list, default=seed_list("0-13"))
    parser.add_argument("--steps", type=int, default=400)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import torch

    from chip_smoke import pose_recovery_config, scratch_workspace
    from raw_ngp_torch.data import make_synthetic_scene
    from raw_ngp_torch.train.pose_analysis import analyze_pose_optimization
    from raw_ngp_torch.train.trainer import Trainer

    train_s, val_s = make_synthetic_scene(n_train=36, n_val=2, H=48, W=48)
    runs = []
    t_all = time.perf_counter()
    for seed in args.seeds:
        cfg = pose_recovery_config()
        cfg = replace(cfg, train=replace(cfg.train, seed=seed)).validate()
        tr = Trainer(cfg, train_s, val_s, device=args.device,
                     workspace=scratch_workspace())
        err0 = analyze_pose_optimization(tr)
        t0 = time.perf_counter()
        tr.train(iters=args.steps, log_every=10 ** 9)
        if tr.device.type == "cuda":
            torch.cuda.synchronize()
        err1 = analyze_pose_optimization(tr)
        run = {"seed": seed,
               "rotation_deg": [err0["rotation_deg"], err1["rotation_deg"]],
               "translation": [err0["translation"], err1["translation"]],
               "rotation_ratio": err1["rotation_deg"] / err0["rotation_deg"],
               "translation_ratio": err1["translation"] / err0["translation"],
               "seconds": time.perf_counter() - t0}
        runs.append(run)
        print(f"seed {seed}: rotation {err0['rotation_deg']:.4f} -> "
              f"{err1['rotation_deg']:.4f} deg (ratio "
              f"{run['rotation_ratio']:.4f}), translation "
              f"{err0['translation']:.5f} -> {err1['translation']:.5f} "
              f"(ratio {run['translation_ratio']:.4f}), "
              f"{run['seconds']:.1f} s", flush=True)
    n = len(runs)
    summary = {
        "config": "chip_smoke.pose_recovery_config()",
        "scene": "make_synthetic_scene(36, 2, 48, 48)",
        "steps": args.steps, "device": args.device, "seeds": args.seeds,
        "translation_fell": sum(r["translation_ratio"] < 1 for r in runs),
        "rotation_below_0_92": sum(r["rotation_ratio"] < 0.92
                                   for r in runs),
        "both": sum(r["translation_ratio"] < 1 and r["rotation_ratio"] < 0.92
                    for r in runs),
        "mean_translation_ratio": sum(r["translation_ratio"]
                                      for r in runs) / n,
        "mean_rotation_ratio": sum(r["rotation_ratio"] for r in runs) / n,
        "seconds": time.perf_counter() - t_all, "runs": runs}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=1)
    print(json.dumps({k: v for k, v in summary.items() if k != "runs"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
