#!/usr/bin/env python3
"""Same-call A/B of the regularised -O step: chip_smoke.py's reg phase
(reg_config(), 128 Trainer steps, the median of the last 32) of TREE, a
whole other version of this repository (e.g. a git archive of a parent
commit, unpacked under workspace/), and of this tree, in turns other,
this, this, other, each run in its own process from its own tree (its own
kernels, built into that tree's build/):

    python3 port_tools/reg_step_ab.py TREE

Prints one `reg_ab` JSON line: each run's median ms a step with its 32
samples, the train views' PSNR, the device busy time of a profiled step
and the card (nvidia-smi name, power limit)."""
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

RUN = """
import json, sys, torch
sys.path.insert(0, {tree!r})
import chip_smoke as cs
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
cs.phase_build()
with cs.cached_mark_untrained():
    _, out, med = cs.phase_reg(torch.device("cuda:0"))
print("REG_AB " + json.dumps({{
    "ms_per_step": med, "ms_per_step_runs": out["ms_per_step_runs"],
    "train_views_psnr_ema": out["train_views_psnr_ema"],
    "device_busy_ms_per_step": out["profile"].get("device_busy_ms_per_step"),
    "gpu": out["gpu"]}}))
"""


def run(tree):
    tree = os.path.abspath(tree)
    proc = subprocess.run([sys.executable, "-c", RUN.format(tree=tree)],
                          cwd=tree, capture_output=True, text=True)
    for line in proc.stdout.splitlines():
        if line.startswith("REG_AB "):
            return json.loads(line[len("REG_AB "):])
    sys.stderr.write(proc.stdout[-4000:] + proc.stderr[-4000:])
    raise SystemExit(f"reg_step_ab: the reg phase of {tree} failed")


def main() -> int:
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    other = sys.argv[1]
    runs = []
    for which in ("other", "this", "this", "other"):
        res = run(other if which == "other" else ROOT)
        res["tree"] = which
        runs.append(res)
        print(f"[reg_ab] {which}: {res['ms_per_step']:.3f} ms a step, "
              f"{res['train_views_psnr_ema']:.3f} dB", flush=True)
    print(json.dumps({"reg_ab": {"against": other, "runs": runs}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
