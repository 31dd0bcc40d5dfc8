"""Collate quality_run JSON curves into a markdown table (copy of the JAX
package's ``tools/summarize_quality.py``).

Usage:
  python -m raw_ngp_torch.tools.summarize_quality q_flat.json q_tex.json

Prints one table: per run, PSNR train/held-out at 1k / 5k / 10k / 20k,
the held-out peak (step @ value), and whether held-out is monotone-ish
(no drop > 0.5 dB below its running max at the end)."""

import json
import os
import sys


def summarize(path):
    with open(path) as f:
        data = json.load(f)
    curve = data["curve"]
    by_step = {c["step"]: c for c in curve}

    def at(step):
        c = by_step.get(step)
        return f"{c['psnr_train']:.1f}/{c['psnr_heldout']:.1f}" if c else "—"

    held = [(c["step"], c["psnr_heldout"]) for c in curve]
    peak_step, peak = max(held, key=lambda sv: sv[1])
    final = held[-1][1]
    stable = final >= peak - 0.5
    name = os.path.basename(path).replace(".json", "")
    return (f"| {name} | {at(1000)} | {at(5000)} | {at(10000)} | "
            f"{at(20000)} | {peak:.1f} @ {peak_step} | "
            f"{'yes' if stable else f'NO (final {final:.1f})'} |")


def main(argv=None):
    lines = ["| run | 1k t/h | 5k t/h | 10k t/h | 20k t/h | held peak | "
             "stable to end |", "|---|---|---|---|---|---|---|"]
    for p in (sys.argv[1:] if argv is None else argv):
        try:
            lines.append(summarize(p))
        except Exception as e:  # noqa: BLE001 - report and continue
            lines.append(f"| {os.path.basename(p)} | error: {e} |")
    print("\n".join(lines))
    return lines


if __name__ == "__main__":
    main()
