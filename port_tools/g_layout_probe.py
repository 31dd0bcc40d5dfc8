#!/usr/bin/env python3
"""How the layout of g costs B2's in-place read: the flat form on
`chip_smoke.py`'s random level-1 stream reading the level's 16 bf16
channels from rows of 64 bytes (g [B, 32], column 16, the path's layout;
and column 0) and from rows of 32 bytes (g [B, 16]), device time split
by stage, in turns a b c c b a:

    python3 port_tools/g_layout_probe.py

Checks that the three layouts give the same bits and prints one
`g_layout` JSON line."""
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    import torch
    from raw_ngp_torch.kernels import segsum as ts
    dev = torch.device("cuda:0")
    M, B, n_rows, C = 1 << 20, 1 << 18, 1 << 19, 16
    stream, _ = cs._outer_stream(dev, M, B, n_rows, C, False)
    keys, perm, w_word, g = stream[:4]
    narrow = g[:, C:].contiguous()
    cases = {"a: [B, 32] column 16": (g, C), "b: [B, 32] column 0": (g, 0),
             "c: [B, 16] column 0": (narrow, 0)}
    flat = torch.empty(n_rows * C, device=dev)
    res = {k: [] for k in cases}
    for name in list(cases) + list(cases)[::-1]:
        gg, col = cases[name]
        prof = cs.profile_device(lambda: ts.segment_grad_outer(
            keys, perm, w_word, gg, n_rows, C, g_col=col, out=flat), 20,
            "call")
        res[name].append({
            "device_ms": prof.get("device_busy_ms_per_call"),
            "stages": cs.stage_split(prof, cs.FLAT_STAGES, "zero_fill")})
    a = ts.segment_grad_outer(keys, perm, w_word, g, n_rows, C, g_col=C)
    c = ts.segment_grad_outer(keys, perm, w_word, narrow, n_rows, C)
    torch.cuda.synchronize()
    cs.check(cs.same_bits(a, c), "g_layout: the layouts differ in bits")
    print(json.dumps({"g_layout": res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
