#!/usr/bin/env python3
"""Why the port's Debevec response differs from cv2's: on the CPU, the
least-squares system of raw_ngp_torch/postprocess/hdr.calibrate_debevec
(tests/test_torch_hdr.py's 4-exposure input, each channel) solved by
LAPACK in float64 (the port's ``np.linalg.lstsq``) and in float32, beside
cv2.createCalibrateDebevec's answer with its BLAS (cv2 ships its own
OpenBLAS) limited to 1, 2, 4 and 8 threads. For each: the least-squares
residual on the same system, the log response at level 128 (the row that
pins it is the system's only hold on a constant shift of the curve) and
the largest difference from the float64 answer.

    python3 port_tools/debevec_solver_probe.py [--channels 0 1 2]

Needs cv2, threadpoolctl and the repository's tests/ on the path.
"""

import argparse
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "tests")]

LDR = 256


def system(ims, t, ch):
    """calibrate_debevec's system of channel ch, float32 as cv2 builds
    it."""
    from raw_ngp_torch.postprocess import hdr
    H, W = ims[0].shape[:2]
    pts = hdr._debevec_points(H, W, 70, False)
    w = hdr._triangle_weights()
    n = len(pts)
    a = np.zeros((n * len(ims) + LDR + 1, LDR + n), np.float32)
    b = np.zeros(a.shape[0], np.float32)
    k = 0
    for i, (x, y) in enumerate(pts):
        for j, im in enumerate(ims):
            v = im[y, x, ch]
            a[k, v], a[k, LDR + i] = w[v], -w[v]
            b[k] = w[v] * np.log(t[j])
            k += 1
    a[k, LDR // 2] = 1
    for i in range(LDR - 2):
        wi = w[i + 1]
        a[k + 1 + i, i:i + 3] = (np.float32(10) * wi, np.float32(-20) * wi,
                                 np.float32(10) * wi)
    return a, b


def residual(a, b, g):
    """The least-squares residual of log response g with each sample's
    best log radiance."""
    a64, b64 = a.astype(np.float64), b.astype(np.float64)
    x = np.concatenate([g, np.zeros(a.shape[1] - LDR)])
    r = b64 - a64[:, :LDR] @ g
    for col in range(LDR, a.shape[1]):
        ac = a64[:, col]
        if ac @ ac > 0:
            x[col] = (ac @ r) / (ac @ ac)
    return float(np.linalg.norm(a64 @ x - b64))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--channels", type=int, nargs="+", default=[0, 1, 2])
    args = parser.parse_args()
    import cv2
    import test_torch_hdr as T
    from threadpoolctl import threadpool_limits
    ims, t = T.stack("p4")
    crfs = {}
    for n in (1, 2, 4, 8):
        with threadpool_limits(limits=n):
            crfs[n] = cv2.createCalibrateDebevec().process(ims, times=t)
    for ch in args.channels:
        a, b = system(ims, t, ch)
        g64 = np.linalg.lstsq(a.astype(np.float64), b.astype(np.float64),
                              rcond=None)[0][:LDR]
        sols = {"lstsq_f64": g64,
                "lstsq_f32": np.linalg.lstsq(a, b, rcond=None)[0][:LDR]
                .astype(np.float64)}
        for n, crf in crfs.items():
            sols[f"cv2_{n}_threads"] = np.log(crf[:, 0, ch].astype(np.float64))
        for name, g in sols.items():
            print(f"channel {ch} {name:14s}: residual "
                  f"{residual(a, b, g):.6f}, g(128) {g[128]:+.6f}, max |g - "
                  f"f64| {np.abs(g - g64).max():.2e}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
