"""Offline golden evaluation of exported predictions (copy of the JAX
package's ``tools/offline_eval.py`` over the port's metrics and
postprocessing).

Equivalent of the reference's debug/eval.py:157-261: load the raw
``pred_*.npy`` / ``gt_*.npy`` pairs that ``--eval`` training dumps into
``<workspace>/eval/``, optionally re-apply RAW postprocessing (cam2rgb +
exposure percentile, or multi-exposure HDR merge), and report
PSNR / SSIM / RMSE / MSE. Calibration comes from a JSON file
(``--calibration``) with the light-stage matrix as the default.

Usage:
  python -m raw_ngp_torch.tools.offline_eval <workspace>/eval [--raw]
      [--percentile 99] [--hdr_merge robertson|debevec]
"""

from __future__ import annotations

import argparse
import glob
import json
import os

import numpy as np

from raw_ngp_torch.data.image_io import LIGHTSTAGE_CAM2RGB
from raw_ngp_torch.postprocess.raw import postprocess_raw, postprocess_raw_hdr
from raw_ngp_torch.train.metrics import PSNRMeter, SSIMMeter, rmse


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("eval_dir", type=str)
    p.add_argument("--raw", action="store_true",
                   help="apply cam2rgb + exposure postprocess before metrics")
    p.add_argument("--hdr_merge", default="none",
                   choices=["none", "robertson", "debevec"])
    p.add_argument("--percentile", type=float, default=99.0)
    p.add_argument("--percentiles", type=float, nargs="*",
                   default=[97, 99, 99.9, 100])
    p.add_argument("--calibration", type=str, default=None,
                   help="JSON with {'cam2rgb': [[...]x3], 'exposure': x}")
    args = p.parse_args(argv)

    cam2rgb = LIGHTSTAGE_CAM2RGB
    exposure = None
    if args.calibration:
        with open(args.calibration) as f:
            calib = json.load(f)
        cam2rgb = np.asarray(calib["cam2rgb"], np.float64)
        exposure = calib.get("exposure")

    preds = sorted(glob.glob(os.path.join(args.eval_dir, "pred_*.npy")))
    gts = sorted(glob.glob(os.path.join(args.eval_dir, "gt_*.npy")))
    if len(preds) != len(gts) or not preds:
        raise ValueError(f"no pred/gt pairs in {args.eval_dir}")

    psnr_m, ssim_m = PSNRMeter(), SSIMMeter()
    rmses, mses = [], []
    for pf, gf in zip(preds, gts):
        pred = np.load(pf)
        gt = np.load(gf)
        if args.raw:
            if args.hdr_merge != "none":
                pred = postprocess_raw_hdr(pred, cam2rgb, args.percentiles,
                                           args.hdr_merge)
                gt = postprocess_raw_hdr(gt, cam2rgb, args.percentiles,
                                         args.hdr_merge)
            else:
                exp = exposure or np.percentile(gt @ cam2rgb.T,
                                                args.percentile)
                pred = postprocess_raw(pred, cam2rgb, exp)
                gt = postprocess_raw(gt, cam2rgb, exp)
        pred = np.clip(pred, 0, 1)
        gt = np.clip(gt, 0, 1)
        psnr_m.update(pred, gt)
        ssim_m.update(pred, gt)
        rmses.append(rmse(pred, gt))
        mses.append(float(np.mean((pred - gt) ** 2)))

    result = {
        "n_images": len(preds),
        "psnr": psnr_m.measure(),
        "ssim": ssim_m.measure(),
        "rmse": float(np.mean(rmses)),
        "mse": float(np.mean(mses)),
    }
    print(json.dumps(result, indent=2))
    return result


if __name__ == "__main__":
    main()
