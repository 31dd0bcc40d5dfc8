"""Schedule-scale quality evidence: train the flagship configuration for
thousands of steps and record the train-view / held-out PSNR curve (copy
of the JAX package's ``tools/quality_run.py`` on the port's Trainer).

The protocol mirrors the reference's offline evaluator (debug/eval.py:
157-205, pred-vs-gt PSNR over full renders); the reference's default
schedule is 20k iters (main.py:40-41).

Usage (one NVIDIA GPU; ``--device cpu`` runs the plain versions):
  python -m raw_ngp_torch.tools.quality_run [--iters 5000]
      [--eval_every 500] [--out quality_run.json]

Writes the curve as JSON (``--out``, default ``quality_run.json`` in the
temporary directory) and prints it. The Trainer's workspace is a fresh
temporary directory, so a run never resumes an earlier one.
"""

import argparse
import json
import os
import tempfile
import time
from dataclasses import replace

import numpy as np


def parse(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=5000)
    ap.add_argument("--eval_every", type=int, default=500)
    ap.add_argument("--textured", action="store_true",
                    help="lat/long-checker albedo: a sharper PSNR "
                         "instrument than the flat bench scene")
    ap.add_argument("--hdr", action="store_true",
                    help="linear-radiance scene with {0.25,1,4} exposure "
                         "bracketing -> RawNeRF clipped loss + "
                         "clamped_exp color (the reference's core mode)")
    ap.add_argument("--rfield", action="store_true",
                    help="per-image light directions -> reflectance-"
                         "field conditioning (SH(ldir) concat)")
    ap.add_argument("--rfield_grid", default="",
                    help="V:L dense view x light grid with held-out "
                         "LIGHTS (e.g. 16:16) — held-out PSNR then "
                         "isolates relighting generalization; implies "
                         "--rfield")
    ap.add_argument("--eps", type=float, default=0.0,
                    help="override train.adam_eps (stability ladder A/Bs)")
    ap.add_argument("--lr", type=float, default=0.0,
                    help="override train.lr")
    ap.add_argument("--levels", type=int, default=0,
                    help="override model num_levels (with --level_dim)")
    ap.add_argument("--level_dim", type=int, default=0)
    ap.add_argument("--hash", default="",
                    help="override hash_variant (e.g. xor for the "
                         "reference-shape 16x2 A/B, network.py:47-49)")
    ap.add_argument("--res", type=int, default=128,
                    help="scene H=W resolution")
    ap.add_argument("--march", default="",
                    help="override march shape, mc:cp[:cdf] "
                         "(e.g. 128:32:cdf)")
    ap.add_argument("--contract", action="store_true",
                    help="contracted/unbounded regime: bound=2, MeRF "
                         "contraction, dt_gamma 0.0078 (the reference's "
                         "-O2 territory)")
    ap.add_argument("--probe_log", action="store_true")
    ap.add_argument("--cdf_floor", type=float, default=0.0)
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                  "quality_run.json"))
    ap.add_argument("--device", default="cuda",
                    help="torch device of the Trainer (cpu: the plain "
                         "versions of the kernels)")
    return ap.parse_args(argv)


def build(args):
    """(cfg, train_scene, val_scene) of the flags: the flagship
    configuration (``with_preset_O().with_tpu_profile()``, fp16, 8,192
    rays) and scene with the flags' overrides."""
    from raw_ngp_torch.config import Config
    from raw_ngp_torch.data import make_rfield_grid_scene, make_synthetic_scene

    cfg = Config().with_preset_O().with_tpu_profile()
    cfg = replace(cfg, train=replace(cfg.train, fp16=True, num_rays=8192))
    if args.eps:
        cfg = replace(cfg, train=replace(cfg.train, adam_eps=args.eps))
    if args.lr:
        cfg = replace(cfg, train=replace(cfg.train, lr=args.lr))
    if args.levels:
        cfg = replace(cfg, model=replace(cfg.model, num_levels=args.levels,
                                         level_dim=args.level_dim))
    if args.hash:
        cfg = replace(cfg, model=replace(cfg.model,
                                         hash_variant=args.hash))
    if args.hdr:
        # HDR mode mirrors the lightstage preset's loss-relevant pieces
        # (image_mode drives rawnerf_loss; clamped_exp is the reference's
        # HDR color head, network.py:131-138)
        cfg = replace(cfg, data=replace(cfg.data, image_mode="HDR"),
                      model=replace(cfg.model,
                                    color_activation="clamped_exp"))
    if args.rfield or args.rfield_grid:
        cfg = replace(cfg, model=replace(cfg.model, rfield=True))
    if args.march:
        toks = args.march.split(":")
        cdf = toks[-1] == "cdf"
        mc, cp = int(toks[0]), int(toks[1])
        cfg = replace(cfg, render=replace(
            cfg.render, march_candidates=mc, coarse_probes=cp,
            march_cdf=cdf))
    if args.contract:
        cfg = replace(cfg, render=replace(
            cfg.render, contract=True, bound=2.0, dt_gamma=0.0078,
            mark_untrained=False))
    if args.probe_log or args.cdf_floor:
        cfg = replace(cfg, render=replace(
            cfg.render, probe_log=args.probe_log,
            cdf_floor=args.cdf_floor))
    cfg = cfg.validate()
    if args.rfield_grid:
        v, l = (int(x) for x in args.rfield_grid.split(":"))
        train_scene, val_scene = make_rfield_grid_scene(
            n_views=v, n_lights=l, H=args.res, W=args.res,
            textured=args.textured)
    else:
        train_scene, val_scene = make_synthetic_scene(
            n_train=36, n_val=2, H=args.res, W=args.res,
            textured=args.textured, hdr=args.hdr, rfield=args.rfield)
    return cfg, train_scene, val_scene


def main(argv=None):
    args = parse(argv)
    from raw_ngp_torch.train.trainer import Trainer

    cfg, train_scene, val_scene = build(args)
    workspace = tempfile.mkdtemp(prefix="raw_ngp_torch_quality_")
    tr = Trainer(cfg, train_scene, val_scene, device=args.device,
                 workspace=workspace)

    curve = []
    t0 = time.time()
    done = 0
    while done < args.iters:
        n = min(args.eval_every, args.iters - done)
        tr.train(iters=n, log_every=10 ** 9)
        done += n
        held = float(tr.evaluate()["psnr"])
        rgb_t, _ = tr.render_image(
            train_scene.poses[0], train_scene.intrinsics,
            train_scene.H, train_scene.W,
            ldir=(train_scene.ldirs[0]
                  if train_scene.ldirs is not None else None))
        gt_t = train_scene.images[0][..., :3]
        if args.hdr and train_scene.exposures is not None:
            # exposure-clipped comparison, the RawNeRF/eval protocol
            # (trainer.evaluate, train_utils.py:1014-1016 parity)
            rgb_t = np.minimum(1.0, np.asarray(rgb_t)
                               * train_scene.exposures[0])
            gt_t = np.minimum(1.0, gt_t)
        mse_t = float(np.mean((np.clip(rgb_t, 0, 1) - gt_t) ** 2))
        train_psnr = float(-10.0 * np.log10(mse_t + 1e-12))
        rec = {"step": done, "psnr_train": round(train_psnr, 3),
               "psnr_heldout": round(held, 3),
               "wall_s": round(time.time() - t0, 1)}
        curve.append(rec)
        print(json.dumps(rec), flush=True)

    out = {"iters": args.iters, "num_rays": tr.num_rays, "curve": curve}
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({"final": curve[-1]}))
    return out


if __name__ == "__main__":
    main()
