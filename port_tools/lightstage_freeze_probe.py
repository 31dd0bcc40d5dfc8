#!/usr/bin/env python3
"""The light-stage preset's training on DNG capture folders that differ
in brightness, lighting and rfield, on the card: the runs behind the
brightness of the `dng` phase of chip_smoke.py.

    python3 port_tools/lightstage_freeze_probe.py

Each run writes chip_smoke.capture_scene()'s captures (9 views x 4 LEDs
of make_rfield_grid_scene at 256x256; "1 LED": each view's first LED's
capture four times) as a DNG folder (chip_smoke.write_capture_folder) at
`brightness` times the scene's linear values (1.0: the brightest pixels
near the white level), loads it with chip_smoke.capture_config(root,
"dng") (Config().with_preset_lightstage(), clip off) with or without
rfield, and trains 128 steps at a train seed. It prints one JSON line a
run: the HDR val PSNR (EMA) untrained and after, the exposure levels of
the trained field's first val render and the loss every 8 steps. Every
run shares one mark_untrained grid (the same cameras).
"""

import json
import shutil
import sys
import time
from dataclasses import replace
from pathlib import Path

RUNS = (("4 LEDs", 1.0, False, 0), ("4 LEDs", 1.0, False, 1),
        ("4 LEDs", 1.0, False, 2), ("4 LEDs", 1.0, True, 0),
        ("4 LEDs", 0.3, False, 0), ("4 LEDs", 0.3, False, 1),
        ("1 LED", 1.0, False, 0), ("1 LED", 0.3, False, 0))


def main() -> int:
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import numpy as np
    import torch
    import chip_smoke as cs
    from raw_ngp_torch.data import load_scene
    from raw_ngp_torch.kernels import _build
    from raw_ngp_torch.train.trainer import Trainer
    if not torch.cuda.is_available():
        print("lightstage_freeze_probe: needs a GPU", file=sys.stderr)
        return 2
    dev = torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    cs.phase_build()
    images, poses, intrinsics, ldirs = cs.capture_scene()
    n_leds = len(ldirs)
    one = images.reshape(-1, n_leds, *images.shape[1:])[:, :1]
    sets = {"4 LEDs": images,
            "1 LED": np.repeat(one, n_leds, 1).reshape(images.shape)}
    print(cs.gpu_line())
    scenes = {}
    with cs.cached_mark_untrained():
        for lights, brightness, rfield, seed in RUNS:
            key = (lights, brightness, rfield)
            if key not in scenes:
                root = _build.BUILD_DIR.parent / "freeze_probe"
                shutil.rmtree(root, ignore_errors=True)
                cs.write_capture_folder(root, "dng",
                                        sets[lights] * brightness, poses,
                                        intrinsics, ldirs)
                cfg = cs.capture_config(root, "dng")
                cfg = replace(cfg, model=replace(cfg.model, rfield=rfield))
                np.random.seed(0)
                scenes[key] = (cfg, load_scene(cfg, "train"),
                               load_scene(cfg, "val"))
                shutil.rmtree(root, ignore_errors=True)
            cfg, train_s, val_s = scenes[key]
            cfg = replace(cfg, train=replace(cfg.train, seed=seed))
            t0 = time.perf_counter()
            tr = Trainer(cfg, train_s, val_s, device=dev,
                         workspace=cs.scratch_workspace())
            psnr_0 = tr.evaluate()["psnr"]
            losses = [float(tr.step()["loss"]) for _ in range(128)]
            psnr = tr.evaluate()["psnr"]
            print(json.dumps({
                "captures": lights, "brightness": brightness,
                "rfield": rfield, "seed": seed,
                "val_psnr_ema_untrained": psnr_0, "val_psnr_ema": psnr,
                "exposure_levels": {str(k): v for k, v in
                                    tr.exposure_levels.items()},
                "loss_every_8": losses[::8] + losses[-1:],
                "seconds": time.perf_counter() - t0}), flush=True)
            del tr
    return 0


if __name__ == "__main__":
    sys.exit(main())
