#!/usr/bin/env python3
"""Val PSNR (EMA) of the -O preset along training, on the CPU, in one of
the two packages: the learning curve behind the `O` phase of
chip_smoke.py at a size the CPU can train.

    JAX_PLATFORMS=cpu python3 port_tools/o_learning_curve.py --package jax
    python3 port_tools/o_learning_curve.py --package torch

The configuration is Config().with_preset_O() (the span march of 512
candidates packed into 64 slots, no probes, mark_untrained, bf16, grid
bound 2) cut to 8 levels, log2 15, resolution 128, hidden 32, grid 32,
1,024 rays a step, on make_synthetic_scene(36, 2, 48, 48), seed 0. It
prints the val PSNR (EMA) of the untrained field and after every 100
steps. The two packages draw different random streams, so their curves
are compared in shape, not value by value. Each run imports one package
only.
"""

import argparse
import sys
import time
from dataclasses import replace
from pathlib import Path


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--package", choices=("jax", "torch"),
                        required=True)
    parser.add_argument("--steps", type=int, default=500)
    args = parser.parse_args()
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import tempfile
    # a workspace of its own, so that neither package resumes a checkpoint
    kwargs = {"workspace": tempfile.mkdtemp()}
    if args.package == "jax":
        import jax
        jax.config.update("jax_platforms", "cpu")
        from raw_ngp_tpu import Config
        from raw_ngp_tpu.data import make_synthetic_scene
        from raw_ngp_tpu.train.trainer import Trainer
    else:
        from raw_ngp_torch import Config
        from raw_ngp_torch.data import make_synthetic_scene
        from raw_ngp_torch.train.trainer import Trainer
        kwargs["device"] = "cpu"
    cfg = Config().with_preset_O()
    cfg = replace(cfg, model=replace(
        cfg.model, num_levels=8, log2_hashmap_size=15,
        hashgrid_resolution=128, grid_mlp_hidden=32, view_mlp_hidden=32),
        render=replace(cfg.render, grid_size=32, max_ray_batch=4096),
        train=replace(cfg.train, iters=600, num_rays=1024)).validate()
    train, val = make_synthetic_scene(n_train=36, n_val=2, H=48, W=48)
    tr = Trainer(cfg, train, val, **kwargs)
    print(f"{args.package}: untrained val PSNR (EMA) "
          f"{tr.evaluate()['psnr']:.3f} dB", flush=True)
    t0 = time.time()
    for done in range(100, args.steps + 1, 100):
        tr.train(iters=100, log_every=10 ** 9)
        print(f"{args.package}: {done} steps, val PSNR (EMA) "
              f"{tr.evaluate()['psnr']:.3f} dB ({time.time() - t0:.0f} s)",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
