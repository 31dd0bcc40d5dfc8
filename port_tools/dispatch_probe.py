#!/usr/bin/env python3
"""The chained dispatch of every single-device training preset on the card,
alone: for each of train (the flagship), pose, lightstage, proposal
(`-O2`), O, reg and unfused at chip_smoke.py's configurations, 32 eager
steps, the synchronizing calls of one eager step past the first refresh
(chip_smoke.sync_calls_of_step), then chip_smoke.repro_check (the graphed
chains bitwise the eager steps, twice) with its dispatch report, and for
O the forced key change and the memory of a sweep across several keys
(chip_smoke.key_sweep_memory). A preset that fails prints its traceback and the
rest run on:

    python3 port_tools/dispatch_probe.py [train pose lightstage proposal O reg unfused]

Prints one JSON line a preset and a summary line."""
import json
import os
import sys
import time
import traceback

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as cs  # noqa: E402


def main(names):
    import torch
    from raw_ngp_torch.data import make_synthetic_scene
    from raw_ngp_torch.train.trainer import Trainer
    dev = torch.device("cuda:0")
    t0 = time.time()
    cs.phase_build()
    print(f"[probe] build {time.time() - t0:.1f} s", flush=True)
    plain = make_synthetic_scene(n_train=36, n_val=2, H=128, W=128)
    hdr = make_synthetic_scene(n_train=36, n_val=2, H=128, W=128, hdr=True,
                               rfield=True)
    cases = {"train": (cs.flagship_config, plain),
             "pose": (lambda: cs.pose_config(128), plain),
             "lightstage": (cs.lightstage_config, hdr),
             "proposal": (cs.proposal_config, plain),
             "O": (cs.o_config, plain),
             "reg": (cs.reg_config, plain),
             "unfused": (lambda: cs.reg_config(fused=False), plain)}
    results = {}
    with cs.cached_mark_untrained():
        for name in names:
            make_cfg, (train_s, val_s) = cases[name]
            t1 = time.time()
            try:
                tr = Trainer(make_cfg(), train_s, val_s, device=dev,
                             workspace=cs.scratch_workspace())
                snap = cs.trainer_snapshot(tr)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(33)]
                for i in range(32):
                    ev[i].record()
                    tr.step()
                ev[32].record()
                torch.cuda.synchronize()
                ref = cs.graphed_tensors(tr)
                snap32 = cs.trainer_snapshot(tr)
                tr.step()     # past the refresh boundary, eagerly
                print(f"[probe] {name} syncs of an eager step: "
                      f"{cs.sync_calls_of_step(tr)}", flush=True)
                cs.trainer_restore(tr, snap32)
                cs.EAGER_RUNS[name] = {
                    "step_ms": [ev[i].elapsed_time(ev[i + 1])
                                for i in range(32)],
                    "eager_allocated_gib":
                        torch.cuda.max_memory_allocated() / 2 ** 30,
                    "eager_reserved_gib":
                        torch.cuda.max_memory_reserved() / 2 ** 30}
                repro, disp = cs.repro_check(tr, snap, ref, 32, name)
                out = {"repro": repro, "dispatch": disp}
                if name == "O":
                    out["forced_key"] = cs.forced_key_check(tr, snap, 32)
                    out["key_sweep"] = cs.key_sweep_memory(tr, snap)
                results[name] = out
            except Exception:   # noqa: BLE001
                traceback.print_exc()
                results[name] = "failed"
            print(f"[probe] {name} {time.time() - t1:.1f} s", flush=True)
            print(json.dumps({name: results[name]}, default=str), flush=True)
            tr = None
            torch.cuda.empty_cache()
    print(json.dumps({k: (v if v == "failed" else {
        "graphed": v["dispatch"].get("graphed_ms_per_step"),
        "eager": v["dispatch"].get("eager_ms_per_step_same_steps"),
        "syncs": v["dispatch"]["sync_calls_eager_step"]["count"]})
        for k, v in results.items()}))
    print(f"[probe] total {time.time() - t0:.1f} s")


if __name__ == "__main__":
    main(sys.argv[1:] or ["train", "pose", "lightstage", "proposal", "O",
                          "reg", "unfused"])
