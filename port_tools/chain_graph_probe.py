#!/usr/bin/env python3
"""The chained dispatch's design choice on the card: one CUDA graph of one
train step replayed n times a chain (what `raw_ngp_torch/train/dispatch.py`
does) against one graph of n steps replayed once (the closer copy of JAX's
`lax.scan` chain), at the flagship (chip_smoke.flagship_config()) on
`make_synthetic_scene(36, 2, 128, 128)`:

    python3 port_tools/chain_graph_probe.py [n]

From the same state, a chain of n steps (default 15, the replays of an
auto chain of 16 after its eager first step) each way, the state after it
compared bit for bit; for each way the device memory its graph's pool
holds (reserved after the capture less before it, every other cached
block freed first), the capture seconds and the chain's CUDA-event ms a
step (median of 5 chains, each from the same state). Prints one
`chain_graph_probe` JSON line and the card's name and power limit."""
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


def capture_steps(tr, n, stream):
    """A CUDA graph of n train steps (device_step n times in one capture),
    the host counters put back -> (graph, capture s)."""
    import torch
    step = tr._train_step
    counters = [(tr.state, "step"), (tr.state.opt_state, "count")]
    before = [getattr(h, a) for h, a in counters]
    graph = torch.cuda.CUDAGraph()
    graph.register_generator_state(tr.batch_generator)
    t0 = time.perf_counter()
    with torch.cuda.graph(graph, stream=stream):
        for _ in range(n):
            step.device_step(tr.field, tr.state, tr.scene_arrays, tr.aabb,
                             tr.batch_generator)
    seconds = time.perf_counter() - t0
    for (h, a), v in zip(counters, before):
        setattr(h, a, v)
    return graph, seconds


def main(n=15):
    import torch
    from raw_ngp_torch.data import make_synthetic_scene
    from raw_ngp_torch.train.trainer import Trainer
    dev = torch.device("cuda:0")
    cs.phase_build()
    train_s, val_s = make_synthetic_scene(n_train=36, n_val=2, H=128, W=128)
    tr = Trainer(cs.flagship_config(), train_s, val_s, device=dev,
                 workspace=cs.scratch_workspace())
    tr.train(16, log_every=10 ** 9)          # a chain: the 1-step graph
    tr._graphs.graphs.clear()
    tr.step()                                # past the refresh, eagerly
    torch.cuda.synchronize()
    snap = cs.trainer_snapshot(tr)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):          # the stream's own warm-up
        tr._train_step.device_step(tr.field, tr.state, tr.scene_arrays,
                                   tr.aabb, tr.batch_generator)
    torch.cuda.current_stream().wait_stream(stream)
    out = {"config": "flagship", "chain_steps": n}
    ends = {}
    for way in ("one_step_graph", "n_step_graph"):
        cs.trainer_restore(tr, snap)
        tr._train_step.prepare(tr.state)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        reserved0 = torch.cuda.memory_reserved()
        graph, cap_s = capture_steps(tr, 1 if way == "one_step_graph"
                                     else n, stream)
        torch.cuda.synchronize()
        pool = torch.cuda.memory_reserved() - reserved0
        replays = n if way == "one_step_graph" else 1
        ms = []
        for rep in range(5):
            cs.trainer_restore(tr, snap)
            tr._train_step.prepare(tr.state)
            torch.cuda.synchronize()
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            for _ in range(replays):
                graph.replay()
            e1.record()
            torch.cuda.synchronize()
            ms.append(e0.elapsed_time(e1) / n)
        ends[way] = cs.graphed_tensors(tr)
        out[way] = {"graph_pool_gib": pool / 2 ** 30, "capture_s": cap_s,
                    "ms_per_step": sorted(ms)[2], "ms_per_step_runs": ms}
        del graph
    diff = cs.bit_diff(ends["n_step_graph"], ends["one_step_graph"])
    out["bitwise_equal"] = not diff
    out["differ"] = sorted(diff)
    print(json.dumps({"chain_graph_probe": out}))
    print(cs.gpu_line())


if __name__ == "__main__":
    main(*(int(a) for a in sys.argv[1:]))
