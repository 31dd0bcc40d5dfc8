#!/usr/bin/env python3
"""Which torch.distributed collectives a backend takes on which tensors.

    python3 port_tools/gloo_cuda_probe.py

Starts two gloo ranks that share one device (cuda:0 where there is a card,
else the CPU) and one NCCL rank alone (where there is a card), calls each
collective that ``raw_ngp_torch.parallel`` could use on f32, bf16 and int32
tensors, and prints one JSON line per world: for each call "ok", or the
first line of the error it raised, and whether its result was right.
"""

from __future__ import annotations

import json
import os
import socket
import sys
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _calls(rank: int, world: int, dev):
    """name -> (function that runs the collective, check of its result)."""
    out = {}
    for dtype in (torch.float32, torch.bfloat16, torch.int32):
        tag = str(dtype).split(".")[-1]
        base = torch.arange(8, device=dev).to(dtype) + rank

        def all_reduce_sum(b=base):
            t = b.clone()
            dist.all_reduce(t)
            ref = sum(torch.arange(8).to(b.dtype) + r for r in range(world))
            return torch.equal(t.cpu(), ref)

        def all_reduce_min(b=base):
            t = b.clone()
            dist.all_reduce(t, op=dist.ReduceOp.MIN)
            return torch.equal(t.cpu(), torch.arange(8).to(b.dtype))

        def all_gather(b=base):
            outs = [torch.empty_like(b) for _ in range(world)]
            dist.all_gather(outs, b)
            return all(torch.equal(o.cpu(), torch.arange(8).to(b.dtype) + r)
                       for r, o in enumerate(outs))

        def all_gather_into_tensor(b=base):
            o = torch.empty(world * 8, dtype=b.dtype, device=b.device)
            dist.all_gather_into_tensor(o, b)
            return all(torch.equal(o[r * 8:(r + 1) * 8].cpu(),
                                   torch.arange(8).to(b.dtype) + r)
                       for r in range(world))

        def reduce_scatter(b=base):
            ins = [b.clone() + j for j in range(world)]
            o = torch.empty_like(b)
            dist.reduce_scatter(o, ins)
            ref = sum(torch.arange(8).to(b.dtype) + r + rank
                      for r in range(world))
            return torch.equal(o.cpu(), ref)

        def reduce_scatter_tensor(b=base):
            i = torch.cat([b + j for j in range(world)])
            o = torch.empty_like(b)
            dist.reduce_scatter_tensor(o, i)
            ref = sum(torch.arange(8).to(b.dtype) + r + rank
                      for r in range(world))
            return torch.equal(o.cpu(), ref)

        def broadcast(b=base):
            t = b.clone()
            dist.broadcast(t, 0)
            return torch.equal(t.cpu(), torch.arange(8).to(b.dtype))

        for fn in (all_reduce_sum, all_reduce_min, all_gather,
                   all_gather_into_tensor, reduce_scatter,
                   reduce_scatter_tensor, broadcast):
            out[f"{fn.__name__}[{tag}]"] = fn
    return out


def _worker(rank: int, world: int, backend: str, init: str, dev_name: str,
            result: str):
    dist.init_process_group(backend, init_method=init, rank=rank,
                            world_size=world)
    dev = torch.device(dev_name)
    report = {}
    for name, fn in _calls(rank, world, dev).items():
        try:
            ok = fn()
            if dev.type == "cuda":
                torch.cuda.synchronize()
            report[name] = "ok" if ok else "wrong result"
        except Exception as e:  # the probe reports what each call raised
            report[name] = f"{type(e).__name__}: {str(e).splitlines()[0]}"
    dist.barrier()
    if rank == 0:
        with open(result, "w") as f:
            json.dump(report, f)
    dist.destroy_process_group()


def probe(backend: str, world: int, dev_name: str) -> dict:
    with tempfile.TemporaryDirectory() as tmp:
        result = os.path.join(tmp, "report.json")
        init = f"tcp://localhost:{_free_port()}"
        mp.spawn(_worker, args=(world, backend, init, dev_name, result),
                 nprocs=world, join=True)
        with open(result) as f:
            return json.load(f)


def main() -> int:
    cuda = torch.cuda.is_available()
    dev = "cuda:0" if cuda else "cpu"
    print(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0) if cuda else 'cpu'}")
    worlds = [("gloo", 2, dev)] + ([("nccl", 1, dev)] if cuda else [])
    for backend, world, d in worlds:
        print(json.dumps({"backend": backend, "world": world, "device": d,
                          "calls": probe(backend, world, d)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
