"""Chains of train steps on the card as CUDA graphs (port of JAX's
chained dispatch: ``scan_train_steps``, ``raw_ngp_tpu/train/trainer.py:
332-347``, and ``Trainer._get_step``'s cache, ``:685-692``).

JAX chains ``steps_per_dispatch`` train steps into one executable with
``lax.scan`` and keeps one executable per ``(num_rays, point_budget,
scan_steps)``. Here a chain of n steps is n replays of a CUDA graph of
one train step (the step's ``device_step``, :func:`raw_ngp_torch.train.
trainer.make_train_step`), captured once per adaptive-batch key
``(num_rays, point_budget)``: nothing runs on the host between the steps
of a chain. One graph of one step serves every chain length (the
remainders' too) and holds one step's memory, where a graph of n steps
would hold n steps' activations and need one capture per length.

What the graph reads is the state's own buffers, updated in place (the
grid refresh and the coarse cache copy into them, the checkpoint loads
into them), the scene tensors, the optimizers' per-step scalar tables
(built once a device) and the state's device counters, which the step
advances on the device. A graph is also keyed by where those buffers
live, so a state rebound to new tensors captures anew instead of reading
stale memory. The batch generator is registered with the graph, so each
replay draws what the eager step would at the generator's state, and
eager draws between chains (the grid refresh) move it as they do between
eager steps.

A capture runs nothing, so the first step of a chain with a new key is an
eager step on the capture stream (torch's warm-up before a capture, and a
real step of the chain), then the capture, then the replays. What a
step does on the host happens once, at capture: its host counters
(``state.step``, the optimizers' ``count``, mirrors of the device
counters) are put back after the capture and advanced by one a replay;
the kernels' launch counters count the capture's calls, each of which
records its kernel, and no replay (:mod:`raw_ngp_torch.kernels`). The
metrics are the graph's static outputs; a chain returns copies of the
last step's (JAX returns the last step's metrics as new arrays).

Only the current key's graph is kept: a capture at a new key drops the
others, and every capture allocates from one memory pool, so a run that
crosses keys reuses the memory of the graphs it left instead of holding
one step's activations a key (a key left and met again is captured
again).

No fallback: a step that cannot be captured raises with the reason.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import torch

from raw_ngp_torch.train import checkpoint


@dataclass
class _Graph:
    graph: Any
    metrics: Dict[str, Any]
    bindings: Tuple[int, ...]


@dataclass
class ChainRecord:
    """One chain's replays: their count, the CUDA events around them and
    the key of the graph."""

    n: int
    start: Any
    end: Any
    key: Tuple


@dataclass
class GraphedSteps:
    """The train steps of one single-device :class:`raw_ngp_torch.train.
    trainer.Trainer` on CUDA, as replays of the current key's graph:
    :meth:`run` takes n steps. ``captures`` lists each capture's key and
    seconds; ``record``, where a list, gets a :class:`ChainRecord` a
    chain."""

    trainer: Any
    graphs: Dict[Tuple, _Graph] = field(default_factory=dict)
    captures: List[Dict[str, Any]] = field(default_factory=list)
    record: Optional[List[ChainRecord]] = None
    stream: Any = None
    pool: Any = None

    def _host_counters(self):
        """(holder, attr) of the host mirrors of the counters a step
        advances on the device."""
        st = self.trainer.state
        out = [(st, "step"), (st.opt_state, "count")]
        if st.pose_opt_state is not None:
            out.append((st.pose_opt_state, "count"))
        return out

    def _bindings(self) -> Tuple[int, ...]:
        """Where every buffer a captured step reads lives."""
        tr = self.trainer
        st = tr.state
        tensors = list(checkpoint.state_tensors(st).values())
        tensors += [st.step_t, st.opt_state.count_t, tr.aabb]
        if st.pose_opt_state is not None:
            tensors.append(st.pose_opt_state.count_t)
        tensors += [tr.scene_arrays[k] for k in sorted(tr.scene_arrays)]
        return tuple(t.data_ptr() for t in tensors)

    def _args(self):
        tr = self.trainer
        return (tr.field, tr.state, tr.scene_arrays, tr.aabb,
                tr.batch_generator)

    def run(self, n: int) -> Dict[str, Any]:
        """n train steps at the Trainer's current key: the host work first
        (the device counters set from the host ones), then the replays.
        Returns the last step's metrics."""
        tr = self.trainer
        step = tr._train_step
        step.prepare(tr.state)
        key = (tr.num_rays, tr._point_budget)
        bindings = self._bindings()
        entry = self.graphs.get(key)
        if not self.graphs:    # the pool lives as long as a graph in it
            self.pool = None
        replays = n
        if entry is None or entry.bindings != bindings:
            entry, metrics = self._capture(key, bindings, step)
            replays = n - 1
            if replays == 0:   # the eager step was the chain
                return metrics
        start = end = None
        if self.record is not None:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        for _ in range(replays):
            entry.graph.replay()
        if end is not None:
            end.record()
            self.record.append(ChainRecord(replays, start, end, key))
        for holder, attr in self._host_counters():
            setattr(holder, attr, getattr(holder, attr) + replays)
        return {k: v.clone() if torch.is_tensor(v) else v
                for k, v in entry.metrics.items()}

    def _capture(self, key, bindings, step):
        """One eager step on the capture stream, then the capture of the
        next (which runs nothing) into the shared pool, which drops every
        other graph -> (the graph, the eager step's metrics)."""
        tr = self.trainer
        if self.stream is None:
            self.stream = torch.cuda.Stream(device=tr.device)
        s = self.stream
        s.wait_stream(torch.cuda.current_stream(tr.device))
        with torch.cuda.stream(s):
            warm = step.device_step(*self._args())
        torch.cuda.current_stream(tr.device).wait_stream(s)
        counters = self._host_counters()
        before = [getattr(h, a) for h, a in counters]
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(tr.batch_generator)
        t0 = time.perf_counter()
        try:
            with torch.cuda.graph(graph, pool=self.pool, stream=s):
                metrics = step.device_step(*self._args())
        except Exception as exc:
            raise RuntimeError(
                f"raw_ngp_torch: the train step at key (num_rays, "
                f"point_budget) {key} could not be captured in a CUDA "
                f"graph: {exc}") from exc
        finally:
            for (h, a), v in zip(counters, before):
                setattr(h, a, v)
        seconds = time.perf_counter() - t0
        if self.pool is None:
            self.pool = graph.pool()
        self.captures.append({"key": list(key), "seconds": seconds,
                              "step": tr.state.step})
        entry = _Graph(graph, metrics, bindings)
        self.graphs = {key: entry}
        return entry, warm
