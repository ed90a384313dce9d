"""The engine's steps as captured CUDA graphs: the port's counterpart of the
JAX engine's jitted steps (``repro.serve.engine`` ``_build_decode`` and
``_build_unified``) and of ``jax.jit(model.prefill_logits)``.

A step runs thousands of small kernels, and launching them one by one from
Python sets its wall time.  ``StepGraph`` captures one forward at fixed
shapes once and replays it: the inputs live in static buffers that every
call overwrites, the output is a static tensor that every replay
overwrites, and the state the forward updates in place (the caches) keeps
its addresses.  Sampling stays outside: a replay returns logits.

  capture   the first call copies its inputs in, runs the forward once on
            a side stream (each kernel's first launch sets its attributes
            there, and the caching allocator and cuBLAS warm up), puts the
            state back as it was, and captures the forward
  replay    every call copies its inputs in and replays the graph
  launches  the capture records the kernel wrappers' launch-count deltas,
            and every replay credits them (``kernels.credit_launches``),
            so ``kernels.launch_counts()`` still counts launches executed

On a card the graph is how the step runs: a capture that fails raises, and
nothing falls back to running the step eagerly.  On the CPU, which a
caller asks for explicitly, the same object runs the forward on the same
static buffers (there is nothing to capture), so the CPU tests drive the
buffer plumbing and the counters.

``StepGraphs`` is an engine's set: graphs keyed by kind and shape, one
memory pool shared by all of them (one replays at a time, and each
output is read before the next replay), and captures counted by kind as
the JAX engine counts its traces.
"""
from __future__ import annotations

import gc
import math
import time
from typing import Callable, Dict, Hashable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import kernels, resolve_device

__all__ = ["StepGraph", "StepGraphs", "cache_tensors", "pool_bytes",
           "prefill_logits_graph"]

KINDS = ("unified", "decode", "spec")   # the JAX engine's ``_compiles`` keys


def cache_tensors(caches) -> List[torch.Tensor]:
    """Every tensor of per-layer caches (``KVCache`` / ``PagedKVCache``
    parts and the recurrent carries, ``MambaCache`` / ``XLSTMCache``):
    the state an engine step updates in place.  Every step updates each
    of them in place (``copy_``, indexed stores, ``masked_fill_``), so a
    replay reads and writes the engine's own tensors."""
    return [t for layer in caches for part in layer.values()
            for t in part if isinstance(t, torch.Tensor)]


class StepGraph:
    """One forward at fixed shapes, captured at its first call.

    ``forward(**inputs)`` returns a tensor and reads its inputs from the
    static buffers ``self.inputs`` ({name: int64 tensor of ``shapes[name]``},
    views of one device buffer filled by one copy per call); ``state`` is
    every tensor it updates in place, put back after the warm-up run.
    Call with {name: numpy array or tensor}; the result is the static
    output, valid until the next call of any graph of the same pool."""

    def __init__(self, forward: Callable[..., torch.Tensor],
                 shapes: Dict[str, Tuple[int, ...]], *,
                 device: torch.device, pool=None,
                 state: Sequence[torch.Tensor] = ()):
        self.forward = forward
        self.device = device
        self._pool = pool
        self._state = list(state)
        sizes = {n: math.prod(s) for n, s in shapes.items()}
        total = sum(sizes.values())
        self._buf = torch.zeros(total, dtype=torch.int64, device=device)
        self._host = torch.zeros(total, dtype=torch.int64,
                                 pin_memory=device.type == "cuda")
        host = self._host.numpy()
        self.inputs: Dict[str, torch.Tensor] = {}
        self._views: Dict[str, np.ndarray] = {}
        off = 0
        for name, shape in shapes.items():
            n = sizes[name]
            self.inputs[name] = self._buf[off:off + n].view(shape)
            self._views[name] = host[off:off + n].reshape(shape)
            off += n
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.output: Optional[torch.Tensor] = None
        self.launches: Optional[Dict[str, int]] = None  # per run
        self.capture_s = 0.0

    @torch.inference_mode()
    def __call__(self, **values) -> torch.Tensor:
        on_host = {n: v for n, v in values.items()
                   if not isinstance(v, torch.Tensor)}
        if on_host:
            # the host buffer is free: every caller reads the previous
            # call's output on the host before it calls again
            for name, v in on_host.items():
                self._views[name][...] = v
            self._buf.copy_(self._host, non_blocking=True)
        for name, v in values.items():
            if name not in on_host:
                self.inputs[name].copy_(v)
        if self.device.type != "cuda":
            before = kernels.launch_counts()
            out = self.forward(**self.inputs)
            if self.launches is None:
                self.launches = _delta(before, kernels.launch_counts())
            return out
        if self.graph is None:
            self._capture()
        self.graph.replay()
        kernels.credit_launches(self.launches)
        return self.output

    def _capture(self) -> None:
        t0 = time.perf_counter()
        dev = self.device
        saved = [t.clone() for t in self._state]
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self.forward(**self.inputs)
            for t, s in zip(self._state, saved):
                t.copy_(s)
        torch.cuda.current_stream(dev).wait_stream(side)
        del saved
        graph = torch.cuda.CUDAGraph()
        before = kernels.launch_counts()
        # a graph that the collector frees while this one is captured
        # destroys itself on the device, which invalidates the capture:
        # collect first, and not during the capture
        gc.collect()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=self._pool):
                out = self.forward(**self.inputs)
        finally:
            gc.enable()
        self.launches = _delta(before, kernels.launch_counts())
        # the capture recorded the launches and executed none of them
        kernels.credit_launches({n: -c for n, c in self.launches.items()})
        self.graph, self.output = graph, out
        torch.cuda.synchronize(dev)
        self.capture_s = time.perf_counter() - t0


def _delta(before: Dict[str, int], after: Dict[str, int]) -> Dict[str, int]:
    return {n: after[n] - before[n] for n in after if after[n] != before[n]}


class StepGraphs:
    """An engine's captured steps.  ``get`` returns the graph of a kind and
    key, building it from ``build()`` = (forward, shapes, state), and
    counting one capture of that kind, on first use; keys carry every
    shape the step depends on, as a jit's cache does.  ``upload`` copies
    host arrays into fixed device tensors (the block tables) through
    pinned staging buffers."""

    def __init__(self, device: torch.device):
        self.device = device
        self.pool = (torch.cuda.graph_pool_handle()
                     if device.type == "cuda" else None)
        self.graphs: Dict[Tuple[str, Hashable], StepGraph] = {}
        self.captures = {k: 0 for k in KINDS}
        self._staging: Dict[tuple, torch.Tensor] = {}

    def get(self, kind: str, key: Hashable,
            build: Callable[[], tuple]) -> StepGraph:
        g = self.graphs.get((kind, key))
        if g is None:
            forward, shapes, state = build()
            g = StepGraph(forward, shapes, device=self.device,
                          pool=self.pool, state=state)
            self.graphs[(kind, key)] = g
            self.captures[kind] += 1
        return g

    @property
    def capture_s(self) -> float:
        """Seconds spent warming up and capturing, all graphs together."""
        return sum(g.capture_s for g in self.graphs.values())

    def pool_bytes(self) -> int:
        """Device bytes the graphs' shared pool has reserved; 0 on the
        CPU."""
        return 0 if self.pool is None else pool_bytes(self.pool)

    def upload(self, dst: torch.Tensor, a: np.ndarray) -> None:
        """``dst[...] = a`` in place, through a pinned staging buffer of
        its own (asynchronous on a card; the engine reads every
        iteration's tokens on the host before the next one stages)."""
        key = (dst.data_ptr(), tuple(dst.shape), dst.dtype)
        host = self._staging.get(key)
        if host is None:
            host = torch.empty(dst.shape, dtype=dst.dtype,
                               pin_memory=dst.is_cuda)
            self._staging[key] = host
        host.numpy()[...] = a
        dst.copy_(host, non_blocking=True)


def pool_bytes(pool) -> int:
    """Device bytes a graph memory pool has reserved: its peak, since the
    segments of a pool whose graphs live are never returned."""
    pool = tuple(pool)
    return sum(s["total_size"] for s in torch.cuda.memory_snapshot()
               if tuple(s.get("segment_pool_id", ())) == pool)


def prefill_logits_graph(model, dparams, batch: int, seq: int, *,
                         device="cuda") -> StepGraph:
    """``model.prefill_logits`` at a fixed (batch, seq) as one captured
    graph (the counterpart of ``jax.jit(model.prefill_logits)``): call it
    with ``tokens=`` a (batch, seq) array or tensor; it returns the
    static (batch, seq, V) logits."""
    dev = resolve_device(device)
    return StepGraph(
        lambda tokens: model.prefill_logits(dparams, tokens, device=dev),
        {"tokens": (batch, seq)}, device=dev)
