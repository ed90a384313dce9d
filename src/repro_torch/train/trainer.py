"""The trainer (port of ``repro.train.trainer``): train steps with
gradient accumulation and optional 1-bit gradient compression.

One device, no mesh: the JAX package's ``Trainer`` binds a mesh and
shards params, optimizer state and batches over it; this one runs the
arithmetic of its jitted ``step`` (``value_and_grad`` of
``model.train_loss``, micro-batches summed in order, compression, then
``AdamW.update``) on ``device``.  CUDA by default; it raises without a
card, and ``device="cpu"`` runs the same steps eagerly on the CPU.

On the card the step is one captured CUDA graph (``graph=True``, the
default), where the JAX package jits it, and the step DONATES its state,
as the JAX package donates its state to the jitted step: the first step
of a batch shape adopts the state it is given as the graph's buffers (no
copy), warms up on a side stream without writing them, and captures
forward, backward and the update, which writes the new params, moments
and error feedback into those buffers group by group
(``AdamW.update(..., donate=True)``).  So the state a step is given and
the one it returns ARE the graph's buffers, overwritten by every later
step: copy a state to keep it, as a JAX caller must under donation
(``Checkpointer.save`` copies to the host at once).  A state that is not
the graph's is copied into its buffers first.  A replay computes what
the eager step computes; ``graph=False`` (and the CPU) runs the step
eagerly and functionally.
"""
from __future__ import annotations

import dataclasses
import gc
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch import resolve_device, tree
from repro_torch.optim import compress as compress_lib
from repro_torch.optim.adamw import AdamW, AdamWState

Params = Any


class TrainState(NamedTuple):
    params: Params
    opt: AdamWState
    ef: Optional[Params]          # 1-bit compression error feedback


@dataclasses.dataclass
class TrainerConfig:
    grad_accum: int = 1
    compress_grads: bool = False
    seed: int = 0


class Trainer:
    """Binds (model, optimizer, device) into train steps."""

    def __init__(self, model, optimizer: AdamW,
                 cfg: TrainerConfig = TrainerConfig(), device="cuda",
                 graph: bool = True):
        self.model = model
        self.opt = optimizer
        self.cfg = cfg
        self.device = resolve_device(device)
        # the layer lists whose leaves are one stacked leaf each in JAX
        self.stacked = model.stacked
        self.graph = graph and self.device.type == "cuda"
        self._graphs: Dict[Any, _StepGraph] = {}
        self.captures = 0

    # -- state ------------------------------------------------------------------

    def init_state(self) -> TrainState:
        """Params from ``torch.Generator(device).manual_seed(seed)``, zero
        moments at step 0, and zero error feedback with compression."""
        gen = torch.Generator(device=self.device).manual_seed(self.cfg.seed)
        params = self.model.init(gen)
        ef = (compress_lib.init_error_feedback(params)
              if self.cfg.compress_grads else None)
        return TrainState(params, self.opt.init(params), ef)

    def synchronize(self) -> None:
        """Wait for the device's queued work (JAX's block_until_ready)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- steps ------------------------------------------------------------------

    def batch_on_device(self, batch: Dict[str, Any]
                        ) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(v).to(self.device)
                for k, v in batch.items()}

    def loss_and_grads(self, params: Params, batch: Dict[str, torch.Tensor]
                       ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor],
                                  Params]:
        """(loss_total, metrics, grads) of ``model.train_loss``; a leaf the
        loss does not read (``bit_alpha`` in SPS mode) gets zeros, as JAX
        gives it."""
        leaves = [p.detach().requires_grad_(True)
                  for p in tree.leaves(params)]
        loss, metrics = self.model.train_loss(tree.unflatten(params, leaves),
                                              batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for g, p in zip(grads, leaves)]
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                tree.unflatten(params, grads))

    def train_step(self, state: TrainState, batch: Dict[str, Any]
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """One optimizer step on ``batch`` (numpy or tensors).  With
        ``grad_accum`` n the batch splits into n micro-batches of
        consecutive rows; their gradients are summed in order and divided
        by n, the reported loss_total is the mean and the other metrics
        are the last micro-batch's, as in the JAX package."""
        batch = self.batch_on_device(batch)
        if not self.graph:
            return self._step(state, batch)
        key = tuple((k, tuple(v.shape), v.dtype)
                    for k, v in sorted(batch.items()))
        g = self._graphs.get(key)
        if g is None:
            g = self._graphs[key] = _StepGraph(self, state, batch)
            self.captures += 1
        return g.run(state, batch)

    def _step(self, state: TrainState, batch: Dict[str, torch.Tensor],
              scalars=None, donate: bool = False, write: bool = True
              ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """The step's arithmetic on device tensors; ``scalars``,
        ``donate`` and ``write`` as in ``AdamW.update`` (the error
        feedback is donated with the rest)."""
        accum = self.cfg.grad_accum
        if accum > 1:
            gsum = [torch.zeros(p.shape, dtype=torch.float32,
                                device=p.device)
                    for p in tree.leaves(state.params)]
            lsum = torch.zeros((), device=self.device)
            for i in range(accum):
                mb = {k: v.reshape((accum, v.shape[0] // accum) +
                                   v.shape[1:])[i] for k, v in batch.items()}
                loss, metrics, g = self.loss_and_grads(state.params, mb)
                gsum = torch._foreach_add(gsum, tree.leaves(g))
                lsum = lsum + loss
            grads = tree.unflatten(state.params,
                                   torch._foreach_div(gsum, accum))
            metrics["loss_total"] = lsum / accum
        else:
            loss, metrics, grads = self.loss_and_grads(state.params, batch)
            metrics["loss_total"] = loss
        ef = state.ef
        with torch.no_grad():
            if self.cfg.compress_grads:
                grads, new_ef = compress_lib.compress_tree(grads, ef,
                                                           self.stacked)
                if not donate:
                    ef = new_ef
                elif write:
                    torch._foreach_copy_(tree.leaves(ef),
                                         tree.leaves(new_ef))
            params, opt, om = self.opt.update(
                grads, state.opt, state.params, stacked=self.stacked,
                scalars=scalars, donate=donate, write=write)
        metrics.update(om)
        return TrainState(params, opt, ef), metrics


class _StepGraph:
    """One batch shape's train step as a captured CUDA graph that donates
    its state (see the module docstring)."""

    WARMUP = 1

    def __init__(self, trainer: Trainer, state: TrainState,
                 batch: Dict[str, torch.Tensor]):
        self.trainer = trainer
        dev = trainer.device
        self.state = state                 # adopted: the graph's buffers
        self.batch = {k: v.clone() for k, v in batch.items()}
        self.scalars = tuple(torch.zeros((), device=dev) for _ in range(3))
        self._set_scalars(int(state.opt.step) + 1)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for _ in range(self.WARMUP):
                trainer._step(self.state, self.batch, self.scalars,
                              donate=True, write=False)
        torch.cuda.current_stream(dev).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        # a garbage collection inside the capture could free an older
        # graph, which a capturing stream does not allow: collect now,
        # and not during the capture; the warm-up's cached blocks go back
        # to the card, so the graph's own pool can take that memory
        gc.collect()
        torch.cuda.empty_cache()
        gc.disable()
        try:
            with torch.cuda.graph(self.graph):
                _, self.metrics = trainer._step(self.state, self.batch,
                                                self.scalars, donate=True)
        finally:
            gc.enable()

    @staticmethod
    def _buffers(state: TrainState):
        """The leaves a step writes: params, moments, error feedback."""
        return tree.leaves((state.params, state.opt.mu, state.opt.nu,
                            state.ef))

    def _set_scalars(self, step: int) -> None:
        for t, v in zip(self.scalars, self.trainer.opt.scalars(step)):
            t.fill_(v)

    def run(self, state: TrainState, batch: Dict[str, torch.Tensor]
            ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        keep = self._buffers(self.state)
        given = self._buffers(state)
        if any(a is not b for a, b in zip(keep, given)):
            torch._foreach_copy_(keep, given)
        for k, v in batch.items():
            self.batch[k].copy_(v)
        step = state.opt.step + 1
        self._set_scalars(int(step))
        self.graph.replay()
        self.state = self.state._replace(opt=self.state.opt._replace(
            step=step))
        return self.state, dict(self.metrics)
