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

On a mesh (``mesh=``, a ``repro_torch.launch.mesh.Mesh``; the JAX
package's ``Trainer`` binds one too) every leaf of the params, the moments
and the error feedback is this rank's block, placed by
``fsdp_specs(specs())`` (``specs()`` alone without ``cfg.fsdp``): the
state takes 1/|mesh| of its bytes per rank, leaves that nothing divides
left whole.  ``init_state`` draws each part as the one-device init does
and keeps its blocks.  A step takes the global batch, and each rank runs
its data index's rows of each micro-batch, with the compute split along
"model" as the JAX package's specs name it (``models.sharding``): the
residual stream holds this rank's block of the sequence, each block's
attention runs on this rank's query heads and its FFN on its d_ff
columns, the row-parallel sums meet in a reduce-scatter.  The embedding,
head and norms are gathered whole at the step's start, each block's
params inside the block's checkpoint, whole or on this rank's range (so
the backward gathers them again).  The loss divides by the global
batch's valid labels, so the ranks' gradients sum to the global batch's:
the gather's backward sums a leaf's gradient over the data axes and
"model" (over the data axes alone for a leaf gathered on its own block
along "model") and cuts it to this rank's block.  The global norm, the
compression's scales and the reported metrics sum over every rank, each
replica counted once; AdamW then updates the blocks.  The mesh step runs
eagerly (no captured graph).
"""
from __future__ import annotations

import dataclasses
import gc
import math
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch import resolve_device, tree
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import sharding
from repro_torch.optim import adamw, compress as compress_lib
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


class StateLayout(NamedTuple):
    """Where a train state's leaves live on a mesh, for the checkpoint:
    ``placement(path)`` of a state path ("params/...", "opt/mu/...",
    "opt/step", ...; None: whole on every rank)."""
    mesh: Any
    placement: Callable[[str], Optional[mesh_lib.Placement]]


class Trainer:
    """Binds (model, optimizer, device or mesh) into train steps."""

    def __init__(self, model, optimizer: AdamW,
                 cfg: TrainerConfig = TrainerConfig(), device="cuda",
                 graph: bool = True, mesh: Optional[mesh_lib.Mesh] = None):
        self.model = model
        self.opt = optimizer
        self.cfg = cfg
        self.device = resolve_device(device)
        self.mesh = mesh
        if mesh is not None and mesh.device != self.device:
            raise ValueError(f"Trainer(device={self.device}) on a mesh of "
                             f"{mesh.device}")
        # the layer lists whose leaves are one stacked leaf each in JAX
        self.stacked = model.stacked
        self.graph = graph and self.device.type == "cuda" and mesh is None
        self._graphs: Dict[Any, _StepGraph] = {}
        self.captures = 0
        self._placements: Dict[str, mesh_lib.Placement] = {}
        self._state_placements: Dict[str, Any] = {}
        if mesh is not None:
            self._specs = dict(tree.leaves_with_paths(model.specs()))
            self._layers = {k: len(v)
                            for k, v in model.layer_blocks().items()}

    # -- the mesh ---------------------------------------------------------------

    @property
    def rank(self) -> int:
        return 0 if self.mesh is None else self.mesh.rank

    @property
    def layout(self) -> Optional[StateLayout]:
        """The state's layout for ``Checkpointer`` (None off a mesh)."""
        if self.mesh is None:
            return None
        return StateLayout(self.mesh, self.state_placement)

    def param_spec(self, path: str, shape) -> mesh_lib.P:
        """The spec of the param at ``path`` (whole ``shape``): ``specs()``'s,
        with FSDP over the data axes when ``cfg.fsdp``, chosen on the JAX
        package's leaf (a per-layer leaf of a stacked list has the layer
        axis before it; where FSDP picks that axis the per-layer leaf
        stays whole along "data")."""
        spec = self._specs[path]
        if not getattr(self.model.cfg, "fsdp", True):
            return spec
        key = path.split("/")[0]
        if key in self.stacked:
            full = mesh_lib.fsdp_spec(mesh_lib.P(None, *spec),
                                      (self._layers[key],) + tuple(shape),
                                      self.mesh)
            return mesh_lib.P(*tuple(full)[1:])
        return mesh_lib.fsdp_spec(spec, shape, self.mesh)

    def placement(self, path: str, shape=None) -> mesh_lib.Placement:
        """The ``Placement`` of the param at ``path``; the first call for a
        path gives its whole ``shape``."""
        pl = self._placements.get(path)
        if pl is None:
            pl = self._placements[path] = mesh_lib.Placement(
                self.mesh, self.param_spec(path, shape), shape)
        return pl

    def state_placement(self, path: str) -> Optional[mesh_lib.Placement]:
        """The ``Placement`` of a train state's leaf (the JAX package's
        state specs: the moments and error feedback take their params')."""
        if not self._state_placements:      # built once placed
            by_param = dict(self._placements)   # keys are the param paths
            self._state_placements = dict(tree.leaves_with_paths(
                TrainState(by_param, self.opt.state_specs(by_param),
                           by_param if self.cfg.compress_grads else None)))
        pl = self._state_placements[path]
        return pl if isinstance(pl, mesh_lib.Placement) else None

    def _keep(self, prefix: str, part: Any) -> Any:
        """This rank's blocks of a freshly drawn part of the params."""
        return tree.unflatten(part, [
            self.placement(f"{prefix}/{p}", t.shape).shard(t)
            for p, t in tree.leaves_with_paths(part)])

    def _param_placements(self, params: Any):
        return [self._placements[p] for p, _ in tree.leaves_with_paths(params)]

    def whole_params(self, params: Any) -> Any:
        """The whole params from every rank's blocks (collectives: every
        rank calls it); the params themselves off a mesh."""
        if self.mesh is None:
            return params
        return tree.unflatten(params, [
            pl.whole(t) for pl, t in zip(self._param_placements(params),
                                         tree.leaves(params))])

    def _global_norm(self, grads: Any) -> torch.Tensor:
        """``adamw.global_norm`` of the whole gradients from every rank's
        blocks: each rank's leaf norms, gathered, each block counted
        once."""
        norms = adamw.leaf_norms(grads)
        mesh = self.mesh
        if mesh.size > 1:
            every = mesh.all_gather(norms[None], None, 0)   # (ranks, leaves)
            pls = self._param_placements(grads)
            ranks = mesh.size
            # each leaf's owned blocks, leaf by leaf in rank order (indices
            # made on the host: no data-dependent shape)
            owned = [j * ranks + r for j, pl in enumerate(pls)
                     for r in range(ranks) if pl.owns(mesh.coords[r])]
            norms = every.T.reshape(-1)[torch.tensor(owned,
                                                     device=norms.device)]
        return torch.linalg.vector_norm(norms)

    def _compress_scales(self, grads: Any, ef: Any):
        mesh = self.mesh
        pls = self._param_placements(grads)
        return compress_lib.sharded_scales(
            grads, ef, self.stacked,
            [pl.owns(mesh.coords[mesh.rank]) for pl in pls],
            [math.prod(pl.shape) for pl in pls],
            lambda t: mesh.all_reduce(t, None))

    # -- state ------------------------------------------------------------------

    def init_state(self) -> TrainState:
        """Params from ``torch.Generator(device).manual_seed(seed)``, zero
        moments at step 0, and zero error feedback with compression.  On a
        mesh, this rank's blocks of the one-device init's params: each
        part is drawn whole, in the one-device order, and cut to its
        blocks before the next part draws."""
        gen = torch.Generator(device=self.device).manual_seed(self.cfg.seed)
        params = self.model.init(gen, None if self.mesh is None
                                 else self._keep)
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
        gives it.  On a mesh: this rank's rows of ``batch``, and the
        gradients of this rank's blocks of ``params``."""
        pairs = tree.leaves_with_paths(params)
        leaves = [p.detach().requires_grad_(True) for _, p in pairs]
        if self.mesh is None:
            loss, metrics = self.model.train_loss(
                tree.unflatten(params, leaves), batch)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        else:
            rows = mesh_lib.batch_spec(self.mesh, batch["tokens"].shape[0])
            use = []
            for (path, _), leaf in zip(pairs, leaves):
                pl = self._placements[path]
                # a layer's params are gathered where the layer runs,
                # whole or on this rank's range of the compute
                use.append(sharding.Gathered(leaf, pl.gather, pl)
                           if path.split("/")[0] in self._layers
                           else pl.gather(leaf))
            with sharding.activation_sharding(self.mesh,
                                              mesh_lib.data_axes(self.mesh)):
                loss, metrics = self.model.train_loss(
                    tree.unflatten(params, use),
                    {k: v[rows] for k, v in batch.items()})
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
        sharded = self.mesh is not None and self.mesh.size > 1
        with torch.no_grad():
            if sharded:
                # each rank's share of the global batch's metrics (its
                # data index's rows, its block of the sequence)
                for k in ("loss", "moe_aux", "tokens", "loss_total"):
                    metrics[k] = self.mesh.all_reduce(metrics[k].clone(),
                                                      None)
            if self.cfg.compress_grads:
                grads, new_ef = compress_lib.compress_tree(
                    grads, ef, self.stacked,
                    self._compress_scales(grads, ef) if sharded else None)
                if not donate:
                    ef = new_ef
                elif write:
                    torch._foreach_copy_(tree.leaves(ef),
                                         tree.leaves(new_ef))
            params, opt, om = self.opt.update(
                grads, state.opt, state.params, stacked=self.stacked,
                scalars=scalars, donate=donate, write=write,
                norm=None if self.mesh is None else self._global_norm(grads))
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
