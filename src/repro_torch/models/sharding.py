"""Sharding specs and the activation-sharding context (port of
``repro.models.sharding``): models stay mesh-agnostic, the trainer opts in.

``PartitionSpec`` (``P``) is the port's own counterpart of JAX's: one
entry per dimension, each None (whole), an axis name, or a tuple of axis
names.  It is a leaf of ``repro_torch.tree`` (not a tuple), so a spec tree
mirrors the param tree it describes.

``with activation_sharding(mesh, data_axes):`` is what the trainer's mesh
step runs the model's loss in.  The JAX package lets XLA place the
activations (``constrain`` emits ``with_sharding_constraint``); the port
splits the batch at the trainer and computes every activation whole along
"model", so ``constrain`` returns ``x`` itself, in a context or not, and
no model code calls it.  What the port's model does need on a data axis
wider than one, it asks of the context:
  * ``batch_sum`` — a count over the global batch (the loss's number of
    valid labels, the MoE's first choices per expert);
  * ``batch_gather`` — rows of every data index, in global row order (the
    MoE's expert choices, for capacity slots in global token order);
  * ``materialize`` — a layer's params gathered whole where the layer
    runs (``Gathered`` leaves: the port's just-in-time all-gather of
    FSDP-sharded params, which XLA inserts in the JAX package).
Outside a context, or on a data axis of one, each gives its argument back.

A rank's block of a leaf carries its ``launch.mesh.Placement``: ``place``
marks it, ``placement_of`` reads it, and ``rows_split`` says whether a
placed batch's rows are split over the data axes (``data_axes``); the
models' deploy faces on a mesh read them.

The context is the process's, not a thread's (JAX keeps it per thread):
a block's checkpoint recomputes the block inside the backward, which on
the card runs on autograd's own device thread, and the recomputation
must route and gather as the forward did.
"""
from __future__ import annotations

import contextlib
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch

from repro_torch import tree

# [the context in force]: (mesh, data axes), or None
_CTX: List[Optional[Tuple[Any, Tuple[str, ...]]]] = [None]


class PartitionSpec:
    """Per-dimension mesh axes of one leaf; compares by its entries."""
    __slots__ = ("entries",)

    def __init__(self, *entries):
        self.entries = tuple(entries)

    def __iter__(self):
        return iter(self.entries)

    def __len__(self) -> int:
        return len(self.entries)

    def __getitem__(self, i):
        return self.entries[i]

    def __eq__(self, other) -> bool:
        return isinstance(other, PartitionSpec) and \
            self.entries == other.entries

    def __hash__(self) -> int:
        return hash(self.entries)

    def __repr__(self) -> str:
        return f"P{self.entries!r}"


P = PartitionSpec


class Gathered:
    """A param leaf held as this rank's shard (``local``); ``gather(local)``
    gives the whole leaf, differentiably (its backward reduces the
    gradient to the shard)."""
    __slots__ = ("local", "gather")

    def __init__(self, local: torch.Tensor,
                 gather: Callable[[torch.Tensor], torch.Tensor]):
        self.local, self.gather = local, gather


@contextlib.contextmanager
def activation_sharding(mesh, data_axes: Sequence[str]):
    """Run model code on ``mesh`` with the global batch split over
    ``data_axes`` (``mesh``: ``repro_torch.launch.mesh.Mesh``)."""
    prev = _CTX[0]
    _CTX[0] = (mesh, tuple(data_axes))
    try:
        yield
    finally:
        _CTX[0] = prev


def current() -> Optional[Tuple[Any, Tuple[str, ...]]]:
    return _CTX[0]


def constrain(x, *axes):
    """JAX's activation constraint; the port's activations are whole along
    "model" and split over the data axes by the trainer: ``x`` itself."""
    return x


def batch_axes() -> Tuple[str, ...]:
    ctx = current()
    return ctx[1] if ctx else ("data",)


def _split_mesh():
    """The context's mesh when its data axes hold more than one index."""
    ctx = current()
    if ctx is None or ctx[0].data_size == 1:
        return None
    return ctx[0]


def batch_split() -> Tuple[int, int]:
    """(this rank's data index, the number of data indices) of the batch
    split in force; (0, 1) outside one."""
    mesh = _split_mesh()
    return (0, 1) if mesh is None else (mesh.data_index, mesh.data_size)


def batch_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the data indices (no gradient)."""
    mesh = _split_mesh()
    return t if mesh is None else mesh.all_reduce(t.detach().clone(),
                                                  batch_axes())


def batch_gather(t: torch.Tensor) -> torch.Tensor:
    """Every data index's ``t`` concatenated on dim 0 in data order: the
    global batch's rows (no gradient)."""
    mesh = _split_mesh()
    return t if mesh is None else mesh.all_gather(t.detach(), batch_axes(),
                                                  0)


def data_axes(mesh) -> Tuple[str, ...]:
    """The axes of ``mesh`` that split the batch, slow to fast."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def place(local: torch.Tensor, placement) -> torch.Tensor:
    """``local`` (this rank's block) marked with its ``placement`` (a
    ``launch.mesh.Placement``)."""
    local.placement = placement
    return local


def placement_of(t: torch.Tensor):
    pl = getattr(t, "placement", None)
    if pl is None:
        raise ValueError(f"a mesh face takes placed shards (place); got a "
                         f"tensor of shape {tuple(t.shape)} without a "
                         f"placement")
    return pl


def rows_split(mesh, t: torch.Tensor) -> bool:
    """Are the rows (dim 0) of placed ``t`` split over the data axes (the
    batch of a mesh face; unplaced rows are whole)?"""
    pl = getattr(t, "placement", None)
    return pl is not None and any(
        d == 0 and set(axes) <= set(data_axes(mesh)) for axes, d in pl.splits)


def materialize(params: Any) -> Any:
    """``params`` with each ``Gathered`` leaf gathered whole."""
    return tree.map(lambda t: t.gather(t.local)
                    if isinstance(t, Gathered) else t, params)
