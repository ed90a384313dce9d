"""Mesh construction and sharding specs on torch.distributed (port of
``repro.launch.mesh``): the (data, model) host mesh, the production mesh
of the dry run, FSDP specs, batch rows, and per-leaf placements.

``make_host_mesh(model_axis, device)`` joins the process group (nccl for
a CUDA device, gloo for the CPU; torchrun's environment when it is set,
else a world of one rank) and lays a ``DeviceMesh`` of (world /
model_axis, model_axis) named ("data", "model") over its ranks.  The
port's ``Mesh`` wraps it with what the trainer asks of a mesh: each
rank's index on each axis, and the collectives (all-gather, all-reduce,
reduce-scatter, all-to-all, barrier) it runs, counted in
``Mesh.collectives`` and in the dry run's census (``repro_torch.census``)
by the bytes of their whole-sized side (an all-gather's result, a
reduce-scatter's input: about what a rank receives or sends; an
all-reduce's or all-to-all's tensor), once a call: a call over several
axes runs one collective per axis that holds more than one index, and
counts as one, as ``AbstractMesh``'s does.

``make_production_mesh(multi_pod)`` is the dry run's mesh: an
``AbstractMesh`` of (16, 16) ("data", "model") = 256 ranks, or (2, 16, 16)
("pod", "data", "model") = 512, seen from rank 0 on the meta device.  It
joins no process group: its collectives return meta tensors of their
results' shapes and count their bytes.  ``param_shapes`` draws a model's
params on the meta device (shapes and dtypes, nothing allocated).

A leaf's ``Placement`` (what ``named`` gives per leaf, the port's
``NamedSharding``) holds its spec and whole shape: a dimension whose spec
names mesh axes (one, or several such as FSDP's ("pod", "data")) is split
over them where it divides by their sizes' product (a dimension that does
not divide stays whole, where the JAX package would pad).  ``shard`` cuts
this rank's block; ``gather`` puts the whole leaf back together over the
axes it is split on, and ``gather_range`` puts together this rank's range
of one dim (the compute split along "model": a head range, d_ff columns).
The backward takes the gradient to this rank's block by one rule
(``_reduce``), a function of the leaf's placement and of whether its
compute is split: a leaf gathered whole was applied by every rank to its
own rows and heads only, so its gradient is summed over the data axes and
"model"; a leaf gathered on exactly its own block along "model" (a range
that is this rank's block for every rank: a head range, d_ff columns, an
expert-parallel stack's experts) holds the whole gradient of that block
already, and is summed over the data axes only.
"""
from __future__ import annotations

import math
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import census, resolve_device, tree
from repro_torch.models.nn import stack_spec
from repro_torch.models.sharding import (  # noqa: F401
    P, PartitionSpec, data_axes, from_words, place, placement_of,
    rows_split, to_words)

Params = Any
AXES = ("data", "model")
Axes = Union[None, str, Sequence[str]]


def world_size() -> int:
    """The process group's size, or the one torchrun's environment
    promises, or 1."""
    if dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", 1))


def init_world(device) -> None:
    """Join the process group for ``device`` once: nccl for CUDA, gloo for
    the CPU; from torchrun's environment (``RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR``) when it is set, else a world of this process alone.
    A group already joined must have the device's backend."""
    dev = resolve_device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if dist.is_initialized():
        if dist.get_backend() != backend:
            raise ValueError(f"the process group runs {dist.get_backend()}"
                             f", but device {dev} needs {backend}")
        return
    if "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _MeshBase:
    """What a mesh is to the port: named axes, this rank's index on each,
    and collectives over axes (``axis``: one name, several, or None for
    every axis)."""
    axis_names: Tuple[str, ...]
    shape: Dict[str, int]
    rank: int
    device: torch.device

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self.shape}, device={self.device})"

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    @property
    def data_size(self) -> int:
        return data_size(self)

    @property
    def coords(self) -> Dict[int, Tuple[int, ...]]:
        """Every rank's index on each axis (in ``axis_names`` order)."""
        return self._coords

    def index(self, axis: str) -> int:
        """This rank's index along ``axis``."""
        return self.coords[self.rank][self.axis_names.index(axis)]

    @property
    def data_index(self) -> int:
        """This rank's index over the data axes (row-major)."""
        return block_index(self, data_axes(self))

    def _axes(self, axis: Axes) -> Tuple[str, ...]:
        if axis is None:
            return self.axis_names
        return (axis,) if isinstance(axis, str) else tuple(axis)

    def _width(self, axis: Axes) -> int:
        return math.prod(self.shape[a] for a in self._axes(axis))

    def placement(self, spec: P, shape: Sequence[int]) -> "Placement":
        """The ``Placement`` of a whole leaf of ``shape`` laid out by
        ``spec`` on this mesh (for the models, which import nothing of
        ``launch``)."""
        return Placement(self, spec, shape)


def block_index(mesh, axes: Sequence[str]) -> int:
    """This rank's index over ``axes`` taken together, row-major (the
    block of a dim split over them)."""
    i = 0
    for a in axes:
        i = i * mesh.shape[a] + mesh.index(a)
    return i


class Mesh(_MeshBase):
    """A ``DeviceMesh`` and the collectives run on it."""

    def __init__(self, device_mesh, device: torch.device):
        self.device_mesh = device_mesh
        self.device = device
        self.axis_names = tuple(device_mesh.mesh_dim_names)
        self.shape = dict(zip(self.axis_names, device_mesh.shape))
        self.rank = dist.get_rank()
        self.collectives = 0
        ranks = device_mesh.mesh.cpu().numpy()
        self._coords = {int(ranks[ix]): tuple(int(i) for i in ix)
                        for ix in np.ndindex(ranks.shape)}

    def _group(self, axis: Optional[str]):
        return None if axis is None else self.device_mesh.get_group(axis)

    def all_gather(self, x: torch.Tensor, axis: Axes,
                   dim: int) -> torch.Tensor:
        """Every index's ``x`` along ``axis`` (None: the whole world; several
        axes: row-major), concatenated on ``dim`` in index order."""
        if self._width(axis) == 1:
            return x
        for a in ([None] if axis is None else
                  reversed([a for a in self._axes(axis)
                            if self.shape[a] > 1])):
            x = x.contiguous()
            parts = [torch.empty_like(x) for _ in range(self._width(a))]
            dist.all_gather(parts, x, group=self._group(a))
            x = torch.cat(parts, dim=dim)
        self.collectives += 1
        census.collective("all-gather", _nbytes(x))
        return x

    def all_reduce(self, x: torch.Tensor, axis: Axes) -> torch.Tensor:
        """``x`` summed over ``axis`` (None: the whole world), in place."""
        if self._width(axis) == 1:
            return x
        for a in ([None] if axis is None else
                  [a for a in self._axes(axis) if self.shape[a] > 1]):
            dist.all_reduce(x, group=self._group(a))
        self.collectives += 1
        census.collective("all-reduce", _nbytes(x))
        return x

    def reduce_scatter(self, x: torch.Tensor, axis: Axes,
                       dim: int) -> torch.Tensor:
        """``x`` summed over ``axis`` and cut to this rank's block of ``dim``
        (several axes: row-major, as ``all_gather`` puts them together)."""
        if self._width(axis) == 1:
            return x
        sent = _nbytes(x)
        for a in [a for a in self._axes(axis) if self.shape[a] > 1]:
            parts = [p.contiguous() for p in x.chunk(self.shape[a], dim)]
            x = torch.empty_like(parts[0])
            dist.reduce_scatter(x, parts, group=self._group(a))
        self.collectives += 1
        census.collective("reduce-scatter", sent)
        return x

    def all_to_all(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """``x`` (n, ...), n the size of ``axis``: row j goes to index j,
        and row j of the result is what index j sent this rank."""
        if self.shape[axis] == 1:
            return x
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x.contiguous(), group=self._group(axis))
        self.collectives += 1
        census.collective("all-to-all", _nbytes(out))
        return out

    def barrier(self) -> None:
        if self.size > 1:
            dist.barrier()
            self.collectives += 1


class AbstractMesh(_MeshBase):
    """A mesh of ``shape`` (axis name -> size) seen from rank 0 on the meta
    device, with no process group (the dry run's; JAX's
    ``jax.sharding.AbstractMesh``): each collective gives a meta tensor of
    its result's shape and counts the bytes of its whole-sized side (a
    reduce-scatter's input, any other's result), once per call."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str]):
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(n) for n in shape)))
        self.device = torch.device("meta")
        self.rank = 0
        self.collectives = 0
        self._coords = {r: ix for r, ix in
                        enumerate(np.ndindex(tuple(self.shape.values())))}

    def all_gather(self, x: torch.Tensor, axis: Axes,
                   dim: int) -> torch.Tensor:
        n = self._width(axis)
        if n == 1:
            return x
        shape = list(x.shape)
        shape[dim] *= n
        out = x.new_empty(shape, device=x.device)
        self.collectives += 1
        census.collective("all-gather", _nbytes(out))
        return out

    def all_reduce(self, x: torch.Tensor, axis: Axes) -> torch.Tensor:
        if self._width(axis) > 1:
            self.collectives += 1
            census.collective("all-reduce", _nbytes(x))
        return x

    def reduce_scatter(self, x: torch.Tensor, axis: Axes,
                       dim: int) -> torch.Tensor:
        n = self._width(axis)
        if n == 1:
            return x
        shape = list(x.shape)
        shape[dim] //= n
        out = x.new_empty(shape, device=x.device)
        self.collectives += 1
        census.collective("reduce-scatter", _nbytes(x))
        return out

    def all_to_all(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        if self.shape[axis] == 1:
            return x
        out = torch.empty_like(x)
        self.collectives += 1
        census.collective("all-to-all", _nbytes(out))
        return out

    def barrier(self) -> None:
        if self.size > 1:
            self.collectives += 1


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    """Single pod: (16, 16) ("data", "model") = 256 ranks.  Multi-pod:
    (2, 16, 16) ("pod", "data", "model") = 512, "pod" the slow axis that
    carries only data-parallel traffic (the JAX package's meshes)."""
    if multi_pod:
        return AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    return AbstractMesh((16, 16), ("data", "model"))


def param_shapes(init_fn, *args, **kwargs) -> Params:
    """``init_fn(*args, device="meta")``: the params' shapes and dtypes as
    meta tensors, nothing allocated (JAX's ``eval_shape``; a generator
    among ``args`` is a CPU one: a meta generator cannot be made).  A
    census in force does not count it."""
    with census.suspended():
        return init_fn(*args, device=torch.device("meta"), **kwargs)


# ---------------------------------------------------------------------------
# Placed shards: a rank's block of a leaf, carrying its Placement (the
# port's counterpart of a JAX array with its sharding; ``place``,
# ``placement_of`` and ``rows_split`` live in ``models.sharding``, which the
# models' mesh faces read)
# ---------------------------------------------------------------------------


def shard_tree(mesh, specs: Params, whole: Params) -> Params:
    """This rank's placed blocks of the whole leaves ``whole`` by
    ``specs``."""
    def one(spec, t):
        pl = Placement(mesh, spec, t.shape)
        return place(pl.shard(t), pl)
    return tree.map(one, specs, whole)


def make_host_mesh(model_axis: int = 1, device="cuda") -> Mesh:
    """A (world // model_axis, model_axis) mesh named ("data", "model")
    over the process group's ranks (joined here if need be; see
    ``init_world``)."""
    dev = resolve_device(device)
    world = world_size()
    if model_axis < 1 or world % model_axis:
        raise ValueError(f"the world size ({world}) is not divisible by "
                         f"the model axis ({model_axis})")
    if dev.type == "cuda":
        # this process's card, before the communicator is made
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    init_world(dev)
    from torch.distributed.device_mesh import init_device_mesh
    return Mesh(init_device_mesh(dev.type, (world // model_axis, model_axis),
                                 mesh_dim_names=AXES), dev)


def data_size(mesh) -> int:
    return int(math.prod(mesh.shape[a] for a in data_axes(mesh)))


def batch_spec(mesh, rows: int) -> slice:
    """This rank's rows of a global batch of ``rows`` (dim 0 split over
    the data axes; ranks along "model" take the same rows)."""
    n = data_size(mesh)
    if rows % n:
        raise ValueError(f"a global batch of {rows} rows does not split "
                         f"over {n} data indices")
    i = mesh.data_index
    return slice(i * rows // n, (i + 1) * rows // n)


# ---------------------------------------------------------------------------
# FSDP / ZeRO: spread params (and so the moments) over the data axes on top
# of their model axis.
# ---------------------------------------------------------------------------


def fsdp_spec(spec: P, shape: Sequence[int], mesh) -> P:
    """One leaf of ``fsdp_specs``."""
    daxes = data_axes(mesh)
    dtotal = data_size(mesh)
    dims = tuple(shape)
    if len(dims) < 2 or dtotal == 1:
        return spec
    entries = list(spec) + [None] * (len(dims) - len(spec))
    best, best_size = -1, 0
    for i, (e, n) in enumerate(zip(entries, dims)):
        if e is None and n % dtotal == 0 and n > best_size:
            best, best_size = i, n
    if best >= 0:
        entries[best] = daxes if len(daxes) > 1 else daxes[0]
    return P(*entries)


def fsdp_specs(specs: Params, shapes: Params, mesh) -> Params:
    """For every >= 2-D leaf whose spec leaves a dim unsplit, split its
    largest unsplit dim that the data axes divide over them (JAX's rule;
    ``shapes``: a tree of anything with a ``shape``, such as tensors on
    the meta device)."""
    return tree.map(lambda s, x: fsdp_spec(s, x.shape, mesh), specs, shapes)


def stacked_specs(specs: Params, stacked: Sequence[str]) -> Params:
    """A port spec tree in the JAX package's layout: each per-layer list
    under a key of ``stacked`` (a model's ``stacked``) becomes its layers'
    one spec tree with a leading None (layer) entry, JAX's stacked leaf."""
    out = dict(specs)
    for key in stacked:
        layers = specs[key]
        if any(tree.leaves(layer) != tree.leaves(layers[0])
               for layer in layers):
            raise ValueError(f"the layers of {key!r} have different specs")
        out[key] = stack_spec(layers[0])
    return out


def named(mesh: Mesh, specs: Params, shapes: Params) -> Params:
    """Per-leaf ``Placement``s of ``specs`` on ``mesh`` (shapes as in
    ``fsdp_specs``)."""
    return tree.map(lambda s, x: Placement(mesh, s, x.shape), specs, shapes)


# ---------------------------------------------------------------------------
# Placements
# ---------------------------------------------------------------------------


class Placement:
    """Where one leaf lives on a mesh (see the module docstring)."""

    def __init__(self, mesh, spec: P, shape: Sequence[int]):
        self.mesh, self.spec, self.shape = mesh, spec, tuple(shape)
        # (axes, dim): the dim split over those axes taken together
        self.splits: List[Tuple[Tuple[str, ...], int]] = []
        self.dims: Dict[str, int] = {}      # axis -> the dim split over it
        for d, entry in enumerate(spec):
            axes = (() if entry is None else
                    (entry,) if isinstance(entry, str) else tuple(entry))
            axes = tuple(a for a in axes if mesh.shape[a] > 1)
            n = math.prod(mesh.shape[a] for a in axes)
            if axes and self.shape[d] % n == 0:
                self.splits.append((axes, d))
                self.dims.update({a: d for a in axes})

    def __repr__(self) -> str:
        return f"Placement({self.spec}, {self.shape}, split {self.dims})"

    def _width(self, axes: Sequence[str]) -> int:
        return math.prod(self.mesh.shape[a] for a in axes)

    @property
    def local_shape(self) -> Tuple[int, ...]:
        s = list(self.shape)
        for axes, d in self.splits:
            s[d] //= self._width(axes)
        return tuple(s)

    def span(self, dim: int) -> Tuple[int, int]:
        """[lo, hi) of this rank's block along ``dim`` of the whole leaf:
        its index over the axes that split the dim, row-major, or the
        whole dim where none does (a decode product's rows, words or
        experts, a ring's slots)."""
        dim %= len(self.shape)
        for axes, d in self.splits:
            if d == dim:
                n = self.shape[d] // self._width(axes)
                i = block_index(self.mesh, axes)
                return i * n, (i + 1) * n
        return 0, self.shape[dim]

    def owns(self, coords: Tuple[int, ...]) -> bool:
        """Is the block the rank at ``coords`` (its index on each axis)
        holds one the mesh counts once (replicas along an unsplit axis:
        index 0's)?"""
        return all(a in self.dims or coords[i] == 0
                   for i, a in enumerate(self.mesh.axis_names))

    def _cut(self, t: torch.Tensor, axes, d: int) -> torch.Tensor:
        n = t.shape[d] // self._width(axes)
        return t.narrow(d, block_index(self.mesh, axes) * n, n)

    def block(self, full: torch.Tensor, skip: Sequence[int] = ()
              ) -> torch.Tensor:
        """This rank's block of the whole leaf (a view; the dims of
        ``skip`` are taken as they are)."""
        for axes, d in self.splits:
            if d not in skip:
                full = self._cut(full, axes, d)
        return full

    def shard(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's block of the whole leaf, in memory of its own."""
        return self.block(full).clone(memory_format=torch.contiguous_format)

    def _gather(self, local: torch.Tensor, skip=()) -> torch.Tensor:
        for axes, d in self.splits:
            if d not in skip:
                local = self.mesh.all_gather(local, axes, d)
        return local

    def _reduce(self, grad: torch.Tensor, keep: Optional[int] = None
                ) -> torch.Tensor:
        """The gradient of what ``_gather`` gave -> this rank's block's:
        summed over the data axes and "model" (reduce-scatters along the
        dims those axes split, an all-reduce over the axes that split
        none), each split dim cut to this rank's block.  ``keep``: the dim
        split over "model" that was gathered on this rank's own block
        (``gather_range``); its gradient is that block's whole gradient,
        and "model" is not summed."""
        mesh = self.mesh
        summed = data_axes(mesh) + ("model",) * (keep is None and
                                                 "model" in mesh.shape)
        for axes, d in self.splits:
            if d != keep:
                grad = mesh.reduce_scatter(grad, axes, d)
        rest = tuple(a for a in summed
                     if a not in self.dims and mesh.shape[a] > 1)
        if rest:
            grad = mesh.all_reduce(grad.clone(), rest)
        return grad.contiguous()

    def whole(self, local: torch.Tensor, skip: Sequence[int] = (),
              signs: bool = False) -> torch.Tensor:
        """The whole leaf from this rank's block (no gradient); the dims of
        ``skip`` stay this rank's block.  ``signs``: sign(leaf), one bit a
        value on the wire."""
        if signs:
            return self._gather_signs(local.detach(), skip)
        return self._gather(local.detach(), skip)

    def _gather_signs(self, local: torch.Tensor, skip=()) -> torch.Tensor:
        """sign(leaf) (+-1, sign(0) = +1) put together as ``_gather`` puts
        the leaf, one bit a value on the wire: the signs of this rank's
        block packed, the words all-gathered over every axis at once (the
        splits' axes in dim order, row-major) and every block unpacked
        into its place."""
        splits = [(axes, d) for axes, d in self.splits if d not in skip]
        if not splits:
            return (local >= 0).to(local.dtype) * 2 - 1
        every = self.mesh.all_gather(
            to_words(local.reshape(1, -1), True),
            tuple(a for axes, _ in splits for a in axes), 0)
        counts = [self._width(axes) for axes, _ in splits]
        blocks = from_words(every, local.numel(), True, local.dtype)
        blocks = blocks.reshape(tuple(counts) + tuple(local.shape))
        # each split's count right before the dim it splits, then merged
        order, shape = [], []
        for i, n in enumerate(local.shape):
            for j, (_, d) in enumerate(splits):
                if d == i:
                    order.append(j)
            order.append(len(splits) + i)
            shape.append(n * math.prod(c for c, (_, d) in zip(counts, splits)
                                        if d == i))
        return blocks.permute(order).reshape(shape)

    def gather(self, local: torch.Tensor, signs: bool = False
               ) -> torch.Tensor:
        """The whole leaf, differentiably (see the module docstring).
        ``signs``: sign(leaf) through the straight-through estimator
        (``binarize.sign_ste``), one bit a value on the wire; its backward
        applies the estimator's mask to this rank's block of the reduced
        gradient."""
        if not self.dims and self.mesh.size == 1:
            if signs:
                from repro_torch.core import binarize
                return binarize.sign_ste(local)
            return local
        return _Gather.apply(local, self, None, signs)

    def gather_range(self, local: torch.Tensor, dim: int,
                     spans: Sequence[Tuple[int, int]], index: int,
                     signs: bool = False) -> torch.Tensor:
        """Rank ``index``'s span ``spans[index]`` of the leaf along ``dim``
        (``spans``: every "model" rank's, in rank order), differentiably
        (``signs`` as in ``gather``).  Where every span is its rank's
        block of a dim split over "model" alone, the leaf is gathered over
        its other axes only and its backward sums over the data axes;
        otherwise the whole leaf is gathered and narrowed, and the
        gradient summed over "model" too (ranks that read the same span,
        such as a KV head shared by query heads on two ranks, add their
        parts)."""
        m = self.mesh.shape.get("model", 1)
        n = self.shape[dim] // m
        own = [(r * n, (r + 1) * n) for r in range(m)]
        if dict(self.splits).get(("model",)) == dim and list(spans) == own:
            return _Gather.apply(local, self, dim, signs)
        lo, hi = spans[index]
        return self.gather(local, signs).narrow(dim, lo, hi - lo)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, local, placement, keep, signs):
        ctx.placement, ctx.keep, ctx.signs = placement, keep, signs
        skip = () if keep is None else (keep,)
        if signs:
            ctx.save_for_backward(local)
            return placement._gather_signs(local, skip)
        return placement._gather(local, skip)

    @staticmethod
    def backward(ctx, grad):
        grad = ctx.placement._reduce(grad, ctx.keep)
        if ctx.signs:
            local, = ctx.saved_tensors
            grad = grad * (local.abs() <= 1.0).to(grad.dtype)
        return grad, None, None, None
