"""Mesh construction and sharding specs on torch.distributed (port of
``repro.launch.mesh``): the (data, model) host mesh, FSDP specs, batch
rows, and per-leaf placements.

``make_host_mesh(model_axis, device)`` joins the process group (nccl for
a CUDA device, gloo for the CPU; torchrun's environment when it is set,
else a world of one rank) and lays a ``DeviceMesh`` of (world /
model_axis, model_axis) named ("data", "model") over its ranks.  The
port's ``Mesh`` wraps it with what the trainer asks of a mesh: each
rank's index on each axis, and the collectives (all-gather, all-reduce,
barrier) it runs, counted in ``Mesh.collectives``.

A leaf's ``Placement`` (what ``named`` gives per leaf, the port's
``NamedSharding``) holds its spec and whole shape: a dimension whose spec
names a mesh axis is split over that axis where it divides by the axis'
size (a dimension that does not divide stays whole, where the JAX package
would pad).  ``shard`` cuts this rank's block; ``gather`` puts the whole
leaf back together over the axes it is split on, and its backward takes
the whole gradient to this rank's block: summed over the data axis (each
data index computed it from its own rows), cut along "model" (the ranks
along "model" computed the same rows).

``make_production_mesh`` and ``param_shapes`` belong to the dry run and
are not ported yet.
"""
from __future__ import annotations

import math
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch import resolve_device, tree
from repro_torch.models.nn import stack_spec
from repro_torch.models.sharding import P, PartitionSpec  # noqa: F401

Params = Any
AXES = ("data", "model")


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


class Mesh:
    """A (data, model) ``DeviceMesh`` and the collectives run on it."""

    def __init__(self, device_mesh, device: torch.device):
        self.device_mesh = device_mesh
        self.device = device
        self.axis_names: Tuple[str, ...] = tuple(device_mesh.mesh_dim_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names,
                                              device_mesh.shape))
        self.rank = dist.get_rank()
        self.collectives = 0
        layout = device_mesh.mesh.reshape(-1, self.shape["model"]).tolist()
        # (data index, model index) of every rank of the world
        self.coords = {r: (d, m) for d, row in enumerate(layout)
                       for m, r in enumerate(row)}

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, device={self.device})"

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    @property
    def data_size(self) -> int:
        return data_size(self)

    def index(self, axis: str) -> int:
        """This rank's index along ``axis``."""
        return self.coords[self.rank][self.axis_names.index(axis)]

    @property
    def data_index(self) -> int:
        return self.index("data")

    def _group(self, axis: Optional[str]):
        return None if axis is None else self.device_mesh.get_group(axis)

    def _width(self, axis: Optional[str]) -> int:
        return self.size if axis is None else self.shape[axis]

    def all_gather(self, x: torch.Tensor, axis: Optional[str],
                   dim: int) -> torch.Tensor:
        """Every index's ``x`` along ``axis`` (None: the whole world),
        concatenated on ``dim`` in index order."""
        if self._width(axis) == 1:
            return x
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(self._width(axis))]
        dist.all_gather(parts, x, group=self._group(axis))
        self.collectives += 1
        return torch.cat(parts, dim=dim)

    def all_reduce(self, x: torch.Tensor,
                   axis: Optional[str]) -> torch.Tensor:
        """``x`` summed over ``axis`` (None: the whole world), in place."""
        if self._width(axis) > 1:
            dist.all_reduce(x, group=self._group(axis))
            self.collectives += 1
        return x

    def barrier(self) -> None:
        if self.size > 1:
            dist.barrier()
            self.collectives += 1


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


def data_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


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

    def __init__(self, mesh: Mesh, spec: P, shape: Sequence[int]):
        self.mesh, self.spec, self.shape = mesh, spec, tuple(shape)
        self.dims: Dict[str, int] = {}      # axis -> the dim split over it
        for d, entry in enumerate(spec):
            axes = (() if entry is None else
                    (entry,) if isinstance(entry, str) else tuple(entry))
            if len(axes) > 1:
                raise NotImplementedError(
                    f"a dim split over several axes {axes} is not ported")
            for a in axes:
                n = mesh.shape[a]
                if n > 1 and self.shape[d] % n == 0:
                    self.dims[a] = d

    def __repr__(self) -> str:
        return f"Placement({self.spec}, {self.shape}, split {self.dims})"

    @property
    def local_shape(self) -> Tuple[int, ...]:
        s = list(self.shape)
        for a, d in self.dims.items():
            s[d] //= self.mesh.shape[a]
        return tuple(s)

    def owns(self, coords: Tuple[int, int]) -> bool:
        """Is the block the rank at (data, model) ``coords`` holds one the
        mesh counts once (replicas along an unsplit axis: index 0's)?"""
        return all(a in self.dims or coords[i] == 0
                   for i, a in enumerate(AXES))

    def shard(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's block of the whole leaf, in memory of its own."""
        for a, d in self.dims.items():
            n = full.shape[d] // self.mesh.shape[a]
            full = full.narrow(d, self.mesh.index(a) * n, n)
        return full.clone(memory_format=torch.contiguous_format)

    def _gather(self, local: torch.Tensor) -> torch.Tensor:
        for a, d in self.dims.items():
            local = self.mesh.all_gather(local, a, d)
        return local

    def _reduce(self, grad: torch.Tensor) -> torch.Tensor:
        """The whole gradient -> this rank's block's: cut along "model",
        summed over data (each data index's own rows)."""
        if "model" in self.dims:
            d, n = self.dims["model"], self.local_shape[self.dims["model"]]
            grad = grad.narrow(d, self.mesh.index("model") * n, n)
        if self.mesh.data_size > 1:
            grad = self.mesh.all_reduce(grad.clone(), "data")
        if "data" in self.dims:
            d, n = self.dims["data"], self.local_shape[self.dims["data"]]
            grad = grad.narrow(d, self.mesh.data_index * n, n)
        return grad.contiguous()

    def whole(self, local: torch.Tensor) -> torch.Tensor:
        """The whole leaf from this rank's block (no gradient)."""
        return self._gather(local.detach())

    def gather(self, local: torch.Tensor) -> torch.Tensor:
        """The whole leaf, differentiably (see the module docstring)."""
        if not self.dims and self.mesh.data_size == 1:
            return local
        return _Gather.apply(local, self)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, local, placement):
        ctx.placement = placement
        return placement._gather(local)

    @staticmethod
    def backward(ctx, grad):
        return ctx.placement._reduce(grad), None
