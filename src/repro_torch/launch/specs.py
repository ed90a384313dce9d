"""Input stand-ins for every (arch x shape x face) cell of the dry run (port
of ``repro.launch.specs``): meta tensors, nothing allocated, each the
rank's local block of its input, carrying its ``Placement`` (the whole
shape and the spec; ``launch.mesh.place``), where the JAX package gives
``ShapeDtypeStruct``s with shardings.  Three faces:

  train   -> (state, batch)            for ``Trainer.train_step``
  prefill -> (dparams, batch)          for ``prefill_logits(..., mesh=)``
  decode  -> (dparams, token, caches)  for ``decode_step(..., mesh=)``,
             which computes on these blocks as they are placed (a cache
             split on its KV heads, a ring split over the data axes)

The dtypes are the port's: the JAX package's ``uint32`` words are
``int32`` here.  The meshes are ``launch.mesh``'s (the production mesh of
the dry run is an ``AbstractMesh``, seen from rank 0).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Tuple

import torch

from repro_torch import census, tree
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.mesh import P
from repro_torch.models.lm import EncDecModel, build_model
from repro_torch.optim.adamw import AdamWState
from repro_torch.train.trainer import TrainState

Params = Any
META = torch.device("meta")


def stand_in(mesh, spec: P, shape, dtype) -> torch.Tensor:
    """This rank's block of a leaf of ``shape`` placed by ``spec``: an
    empty meta tensor carrying its ``Placement``."""
    pl = mesh_lib.Placement(mesh, spec, shape)
    return mesh_lib.place(torch.empty(pl.local_shape, dtype=dtype,
                                      device=META), pl)


def _placed(mesh, specs: Params, shapes: Params) -> Params:
    return tree.map(lambda s, t: stand_in(mesh, s, t.shape, t.dtype),
                    specs, shapes)


def batch_specs(cfg: ModelConfig, shape: ShapeConfig, mesh
                ) -> Dict[str, torch.Tensor]:
    """Token / label / frontend stand-ins of a full-sequence face, rows
    split over the data axes."""
    b, s = shape.global_batch, shape.seq_len
    s_text = s - cfg.frontend_tokens if cfg.frontend_tokens and \
        cfg.family != "audio" else s
    out = {"tokens": ((b, s_text), torch.int32),
           "labels": ((b, s_text), torch.int32)}
    if cfg.frontend_tokens:
        out["frontend_embeds"] = ((b, cfg.frontend_tokens,
                                   min(cfg.d_model, 1024)), torch.float32)
    return {k: stand_in(mesh, P(mesh_lib.data_axes(mesh),
                                *([None] * (len(sh) - 1))), sh, dt)
            for k, (sh, dt) in out.items()}


def _batch_spec(mesh, dims, batch: int) -> P:
    """Dim 0 over the data axes when it is the batch and they divide it,
    else every dim whole (JAX's ``_shard_batch_dim``)."""
    nd = len(dims)
    if nd and dims[0] == batch and batch % mesh_lib.data_size(mesh) == 0:
        return P(mesh_lib.data_axes(mesh), *([None] * (nd - 1)))
    return P(*([None] * nd))


def _shard_batch_dim(mesh, shapes: Params, batch: int) -> Params:
    """Stand-ins of ``shapes`` (meta tensors) with dim 0 split over the data
    axes where it is the batch and they divide it, else replicated."""
    return tree.map(lambda t: stand_in(mesh, _batch_spec(mesh, t.shape,
                                                          batch),
                                       t.shape, t.dtype), shapes)


def cache_spec(mesh, dims, *, batch: int, model_axis: str = "model") -> P:
    """One cache leaf's spec (JAX's ``cache_shardings`` rule): the batch
    over the data axes (when they divide it), the kv-head dim over
    "model" (when it divides it), and for a batch left whole (long_500k)
    the largest remaining dim over the data axes (sequence parallelism)."""
    daxes = mesh_lib.data_axes(mesh)
    dtotal = mesh_lib.data_size(mesh)
    msize = mesh.shape[model_axis]
    entries = [None] * len(dims)
    if not dims:
        return P()
    if dims[0] == batch and batch % dtotal == 0:
        entries[0] = daxes
    if len(dims) >= 2 and dims[1] % msize == 0 and dims[1] > 1:
        entries[1] = model_axis
    if entries[0] is None and len(dims) >= 3:
        cand = max(range(2, len(dims)), key=lambda i: dims[i])
        if dims[cand] % dtotal == 0 and dims[cand] >= dtotal:
            entries[cand] = daxes
    return P(*entries)


def cache_shardings(mesh, caches_shape: Params, *, batch: int,
                    model_axis: str = "model") -> Params:
    """Stand-ins of the caches ``caches_shape`` (meta tensors) placed by
    ``cache_spec``."""
    return tree.map(lambda t: stand_in(
        mesh, cache_spec(mesh, tuple(t.shape), batch=batch,
                         model_axis=model_axis), t.shape, t.dtype),
        caches_shape)


@functools.lru_cache(maxsize=None)
def model_shapes(model, deploy: bool) -> Params:
    """The params of ``model`` as meta tensors (QAT, or deploy with
    ``deploy``): ``param_shapes`` of its init, with one block drawn per
    block kind and its tensors standing for every layer of that kind
    (their shapes are the same; drawing all 35 of arctic's 128-expert
    blocks on meta takes minutes)."""
    cfg = model.cfg
    layer = "init_deploy" if deploy else "init"
    zero = dataclasses.replace(model, cfg=cfg.with_(
        num_layers=0, **({"num_encoder_layers": 0}
                         if isinstance(model, EncDecModel) else {})))
    gen = torch.Generator()
    top = mesh_lib.param_shapes(zero._build, gen, layer)
    drawn: Dict[Any, Params] = {}
    with census.suspended():
        for key, blocks in model.layer_blocks().items():
            layers = []
            for blk in blocks:
                kind = dataclasses.replace(blk, window=0)
                if kind not in drawn:
                    drawn[kind] = getattr(blk, layer)(gen, META)
                layers.append(drawn[kind])
            top[key] = layers
    return top


def deploy_param_specs(model, mesh) -> Params:
    """Deploy params as placed stand-ins by ``deploy_specs`` (packed
    weights are 32x smaller: the model axis alone fits every arch, so no
    FSDP pass, as in the JAX package)."""
    return _placed(mesh, model.deploy_specs(), model_shapes(model, True))


def train_state_specs(trainer) -> Any:
    """The train state as placed stand-ins by the trainer's placements
    (``Trainer.placement``: ``specs()`` with FSDP, chosen on the JAX
    package's stacked leaves): params, then the AdamW moments placed as
    their params, the step a host scalar."""
    shapes = model_shapes(trainer.model, False)
    pls = [(trainer.placement(p, t.shape), t.dtype)
           for p, t in tree.leaves_with_paths(shapes)]

    def placed(dtype=None):
        return tree.unflatten(shapes, [
            mesh_lib.place(torch.empty(pl.local_shape, dtype=dtype or dt,
                                       device=META), pl)
            for pl, dt in pls])

    params = placed()
    md = trainer.opt.moment_dtype
    opt = AdamWState(torch.zeros((), dtype=torch.int32), placed(md),
                     placed(md))
    ef = placed(torch.float32) if trainer.cfg.compress_grads else None
    return TrainState(params, opt, ef)


def decode_specs(cfg: ModelConfig, shape: ShapeConfig, mesh
                 ) -> Tuple[Params, torch.Tensor, Params]:
    """(dparams, token, caches) stand-ins of the decode face: the caches
    cover ``shape.seq_len`` tokens and the step decodes the next one."""
    model = build_model(cfg)
    b = shape.global_batch
    dparams = deploy_param_specs(model, mesh)
    with census.suspended():
        if isinstance(model, EncDecModel):
            caches = model.init_caches(b, shape.seq_len, META,
                                       memory_len=cfg.frontend_tokens)
        else:
            caches = model.init_caches(b, shape.seq_len, META)
        caches = cache_shardings(mesh, caches, batch=b)
        token = _shard_batch_dim(mesh, {"t": torch.empty(
            (b, 1), dtype=torch.int32, device=META)}, b)["t"]
    return dparams, token, caches
