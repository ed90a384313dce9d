"""The dry run's train state (``launch.specs.train_state_specs``) against
the JAX package's at full width on both production meshes: JAX's state
specs composed as its ``Trainer.__init__`` composes them
(``repro/train/trainer.py:50-62``: ``fsdp_specs(model.specs(),
eval_shape(model.init), mesh)``, then ``opt.state_specs``; JAX's
``Trainer`` itself enters its mesh, which an ``AbstractMesh`` cannot), on
``jax.sharding.AbstractMesh``.

Every leaf of the params and both AdamW moments has JAX's global shape,
spec and per-rank shard shape and dtype (a per-layer leaf against its
stacked JAX leaf without the layer axis), but where JAX's FSDP, run on
the stacked leaf, puts the data axes on the layer axis (small per-layer
leaves such as smollm's (L, H) scales or hymba's (L, 3200, 16) a_log):
the port's per-layer leaf stays whole along the data axes (ROADMAP §3)
and is split as JAX's along "model".  The test lists those leaves and
bounds their per-rank bytes; every other leaf is checked exactly."""
import test_torch_threads  # noqa: F401  (first: one torch thread)
import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import base as jbase
from repro.launch import mesh as jmesh
from repro.models.lm import build_model as jbuild
from repro.optim.adamw import AdamW as JAdamW
from repro_torch import tree
from repro_torch.configs import base
from repro_torch.launch import mesh as mesh_lib, specs
from repro_torch.models.lm import build_model
from repro_torch.optim.adamw import AdamW
from repro_torch.train.trainer import Trainer, TrainerConfig

from test_torch_dryrun_specs import ASSIGNED, MESHES, _dtype, _jax_leaves, \
    _spec

META = torch.device("meta")


@functools.lru_cache(maxsize=None)
def _jax_state(arch, kind):
    """{path: (shape, spec, shard shape, dtype)} of JAX's params and
    moments (paths "params/...", "opt/mu/...", "opt/nu/...")."""
    cfg = jbase.get_config(arch)
    model = jbuild(cfg)
    mesh = AbstractMesh(*MESHES[kind])
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0))
    pspecs = (jmesh.fsdp_specs(model.specs(), shapes, mesh)
              if getattr(cfg, "fsdp", True) else model.specs())
    opt = JAdamW(moment_dtype=np.dtype(cfg.optim_moment_dtype))
    ospecs = opt.state_specs(pspecs)
    out = {}
    moment = np.dtype(cfg.optim_moment_dtype)
    for prefix, sp, dt in (("params", pspecs, None),
                           ("opt/mu", ospecs.mu, moment),
                           ("opt/nu", ospecs.nu, moment)):
        sps = _jax_leaves(jax.tree.map(
            lambda s: s, sp, is_leaf=lambda x: isinstance(
                x, jax.sharding.PartitionSpec)))
        for path, s in _jax_leaves(shapes).items():
            spec = _spec(sps[path])
            spec = spec + (None,) * (len(s.shape) - len(spec))
            local = tuple(jax.sharding.NamedSharding(
                mesh, sps[path]).shard_shape(s.shape))
            out[f"{prefix}/{path}"] = (tuple(s.shape), spec, local,
                                       _dtype(dt or s.dtype))
    return out


@pytest.mark.parametrize("arch", ASSIGNED)
def test_train_state_shards_equal_jax_but_listed_leaves(arch):
    cfg = base.get_config(arch)
    model = build_model(cfg)
    for kind in MESHES:
        want = _jax_state(arch, kind)
        mesh = mesh_lib.make_production_mesh(multi_pod=kind == "multi")
        daxes = mesh_lib.data_axes(mesh)
        daxes = daxes[0] if len(daxes) == 1 else daxes
        moment = getattr(torch, cfg.optim_moment_dtype)
        tr = Trainer(model, AdamW(moment_dtype=moment), TrainerConfig(),
                     device=META, mesh=mesh)
        state = specs.train_state_specs(tr)
        assert tuple(state.opt.step.shape) == () and \
            state.opt.step.dtype == torch.int32
        listed, listed_bytes, checked = set(), 0, 0
        for sub, part in (("params", state.params), ("opt/mu", state.opt.mu),
                          ("opt/nu", state.opt.nu)):
            for path, t in tree.leaves_with_paths(part):
                key = f"{sub}/{path}"
                head, _, rest = path.partition("/")
                stacked = head in model.stacked
                if stacked:
                    key = f"{sub}/{head}/{rest.partition('/')[2]}"
                shape, spec, local, dtype = want[key]
                pl = mesh_lib.placement_of(t)
                got_spec = _spec(pl.spec)
                got_spec += (None,) * (len(pl.shape) - len(got_spec))
                assert _dtype(t.dtype) == dtype, key
                if stacked and spec[0] is not None:
                    # JAX's FSDP took the layer axis: whole per layer
                    assert spec[0] == daxes, key
                    assert (pl.shape, got_spec, tuple(t.shape)) == (
                        shape[1:], spec[1:], local[1:]), key
                    listed.add(key)
                    listed_bytes += t.numel() * t.element_size()
                    continue
                if stacked:
                    shape, spec, local = shape[1:], spec[1:], local[1:]
                assert (pl.shape, got_spec, tuple(t.shape)) == (
                    shape, spec, local), key
                checked += 1
        assert checked > len(listed)
        # the listed leaves are small vectors: under 64 MiB a rank
        assert listed_bytes < 64 * 2 ** 20, (arch, kind, listed_bytes)
