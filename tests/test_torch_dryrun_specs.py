"""The dry run's stand-ins (``repro_torch.launch.specs``) against the JAX
package's ``repro.launch.specs`` at full width, on the production meshes:
JAX's on ``jax.sharding.AbstractMesh`` (no devices), the port's on its
``AbstractMesh``.

For every arch of ``ARCH_IDS`` but bert, every valid shape and both
meshes, each leaf of ``batch_specs``, ``cache_shardings`` (through
``decode_specs``) and ``deploy_param_specs`` has JAX's global shape, spec
and per-rank shard shape, and JAX's dtype up to ``uint32`` -> ``int32``;
the port's per-layer leaf of a stacked JAX leaf is compared with that
leaf without its layer axis (never split in these specs).  The deploy
specs equal JAX's ``deploy_specs()`` through ``stacked_specs``, and the
per-rank bytes of the decode_32k deploy params and caches on the single
pod are the figures JAX's specs give (shape arithmetic).  Everything here
is exact: specs are names and shapes."""
import test_torch_threads  # noqa: F401  (first: one torch thread)
import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import base as jbase
from repro.launch import specs as jspecs
from repro.models.lm import build_model as jbuild
from repro_torch import tree
from repro_torch.configs import base
from repro_torch.launch import mesh as mesh_lib, specs
from repro_torch.models.lm import build_model

ASSIGNED = [a for a in base.ARCH_IDS if a != "bert-base-cobra"]
MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}
GIB = 2 ** 30
# per-rank GiB of the decode_32k deploy params and caches on the single
# pod, from JAX's specs (shape arithmetic)
DECODE_32K_GIB = {
    "mixtral-8x22b": (1.142, 0.438), "arctic-480b": (3.713, 2.188),
    "qwen1.5-32b": (0.612, 20.000), "gemma3-27b": (0.520, 0.091),
    "smollm-135m": (0.008, 0.352), "granite-3-2b": (0.043, 1.250),
    "seamless-m4t-large-v2": (0.136, 0.097), "hymba-1.5b": (0.042, 0.023),
    "xlstm-350m": (0.026, 0.626), "internvl2-76b": (1.030, 5.000)}


def _entry(e):
    if isinstance(e, (tuple, list)):
        e = tuple(e)
        return e[0] if len(e) == 1 else e
    return e


def _spec(s):
    return tuple(_entry(e) for e in s)


def _key(k):
    for attr in ("key", "idx", "name"):
        if hasattr(k, attr):
            return str(getattr(k, attr))
    raise TypeError(k)


def _jax_leaves(t):
    """{path: ShapeDtypeStruct} with the port's path spelling."""
    return {"/".join(_key(k) for k in path): leaf for path, leaf in
            jax.tree_util.tree_flatten_with_path(t)[0]}


def _dtype(d) -> str:
    name = str(d).replace("torch.", "") if isinstance(d, torch.dtype) \
        else np.dtype(d).name
    return {"uint32": "int32"}.get(name, name)


def _jax_leaf(jl, path: str, stacked):
    """JAX's leaf of the port's ``path`` and whether it is a stacked one
    (the port's layer index dropped)."""
    if path in jl:
        return jl[path], False
    head, _, rest = path.partition("/")
    if head in stacked:
        layer, _, rest = rest.partition("/")
        return jl[f"{head}/{rest}"], True
    raise KeyError(path)


def _compare(port, jax_tree, stacked=()):
    """Every port leaf against JAX's: (whole shape, spec, shard shape,
    dtype); returns the port's per-rank bytes."""
    jl = _jax_leaves(jax_tree)
    total = 0
    for path, t in tree.leaves_with_paths(port):
        j, is_stacked = _jax_leaf(jl, path, stacked)
        pl = mesh_lib.placement_of(t)
        shape, spec = tuple(j.shape), _spec(j.sharding.spec)
        spec = spec + (None,) * (len(shape) - len(spec))
        local = tuple(j.sharding.shard_shape(j.shape))
        if is_stacked:
            assert spec[0] is None, path
            shape, spec, local = shape[1:], spec[1:], local[1:]
        got_spec = _spec(pl.spec)
        got_spec = got_spec + (None,) * (len(pl.shape) - len(got_spec))
        assert (pl.shape, got_spec, tuple(t.shape)) == (
            shape, spec, local), path
        assert _dtype(t.dtype) == _dtype(j.dtype), path
        total += t.numel() * t.element_size()
    return total


@functools.lru_cache(maxsize=None)
def _jax_mesh(kind):
    return AbstractMesh(*MESHES[kind])


@functools.lru_cache(maxsize=None)
def _jax_deploy(arch, kind):
    return jspecs.deploy_param_specs(jbuild(jbase.get_config(arch)),
                                     _jax_mesh(kind))


@pytest.mark.parametrize("arch", ASSIGNED)
def test_specs_equal_jax_at_full_width_on_both_meshes(arch):
    cfg, jcfg = base.get_config(arch), jbase.get_config(arch)
    model, jmodel = build_model(cfg), jbuild(jcfg)
    got = mesh_lib.stacked_specs(model.deploy_specs(), model.stacked)
    want = jmodel.deploy_specs()
    jl = _jax_leaves(want)
    gl = {p: s for p, s in tree.leaves_with_paths(got)}
    assert set(gl) == set(jl)
    assert {p: _spec(s) for p, s in gl.items()} == \
        {p: _spec(s) for p, s in jl.items()}
    for kind in MESHES:
        mesh = mesh_lib.make_production_mesh(multi_pod=kind == "multi")
        assert (tuple(mesh.shape.values()), mesh.axis_names) == MESHES[kind]
        jmesh = _jax_mesh(kind)
        dparams = specs.deploy_param_specs(model, mesh)
        params_bytes = _compare(dparams, _jax_deploy(arch, kind),
                                model.stacked)
        for name, shape in base.valid_shapes(cfg).items():
            jshape = jbase.SHAPES[name]
            if shape.kind == "decode":
                dp, token, caches = specs.decode_specs(cfg, shape, mesh)
                _, jtoken, jcaches = jspecs.decode_specs(jcfg, jshape,
                                                         jmesh)
                assert _compare(dp, _jax_deploy(arch, kind),
                                model.stacked) == params_bytes
                _compare({"t": token}, {"t": jtoken})
                cache_bytes = _compare(caches, jcaches)
                if name == "decode_32k":
                    want_p, want_c = DECODE_32K_GIB[arch]
                    if kind == "multi":   # the caches halve
                        want_c /= 2
                    assert round(params_bytes / GIB, 3) == want_p
                    assert round(cache_bytes / GIB, 3) == \
                        pytest.approx(want_c, abs=1e-3)
            else:
                _compare(specs.batch_specs(cfg, shape, mesh),
                         jspecs.batch_specs(jcfg, jshape, jmesh))


def test_cache_and_batch_rules_split_what_divides():
    """The rule's branches on a (2, 16, 16) mesh: rows over both data axes
    where 32 divides them, the kv heads over "model", and at B = 1 the
    largest remaining dim over the data axes (sequence parallelism)."""
    mesh = mesh_lib.make_production_mesh(multi_pod=True)
    d = ("pod", "data")
    assert _spec(specs.cache_spec(mesh, (64, 16, 8, 2), batch=64)) == \
        (d, "model", None, None)
    assert _spec(specs.cache_spec(mesh, (1, 8, 524288, 4), batch=1)) == \
        (None, None, d, None)
    assert _spec(specs.cache_spec(mesh, (1, 8, 30, 4), batch=1)) == \
        (None, None, None, None)
    t = specs.stand_in(mesh, specs.cache_spec(mesh, (64, 16, 8, 2),
                                              batch=64), (64, 16, 8, 2),
                       torch.int32)
    assert tuple(t.shape) == (2, 1, 8, 2) and t.device.type == "meta"
    assert mesh_lib.rows_split(mesh, t)
    one = specs.stand_in(mesh, specs._batch_spec(mesh, (1, 1), 1), (1, 1),
                         torch.int32)
    assert tuple(one.shape) == (1, 1) and not mesh_lib.rows_split(mesh, one)
