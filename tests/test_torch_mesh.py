"""The port's sharding specs against the JAX package's on the CPU.

Layouts: the port keeps a stacked layer list (``blocks``, an
encoder-decoder's ``encoder`` and ``decoder``) as one param tree per
layer where JAX stacks the layers on a leading axis.  The port's
``specs()`` gives each per-layer leaf JAX's spec without the leading
layer entry; ``launch.mesh.stacked_specs`` maps a port spec tree back to
JAX's layout (the layers' one spec with a leading None), which must equal
JAX's ``specs()`` leaf by leaf.  ``fsdp_specs`` runs on JAX's stacked
shapes; JAX's runs in a subprocess with 8 host devices (its meshes need
them), as the JAX package's ``test_distributed.py`` runs it.  The
trainer's per-layer spec is JAX's stacked leaf's without the layer
entry, whole along "data" where FSDP picks the layer axis.

Everything here is exact: specs are names."""
import test_torch_threads  # noqa: F401  (first: one torch thread)
import functools
import json
import subprocess
import sys
import textwrap
import types

import jax
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from conftest import subprocess_env
from repro.configs import base as jbase
from repro.models.lm import build_model as jbuild
from repro.optim.adamw import AdamW as JAdamW
from repro_torch import tree
from repro_torch.configs import base
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import sharding
from repro_torch.models.lm import build_model
from repro_torch.optim.adamw import AdamW
from repro_torch.train.trainer import Trainer

P = mesh_lib.P
MESHES = ((2, 1), (2, 2), (4, 1))
FSDP_ARCHS = ("smollm-135m", "mixtral-8x22b")


def _entries(spec):
    """A spec's entries as JSON gives them back (tuples as lists)."""
    return [list(e) if isinstance(e, tuple) else e for e in spec]


def _flat(specs):
    """A JAX spec tree as {path: entries}, paths as the port names them."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, JP))
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): _entries(s) for path, s in flat}


def _jax_specs(arch: str):
    return _flat(jbuild(jbase.get_smoke_config(arch)).specs())


def _port_stacked(arch: str):
    model = build_model(base.get_smoke_config(arch))
    return model, mesh_lib.stacked_specs(model.specs(), model.stacked)


@pytest.mark.parametrize("arch", list(base.ARCH_IDS))
def test_specs_equal_jax_leaf_by_leaf(arch):
    """Every module's ``specs()`` (norms, embedding, dense head and
    frontend, ``BinaryDense`` by partition, attention, the FFN and the
    expert stack (expert-parallel from 16 experts), the MoE, the
    recurrent blocks, ``Block``, ``LMModel`` and ``EncDecModel``): the
    port's tree mirrors its params, and in JAX's layout it is JAX's."""
    model, stacked = _port_stacked(arch)
    params = model.init(torch.Generator().manual_seed(0))
    assert [p for p, _ in tree.leaves_with_paths(model.specs())] == \
        [p for p, _ in tree.leaves_with_paths(params)]
    for (path, spec), leaf in zip(tree.leaves_with_paths(model.specs()),
                                  tree.leaves(params)):
        assert len(spec) <= leaf.dim(), path
    port = {p: _entries(s) for p, s in tree.leaves_with_paths(stacked)}
    assert port == _jax_specs(arch)


@functools.lru_cache(maxsize=None)
def _jax_fsdp():
    """JAX's ``fsdp_specs``: test_fsdp_specs_assignment's inputs on a
    (4, 2) mesh, and each of FSDP_ARCHS' smoke trees on MESHES."""
    script = textwrap.dedent(f"""
        import json
        import jax, jax.numpy as jnp
        from jax.sharding import PartitionSpec as P
        from repro.configs import base
        from repro.launch import mesh as mesh_lib
        from repro.models.lm import build_model

        def flat(tree):
            leaves, _ = jax.tree_util.tree_flatten_with_path(
                tree, is_leaf=lambda x: isinstance(x, P))
            return {{'/'.join(str(getattr(k, 'key', getattr(k, 'idx', k)))
                             for k in path): list(s) for path, s in leaves}}

        out = {{}}
        mesh = jax.make_mesh((4, 2), ('data', 'model'))
        specs = {{'w': P(None, 'model'), 'small': P(None),
                  'odd': P(None, None)}}
        shapes = {{'w': jax.ShapeDtypeStruct((16, 6), jnp.float32),
                   'small': jax.ShapeDtypeStruct((7,), jnp.float32),
                   'odd': jax.ShapeDtypeStruct((5, 3), jnp.float32)}}
        out['assignment'] = flat(mesh_lib.fsdp_specs(specs, shapes, mesh))
        for arch in {list(FSDP_ARCHS)!r}:
            model = build_model(base.get_smoke_config(arch))
            shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0))
            for d, m in {list(MESHES)!r}:
                mesh = jax.make_mesh((d, m), ('data', 'model'))
                out[f'{{arch}} {{d}}x{{m}}'] = flat(
                    mesh_lib.fsdp_specs(model.specs(), shapes, mesh))
        print(json.dumps(out))
    """)
    res = subprocess.run([sys.executable, "-c", script],
                         env=subprocess_env(8), capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


def _mesh(d: int, m: int):
    """What ``fsdp_specs`` and ``Trainer.param_spec`` read of a mesh."""
    return types.SimpleNamespace(axis_names=("data", "model"),
                                 shape={"data": d, "model": m},
                                 device=torch.device("cpu"))


def test_fsdp_specs_equal_jax_on_the_assignment_inputs():
    specs = {"w": P(None, "model"), "small": P(None), "odd": P(None, None)}
    shapes = {"w": torch.empty(16, 6, device="meta"),
              "small": torch.empty(7, device="meta"),
              "odd": torch.empty(5, 3, device="meta")}
    got = mesh_lib.fsdp_specs(specs, shapes, _mesh(4, 2))
    assert got == {"w": P("data", "model"), "small": P(None),
                   "odd": P(None, None)}
    assert {k: _entries(v) for k, v in got.items()} == \
        _jax_fsdp()["assignment"]


def _stacked_shapes(model, params):
    """Meta tensors of JAX's stacked leaves' shapes."""
    out = dict(params)
    for key in model.stacked:
        layers = params[key]
        out[key] = tree.map(lambda t: torch.empty((len(layers),) + t.shape,
                                                  device="meta"), layers[0])
    return tree.map(lambda t: torch.empty(t.shape, device="meta"), out)


@pytest.mark.parametrize("arch", FSDP_ARCHS)
def test_fsdp_specs_equal_jax_on_smoke_trees(arch):
    """``fsdp_specs`` on JAX's stacked shapes equals JAX's at (2, 1),
    (2, 2) and (4, 1); the trainer's spec of each per-layer leaf is the
    stacked leaf's without its layer entry, or (where FSDP picked the
    layer axis) the per-layer spec whole along "data"."""
    model, stacked = _port_stacked(arch)
    params = model.init(torch.Generator().manual_seed(0))
    shapes = _stacked_shapes(model, params)
    layer_axis = 0
    for d, m in MESHES:
        got = mesh_lib.fsdp_specs(stacked, shapes, _mesh(d, m))
        want = _jax_fsdp()[f"{arch} {d}x{m}"]
        assert {p: _entries(s) for p, s in
                tree.leaves_with_paths(got)} == want
        tr = Trainer(model, AdamW(), device="cpu", mesh=_mesh(d, m))
        own = dict(tree.leaves_with_paths(model.specs()))
        for path, leaf in tree.leaves_with_paths(params):
            key, *rest = path.split("/")
            spec = _entries(tr.param_spec(path, leaf.shape))
            if key not in model.stacked:
                assert spec == want[path]
                continue
            jax_spec = want["/".join([key] + rest[1:])]
            if jax_spec[0] is None:
                assert spec == jax_spec[1:], path
            else:
                layer_axis += 1
                assert spec == _entries(own[path]) + \
                    [None] * (len(jax_spec) - 1 - len(own[path])), path
    assert layer_axis > 0      # small per-layer vectors, (L, H) at H = 3


def test_optimizer_state_specs_equal_jax():
    """``AdamW.state_specs``: the moments take their params' specs, the
    step is whole, as JAX's (on smollm's specs in JAX's layout)."""
    _, stacked = _port_stacked("smollm-135m")
    jstate = JAdamW().state_specs(jbuild(jbase.get_smoke_config(
        "smollm-135m")).specs())
    port = AdamW().state_specs(stacked)
    assert list(port.step) == list(jstate.step) == []
    for got, want in ((port.mu, jstate.mu), (port.nu, jstate.nu)):
        assert {p: _entries(s) for p, s in tree.leaves_with_paths(got)} == \
            _flat(want)


def test_constrain_returns_x_in_and_out_of_a_context():
    """``constrain`` is the identity; the context carries the mesh and its
    data axes, and a data axis of one index splits nothing."""
    x = torch.ones(4, 8)
    assert sharding.constrain(x, "batch", None) is x
    assert sharding.current() is None and sharding.batch_axes() == ("data",)
    mesh = types.SimpleNamespace(data_size=1, data_index=0)
    with sharding.activation_sharding(mesh, ("data",)):
        assert sharding.constrain(x, "batch", "model") is x
        assert sharding.current() == (mesh, ("data",))
        assert sharding.claim_shares() == (None, (), 1)
        assert sharding.batch_sum(x) is x
        assert sharding.claim_offsets(x.int()) is None
        leaf = sharding.Gathered(x, lambda t: t * 2)
        assert torch.equal(sharding.materialize({"w": leaf})["w"], 2 * x)
    assert sharding.current() is None
    assert sharding.materialize({"w": x})["w"] is x


def test_placements_cut_blocks_that_divide():
    """A placement splits a dim over an axis only where the axis' size
    divides it; the blocks of every rank put back together give the
    leaf; ``batch_spec`` gives each data index its rows."""
    full = torch.arange(8 * 6, dtype=torch.float32).reshape(8, 6)
    blocks = {}
    for d in range(2):
        for m in range(2):
            mesh = _mesh(2, 2)
            mesh.index = lambda a, d=d, m=m: {"data": d, "model": m}[a]
            mesh.data_index = d
            pl = mesh_lib.Placement(mesh, P("data", "model"), full.shape)
            assert pl.dims == {"data": 0, "model": 1}
            assert pl.local_shape == (4, 3)
            blocks[d, m] = pl.shard(full)
            assert pl.owns((d, m))
            assert mesh_lib.batch_spec(mesh, 8) == slice(4 * d, 4 * d + 4)
    top = torch.cat([blocks[0, 0], blocks[0, 1]], dim=1)
    bottom = torch.cat([blocks[1, 0], blocks[1, 1]], dim=1)
    assert torch.equal(torch.cat([top, bottom]), full)
    odd = mesh_lib.Placement(_mesh(2, 2), P("model", None), (3, 6))
    assert odd.dims == {} and odd.local_shape == (3, 6)
    assert odd.owns((0, 0)) and not odd.owns((1, 0))
    with pytest.raises(ValueError, match="does not split"):
        mesh_lib.batch_spec(mesh, 7)
