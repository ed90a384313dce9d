"""``bridge.deploy_from_jax`` against the JAX package's own ``convert`` on
the CPU, at smoke size, and the config registry's ``all_configs`` and
``valid_shapes`` against the JAX package's.

A JAX QAT tree (drawn by the JAX package's ``init``, scales moved off
their init values), saved leaf by leaf and memory-mapped back as numpy,
goes through ``deploy_from_jax`` (layer by layer, an expert stack expert
by expert); it must equal ``from_jax_params`` of the JAX package's
``convert`` of the same tree (a ``jax.vmap`` over the stacked layers):
packed words bitwise, floats exactly.  Covered: smollm (a stacked uniform
stack), xlstm (a list of mixed layers), mixtral (expert stacks),
seamless (encoder and decoder stacks) and internvl2 (the frontend)."""
import test_torch_threads  # noqa: F401  (first: one torch thread)
import dataclasses
import functools

import jax
import numpy as np
import pytest

from repro.configs import base as jbase
from repro.models.lm import build_model as jbuild
from repro_torch import bridge
from repro_torch.configs import base as tbase
from repro_torch.models.lm import build_model as tbuild

from test_torch_init_deploy import assert_same_tree

ARCHS = ("smollm-135m", "xlstm-350m", "mixtral-8x22b",
         "seamless-m4t-large-v2", "internvl2-76b")


def _perturb(tree, rng, name=""):
    """Scales and thresholds off their init values (so a key that convert
    dropped or swapped would show)."""
    if isinstance(tree, dict):
        return {k: _perturb(v, rng, k) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_perturb(v, rng, name) for v in tree]
    a = np.asarray(tree)
    if name.endswith(("_alpha", "_beta", "alpha_w", "sps_lambda")):
        return (a + 0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
    return a


@functools.lru_cache(maxsize=None)
def _jax(arch):
    """(JAX QAT tree as numpy, JAX deploy tree as numpy), jitted once."""
    jm = jbuild(jbase.get_smoke_config(arch))
    qat = _perturb(jax.tree.map(np.asarray, jax.jit(jm.init)(
        jax.random.PRNGKey(3))), np.random.default_rng(3))
    dp = jax.tree.map(np.asarray, jax.jit(jm.convert)(qat))
    return qat, dp


def _memmap(tree, root, path="p"):
    """``tree`` saved leaf by leaf under ``root`` and loaded back
    memory-mapped (read-only)."""
    if isinstance(tree, dict):
        return {k: _memmap(v, root, f"{path}.{k}") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_memmap(v, root, f"{path}.{i}") for i, v in enumerate(tree)]
    f = root / f"{path}.npy"
    np.save(f, np.asarray(tree))
    return np.load(f, mmap_mode="r")


@pytest.mark.parametrize("arch", ARCHS)
def test_deploy_from_jax_equals_jax_convert(arch, tmp_path):
    qat, dp = _jax(arch)
    model = tbuild(tbase.get_smoke_config(arch))
    got = bridge.deploy_from_jax(model, _memmap(qat, tmp_path),
                                 device="cpu")
    assert_same_tree(got, bridge.from_jax_params(dp, device="cpu"))
    # and the port's own convert of the bridged QAT tree
    assert_same_tree(got, model.convert(bridge.from_jax_params(
        qat, device="cpu")))


def test_all_configs_and_valid_shapes_match_jax():
    tall, jall = tbase.all_configs(), jbase.all_configs()
    assert list(tall) == list(jall) == list(tbase.ARCH_IDS)
    for arch in tbase.ARCH_IDS:
        assert dataclasses.asdict(tall[arch]) == \
            dataclasses.asdict(jall[arch])
        for flags in ({}, {"subquadratic": True}, {"skip_decode": True}):
            got = tbase.valid_shapes(dataclasses.replace(tall[arch],
                                                         **flags))
            want = jbase.valid_shapes(dataclasses.replace(jall[arch],
                                                          **flags))
            assert {k: dataclasses.asdict(v) for k, v in got.items()} == \
                {k: dataclasses.asdict(v) for k, v in want.items()}, arch
