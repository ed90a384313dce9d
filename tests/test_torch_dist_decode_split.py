"""The mesh ``decode_step`` split along "model" against the one-device
step, on gloo worlds of CPU ranks (``test_torch_dist_worlds.run_world``;
the jobs in ``test_torch_decode_jobs.py``; the float32 smoke configs, a
MoE's capacity factor dropping claims).

After a prefill, three greedy decode steps of each family at (1, 2),
(1, 4) and (2, 2): smollm (9 heads' smoke of 3 over 4 ranks leaves one
empty), granite (GQA, its cache split on KV heads at (1, 2)), qwen (MHA,
QKV bias, untied head), gemma (windows, its cache split on KV heads),
mixtral (an expert stack split on its rows and words) and arctic (the
dense residual; with 16 experts, split by expert), seamless (the cross
memory, read on the rank's heads), hymba and xlstm (the recurrences
whole), internvl2 (the frontend), and smollm and mixtral at d = 512, d_ff
= 1,024, where ``wo`` and ``w2`` split on their words (Kp = 16 and 32)
and the FFN's ``w1``/``w3`` rows feed ``w2``'s words with nothing
crossing.  On every rank the logits of its rows equal the one-device
step's, and every cache leaf's block the one-device cache's, bitwise.  A
batch of one row at (2, 1) and (2, 2) splits its rings over the data axes
(windows wrapped by the prompt; V^T on its d_h rows, or on its words as K
on its slots), bitwise too.  smollm's mesh decode at (1, 2) gives the JAX
package's ``decode_step`` logits within ``ATOL`` (the frameworks sum the
norms, RoPE and the head in other orders) and its tokens."""
import test_torch_threads  # noqa: F401  (first: one torch thread)
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import test_torch_decode_jobs as jobs
import test_torch_dist_worlds as worlds
from repro.configs import base as jbase
from repro.models.lm import build_model as jbuild
from test_torch_dense_archs import _perturb

ATOL = 1e-4
SHAPES = {(1, 2): 2, (1, 4): 4, (2, 2): 4}
RING_SHAPES = {(2, 1): 2, (2, 2): 4}
PARITY_B, PARITY_S, PARITY_EXTRA = 2, 12, 4


@functools.lru_cache(maxsize=None)
def _jax_smollm():
    """smollm's JAX smoke model and its deploy params (scales and
    thresholds moved off their init values), numpy."""
    jm = jbuild(jbase.get_smoke_config("smollm-135m"))
    qat = _perturb(jax.tree.map(np.asarray, jax.jit(jm.init)(
        jax.random.PRNGKey(0))), np.random.default_rng(0))
    return jm, jax.tree.map(np.asarray, jax.jit(jm.convert)(qat))


def _prompt() -> np.ndarray:
    return np.random.default_rng(1).integers(
        0, 256, (PARITY_B, PARITY_S)).astype(np.int32)


@functools.lru_cache(maxsize=None)
def world(size: int):
    """Every task on the world of ``size`` ranks: {(data, model): {case:
    rank results}, ("ring", data, model): ..., "parity": rank results}."""
    tasks, keys = [], []
    for shape, n in SHAPES.items():
        if n == size:
            tasks.append(("decode", (shape[1], list(jobs.CASES.items()))))
            keys.append(shape)
    for shape, n in RING_SHAPES.items():
        if n == size:
            tasks.append(("decode", (shape[1], list(jobs.RINGS.items()))))
            keys.append(("ring",) + shape)
    if size == 2:
        tasks.append(("parity", (2, _jax_smollm()[1], _prompt(),
                                 PARITY_EXTRA)))
        keys.append("parity")
    res = worlds.run_world(size, jobs.tasks_job, tasks)
    return {k: [r[i] for r in res] for i, k in enumerate(keys)}


def _assert_bitwise(ranks, name: str) -> None:
    for r, rank in enumerate(ranks):
        for step, (logits, cache) in enumerate(rank[name]["steps"]):
            assert logits, f"{name}: rank {r}'s logits at step {step}"
            assert cache, f"{name}: rank {r}'s cache blocks at step {step}"


@pytest.mark.parametrize("name", list(jobs.CASES))
def test_split_decode_equals_one_device(name):
    """At (1, 2), (1, 4) and (2, 2): the logits of each rank's rows and
    each rank's cache blocks after every step, bitwise; the wide configs
    split a weight on its words (at (1, 2))."""
    for shape, n in SHAPES.items():
        _assert_bitwise(world(n)[shape], name)
    if name.endswith("wide"):
        assert all(r[name]["words"] for r in world(2)[(1, 2)])


@pytest.mark.parametrize("shape", list(RING_SHAPES), ids=lambda s: "x".join(
    map(str, s)))
def test_one_row_ring_split_over_data(shape):
    """A batch of one row, its rings split over the data axes: logits and
    every rank's cache blocks bitwise; every case's ring is split."""
    ranks = world(RING_SHAPES[shape])[("ring",) + shape]
    for name in jobs.RINGS:
        _assert_bitwise(ranks, name)
        assert all(r[name]["ring"] for r in ranks), name


def test_every_rank_runs_the_same_collectives():
    """Every rank of a world ran as many collectives (a rank with no
    query head among them), and some ran."""
    for n in (2, 4):
        for key, ranks in world(n).items():
            if key == "parity":
                continue
            counts = {r["collectives"] for r in ranks}
            assert len(counts) == 1 and counts.pop() > 0, key


def test_split_decode_equals_jax_decode_step():
    """smollm at (1, 2): each rank's logits of every step equal the JAX
    package's ``decode_step`` on the same params, caches and tokens
    (within ``ATOL``), and their greedy tokens too."""
    jm, dp = _jax_smollm()
    ranks = world(2)["parity"]
    jdp = jax.tree.map(jnp.asarray, dp)
    _, jc = jax.jit(functools.partial(jm.prefill_with_cache,
                                      max_len=PARITY_S + PARITY_EXTRA))(
        jdp, jnp.asarray(_prompt()))
    jdec = jax.jit(jm.decode_step)
    for step, tok in enumerate(ranks[0]["fed"]):
        jl, jc = jdec(jdp, jnp.asarray(tok), jc)
        jl = np.asarray(jl, np.float32)
        for rank in ranks:
            assert rank["steps"][step] == (True, True)
            got = rank["logits"][step]
            np.testing.assert_allclose(got, jl, atol=ATOL, rtol=0)
            np.testing.assert_array_equal(got.argmax(-1), jl.argmax(-1))
