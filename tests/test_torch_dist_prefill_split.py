"""The mesh ``prefill_logits`` split along "model" by the sequence against
the one-device forward, on gloo worlds of CPU ranks
(``test_torch_dist_worlds.run_world``; the jobs in
``test_torch_prefill_jobs.py``; the float32 smoke configs at 128
positions).

At (1, 2), (1, 4) and (2, 2) each rank computes its block of the
positions, attention on its query heads over the whole sequence; the
logits, put together whole by their placement, equal the one-device
logits bitwise for smollm (its 3 smoke heads over 4 ranks leave one rank
with none; over 2 a rank's heads start inside a KV group), granite (GQA),
qwen (MHA, QKV bias, untied head; with a vocabulary of 4,096 on
vocabulary blocks), gemma (local/global windows and the ``row`` threshold
table, on vocabulary blocks), internvl2 (the frontend's patches among the
positions), seamless (the encoder split too, cross-attention over the
memory's KV heads) and bert (bidirectional, the blocked ReLU F1 through
``rbmm_binary``) and mixtral (a MoE: each rank routes its positions at
the global batch's capacity and slots; a MoE's whole route is
``test_torch_dist_moe_split.py``'s).  A length that "model" does not
divide into whole-word blocks and hymba (the Mamba branch) run the whole
route, bitwise too.  The positions <-> heads exchange round-trips exactly, and
every rank runs as many collectives.  The CLI that compares the two
faces on a process group (``launch/mesh_prefill.py``) runs under
torchrun.  smollm's mesh prefill at (1, 2)
gives the JAX package's ``prefill_logits`` within ``ATOL`` (the
frameworks sum the norms, RoPE and the head in other orders)."""
import test_torch_threads  # noqa: F401  (first: one torch thread)
import functools
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import test_torch_dist_worlds as worlds
import test_torch_prefill_jobs as jobs
from repro.configs import base as jbase
from repro.models.lm import build_model as jbuild
from test_torch_dense_archs import _perturb

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-4
SHAPES = {(1, 2): 2, (1, 4): 4, (2, 2): 4}
PARITY_B = 2
# (heads, KV heads, d_h) of the exchange's round trips: smollm's 9 over 3
# (spans inside KV groups, an empty rank at 16), qwen's MHA at d_h = 64
EXCHANGES = [(9, 3, 64), (5, 5, 32), (3, 1, 32)]
SPLIT = ("smollm-135m", "granite-3-2b", "qwen1.5-32b", "qwen vocab blocks",
         "gemma row table", "internvl2-76b", "seamless-m4t-large-v2",
         "bert-base-cobra", "mixtral-8x22b")
WHOLE = ("smollm whole length", "hymba-1.5b")


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
        0, 256, (PARITY_B, jobs.N)).astype(np.int32)


@functools.lru_cache(maxsize=None)
def world(size: int):
    """Every task on the world of ``size`` ranks: {(data, model): {case:
    rank results}, ("exchange", data, model): [...], "parity": rank
    results}."""
    tasks, keys = [], []
    for shape, n in SHAPES.items():
        if n == size:
            tasks.append(("prefill", (shape[1], list(jobs.CASES.items()))))
            keys.append(shape)
            for ex in EXCHANGES:
                tasks.append(("exchange", (shape[1],) + ex))
                keys.append(("exchange",) + shape + ex)
    if size == 2:
        tasks.append(("parity", (2, _jax_smollm()[1], _prompt())))
        keys.append("parity")
    res = worlds.run_world(size, jobs.tasks_job, tasks)
    return {k: [r[i] for r in res] for i, k in enumerate(keys)}


def _cases(name: str):
    for shape, n in SHAPES.items():
        for r, rank in enumerate(world(n)[shape]):
            yield shape, r, rank[name]


@pytest.mark.parametrize("name", SPLIT)
def test_split_prefill_equals_one_device(name):
    """At (1, 2), (1, 4) and (2, 2): every rank's logits put together
    whole equal the one-device logits, bitwise; each rank holds a block of
    the positions (dim 1) or of the vocabulary (dim 2) along "model"."""
    for shape, r, res in _cases(name):
        assert res["equal"], f"{name} at {shape}: rank {r}"
        assert res["model_dim"] in (1, 2), (name, shape, res["model_dim"])
        assert res["whole_shape"][res["model_dim"]] == \
            res["shape"][res["model_dim"]] * shape[1]


def test_vocabulary_blocks_where_the_tables_cost_more():
    """The route each case takes: the smoke tables (V = 256, at most 2.6e5
    bytes) gathered whole, the logits on the rank's positions; a
    vocabulary of 4,096 (2.1e6 bytes a table, against the streams' 2.6e5
    to 5.2e5) on vocabulary blocks."""
    blocks = ("qwen vocab blocks", "gemma row table",
              "seamless-m4t-large-v2")
    for shape, n in SHAPES.items():
        for name in SPLIT:
            got = world(n)[shape][0][name]["model_dim"]
            assert got == (2 if name in blocks else 1), (name, shape)


@pytest.mark.parametrize("name", WHOLE)
def test_whole_route_equals_one_device(name):
    """A length 4 ranks would cut into blocks of 25 positions and the
    Mamba branch: every block whole on every rank, the logits this rank's
    rows, bitwise."""
    for shape, r, res in _cases(name):
        assert res["equal"], f"{name} at {shape}: rank {r}"
        assert res["model_dim"] is None


@pytest.mark.parametrize("ex", EXCHANGES, ids=lambda e: "x".join(map(str, e)))
def test_positions_heads_exchange_round_trips(ex):
    """Each rank receives its query heads' and KV heads' words over the
    whole sequence (a KV head two ranks read goes to both), and the words
    it sends back land at their positions' ranks as they were."""
    for shape, n in SHAPES.items():
        for rank in world(n)[("exchange",) + shape + ex]:
            heads_ok, back_ok, _, coll = rank
            assert heads_ok and back_ok, (ex, shape)
            assert coll == 2


def test_every_rank_runs_the_same_collectives():
    """Every rank of a world ran as many collectives (smollm's rank with
    no query head at (1, 4) among them), and some ran."""
    for n in (2, 4):
        for shape, m in SHAPES.items():
            if m != n:
                continue
            counts = {r["collectives"] for r in world(n)[shape]}
            assert len(counts) == 1 and counts.pop() > 0, shape


def test_split_prefill_equals_jax_prefill_logits():
    """smollm at (1, 2): the mesh logits put together whole equal the JAX
    package's ``prefill_logits`` on the same params and tokens (within
    ``ATOL``), and the one-device port's bitwise."""
    jm, dp = _jax_smollm()
    want = np.asarray(jax.jit(jm.prefill_logits)(
        jax.tree.map(jnp.asarray, dp), jnp.asarray(_prompt())), np.float32)
    ranks = world(2)["parity"]
    blocks = [r["logits"] for r in ranks]
    got = np.concatenate(blocks, axis=ranks[0]["model_dim"])
    got = got[..., :want.shape[-1]]
    for rank in ranks:
        assert rank["equal"]
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def test_torchrun_cli_compares_the_faces():
    """``torch.distributed.run`` with 2 ranks: ``launch.mesh_prefill`` on
    a (1, 2) gloo mesh, gemma's smoke config (6 layers, windows); rank 0
    alone prints its JSON line: bitwise, the same greedy tokens."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    env.pop("WORLD_SIZE", None)
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.mesh_prefill",
         "--device", "cpu", "--smoke", "--arch", "gemma3-27b",
         "--model-parallel", "2", "--batch", "2", "--positions", "128",
         "--iters", "1"],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = [json.loads(ln) for ln in out.stdout.splitlines()
             if ln.startswith("{")]
    assert len(lines) == 1, out.stdout
    rec = lines[0]
    assert rec["mesh"] == {"data": 1, "model": 2} and rec["layers"] == 6
    assert rec["bitwise"] and rec["tokens_equal"] and rec["route"] == 1
    assert rec["max_abs_err"] == 0.0 and rec["mesh_ms"] > 0
