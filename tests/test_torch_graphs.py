"""The engine's captured steps (``repro_torch/serve/graphs.py``) on the CPU,
against the JAX engine's jitted steps on the same params (float32 smoke
config, greedy, arrivals at 0).

On the CPU a ``StepGraph`` runs its forward on its static buffers (there
is no card to capture on), so these tests hold what the capture relies on
and what the engine reports: caches and block tables that keep their
addresses while their values follow JAX's, the captures counted by kind
as JAX counts its traces, and launch counts that a replay credits.  The
replays themselves are held to the eager steps on the card by
``test_torch_gpu_graphs.py``."""
import test_torch_threads  # noqa: F401  (first: one torch thread)
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.models.lm import build_model as jbuild
from repro.serve import engine as jengine
from repro.serve import kvcache as jkv
from repro_torch import bridge, kernels
from repro_torch.configs import base as tbase
from repro_torch.models.attention import PageSpec
from repro_torch.models.lm import build_model as tbuild
from repro_torch.serve import engine as tengine
from repro_torch.serve import graphs
from repro_torch.serve import kvcache as tkv

ATOL = 1e-4
TIMING = ("elapsed_s", "goodput_under_slo", "ttft_p50_s", "ttft_p99_s",
          "tenants")


@pytest.fixture(scope="module")
def smoke():
    jm = jbuild(jbase.get_smoke_config("smollm-135m"))
    dp = jax.tree.map(np.asarray, jax.jit(jm.convert)(
        jax.jit(jm.init)(jax.random.PRNGKey(0))))
    return dict(jm=jm, jdp=jax.tree.map(jnp.asarray, dp),
                tm=tbuild(tbase.get_smoke_config("smollm-135m")),
                tdp=bridge.from_jax_params(dp, device="cpu"))


def _engines(smoke, num_slots, cache, policy=None):
    def cfg(m):
        return m.ServeConfig(num_slots=num_slots,
                             cache=m.CacheConfig(**cache),
                             policy=m.PolicyConfig(**(policy or {})))
    return (jengine.ServeEngine(smoke["jm"], smoke["jdp"], cfg(jengine)),
            tengine.ServeEngine(smoke["tm"], smoke["tdp"], cfg(tengine),
                                device="cpu"))


def _requests(mod, lens, new, seed):
    rng = np.random.default_rng(seed)
    return [mod.Request(rid=i, tokens=rng.integers(0, 256, n).astype(
                np.int32), max_new_tokens=new[i] if isinstance(new, tuple)
                else new) for i, n in enumerate(lens)]


def _lengths(caches):
    return [c["attn"].length for c in caches]


# -- caches and tables keep their addresses ------------------------------------


@pytest.mark.parametrize("paged", [False, True], ids=["ring", "paged"])
def test_lengths_keep_their_addresses_and_equal_jax(smoke, paged):
    """Chunks (an inactive row, a row whose chunk ends early) and decode
    steps on the engine's own caches: every layer's ``length`` is the
    tensor it was, the caches come back as the same objects, and the
    lengths equal the JAX model's."""
    jm, tm = smoke["jm"], smoke["tm"]
    spec = PageSpec(page_size=32, max_blocks=3) if paged else None
    _, teng = _engines(smoke, 3, dict(max_len=96, paged=paged))
    _, tc = teng._pool_caches(3, spec)
    if paged:
        jc = jm.init_caches(3, 96, paged=jengine.PageSpec(page_size=32,
                                                          max_blocks=3))
        table = np.array([[1, 2, 3], [4, 5, 0], [6, 7, 8]], np.int32)
        jc = [dict(c, attn=c["attn"]._replace(block_table=jnp.asarray(
            table))) for c in jc]
        tc[0]["attn"].block_table.copy_(torch.from_numpy(table))
    else:
        jc = jm.init_caches(3, 96)
    ptrs = [t.data_ptr() for t in _lengths(tc)]
    rng = np.random.default_rng(3)
    start = np.zeros(3, np.int32)
    for valid in ([32, 20, 0], [9, 32, 0]):
        valid = np.asarray(valid, np.int32)
        toks = rng.integers(0, 256, (3, 32)).astype(np.int32)
        _, jc = jax.jit(jm.prefill_with_cache)(
            smoke["jdp"], jnp.asarray(toks), caches=jc,
            start=jnp.asarray(start), seq_lens=jnp.asarray(valid))
        _, out = tm.prefill_with_cache(
            smoke["tdp"], torch.from_numpy(toks), caches=tc,
            start=torch.from_numpy(start), seq_lens=torch.from_numpy(valid))
        assert out is tc
        start = start + valid
        for j, t in zip(jc, tc):
            np.testing.assert_array_equal(t["attn"].length.numpy(),
                                          np.asarray(j["attn"].length))
    for _ in range(2):
        tok = rng.integers(0, 256, (3, 1)).astype(np.int32)
        jl, jc = jax.jit(jm.decode_step)(smoke["jdp"], jnp.asarray(tok), jc)
        tl, out = tm.decode_step(smoke["tdp"], torch.from_numpy(tok), tc)
        assert out is tc
        live = [0, 1] if paged else [0, 1, 2]
        np.testing.assert_allclose(tl.numpy()[live], np.asarray(jl)[live],
                                   atol=ATOL, rtol=0)
        for j, t in zip(jc, tc):
            np.testing.assert_array_equal(t["attn"].length.numpy(),
                                          np.asarray(j["attn"].length))
    assert [t.data_ptr() for t in _lengths(tc)] == ptrs


def test_sync_tables_refresh_one_table_in_place_and_equal_jax(smoke):
    """Dirty host tables reach the device through ``_sync_tables``: the
    port writes the one table its ring group shares, in place, with the
    values the JAX engine puts in every layer."""
    spec = PageSpec(page_size=32, max_blocks=3, num_pages=6)
    jeng, teng = _engines(smoke, 2, dict(max_len=96, paged=True,
                                         page_size=32, max_blocks=3,
                                         num_pages=6))
    _, tc = teng._pool_caches(2, spec)
    jc = smoke["jm"].init_caches(2, 96, paged=jengine.PageSpec(
        page_size=32, max_blocks=3, num_pages=6))
    rings = teng._layer_rings(spec)
    table = tc[0]["attn"].block_table
    assert all(c["attn"].block_table is table for c in tc)
    ptr = table.data_ptr()
    arenas = {m: {96: m.PageArena(6, 32, 2, 3, 96)} for m in (jkv, tkv)}
    for step in ((0, 40), (1, 70), (0, 96)):
        for m in (jkv, tkv):
            assert arenas[m][96].grow(*step)
        assert arenas[tkv][96].dirty
        jc = jeng._sync_tables(jc, arenas[jkv], rings)
        assert teng._sync_tables(tc, arenas[tkv], rings) is None
        assert not arenas[tkv][96].dirty
        for j, t in zip(jc, tc):
            assert t["attn"].block_table.data_ptr() == ptr
            np.testing.assert_array_equal(t["attn"].block_table.numpy(),
                                          np.asarray(j["attn"].block_table))


# -- the engine's report against the JAX engine's ------------------------------

TRACES = {
    # a long prompt streams in chunks of 32 beside decoding rows: one
    # chunk width, one unified capture (tests/test_engine_unified.py)
    "fixed-chunk": dict(lens=(4, 96, 33), new=(8, 3, 4), seed=31, slots=2,
                        cache=dict(max_len=128),
                        policy=dict(prefill_chunk=32)),
    # whole prompts of 5..100 tokens on a paged pool: power-of-two widths
    "pow2-buckets": dict(lens=(5, 17, 33, 70, 100, 12, 40), new=3, seed=37,
                         slots=3, cache=dict(max_len=128, paged=True,
                                             page_size=32),
                         policy={}),
}


@pytest.mark.parametrize("name", list(TRACES))
def test_engine_tokens_and_whole_report_equal_jax(smoke, name):
    """Greedy tokens by rid and every field of the report, the capture
    counts included, equal the JAX engine's; the unified captures are
    bounded as the JAX engine's compiles are."""
    tr = TRACES[name]
    jeng, teng = _engines(smoke, tr["slots"], tr["cache"], tr["policy"])
    jres, jrep = jeng.serve(_requests(jengine, tr["lens"], tr["new"],
                                      tr["seed"]))
    tres, trep = teng.serve(_requests(tengine, tr["lens"], tr["new"],
                                      tr["seed"]))
    assert sorted(tres) == sorted(jres)
    for rid in jres:
        np.testing.assert_array_equal(tres[rid], np.asarray(jres[rid]),
                                      err_msg=f"rid {rid}")
    keys = [k for k in jrep.keys() if k not in TIMING]
    assert "unified_compiles" in keys and "engine_compiles" in keys
    assert sorted(k for k in trep.keys() if k not in TIMING) == sorted(keys)
    for k in keys:
        assert trep[k] == pytest.approx(jrep[k]), k
    assert teng._graphs.captures == jeng._compiles
    widths = {key[1] for kind, key in teng._graphs.graphs
              if kind == "unified"}
    assert trep.unified_compiles == len(widths)
    if name == "fixed-chunk":
        assert trep.unified_compiles == 1.0 and widths == {32}
    else:
        assert trep.unified_compiles <= math.log2(max(tr["lens"])) + 1
        assert trep.unified_compiles < len(tr["lens"])
    assert trep.engine_compiles == trep.unified_compiles + 1


def test_captures_stable_across_calls_and_shared_with_static(smoke):
    """Captures count per step kind and shape, over the engine's life: a
    static batch whose shape equals the pool's shares its decode step, a
    second ``serve`` captures nothing, as the JAX engine traces nothing
    again."""
    jeng, teng = _engines(smoke, 2, dict(max_len=64))
    prompts = np.random.default_rng(1).integers(0, 256, (2, 8)).astype(
        np.int32)
    for _ in range(2):
        jtok, _ = jeng.generate(prompts, max_new_tokens=3)
        ttok, _ = teng.generate(prompts, max_new_tokens=3)
        np.testing.assert_array_equal(ttok, np.asarray(jtok))
    assert teng._graphs.captures == jeng._compiles == \
        {"unified": 0, "decode": 1, "spec": 0}
    for _ in range(2):
        _, jrep = jeng.serve(_requests(jengine, (4, 9), 3, 1))
        tres, trep = teng.serve(_requests(tengine, (4, 9), 3, 1))
        assert (trep.unified_compiles, trep.engine_compiles) == \
            (jrep.unified_compiles, jrep.engine_compiles) == (1.0, 2.0)
    assert teng._graphs.captures == jeng._compiles
    assert len(teng._pools) == 1


# -- the StepGraph plumbing -----------------------------------------------------


def test_step_graph_inputs_keep_their_buffers():
    """Host arrays and tensors land in fixed static buffers, one int64
    buffer for all of them, whatever dtype they come in."""
    seen = []

    def forward(tokens, start):
        seen.append((tokens.clone(), start.clone()))
        return tokens.sum(-1) + start

    g = graphs.StepGraph(forward, {"tokens": (2, 3), "start": (2,)},
                         device=torch.device("cpu"))
    ptrs = {n: t.data_ptr() for n, t in g.inputs.items()}
    a = np.arange(6, dtype=np.int32).reshape(2, 3)
    out = g(tokens=a, start=torch.tensor([10, 20], dtype=torch.int32))
    assert out.tolist() == [13, 32]
    out = g(tokens=torch.ones(2, 3, dtype=torch.int64),
            start=np.array([1, 2]))
    assert out.tolist() == [4, 5]
    assert {n: t.data_ptr() for n, t in g.inputs.items()} == ptrs
    assert all(t.dtype == torch.int64 for t in g.inputs.values())
    assert len(seen) == 2 and g.graph is None


class _Counting:
    """A kernel wrapper that counts its CPU calls too (the real ones count
    only kernel launches, on a card)."""

    def __init__(self, fn):
        self.fn, self.launches = fn, 0

    def __call__(self, *args, **kw):
        self.launches += 1
        return self.fn(*args, **kw)


def _counting_wrappers(monkeypatch):
    import importlib
    for mod, fn in kernels.KERNELS.values():
        ops = importlib.import_module(f"repro_torch.kernels.{mod}.ops")
        monkeypatch.setattr(ops, fn, _Counting(getattr(ops, fn)))


def test_credited_launches_equal_the_counted_eager_ones(smoke, monkeypatch):
    """A step records the launch deltas of one run, and crediting adds
    them: one eager decode step, the first run of the step's graph (its
    record) and ``credit_launches`` of that record move the counters by
    the same amounts."""
    _counting_wrappers(monkeypatch)
    tm, tdp = smoke["tm"], smoke["tdp"]
    tok = np.random.default_rng(4).integers(0, 256, (2, 1))
    eager = tm.init_caches(2, 16, "cpu")
    kernels.reset_launch_counts()
    tm.decode_step(tdp, torch.from_numpy(tok), eager)
    counted = {n: c for n, c in kernels.launch_counts().items() if c}
    assert counted["rbmm_int"] > 0 and counted["pack_threshold"] > 0
    caches = tm.init_caches(2, 16, "cpu")
    g = graphs.StepGraph(lambda tokens: tm.decode_step(tdp, tokens,
                                                       caches)[0],
                         {"tokens": (2, 1)}, device=torch.device("cpu"),
                         state=graphs.cache_tensors(caches))
    kernels.reset_launch_counts()
    g(tokens=tok)
    assert g.launches == counted
    assert kernels.launch_counts() == {n: counted.get(n, 0)
                                       for n in kernels.KERNELS}
    kernels.reset_launch_counts()
    kernels.credit_launches(g.launches)
    kernels.credit_launches(g.launches)
    assert kernels.launch_counts() == {n: 2 * counted.get(n, 0)
                                       for n in kernels.KERNELS}
    kernels.reset_launch_counts()


def test_prefill_logits_graph_runs_the_encoder_forward():
    """The encoder's forward at a fixed (B, S) through the capture class:
    on the CPU the same logits as ``prefill_logits``, bit for bit."""
    cfg = tbase.get_smoke_config("bert-base-cobra")
    model = tbuild(cfg)
    dp = model.convert(model.init(torch.Generator().manual_seed(0)))
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 24))
    g = graphs.prefill_logits_graph(model, dp, 2, 24, device="cpu")
    with torch.inference_mode():
        want = model.prefill_logits(dp, toks, device="cpu")
    got = g(tokens=toks)
    assert got.shape == (2, 24, cfg.vocab_size)
    assert torch.equal(got, want)
