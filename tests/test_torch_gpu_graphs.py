"""The engine's steps as captured CUDA graphs (``serve/graphs.py``) against
the same steps run eagerly, on a CUDA card: the static decode step, the
pooled unified and decode steps on a paged pool (an inactive row on the
trash page, a copy-on-write page copy between replays), the engine's
``generate`` and ``serve`` (preemption, prefix sharing), and the encoder
forward; at smoke size (float32) and at full width (bf16, depth cut to 2
layers).  Replays must give the eager logits bit for bit (the same kernels
on the same inputs; the head's cuBLAS call included), allocate nothing,
and credit the eager step's launch counts.

Marked ``gpu``: without a card every test skips (the decision is made in
a fixture, so every worker collects the same tests).  On a card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu_graphs.py

This file imports no JAX."""
import test_torch_threads  # noqa: F401  (first: one torch thread)
import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models.attention import PageSpec
from repro_torch.models.lm import build_model
from repro_torch.serve import engine as eng_lib
from repro_torch.serve import graphs
from repro_torch.serve.engine import (CacheConfig, PolicyConfig, Request,
                                      ServeConfig, ServeEngine)

pytestmark = pytest.mark.gpu

SIZES = {"smoke": lambda a: get_smoke_config(a),
         "full": lambda a: get_config(a).with_(num_layers=2)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: replays captured CUDA graphs of the "
                    "engine's steps against the eager steps")
    return torch.device("cuda")


def _model(arch, size, seed=0):
    model = build_model(SIZES[size](arch))
    with torch.inference_mode():
        gen = torch.Generator(device="cuda").manual_seed(seed)
        return model, model.convert(model.init(gen))


def _clone(caches):
    return [{k: type(v)(*[t.clone() if isinstance(t, torch.Tensor) else t
                          for t in v]) for k, v in c.items()}
            for c in caches]


def _shared_table(caches):
    """One block table for every layer, as the engine holds it."""
    t = caches[0]["attn"].block_table
    return [dict(c, attn=c["attn"]._replace(block_table=t)) for c in caches]


def _tokens(model, shape, seed):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, model.cfg.vocab_size, shape)).cuda()


@pytest.mark.parametrize("size", list(SIZES))
@torch.inference_mode()
def test_static_decode_replays_equal_eager(cuda, size):
    model, dp = _model("smollm-135m", size)
    b, s = 4, 40
    logits, eager = model.prefill_with_cache(dp, _tokens(model, (b, s), 1),
                                             max_len=64)
    caches = _clone(eager)
    g = graphs.StepGraph(lambda tokens: model.decode_step(dp, tokens,
                                                          caches)[0],
                         {"tokens": (b, 1)}, device=cuda,
                         state=graphs.cache_tensors(caches))
    tok = logits.argmax(-1)
    for step in range(6):
        want, _ = model.decode_step(dp, tok, eager)
        got = g(tokens=tok)
        assert torch.equal(got, want), step
        tok = want[:, -1:].argmax(-1)
    for a, c in zip(graphs.cache_tensors(eager),
                    graphs.cache_tensors(caches)):
        assert torch.equal(a, c)


def _paged_pair(model, dp, cuda):
    """Eager and graphed paged caches of 4 rows (row 2 inactive: its table
    row is the trash page), and the unified and decode graphs of the
    graphed ones."""
    spec = PageSpec(page_size=32, max_blocks=4, num_pages=12)
    eager = _shared_table(model.init_caches(4, 0, cuda, paged=spec))
    table = torch.tensor([[1, 2, 3, 0], [4, 5, 0, 0], [0, 0, 0, 0],
                          [6, 7, 8, 9]], dtype=torch.int32, device=cuda)
    eager[0]["attn"].block_table.copy_(table)
    caches = _shared_table(_clone(eager))
    state = graphs.cache_tensors(caches)

    def unified(tokens, start, valid):
        return model.prefill_with_cache(dp, tokens, caches=caches,
                                        start=start, seq_lens=valid)[0]
    uni = graphs.StepGraph(unified, {"tokens": (4, 32), "start": (4,),
                                     "valid": (4,)}, device=cuda,
                           state=state)
    dec = graphs.StepGraph(lambda tokens: model.decode_step(
        dp, tokens, caches)[0], {"tokens": (4, 1)}, device=cuda, state=state)
    return eager, caches, uni, dec


def _assert_pages_equal(eager, caches):
    """Pages 1.. and every length (inactive rows included); the trash page
    takes colliding writes in an order no version fixes."""
    for e, c in zip(eager, caches):
        e, c = e["attn"], c["attn"]
        assert torch.equal(e.k_pages[1:], c.k_pages[1:])
        assert torch.equal(e.vt_pages[1:], c.vt_pages[1:])
        assert torch.equal(e.length, c.length)


@pytest.mark.parametrize("size", list(SIZES))
@torch.inference_mode()
def test_paged_unified_and_decode_replays_equal_eager(cuda, size):
    """Chunks of one width with ragged and zero valid counts, decode steps,
    then a copy-on-write copy and a table change between replays: the
    live rows' logits bit for bit, the pages and lengths equal."""
    model, dp = _model("smollm-135m", size)
    eager, caches, uni, dec = _paged_pair(model, dp, cuda)
    live = [0, 1, 3]
    start = torch.zeros(4, dtype=torch.int64, device=cuda)
    for i, valid in enumerate(([32, 20, 0, 32], [32, 12, 0, 32],
                               [7, 0, 0, 32])):
        valid = torch.tensor(valid, device=cuda)
        toks = _tokens(model, (4, 32), 10 + i)
        want = model.prefill_with_cache(dp, toks, caches=eager, start=start,
                                        seq_lens=valid)[0]
        got = uni(tokens=toks, start=start, valid=valid)
        assert torch.equal(got[live], want[live]), i
        start = start + valid
        _assert_pages_equal(eager, caches)
    tok = _tokens(model, (4, 1), 20)
    for step in range(3):
        if step == 2:
            # copy-on-write of row 1's page 5 into page 10, then the table
            # points there: eager ops between replays, on the fixed tensors
            for cs in (eager, caches):
                eng_lib.ServeEngine._copy_pages(cs, [128] * len(cs),
                                                {128: [(5, 10)]})
                cs[0]["attn"].block_table[1, 1] = 10
        want, _ = model.decode_step(dp, tok, eager)
        got = dec(tokens=tok)
        assert torch.equal(got[live], want[live]), step
        _assert_pages_equal(eager, caches)
        tok = want[:, -1:].argmax(-1)


@torch.inference_mode()
def test_replays_allocate_nothing_and_credit_launches(cuda):
    """After capture, 100 replays of the unified and the decode step leave
    ``memory_allocated`` unchanged, and each replay credits the launches
    the eager step counts (the capture credits none)."""
    model, dp = _model("smollm-135m", "full")
    eager, caches, uni, dec = _paged_pair(model, dp, cuda)
    start = torch.zeros(4, dtype=torch.int64, device=cuda)
    valid = torch.tensor([32, 20, 0, 32], device=cuda)
    toks = _tokens(model, (4, 32), 3)
    tok = _tokens(model, (4, 1), 4)
    counted = {}
    for name, run in (("unified", lambda: model.prefill_with_cache(
            dp, toks, caches=eager, start=start, seq_lens=valid)),
            ("decode", lambda: model.decode_step(dp, tok, eager))):
        kernels.reset_launch_counts()
        run()
        counted[name] = kernels.launch_counts()
    assert counted["decode"]["paged_gather_decode"] == model.cfg.num_layers
    for name, g, kw in (("unified", uni, dict(tokens=toks, start=start,
                                              valid=valid)),
                        ("decode", dec, dict(tokens=tok))):
        kernels.reset_launch_counts()
        g(**kw)                          # warm-up (counted), capture, replay
        assert kernels.launch_counts() == {
            n: 2 * c for n, c in counted[name].items()}, name
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        kernels.reset_launch_counts()
        for _ in range(100):
            g(**kw)
        torch.cuda.synchronize()
        assert torch.cuda.memory_allocated() == before, name
        assert kernels.launch_counts() == {
            n: 100 * c for n, c in counted[name].items()}, name


def _eager_steps(monkeypatch):
    """Run every StepGraph's forward eagerly on the card, on its static
    buffers: the engine's eager path, for this test only."""
    def call(self, **values):
        for name, v in values.items():
            self.inputs[name].copy_(torch.as_tensor(v))
        return self.forward(**self.inputs)
    monkeypatch.setattr(graphs.StepGraph, "__call__", call)


def _continuous(prompts, new):
    return [Request(rid=i, tokens=p.astype(np.int32), max_new_tokens=new)
            for i, p in enumerate(prompts)]


@pytest.mark.parametrize("size", list(SIZES))
def test_static_generate_graphed_equals_eager(cuda, size, monkeypatch):
    """``generate`` of a static batch, twice on one engine: one decode
    capture, and the eager engine's tokens."""
    model, dp = _model("smollm-135m", size)
    prompts = np.random.default_rng(6).integers(0, model.cfg.vocab_size,
                                                (4, 24))
    cfg = ServeConfig(cache=CacheConfig(max_len=40))
    eng = ServeEngine(model, dp, cfg)
    got = [eng.generate(prompts, max_new_tokens=8)[0] for _ in range(2)]
    assert eng._graphs.captures == {"unified": 0, "decode": 1, "spec": 0}
    assert all(g.graph is not None for g in eng._graphs.graphs.values())
    _eager_steps(monkeypatch)
    want, _ = ServeEngine(model, dp, cfg).generate(prompts,
                                                   max_new_tokens=8)
    for g in got:
        np.testing.assert_array_equal(g, want)


def test_serve_graphed_equals_eager_and_captures_once(cuda, monkeypatch):
    """Continuous serving on a 3-page arena (a preemption, a prefix hit,
    chunks of 32), twice on one engine: the captures do not move on the
    second call, and tokens by rid and the engine's counters equal the
    eager engine's."""
    model, dp = _model("smollm-135m", "smoke")
    rng = np.random.default_rng(2)
    shared = rng.integers(0, 256, 32)
    prompts = [np.concatenate([shared, rng.integers(0, 256, n)])
               for n in (2, 8)] + [rng.integers(0, 256, n) for n in (30, 29)]
    cfg = ServeConfig(num_slots=2, cache=CacheConfig(
        paged=True, page_size=32, max_blocks=2, num_pages=3),
        policy=PolicyConfig(prefill_chunk=32))
    eng = ServeEngine(model, dp, cfg)
    runs = [eng.serve(_continuous(prompts, 6)) for _ in range(2)]
    assert eng._graphs.captures == {"unified": 1, "decode": 1, "spec": 0}
    _eager_steps(monkeypatch)
    want, wrep = ServeEngine(model, dp, cfg).serve(_continuous(prompts, 6))
    assert wrep.preemptions >= 1 and wrep.prefix_hits >= 1
    for res, rep in runs:
        assert sorted(res) == sorted(want)
        for rid in want:
            np.testing.assert_array_equal(res[rid], want[rid])
        for k in ("preemptions", "prefix_hits", "iterations",
                  "prefill_chunks", "peak_page_utilization",
                  "pages_freed_retire", "unified_compiles",
                  "engine_compiles"):
            assert rep[k] == wrep[k], k


@pytest.mark.parametrize("size", list(SIZES))
@torch.inference_mode()
def test_encoder_graph_equals_eager(cuda, size):
    """``prefill_logits`` of bert-base-cobra through the capture class:
    the eager logits bit for bit, the eager launches credited per replay,
    nothing allocated across 100 replays."""
    model, dp = _model("bert-base-cobra", size)
    b, s = 2, 128
    g = graphs.prefill_logits_graph(model, dp, b, s)
    for i in range(2):
        toks = _tokens(model, (b, s), 30 + i)
        kernels.reset_launch_counts()
        want = model.prefill_logits(dp, toks)
        counted = kernels.launch_counts()
        assert counted["rbmm_binary"] > 0
        got = g(tokens=toks.cpu().numpy() if i else toks)
        assert torch.equal(got, want), i
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    kernels.reset_launch_counts()
    for _ in range(100):
        g(tokens=toks)
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated() == before
    assert kernels.launch_counts() == {n: 100 * c
                                       for n, c in counted.items()}
