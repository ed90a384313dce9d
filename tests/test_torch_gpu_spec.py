"""Speculative decode on a CUDA card: every call the speculative iteration
makes, kernel against its plain version; the iteration captured as one
graph against the same iteration run eagerly, on a ring and on a paged
trunk; a small speculative serve on the card against the CPU; no
allocation over 100 replays.

Kernels and plain versions must agree bitwise, replays must give the
eager iteration's tokens, caches and launch counts bit for bit (the same
kernels on the same inputs; the uniforms of the stochastic samplers are
inputs of the graph).

Marked ``gpu``: without a card every test skips (the decision is made in
a fixture, so every worker collects the same tests).  On a card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu_spec.py

This file imports no JAX."""
import test_torch_threads  # noqa: F401  (first: one torch thread)
import numpy as np
import pytest
import torch

from repro_torch import kernels, to_device
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.launch import kernel_times
from repro_torch.models.lm import build_model
from repro_torch.serve import sampler
from repro_torch.serve.engine import (CacheConfig, PolicyConfig, Request,
                                      ServeConfig, ServeEngine, SpecConfig)

pytestmark = pytest.mark.gpu

SIZES = {"smoke": lambda: get_smoke_config("smollm-135m"),
         "full": lambda: get_config("smollm-135m").with_(num_layers=2)}
K = 4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: runs the speculative iteration's "
                    "kernels and its captured graph")
    return torch.device("cuda")


def _model(size, seed=0):
    model = build_model(SIZES[size]())
    with torch.inference_mode():
        gen = torch.Generator(device="cuda").manual_seed(seed)
        return model, model.convert(model.init(gen))


def _clone(caches):
    return [{k: type(v)(*[t.clone() if isinstance(t, torch.Tensor) else t
                          for t in v]) for k, v in c.items()}
            for c in caches]


def _shared_table(caches):
    t = caches[0]["attn"].block_table
    return [dict(c, attn=c["attn"]._replace(block_table=t)) for c in caches]


def _equal_caches(a, b, paged):
    """Pages 1.. (the trash page takes inactive rows' writes in no fixed
    order) or whole rings, and lengths."""
    for x, y in zip(a, b):
        x, y = x["attn"], y["attn"]
        if paged and hasattr(x, "k_pages"):
            pairs = ((x.k_pages[1:], y.k_pages[1:]),
                     (x.vt_pages[1:], y.vt_pages[1:]), (x.length, y.length))
        else:
            pairs = [(s, t) for s, t in zip(x, y)
                     if isinstance(s, torch.Tensor)]
        if not all(torch.equal(s, t) for s, t in pairs):
            return False
    return True


@pytest.mark.parametrize("kernel", ["rbmm_int", "rbmm_mxu",
                                    "pack_threshold"])
@torch.inference_mode()
def test_spec_calls_kernel_equals_plain(cuda, kernel):
    """Each call of the speculative iteration (``kernel_times.SPEC_CALLS``)
    at its exact shape: the wrapper's kernel, one launch, bitwise equal to
    ``ref.py``."""
    calls = {n: c for n, c in kernel_times.spec_operands(3).items()
             if c[0] == kernel}
    assert calls
    for name, (_, call, plain, _, _) in calls.items():
        kernels.reset_launch_counts()
        got = call()
        assert kernels.launch_counts()[kernel] == 1, name
        want = plain()
        assert got.shape == want.shape and got.dtype == want.dtype, name
        assert torch.equal(got, want), name


def _engine(model, dp, sampler_name="greedy", paged=False):
    cache = (CacheConfig(paged=True, page_size=32, max_blocks=4,
                         num_pages=12) if paged else CacheConfig(max_len=128))
    return ServeEngine(model, dp, ServeConfig(
        num_slots=4, sampler=sampler_name, temperature=1.5, cache=cache,
        spec=SpecConfig(k=K)))


def _replay_against_eager(model, dp, eng, paged, iters=3, rand_seed=None):
    """A unified chunk (the draft ingesting it too), then ``iters``
    speculative iterations, each as a replay of the engine's graphs and
    eagerly on cloned caches: live rows' outputs, the trunk's caches
    (pages 1..), the draft's rings and the launches credited must equal
    the eager run's."""
    b, live = 4, 3
    spec = eng.cfg.page_spec() if paged else None
    key, caches = eng._pool_caches(b, spec)
    eng._resolve_draft()
    draft = eng._draft_caches(b, spec.capacity if spec else 128)
    if paged:
        table = np.zeros((b, 4), np.int32)
        table[:live] = 1 + np.arange(4 * live).reshape(live, 4)
        caches[0]["attn"].block_table.copy_(torch.from_numpy(table))
    eager = _clone(caches)
    if paged:
        eager = _shared_table(eager)
    deager = _clone(draft[1])
    rng = np.random.default_rng(5)
    valid = np.zeros(b, np.int64)
    valid[:live] = rng.integers(5, 40, live)
    toks = rng.integers(0, model.cfg.vocab_size, (b, 64))
    start = np.zeros(b, np.int64)
    dev = torch.device("cuda")
    t = lambda a: torch.from_numpy(np.asarray(a)).to(dev)
    got = eng._unified_graph(key, caches, 64, draft)(
        tokens=toks, start=start, valid=valid, fresh=(valid > 0) * 1)
    want, _ = model.prefill_with_cache(dp, t(toks), caches=eager,
                                       start=t(start), seq_lens=t(valid))
    eng.draft_model.prefill_with_cache(eng.draft_dparams, t(toks),
                                       caches=deager, start=t(start),
                                       seq_lens=t(valid))
    assert torch.equal(got[:live], want[:live])
    assert _equal_caches(caches, eager, paged)
    assert _equal_caches(draft[1], deager, False)
    graph = eng._spec_graph(key, caches, draft)
    step = eng.spec_forward(eager, deager)
    pending = want[:, -1].argmax(-1, keepdim=True).cpu().numpy()
    start, active = valid.copy(), (valid > 0) * 1
    gen = torch.Generator(device=dev).manual_seed(rand_seed or 0)
    for i in range(iters):
        inputs = dict(tokens=pending, start=start, active=active)
        if rand_seed is not None:
            inputs["rand"] = torch.randint(0, 2 ** sampler.UNIFORM_BITS,
                                           (b, 2 * K + 2), generator=gen,
                                           device=dev)
        kernels.reset_launch_counts()
        res_g = graph(**inputs).clone()
        credited = kernels.launch_counts()
        kernels.reset_launch_counts()
        res_e = step(**{n: t(v) if not isinstance(v, torch.Tensor) else v
                        for n, v in inputs.items()})
        if i:       # the first graph call captures: its credit is one run
            assert credited == kernels.launch_counts()
        assert torch.equal(res_g[:live], res_e[:live]), i
        assert _equal_caches(caches, eager, paged), i
        assert _equal_caches(draft[1], deager, False), i
        res = res_e.cpu().numpy()
        n_acc = res[:, K + 1]
        pending = res[np.arange(b), n_acc][:, None]
        start = start + active * (n_acc + 1)
    return graph


@pytest.mark.parametrize("paged", [False, True], ids=["ring", "paged"])
@pytest.mark.parametrize("size", list(SIZES))
@torch.inference_mode()
def test_spec_replays_equal_eager(cuda, size, paged):
    model, dp = _model(size)
    _replay_against_eager(model, dp, _engine(model, dp, paged=paged), paged)


@torch.inference_mode()
def test_stochastic_spec_replays_equal_eager(cuda):
    """top_k sampling: the uniforms are graph inputs, so a replay draws
    exactly what the eager iteration draws from the same uniforms."""
    model, dp = _model("smoke")
    _replay_against_eager(model, dp, _engine(model, dp, "top_k",
                                             paged=True), True, rand_seed=7)


@torch.inference_mode()
def test_spec_replays_allocate_nothing(cuda):
    model, dp = _model("smoke")
    graph = _replay_against_eager(model, dp, _engine(model, dp), False,
                                  iters=2)
    b = 4
    inputs = dict(tokens=np.zeros((b, 1), np.int64),
                  start=np.full(b, 50, np.int64), active=np.zeros(b, np.int64))
    graph(**inputs)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    for _ in range(100):
        graph(**inputs)
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated() == before


def test_spec_serve_card_equals_cpu(cuda):
    """Greedy speculative serving, paged with prefix sharing, chunks and
    preemption, float32: the card's tokens and counters are the CPU's."""
    model, dp = _model("smoke")
    rng = np.random.default_rng(9)
    shared = rng.integers(0, 256, 32)
    prompts = [np.concatenate([shared, rng.integers(0, 256, n)])
               for n in (3, 9)] + [rng.integers(0, 256, n) for n in (30, 20)]
    cfg = ServeConfig(num_slots=2, cache=CacheConfig(
        paged=True, page_size=32, max_blocks=3, num_pages=4),
        policy=PolicyConfig(prefill_chunk=32), spec=SpecConfig(k=K))
    runs = {}
    for dev, params in (("cuda", dp), ("cpu", to_device(dp, "cpu"))):
        reqs = [Request(rid=i, tokens=p.astype(np.int32), max_new_tokens=12)
                for i, p in enumerate(prompts)]
        runs[dev] = ServeEngine(model, params, cfg, device=dev).serve(reqs)
    (card, rep_card), (cpu, rep_cpu) = runs["cuda"], runs["cpu"]
    for rid in cpu:
        np.testing.assert_array_equal(card[rid], cpu[rid], err_msg=str(rid))
    for name in ("spec_steps", "spec_drafted", "spec_accepted",
                 "pages_freed_rollback", "preemptions", "prefix_hits",
                 "iterations", "unified_compiles", "engine_compiles"):
        assert rep_card[name] == rep_cpu[name], name
    assert rep_cpu["spec_steps"] > 0
