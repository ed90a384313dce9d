"""The recurrent families on a CUDA card: the card twins of
``test_torch_ssm.py``, ``test_torch_recurrent_lm.py`` and
``test_torch_recurrent_serve.py``.

Every kernel call of hymba-1.5b's and xlstm-350m's serve paths at full
width (``kernel_times.RECURRENT_CALLS``: the projections at K = 1,600,
3,200, 5,504, 1,024 and 2,048 on both ``rbmm_int`` routes and
``rbmm_mxu``, ``sps_attention`` at H = 25/5 with a window of 1,024,
``paged_gather_decode`` at G = 5, the chunk attend at M = 640, the packs)
against its plain version, bitwise, one launch each.  The smoke configs
(float32): prefill then greedy decode on the card equal to the CPU's
(tokens exact, logits and carries within ATOL); the decode step and the
unified step (with the fresh rows' reset) captured as CUDA graphs equal
to the eager steps bitwise, carries included, an inactive row's carries
untouched; continuous serving on the card equal to the CPU's by rid.

Marked ``gpu``: without a card every test skips (the decision is made in
a fixture, so every worker collects the same tests).  On a card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu_recurrent.py

This file imports no JAX."""
import test_torch_threads  # noqa: F401  (first: one torch thread)
import numpy as np
import pytest
import torch

from repro_torch import kernels, to_device
from repro_torch.configs import get_smoke_config
from repro_torch.launch import kernel_times
from repro_torch.models.attention import PageSpec
from repro_torch.models.lm import build_model
from repro_torch.serve import engine as E
from repro_torch.serve import graphs, trace

pytestmark = pytest.mark.gpu

# float32 logits and carries; the scans', the norms' and the head's sums
# differ in order between the devices
ATOL = 2e-3
ARCHS = ("hymba-1.5b", "xlstm-350m")
KERNELS = ("rbmm_int", "rbmm_mxu", "pack_threshold", "sps_attention",
           "paged_gather_decode")
SPEC = PageSpec(page_size=32, max_blocks=3, num_pages=5)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: compares each kernel with its "
                    "plain version on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _model(arch, cuda):
    cfg = get_smoke_config(arch)
    model = build_model(cfg)
    with torch.inference_mode():
        dp = model.convert(model.init(
            torch.Generator(device=cuda).manual_seed(0)))
    return model, dp, to_device(dp, "cpu")


def _carries(caches):
    return [t for layer in caches for name, part in layer.items()
            if name != "attn" for t in part]


def _tensors(caches):
    return [t for layer in caches for part in layer.values() for t in part
            if isinstance(t, torch.Tensor)]


@pytest.mark.parametrize("kernel", KERNELS)
def test_recurrent_calls(cuda, kernel):
    names = [n for n, c in kernel_times.RECURRENT_CALLS.items()
             if c[0] == kernel]
    assert names
    for name in names:
        (_, call, plain, _, _), = kernel_times.call_operands(
            {name: kernel_times.RECURRENT_CALLS[name]}, 7).values()
        before = kernels.launch_counts()[kernel]
        got = call()
        assert kernels.launch_counts()[kernel] == before + 1, name
        want = plain()
        assert got.dtype == want.dtype and torch.equal(got, want), name
        del call, plain, got, want


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_greedy_decode_card_equals_cpu(cuda, arch):
    model, dp, on_cpu = _model(arch, cuda)
    toks = np.random.default_rng(1).integers(0, 256, (2, 40))
    out = {}
    with torch.inference_mode():
        for key, dev, params in (("card", cuda, dp), ("cpu", "cpu", on_cpu)):
            lg, caches = model.prefill_with_cache(
                params, torch.as_tensor(toks, device=dev), max_len=48)
            seq, lgs = [], [lg.cpu()]
            for _ in range(4):
                tok = lg[:, -1:].argmax(-1)
                seq.append(tok.cpu())
                lg, caches = model.decode_step(params, tok, caches)
                lgs.append(lg.cpu())
            out[key] = (torch.cat(seq, 1), lgs, [t.cpu() for t in
                                                 _carries(caches)])
    assert torch.equal(out["card"][0], out["cpu"][0])
    for a, b in zip(out["card"][1] + out["card"][2],
                    out["cpu"][1] + out["cpu"][2]):
        assert (a - b).abs().max().item() <= ATOL


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_graph_equals_eager(cuda, arch):
    """Four decode steps replayed from a graph and run eagerly from the
    same prefilled state: logits and every cache tensor bitwise equal."""
    model, dp, _ = _model(arch, cuda)
    toks = torch.as_tensor(np.random.default_rng(2).integers(
        0, 256, (3, 20)), device=cuda)
    with torch.inference_mode():
        _, eager = model.prefill_with_cache(dp, toks, max_len=32)
        _, caches = model.prefill_with_cache(dp, toks, max_len=32)
        g = graphs.StepGraph(
            lambda tokens: model.decode_step(dp, tokens, caches)[0],
            {"tokens": (3, 1)}, device=cuda,
            state=graphs.cache_tensors(caches))
        tok = torch.zeros(3, 1, dtype=torch.int64, device=cuda)
        for _ in range(4):
            want, _ = model.decode_step(dp, tok, eager)
            got = g(tokens=tok)
            assert torch.equal(got, want)
            for a, b in zip(_tensors(eager), _tensors(caches)):
                assert torch.equal(a, b)
            tok = want[:, -1:].argmax(-1)


@pytest.mark.parametrize("arch", ARCHS)
def test_unified_graph_resets_and_freezes_rows(cuda, arch):
    """The engine's unified step (fresh rows reset, then the chunk) as a
    graph on a paged pool against the eager step: bitwise; row 1 (valid
    0, not fresh) keeps every carry bit for bit."""
    model, dp, _ = _model(arch, cuda)
    rng = np.random.default_rng(3)
    toks0 = torch.as_tensor(rng.integers(0, 256, (3, 8)), device=cuda)
    with torch.inference_mode():
        pools = []
        for _ in range(2):
            pool = model.init_caches(3, 0, cuda, paged=SPEC)
            for c in pool:
                if "attn" in c:
                    c["attn"].block_table.copy_(torch.arange(
                        1, 4, device=cuda, dtype=torch.int32)[:, None])
            model.prefill_with_cache(
                dp, toks0, caches=pool,
                start=torch.zeros(3, dtype=torch.int64, device=cuda),
                seq_lens=torch.full((3,), 8, device=cuda))
            pools.append(pool)
        eager, caches = pools
        idle = [t[1].clone() for t in _carries(caches)]

        def forward(tokens, start, valid, fresh):
            model.reset_recurrent_rows(caches, fresh != 0)
            return model.prefill_with_cache(dp, tokens, caches=caches,
                                            start=start, seq_lens=valid)[0]
        g = graphs.StepGraph(forward, {"tokens": (3, 16), "start": (3,),
                                       "valid": (3,), "fresh": (3,)},
                             device=cuda, state=graphs.cache_tensors(caches))
        inputs = dict(tokens=rng.integers(0, 256, (3, 16)),
                      start=np.array([8, 8, 0]), valid=np.array([16, 0, 5]),
                      fresh=np.array([0, 0, 1]))
        model.reset_recurrent_rows(eager, torch.tensor(
            [False, False, True], device=cuda))
        want = model.prefill_with_cache(
            dp, torch.as_tensor(inputs["tokens"], device=cuda),
            caches=eager, start=torch.as_tensor(inputs["start"], device=cuda),
            seq_lens=torch.as_tensor(inputs["valid"], device=cuda))[0]
        got = g(**inputs)
    assert torch.equal(got[[0, 2]], want[[0, 2]])
    for a, b in zip(_tensors(eager), _tensors(caches)):
        assert torch.equal(a, b)
    for t, t0 in zip(_carries(caches), idle):
        assert torch.equal(t[1], t0)


@pytest.mark.parametrize("arch", ARCHS)
def test_continuous_serve_card_equals_cpu(cuda, arch):
    model, dp, on_cpu = _model(arch, cuda)
    out = []
    for dev, params in ((cuda, dp), ("cpu", on_cpu)):
        reqs = trace.as_requests(trace.generate_trace(trace.TraceConfig(
            n_requests=6, mean_prompt=24, max_prompt=60, mean_new=5,
            max_new=8, vocab=256, seed=0, tenants=(trace.TenantSpec(
                "default", system_prompt_len=32),))))
        for r in reqs:
            r.arrival_s = 0.0
        cfg = E.ServeConfig(num_slots=3, cache=E.CacheConfig(
            max_len=96, paged=True, page_size=32, max_blocks=3,
            num_pages=5), policy=E.PolicyConfig(prefill_chunk=32))
        with torch.inference_mode():
            out.append(E.ServeEngine(model, params, cfg,
                                     device=dev).serve(reqs))
    (card, rc), (cpu, rp) = out
    assert sorted(card) == sorted(cpu)
    for rid in cpu:
        np.testing.assert_array_equal(card[rid], cpu[rid])
    for k in ("iterations", "prefill_chunks", "unified_compiles"):
        assert rc[k] == rp[k], k
