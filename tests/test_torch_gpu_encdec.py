"""The encoder-decoder and the frontend stub on a CUDA card: the card twins
of ``test_torch_cross.py``, ``test_torch_encdec.py`` and
``test_torch_frontend.py``.

Every kernel call of seamless-m4t-large-v2's and internvl2-76b's static
serve paths at full width (``kernel_times.ENCDEC_CALLS``: the encoder's
bidirectional ``sps_attention`` at L = 1,024, the cross score and context
on both ``rbmm_int`` routes over memories of 1,024 frames, the fused F1
``rbmm_binary`` at M = 4, internvl2's prefill projections at M = 4,352,
the packs) against its plain version, bitwise, one launch each.  The smoke
configs (float32): prefill then greedy decode on the card equal to the
CPU's (tokens exact, logits within ATOL; seamless over memories of 8 and
40 frames), the static engine's tokens equal on both devices; the decode
step captured as a CUDA graph equal to the eager step bitwise, caches
included (the memories unwritten); ``prefill_logits`` captured as one
graph equal to the eager forward.

Marked ``gpu``: without a card every test skips (the decision is made in
a fixture, so every worker collects the same tests).  On a card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu_encdec.py

This file imports no JAX."""
import test_torch_threads  # noqa: F401  (first: one torch thread)
import numpy as np
import pytest
import torch

from repro_torch import kernels, to_device
from repro_torch.configs import get_smoke_config
from repro_torch.launch import kernel_times
from repro_torch.models.lm import build_model
from repro_torch.serve import engine as E
from repro_torch.serve import graphs

pytestmark = pytest.mark.gpu

# float32 logits; the norms', the encoder's and the head's sums differ in
# order between the devices
ATOL = 2e-3
CASES = (("seamless-m4t-large-v2", 8), ("seamless-m4t-large-v2", 40),
         ("internvl2-76b", 8))
KERNELS = ("rbmm_int", "rbmm_binary", "rbmm_mxu", "pack_threshold",
           "sps_attention")
B, S, NEW = 2, 20, 4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: compares each kernel with its "
                    "plain version on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _model(arch, cuda):
    model = build_model(get_smoke_config(arch))
    with torch.inference_mode():
        dp = model.convert(model.init(
            torch.Generator(device=cuda).manual_seed(0)))
    return model, dp, to_device(dp, "cpu")


def _inputs(model, frames, seed=1):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, model.cfg.vocab_size, (B, S))
    fe = rng.standard_normal((B, frames, model.frontend_dim),
                             dtype=np.float32)
    # a decoder-only model's rings hold the frontend embeddings too
    prefix = frames if hasattr(model, "plan") else 0
    return toks, fe, S + NEW + prefix


def _tensors(caches):
    return [t for layer in caches for part in layer.values() for t in part
            if isinstance(t, torch.Tensor)]


@pytest.mark.parametrize("kernel", KERNELS)
def test_encdec_calls(cuda, kernel):
    names = [n for n, c in kernel_times.ENCDEC_CALLS.items()
             if c[0] == kernel]
    assert names
    for name in names:
        (_, call, plain, _, _), = kernel_times.call_operands(
            {name: kernel_times.ENCDEC_CALLS[name]}, 7).values()
        before = kernels.launch_counts()[kernel]
        got = call()
        assert kernels.launch_counts()[kernel] == before + 1, name
        want = plain()
        pairs = zip(got, want) if isinstance(got, tuple) else [(got, want)]
        for a, b in pairs:
            assert a.dtype == b.dtype and torch.equal(a, b), name
        del call, plain, got, want
        torch.cuda.empty_cache()


@pytest.mark.parametrize("arch,frames", CASES)
def test_prefill_and_greedy_decode_card_equals_cpu(cuda, arch, frames):
    model, dp, on_cpu = _model(arch, cuda)
    toks, fe, max_len = _inputs(model, frames)
    out = {}
    with torch.inference_mode():
        for key, dev, params in (("card", cuda, dp), ("cpu", "cpu", on_cpu)):
            lg, caches = model.prefill_with_cache(
                params, torch.as_tensor(toks, device=dev), max_len=max_len,
                frontend_embeds=torch.as_tensor(fe, device=dev))
            seq, lgs = [], [lg.cpu()]
            for _ in range(NEW):
                tok = lg[:, -1:].argmax(-1)
                seq.append(tok.cpu())
                lg, caches = model.decode_step(params, tok, caches)
                lgs.append(lg.cpu())
            out[key] = (torch.cat(seq, 1), lgs)
    assert torch.equal(out["card"][0], out["cpu"][0])
    for a, b in zip(out["card"][1], out["cpu"][1]):
        assert (a - b).abs().max().item() <= ATOL
    cfg = E.ServeConfig(cache=E.CacheConfig(max_len=max_len))
    for dev, params in ((cuda, dp), ("cpu", on_cpu)):
        toks_eng, _ = E.ServeEngine(model, params, cfg, device=dev).generate(
            toks, max_new_tokens=NEW, frontend_embeds=fe)
        assert np.array_equal(toks_eng, out["cpu"][0].numpy())


@pytest.mark.parametrize("arch,frames", CASES[1:])
def test_decode_graph_equals_eager(cuda, arch, frames):
    """Four decode steps replayed from a graph and run eagerly from the
    same prefilled state: logits and every cache tensor bitwise equal,
    the memories as the prefill left them."""
    model, dp, _ = _model(arch, cuda)
    toks, fe, max_len = _inputs(model, frames, seed=2)
    t = torch.as_tensor(toks, device=cuda)
    f = torch.as_tensor(fe, device=cuda)
    with torch.inference_mode():
        _, eager = model.prefill_with_cache(dp, t, max_len=max_len,
                                            frontend_embeds=f)
        _, caches = model.prefill_with_cache(dp, t, max_len=max_len,
                                             frontend_embeds=f)
        memories = [t.clone() for c in caches if "cross" in c
                    for t in c["cross"]]
        g = graphs.StepGraph(
            lambda tokens: model.decode_step(dp, tokens, caches)[0],
            {"tokens": (B, 1)}, device=cuda,
            state=graphs.cache_tensors(caches))
        tok = torch.zeros(B, 1, dtype=torch.int64, device=cuda)
        for _ in range(4):
            want, _ = model.decode_step(dp, tok, eager)
            got = g(tokens=tok)
            assert torch.equal(got, want)
            for a, b in zip(_tensors(eager), _tensors(caches)):
                assert torch.equal(a, b)
            tok = want[:, -1:].argmax(-1)
    after = [t for c in caches if "cross" in c for t in c["cross"]]
    assert all(torch.equal(a, b) for a, b in zip(memories, after))


@pytest.mark.parametrize("arch,frames", CASES[1:])
def test_prefill_logits_graph_equals_eager(cuda, arch, frames):
    model, dp, _ = _model(arch, cuda)
    toks, fe, _ = _inputs(model, frames, seed=3)
    t = torch.as_tensor(toks, device=cuda)
    f = torch.as_tensor(fe, device=cuda)
    out = {}

    def forward():
        out["lg"] = model.prefill_logits(dp, t, frontend_embeds=f)

    with torch.inference_mode():
        forward()
        want = out.pop("lg")
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            forward()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            forward()
        graph.replay()
        torch.cuda.synchronize()
    assert torch.equal(out["lg"], want)
