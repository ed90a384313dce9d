"""``BinaryMoE`` and the MoE archs on a CUDA card: the card twins of
``test_torch_moe.py``, ``test_torch_moe_lm.py`` and
``test_torch_moe_serve.py``.

Every expert-batched call of mixtral-8x22b's and arctic-480b's serve paths
at full width (``kernel_times.MOE_CALLS``: ``rbmm_int``'s decode route over
8 and 128 experts, ``rbmm_mxu`` batched over experts, ``pack_threshold`` on
(E, C, d) buffers) against its plain version, bitwise, one launch each,
one call's operands at a time.  ``BinaryMoE.apply_deploy`` (fp rows and
packed bits dispatched, dropless and dropping, the dense residual) on the
card against the CPU, and captured as a CUDA graph: routing, dispatch and
combine read nothing on the host, so the replay equals the eager call
bitwise.  The mixtral and arctic smoke configs (float32): prefill then
greedy decode on the card equal to the CPU's, logits within ATOL.

Marked ``gpu``: without a card every test skips (the decision is made in
a fixture, so every worker collects the same tests).  On a card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu_moe.py

This file imports no JAX."""
import test_torch_threads  # noqa: F401  (first: one torch thread)
import numpy as np
import pytest
import torch

from repro_torch import kernels, to_device
from repro_torch.configs import get_smoke_config
from repro_torch.launch import kernel_times
from repro_torch.models.ffn import BinaryMoE
from repro_torch.models.lm import build_model

pytestmark = pytest.mark.gpu

# float32 outputs; the router's and the head's sums differ in order
# between the devices
ATOL = 2e-3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: compares each kernel with its "
                    "plain version on the card")
    return torch.device("cuda")


@pytest.mark.parametrize("kernel", ["rbmm_int", "rbmm_mxu",
                                    "pack_threshold"])
def test_moe_calls(cuda, kernel):
    names = [n for n, c in kernel_times.MOE_CALLS.items() if c[0] == kernel]
    assert names
    for name in names:
        (_, call, plain, _, _), = kernel_times.call_operands(
            {name: kernel_times.MOE_CALLS[name]}, 7).values()
        before = kernels.launch_counts()[kernel]
        got = call()
        assert kernels.launch_counts()[kernel] == before + 1, name
        want = plain()
        assert got.dtype == want.dtype and torch.equal(got, want), name
        del call, plain, got, want
        torch.cuda.empty_cache()


def _moe(cf, bits, dr, dev):
    moe = BinaryMoE(128, 256, 8, top_k=2, capacity_factor=cf,
                    dense_residual=dr, dispatch_bits=bits)
    gen = torch.Generator(device=dev).manual_seed(3)
    params = moe.convert(moe.init(gen, dev))
    for sub in ("experts", "residual"):
        if sub in params:
            params[sub]["act_beta"] = torch.full((), 0.05, device=dev)
            params[sub]["h_alpha"] = torch.full((), 0.7, device=dev)
    return moe, params


@pytest.mark.parametrize("dr", [False, True], ids=["moe", "residual"])
@pytest.mark.parametrize("bits", [False, True], ids=["fp", "bits"])
@pytest.mark.parametrize("cf", [4.0, 0.5], ids=["dropless", "dropping"])
def test_apply_deploy_card_equals_cpu(cuda, cf, bits, dr):
    """(4, 20, 128) rows (rows 40.. repeat rows 0..: equal rows claim equal
    experts): the same routing on both devices, outputs within ATOL."""
    moe, params = _moe(cf, bits, dr, cuda)
    x = torch.randn(80, 128, generator=torch.Generator().manual_seed(4))
    x[40:] = x[:40]
    x = x.reshape(4, 20, 128)
    on_cpu = to_device(params, "cpu")
    route_card = moe._route(params, x.reshape(-1, 128).to(cuda))
    route_cpu = moe._route(on_cpu, x.reshape(-1, 128))
    for a, b in zip(route_card[1:4], route_cpu[1:4]):
        assert torch.equal(a.cpu(), b)
    assert bool(route_cpu[3].all()) == (cf == 4.0)
    got = moe.apply_deploy(params, x.to(cuda)).cpu()
    want = moe.apply_deploy(on_cpu, x)
    assert (got - want).abs().max().item() <= ATOL


@pytest.mark.parametrize("bits", [False, True], ids=["fp", "bits"])
def test_apply_deploy_captures(cuda, bits):
    """The MoE forward captured as a CUDA graph (dropping): no host read,
    and each replay on new rows equals the eager call bitwise."""
    moe, params = _moe(0.5, bits, True, cuda)
    gen = torch.Generator(device=cuda).manual_seed(5)
    x = torch.randn(64, 128, generator=gen, device=cuda)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        moe.apply_deploy(params, x)         # warm-up off the capture
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        y = moe.apply_deploy(params, x)
    for _ in range(3):
        x.copy_(torch.randn(64, 128, generator=gen, device=cuda))
        g.replay()
        assert torch.equal(y, moe.apply_deploy(params, x))


@pytest.mark.parametrize("arch", ["mixtral-8x22b", "arctic-480b"])
def test_smoke_card_equals_cpu(cuda, arch):
    """The smoke config (mixtral: windows of 16, 40-token prompts wrap the
    rings): greedy tokens equal, logits within ATOL."""
    cfg = get_smoke_config(arch)
    model = build_model(cfg)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 40))
    out = {}
    with torch.inference_mode():
        dp = model.convert(model.init(
            torch.Generator(device="cuda").manual_seed(0)))
        for dev, params in ((cuda, dp), ("cpu", to_device(dp, "cpu"))):
            logits, caches = model.prefill_with_cache(
                params, torch.as_tensor(toks, device=dev), max_len=48)
            tokens, lgs = [], [logits.float().cpu()]
            for _ in range(4):
                tok = logits[:, -1:].argmax(-1)
                tokens.append(tok.cpu())
                logits, caches = model.decode_step(params, tok, caches)
                lgs.append(logits.float().cpu())
            out[str(dev)] = (torch.cat(tokens, 1), lgs)
    (t_card, l_card), (t_cpu, l_cpu) = out["cuda"], out["cpu"]
    assert torch.equal(t_card, t_cpu)
    assert max((a - b).abs().max().item()
               for a, b in zip(l_card, l_cpu)) <= ATOL


def test_dropping_paged_serve_is_deterministic(cuda):
    """The CPU test's dropping, prefix-shared serve on the card (its steps
    captured graphs): a second serve on the engine and a serve on a fresh
    engine give the first serve's tokens by rid."""
    from repro_torch.configs import base
    from repro_torch.serve import engine as eng_lib
    from repro_torch.serve import trace
    cfg = get_smoke_config("mixtral-8x22b")
    model = build_model(cfg.with_(window_size=4096, moe=base.MoEConfig(
        num_experts=8, top_k=2, capacity_factor=2.0)))
    with torch.inference_mode():
        params = model.convert(model.init(
            torch.Generator(device="cuda").manual_seed(0)))
    scfg = eng_lib.ServeConfig(num_slots=8, cache=eng_lib.CacheConfig(
        paged=True, page_size=32, max_blocks=8, num_pages=24,
        prefix_share=True), policy=eng_lib.PolicyConfig(prefill_chunk=64))
    first = eng_lib.ServeEngine(model, params, scfg)
    runs = []
    for e in (first, eng_lib.ServeEngine(model, params, scfg), first):
        reqs = trace.as_requests(trace.generate_trace(trace.TraceConfig(
            n_requests=16, mean_prompt=96, max_prompt=200, mean_new=12,
            max_new=24, vocab=256, seed=0, tenants=(
                trace.TenantSpec("default", system_prompt_len=64),))))
        for r in reqs:
            r.arrival_s = 0.0
        runs.append(e.serve(reqs)[0])
    for other in runs[1:]:
        assert all(np.array_equal(other[rid], runs[0][rid])
                   for rid in runs[0])
