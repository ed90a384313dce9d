"""The port's kernels against their plain versions on a CUDA card.

Marked ``gpu``: without a card every test skips (the decision is made in
a fixture, so every worker collects the same tests).  On a card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

This file imports no JAX, so it also runs where only PyTorch is
installed.  Integer and float32 outputs must be bitwise equal."""
import test_torch_threads  # noqa: F401  (first: one torch thread)
import numpy as np
import pytest
import torch

from repro_torch import kernels, to_device
from repro_torch.configs import base
from repro_torch.core import packing
from repro_torch.kernels.pack import ops as pack_ops, ref as pack_ref
from repro_torch.kernels.paged_attn import ops as paged_ops
from repro_torch.kernels.paged_attn import ref as paged_ref
from repro_torch.kernels.rbmm import ops as rbmm_ops, ref as rbmm_ref
from repro_torch.kernels.rbmm_mxu import ops as mxu_ops, ref as mxu_ref
from repro_torch.kernels.sps_attn import ops as sps_ops, ref as sps_ref
from repro_torch.models.lm import build_model
from repro_torch.serve import engine, trace

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: compares each kernel with its "
                    "plain version on the card")
    return torch.device("cuda")


def _words(gen, shape, k, dev):
    w = torch.randint(-2**31, 2**31, shape, generator=gen,
                      dtype=torch.int64).to(torch.int32)
    pad = shape[-1] * 32 - k
    if pad:
        w[..., -1] &= (1 << (32 - pad)) - 1
    return w.to(dev)


def _launched(fn, name):
    before = kernels.launch_counts()[name]
    out = fn()
    assert kernels.launch_counts()[name] == before + 1
    return out


def test_pack_threshold_kernel(cuda):
    gen = torch.Generator().manual_seed(0)
    for x, th in (
            (torch.randn(37, 100, generator=gen), torch.randn(100) * 0.3),
            (torch.randint(-9, 9, (5, 70), generator=gen, dtype=torch.int32),
             torch.tensor(1, dtype=torch.int32)),
            (torch.randn(4, 6, 3, 48, generator=gen).to(torch.bfloat16),
             torch.randn(3, 1) * 0.2)):
        x, th = x.to(cuda), th.to(cuda)
        got = _launched(lambda: pack_ops.pack_threshold(x, th),
                        "pack_threshold")
        assert torch.equal(got, pack_ref.pack_threshold(x, th))


@pytest.mark.parametrize("scheme", ["xnor", "and_dc"])
def test_rbmm_int_kernel(cuda, scheme):
    gen = torch.Generator().manual_seed(1)
    a, b = _words(gen, (3, 13, 4), 100, cuda), _words(gen, (3, 70, 4), 100,
                                                      cuda)
    got = _launched(lambda: rbmm_ops.rbmm_int(a, b, 100, scheme=scheme),
                    "rbmm_int")
    assert torch.equal(got, rbmm_ref.rbmm_int(a, b, 100, scheme=scheme))


@pytest.mark.parametrize("scheme", ["xnor", "and_dc"])
def test_rbmm_binary_kernel(cuda, scheme):
    """Both stores; ragged M, P and K, K past one staged chunk, causal with
    M > P, a given dc, batched operands and an (M, P) theta."""
    gen = torch.Generator().manual_seed(5)
    th = lambda *s: torch.randint(-30, 30, s, generator=gen,
                                  dtype=torch.int32).to(cuda)
    a, b = _words(gen, (70, 4), 100, cuda), _words(gen, (45, 4), 100, cuda)
    al, bl = _words(gen, (40, 35), 1100, cuda), _words(gen, (150, 35), 1100,
                                                        cuda)
    ab, bb = _words(gen, (3, 33, 2), 48, cuda), _words(gen, (3, 65, 2), 48,
                                                       cuda)
    dc = torch.randint(0, 100, (70,), generator=gen,
                       dtype=torch.int32).to(cuda)
    for x, y, k, theta, kw in (
            (a, b, 100, th(45), dict(causal=True)),
            (a, b, 100, th(45), dict(dc=dc if scheme == "and_dc" else None)),
            (al, bl, 1100, th(40, 150), {}),
            (ab, bb, 48, th(65), dict(causal=True))):
        want, want_dc = rbmm_ref.rbmm_binary(x, y, k, theta, scheme=scheme,
                                             **kw)
        for pack in (False, True):
            got, got_dc = _launched(lambda: rbmm_ops.rbmm_binary(
                x, y, k, theta, scheme=scheme, pack_output=pack, **kw),
                "rbmm_binary")
            assert torch.equal(got, packing.pack_bits(want) if pack
                               else want)
            assert torch.equal(got_dc, want_dc)


def test_rbmm_mxu_kernel(cuda):
    gen = torch.Generator().manual_seed(2)
    a = (2 * torch.randint(0, 2, (70, 100), generator=gen) - 1).to(
        cuda, torch.bfloat16)
    w = _words(gen, (45, 4), 100, cuda)
    got = _launched(lambda: mxu_ops.rbmm_mxu(a, w), "rbmm_mxu")
    assert torch.equal(got, mxu_ref.rbmm_mxu(a, w))


@pytest.mark.parametrize("bt,m,k,p,unsigned", [
    (1, 63, 48, 129, False), (3, 128, 100, 65, True),
    (1, 129, 2048, 127, False), (1, 1100, 576, 1100, True)])
def test_rbmm_mxu_kernel_tile_edges(cuda, bt, m, k, p, unsigned):
    """M and P at and past the 64 and 128 tile edges, K of 1 to 32 steps of
    64 (more than the ring's 4 stages), K % 8 != 0, a batch, {0,1} values;
    the last case takes the 128 x 64 tile."""
    gen = torch.Generator().manual_seed(m + k)
    lead = (bt,) if bt > 1 else ()
    bits = torch.randint(0, 2, lead + (m, k), generator=gen)
    a = (bits if unsigned else 2 * bits - 1).to(cuda, torch.bfloat16)
    w = _words(gen, lead + (p, (k + 31) // 32), k, cuda)
    got = _launched(lambda: mxu_ops.rbmm_mxu(a, w), "rbmm_mxu")
    assert torch.equal(got, mxu_ref.rbmm_mxu(a, w))


@pytest.mark.parametrize("scheme", ["xnor", "and_dc"])
def test_rbmm_binary_kernel_tile_edges(cuda, scheme):
    """Both stores at M and P around the 128 x 192 tile, K of 1 to 16
    steps of 128 values, dc derived and given, causal with M > P, every
    theta form."""
    gen = torch.Generator().manual_seed(6)
    th = lambda *s: torch.randint(-12, 12, s, generator=gen,
                                  dtype=torch.int32).to(cuda)
    for lead, m, p, k, theta, kw in (
            ((), 63, 193, 48, th(193), {}),
            ((), 129, 127, 2048, th(129, 127), dict(causal=True)),
            ((2,), 128, 65, 576, th(), {}),
            ((), 127, 128, 100, th(128), dict(dc=torch.randint(
                0, 100, (127,), generator=gen, dtype=torch.int32).to(cuda)))):
        a = _words(gen, lead + (m, (k + 31) // 32), k, cuda)
        b = _words(gen, lead + (p, (k + 31) // 32), k, cuda)
        if scheme == "xnor":
            kw.pop("dc", None)
        want, want_dc = rbmm_ref.rbmm_binary(a, b, k, theta, scheme=scheme,
                                             **kw)
        for pack in (False, True):
            got, got_dc = _launched(lambda: rbmm_ops.rbmm_binary(
                a, b, k, theta, scheme=scheme, pack_output=pack, **kw),
                "rbmm_binary")
            assert torch.equal(got, packing.pack_bits(want) if pack
                               else want)
            assert torch.equal(got_dc, want_dc)


def test_sps_attention_kernel(cuda):
    gen = torch.Generator().manual_seed(3)
    q = _words(gen, (2, 3, 77, 2), 48, cuda)
    k = _words(gen, (2, 1, 77, 2), 48, cuda)
    vt = _words(gen, (2, 1, 48, 3), 77, cuda)
    th = torch.randint(-6, 7, (3,), generator=gen,
                       dtype=torch.int32).to(cuda)
    got = _launched(lambda: sps_ops.sps_attention_gqa(q, k, vt, th, d_h=48),
                    "sps_attention")
    assert torch.equal(got, sps_ref.sps_attention_gqa(q, k, vt, th, d_h=48))


def test_smoke_model_on_card_equals_cpu(cuda):
    model = build_model(base.get_smoke_config("smollm-135m"))
    dp = model.convert(model.init(torch.Generator().manual_seed(0)))
    prompts = np.random.default_rng(0).integers(0, 256, (4, 20))
    cfg = engine.ServeConfig(cache=engine.CacheConfig(max_len=32))
    on_cpu, _ = engine.ServeEngine(model, dp, cfg, device="cpu").generate(
        prompts, max_new_tokens=4)
    kernels.reset_launch_counts()
    on_card, _ = engine.ServeEngine(model, to_device(dp, cuda), cfg,
                                    device=cuda).generate(prompts,
                                                          max_new_tokens=4)
    static_path = ("pack_threshold", "rbmm_int", "rbmm_mxu",
                   "sps_attention")   # paged_gather_decode serves paging
    counts = kernels.launch_counts()
    assert all(counts[name] > 0 for name in static_path), counts
    np.testing.assert_array_equal(on_card, on_cpu)


def test_smoke_encoder_on_card_equals_cpu(cuda):
    """bert-base-cobra's smoke config (float32): prefill_logits on the card
    against the plain versions on the CPU, through every kernel of the
    encoder path; float sums differ in order, hence the tolerance."""
    model = build_model(base.get_smoke_config("bert-base-cobra"))
    dp = model.convert(model.init(torch.Generator().manual_seed(0)))
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, 256,
                                                              (2, 48)))
    on_cpu = model.prefill_logits(dp, toks, device="cpu")
    kernels.reset_launch_counts()
    on_card = model.prefill_logits(to_device(dp, cuda), toks.to(cuda)).cpu()
    counts = kernels.launch_counts()
    assert counts["rbmm_binary"] == counts["rbmm_int"] == 8, counts
    assert all(counts[name] > 0 for name in (
        "pack_threshold", "rbmm_mxu", "sps_attention")), counts
    assert torch.equal(on_card.argmax(-1), on_cpu.argmax(-1))
    assert (on_card - on_cpu).abs().max().item() <= 1e-3


def test_paged_gather_decode_kernel(cuda):
    """d_h = 48, G = 3, a ring shorter than the table, trash entries, a
    length 0 and a length past the ring."""
    gen = torch.Generator().manual_seed(4)
    b, h, hkv, dh, page, nblk, pages, ring = 3, 9, 3, 48, 32, 3, 6, 80
    q = _words(gen, (b, h, 2), dh, cuda)
    kp = _words(gen, (pages + 1, hkv, page, 2), dh, cuda)
    vt = _words(gen, (pages + 1, hkv, dh, 1), page, cuda)
    bt = torch.tensor([[1, 2, 0], [3, 4, 5], [6, 0, 0]],
                      dtype=torch.int32, device=cuda)
    lens = torch.tensor([0, ring + 5, 40], dtype=torch.int32, device=cuda)
    th = torch.randint(-12, 12, (b, h), generator=gen,
                       dtype=torch.int32).to(cuda)
    args = (q, kp, vt, bt, lens, ring, th)
    got = _launched(lambda: paged_ops.paged_gather_decode(*args, d_h=dh),
                    "paged_gather_decode")
    assert torch.equal(got, paged_ref.paged_gather_decode_popcount(
        *args, d_h=dh))


def test_smoke_continuous_serve_on_card_equals_cpu(cuda):
    """Paged pool with prefix sharing, chunks of 32 and an arena small
    enough to preempt: equal tokens by rid and equal counters."""
    model = build_model(base.get_smoke_config("smollm-135m"))
    dp = model.convert(model.init(torch.Generator().manual_seed(0)))
    tcfg = trace.TraceConfig(n_requests=8, mean_prompt=24, max_prompt=60,
                             mean_new=6, max_new=10, vocab=256, seed=0,
                             tenants=(trace.TenantSpec(
                                 "default", system_prompt_len=32),))
    cfg = engine.ServeConfig(num_slots=4, cache=engine.CacheConfig(
        max_len=128, paged=True, page_size=32, max_blocks=3, num_pages=5),
        policy=engine.PolicyConfig(prefill_chunk=32))
    runs = []
    for dev, params in (("cpu", dp), (cuda, to_device(dp, cuda))):
        reqs = trace.as_requests(trace.generate_trace(tcfg))
        for r in reqs:
            r.arrival_s = 0.0
        kernels.reset_launch_counts()
        runs.append(engine.ServeEngine(model, params, cfg,
                                       device=dev).serve(reqs))
    assert kernels.launch_counts()["paged_gather_decode"] > 0
    (cpu_res, cpu_rep), (card_res, card_rep) = runs
    assert sorted(card_res) == sorted(cpu_res)
    for rid in cpu_res:
        np.testing.assert_array_equal(card_res[rid], cpu_res[rid])
    for key in ("preemptions", "prefix_hits", "cow_copies", "iterations",
                "pages_freed_retire", "peak_page_utilization"):
        assert card_rep[key] == cpu_rep[key], key
