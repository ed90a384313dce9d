"""granite-3-2b's and qwen1.5-32b's kernel calls, ``sps_attention``'s
``lens`` and the ``top_k`` sampler's ties on a CUDA card.

Every call of the two archs' serve paths at full width
(``kernel_times.ARCH_CALLS``) against its plain version, one launch each;
``sps_attention`` with per-sequence key lengths (1, L, the query and key
tile edges +-1, 0) at d_h = 64 and 128, causal and not; the ragged
whole-prompt prefill of a 2-layer full-width granite, each row's rings
equal to its own prefill's; the ``top_k`` sampler drawing from
``lax.top_k``'s candidates under ties (the CPU test's twin, the indices
written out).  Kernels and plain versions agree bitwise.

Marked ``gpu``: without a card every test skips (the decision is made in
a fixture, so every worker collects the same tests).  On a card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu_dense.py

This file imports no JAX."""
import test_torch_threads  # noqa: F401  (first: one torch thread)
import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.configs import get_config
from repro_torch.kernels.sps_attn import ops as sps_ops, ref as sps_ref
from repro_torch.launch import kernel_times
from repro_torch.models.lm import build_model
from repro_torch.serve import sampler

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: compares each kernel with its "
                    "plain version on the card")
    return torch.device("cuda")


@pytest.mark.parametrize("kernel", ["rbmm_int", "rbmm_mxu", "pack_threshold",
                                    "sps_attention", "paged_gather_decode"])
def test_arch_calls(cuda, kernel):
    calls = {n: c for n, c in kernel_times.call_operands(
        kernel_times.ARCH_CALLS, 5).items() if c[0] == kernel}
    assert calls
    for name, (_, call, plain, _, _) in calls.items():
        before = kernels.launch_counts()[kernel]
        got = call()
        assert kernels.launch_counts()[kernel] == before + 1, name
        want = plain()
        assert got.dtype == want.dtype and torch.equal(got, want), name


def _words(gen, shape, k, dev):
    w = torch.randint(-2**31, 2**31, shape, generator=gen,
                      dtype=torch.int64).to(torch.int32)
    pad = shape[-1] * 32 - k
    if pad:
        w[..., -1] &= (1 << (32 - pad)) - 1
    return w.to(dev)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("h,hkv,length,dh", [(6, 2, 200, 64),
                                              (4, 4, 130, 128),
                                              (16, 1, 77, 256)])
def test_sps_lens(cuda, h, hkv, length, dh, causal):
    gen = torch.Generator().manual_seed(length)
    lens = [1, length, 63, 64, 65, 127, 129, 0]
    b, dhp = len(lens), (dh + 31) // 32
    q = _words(gen, (b, h, length, dhp), dh, cuda)
    k = _words(gen, (b, hkv, length, dhp), dh, cuda)
    vt = _words(gen, (b, hkv, dh, (length + 31) // 32), length, cuda)
    th = torch.randint(-dh // 6, dh // 6 + 1, (h,), generator=gen,
                       dtype=torch.int32).to(cuda)
    ln = torch.tensor(lens, dtype=torch.int32, device=cuda)
    got = sps_ops.sps_attention_gqa(q, k, vt, th, d_h=dh, causal=causal,
                                    lens=ln)
    assert torch.equal(got, sps_ref.sps_attention_gqa(
        q, k, vt, th, d_h=dh, causal=causal, lens=ln))
    full = torch.full((b,), length, dtype=torch.int32, device=cuda)
    assert torch.equal(
        sps_ops.sps_attention_gqa(q, k, vt, th, d_h=dh, causal=causal,
                                  lens=full),
        sps_ops.sps_attention_gqa(q, k, vt, th, d_h=dh, causal=causal))


def test_ragged_prefill_rows_equal_their_own(cuda):
    """Two full-width granite layers (bf16): 4 rows of 1, 64, 65 and 128
    tokens; each row's rings equal to its own unpadded prefill's."""
    model = build_model(get_config("granite-3-2b").truncated(2))
    lens = np.array([1, 64, 65, 128], np.int32)
    toks = np.random.default_rng(0).integers(0, 49155, (4, 128))
    with torch.inference_mode():
        gen = torch.Generator(device="cuda").manual_seed(0)
        dp = model.convert(model.init(gen))
        _, caches = model.prefill_with_cache(
            dp, torch.as_tensor(toks, device=cuda), max_len=160,
            seq_lens=torch.as_tensor(lens, device=cuda))
        for i, n in enumerate(lens):
            _, own = model.prefill_with_cache(
                dp, torch.as_tensor(toks[i:i + 1, :n], device=cuda),
                max_len=160)
            for c, o in zip(caches, own):
                c, o = c["attn"], o["attn"]
                assert torch.equal(c.k_bits[i], o.k_bits[0]), (i, n)
                assert torch.equal(c.vt_bits[i], o.vt_bits[0]), (i, n)
                assert int(c.length[i]) == n


def test_top_k_ties_draw_lax_top_k_candidates(cuda):
    """A leader and a tie group of six across the third place: k = 3 keeps
    the leader and the two lowest tied indices (``lax.top_k``'s)."""
    v = torch.full((64,), -1.0)
    v[10] = 2.0
    v[[3, 7, 20, 33, 40, 50]] = 1.0
    rows = v.expand(512, 1, 64).contiguous().to(cuda)
    gen = torch.Generator(device="cuda").manual_seed(0)
    got = sampler.top_k(rows, gen, k=3, temp=0.7)
    assert set(got.flatten().tolist()) == {10, 3, 7}
