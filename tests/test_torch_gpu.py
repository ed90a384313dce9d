"""The port's kernels against their plain versions on a CUDA card.

Marked ``gpu``: without a card every test skips (the decision is made in
a fixture, so every worker collects the same tests).  On a card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

This file imports no JAX, so it also runs where only PyTorch is
installed.  Integer and float32 outputs must be bitwise equal."""
import numpy as np
import pytest
import torch

from repro_torch import kernels, to_device
from repro_torch.configs import base
from repro_torch.kernels.pack import ops as pack_ops, ref as pack_ref
from repro_torch.kernels.rbmm import ops as rbmm_ops, ref as rbmm_ref
from repro_torch.kernels.rbmm_mxu import ops as mxu_ops, ref as mxu_ref
from repro_torch.kernels.sps_attn import ops as sps_ops, ref as sps_ref
from repro_torch.models.lm import build_model
from repro_torch.serve import engine

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


def test_rbmm_mxu_kernel(cuda):
    gen = torch.Generator().manual_seed(2)
    a = (2 * torch.randint(0, 2, (70, 100), generator=gen) - 1).to(
        cuda, torch.bfloat16)
    w = _words(gen, (45, 4), 100, cuda)
    got = _launched(lambda: mxu_ops.rbmm_mxu(a, w), "rbmm_mxu")
    assert torch.equal(got, mxu_ref.rbmm_mxu(a, w))


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
    assert all(n > 0 for n in kernels.launch_counts().values())
    np.testing.assert_array_equal(on_card, on_cpu)
