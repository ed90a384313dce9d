"""Windows, gemma3-27b and the ``row`` granularity on a CUDA card: the card
twins of ``test_torch_windows.py``, ``test_torch_gemma.py`` and
``test_torch_row.py``.

``sps_attention`` with a causal window (a window of one key, the 32-bit
word's and the 128-key tile's edges, gemma's 1,024) at L = 64, 1,100 and
1,536, with ``lens`` beside it, and with an (H, 512) row table at L =
600 (rows past 511 read column 511), against its plain version, one
launch each; with ``window=0`` and an (H,) threshold it is the kernel
without the operands.  ``paged_gather_decode`` with a row table's
thresholds gathered by position on wrapped rings of 1,024.  Every call of
gemma3-27b's serve paths at full width (``kernel_times.GEMMA_CALLS``).
The gemma3 smoke config (float32) and a ``row`` smollm smoke config with
a seeded non-zero lambda table: prefill then greedy decode on the card
equal to the CPU's, logits within ATOL.  Kernels and plain versions agree
bitwise.

Marked ``gpu``: without a card every test skips (the decision is made in
a fixture, so every worker collects the same tests).  On a card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu_windows.py

This file imports no JAX."""
import test_torch_threads  # noqa: F401  (first: one torch thread)
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import kernels, to_device
from repro_torch.configs import get_smoke_config
from repro_torch.kernels.paged_attn import ops as paged_ops
from repro_torch.kernels.paged_attn import ref as paged_ref
from repro_torch.kernels.sps_attn import ops as sps_ops, ref as sps_ref
from repro_torch.launch import kernel_times
from repro_torch.models.lm import build_model

pytestmark = pytest.mark.gpu

# float32 logits; sums differ in order between the devices
ATOL = 2e-3


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


def _operands(gen, b, h, hkv, length, dh, dev):
    dhp = (dh + 31) // 32
    return (_words(gen, (b, h, length, dhp), dh, dev),
            _words(gen, (b, hkv, length, dhp), dh, dev),
            _words(gen, (b, hkv, dh, (length + 31) // 32), length, dev))


def _once(kernel: str, call):
    before = kernels.launch_counts()[kernel]
    out = call()
    assert kernels.launch_counts()[kernel] == before + 1
    return out


@pytest.mark.parametrize("dh", [64, 128])
@pytest.mark.parametrize("length", [64, 1100, 1536])
def test_sps_window(cuda, length, dh):
    gen = torch.Generator().manual_seed(length + dh)
    q, k, vt = _operands(gen, 1, 4, 2, length, dh, cuda)
    th = torch.randint(-dh // 6, dh // 6 + 1, (4,), generator=gen,
                       dtype=torch.int32).to(cuda)
    full = sps_ops.sps_attention_gqa(q, k, vt, th, d_h=dh)
    assert torch.equal(sps_ops.sps_attention_gqa(q, k, vt, th, d_h=dh,
                                                 window=0), full)
    for window in (1, 31, 32, 33, 127, 128, 129, 1024):
        got = _once("sps_attention", lambda: sps_ops.sps_attention_gqa(
            q, k, vt, th, d_h=dh, window=window))
        assert torch.equal(got, sps_ref.sps_attention_gqa(
            q, k, vt, th, d_h=dh, window=window)), window
        if window < length - 1:
            assert not torch.equal(got, full), window


def test_sps_window_with_lens(cuda):
    gen = torch.Generator().manual_seed(3)
    lens = torch.tensor([1100, 1, 1024, 1025, 130, 0], dtype=torch.int32,
                        device=cuda)
    q, k, vt = _operands(gen, len(lens), 8, 2, 1100, 128, cuda)
    th = torch.randint(-20, 21, (8,), generator=gen,
                       dtype=torch.int32).to(cuda)
    for window in (33, 1024):
        got = _once("sps_attention", lambda: sps_ops.sps_attention_gqa(
            q, k, vt, th, d_h=128, window=window, lens=lens))
        assert torch.equal(got, sps_ref.sps_attention_gqa(
            q, k, vt, th, d_h=128, window=window, lens=lens))


@pytest.mark.parametrize("dh", [64, 128])
def test_sps_row_table(cuda, dh):
    """An (H, 512) table at L = 600; the same table's column 0 as an (H,)
    threshold gives other outputs."""
    gen = torch.Generator().manual_seed(dh)
    q, k, vt = _operands(gen, 2, 4, 2, 600, dh, cuda)
    table = torch.randint(-20, 21, (4, 512), generator=gen,
                          dtype=torch.int32).to(cuda)
    got = _once("sps_attention", lambda: sps_ops.sps_attention_gqa(
        q, k, vt, table, d_h=dh))
    assert torch.equal(got, sps_ref.sps_attention_gqa(q, k, vt, table,
                                                      d_h=dh))
    assert not torch.equal(got, sps_ops.sps_attention_gqa(
        q, k, vt, table[:, 0].contiguous(), d_h=dh))
    lens = torch.tensor([600, 333], dtype=torch.int32, device=cuda)
    assert torch.equal(
        sps_ops.sps_attention_gqa(q, k, vt, table, d_h=dh, window=64,
                                  lens=lens),
        sps_ref.sps_attention_gqa(q, k, vt, table, d_h=dh, window=64,
                                  lens=lens))


def test_paged_row_thresholds_on_wrapped_rings(cuda):
    gen = torch.Generator().manual_seed(5)
    b, h, hkv, dh, page, nblk, pages, ring = 8, 32, 16, 128, 32, 32, 256, \
        1024
    q = _words(gen, (b, h, 4), dh, cuda)
    kp = _words(gen, (pages + 1, hkv, page, 4), dh, cuda)
    vtp = _words(gen, (pages + 1, hkv, dh, 1), page, cuda)
    bt = torch.randint(0, pages + 1, (b, nblk), generator=gen,
                       dtype=torch.int32).to(cuda)
    lens = torch.randint(ring + 1, 2176, (b,), generator=gen,
                         dtype=torch.int32).to(cuda)
    table = torch.randint(-20, 21, (h, 512), generator=gen,
                          dtype=torch.int32).to(cuda)
    th = table[:, lens.long().clamp(max=511)].T.contiguous()
    got = _once("paged_gather_decode", lambda: paged_ops.paged_gather_decode(
        q, kp, vtp, bt, lens, ring, th, d_h=dh))
    assert torch.equal(got, paged_ref.paged_gather_decode_popcount(
        q, kp, vtp, bt, lens, ring, th, d_h=dh))


@pytest.mark.parametrize("kernel", ["rbmm_int", "rbmm_mxu", "pack_threshold",
                                    "sps_attention", "paged_gather_decode"])
def test_gemma_calls(cuda, kernel):
    calls = {n: c for n, c in kernel_times.call_operands(
        kernel_times.GEMMA_CALLS, 6).items() if c[0] == kernel}
    assert calls
    for name, (_, call, plain, _, _) in calls.items():
        got = _once(kernel, call)
        want = plain()
        assert got.dtype == want.dtype and torch.equal(got, want), name


def _greedy(model, dparams, toks, max_len, dev, steps=4):
    logits, caches = model.prefill_with_cache(
        dparams, torch.as_tensor(toks, device=dev), max_len=max_len)
    out, lgs = [], [logits.float().cpu()]
    for _ in range(steps):
        tok = logits[:, -1:].argmax(-1)
        out.append(tok.cpu())
        logits, caches = model.decode_step(dparams, tok, caches)
        lgs.append(logits.float().cpu())
    return torch.cat(out, 1), lgs


@pytest.mark.parametrize("arch,row", [("gemma3-27b", False),
                                      ("smollm-135m", True)])
def test_smoke_card_equals_cpu(cuda, arch, row):
    """gemma3's smoke config (windows of 8, 40-token prompts: the local
    rings wrap) or smollm's with ``row`` and a seeded lambda table
    (520-token prompts cross position 511): greedy tokens equal, logits
    within ATOL."""
    cfg = get_smoke_config(arch)
    if row:
        cfg = cfg.with_(num_layers=2, binary=dataclasses.replace(
            cfg.binary, sps_granularity="row"))
    model = build_model(cfg)
    s = 520 if row else 40
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, s))
    with torch.inference_mode():
        gen = torch.Generator(device="cuda").manual_seed(0)
        qat = model.init(gen)
        if row:
            for bp in qat["blocks"]:
                lam = bp["attn"]["sps_lambda"]
                lam.copy_(0.4 * torch.randn(lam.shape, generator=gen,
                                            device="cuda"))
        dp = model.convert(qat)
        got, lg_card = _greedy(model, dp, toks, s + 8, cuda)
        want, lg_cpu = _greedy(model, to_device(dp, "cpu"), toks, s + 8,
                               "cpu")
    assert torch.equal(got, want)
    assert max((a - b).abs().max().item()
               for a, b in zip(lg_card, lg_cpu)) <= ATOL
