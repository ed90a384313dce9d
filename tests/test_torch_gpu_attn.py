"""The attention kernels against their plain versions on a CUDA card, at
the edges of their designs: ``sps_attention`` on the int8 tensor cores
(64-row query tiles, 128-key tiles, up to three query heads a block,
64 context columns a pass) and ``paged_gather_decode`` with a sequence's
pages split over 16 warps.

Marked ``gpu``: without a card every test skips (the decision is made in
a fixture, so every worker collects the same tests).  On a card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu_attn.py

This file imports no JAX.  Outputs are int32 and must be bitwise equal;
every call must be exactly one launch of its kernel."""
import test_torch_threads  # noqa: F401  (first: one torch thread)
import pytest
import torch

from repro_torch import kernels
from repro_torch.kernels.paged_attn import ops as paged_ops
from repro_torch.kernels.paged_attn import ref as paged_ref
from repro_torch.kernels.sps_attn import ops as sps_ops, ref as sps_ref

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: compares each kernel with its "
                    "plain version on the card")
    return torch.device("cuda")


def _words(gen, shape, k, dev):
    """Random words with k true bits per row (zero pad bits)."""
    w = torch.randint(-2**31, 2**31, shape, generator=gen,
                      dtype=torch.int64).to(torch.int32)
    pad = shape[-1] * 32 - k
    if pad:
        w[..., -1] &= (1 << (32 - pad)) - 1
    return w.to(dev)


def _one_launch(fn, name):
    before = kernels.launch_counts()[name]
    out = fn()
    assert kernels.launch_counts()[name] == before + 1
    return out


def _sps(dev, seed, b, h, hkv, length, dh, causal):
    gen = torch.Generator().manual_seed(seed)
    dhp, lw = (dh + 31) // 32, (length + 31) // 32
    q = _words(gen, (b, h, length, dhp), dh, dev)
    k = _words(gen, (b, hkv, length, dhp), dh, dev)
    vt = _words(gen, (b, hkv, dh, lw), length, dev)
    # thresholds around the score's spread, so both bits are common
    th = torch.randint(-dh // 6, dh // 6 + 1, (h,), generator=gen,
                       dtype=torch.int32).to(dev)
    got = _one_launch(lambda: sps_ops.sps_attention_gqa(
        q, k, vt, th, d_h=dh, causal=causal), "sps_attention")
    want = sps_ref.sps_attention_gqa(q, k, vt, th, d_h=dh, causal=causal)
    assert torch.equal(got, want), (b, h, hkv, length, dh, causal)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("length", [63, 64, 65, 129])
def test_sps_attention_tile_edges(cuda, length, causal):
    """Query tiles of 64 rows and key tiles of 128 keys, ragged at both;
    GQA 3:1 (one block serves the three heads of a KV group)."""
    _sps(cuda, length, 2, 6, 2, length, 64, causal)


@pytest.mark.parametrize("case", [
    # (batch, H, Hkv, L, d_h, causal)
    (2, 3, 1, 77, 48, True),      # pad bits: d_h = 48
    (1, 16, 1, 130, 256, False),  # G = 16 (6 blocks a group), d_h = 256
    (2, 8, 2, 200, 95, True),     # G = 4 (2 blocks of 2), odd d_h
    (8, 12, 12, 512, 64, False),  # the encoder's shape
    (8, 9, 3, 128, 64, True),     # smollm prefill
    (1, 6, 2, 700, 96, True),     # six key tiles, two context passes
], ids=["dh48-L77", "G16-dh256", "G4-dh95", "encoder", "prefill",
        "L700-dh96"])
def test_sps_attention_shapes(cuda, case):
    _sps(cuda, sum(case), *case)


def _paged(dev, seed, b, h, hkv, dh, page, nblk, pages, ring, lens):
    gen = torch.Generator().manual_seed(seed)
    dhp = (dh + 31) // 32
    q = _words(gen, (b, h, dhp), dh, dev)
    kp = _words(gen, (pages + 1, hkv, page, dhp), dh, dev)
    vt = _words(gen, (pages + 1, hkv, dh, page // 32), page, dev)
    bt = torch.randint(0, pages + 1, (b, nblk), generator=gen,
                       dtype=torch.int32)
    bt[-1, -1] = 0                      # a trash entry
    th = torch.randint(-dh // 6, dh // 6 + 1, (b, h), generator=gen,
                       dtype=torch.int32).to(dev)
    args = (q, kp, vt, bt.to(dev), torch.tensor(lens, dtype=torch.int32,
                                                device=dev), ring, th)
    got = _one_launch(lambda: paged_ops.paged_gather_decode(*args, d_h=dh),
                      "paged_gather_decode")
    want = paged_ref.paged_gather_decode_popcount(*args, d_h=dh)
    assert torch.equal(got, want), (b, h, hkv, dh, page, nblk, ring)


@pytest.mark.parametrize("case", [
    # (batch, H, Hkv, d_h, page, nblk, pages, ring, lengths)
    (16, 9, 3, 64, 32, 12, 96, 384,
     [0, 5, 31, 32, 63, 100, 150, 200, 250, 300, 340, 383, 384, 400, 17,
      222]),                                   # the main path's shape
    (3, 4, 2, 48, 96, 40, 60, 3800,
     [0, 3839, 2000]),                         # 40 pages over 16 warps
    (2, 32, 2, 256, 256, 3, 4, 700, [699, 260]),   # G = 16, d_h = 256
    (2, 2, 1, 32, 32, 530, 540, 16950,
     [16960, 9000]),       # 530 pages: a warp past 32 table entries
], ids=["main", "nblk40-page96", "G16-dh256-page256", "nblk530"])
def test_paged_gather_decode_edges(cuda, case):
    _paged(cuda, len(case[-1]), *case)
