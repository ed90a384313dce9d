"""Both routes of ``rbmm_int`` (the decode kernel, and the int8
tensor-core kernel) and ``pack_threshold``'s three layouts against their
plain versions on a CUDA card.

Marked ``gpu``: without a card every test skips (the decision is made in
a fixture, so every worker collects the same tests).  On a card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu_tc_pack.py

This file imports no JAX.  Outputs are int32 words and must be bitwise
equal."""
import test_torch_threads  # noqa: F401  (first: one torch thread)
import pytest
import torch

from repro_torch import kernels
from repro_torch.kernels.pack import ops as pack_ops, ref as pack_ref
from repro_torch.kernels.rbmm import ops as rbmm_ops, ref as rbmm_ref

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: compares each kernel with its "
                    "plain version on the card")
    return torch.device("cuda")


def _words(gen, shape, dev):
    """Random words with every bit random, pad bits included."""
    return torch.randint(-2**31, 2**31, shape, generator=gen,
                         dtype=torch.int64).to(torch.int32).to(dev)


def _both_routes(a, b, k, scheme, dc=None):
    want = rbmm_ref.rbmm_int(a, b, k, scheme=scheme, dc=dc)
    for which in rbmm_ops.ROUTES:
        before = kernels.launch_counts()["rbmm_int"]
        got = rbmm_ops.launch_int(which, a, b, k, scheme=scheme, dc=dc)
        assert kernels.launch_counts()["rbmm_int"] == before + 1
        assert torch.equal(got, want), (which, tuple(a.shape),
                                        tuple(b.shape), k, scheme)
    return want


@pytest.mark.parametrize("shape", ["f2", "chunk"])
def test_rbmm_int_routes_at_main_path_shapes(cuda, shape):
    """The encoder's F2 (and_dc, dc given) and chunked prefill's prefix
    score, context (dc derived) and intra-chunk score; the public wrapper
    equals both routes."""
    gen = torch.Generator().manual_seed(11)
    if shape == "f2":
        cases = [((4096, 24), (768, 24), 768, "and_dc", torch.randint(
            0, 768, (4096,), generator=gen, dtype=torch.int32).to(cuda))]
    else:
        lead = (16, 3)
        cases = [(lead + (384, 2), lead + (384, 2), 64, "xnor", None),
                 (lead + (384, 12), lead + (64, 12), 384, "and_dc", None),
                 (lead + (384, 2), lead + (128, 2), 64, "xnor", None)]
    for sa, sb, k, scheme, dc in cases:
        a, b = _words(gen, sa, cuda), _words(gen, sb, cuda)
        want = _both_routes(a, b, k, scheme, dc)
        assert torch.equal(rbmm_ops.rbmm_int(a, b, k, scheme=scheme, dc=dc),
                           want)


@pytest.mark.parametrize("scheme,with_dc", [("xnor", False),
                                            ("and_dc", True),
                                            ("and_dc", False)])
def test_rbmm_int_routes_tile_edges(cuda, scheme, with_dc):
    """M and P around the 128-row tile and the 64/128/192-column tiles,
    Kp of 1 to 5, 24 and 25 words with pad bits set (K % 32 != 0), and a
    batch."""
    gen = torch.Generator().manual_seed(12)
    for lead, m, p, k in (((), 17, 65, 20), ((), 127, 193, 33),
                          ((), 129, 64, 70), ((2,), 65, 127, 100),
                          ((), 300, 129, 130), ((), 1, 1, 1),
                          ((3,), 200, 384, 768), ((), 129, 257, 790)):
        kp = (k + 31) // 32
        a = _words(gen, lead + (m, kp), cuda)
        b = _words(gen, lead + (p, kp), cuda)
        dc = (torch.randint(0, k + 1, lead + (m,), generator=gen,
                            dtype=torch.int32).to(cuda) if with_dc else None)
        _both_routes(a, b, k, scheme, dc)


def _pack_cases(dev):
    g = torch.Generator().manual_seed(13)

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=g).to(dtype).to(dev)

    def ints(*shape, lo=-40, hi=40):
        return torch.randint(lo, hi, shape, generator=g,
                             dtype=torch.int32).to(dev)

    zero = torch.zeros((), device=dev)
    return {
        "decode x (8,1,576) bf16": lambda: (randn(8, 1, 576), zero),
        "decode q (16,1,9,64) bf16 per-head": lambda: (
            randn(16, 1, 9, 64), randn(9, 1, dtype=torch.float32)),
        "prefill x (1024,576) bf16": lambda: (randn(1024, 576), zero),
        "encoder x (8,512,768) bf16": lambda: (randn(8, 512, 768), zero),
        "encoder q (8,512,12,64) bf16 per-head": lambda: (
            randn(8, 512, 12, 64), randn(12, 1, dtype=torch.float32)),
        "encoder V^T (8,12,64,512) bf16 strided": lambda: (
            randn(8, 512, 12, 64).permute(0, 2, 3, 1),
            randn(12, 1, 1, dtype=torch.float32)),
        "ragged K=100 f32 per-column": lambda: (
            randn(37, 100, dtype=torch.float32),
            randn(100, dtype=torch.float32)),
        "K=4100 f32 per-column (theta past shared memory)": lambda: (
            randn(5, 4100, dtype=torch.float32),
            randn(4100, dtype=torch.float32)),
        "chunk probs (4,3,384,384) int32 per-row": lambda: (
            ints(4, 3, 384, 384), ints(3, 384, 1, lo=-8, hi=8)),
        "int32 strided V^T words (4,3,48,100), ragged": lambda: (
            ints(4, 3, 100, 48, lo=0, hi=2).transpose(2, 3),
            torch.ones((), dtype=torch.int32, device=dev)),
        "unaligned rows and odd strides (vector loads off)": lambda: (
            randn(2, 77, 3, 49)[..., 1:].permute(0, 2, 3, 1),
            randn(3, 1, 1, dtype=torch.float32)),
        "no unit stride (one warp per word), per-element theta": lambda: (
            randn(40, 7, 5).permute(2, 1, 0),
            randn(5, 7, 40, dtype=torch.float32)),
        "row offset of one value (16-byte loads off)": lambda: (
            randn(9, 577)[:, 1:], randn(576, dtype=torch.float32)),
    }


@pytest.mark.parametrize("case", list(_pack_cases("cpu")))
def test_pack_threshold_layouts(cuda, case):
    """The contiguous, strided and any-layout kernels at the decode,
    prefill and encoder shapes, with ragged K, f32 and int32 x, every
    theta form, and views whose vector loads must fall back."""
    x, th = _pack_cases(cuda)[case]()
    before = kernels.launch_counts()["pack_threshold"]
    got = pack_ops.pack_threshold(x, th)
    assert kernels.launch_counts()["pack_threshold"] == before + 1
    assert torch.equal(got, pack_ref.pack_threshold(x, th)), case
