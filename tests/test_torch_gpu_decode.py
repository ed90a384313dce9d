"""``rbmm_int``'s decode route (M <= 16, ``csrc/rbmm.cu``
``rbmm_int_dec_kernel``) against its plain version on a CUDA card: every
decode call of smollm-135m at M (or batch) 8 and 16, M and Kp edges with
pad bits set, P off the column tile, batches, both schemes with dc given
and derived, and operands whose base is not 16-byte aligned.

Marked ``gpu``: without a card every test skips (the decision is made in
a fixture, so every worker collects the same tests).  On a card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu_decode.py

This file imports no JAX.  Outputs are int32 and must be bitwise equal."""
import test_torch_threads  # noqa: F401  (first: one torch thread)
import pytest
import torch

from repro_torch import kernels
from repro_torch.kernels.rbmm import ops as rbmm_ops, ref as rbmm_ref
from repro_torch.launch.kernel_times import DECODE_CALLS, decode_calls

pytestmark = pytest.mark.gpu

SCHEMES = [("xnor", False), ("and_dc", False), ("and_dc", True)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: compares the decode kernel with its "
                    "plain version on the card")
    return torch.device("cuda")


def _words(gen, shape, dev):
    """Random words with every bit random, pad bits included."""
    return torch.randint(-2**31, 2**31, shape, generator=gen,
                         dtype=torch.int64).to(torch.int32).to(dev)


def _dc(gen, lead, m, k, dev):
    return torch.randint(0, k + 1, lead + (m,), generator=gen,
                         dtype=torch.int32).to(dev)


def _decode(a, b, k, scheme, dc=None):
    """The decode route, launched once and counted once, equal to the plain
    version; where M <= 16 the public wrapper takes the same route."""
    want = rbmm_ref.rbmm_int(a, b, k, scheme=scheme, dc=dc)
    before = kernels.launch_counts()["rbmm_int"]
    got = rbmm_ops.launch_int("scalar", a, b, k, scheme=scheme, dc=dc)
    assert kernels.launch_counts()["rbmm_int"] == before + 1
    assert torch.equal(got, want), (tuple(a.shape), tuple(b.shape), k,
                                    scheme, dc is not None)
    if a.shape[-2] <= 16:
        assert rbmm_ops.route(a.shape[-2], b.shape[-2], a.shape[-1]) == \
            "scalar"
        assert torch.equal(rbmm_ops.rbmm_int(a, b, k, scheme=scheme, dc=dc),
                           want)


@pytest.mark.parametrize("call", list(DECODE_CALLS))
def test_decode_calls(cuda, call):
    """The call at M (or batch) 8 and 16; and_dc calls with dc derived (as
    the model calls them) and given."""
    gen = torch.Generator().manual_seed(21)
    for name, (lead, m, p, k, scheme) in decode_calls(
            crossover=()).items():
        if not name.startswith(f"rbmm_int decode {call} "):
            continue
        kp = (k + 31) // 32
        a, b = _words(gen, lead + (m, kp), cuda), \
            _words(gen, lead + (p, kp), cuda)
        _decode(a, b, k, scheme)
        if scheme == "and_dc":
            _decode(a, b, k, scheme, _dc(gen, lead, m, k, cuda))


@pytest.mark.parametrize("m", [1, 3, 16])
def test_decode_m_edges(cuda, m):
    """M = 1, 3 (a row bucket of 4) and 16 against P around the column
    tiles, every scheme, Kp 18 and 48 with pad bits set."""
    gen = torch.Generator().manual_seed(22 + m)
    for p in (1, 31, 33, 577):
        for k in (570, 1530):
            kp = (k + 31) // 32
            a, b = _words(gen, (m, kp), cuda), _words(gen, (p, kp), cuda)
            for scheme, with_dc in SCHEMES:
                _decode(a, b, k, scheme,
                        _dc(gen, (), m, k, cuda) if with_dc else None)


@pytest.mark.parametrize("scheme,with_dc", SCHEMES)
def test_decode_kp_edges(cuda, scheme, with_dc):
    """Kp = 1, 2, 5, 17, 18, 19, 48, 49 and 256 (two K-chunks at 32
    lanes), each with pad bits set (K = 32 Kp - 5, every bit random), at
    M of 2, 5, 8 and 9, P off the column tile, batched leading dims."""
    gen = torch.Generator().manual_seed(23 + with_dc + len(scheme))
    for kp in (1, 2, 5, 17, 18, 19, 48, 49, 256):
        k = 32 * kp - 5
        for lead, m, p in (((), 5, 77), ((3,), 8, 161), ((2, 3), 2, 65),
                           ((), 9, 193)):
            a, b = _words(gen, lead + (m, kp), cuda), \
                _words(gen, lead + (p, kp), cuda)
            _decode(a, b, k, scheme,
                    _dc(gen, lead, m, k, cuda) if with_dc else None)


def test_decode_unaligned_bases(cuda):
    """Contiguous operands 4, 8 and 12 bytes past a 16-byte boundary (rows
    sliced off a larger flat tensor): the kernel lowers its 16- and 8-byte
    loads to what the bases allow."""
    gen = torch.Generator().manual_seed(24)
    for off in (1, 2, 3):
        for m, p, kp in ((8, 576, 48), (16, 192, 18), (8, 160, 2)):
            flat = _words(gen, (off + (m + p) * kp,), cuda)
            a = flat[off:off + m * kp].view(m, kp)
            b = flat[off + m * kp:].view(p, kp)
            assert a.is_contiguous() and a.data_ptr() % 16 == 4 * off
            for scheme, with_dc in SCHEMES:
                _decode(a, b, 32 * kp - 3, scheme,
                        _dc(gen, (), m, 32 * kp - 3, cuda) if with_dc
                        else None)


def test_decode_route_past_16_rows(cuda):
    """``launch_int("scalar")`` at M > 16 (row blocks of 16, a ragged last
    one), as the card tests of both routes call it."""
    gen = torch.Generator().manual_seed(25)
    for lead, m, p, k in (((), 17, 65, 600), ((2,), 33, 100, 1530),
                          ((), 100, 577, 64)):
        kp = (k + 31) // 32
        a, b = _words(gen, lead + (m, kp), cuda), \
            _words(gen, lead + (p, kp), cuda)
        for scheme, with_dc in SCHEMES:
            _decode(a, b, k, scheme,
                    _dc(gen, lead, m, k, cuda) if with_dc else None)
