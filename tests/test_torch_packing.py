"""Port parity: ``repro_torch.core.packing`` and the pack kernel's plain
version against the JAX package (its Pallas kernel in interpret mode and
its oracle).  Packed words must be bitwise equal: the port's int32 words
viewed as uint32 are the JAX package's words."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import packing as jpack
from repro.kernels.pack import ops as jpack_ops
from repro.kernels.pack import ref as jpack_ref
from repro_torch.core import packing as tpack
from repro_torch.kernels.pack import ops as tpack_ops

KS = [32, 48, 100, 576]


def _words(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def _rand_words(rng, shape, k):
    w = rng.integers(0, 2**32, shape, dtype=np.uint64).astype(np.uint32)
    pad = w.shape[-1] * 32 - k
    if pad:
        w[..., -1] &= np.uint32((1 << (32 - pad)) - 1)
    return w


@pytest.mark.parametrize("k", KS)
def test_pack_unpack_match_jax(k):
    rng = np.random.default_rng(k)
    bits = rng.integers(0, 2, (3, 5, k)).astype(np.int32)
    want = np.asarray(jpack.pack_bits(jnp.asarray(bits)))
    got = tpack.pack_bits(torch.from_numpy(bits))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(_u32(got), want)
    np.testing.assert_array_equal(tpack.unpack_bits(got, k).numpy(), bits)
    x = rng.standard_normal((4, k)).astype(np.float32)
    x[0, :3] = 0.0                       # sign(0) := +1, unsigned 0 -> 0
    np.testing.assert_array_equal(
        _u32(tpack.pack_signs(torch.from_numpy(x))),
        np.asarray(jpack.pack_signs(jnp.asarray(x))))
    np.testing.assert_array_equal(
        _u32(tpack.pack_unsigned(torch.from_numpy(x))),
        np.asarray(jpack.pack_unsigned(jnp.asarray(x))))
    np.testing.assert_array_equal(
        tpack.unpack_signs(got, k).numpy(),
        np.asarray(jpack.unpack_signs(jnp.asarray(want), k)))


@pytest.mark.parametrize("k", KS)
def test_popcount_dc_and_score_match_jax(k):
    rng = np.random.default_rng(100 + k)
    kp = tpack.packed_len(k)
    a = _rand_words(rng, (6, kp), k)
    b = _rand_words(rng, (6, kp), k)
    a[0, :k // 32] = 0xFFFFFFFF                 # full words: bit 31 set
    np.testing.assert_array_equal(
        tpack.popcount_words(_words(a)).numpy(),
        np.asarray(jpack.popcount_words(jnp.asarray(a))))
    np.testing.assert_array_equal(
        tpack.dc_count(_words(a), k).numpy(),
        np.asarray(jpack.dc_count(jnp.asarray(a), k)))
    np.testing.assert_array_equal(
        tpack.xnor_popcount_score(_words(a)[:, None], _words(b)[None],
                                  k).numpy(),
        np.asarray(jpack.xnor_popcount_score(jnp.asarray(a)[:, None],
                                             jnp.asarray(b)[None], k)))


def test_score_rejects_wrong_word_counts():
    a = torch.zeros((2, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="disagree"):
        tpack.xnor_popcount_score(a, torch.zeros((2, 3), dtype=torch.int32),
                                  48)
    with pytest.raises(ValueError, match="ceil"):
        tpack.xnor_popcount_score(a, a, 100)


def test_bit_mask_sets_one_bit_including_31():
    off = torch.arange(32)
    want = (np.uint32(1) << np.arange(32, dtype=np.uint32))
    np.testing.assert_array_equal(_u32(tpack.bit_mask(off)), want)


@pytest.mark.parametrize("dtype", ["float32", "int32", "bfloat16"])
@pytest.mark.parametrize("k", [100, 576])
def test_pack_threshold_matches_jax_kernel_and_oracle(dtype, k):
    rng = np.random.default_rng(7)
    if dtype == "int32":
        x = rng.integers(-20, 20, (37, k)).astype(np.int32)
        th = rng.integers(-3, 3, (k,)).astype(np.int32)
        xt, tt = torch.from_numpy(x), torch.from_numpy(th)
        xj, tj = jnp.asarray(x), jnp.asarray(th)
    else:
        x = rng.standard_normal((37, k)).astype(np.float32)
        th = (0.3 * rng.standard_normal(k)).astype(np.float32)
        xt, tt = torch.from_numpy(x), torch.from_numpy(th)
        xj, tj = jnp.asarray(x), jnp.asarray(th)
        if dtype == "bfloat16":
            # the JAX kernel casts theta to x's dtype; feed it a theta
            # already on the bf16 grid so both compare the same numbers
            xt = xt.to(torch.bfloat16)
            tt = tt.to(torch.bfloat16).to(torch.float32)
            xj = xj.astype(jnp.bfloat16)
            tj = jnp.asarray(tt.numpy()).astype(jnp.bfloat16)
    got = _u32(tpack_ops.pack_threshold(xt, tt))
    np.testing.assert_array_equal(
        got, np.asarray(jpack_ops.pack_threshold(xj, tj)))
    np.testing.assert_array_equal(
        got, np.asarray(jpack_ref.pack_threshold(xj, tj)))


def test_pack_threshold_broadcast_per_head_and_strided():
    """A per-head threshold on a (..., H, d_h) view and a permuted V^T
    view give the packing of the materialised comparison."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((2, 77, 3, 48)).astype(
        np.float32))
    beta = torch.from_numpy((0.2 * rng.standard_normal(3)).astype(
        np.float32))
    got = tpack_ops.pack_threshold(x, beta[:, None])
    want = jpack.pack_bits(jnp.asarray((x >= beta[:, None]).numpy()))
    np.testing.assert_array_equal(_u32(got), np.asarray(want))
    vt = x.permute(0, 2, 3, 1)                     # (B, H, d_h, L) view
    got = tpack_ops.pack_threshold(vt, beta[:, None, None])
    want = jpack.pack_bits(jnp.asarray(
        (vt >= beta[:, None, None]).numpy()))
    np.testing.assert_array_equal(_u32(got), np.asarray(want))


def test_pack_threshold_rejects_what_the_kernel_does_not_take():
    x = torch.zeros((4, 40))
    with pytest.raises(TypeError, match="theta"):
        tpack_ops.pack_threshold(x, torch.zeros((), dtype=torch.float64))
    with pytest.raises(TypeError, match="bfloat16, float32 or int32"):
        tpack_ops.pack_threshold(x.double(), torch.zeros(()))
    with pytest.raises(ValueError, match="broadcast"):
        tpack_ops.pack_threshold(x, torch.zeros(41))
    with pytest.raises(ValueError, match="1-4 dims"):
        tpack_ops.pack_threshold(torch.zeros((1, 1, 1, 1, 4)),
                                 torch.zeros(()))
