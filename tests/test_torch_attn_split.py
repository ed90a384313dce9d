"""The arithmetic the redesigned attention kernels rely on, on the CPU,
against the JAX kernels in interpret mode and both packages' plain
versions:

  * ``sps_attention`` as two integer matrix products (the int8 tensor-core
    kernel): every bit unpacked to ±1, the score the int32 dot product
    minus the pad, {0,1} probabilities times ±1 V;
  * ``paged_gather_decode`` split over its pages: each live page's int32
    partial context added in a shuffled order.

Outputs are int32 and must be bitwise equal."""
import test_torch_threads  # noqa: F401  (first: one torch thread)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_attn import kernel as jpk
from repro.kernels.sps_attn import kernel as jsk
from repro_torch.kernels.paged_attn import ref as tpref
from repro_torch.kernels.sps_attn import ref as tsref


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32
                            else a)


def _words(rng, shape, k=None):
    """Random words with k true bits per row (zero pad bits), or every bit
    random when k is None."""
    w = rng.integers(0, 2**32, shape, dtype=np.uint64).astype(np.uint32)
    pad = 0 if k is None else shape[-1] * 32 - k
    if pad:
        w[..., -1] &= np.uint32((1 << (32 - pad)) - 1)
    return w


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("length", [40, 77])
@pytest.mark.parametrize("d_h", [48, 64])
def test_sps_int8_products_match_jax_kernel(d_h, length, causal):
    """GQA 3:1: the matmul form equals the port's packed plain version and
    the JAX kernel (interpret mode, K and V^T repeated to the heads)."""
    rng = np.random.default_rng(d_h * 1000 + length * 10 + causal)
    h, hkv, dhp, lw = 3, 1, (d_h + 31) // 32, (length + 31) // 32
    q = _words(rng, (1, h, length, dhp), d_h)
    k = _words(rng, (1, hkv, length, dhp), d_h)
    vt = _words(rng, (1, hkv, d_h, lw), length)
    th = rng.integers(-8, 9, (h,)).astype(np.int32)
    got = tsref.sps_attention_int8(_t(q), _t(k), _t(vt), _t(th), d_h=d_h,
                                   causal=causal)
    want = tsref.sps_attention_gqa(_t(q), _t(k), _t(vt), _t(th), d_h=d_h,
                                   causal=causal)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    jax_out = jsk.sps_attention(
        jnp.asarray(q[0]), jnp.asarray(np.repeat(k[0], h, 0)),
        jnp.asarray(np.repeat(vt[0], h, 0)), jnp.asarray(th), d_h=d_h,
        causal=causal, bq=32, bk=32, interpret=True)
    np.testing.assert_array_equal(got.numpy()[0], np.asarray(jax_out))


def test_sps_int8_score_minus_pad_holds_for_any_pad_bits():
    """The kernel unpacks every bit, pad bits included, and subtracts the
    pad: that is the popcount form's score whatever the pad bits hold."""
    rng = np.random.default_rng(7)
    q = _words(rng, (2, 6, 33, 2))
    k = _words(rng, (2, 2, 33, 2))
    vt = _words(rng, (2, 2, 48, 2))
    th = rng.integers(-8, 9, (6,)).astype(np.int32)
    for causal in (True, False):
        np.testing.assert_array_equal(
            tsref.sps_attention_int8(_t(q), _t(k), _t(vt), _t(th), d_h=48,
                                     causal=causal).numpy(),
            tsref.sps_attention_gqa(_t(q), _t(k), _t(vt), _t(th), d_h=48,
                                    causal=causal).numpy())


@pytest.mark.parametrize("b,h,hkv,dh,page,nblk,pages,ring", [
    (3, 9, 3, 48, 32, 3, 6, 96),          # d_h = 48: pad bits
    (2, 4, 2, 32, 64, 5, 8, 300),         # page 64, ring < nblk * page
    (4, 6, 3, 64, 32, 20, 30, 640),       # 20 pages: past 16 warps
    (2, 32, 2, 64, 96, 2, 3, 192),        # G = 16, page 96
])
def test_paged_split_sum_matches_jax_kernel(b, h, hkv, dh, page, nblk,
                                            pages, ring):
    """Per-page partials added in a shuffled order equal the port's plain
    version and the JAX kernel (interpret mode), with trash entries, a
    length 0 and a length past the ring."""
    rng = np.random.default_rng(b * 100 + page + dh + nblk)
    dhp = (dh + 31) // 32
    q = _words(rng, (b, h, dhp), dh)
    kp = _words(rng, (pages + 1, hkv, page, dhp), dh)
    vt = _words(rng, (pages + 1, hkv, dh, page // 32), page)
    bt = rng.integers(0, pages + 1, (b, nblk)).astype(np.int32)
    bt[-1, -1] = 0
    lens = rng.integers(0, ring + 20, (b,)).astype(np.int32)
    lens[0], lens[-1] = 0, ring + 3
    th = rng.integers(-12, 12, (b, h)).astype(np.int32)
    args = (_t(q), _t(kp), _t(vt), _t(bt), _t(lens), ring, _t(th))
    got = tpref.paged_gather_decode_split(
        *args, d_h=dh, generator=torch.Generator().manual_seed(nblk))
    np.testing.assert_array_equal(
        got.numpy(),
        tpref.paged_gather_decode_popcount(*args, d_h=dh).numpy())
    j = [jnp.asarray(a) for a in (q, kp, vt, bt, lens)]
    jargs = (*j, jnp.int32(ring), jnp.asarray(th))
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        jpk.paged_gather_decode(*jargs, d_h=dh, interpret=True)))
