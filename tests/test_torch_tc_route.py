"""``rbmm_int``'s route rule and tile rule, pinned at the main paths'
shapes, and the plain versions the two redesigned kernels are held to on
the card, against the JAX package: ``ref.rbmm_int`` on words whose pad bits
are set (the tensor-core route unpacks every bit and corrects by integers,
so the plain version must give the JAX answer for any words), and
``ref.pack_threshold`` on int32 x and on a strided per-head view."""
import test_torch_threads  # noqa: F401  (first: one torch thread)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.pack import ops as jpack_ops
from repro.kernels.pack import ref as jpack_ref
from repro.kernels.rbmm import ops as jrbmm_ops
from repro.kernels.rbmm import ref as jrbmm_ref
from repro_torch.kernels.pack import ref as tpack_ref
from repro_torch.kernels.rbmm import ops as trbmm_ops
from repro_torch.kernels.rbmm import ref as trbmm_ref


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


@pytest.mark.parametrize("shape,want", [
    # decode: wq/wk/wv/wo and the FFN at M = batch (8 static, 16 slots),
    # the ring scores and context at M = G = 3 query heads per KV head
    ((8, 576, 18), "scalar"), ((16, 1536, 18), "scalar"),
    ((3, 384, 2), "scalar"), ((16, 576, 48), "scalar"),
    # the encoder's F2 and chunked prefill's prefix score, context and
    # intra-chunk score (M = 3 query heads x 128 chunk rows)
    ((4096, 768, 24), "tc"), ((384, 384, 2), "tc"), ((384, 64, 12), "tc"),
    ((384, 128, 2), "tc")])
def test_route_at_main_path_shapes(shape, want):
    assert trbmm_ops.route(*shape) == want


def test_tile_n_takes_fewest_padded_columns():
    assert [trbmm_ops.tile_n(p) for p in (768, 384, 128, 64, 256, 1, 193)] \
        == [192, 192, 128, 64, 128, 64, 128]


@pytest.mark.parametrize("scheme,with_dc", [("xnor", False),
                                            ("and_dc", False),
                                            ("and_dc", True)])
def test_rbmm_int_plain_matches_jax_with_pad_bits_set(scheme, with_dc):
    """K = 100 (Kp = 4, 28 pad bits a row) and K = 800 (Kp = 25), every
    bit of every word random: the JAX kernel (interpret mode) at K = 100,
    its oracle at both."""
    for k in (100, 800):
        rng = np.random.default_rng(k + len(scheme))
        kp = (k + 31) // 32
        a = rng.integers(0, 2**32, (13, kp), dtype=np.uint64).astype(
            np.uint32)
        b = rng.integers(0, 2**32, (70, kp), dtype=np.uint64).astype(
            np.uint32)
        if k % 32:
            assert (a[:, -1] >> np.uint32(k % 32)).any()   # pad bits set
        dc = rng.integers(0, k, (13,)).astype(np.int32) if with_dc else None
        got = trbmm_ref.rbmm_int(
            torch.from_numpy(a.view(np.int32)),
            torch.from_numpy(b.view(np.int32)), k, scheme=scheme,
            dc=None if dc is None else torch.from_numpy(dc)).numpy()
        jdc = None if dc is None else jnp.asarray(dc)
        ja, jb = jnp.asarray(a), jnp.asarray(b)
        np.testing.assert_array_equal(got, np.asarray(jrbmm_ref.rbmm_int(
            ja, jb, k, scheme=scheme, dc=jdc)))
        if k == 100:
            np.testing.assert_array_equal(got, np.asarray(
                jrbmm_ops.rbmm_int(ja, jb, k, scheme=scheme, dc=jdc)))


def test_pack_plain_matches_jax_on_int32_and_strided_per_head_view():
    """int32 x (the chunk probabilities' form, ragged K = 100) against the
    JAX kernel and oracle; a per-head threshold on the strided V^T view
    (B, H, d_h, S) = v.permute(0, 2, 3, 1) against the JAX oracle, head by
    head on the materialised rows."""
    rng = np.random.default_rng(5)
    x = rng.integers(-20, 20, (37, 100)).astype(np.int32)
    th = rng.integers(-3, 3, (100,)).astype(np.int32)
    got = _u32(tpack_ref.pack_threshold(torch.from_numpy(x),
                                        torch.from_numpy(th)))
    np.testing.assert_array_equal(got, np.asarray(jpack_ops.pack_threshold(
        jnp.asarray(x), jnp.asarray(th))))
    np.testing.assert_array_equal(got, np.asarray(jpack_ref.pack_threshold(
        jnp.asarray(x), jnp.asarray(th))))
    v = rng.standard_normal((2, 77, 3, 48)).astype(np.float32)
    beta = (0.2 * rng.standard_normal(3)).astype(np.float32)
    vt = torch.from_numpy(v).permute(0, 2, 3, 1)        # (2, 3, 48, 77)
    got = _u32(tpack_ref.pack_threshold(
        vt, torch.from_numpy(beta)[:, None, None]))
    rows = np.ascontiguousarray(v.transpose(0, 2, 3, 1))
    for h in range(3):
        want = jpack_ref.pack_threshold(
            jnp.asarray(rows[:, h].reshape(-1, 77)),
            jnp.full((77,), beta[h]))
        np.testing.assert_array_equal(got[:, h].reshape(-1, 3),
                                      np.asarray(want))


def test_rbmm_binary_theta_strides_match_the_expanded_view():
    """The wrapper reads a theta of at most two dims through its own
    strides; they must address what the expanded (batch, M, P) view does
    (axes of one element are never stepped)."""
    shape = torch.Size((2, 3, 5, 7))   # (..., M, P), batch 6
    for theta in (torch.arange(7, dtype=torch.int32),
                  torch.tensor(4, dtype=torch.int32),
                  torch.arange(35, dtype=torch.int32).reshape(5, 7),
                  torch.arange(35, dtype=torch.int32).reshape(7, 5).T,
                  torch.arange(5, dtype=torch.int32).reshape(5, 1),
                  torch.arange(7, dtype=torch.int32).reshape(1, 7),
                  torch.arange(210, dtype=torch.int32).reshape(shape)):
        want = theta.expand(shape).reshape(6, 5, 7)
        th, got = trbmm_ops._theta_view(theta, shape, 6)
        assert th.data_ptr() == want.data_ptr()
        assert [g if n > 1 else 0 for g, n in zip(got, (6, 5, 7))] == \
            [w if n > 1 else 0 for w, n in zip(want.stride(), (6, 5, 7))]
