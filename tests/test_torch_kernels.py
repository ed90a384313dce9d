"""Port parity: the plain versions of the RBMM, packed-weight MMA and SPS
attention kernels, and ``repro_torch.core.rbmm``, against the JAX package's
Pallas kernels (interpret mode, through their ``ops.py``) and oracles.
Integer and packed outputs must be bitwise equal, ragged shapes included
(K % 32 != 0, L % 32 != 0, d_h = 48)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import rbmm as jrbmm_core
from repro.kernels.rbmm import ops as jrbmm_ops
from repro.kernels.rbmm import ref as jrbmm_ref
from repro.kernels.rbmm_mxu import ops as jmxu_ops
from repro.kernels.rbmm_mxu import ref as jmxu_ref
from repro.kernels.sps_attn import ops as jsps_ops
from repro.kernels.sps_attn import ref as jsps_ref
from repro_torch.core import rbmm as trbmm_core
from repro_torch.kernels.rbmm import ops as trbmm_ops
from repro_torch.kernels.rbmm_mxu import ops as tmxu_ops
from repro_torch.kernels.sps_attn import ops as tsps_ops
from repro_torch.kernels.sps_attn import ref as tsps_ref


def _t(a) -> torch.Tensor:
    a = np.array(a)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32
                            else a)


def _words(rng, shape, k):
    w = rng.integers(0, 2**32, shape, dtype=np.uint64).astype(np.uint32)
    pad = w.shape[-1] * 32 - k
    if pad:
        w[..., -1] &= np.uint32((1 << (32 - pad)) - 1)
    return w


def _pm1(rng, shape, unsigned=False):
    bits = rng.integers(0, 2, shape)
    return (bits if unsigned else 2 * bits - 1).astype(np.float32)


@pytest.mark.parametrize("scheme,with_dc", [("xnor", False),
                                            ("and_dc", False),
                                            ("and_dc", True)])
def test_rbmm_int_plain_matches_jax_kernel_and_oracle(scheme, with_dc):
    for k in (100, 128):
        rng = np.random.default_rng(k)
        kp = (k + 31) // 32
        a, b = _words(rng, (13, kp), k), _words(rng, (70, kp), k)
        dc = rng.integers(0, k, (13,)).astype(np.int32) if with_dc else None
        got = trbmm_ops.rbmm_int(_t(a), _t(b), k, scheme=scheme,
                                 dc=None if dc is None else _t(dc)).numpy()
        jdc = None if dc is None else jnp.asarray(dc)
        np.testing.assert_array_equal(got, np.asarray(jrbmm_ops.rbmm_int(
            jnp.asarray(a), jnp.asarray(b), k, scheme=scheme, dc=jdc)))
        np.testing.assert_array_equal(got, np.asarray(jrbmm_ref.rbmm_int(
            jnp.asarray(a), jnp.asarray(b), k, scheme=scheme, dc=jdc)))


def test_rbmm_int_batched_equals_per_batch():
    rng = np.random.default_rng(1)
    a, b = _words(rng, (2, 3, 5, 2), 48), _words(rng, (2, 3, 9, 2), 48)
    got = trbmm_ops.rbmm_int(_t(a), _t(b), 48, scheme="and_dc").numpy()
    for i in range(2):
        for j in range(3):
            np.testing.assert_array_equal(got[i, j], np.asarray(
                jrbmm_ref.rbmm_int(jnp.asarray(a[i, j]),
                                   jnp.asarray(b[i, j]), 48,
                                   scheme="and_dc")))


@pytest.mark.parametrize("unsigned", [False, True])
def test_rbmm_mxu_plain_matches_jax(unsigned):
    rng = np.random.default_rng(2)
    # the JAX kernel tiles K by whole words; its oracle takes ragged K
    a, w = _pm1(rng, (70, 128), unsigned), _words(rng, (45, 4), 128)
    got = tmxu_ops.rbmm_mxu(_t(a), _t(w)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jmxu_ops.rbmm_mxu(
        jnp.asarray(a), jnp.asarray(w), bm=16, bn=16, bk=64)))
    a, w = _pm1(rng, (70, 100), unsigned), _words(rng, (45, 4), 100)
    np.testing.assert_array_equal(
        tmxu_ops.rbmm_mxu(_t(a), _t(w)).numpy(),
        np.asarray(jmxu_ref.rbmm_mxu(jnp.asarray(a), jnp.asarray(w))))


@pytest.mark.parametrize("impl", ["popcount", "mxu", "auto"])
@pytest.mark.parametrize("scheme", ["xnor", "and_dc"])
def test_core_rbmm_int_matches_jax(impl, scheme):
    rng = np.random.default_rng(3)
    a, b = _words(rng, (24, 4), 100), _words(rng, (33, 4), 100)
    got = trbmm_core.rbmm_int(_t(a), _t(b), 100, scheme=scheme, impl=impl)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        jrbmm_core.rbmm_int(jnp.asarray(a), jnp.asarray(b), 100,
                            scheme=scheme, impl=impl)))
    assert trbmm_core.resolve_impl("auto", 16) == "popcount"
    assert trbmm_core.resolve_impl("auto", 17) == "mxu"


def test_rbmm_wrappers_reject_bad_operands():
    a = torch.zeros((4, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="ceil"):
        trbmm_ops.rbmm_int(a, a, 100)
    with pytest.raises(ValueError, match="scheme"):
        trbmm_ops.rbmm_int(a, a, 64, scheme="or")
    with pytest.raises(TypeError, match="int32"):
        trbmm_ops.rbmm_int(a.float(), a, 64)
    with pytest.raises(ValueError, match="dc"):
        trbmm_ops.rbmm_int(a, a, 64, scheme="and_dc",
                           dc=torch.zeros(5, dtype=torch.int32))
    with pytest.raises(ValueError, match="too short"):
        tmxu_ops.rbmm_mxu(torch.zeros((4, 100)), a)
    with pytest.raises(ValueError, match="scheme"):
        trbmm_core.rbmm_int(a, a, 64, scheme="nope")


@pytest.mark.parametrize("length,d_h", [(77, 48), (64, 64)])
def test_sps_attention_plain_matches_jax_kernel_and_oracles(length, d_h):
    rng = np.random.default_rng(length)
    h, dhp = 3, (d_h + 31) // 32
    q, k = _words(rng, (h, length, dhp), d_h), _words(rng, (h, length, dhp),
                                                      d_h)
    v = _pm1(rng, (h, length, d_h))
    theta = rng.integers(-8, 9, (h,)).astype(np.int32)
    vt = np.asarray(jsps_ref.v_transpose_packed(jnp.asarray(v)))
    np.testing.assert_array_equal(
        tsps_ref.v_transpose_packed(_t(v)).numpy().view(np.uint32), vt)
    want = np.asarray(jsps_ops.sps_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(vt), jnp.asarray(theta),
        d_h=d_h, bq=32, bk=32))
    np.testing.assert_array_equal(want, np.asarray(jsps_ref.sps_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(theta),
        d_h=d_h)))
    for path, vin in (("vpu", vt), ("mxu", v)):
        got = tsps_ops.sps_attention(_t(q), _t(k), _t(vin), _t(theta),
                                     d_h=d_h, path=path)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=path)


def test_sps_attention_gqa_reads_kv_head_per_group():
    """The batched entry equals the one-sequence oracle run per sequence
    on K/V repeated to every query head, causal and not."""
    rng = np.random.default_rng(5)
    b, h, hkv, length, d_h = 2, 3, 1, 45, 48
    q = _words(rng, (b, h, length, 2), d_h)
    k = _words(rng, (b, hkv, length, 2), d_h)
    v = _pm1(rng, (b, hkv, length, d_h))
    theta = rng.integers(-6, 7, (h,)).astype(np.int32)
    vt = np.stack([np.asarray(jsps_ref.v_transpose_packed(jnp.asarray(x)))
                   for x in v])
    for causal in (True, False):
        got = tsps_ops.sps_attention_gqa(_t(q), _t(k), _t(vt), _t(theta),
                                         d_h=d_h, causal=causal).numpy()
        for i in range(b):
            want = jsps_ref.sps_attention_popcount(
                jnp.asarray(q[i]), jnp.asarray(np.repeat(k[i], h, 0)),
                jnp.asarray(np.repeat(vt[i], h, 0)), jnp.asarray(theta),
                d_h=d_h, causal=causal)
            np.testing.assert_array_equal(got[i], np.asarray(want))


def test_sps_attention_rejects_bad_word_counts():
    q = torch.zeros((1, 3, 8, 2), dtype=torch.int32)
    vt = torch.zeros((1, 1, 48, 1), dtype=torch.int32)
    theta = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(ValueError, match="ceil"):
        tsps_ops.sps_attention_gqa(q, q[:, :1], vt, theta, d_h=100)
    with pytest.raises(ValueError, match="vt_bits"):
        tsps_ops.sps_attention_gqa(q, q[:, :1], vt[..., :40, :], theta,
                                   d_h=48)
    with pytest.raises(ValueError, match="divide"):
        tsps_ops.sps_attention_gqa(q, q[:, :2], vt, theta, d_h=48)
    with pytest.raises(ValueError, match="path"):
        tsps_ops.sps_attention(q[0], q[0], vt[0], theta, d_h=48,
                               path="tpu")
