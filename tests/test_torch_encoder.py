"""Port parity of the bert-base-cobra deploy path: the threshold-fused RBMM
(plain version, wrapper and ``core.rbmm``), split-K, the Eq. 11 blocked
FFN and the mode wrappers, the fused ``BinaryDense`` faces, the ReLU FFN,
LayerNorm, the fp head, bidirectional attention, one block, the bridge and
``prefill_logits``, each against the JAX package on the same numpy inputs.

Packed words, bits and integers must be bitwise equal.  Floats must agree
within ATOL: the frameworks sum LayerNorm and the head in different orders,
which moves float32 results by a few ulps, never the integer parts."""
import test_torch_threads  # noqa: F401  (first: one torch thread)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.core import packing as jpacking
from repro.core import rbmm as jcore
from repro.kernels.rbmm import ops as jops
from repro.kernels.rbmm import ref as jref
from repro.models import nn as jnn
from repro.models.blocks import Block as JBlock
from repro.models.ffn import BinaryFFN as JFFN
from repro.models.linear import BinaryDense as JDense
from repro.models.lm import build_model as jbuild
from repro_torch import bridge
from repro_torch.configs import base as tbase
from repro_torch.core import packing as tpacking
from repro_torch.core import rbmm as tcore
from repro_torch.kernels.rbmm import ops as tops
from repro_torch.kernels.rbmm import ref as tref
from repro_torch.models import nn as tnn
from repro_torch.models.blocks import Block as TBlock
from repro_torch.models.ffn import BinaryFFN as TFFN
from repro_torch.models.linear import BinaryDense as TDense
from repro_torch.models.lm import build_model as tbuild

ATOL = 1e-4
ARCH = "bert-base-cobra"
B, S = 2, 24            # B*S = 48 > 16: projections take the mxu route


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


def _eq(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    got = got.numpy()
    if want.dtype == np.uint32:
        got = got.view(np.uint32)
    np.testing.assert_array_equal(got, want)


def _close(t: torch.Tensor, j) -> None:
    np.testing.assert_allclose(t.float().numpy(),
                               np.asarray(j, np.float32), atol=ATOL, rtol=0)


def _perturb(tree, rng, name=""):
    """Scales and thresholds off their init values, so every binarization
    and SPS threshold is non-trivial."""
    if isinstance(tree, dict):
        return {k: _perturb(v, rng, k) for k, v in tree.items()}
    a = np.array(tree)
    if name.endswith("_alpha") or name == "bit_alpha":
        return (a * rng.uniform(0.5, 1.5, a.shape)).astype(np.float32)
    if name.endswith("_beta") or name == "bias":
        return (a + 0.1 * rng.standard_normal(a.shape)).astype(np.float32)
    if name in ("sps_lambda", "scale"):
        return (a + 0.3 * rng.standard_normal(a.shape)).astype(np.float32)
    return a


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def smoke():
    rng = np.random.default_rng(0)
    jcfg = jbase.get_smoke_config(ARCH)
    jm = jbuild(jcfg)
    qat = _perturb(_np(jax.jit(jm.init)(jax.random.PRNGKey(0))), rng)
    dp = _np(jax.jit(jm.convert)(qat))
    tm = tbuild(tbase.get_smoke_config(ARCH))
    return dict(rng=rng, jcfg=jcfg, jm=jm, qat=qat, dp=dp, tm=tm,
                tdp=bridge.from_jax_params(dp, device="cpu"),
                tqat=bridge.from_jax_params(qat, device="cpu"))


def _layer0(smoke):
    return (jax.tree.map(lambda t: t[0], smoke["dp"]["blocks"]),
            smoke["tdp"]["blocks"][0])


def _x(rng, rows, d=128):
    return rng.standard_normal((B, rows, d)).astype(np.float32)


# -- the kernel's plain version and wrapper ------------------------------------


@pytest.mark.parametrize("scheme,causal,dc_mode", [
    ("xnor", False, None), ("xnor", True, None),
    ("and_dc", False, "derived"), ("and_dc", True, "given")])
def test_rbmm_binary_plain_matches_jax_ref_and_kernel(scheme, causal,
                                                      dc_mode):
    """Unpacked bits and dc, bitwise, at ragged K and P, M > P (causal
    rows past the last column) and M < P; the wrapper's packed store is
    pack_bits of them."""
    for m, k, p in ((50, 100, 45), (13, 64, 70)):
        rng = np.random.default_rng(m + k)
        kp = (k + 31) // 32
        a, b = _words(rng, (m, kp), k), _words(rng, (p, kp), k)
        theta = rng.integers(-k // 3, k // 3, (p,)).astype(np.int32)
        dc = (rng.integers(0, k, (m,)).astype(np.int32)
              if dc_mode == "given" else None)
        jdc = None if dc is None else jnp.asarray(dc)
        tdc = None if dc is None else _t(dc)
        ja, jb, jth = jnp.asarray(a), jnp.asarray(b), jnp.asarray(theta)
        bits, dc_ret = tref.rbmm_binary(_t(a), _t(b), k, _t(theta),
                                        scheme=scheme, dc=tdc, causal=causal)
        assert bits.dtype == dc_ret.dtype == torch.int32
        for want_bits, want_dc in (
                jref.rbmm_binary(ja, jb, k, jth, scheme=scheme, dc=jdc,
                                 causal=causal),
                jops.rbmm_binary(ja, jb, k, jth, scheme=scheme, dc=jdc,
                                 causal=causal, bm=16, bn=32)):
            _eq(bits, np.asarray(want_bits).astype(np.int32))
            _eq(dc_ret, want_dc)
        for pack in (False, True):
            got, got_dc = tops.rbmm_binary(_t(a), _t(b), k, _t(theta),
                                           scheme=scheme, dc=tdc,
                                           causal=causal, pack_output=pack)
            assert torch.equal(got, tpacking.pack_bits(bits) if pack
                               else bits)
            assert torch.equal(got_dc, dc_ret)


def test_rbmm_binary_plain_with_pad_bits_matches_jax_ref():
    """Nonzero pad bits in the last word (K % 32 != 0): the plain version
    still equals the JAX ref on the same words, bits and dc, both schemes,
    dc derived and given, causal or not.  The card kernel unpacks every bit
    of the Kp words and must agree with this, not only on zero pads."""
    for m, k, p in ((50, 100, 45), (33, 48, 70)):
        rng = np.random.default_rng(k)
        kp = (k + 31) // 32
        a = rng.integers(0, 2**32, (m, kp), dtype=np.uint64).astype(
            np.uint32)
        b = rng.integers(0, 2**32, (p, kp), dtype=np.uint64).astype(
            np.uint32)
        a[:, -1] |= np.uint32(0xF0000000)   # pad bits set in both
        b[:, -1] |= np.uint32(0xC0000000)
        theta = rng.integers(-k // 3, k // 3, (p,)).astype(np.int32)
        dc = rng.integers(0, k, (m,)).astype(np.int32)
        for scheme, given, causal in (("xnor", False, False),
                                      ("xnor", False, True),
                                      ("and_dc", False, False),
                                      ("and_dc", True, True)):
            bits, dc_ret = tref.rbmm_binary(
                _t(a), _t(b), k, _t(theta), scheme=scheme,
                dc=_t(dc) if given else None, causal=causal)
            want_bits, want_dc = jref.rbmm_binary(
                jnp.asarray(a), jnp.asarray(b), k, jnp.asarray(theta),
                scheme=scheme, dc=jnp.asarray(dc) if given else None,
                causal=causal)
            _eq(bits, np.asarray(want_bits).astype(np.int32))
            _eq(dc_ret, want_dc)


def test_rbmm_binary_wrapper_batches_broadcasts_and_checks():
    """Leading dims, a per-row theta and a full (..., M, P) table, each
    equal to the per-sequence JAX oracle; bad operands raise."""
    rng = np.random.default_rng(5)
    a, b = _words(rng, (3, 9, 2), 48), _words(rng, (3, 40, 2), 48)
    for theta in (rng.integers(-9, 9, (40,)), rng.integers(-9, 9, (9, 1)),
                  rng.integers(-9, 9, (3, 9, 40)), np.array(2)):
        theta = theta.astype(np.int32)
        got, got_dc = tops.rbmm_binary(_t(a), _t(b), 48, _t(theta),
                                       scheme="and_dc", pack_output=True)
        th = np.broadcast_to(theta, (3, 9, 40))
        for z in range(3):
            c = np.asarray(jref.rbmm_int(jnp.asarray(a[z]),
                                         jnp.asarray(b[z]), 48,
                                         scheme="and_dc"))
            want = (c >= th[z]).astype(np.uint32)
            _eq(got[z], jpacking.pack_bits(jnp.asarray(want)))
            _eq(got_dc[z], 40 - want.sum(-1).astype(np.int32))
    z32 = torch.zeros((4, 2), dtype=torch.int32)
    with pytest.raises(TypeError, match="int32"):
        tops.rbmm_binary(z32, z32, 64, torch.zeros(4))
    with pytest.raises(ValueError, match="broadcast"):
        tops.rbmm_binary(z32, z32, 64, torch.zeros(5, dtype=torch.int32))
    with pytest.raises(ValueError, match="ceil"):
        tops.rbmm_binary(z32, z32, 100, torch.zeros(4, dtype=torch.int32))


# -- core.rbmm -------------------------------------------------------------------


@pytest.mark.parametrize("impl", ["popcount", "mxu", "dense", "auto"])
def test_core_rbmm_binary_matches_jax(impl):
    """Every pack_output x theta as (P,), a scalar, (M, P), float with
    negatives, +-inf and NaN, for a 2-D and a batched a; and an and_dc dc
    that disagrees with a (used by popcount, ignored by mxu/dense)."""
    rng = np.random.default_rng(7)
    m, k, p = 20, 100, 45
    a, b = _words(rng, (m, 4), k), _words(rng, (p, 4), k)
    fl = rng.uniform(-30, 30, (p,)).astype(np.float32)
    fl[:3] = (np.inf, -np.inf, np.nan)
    thetas = (rng.integers(-20, 20, (p,)).astype(np.int32), np.int32(-3),
              rng.integers(-20, 20, (m, p)).astype(np.int32), fl,
              np.float32(-2.5))
    dc = (rng.integers(0, k, (m,)) // 2).astype(np.int32)
    for theta in thetas:
        for pack in (False, True):
            for scheme, d in (("xnor", None), ("and_dc", None),
                              ("and_dc", dc)):
                for av in (a, a.reshape(4, 5, 4)):
                    dd = None if d is None else d.reshape(av.shape[:-1])
                    th = (theta.reshape(av.shape[:-1] + (p,))
                          if theta.ndim == 2 else theta)
                    got, got_dc = tcore.rbmm_binary(
                        _t(av), _t(b), k, _t(th), scheme=scheme,
                        dc=None if dd is None else _t(dd), impl=impl,
                        return_dc=True, pack_output=pack)
                    want, want_dc = jcore.rbmm_binary(
                        jnp.asarray(av), jnp.asarray(b), k,
                        jnp.asarray(th), scheme=scheme,
                        dc=None if dd is None else jnp.asarray(dd),
                        impl=impl, return_dc=True, pack_output=pack)
                    _eq(got, want)
                    _eq(got_dc, want_dc)
    got, none = tcore.rbmm_binary(_t(a), _t(b), k, 0.5)
    assert none is None and got.shape == (m, 2)


def test_rbmm_int_split_k_with_dc_matches_jax():
    rng = np.random.default_rng(9)
    a, b = _words(rng, (6, 4), 100), _words(rng, (7, 4), 100)
    dc = rng.integers(0, 100, (6,)).astype(np.int32)
    for scheme in ("xnor", "and_dc"):
        for splits in (1, 2, 4):
            _eq(tcore.rbmm_int_split_k(_t(a), _t(b), 100, splits,
                                       scheme=scheme, dc=_t(dc)),
                jcore.rbmm_int_split_k(jnp.asarray(a), jnp.asarray(b), 100,
                                       splits, scheme=scheme,
                                       dc=jnp.asarray(dc)))
    with pytest.raises(ValueError, match="divide"):
        tcore.rbmm_int_split_k(_t(a), _t(b), 100, 3)


def test_ffn_blocked_and_mode_wrappers_match_jax():
    rng = np.random.default_rng(11)
    d, r = 64, 4
    ff = 4 * d
    x = _words(rng, (2, 5, 2), d)                   # batched activations
    y = _words(rng, (ff, 2), d)
    z = _words(rng, (r, d, ff // r // 32), ff // r)
    theta1 = rng.integers(-8, 8, (ff,)).astype(np.int32)
    for impl in ("popcount", "mxu"):
        _eq(tcore.ffn_blocked(_t(x), _t(y), _t(z), d, _t(theta1), r,
                              impl=impl),
            jcore.ffn_blocked(jnp.asarray(x), jnp.asarray(y), jnp.asarray(z),
                              d, jnp.asarray(theta1), r, impl=impl))
    assert tcore.split_w2_for_blocked_ffn(_t(z)) is not None
    with pytest.raises(ValueError, match="divide"):
        tcore.ffn_blocked(_t(x), _t(y), _t(z), d, _t(theta1), 3)
    # the paper's modes: M1 Q/K/V, M2 scores, M3 context, M4, F1, F2
    a2, w = x[0], y[:70]
    th = rng.integers(-8, 8, (70,)).astype(np.int32)
    q, kk = _words(rng, (3, 6, 1), 20), _words(rng, (3, 6, 1), 20)
    mask = np.triu(np.ones((6, 6), bool), 1)
    lam = rng.integers(-3, 3, (3, 1, 1)).astype(np.int32)
    vt = _words(rng, (3, 20, 1), 6)
    j = lambda *xs: [jnp.asarray(v) for v in xs]
    t = lambda *xs: [_t(v) for v in xs]
    _eq(tcore.mode_m1_qkv(*t(a2, w), d, _t(th)),
        jcore.mode_m1_qkv(*j(a2, w), d, jnp.asarray(th)))
    tb, tdc = tcore.mode_m2_score(*t(q, kk), 20, _t(lam),
                                  mask=torch.from_numpy(mask))
    jb, jdc = jcore.mode_m2_score(*j(q, kk), 20, jnp.asarray(lam),
                                  mask=jnp.asarray(mask))
    _eq(tb, np.asarray(jb).astype(np.int32))
    _eq(tdc, jdc)
    probs = np.asarray(jpacking.pack_bits(jb))
    th3 = rng.integers(-3, 3, (20,)).astype(np.int32)
    _eq(tcore.mode_m3_context(_t(probs), _t(vt), 6, tdc, _t(th3)),
        jcore.mode_m3_context(jnp.asarray(probs), jnp.asarray(vt), 6, jdc,
                              jnp.asarray(th3)))
    _eq(tcore.mode_m4_linear(*t(a2, w), d), jcore.mode_m4_linear(*j(a2, w),
                                                                 d))
    (tb, tdc), (jb, jdc) = (tcore.mode_f1_ffn1(*t(a2, w), d, _t(th)),
                            jcore.mode_f1_ffn1(*j(a2, w), d,
                                               jnp.asarray(th)))
    _eq(tb, jb)
    _eq(tdc, jdc)
    w2 = _words(rng, (9, 3), 70)
    acc = rng.integers(-5, 5, (5, 9)).astype(np.int32)
    _eq(tcore.mode_f2_ffn2(tb, _t(w2), 70, tdc, acc=_t(acc)),
        jcore.mode_f2_ffn2(jb, jnp.asarray(w2), 70, jdc,
                           acc=jnp.asarray(acc)))


# -- layers ----------------------------------------------------------------------


def test_binary_dense_fused_faces_match_jax():
    """apply_deploy_fused and apply_deploy_fused_unsigned, packed bits and
    dc bitwise, with a bias, a fp threshold t > 0 and t <= 0 (the -(K+1)
    branch), relu on and off."""
    rng = np.random.default_rng(13)
    jd, td = JDense(100, 70, use_bias=True), TDense(100, 70, use_bias=True)
    qat = _perturb(_np(jax.jit(jd.init)(jax.random.PRNGKey(1))), rng)
    jp = _np(jax.jit(jd.convert)(qat))
    tp = bridge.from_jax_params(jp, device="cpu")
    x = _x(rng, 9, 100)
    for impl in ("auto", "popcount", "mxu"):
        nb = np.float32(0.3)
        (tb, tdc), (jb, jdc) = (
            td.apply_deploy_fused(tp, torch.from_numpy(x), torch.tensor(nb),
                                  impl=impl, return_dc=True),
            jd.apply_deploy_fused(jp, jnp.asarray(x), jnp.asarray(nb),
                                  impl=impl, return_dc=True))
        _eq(tb, jb)
        _eq(tdc, jdc)
        for h_beta, relu in ((0.2, True), (-1.0, True), (-1.0, False)):
            ha, hb = np.float32(0.8), np.float32(h_beta)
            (tb, tdc), (jb, jdc) = (
                td.apply_deploy_fused_unsigned(
                    tp, torch.from_numpy(x), torch.tensor(ha),
                    torch.tensor(hb), relu=relu, impl=impl),
                jd.apply_deploy_fused_unsigned(
                    jp, jnp.asarray(x), jnp.asarray(ha), jnp.asarray(hb),
                    relu=relu, impl=impl))
            _eq(tb, jb)
            _eq(tdc, jdc)


def test_relu_ffn_blocked_and_unblocked_match_jax():
    rng = np.random.default_rng(17)
    for blocked_r in (4, 0):
        jf = JFFN(128, 512, act="relu", glu=False, blocked_r=blocked_r)
        tf = TFFN(128, 512, act="relu", glu=False, blocked_r=blocked_r)
        qat = _perturb(_np(jax.jit(jf.init)(jax.random.PRNGKey(2))), rng)
        jp = _np(jax.jit(jf.convert)(qat))
        tp = bridge.from_jax_params(jp, device="cpu")
        assert "w3" not in tp and "w3" not in tf.init(
            torch.Generator().manual_seed(0), "cpu")
        for rows in (S, 1):
            x = _x(rng, rows)
            _close(tf.apply_deploy(tp, torch.from_numpy(x)),
                   jax.jit(jf.apply_deploy)(jp, jnp.asarray(x)))
    with pytest.raises(ValueError, match="fp x"):
        tf.apply_deploy(tp, bits=torch.zeros((2, 4), dtype=torch.int32))
    # the GELU GLU is ported (gemma3); a GELU without the GLU is not
    with pytest.raises(NotImplementedError, match="not ported"):
        TFFN(128, 512, act="gelu", glu=False)


def test_layernorm_and_dense_head_match_jax():
    rng = np.random.default_rng(19)
    x = (3 * rng.standard_normal((B, 5, 128)) + 1).astype(np.float32)
    ln_p = {"scale": rng.standard_normal(128).astype(np.float32),
            "bias": rng.standard_normal(128).astype(np.float32)}
    tln = tnn.make_norm("layernorm", 128)
    assert isinstance(tln, tnn.LayerNorm)
    assert isinstance(tnn.make_norm("rmsnorm", 128), tnn.RMSNorm)
    tp = {k: torch.from_numpy(v) for k, v in ln_p.items()}
    for dt in (np.float32, jnp.bfloat16):
        jx = jnp.asarray(x).astype(dt)
        tx = torch.from_numpy(x).to(torch.float32 if dt is np.float32
                                    else torch.bfloat16)
        got = tln.apply(tp, tx)
        assert got.dtype == tx.dtype
        _close(got, jnn.make_norm("layernorm", 128).apply(ln_p, jx))
    for use_bias in (False, True):
        jd = jnn.Dense(128, 96, use_bias=use_bias)
        p = _perturb(_np(jd.init(jax.random.PRNGKey(3))), rng)
        for dt in (np.float32, jnp.bfloat16):
            jy = jd.apply(p, jnp.asarray(x).astype(dt))
            ty = tnn.Dense(128, 96, use_bias=use_bias).apply(
                bridge.from_jax_params(p, device="cpu"),
                torch.from_numpy(x).to(torch.float32 if dt is np.float32
                                       else torch.bfloat16))
            assert str(ty.dtype).split(".")[-1] == str(jy.dtype)
            _close(ty, jy)


def test_bidirectional_attention_and_block_match_jax(smoke):
    jp, tp = _layer0(smoke)
    jblk, tblk = JBlock(smoke["jcfg"]), TBlock(smoke["tm"].cfg)
    jattn, tattn = jblk._parts()["attn"], tblk._attn()
    assert not tattn.causal and not tattn.use_rope
    x = _x(smoke["rng"], S)
    jout, _ = jax.jit(jattn.deploy_prefill)(jp["attn"], jnp.asarray(x))
    tout, cache = tattn.deploy_prefill(tp["attn"], torch.from_numpy(x))
    assert cache is None
    _close(tout, jout)
    jx, _ = jax.jit(jblk.deploy_prefill)(jp, jnp.asarray(x))
    tx, _ = tblk.deploy_prefill(tp, torch.from_numpy(x))
    _close(tx, jx)


def test_convert_through_the_bridge_matches_jax(smoke):
    """The port's convert of the bridged QAT tree (LayerNorm, untied head,
    ReLU FFN without w3) equals the bridged JAX deploy tree."""
    got = smoke["tm"].convert(smoke["tqat"])
    want = smoke["tdp"]
    flat_got = jax.tree_util.tree_leaves_with_path(got)
    flat_want = dict(jax.tree_util.tree_leaves_with_path(want))
    assert len(flat_got) == len(flat_want)
    for path, t in flat_got:
        assert torch.equal(t, flat_want[path]), path
    assert set(want) == {"embed", "final_norm", "head", "blocks"}
    assert set(want["final_norm"]) == {"scale", "bias"}
    assert "w3" not in want["blocks"][0]["ffn"]


def test_smoke_prefill_logits_matches_jax(smoke):
    toks = smoke["rng"].integers(0, 256, (B, S)).astype(np.int32)
    jl = jax.jit(smoke["jm"].prefill_logits)(smoke["dp"], jnp.asarray(toks))
    tl = smoke["tm"].prefill_logits(smoke["tdp"], torch.from_numpy(toks),
                                      device="cpu")
    assert tl.shape == (B, S, 256) and tl.dtype == torch.float32
    _close(tl, jl)
    np.testing.assert_array_equal(tl.argmax(-1).numpy(),
                                  np.asarray(jnp.argmax(jl, -1)))
