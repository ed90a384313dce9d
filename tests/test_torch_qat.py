"""The QAT primitives of the port against the JAX package on the CPU: the
straight-through estimators (forward and backward, at 0, +-1, exact .5
ties and the clip's bounds), the helpers of ``core/binarize.py``,
``core/sps.py`` (``sps_ste``'s lambda gradient for every granularity, the
threshold search and calibration, the integer threshold), ``rbmm_sim``
and ``BinaryDense.apply`` with its gradients in float32 and bfloat16, and
the port's own QAT == deploy invariant for ``BinaryDense``.

Inputs and cotangents come from numpy seeds.  Hard values (signs, bits,
thresholds, lambda*) are held bitwise; float values within the stated
tolerances: float32 sums within 1e-6 relative (the order of a reduction
differs between XLA and PyTorch), bfloat16 outputs and gradients within
one bfloat16 rounding (rtol 2^-7)."""
import test_torch_threads  # noqa: F401  (first: one torch thread)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import binarize as jbin, rbmm as jrbmm, sps as jsps
from repro.models.linear import BinaryDense as JDense
from repro_torch import bridge
from repro_torch.core import binarize as tbin, rbmm as trbmm, sps as tsps
from repro_torch.models.linear import BinaryDense as TDense

F32_RTOL = 1e-6
BF16_RTOL = 2.0 ** -7
TIES = np.array([-2.0, -1.5, -1.0, -0.5, 0.0, 0.5, 1.0, 1.5, 2.5, 1e-7,
                 -1e-7, 0.999, 1.001], np.float32)


def _vjp_jax(f, args, ct):
    out, pull = jax.vjp(f, *[jnp.asarray(a) for a in args])
    return np.asarray(out, np.float32), [np.asarray(g, np.float32)
                                         for g in pull(jnp.asarray(ct))]


def _vjp_torch(f, args, ct, dtype=torch.float32):
    ins = [torch.tensor(np.asarray(a, np.float32)).to(dtype)
           .requires_grad_(True) for a in args]
    out = f(*ins)
    grads = torch.autograd.grad(out, ins, torch.tensor(
        np.asarray(ct, np.float32)).to(out.dtype), allow_unused=True)
    return out.detach().float().numpy(), [
        None if g is None else g.float().numpy() for g in grads]


def _x(seed, shape, scale=1.5):
    rng = np.random.default_rng(seed)
    x = (scale * rng.standard_normal(shape)).astype(np.float32)
    flat = x.reshape(-1)
    flat[:len(TIES)] = TIES
    return x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sign_ste_forward_and_backward_match_jax(dtype):
    """sign(0) = +1 (torch.sign gives 0) and the gradient passes where
    |x| <= 1, both bounds included."""
    x = _x(0, (7, 9))
    ct = np.random.default_rng(1).standard_normal(x.shape).astype(np.float32)
    jdt = jnp.dtype(dtype)
    out_j, (g_j,) = _vjp_jax(jbin.sign_ste, [jnp.asarray(x, jdt)],
                             jnp.asarray(ct, jdt))
    out_t, (g_t,) = _vjp_torch(tbin.sign_ste, [x], ct, getattr(torch, dtype))
    np.testing.assert_array_equal(out_t, out_j)
    np.testing.assert_array_equal(g_t, g_j)
    assert out_t.reshape(-1)[TIES.tolist().index(0.0)] == 1.0


def test_round_ste_and_clip_match_jax():
    """Round half up (floor(x + 0.5): -1.5 -> -1, 0.5 -> 1, 2.5 -> 3, where
    torch.round gives -2, 0, 2), identity gradient; jnp.clip's gradient is
    1/2 at a bound it hits, which the unsigned scheme hits at every
    clipped rounded value."""
    x = _x(2, (6, 11), scale=2.0)
    ct = np.random.default_rng(3).standard_normal(x.shape).astype(np.float32)
    out_j, (g_j,) = _vjp_jax(jbin.round_ste, [x], ct)
    out_t, (g_t,) = _vjp_torch(tbin.round_ste, [x], ct)
    np.testing.assert_array_equal(out_t, out_j)
    np.testing.assert_array_equal(g_t, g_j)
    assert out_t.reshape(-1)[:9].tolist() == [-2, -1, -1, 0, 0, 1, 1, 2, 3]
    r = np.floor(x + 0.5)
    out_j, (g_j,) = _vjp_jax(lambda v: jnp.clip(v, 0.0, 1.0), [r], ct)
    out_t, (g_t,) = _vjp_torch(lambda v: tbin.clip(v, 0.0, 1.0), [r], ct)
    np.testing.assert_array_equal(out_t, out_j)
    np.testing.assert_array_equal(g_t, g_j)
    assert set(np.unique(np.abs(g_t / np.where(ct == 0, 1, ct)))) <= \
        {0.0, 0.5}


def test_elastic_binarizers_and_bits_match_jax():
    x = _x(4, (5, 16))
    rng = np.random.default_rng(5)
    ct = rng.standard_normal(x.shape).astype(np.float32)
    alpha = np.float32(0.7)
    beta = np.float32(0.15)
    for jf, tf in ((jbin.binarize_act_signed, tbin.binarize_act_signed),
                   (jbin.binarize_act_unsigned, tbin.binarize_act_unsigned)):
        out_j, g_j = _vjp_jax(jf, [x, alpha, beta], ct)
        out_t, g_t = _vjp_torch(tf, [x, alpha, beta], ct)
        np.testing.assert_array_equal(out_t, out_j)
        np.testing.assert_array_equal(g_t[0], g_j[0])
        for a, b in zip(g_t[1:], g_j[1:]):
            np.testing.assert_allclose(a, b, rtol=F32_RTOL, atol=1e-6)
    w = rng.standard_normal((16, 8)).astype(np.float32)
    wb_j, a_j = jbin.binarize_weight(jnp.asarray(w))
    wb_t, a_t = tbin.binarize_weight(torch.from_numpy(w))
    np.testing.assert_array_equal(wb_t.numpy(), np.asarray(wb_j))
    np.testing.assert_allclose(a_t.numpy(), np.asarray(a_j), rtol=F32_RTOL)
    xt = torch.from_numpy(x)
    np.testing.assert_array_equal(
        tbin.bits_signed(xt, 1.0, torch.tensor(beta)).numpy(),
        np.asarray(jbin.bits_signed(jnp.asarray(x), 1.0, beta)))
    for a, b in ((alpha, beta), (0.0, -0.25), (1.0, 0.0)):
        np.testing.assert_array_equal(
            tbin.bits_unsigned(xt, a, b).numpy(),
            np.asarray(jbin.bits_unsigned(jnp.asarray(x), a, b)))


def test_fused_integer_and_apply_thresholds_match_jax():
    """Eq. 10's thresholds (``jnp.round`` and ``torch.round`` both round
    half to even, so the .5 cases agree), the integer SPS threshold, and
    the compare."""
    rng = np.random.default_rng(6)
    alpha = np.array([1.0, 3.0, 0.5, 2.0, 1.0], np.float32)
    beta = np.array([0.25, -1.5, 0.25, 0.0, -3.0], np.float32)
    for scheme, relu in (("signed", False), ("unsigned", False),
                         ("unsigned", True)):
        want = np.asarray(jbin.fused_threshold(jnp.asarray(alpha),
                                               jnp.asarray(beta), scheme,
                                               relu))
        got = tbin.fused_threshold(torch.from_numpy(alpha),
                                   torch.from_numpy(beta), scheme, relu)
        np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="scheme"):
        tbin.fused_threshold(torch.ones(1), torch.ones(1), "ternary")
    c = rng.integers(-40, 40, (6, 5)).astype(np.int32)
    theta = rng.integers(-10, 10, (5,)).astype(np.float32)
    np.testing.assert_array_equal(
        tbin.apply_threshold(torch.from_numpy(c),
                             torch.from_numpy(theta)).numpy(),
        np.asarray(jbin.apply_threshold(jnp.asarray(c), jnp.asarray(theta))))
    lam = rng.uniform(-0.5, 1.0, (3, 7)).astype(np.float32)
    aq = rng.uniform(0.1, 2.0, (3, 1)).astype(np.float32)
    ak = rng.uniform(0.1, 2.0, (3, 1)).astype(np.float32)
    np.testing.assert_array_equal(
        tsps.integer_threshold(*map(torch.from_numpy, (lam,)), 64,
                               torch.from_numpy(aq),
                               torch.from_numpy(ak)).numpy(),
        np.asarray(jsps.integer_threshold(jnp.asarray(lam), 64,
                                          jnp.asarray(aq), jnp.asarray(ak))))


def _lam(granularity, h, length, rng):
    shape = {"layer": (), "head": (h,), "row": (h, length)}[granularity]
    return rng.uniform(-0.3, 0.6, shape).astype(np.float32)


def _bcast(granularity, lam):
    if granularity == "layer":
        return lam
    if granularity == "head":
        return lam[:, None, None]
    return lam[:, :, None]


@pytest.mark.parametrize("granularity", ["layer", "head", "row"])
def test_sps_ste_lambda_gradient_matches_jax(granularity):
    """The hard step forward; the window's gradient to z, and -g summed
    to lambda's own shape through the broadcast (a custom Function must
    reduce it itself)."""
    rng = np.random.default_rng(7)
    b, h, length = 2, 3, 10
    z = rng.standard_normal((b, h, length, length)).astype(np.float32)
    lam = _lam(granularity, h, length, rng)
    ct = rng.standard_normal(z.shape).astype(np.float32)
    out_j, (gz_j, gl_j) = _vjp_jax(
        lambda zz, ll: jsps.sps_ste(zz, _bcast(granularity, ll)), [z, lam],
        ct)
    out_t, (gz_t, gl_t) = _vjp_torch(
        lambda zz, ll: tsps.sps_ste(zz, _bcast(granularity, ll)), [z, lam],
        ct)
    np.testing.assert_array_equal(out_t, out_j)
    np.testing.assert_array_equal(gz_t, gz_j)
    assert gl_t.shape == lam.shape and np.abs(gl_t).sum() > 0
    np.testing.assert_allclose(gl_t, gl_j, rtol=F32_RTOL, atol=1e-5)
    np.testing.assert_array_equal(
        tsps.sps(torch.from_numpy(z), torch.from_numpy(
            _bcast(granularity, lam))).numpy(),
        np.asarray(jsps.sps(jnp.asarray(z), _bcast(granularity, lam))))


@pytest.mark.parametrize("granularity", ["layer", "head", "row"])
def test_threshold_search_and_calibration_match_jax(granularity):
    """The BiT target, the grid (21 float32 values), lambda* (equal: a CDR
    is a count of {0,1} differences over a fixed N, exact in any sum
    order) and CDR*, with a causal mask; the calibration's broadcast."""
    rng = np.random.default_rng(8)
    b, h, length = 2, 3, 12
    z = (0.6 * rng.standard_normal((b, h, length, length))).astype(
        np.float32)
    mask = np.triu(np.ones((length, length), bool), 1)
    np.testing.assert_array_equal(tsps.DEFAULT_GRID.numpy(),
                                  np.asarray(jsps.DEFAULT_GRID))
    target_j = jsps.att_prob_bit(jnp.asarray(z), 0.2, jnp.asarray(mask))
    target_t = tsps.att_prob_bit(torch.from_numpy(z), 0.2,
                                 torch.from_numpy(mask))
    np.testing.assert_array_equal(target_t.numpy(), np.asarray(target_j))
    lam_j, cdr_j = jsps.search_thresholds(
        jnp.asarray(z), target_j, granularity=granularity,
        mask=jnp.asarray(mask))
    lam_t, cdr_t = tsps.search_thresholds(
        torch.from_numpy(z), target_t, granularity=granularity,
        mask=torch.from_numpy(mask))
    np.testing.assert_array_equal(lam_t.numpy(), np.asarray(lam_j))
    np.testing.assert_allclose(cdr_t.numpy(), np.asarray(cdr_j),
                               rtol=F32_RTOL)
    cal_j = jsps.calibrate_layer(jnp.asarray(z), bit_alpha=0.2,
                                 granularity=granularity,
                                 mask=jnp.asarray(mask))
    cal_t = tsps.calibrate_layer(torch.from_numpy(z), bit_alpha=0.2,
                                 granularity=granularity,
                                 mask=torch.from_numpy(mask))
    np.testing.assert_array_equal(cal_t.lam.numpy(), np.asarray(cal_j.lam))
    np.testing.assert_array_equal(cal_t.lam_broadcast().numpy(),
                                  np.asarray(cal_j.lam_broadcast()))
    assert cal_t.granularity == granularity


def test_cdr_and_similarity_report_match_jax():
    rng = np.random.default_rng(9)
    a = rng.integers(0, 2, (2, 3, 8, 8)).astype(np.float32)
    b = rng.integers(0, 2, (2, 3, 8, 8)).astype(np.float32)
    for axes in ((0, 1, 2, 3), (0, 2, 3), (0, 3)):
        np.testing.assert_allclose(
            tsps.cdr(torch.from_numpy(a), torch.from_numpy(b), axes).numpy(),
            np.asarray(jsps.cdr(jnp.asarray(a), jnp.asarray(b), axes)),
            rtol=F32_RTOL)
    got = tsps.similarity_report(torch.from_numpy(a), torch.from_numpy(b))
    want = jsps.similarity_report(jnp.asarray(a), jnp.asarray(b))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-5, abs=1e-6), k


def test_rbmm_sim_matches_jax():
    rng = np.random.default_rng(10)
    a = (2 * rng.integers(0, 2, (2, 5, 70)) - 1).astype(np.float32)
    u = rng.integers(0, 2, (2, 5, 70)).astype(np.float32)
    w = (2 * rng.integers(0, 2, (2, 9, 70)) - 1).astype(np.float32)
    for lhs in (a, u):
        got = trbmm.rbmm_sim(torch.from_numpy(lhs), torch.from_numpy(w))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jrbmm.rbmm_sim(jnp.asarray(lhs),
                                                   jnp.asarray(w))))


def _dense_params(layer, seed):
    """The JAX layer's init with its scales moved off their init values."""
    rng = np.random.default_rng(seed)
    p = jax.tree.map(np.asarray, layer.init(jax.random.PRNGKey(seed)))
    p["alpha_w"] = rng.uniform(0.2, 2.0, (layer.out_dim,)).astype(
        np.float32)
    if not layer.external_act:
        p["act_alpha"] = np.float32(rng.uniform(0.3, 1.5))
        p["act_beta"] = np.float32(rng.normal() * 0.1)
    if layer.use_bias:
        p["bias"] = rng.normal(size=(layer.out_dim,)).astype(np.float32)
    return p


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_binary_dense_apply_and_gradients_match_jax(dtype):
    """``apply`` with its own binarization (and a bias) and with external
    +-1 values, output and every gradient against ``jax.vjp`` of op-by-op
    JAX.  The +-1 product is float32 on both sides, so it is exact; in
    bfloat16 the output and the gradients of the bfloat16-rounded
    operands round once more."""
    rng = np.random.default_rng(11)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    rtol = F32_RTOL if dtype == "float32" else BF16_RTOL
    x = rng.standard_normal((3, 5, 64)).astype(np.float32)
    for ext in (False, True):
        jl = JDense(64, 48, use_bias=not ext, external_act=ext, dtype=jdt)
        tl = TDense(64, 48, use_bias=not ext, external_act=ext, dtype=tdt)
        p = _dense_params(jl, 12 + ext)
        keys = sorted(p)
        ct = rng.standard_normal((3, 5, 48)).astype(np.float32)
        xin = np.sign(x) + (x == 0) if ext else x

        def jf(xx, *vals):
            pp = dict(zip(keys, vals))
            if ext:
                return jl.apply(pp, act_values=xx, act_scale=0.75)
            return jl.apply(pp, xx)

        def tf(xx, *vals):
            pp = dict(zip(keys, vals))
            if ext:
                return tl.apply(pp, act_values=xx, act_scale=0.75)
            return tl.apply(pp, xx)

        out_j, g_j = _vjp_jax(jf, [jnp.asarray(xin, jdt)] +
                              [p[k] for k in keys], jnp.asarray(ct, jdt))
        ins = [torch.tensor(xin).to(tdt).requires_grad_(True)] + [
            torch.tensor(np.asarray(p[k])).requires_grad_(True)
            for k in keys]
        out = tf(*ins)
        assert out.dtype == tdt
        g_t = torch.autograd.grad(out, ins, torch.tensor(ct).to(tdt))
        np.testing.assert_allclose(out.detach().float().numpy(), out_j,
                                   rtol=rtol, atol=1e-5)
        for name, a, b in zip(["x"] + keys, g_t, g_j):
            np.testing.assert_allclose(a.float().numpy(), b, rtol=rtol,
                                       atol=1e-4 if dtype == "bfloat16"
                                       else 1e-5, err_msg=name)


def test_binary_dense_apply_equals_apply_deploy():
    """The port's QAT face against its packed deploy face (JAX's
    ``tests/test_linear.py`` invariant): the integer part is the same
    RBMM, so outputs agree to 1e-4."""
    for seed, (m, k, p_out, bias) in enumerate(
            [(1, 32, 8, False), (4, 64, 16, True), (6, 96, 8, True),
             (3, 100, 24, False)]):
        jl = JDense(k, p_out, use_bias=bias)
        tl = TDense(k, p_out, use_bias=bias)
        params = bridge.from_jax_params(_dense_params(jl, seed),
                                        device="cpu")
        x = torch.from_numpy(np.random.default_rng(seed).normal(
            size=(m, k)).astype(np.float32))
        with torch.no_grad():
            y_qat = tl.apply(params, x)
            y_dep = tl.apply_deploy(tl.convert(params), x)
        np.testing.assert_allclose(y_qat.numpy(), y_dep.numpy(), rtol=0,
                                   atol=1e-4)
