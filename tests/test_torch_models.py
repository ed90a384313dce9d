"""Port parity at model level, on ``get_smoke_config("smollm-135m")``
(2 layers, d=96, 3 heads over 1 KV head, d_h=32, float32): the JAX
package's params go through ``repro_torch.bridge`` and the same numpy
inputs through both packages.

Packed words, caches and integer outputs must be bitwise equal.  Float
outputs must agree within ATOL: the two frameworks sum RMSNorm, RoPE's
trigonometry and the tied head in different orders, which moves float32
results by a few ulps (about 1e-6 here), never the integer parts.
Shapes keep B*S > 16 at prefill (the mxu route) and B <= 16 at decode
(the popcount route), in both packages.

Every test draws its inputs from its own seeded rng, so no test's inputs
depend on which tests ran before it."""
import test_torch_threads  # noqa: F401  (first: one torch thread)
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.core import packing as jpacking
from repro.models.blocks import Block as JBlock
from repro.models.linear import BinaryDense as JDense
from repro.models.lm import build_model as jbuild
from repro.serve import engine as jengine
from repro_torch import bridge
from repro_torch.configs import base as tbase
from repro_torch.models.blocks import Block as TBlock
from repro_torch.models.linear import BinaryDense as TDense
from repro_torch.models.lm import build_model as tbuild
from repro_torch.serve import engine as tengine

ATOL = 1e-4
B, S, MAX_LEN = 2, 20, 32


def _perturb(tree, rng, name=""):
    """Move the scales and thresholds off their init values (1, 0) so the
    binarizations and the SPS threshold are non-trivial."""
    if isinstance(tree, dict):
        return {k: _perturb(v, rng, k) for k, v in tree.items()}
    a = np.array(tree)
    if name.endswith("_alpha") or name == "bit_alpha":
        return (a * rng.uniform(0.5, 1.5, a.shape)).astype(np.float32)
    if name.endswith("_beta"):
        return (a + 0.1 * rng.standard_normal(a.shape)).astype(np.float32)
    if name == "sps_lambda":
        return (a + 0.3 * rng.standard_normal(a.shape)).astype(np.float32)
    return a


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def _assert_cache_equal(jc, tc):
    np.testing.assert_array_equal(_u32(tc.k_bits), np.asarray(jc.k_bits))
    np.testing.assert_array_equal(_u32(tc.vt_bits), np.asarray(jc.vt_bits))
    np.testing.assert_array_equal(tc.length.numpy(),
                                  np.broadcast_to(np.asarray(jc.length),
                                                  tc.length.shape))


def _close(t: torch.Tensor, j) -> None:
    np.testing.assert_allclose(t.float().numpy(),
                               np.asarray(j, np.float32), atol=ATOL, rtol=0)


@pytest.fixture(scope="module")
def smoke():
    rng = np.random.default_rng(0)   # the params' perturbation only
    jcfg = jbase.get_smoke_config("smollm-135m")
    jm = jbuild(jcfg)
    qat = _perturb(_np(jax.jit(jm.init)(jax.random.PRNGKey(0))), rng)
    dp = _np(jax.jit(jm.convert)(qat))
    tm = tbuild(tbase.get_smoke_config("smollm-135m"))
    return dict(jcfg=jcfg, jm=jm, qat=qat, dp=dp, tm=tm,
                tdp=bridge.from_jax_params(dp, device="cpu"),
                tqat=bridge.from_jax_params(qat, device="cpu"))


def _layer0(smoke):
    jp = jax.tree.map(lambda t: t[0], smoke["dp"]["blocks"])
    return jp, smoke["tdp"]["blocks"][0]


def _x(rng, s, d=96):
    return rng.standard_normal((B, s, d)).astype(np.float32)


def test_convert_matches_jax(smoke):
    """The port's convert of the bridged QAT tree equals the bridged JAX
    convert, packed weights bitwise."""
    got = smoke["tm"].convert(smoke["tqat"])
    want = smoke["tdp"]
    flat_got = jax.tree_util.tree_leaves_with_path(got)
    flat_want = dict(jax.tree_util.tree_leaves_with_path(want))
    assert len(flat_got) == len(flat_want)
    for path, t in flat_got:
        assert torch.equal(t, flat_want[path]), path


@pytest.mark.parametrize("rows", [1, S])
def test_binary_dense_apply_deploy(smoke, rows):
    rng = np.random.default_rng(rows)
    jd = JDense(96, 70)
    qat = _perturb(_np(jax.jit(jd.init)(jax.random.PRNGKey(1))), rng)
    jp = _np(jax.jit(jd.convert)(qat))
    td = TDense(96, 70)
    tp = td.convert(bridge.from_jax_params(qat, device="cpu"))
    assert torch.equal(tp["w_packed"], bridge.from_jax_params(
        jp, device="cpu")["w_packed"])
    x = _x(rng, rows)
    for impl in ("auto", "popcount", "mxu"):
        _close(td.apply_deploy(tp, torch.from_numpy(x), impl=impl),
               jax.jit(functools.partial(jd.apply_deploy, impl=impl))(
                   jp, jnp.asarray(x)))


def test_attention_prefill_and_decode(smoke):
    jp, tp = _layer0(smoke)
    jattn = JBlock(smoke["jcfg"])._parts()["attn"]
    tattn = TBlock(smoke["tm"].cfg)._attn()
    rng = np.random.default_rng(10)
    x = _x(rng, S)
    jout, jcache = jax.jit(functools.partial(
        jattn.deploy_prefill, cache_size=MAX_LEN))(jp["attn"],
                                                   jnp.asarray(x))
    tout, tcache = tattn.deploy_prefill(tp["attn"], torch.from_numpy(x),
                                        cache_size=MAX_LEN)
    _close(tout, jout)
    _assert_cache_equal(jcache, tcache)
    jdec = jax.jit(jattn.deploy_decode)
    for _ in range(2):
        x1 = _x(rng, 1)
        jout, jcache = jdec(jp["attn"], jnp.asarray(x1), jcache)
        tout, tcache = tattn.deploy_decode(tp["attn"], torch.from_numpy(x1),
                                           tcache)
        _close(tout, jout)
        _assert_cache_equal(jcache, tcache)


def test_ffn_deploy_glu(smoke):
    jp, tp = _layer0(smoke)
    jffn = JBlock(smoke["jcfg"])._parts()["ffn"]
    tffn = TBlock(smoke["tm"].cfg)._ffn()
    rng = np.random.default_rng(11)
    for rows in (S, 1):
        x = _x(rng, rows)
        _close(tffn._deploy_glu(tp["ffn"], torch.from_numpy(x)),
               jax.jit(jffn._deploy_glu)(jp["ffn"], jnp.asarray(x)))
    # pre-packed bits in place of x, as the JAX face takes them
    bits = np.array(jpacking.pack_bits(jnp.asarray(
        (x >= np.asarray(jp["ffn"]["act_beta"])).astype(np.uint32))))
    _close(tffn.apply_deploy(tp["ffn"],
                             bits=torch.from_numpy(bits.view(np.int32))),
           jax.jit(jffn.apply_deploy)(jp["ffn"], bits=jnp.asarray(bits)))


def test_block_prefill_and_decode(smoke):
    jp, tp = _layer0(smoke)
    jblk, tblk = JBlock(smoke["jcfg"]), TBlock(smoke["tm"].cfg)
    rng = np.random.default_rng(12)
    x = _x(rng, S)
    jx, jcache = jax.jit(functools.partial(
        jblk.deploy_prefill, cache_size=MAX_LEN))(jp, jnp.asarray(x))
    tx, tcache = tblk.deploy_prefill(tp, torch.from_numpy(x),
                                     cache_size=MAX_LEN)
    _close(tx, jx)
    _assert_cache_equal(jcache["attn"], tcache["attn"])
    x1 = _x(rng, 1)
    jx, jcache = jax.jit(jblk.deploy_decode)(jp, jnp.asarray(x1), jcache)
    tx, tcache = tblk.deploy_decode(tp, torch.from_numpy(x1), tcache)
    _close(tx, jx)
    _assert_cache_equal(jcache["attn"], tcache["attn"])


# The tokens on which jitted and op-by-op JAX disagree in bfloat16: XLA's
# excess precision (``xla_allow_excess_precision``, on by default) lets
# layer 1's RMSNorm read the residual sum of layer 0 before its rounding to
# bfloat16, and one K value of layer 1 (row 1, position 4, head index 21)
# then lands on the other side of ``k_beta``: one bit of one K-cache word.
# The port rounds where the program says, as op-by-op JAX does.
PINNED_BF16_TOKENS = [
    [12, 93, 162, 27, 130, 161, 195, 237, 104, 112, 121, 244, 50, 127, 12,
     108, 242, 158, 89, 254],
    [154, 242, 4, 117, 213, 193, 104, 127, 107, 135, 58, 201, 19, 106, 72,
     188, 191, 182, 236, 238]]


@pytest.mark.parametrize("dtype,tokens", [
    ("float32", 13), ("bfloat16", 14), ("bfloat16", PINNED_BF16_TOKENS)],
    ids=["float32", "bfloat16", "bfloat16-pinned-draw"])
def test_lm_prefill_then_decode_steps(smoke, dtype, tokens):
    """Prefill then greedy decode steps, in the smoke config's float32 and
    in the main path's bfloat16 compute dtype (same params).  ``tokens`` is
    a seed for the draw or the draw itself.  float32 is held to jitted JAX;
    bfloat16 to op-by-op JAX, which rounds every bfloat16 result as the
    program states (jitted JAX may keep a float32 intermediate unrounded,
    see ``PINNED_BF16_TOKENS``)."""
    jm = jbuild(smoke["jcfg"].with_(compute_dtype=dtype))
    tm = tbuild(smoke["tm"].cfg.with_(compute_dtype=dtype))
    dp, tdp = smoke["dp"], smoke["tdp"]
    toks = (np.asarray(tokens) if isinstance(tokens, list) else
            np.random.default_rng(tokens).integers(0, 256, (B, S))
            ).astype(np.int32)
    if dtype == "float32":
        jprefill = jax.jit(functools.partial(jm.prefill_with_cache,
                                             max_len=MAX_LEN))
        jdec = jax.jit(jm.decode_step)
    else:
        def eager(fn):
            def run(*args):
                with jax.disable_jit():
                    return fn(*args)
            return run
        jprefill = eager(functools.partial(jm.prefill_with_cache,
                                           max_len=MAX_LEN))
        jdec = eager(jm.decode_step)
    jl, jc = jprefill(dp, jnp.asarray(toks))
    tl, tc = tm.prefill_with_cache(tdp, torch.from_numpy(toks),
                                   max_len=MAX_LEN)
    _close(tl, jl)
    for step in range(3):
        for j, t in zip(jc, tc):
            _assert_cache_equal(j["attn"], t["attn"])
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        np.testing.assert_array_equal(tl.argmax(-1).numpy(), tok,
                                      err_msg=f"step {step}")
        jl, jc = jdec(dp, jnp.asarray(tok), jc)
        tl, tc = tm.decode_step(tdp, torch.from_numpy(tok), tc)
        _close(tl, jl)


def test_decode_from_empty_caches(smoke):
    """init_caches + decode_step from position 0 (no prefill)."""
    jm, tm, dp, tdp = smoke["jm"], smoke["tm"], smoke["dp"], smoke["tdp"]
    jc = jm.init_caches(B, 8)
    tc = tm.init_caches(B, 8, "cpu")
    for j, t in zip(jc, tc):
        _assert_cache_equal(j["attn"], t["attn"])
    jdec = jax.jit(jm.decode_step)
    rng = np.random.default_rng(15)
    for tok in rng.integers(0, 256, (3, B, 1)).astype(np.int32):
        jl, jc = jdec(dp, jnp.asarray(tok), jc)
        tl, tc = tm.decode_step(tdp, torch.from_numpy(tok), tc)
        _close(tl, jl)
    for j, t in zip(jc, tc):
        _assert_cache_equal(j["attn"], t["attn"])


class _JitPrefill:
    """The JAX model with its prefill under jit (the engine calls it
    eagerly, which is slow at op-by-op dispatch); all else delegates."""

    def __init__(self, model):
        self._model = model
        self._prefill = jax.jit(model.prefill_with_cache,
                                static_argnames=("max_len",))

    def prefill_with_cache(self, dparams, tokens, *, max_len):
        return self._prefill(dparams, tokens, max_len=max_len)

    def __getattr__(self, name):
        return getattr(self._model, name)


def test_engine_generate_greedy_tokens_equal(smoke):
    toks = np.random.default_rng(16).integers(0, 256, (B, S)).astype(
        np.int32)
    jeng = jengine.ServeEngine(
        _JitPrefill(smoke["jm"]), jax.tree.map(jnp.asarray, smoke["dp"]),
        jengine.ServeConfig(cache=jengine.CacheConfig(max_len=MAX_LEN)))
    teng = tengine.ServeEngine(
        smoke["tm"], smoke["tdp"],
        tengine.ServeConfig(cache=tengine.CacheConfig(max_len=MAX_LEN)),
        device="cpu")
    jt, jrep = jeng.generate(toks, max_new_tokens=6)
    seen = []
    tt, trep = teng.generate(toks, max_new_tokens=6,
                             stream_cb=lambda i, t: seen.append(i))
    assert tt.dtype == np.int32 and tt.shape == (B, 6)
    np.testing.assert_array_equal(tt, jt)
    assert seen == list(range(6))
    for key in trep.keys():
        assert trep[key] == pytest.approx(jrep[key]), key
