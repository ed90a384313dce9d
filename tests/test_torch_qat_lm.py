"""The QAT faces of the dense family in the port against the JAX package
on the CPU, float32: ``SPSAttention.qat`` (SPS and the BiT softmax
teacher; layer, head and row thresholds; a causal window, a key length,
bidirectional, GQA, RoPE, S = 20, not a multiple of 32 or of JAX's query
chunk), ``BinaryFFN.apply`` (SiLU GLU, GELU GLU, ReLU), ``Block.qat``,
``LMModel.qat_logits`` on the smollm, gemma (5:1 local:global windows),
bert (bidirectional, LayerNorm, ReLU, untied head) and internvl2
(frontend stub) smoke configs, and ``train_loss`` with every leaf's
gradient against ``jax.value_and_grad``; then the port's own invariants:
remat on == off bitwise, QAT logits == deploy logits within JAX's 2e-3.

Params are the JAX package's init with scales, betas and lambdas moved
off their init values, bridged through numpy; inputs and cotangents come
from numpy seeds.  Hard decisions (signs, SPS bits) must agree, so values
agree to float32 rounding: outputs within 1e-5 absolute (1e-4 for
logits), gradients within 2e-4 of each leaf's largest |gradient| (sums
of many terms in another order, through sign-STE windows)."""
import test_torch_threads  # noqa: F401  (first: one torch thread)
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.models.attention import SPSAttention as JAttn
from repro.models.blocks import Block as JBlock
from repro.models.ffn import BinaryFFN as JFFN
from repro.models.lm import build_model as jbuild
from repro_torch import bridge, tree
from repro_torch.configs import base as tbase
from repro_torch.models.attention import SPSAttention as TAttn
from repro_torch.models.blocks import Block as TBlock
from repro_torch.models.ffn import BinaryFFN as TFFN
from repro_torch.models.lm import build_model as tbuild

OUT_ATOL, LOGIT_ATOL, GRAD_REL = 1e-5, 1e-4, 2e-4


def _perturb(t, rng, name=""):
    if isinstance(t, dict):
        return {k: _perturb(v, rng, k) for k, v in t.items()}
    a = np.array(t)
    if name.endswith("_alpha") or name == "alpha_w":
        return (a * rng.uniform(0.5, 1.5, a.shape)).astype(np.float32)
    if name.endswith("_beta") or name == "bias":
        return (a + 0.1 * rng.standard_normal(a.shape)).astype(np.float32)
    if name == "sps_lambda":
        return (a + 0.3 * rng.standard_normal(a.shape)).astype(np.float32)
    return a


def _params(module, seed):
    return _perturb(jax.tree.map(np.asarray, module.init(
        jax.random.PRNGKey(seed))), np.random.default_rng(seed))


def _close_grads(got, want, what=""):
    """Leaf by leaf (port tree, JAX numpy tree bridged), within GRAD_REL of
    the leaf's largest |gradient|."""
    want = bridge.from_jax_params(want, device="cpu")
    pairs = list(zip(tree.leaves_with_paths(got), tree.leaves(want)))
    assert len(pairs) == len(tree.leaves(want))
    for (name, g), w in pairs:
        scale = float(w.abs().max())
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                   atol=GRAD_REL * scale + 1e-7,
                                   err_msg=f"{what} {name}")


def _jax_vjp(fn, params, x, ct):
    """(out, grads of params, grad of x) of fn(params, x) . ct, jitted
    (the sliced-window path's lax.map runs slowly op by op)."""
    def run(p, xx, c):
        out, pull = jax.vjp(fn, p, xx)
        return (out,) + pull(c)

    out, gp, gx = jax.jit(run)(jax.tree.map(jnp.asarray, params),
                               jnp.asarray(x), jnp.asarray(ct))
    return np.asarray(out), jax.tree.map(np.asarray, gp), np.asarray(gx)


def _torch_vjp(fn, params, x, ct):
    """(out, grads of params (tree), grad of x) of fn(params, x) . ct."""
    leaves = [torch.tensor(np.asarray(v)).requires_grad_(True)
              for v in tree.leaves(params)]
    xt = torch.tensor(x).requires_grad_(True)
    out = fn(tree.unflatten(params, leaves), xt)
    grads = torch.autograd.grad(out, leaves + [xt], torch.tensor(ct),
                                allow_unused=True)
    grads = [torch.zeros_like(v) if g is None else g
             for g, v in zip(grads, leaves + [xt])]
    return out.detach(), tree.unflatten(params, grads[:-1]), grads[-1]


ATTN_CASES = {
    # name: (granularity, attn_mode, causal, window, kv_len)
    "sps-head-window-gqa": ("head", "sps", True, 5, None),
    "sps-layer-kvlen": ("layer", "sps", True, None, 15),
    "sps-row": ("row", "sps", True, None, None),
    "bit_softmax-head": ("head", "bit_softmax", True, None, None),
    "sps-head-bidirectional": ("head", "sps", False, None, None),
}


@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_attention_qat_and_gradients_match_jax(case):
    """Output, every param's and the input's gradient; JAX runs its query
    chunks of 8 (and, for the window, its sliced-window path), the port
    one dense masked score matrix."""
    gran, mode, causal, window, kv_len = ATTN_CASES[case]
    kw = dict(d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
              causal=causal, sps_granularity=gran, attn_mode=mode)
    ja = JAttn(**kw, q_chunk=8)
    ta = TAttn(**kw)
    params = _params(ja, 3)
    rng = np.random.default_rng(4)
    b, s = 2, 20
    x = rng.standard_normal((b, s, 64)).astype(np.float32)
    ct = rng.standard_normal((b, s, 64)).astype(np.float32)
    collect = mode == "bit_softmax"

    out_j, gp_j, gx_j = _jax_vjp(
        lambda p, xx: ja.qat(p, xx, window=window, kv_len=kv_len)[0],
        params, x, ct)
    out_t, gp_t, gx_t = _torch_vjp(
        lambda p, xx: ta.qat(p, xx, window=window, kv_len=kv_len)[0],
        params, x, ct)
    np.testing.assert_allclose(out_t.numpy(), out_j, rtol=0, atol=OUT_ATOL)
    _close_grads(gp_t, gp_j, case)
    np.testing.assert_allclose(gx_t.numpy(), np.asarray(gx_j), rtol=0,
                               atol=GRAD_REL * float(np.abs(gx_j).max()))
    if collect:
        _, aux_j = ja.qat(jax.tree.map(jnp.asarray, params),
                          jnp.asarray(x), collect_scores=True)
        with torch.no_grad():
            _, aux_t = ta.qat(bridge.from_jax_params(params, device="cpu"),
                              torch.from_numpy(x), collect_scores=True)
        np.testing.assert_allclose(aux_t["scores"].numpy(),
                                   np.asarray(aux_j["scores"]), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_array_equal(aux_t["probs"].numpy(),
                                      np.asarray(aux_j["probs"]))


@pytest.mark.parametrize("act,glu", [("silu", True), ("gelu", True),
                                     ("relu", False)])
def test_ffn_apply_and_gradients_match_jax(act, glu):
    jf = JFFN(64, 96, act=act, glu=glu)
    tf = TFFN(64, 96, act=act, glu=glu)
    params = _params(jf, 5)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 7, 64)).astype(np.float32)
    ct = rng.standard_normal((2, 7, 64)).astype(np.float32)
    out_j, gp_j, gx_j = _jax_vjp(jf.apply, params, x, ct)
    out_t, gp_t, gx_t = _torch_vjp(tf.apply, params, x, ct)
    np.testing.assert_allclose(out_t.numpy(), out_j, rtol=0, atol=OUT_ATOL)
    _close_grads(gp_t, gp_j, act)
    np.testing.assert_allclose(gx_t.numpy(), np.asarray(gx_j), rtol=0,
                               atol=GRAD_REL * float(np.abs(gx_j).max()))


def test_block_qat_and_gradients_match_jax():
    """gemma's smoke block: RMSNorm, windowed GQA attention (the block's
    own window), the GELU GLU."""
    jcfg = jbase.get_smoke_config("gemma3-27b")
    window = jcfg.window_size
    jb = JBlock(jcfg, kind="attn", window=window)
    tb = TBlock(tbase.get_smoke_config("gemma3-27b"), kind="attn",
                window=window)
    params = _params(jb, 7)
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 20, jcfg.d_model)).astype(np.float32)
    ct = rng.standard_normal(x.shape).astype(np.float32)
    out_j, gp_j, gx_j = _jax_vjp(lambda p, xx: jb.qat(p, xx)[0], params,
                                 x, ct)
    out_t, gp_t, gx_t = _torch_vjp(lambda p, xx: tb.qat(p, xx)[0], params,
                                   x, ct)
    np.testing.assert_allclose(out_t.numpy(), out_j, rtol=0, atol=OUT_ATOL)
    _close_grads(gp_t, gp_j, "block")
    np.testing.assert_allclose(gx_t.numpy(), np.asarray(gx_j), rtol=0,
                               atol=GRAD_REL * float(np.abs(gx_j).max()))


@functools.lru_cache(maxsize=None)
def _model(arch, seed=0):
    jm = jbuild(jbase.get_smoke_config(arch))
    params = _params(jm, seed)
    return dict(jm=jm, jp=jax.tree.map(jnp.asarray, params), np=params,
                tm=tbuild(tbase.get_smoke_config(arch)),
                tp=bridge.from_jax_params(params, device="cpu"))


def _tokens(arch, seed, b=2, s=20):
    cfg = tbase.get_smoke_config(arch)
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    kw = {}
    if cfg.frontend_tokens:
        kw["frontend_embeds"] = rng.standard_normal(
            (b, cfg.frontend_tokens, min(cfg.d_model, 1024)),
            dtype=np.float32)
    return toks, kw


@pytest.mark.parametrize("arch", ["smollm-135m", "gemma3-27b",
                                  "bert-base-cobra", "internvl2-76b"])
def test_qat_logits_match_jax(arch):
    m = _model(arch)
    toks, kw = _tokens(arch, 9)
    want = jax.jit(m["jm"].qat_logits)(m["jp"], jnp.asarray(toks),
                                        **{k: jnp.asarray(v)
                                           for k, v in kw.items()})
    with torch.no_grad():
        got = m["tm"].qat_logits(m["tp"], torch.from_numpy(toks), **kw)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=LOGIT_ATOL)


def _batch(arch, seed):
    toks, kw = _tokens(arch, seed, b=4, s=16)
    labels = np.concatenate([toks[:, 1:], np.full((4, 1), -1, np.int32)],
                            axis=1)
    labels[0, :3] = -1                      # ignored labels inside a row
    return dict(tokens=toks, labels=labels, **kw)


def _port_loss_and_grads(model, params, batch):
    leaves = [p.detach().clone().requires_grad_(True)
              for p in tree.leaves(params)]
    loss, metrics = model.train_loss(tree.unflatten(params, leaves),
                                     {k: torch.from_numpy(v)
                                      for k, v in batch.items()})
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for g, p in zip(grads, leaves)]
    return loss.detach(), metrics, tree.unflatten(params, grads)


def test_train_loss_and_every_gradient_match_jax():
    """smollm's smoke config (float32, tied head, z-loss over valid
    labels, ignored labels inside a row): the loss, its metrics and the
    gradient of every leaf (``bit_alpha``, unread in SPS mode, gets
    zeros on both sides) against ``jax.value_and_grad``."""
    m = _model("smollm-135m")
    batch = _batch("smollm-135m", 10)
    (loss_j, met_j), g_j = jax.jit(jax.value_and_grad(
        m["jm"].train_loss, has_aux=True))(
            m["jp"], jax.tree.map(jnp.asarray, batch))
    loss_t, met_t, g_t = _port_loss_and_grads(m["tm"], m["tp"], batch)
    assert float(loss_t) == pytest.approx(float(loss_j), rel=1e-6)
    assert float(met_t["loss"].detach()) == pytest.approx(float(met_j["loss"]),
                                                 rel=1e-6)
    assert int(met_t["tokens"]) == int(met_j["tokens"]) == 4 * 15 - 3
    assert float(met_t["moe_aux"]) == float(met_j["moe_aux"]) == 0.0
    _close_grads(g_t, jax.tree.map(np.asarray, g_j), "train_loss")
    assert any(float(g.abs().sum()) > 0 for name, g in
               tree.leaves_with_paths(g_t) if name.endswith("sps_lambda"))


def test_remat_on_equals_off_bitwise():
    """Each block under ``torch.utils.checkpoint`` recomputes the same
    forward in the backward: loss and every gradient equal bitwise on
    the CPU."""
    m = _model("smollm-135m")
    batch = _batch("smollm-135m", 11)
    cfg = tbase.get_smoke_config("smollm-135m")
    assert cfg.remat == "none"
    on = tbuild(dataclasses.replace(cfg, remat="block"))
    loss_a, _, g_a = _port_loss_and_grads(m["tm"], m["tp"], batch)
    loss_b, _, g_b = _port_loss_and_grads(on, m["tp"], batch)
    assert torch.equal(loss_a, loss_b)
    for a, b in zip(tree.leaves(g_a), tree.leaves(g_b)):
        assert torch.equal(a, b)


def test_qat_logits_equal_deploy_logits():
    """The port's QAT face against its deploy face on the same params
    (JAX's ``tests/test_models_deploy.py`` invariant and tolerance):
    smollm, gemma's windows, bert's ReLU FFN, internvl2's frontend."""
    for arch in ("smollm-135m", "gemma3-27b", "bert-base-cobra",
                 "internvl2-76b"):
        m = _model(arch)
        toks, kw = _tokens(arch, 12)
        with torch.no_grad():
            qat = m["tm"].qat_logits(m["tp"], torch.from_numpy(toks), **kw)
            dep = m["tm"].prefill_logits(m["tm"].convert(m["tp"]), toks,
                                         device="cpu", **kw)
        np.testing.assert_allclose(qat.numpy(), dep.numpy(), rtol=0,
                                   atol=2e-3, err_msg=arch)
