"""The encoder-decoder family's QAT face in the port against the JAX
package on the CPU, float32: cross-attention's QAT face (its memory
binarized with the block's own activation scales, no RoPE, the key-length
mask only; the memory's gradient), ``Block.qat`` of kind "dec", the
encoder's QAT face (``encode(..., deploy=False)``), ``EncDecModel``'s
``train_loss`` (the NLL alone: no z-loss, no MoE term) with every leaf's
gradient on the seamless smoke config, three ``Trainer`` steps against
the JAX composition (``value_and_grad`` then ``AdamW.update``, with
1-bit compression) whose decay rule and compression scales read
the stacked ``encoder`` / ``decoder`` leaves of JAX's tree; and the
port's own: remat on equals off bitwise, and the donating step (on the
card the captured step writes the new state into the given state's own
tensors, group by group) equal to the functional step bitwise.

Tolerances as in ``test_torch_qat_moe.py``, for the same reasons:
outputs within 1e-5, gradients within 2e-4 of each leaf's largest
|gradient|, losses within 1e-6 relative; the decay-only step within
1e-6 relative."""
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
from repro.models.lm import build_model as jbuild
from repro.optim import compress as jcomp
from repro.optim.adamw import AdamW as JAdamW
from repro_torch import tree
from repro_torch.configs import base as tbase
from repro_torch.models.attention import SPSAttention as TAttn
from repro_torch.models.blocks import Block as TBlock
from repro_torch.models.lm import build_model as tbuild
from repro_torch.optim import adamw as tadamw, compress as tcomp
from repro_torch.optim.adamw import AdamW as TAdamW, decayed
from repro_torch.train.trainer import Trainer, TrainerConfig
from test_torch_qat_moe import (
    LOSS_RTOL, OUT_ATOL, check_train_loss, check_trainer_steps,
    close_array, close_grads, jax_params, jax_value_grads,
    port_loss_and_grads, port_params, stream_batch, torch_value_grads)

ARCH = "seamless-m4t-large-v2"

CROSS_CASES = {
    # name: (heads, kv heads, granularity)
    "head-gqa": (4, 2, "head"),
    "row": (2, 2, "row"),
}


@pytest.mark.parametrize("case", list(CROSS_CASES))
def test_cross_attention_qat_and_memory_gradient_match_jax(case):
    """S = 10 queries over a memory of 14 positions: the output and the
    gradients of every param, of the queries' input and of the memory
    (which reaches the encoder)."""
    h, hkv, gran = CROSS_CASES[case]
    kw = dict(d_model=64, num_heads=h, num_kv_heads=hkv, head_dim=16,
              use_rope=False, cross=True, sps_granularity=gran)
    ja, ta = JAttn(**kw, q_chunk=8), TAttn(**kw)
    params = jax_params(ja, 1)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 10, 64)).astype(np.float32)
    mem = rng.standard_normal((2, 14, 64)).astype(np.float32)
    ct = rng.standard_normal(x.shape).astype(np.float32)
    fj = lambda p, xx, mm: jnp.sum(ja.qat(p, xx, memory=mm)[0] * ct)
    ft = lambda p, xx, mm: torch.sum(ta.qat(p, xx, memory=mm)[0] *
                                     torch.from_numpy(ct))
    v_j, gp_j, (gx_j, gm_j) = jax_value_grads(fj, params, x, mem)
    v_t, gp_t, (gx_t, gm_t) = torch_value_grads(ft, params, x, mem)
    assert v_t == pytest.approx(v_j, rel=1e-5)
    close_grads(gp_t, gp_j, case)
    close_array(gx_t, gx_j, what="x")
    close_array(gm_t, gm_j, what="memory")
    assert float(gm_t.abs().max()) > 0


def test_decoder_block_qat_matches_jax():
    """seamless' "dec" block: causal self-attention, norm_x and
    cross-attention over the memory, the ReLU FFN; output and every
    gradient, the memory's included."""
    jcfg, tcfg = jbase.get_smoke_config(ARCH), tbase.get_smoke_config(ARCH)
    jb, tb = JBlock(jcfg, kind="dec"), TBlock(tcfg, kind="dec")
    params = jax_params(jb, 3)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 9, jcfg.d_model)).astype(np.float32)
    mem = rng.standard_normal((2, 8, jcfg.d_model)).astype(np.float32)
    ct = rng.standard_normal(x.shape).astype(np.float32)
    want = jb.qat(jax.tree.map(jnp.asarray, params), jnp.asarray(x),
                  memory=jnp.asarray(mem))[0]
    with torch.no_grad():
        got = tb.qat(port_params(params), torch.from_numpy(x),
                     memory=torch.from_numpy(mem))[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=OUT_ATOL)
    fj = lambda p, xx, mm: jnp.sum(jb.qat(p, xx, memory=mm)[0] * ct)
    ft = lambda p, xx, mm: torch.sum(tb.qat(p, xx, memory=mm)[0] *
                                     torch.from_numpy(ct))
    _, gp_j, (gx_j, gm_j) = jax_value_grads(fj, params, x, mem)
    _, gp_t, (gx_t, gm_t) = torch_value_grads(ft, params, x, mem)
    close_grads(gp_t, gp_j, "dec")
    close_array(gx_t, gx_j, what="x")
    close_array(gm_t, gm_j, what="memory")


@functools.lru_cache(maxsize=None)
def _model():
    jm = jbuild(jbase.get_smoke_config(ARCH))
    tcfg = tbase.get_smoke_config(ARCH)
    return jm, tbuild(tcfg), jax_params(jm, 0), tcfg


def test_encode_qat_matches_jax():
    """The frontend projection, the bidirectional encoder blocks' QAT
    faces and ``enc_norm``: the memory and every gradient of sum(memory *
    ct), the frame embeddings' included."""
    jm, tm, params, tcfg = _model()
    rng = np.random.default_rng(5)
    fe = rng.standard_normal((2, tcfg.frontend_tokens, tm.frontend_dim)
                             ).astype(np.float32)
    ct = rng.standard_normal((2, tcfg.frontend_tokens, tcfg.d_model)
                             ).astype(np.float32)
    fj = lambda p, f: jnp.sum(jm.encode(p, f) * ct)
    ft = lambda p, f: torch.sum(tm.encode(p, f, deploy=False) *
                                torch.from_numpy(ct))
    v_j, gp_j, (gf_j,) = jax_value_grads(fj, params, fe)
    v_t, gp_t, (gf_t,) = torch_value_grads(ft, params, fe)
    assert v_t == pytest.approx(v_j, rel=1e-5)
    close_grads(gp_t, gp_j, "encode")
    close_array(gf_t, gf_j, what="frontend_embeds")


def test_train_loss_and_every_gradient_match_jax():
    """The NLL over valid labels (no z-loss), "moe_aux" 0, and every
    leaf's gradient: the encoder's through the memory."""
    jm, tm, params, tcfg = _model()
    g = check_train_loss(jm, tm, params, stream_batch(tcfg, 6), ARCH)
    assert float(g["encoder"][0]["attn"]["sps_lambda"].abs().max()) > 0
    assert float(g["decoder"][1]["cross"]["wq"]["w_latent"].abs().max()) > 0


def test_trainer_steps_match_jax_composition():
    """Three steps from one state with 1-bit compression; the decay rule
    and the compression's scales read the encoder's and the decoder's
    per-layer lists as JAX's stacked leaves."""
    jm, tm, params, tcfg = _model()
    trainer = check_trainer_steps(jm, tm, params, tcfg, compress_grads=True)
    assert trainer.stacked == ("encoder", "decoder")


def test_decay_and_compression_read_the_stacked_encoder_decoder():
    """Zero gradients leave only the decay: JAX moves exactly its leaves
    of ndim >= 2 on its stacked tree (an encoder layer's norm scales and
    per-head lambdas, not its scalar scales), and the port moves the same
    ones; ``stacked_groups`` gives JAX's leaves."""
    jm, tm, params, _ = _model()
    params = jax.tree.map(lambda p: p + np.float32(0.25), params)
    zero = jax.tree.map(np.zeros_like, params)
    jopt, topt = JAdamW(lr=0.1, weight_decay=0.5), TAdamW(
        lr=0.1, weight_decay=0.5)
    jp = jax.tree.map(jnp.asarray, params)
    jnew, _, _ = jax.jit(jopt.update)(jax.tree.map(jnp.asarray, zero),
                                      jopt.init(jp), jp)
    tp = port_params(params)
    tnew, _, _ = topt.update(port_params(zero), topt.init(tp), tp,
                             stacked=tm.stacked)
    want = port_params(jax.tree.map(np.asarray, jnew))
    flags = decayed(tp, tm.stacked)
    for (name, old), new, w, d in zip(tree.leaves_with_paths(tp),
                                      tree.leaves(tnew), tree.leaves(want),
                                      flags):
        assert bool((old != w).any()) == d, name
        np.testing.assert_allclose(new.numpy(), w.numpy(), rtol=LOSS_RTOL,
                                   err_msg=name)
    paths = dict(zip([n for n, _ in tree.leaves_with_paths(tp)], flags))
    assert paths["encoder/0/norm1/scale"] and \
        paths["decoder/1/cross/sps_lambda"]
    assert not paths["encoder/0/attn/act_alpha"]
    assert len(tcomp.stacked_groups(tp, tm.stacked)) == len(
        jax.tree.leaves(params))
    g = jax.tree.map(lambda p: np.random.default_rng(0).standard_normal(
        p.shape).astype(np.float32), params)
    gj, _ = jcomp.compress_tree(jax.tree.map(jnp.asarray, g),
                                jcomp.init_error_feedback(jp))
    gt, _ = tcomp.compress_tree(port_params(g), tcomp.init_error_feedback(
        tp), tm.stacked)
    for (name, a), w in zip(tree.leaves_with_paths(gt), tree.leaves(
            port_params(jax.tree.map(np.asarray, gj)))):
        np.testing.assert_allclose(a.numpy(), w.numpy(), rtol=LOSS_RTOL,
                                   err_msg=name)


def test_remat_on_equals_off_bitwise():
    """Each encoder and decoder block under ``torch.utils.checkpoint``
    (JAX's encoder-decoder scans have none; the values are the same):
    loss and every gradient equal bitwise on the CPU."""
    _, tm, params, tcfg = _model()
    assert tcfg.remat == "none"
    on = tbuild(dataclasses.replace(tcfg, remat="block"))
    batch = stream_batch(tcfg, 7)
    loss_a, _, g_a = port_loss_and_grads(tm, port_params(params), batch)
    loss_b, _, g_b = port_loss_and_grads(on, port_params(params), batch)
    assert torch.equal(loss_a, loss_b)
    for a, b in zip(tree.leaves(g_a), tree.leaves(g_b)):
        assert torch.equal(a, b)


def test_donating_step_equals_the_functional_step_bitwise(monkeypatch):
    """``Trainer._step(..., donate=True)`` on the CPU, with groups of 1,000
    elements (leaves cut into slices): params, moments and error feedback
    written into the given state's tensors, bitwise the functional
    step's; with ``write`` False it computes and leaves the state as it
    was."""
    _, tm, params, tcfg = _model()
    monkeypatch.setattr(tadamw, "GROUP_NUMEL", 1000)
    trainer = Trainer(tm, TAdamW(lr=3e-3), TrainerConfig(
        compress_grads=True), device="cpu")
    state = trainer.init_state()
    batch = trainer.batch_on_device(stream_batch(tcfg, 8))
    first, _ = trainer._step(state, batch)          # non-zero moments
    want, m_want = trainer._step(first, batch)
    kept = tree.map(lambda t: t.clone(), first)
    trainer._step(first, batch, donate=True, write=False)
    for a, b in zip(tree.leaves(first), tree.leaves(kept)):
        assert torch.equal(a, b)
    got, m_got = trainer._step(first, batch, donate=True)
    assert torch.equal(m_got["loss_total"], m_want["loss_total"])
    assert got.params["decoder"][0]["cross"]["wq"]["w_latent"] is \
        first.params["decoder"][0]["cross"]["wq"]["w_latent"]
    for (name, a), b in zip(tree.leaves_with_paths(got), tree.leaves(want)):
        assert torch.equal(a, b), name
