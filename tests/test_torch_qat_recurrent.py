"""The recurrent families' QAT faces in the port against the JAX package
on the CPU, float32: ``MambaBlock``, ``MLSTMBlock`` and ``SLSTMBlock``
``apply(deploy=False)`` with every gradient (the projections through
``BinaryDense.apply``, the scan and the cells as Python loops under
autograd); the cells' ``maximum`` at a tie, which every sLSTM hits at
its first step (its normalizer is exactly 1) and which JAX's
``jnp.maximum`` splits in half where ``torch.clamp`` would not;
``Block.qat`` of kinds hybrid, mlstm and slstm; ``train_loss`` with
every leaf's gradient on the hymba and xlstm smoke configs; three
``Trainer`` steps against the JAX composition (xlstm's mixed stack is a
list in JAX too, so nothing is read as stacked); and the port's own:
remat through the scans equal to no remat bitwise, QAT logits == deploy
logits within JAX's 2e-3, the bridge carries the recurrent float32
leaves unchanged.

Tolerances as in ``test_torch_qat_moe.py``, for the same reasons:
outputs within 1e-5, gradients within 2e-4 of each leaf's largest
|gradient|, losses within 1e-6 relative; the tie's gradients within 1e-6
(a handful of float32 operations)."""
import test_torch_threads  # noqa: F401  (first: one torch thread)
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.models import ssm as jssm
from repro.models.blocks import Block as JBlock
from repro.models.lm import build_model as jbuild
from repro_torch import tree
from repro_torch.configs import base as tbase
from repro_torch.models import ssm as tssm
from repro_torch.models.blocks import Block as TBlock
from repro_torch.models.lm import build_model as tbuild
from test_torch_qat_moe import (
    OUT_ATOL, check_train_loss, check_trainer_steps, close_array,
    close_grads, jax_params, jax_value_grads, port_loss_and_grads,
    port_params, stream_batch, torch_value_grads)

CELLS = {
    "mamba": (jssm.MambaBlock(32, state_size=4), tssm.MambaBlock(
        32, state_size=4)),
    "mlstm": (jssm.MLSTMBlock(32, 2), tssm.MLSTMBlock(32, 2)),
    "slstm": (jssm.SLSTMBlock(32), tssm.SLSTMBlock(32)),
}


@pytest.mark.parametrize("name", list(CELLS))
def test_recurrent_block_qat_and_gradients_match_jax(name):
    """``apply(deploy=False)`` over 9 positions: the output, every param's
    gradient (the binary projections' latents and scales, the conv, the
    selective-scan and gate params) and the input's."""
    jb, tb = CELLS[name]
    params = jax_params(jb, 1)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 9, 32)).astype(np.float32)
    ct = rng.standard_normal(x.shape).astype(np.float32)
    want = jb.apply(jax.tree.map(jnp.asarray, params), jnp.asarray(x))
    with torch.no_grad():
        got = tb.apply(port_params(params), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=OUT_ATOL)
    fj = lambda p, xx: jnp.sum(jb.apply(p, xx) * ct)
    ft = lambda p, xx: torch.sum(tb.apply(p, xx) * torch.from_numpy(ct))
    _, gp_j, (gx_j,) = jax_value_grads(fj, params, x)
    _, gp_t, (gx_t,) = torch_value_grads(ft, params, x)
    close_grads(gp_t, gp_j, name)
    close_array(gx_t, gx_j, what="x")


def _clamped_cell(kind):
    """The port's cell with ``torch.clamp`` where it writes
    ``torch.maximum``: the same values, all of a tie's gradient."""
    if kind == "slstm":
        def cell(carry, zifo):
            z, ig, fg, og = zifo
            c, n, m = carry
            log_f = -torch.nn.functional.softplus(-fg)
            m_new = torch.maximum(log_f + m, ig)
            i_, f_ = torch.exp(ig - m_new), torch.exp(log_f + m - m_new)
            c = f_ * c + i_ * torch.tanh(z)
            n = f_ * n + i_
            return None, torch.sigmoid(og) * c / torch.clamp(n, min=1.0)
        return cell

    def cell(carry, qkvg):
        q, k, v, ig, fg = qkvg
        c, n, m = carry
        log_f = -torch.nn.functional.softplus(-fg)
        m_new = torch.maximum(log_f + m, ig)
        i_, f_ = torch.exp(ig - m_new), torch.exp(log_f + m - m_new)
        c = f_[..., None, None] * c + \
            i_[..., None, None] * v[..., :, None] * k[..., None, :]
        n = f_[..., None] * n + i_[..., None] * k
        denom = torch.clamp(torch.einsum("bhk,bhk->bh", n, q).abs(), min=1.0)
        return None, torch.einsum("bhvk,bhk->bhv", c, q) / denom[..., None]
    return cell


def _tie_inputs(kind):
    """A cell step whose maximum ties with its bound at 1.  sLSTM: from a
    carry with n = 1, m = 0 and an input gate of -200, i_ = 0 and f_ = 1
    exactly, so the new normalizer is 1 (as at every sLSTM's first
    step, where the tie carries no gradient to the params: i_'s gradient
    is 0 there).  mLSTM: from the init carry n = k, and k = q = the first
    unit vector gives |n . q| = 1 exactly."""
    rng = np.random.default_rng(3)
    if kind == "slstm":
        carry = [rng.standard_normal((2, 6)).astype(np.float32),
                 np.ones((2, 6), np.float32), np.zeros((2, 6), np.float32)]
        z, fg, og = (rng.standard_normal((2, 6)).astype(np.float32)
                     for _ in range(3))
        return carry, [z, np.full((2, 6), -200.0, np.float32), fg, og]
    b, h, dh = 2, 2, 4
    carry = [np.zeros((b, h, dh, dh), np.float32),
             np.zeros((b, h, dh), np.float32),
             np.full((b, h), -1e9, np.float32)]
    unit = np.zeros((b, h, dh), np.float32)
    unit[..., 0] = 1.0
    ins = [unit.copy(), unit.copy(),
           rng.standard_normal((b, h, dh)).astype(np.float32),
           rng.standard_normal((b, h)).astype(np.float32),
           rng.standard_normal((b, h)).astype(np.float32)]
    return carry, ins


@pytest.mark.parametrize("kind", ["slstm", "mlstm"])
def test_cell_maximum_ties_split_the_gradient_as_jax(kind):
    """A cell step at its tie: the port's gradients of sum(h * ct) with
    respect to the carry and every input equal JAX's (``jnp.maximum``
    gives each side half of a tie's gradient, as ``torch.maximum``
    does), and a ``torch.clamp`` denominator gives other ones."""
    jcell = CELLS[kind][0]._cell
    tcell = CELLS[kind][1]._cell
    carry, ins = _tie_inputs(kind)
    args = carry + ins
    rng = np.random.default_rng(4)
    shape = (2, 6) if kind == "slstm" else (2, 2, 4)
    ct = rng.standard_normal(shape).astype(np.float32)

    def fj(*xs):
        return jnp.sum(jcell(jssm.XLSTMCache(*xs[:3]), xs[3:])[1] * ct)

    want = jax.jit(jax.grad(fj, argnums=tuple(range(len(args)))))(
        *map(jnp.asarray, args))

    def grads(cell):
        xs = [torch.tensor(a, requires_grad=True) for a in args]
        h = cell(tssm.XLSTMCache(*xs[:3]), tuple(xs[3:]))[1]
        return torch.autograd.grad((h * torch.from_numpy(ct)).sum(), xs,
                                   allow_unused=True)

    for g, w in zip(grads(tcell), want):
        g = np.zeros(w.shape, np.float32) if g is None else g.numpy()
        np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=1e-6)
    clamped = grads(_clamped_cell(kind))
    assert any(g is not None and
               float(np.abs(g.numpy() - np.asarray(w)).max()) > 1e-3
               for g, w in zip(clamped, want))


BLOCK_CASES = {"hybrid": "hymba-1.5b", "mlstm": "xlstm-350m",
               "slstm": "xlstm-350m"}


@pytest.mark.parametrize("kind", list(BLOCK_CASES))
def test_block_qat_kinds_match_jax(kind):
    """``Block.qat``: hybrid (the windowed attention and the Mamba branch
    on one norm, averaged, then the GLU), the xLSTM cells (x + cell(norm1
    x), no FFN); output and every gradient."""
    arch = BLOCK_CASES[kind]
    jcfg, tcfg = jbase.get_smoke_config(arch), tbase.get_smoke_config(arch)
    jb, tb = JBlock(jcfg, kind=kind), TBlock(tcfg, kind=kind)
    params = jax_params(jb, 5)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 10, jcfg.d_model)).astype(np.float32)
    ct = rng.standard_normal(x.shape).astype(np.float32)
    fj = lambda p, xx: jnp.sum(jb.qat(p, xx)[0] * ct)
    ft = lambda p, xx: torch.sum(tb.qat(p, xx)[0] * torch.from_numpy(ct))
    v_j, gp_j, (gx_j,) = jax_value_grads(fj, params, x)
    v_t, gp_t, (gx_t,) = torch_value_grads(ft, params, x)
    assert v_t == pytest.approx(v_j, rel=1e-5)
    close_grads(gp_t, gp_j, kind)
    close_array(gx_t, gx_j, what="x")


@functools.lru_cache(maxsize=None)
def _model(arch):
    jm = jbuild(jbase.get_smoke_config(arch))
    tcfg = tbase.get_smoke_config(arch)
    return jm, tbuild(tcfg), jax_params(jm, 0), tcfg


RECURRENT_LEAVES = ("a_log", "conv_w", "x_proj", "dt_proj", "w_gates",
                    "b_gates", "f_bias")


@pytest.mark.parametrize("arch", ["hymba-1.5b", "xlstm-350m"])
def test_train_loss_and_every_gradient_match_jax(arch):
    """hymba's uniform stack (stacked in JAX) and xlstm's mixed stack of
    mLSTM and sLSTM layers (a list in JAX): the loss, its metrics and
    every leaf's gradient; the bridge carries the recurrent float32
    leaves unchanged."""
    jm, tm, params, tcfg = _model(arch)
    g = check_train_loss(jm, tm, params, stream_batch(tcfg, 7), arch)
    tp = port_params(params)
    jblocks = params["blocks"]
    seen = 0
    for i, layer in enumerate(tp["blocks"]):
        jl = (jblocks[i] if isinstance(jblocks, list) else
              jax.tree.map(lambda t: t[i], jblocks))
        for part in ("mamba", "cell"):
            for leaf in RECURRENT_LEAVES:
                if leaf in layer.get(part, {}):
                    got = layer[part][leaf]
                    assert got.dtype == torch.float32
                    np.testing.assert_array_equal(got.numpy(),
                                                  jl[part][leaf])
                    assert float(g["blocks"][i][part][leaf].abs().max()) > 0
                    seen += 1
    assert seen >= len(tp["blocks"])


@pytest.mark.parametrize("arch", ["hymba-1.5b", "xlstm-350m"])
def test_trainer_steps_match_jax_composition(arch):
    """Three steps from one state: the port reads hymba's blocks as
    stacked and xlstm's as a list, as JAX's trees are, for the decay rule
    and the compression's scales (compression on)."""
    jm, tm, params, tcfg = _model(arch)
    trainer = check_trainer_steps(jm, tm, params, tcfg,
                                  compress_grads=True)
    assert trainer.stacked == (("blocks",) if arch == "hymba-1.5b"
                               else ())


def test_remat_through_the_scans_equals_no_remat_bitwise():
    """Each block under ``torch.utils.checkpoint`` recomputes the scan and
    the cells in the backward: xlstm's loss and every gradient equal the
    unrematerialized ones bitwise on the CPU."""
    _, tm, params, tcfg = _model("xlstm-350m")
    assert tcfg.remat == "none"
    on = tbuild(dataclasses.replace(tcfg, remat="block"))
    batch = stream_batch(tcfg, 8)
    loss_a, _, g_a = port_loss_and_grads(tm, port_params(params), batch)
    loss_b, _, g_b = port_loss_and_grads(on, port_params(params), batch)
    assert torch.equal(loss_a, loss_b)
    for a, b in zip(tree.leaves(g_a), tree.leaves(g_b)):
        assert torch.equal(a, b)


def test_qat_logits_equal_deploy_logits():
    """JAX's ``tests/test_models_deploy.py`` invariant and tolerance on
    the hymba and xlstm smoke configs."""
    for arch in ("hymba-1.5b", "xlstm-350m"):
        _, tm, params, tcfg = _model(arch)
        toks = np.random.default_rng(9).integers(
            0, tcfg.vocab_size, (2, 20)).astype(np.int32)
        tp = port_params(params)
        with torch.no_grad():
            qat = tm.qat_logits(tp, torch.from_numpy(toks))
            dep = tm.prefill_logits(tm.convert(tp), toks, device="cpu")
        np.testing.assert_allclose(qat.numpy(), dep.numpy(), rtol=0,
                                   atol=2e-3, err_msg=arch)
        assert torch.equal(qat.argmax(-1), dep.argmax(-1))
