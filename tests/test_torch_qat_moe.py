"""The MoE family's QAT face in the port against the JAX package on the
CPU, float32: the expert-stacked ``BinaryFFN.apply`` (SiLU and GELU
GLUs, (E, C, d) buffers), ``BinaryMoE.apply`` with its load-balance
loss (mixtral's and arctic's shapes, the dense residual, claims dropped
and none dropped, tied router probabilities), ``train_loss`` with every
leaf's gradient against ``jax.value_and_grad``, three ``Trainer`` steps
against the composition the JAX ``Trainer`` jits (``value_and_grad``
then ``AdamW.update``, without its mesh, which fails on the CPU), with
and without gradient accumulation (capacity counts the micro-batch's
rows), and the port's own: a dropped claim gets no gradient, QAT logits
== deploy logits within JAX's 2e-3, the bridge carries expert stacks.

The helpers here (list-aware param perturbation, the vjp and gradient
comparisons, the JAX train-step composition) serve the other QAT test
files of this slice too.

Tolerances, each with its reason: outputs within 1e-5 absolute and
logits within 1e-4 (hard decisions, the signs and SPS bits, agree, so
values differ by float32 rounding: sums in another order); gradients
within 2e-4 of each leaf's largest |gradient| (sums of many terms in
another order through sign-STE windows); losses within 1e-6 relative;
params after training steps as ``_close_params`` states (Adam's m /
sqrt(v) turns a last-bit difference of a gradient near zero into a
step of up to lr)."""
import test_torch_threads  # noqa: F401  (first: one torch thread)
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.models.ffn import BinaryFFN as JFFN, BinaryMoE as JMoE
from repro.models.lm import build_model as jbuild
from repro.optim import compress as jcomp, schedules as jsched
from repro.optim.adamw import AdamW as JAdamW
from repro.train.trainer import TrainState as JState
from repro_torch import bridge, tree
from repro_torch.configs import base as tbase
from repro_torch.data.synthetic import SyntheticStream
from repro_torch.models.ffn import BinaryFFN as TFFN, BinaryMoE as TMoE
from repro_torch.models.lm import build_model as tbuild
from repro_torch.optim import schedules as tsched
from repro_torch.optim.adamw import AdamW as TAdamW
from repro_torch.train.trainer import Trainer, TrainerConfig

OUT_ATOL, LOGIT_ATOL, GRAD_REL, LOSS_RTOL = 1e-5, 1e-4, 2e-4, 1e-6
LR = 3e-3


# -- shared helpers -----------------------------------------------------------


def perturb(t, rng, name=""):
    """Scales, betas and lambdas moved off their init values (a list of
    layers, xlstm's, visited layer by layer)."""
    if isinstance(t, dict):
        return {k: perturb(v, rng, k) for k, v in t.items()}
    if isinstance(t, list):
        return [perturb(v, rng, name) for v in t]
    a = np.array(t)
    if name.endswith("_alpha") or name == "alpha_w":
        return (a * rng.uniform(0.5, 1.5, a.shape)).astype(np.float32)
    if name.endswith("_beta") or name == "bias":
        return (a + 0.1 * rng.standard_normal(a.shape)).astype(np.float32)
    if name == "sps_lambda":
        return (a + 0.3 * rng.standard_normal(a.shape)).astype(np.float32)
    return a


def jax_params(module, seed):
    """The JAX module's init from ``seed`` (jitted: the same values, a
    fraction of the eager init's time), perturbed, as numpy."""
    return perturb(jax.tree.map(np.asarray, jax.jit(module.init)(
        jax.random.PRNGKey(seed))), np.random.default_rng(seed))


def close_grads(got, want_np, what=""):
    """Leaf by leaf (port tree against the bridged JAX numpy tree), within
    GRAD_REL of the leaf's largest |gradient|."""
    want = bridge.from_jax_params(want_np, device="cpu")
    pairs = list(zip(tree.leaves_with_paths(got), tree.leaves(want)))
    assert len(pairs) == len(tree.leaves(want)) > 0
    for (name, g), w in pairs:
        np.testing.assert_allclose(
            g.numpy(), w.numpy(), rtol=0,
            atol=GRAD_REL * float(w.abs().max()) + 1e-7,
            err_msg=f"{what} {name}")


def close_array(got, want, rel=GRAD_REL, what=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rel * float(np.abs(want).max()) + 1e-7,
                               err_msg=what)


def jax_value_grads(fn, params, *args):
    """(value, grads of params, grads of args) of the scalar fn(params,
    *args), jitted."""
    argnums = tuple(range(1 + len(args)))
    val, grads = jax.jit(jax.value_and_grad(fn, argnums=argnums))(
        jax.tree.map(jnp.asarray, params), *map(jnp.asarray, args))
    return (float(val), jax.tree.map(np.asarray, grads[0]),
            [np.asarray(g) for g in grads[1:]])


def port_params(params_np):
    return bridge.from_jax_params(params_np, device="cpu")


def torch_value_grads(fn, params, *args):
    """(value, grads of the bridged params (port tree), grads of args) of
    fn(params, *args), for JAX numpy ``params``."""
    tp = port_params(params)
    leaves = [t.requires_grad_(True) for t in tree.leaves(tp)]
    targs = [torch.tensor(np.asarray(a)).requires_grad_(True) for a in args]
    val = fn(tree.unflatten(tp, leaves), *targs)
    grads = torch.autograd.grad(val, leaves + targs, allow_unused=True)
    grads = [torch.zeros_like(v) if g is None else g
             for g, v in zip(grads, leaves + targs)]
    return (float(val.detach()), tree.unflatten(tp, grads[:len(leaves)]),
            grads[len(leaves):])


def stream_batch(cfg, seed, step=0, b=4, s=16):
    """A batch of the seeded synthetic stream with a few more labels
    ignored inside a row."""
    batch = SyntheticStream(cfg, s, b, seed=seed).batch_at(step)
    batch["labels"][0, :3] = -1
    return batch


def port_loss_and_grads(model, params, batch):
    leaves = [p.detach().clone().requires_grad_(True)
              for p in tree.leaves(params)]
    loss, metrics = model.train_loss(tree.unflatten(params, leaves),
                                     {k: torch.from_numpy(v)
                                      for k, v in batch.items()})
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for g, p in zip(grads, leaves)]
    return loss.detach(), metrics, tree.unflatten(params, grads)


def check_train_loss(jm, tm, params_np, batch, what):
    """``train_loss``, its metrics and every leaf's gradient against
    ``jax.value_and_grad``; returns the port's gradients."""
    (loss_j, met_j), g_j = jax.jit(jax.value_and_grad(
        jm.train_loss, has_aux=True))(
            jax.tree.map(jnp.asarray, params_np),
            jax.tree.map(jnp.asarray, batch))
    loss_t, met_t, g_t = port_loss_and_grads(tm, port_params(params_np),
                                             batch)
    assert float(loss_t) == pytest.approx(float(loss_j), rel=LOSS_RTOL)
    for k in ("loss", "moe_aux"):
        assert float(met_t[k]) == pytest.approx(float(met_j[k]),
                                                rel=LOSS_RTOL, abs=1e-7), k
    assert int(met_t["tokens"]) == int(met_j["tokens"])
    close_grads(g_t, jax.tree.map(np.asarray, g_j), what)
    return g_t


def jax_step_fn(jm, opt, accum=1, compress_grads=False):
    """``repro.train.trainer.Trainer._build_train_step``'s ``step``,
    without the mesh, jitted."""
    grad_fn = jax.value_and_grad(jm.train_loss, has_aux=True)

    def step(state, batch):
        if accum > 1:
            def micro(c, mb):
                (l, m), g = grad_fn(state.params, mb)
                gsum, lsum = c
                return (jax.tree.map(jnp.add, gsum, g), lsum + l), m

            mbs = jax.tree.map(lambda x: x.reshape(
                (accum, x.shape[0] // accum) + x.shape[1:]), batch)
            g0 = jax.tree.map(lambda p: jnp.zeros(p.shape, jnp.float32),
                              state.params)
            (gsum, lsum), ms = jax.lax.scan(micro, (g0, 0.0), mbs)
            grads = jax.tree.map(lambda g: g / accum, gsum)
            metrics = jax.tree.map(lambda m: m[-1], ms)
            metrics["loss_total"] = lsum / accum
        else:
            (loss, metrics), grads = grad_fn(state.params, batch)
            metrics["loss_total"] = loss
        ef = state.ef
        if compress_grads:
            grads, ef = jcomp.compress_tree(grads, ef)
        params, o, om = opt.update(grads, state.opt, state.params)
        metrics.update(om)
        return JState(params, o, ef), metrics

    return jax.jit(step)


def close_params(got, want_np, steps):
    """Params after training steps on gradients that agree to float32
    rounding: any element within 2 lr per step, all but 1 in 1,000
    within 1e-6."""
    want = port_params(want_np)
    diffs = torch.cat([(g - w).abs().reshape(-1) for g, w in zip(
        tree.leaves(got), tree.leaves(want))])
    assert float(diffs.max()) <= 2 * LR * steps
    assert float((diffs > 1e-6).double().mean()) <= 1e-3


def check_trainer_steps(jm, tm, params_np, cfg, steps=3, accum=1,
                        compress_grads=False, b=4, s=16):
    """``steps`` steps of the port's ``Trainer`` (CPU) against the JAX
    composition from one state on the stream's batches: each step's
    losses and grad norm, then params, moments and error feedback.
    Returns the port's trainer."""
    jopt = JAdamW(lr=LR, schedule=jsched.warmup_cosine(2, 10))
    jp = jax.tree.map(jnp.asarray, params_np)
    js = JState(jp, jopt.init(jp),
                jcomp.init_error_feedback(jp) if compress_grads else None)
    ts = bridge.from_jax_train_state(jax.tree.map(np.asarray, js),
                                     device="cpu")
    trainer = Trainer(tm, TAdamW(lr=LR, schedule=tsched.warmup_cosine(2, 10)),
                      TrainerConfig(grad_accum=accum,
                                    compress_grads=compress_grads),
                      device="cpu")
    step_fn = jax_step_fn(jm, jopt, accum, compress_grads)
    stream = SyntheticStream(cfg, s, b, seed=2)
    for step in range(steps):
        batch = stream.batch_at(step)
        js, jmet = step_fn(js, jax.tree.map(jnp.asarray, batch))
        ts, tmet = trainer.train_step(ts, batch)
        for k in ("loss_total", "loss", "grad_norm"):
            assert float(tmet[k]) == pytest.approx(float(jmet[k]),
                                                   rel=1e-5), (step, k)
    close_params(ts.params, jax.tree.map(np.asarray, js.params), steps)
    close_moments(ts.opt.mu, js.opt.mu, compress_grads, "mu")
    if compress_grads:
        close_moments(ts.ef, js.ef, True, "ef")
    return trainer


def close_moments(got, want_jax, flips: bool, what: str):
    """Each element within 1e-3 relative and 1e-6 absolute.  With 1-bit
    compression, where g + e lies within float32 rounding of 0 the two
    packages may give its compressed gradient opposite signs, and the
    error feedback carries a flip into later steps: then all but 1 in 100
    elements of a leaf must agree so, and the rest differ by at most
    twice the leaf's largest |value| (a flipped sign)."""
    want = port_params(jax.tree.map(np.asarray, want_jax))
    for (name, a), w in zip(tree.leaves_with_paths(got), tree.leaves(want)):
        if not flips:
            np.testing.assert_allclose(a.numpy(), w.numpy(), rtol=1e-3,
                                       atol=1e-6, err_msg=f"{what} {name}")
            continue
        diff = (a - w).abs()
        off = diff > 1e-6 + 1e-3 * w.abs()
        assert float(off.double().mean()) <= 1e-2, (what, name)
        assert float(diff.max()) <= 2 * float(w.abs().max()) + 1e-6, \
            (what, name)


# -- the expert stack and the MoE ---------------------------------------------


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_expert_stacked_ffn_apply_and_gradients_match_jax(act):
    """(E, C, d) expert buffers: one batched float32 +-1 product per
    projection, alpha_w (E, 1, P); output, every param's and the input's
    gradient."""
    jf = JFFN(64, 96, act=act, num_experts=4)
    tf = TFFN(64, 96, act=act, num_experts=4)
    params = jax_params(jf, 1)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((4, 6, 64)).astype(np.float32)
    ct = rng.standard_normal((4, 6, 64)).astype(np.float32)
    want = jf.apply(jax.tree.map(jnp.asarray, params), jnp.asarray(x))
    with torch.no_grad():
        got = tf.apply(port_params(params), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=OUT_ATOL)
    fj = lambda p, xx: jnp.sum(jf.apply(p, xx) * ct)
    ft = lambda p, xx: torch.sum(tf.apply(p, xx) * torch.from_numpy(ct))
    _, gp_j, (gx_j,) = jax_value_grads(fj, params, x)
    _, gp_t, (gx_t,) = torch_value_grads(ft, params, x)
    close_grads(gp_t, gp_j, act)
    close_array(gx_t, gx_j, what="x")


MOE_CASES = {
    # name: (experts, d_ff, capacity factor, dense residual, drops)
    "mixtral-dropless": (4, 96, 2.0, False, False),
    "mixtral-drops": (4, 96, 0.5, False, True),
    "arctic-residual-drops": (8, 64, 1.0, True, True),
}


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_apply_aux_and_gradients_match_jax(case):
    """The output, the load-balance loss and every gradient (router,
    experts, residual, input) of sum(y * ct) + c * aux: the router's
    gradient is the sum over the gates and the aux loss, each reading
    its own softmax as in JAX."""
    e, ff, cf, residual, drops = MOE_CASES[case]
    kw = dict(d_model=64, d_ff=ff, num_experts=e, top_k=2,
              capacity_factor=cf, dense_residual=residual)
    jm, tm = JMoE(**kw), TMoE(**kw)
    params = jax_params(jm, 3)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 12, 64)).astype(np.float32)
    ct = rng.standard_normal(x.shape).astype(np.float32)
    c_aux = np.float32(0.7)
    y_j, aux_j = jm.apply(jax.tree.map(jnp.asarray, params), jnp.asarray(x))
    tp = port_params(params)
    with torch.no_grad():
        y_t, aux_t = tm.apply(tp, torch.from_numpy(x))
        keep = tm._route(tp, torch.from_numpy(x).reshape(-1, 64))[3]
    assert bool((~keep).any()) == drops
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), rtol=0,
                               atol=OUT_ATOL)
    assert float(aux_t["moe_aux_loss"]) == pytest.approx(
        float(aux_j["moe_aux_loss"]), rel=LOSS_RTOL)

    def fj(p, xx):
        y, aux = jm.apply(p, xx)
        return jnp.sum(y * ct) + c_aux * aux["moe_aux_loss"]

    def ft(p, xx):
        y, aux = tm.apply(p, xx)
        return torch.sum(y * torch.from_numpy(ct)) + \
            float(c_aux) * aux["moe_aux_loss"]

    _, gp_j, (gx_j,) = jax_value_grads(fj, params, x)
    _, gp_t, (gx_t,) = torch_value_grads(ft, params, x)
    close_grads(gp_t, gp_j, case)
    close_array(gx_t, gx_j, what="x")
    assert float(gp_t["router"]["kernel"].abs().max()) > 0


def test_tied_router_probabilities_take_the_lowest_experts():
    """A zero router gives every expert the same probability: the top-k
    takes experts 0 and 1 (``lax.top_k``'s lowest indices), the aux loss's
    argmax expert 0, and capacity then drops claims past the first
    C rows; values and gradients as JAX's."""
    kw = dict(d_model=32, d_ff=64, num_experts=4, top_k=2,
              capacity_factor=1.0)
    jm, tm = JMoE(**kw), TMoE(**kw)
    params = jax_params(jm, 5)
    params["router"]["kernel"] = np.zeros_like(params["router"]["kernel"])
    x = np.random.default_rng(6).standard_normal((10, 32)).astype(
        np.float32)
    tp = port_params(params)
    _, idx, _, keep, cap = tm._route(tp, torch.from_numpy(x))
    assert idx.tolist() == [[0, 1]] * 10 and cap == 5
    assert keep[:, 0].tolist() == [True] * 5 + [False] * 5
    fj = lambda p, xx: jnp.sum(jm.apply(p, xx)[0]) + \
        jm.apply(p, xx)[1]["moe_aux_loss"]
    ft = lambda p, xx: torch.sum(tm.apply(p, xx)[0]) + \
        tm.apply(p, xx)[1]["moe_aux_loss"]
    v_j, gp_j, (gx_j,) = jax_value_grads(fj, params, x)
    v_t, gp_t, (gx_t,) = torch_value_grads(ft, params, x)
    assert v_t == pytest.approx(v_j, rel=LOSS_RTOL)
    close_grads(gp_t, gp_j, "tied")
    close_array(gx_t, gx_j, what="x")


def test_a_dropped_claim_gets_no_gradient():
    """Capacity 0.25: a row whose claims all drop has a zero output and,
    the aux loss aside, an exactly zero input gradient; the combine adds
    exactly 0 to the clipped slot a dropped claim gathers (the buffer's
    gradient equals the kept claims' alone, bitwise)."""
    tm = TMoE(d_model=32, d_ff=64, num_experts=4, top_k=2,
              capacity_factor=0.25)
    params = port_params(jax_params(JMoE(32, 64, 4, capacity_factor=0.25),
                                    7))
    x = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (16, 32)).astype(np.float32)).requires_grad_(True)
    gates, idx, slot, keep, cap = tm._route(params, x.detach())
    gone = ~keep.any(1)
    assert bool(gone.any()) and bool(keep.any())
    y, _ = tm.apply(params, x)
    assert float(y[gone].abs().max()) == 0.0
    gx, = torch.autograd.grad(y.sum(), x)
    assert float(gx[gone].abs().max()) == 0.0
    out_buf = torch.randn(4, cap, 32, requires_grad=True)
    ct = torch.randn(16, 32)
    g_buf, = torch.autograd.grad((tm._combine(out_buf, gates, idx, slot,
                                              keep) * ct).sum(), out_buf)
    want = torch.zeros(4 * cap, 32)
    w = gates * keep
    for n, k in keep.nonzero().tolist():
        want[int(idx[n, k]) * cap + int(slot[n, k])] += w[n, k] * ct[n]
    assert torch.equal(g_buf.reshape(-1, 32), want)


# -- the model ----------------------------------------------------------------


def _smoke(arch, cf=None):
    jcfg, tcfg = jbase.get_smoke_config(arch), tbase.get_smoke_config(arch)
    if cf is not None:
        jcfg = jcfg.with_(moe=dataclasses.replace(jcfg.moe,
                                                  capacity_factor=cf))
        tcfg = tcfg.with_(moe=dataclasses.replace(tcfg.moe,
                                                  capacity_factor=cf))
    return jcfg, tcfg


@functools.lru_cache(maxsize=None)
def _model(arch, cf):
    jcfg, tcfg = _smoke(arch, cf)
    jm = jbuild(jcfg)
    return jm, tbuild(tcfg), jax_params(jm, 0), tcfg


@pytest.mark.parametrize("arch,cf", [("mixtral-8x22b", 1.0),
                                     ("arctic-480b", None)])
def test_train_loss_and_every_gradient_match_jax(arch, cf):
    """mixtral's smoke config at capacity factor 1 (claims drop: the
    capacity is the whole batch's) and arctic's (a dense residual, 8
    experts): the loss with its z-loss and 0.01 * the summed load-balance
    losses, the metrics and every leaf's gradient."""
    jm, tm, params, tcfg = _model(arch, cf)
    batch = stream_batch(tcfg, 9)
    g = check_train_loss(jm, tm, params, batch, arch)
    assert float(g["blocks"][1]["ffn"]["router"]["kernel"].abs().max()) > 0


def test_trainer_steps_match_jax_composition():
    """Three steps of mixtral's smoke config at capacity factor 1 with two
    micro-batches: the capacity counts a micro-batch's rows, as in JAX,
    so the drops differ from the whole batch's."""
    jm, tm, params, tcfg = _model("mixtral-8x22b", 1.0)
    trainer = check_trainer_steps(jm, tm, params, tcfg, accum=2)
    assert trainer.stacked == ("blocks",)
    moe = tm._block()._ffn()
    assert moe.capacity(2 * 16) < moe.capacity(4 * 16)


def test_qat_logits_equal_deploy_logits():
    """JAX's ``tests/test_models_deploy.py`` invariant and tolerance on
    the mixtral (claims dropped: both faces route alike) and arctic smoke
    configs."""
    for arch, cf in (("mixtral-8x22b", 1.0), ("arctic-480b", None)):
        _, tm, params, tcfg = _model(arch, cf)
        toks = np.random.default_rng(10).integers(
            0, tcfg.vocab_size, (2, 20)).astype(np.int32)
        tp = port_params(params)
        with torch.no_grad():
            qat = tm.qat_logits(tp, torch.from_numpy(toks))
            dep = tm.prefill_logits(tm.convert(tp), toks, device="cpu")
        np.testing.assert_allclose(qat.numpy(), dep.numpy(), rtol=0,
                                   atol=2e-3, err_msg=arch)
        assert torch.equal(qat.argmax(-1), dep.argmax(-1))


def test_qat_logits_match_jax_and_bridge_carries_expert_stacks():
    """The QAT logits against JAX's (dropping config), and the bridge's
    expert-stacked leaves: layer i of JAX's stacked (L, E, K, P) leaf is
    the port's (E, K, P) leaf, unchanged."""
    jm, tm, params, tcfg = _model("mixtral-8x22b", 1.0)
    tp = port_params(params)
    w = params["blocks"]["ffn"]["experts"]["w1"]["w_latent"]
    for i, layer in enumerate(tp["blocks"]):
        got = layer["ffn"]["experts"]["w1"]["w_latent"]
        assert got.dtype == torch.float32 and got.shape == w.shape[1:]
        np.testing.assert_array_equal(got.numpy(), w[i])
    toks = np.random.default_rng(11).integers(
        0, tcfg.vocab_size, (2, 20)).astype(np.int32)
    want = jax.jit(jm.qat_logits)(jax.tree.map(jnp.asarray, params),
                                  jnp.asarray(toks))
    with torch.no_grad():
        got = tm.qat_logits(tp, torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=LOGIT_ATOL)
