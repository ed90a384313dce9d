"""The paper's stage-2 pipeline pieces in the port against the JAX package
on the CPU, float32: the distillation losses (``kd_loss``,
``hidden_distill_loss``, ``distill_loss``) with their gradients,
``calibration_set``'s picks (the same numpy draw, so the same batches),
``search_model_thresholds`` on a BiT-softmax teacher's per-layer scores
followed by ``install_thresholds`` (as ``tests/test_system.py`` runs
them on bert's smoke model: lambda* and the CDR equal to JAX's; the port
writes each layer's lambda into its own attention params, JAX one
stacked leaf); and the training CLI on the CPU for every family: two
smoke steps, then a rerun that resumes from the checkpoint.

Tolerances: losses within 1e-6 relative and their gradients within 1e-5
of the largest (softmaxes and float32 reductions in another order); the
calibration batches bytewise; lambda* exactly (a grid value: the scores
agree to float32 rounding, far from any grid point's bits) and the CDR
within 1e-6."""
import test_torch_threads  # noqa: F401  (first: one torch thread)
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.data import calib as jcalib, synthetic as jsyn
from repro.models.attention import SPSAttention as JAttn
from repro.models.blocks import Block as JBlock
from repro.models.lm import build_model as jbuild
from repro.optim import distill as jdistill
from repro_torch import tree
from repro_torch.checkpoint.ckpt import Checkpointer
from repro_torch.configs import base as tbase
from repro_torch.data import calib as tcalib, synthetic as tsyn
from repro_torch.launch import train as train_cli
from repro_torch.models.attention import SPSAttention as TAttn
from repro_torch.models.blocks import Block as TBlock
from repro_torch.models.lm import build_model as tbuild
from repro_torch.optim import distill as tdistill
from test_torch_qat_moe import jax_params, port_params

RTOL = 1e-6


def _logits(seed, shape=(4, 8, 32)):
    rng = np.random.default_rng(seed)
    s = rng.standard_normal(shape).astype(np.float32)
    t = rng.standard_normal(shape).astype(np.float32)
    labels = rng.integers(0, shape[-1], shape[:-1]).astype(np.int32)
    labels[0, :3] = -1
    return s, t, labels


LOSSES = {
    "kd": (lambda m, s, t, lab: m.kd_loss(s, t, temperature=3.0)),
    "hidden": (lambda m, s, t, lab: m.hidden_distill_loss(s, t)),
    "distill": (lambda m, s, t, lab: m.distill_loss(s, t, lab, alpha=0.7)),
}


@pytest.mark.parametrize("name", list(LOSSES))
def test_distillation_losses_and_gradients_match_jax(name):
    """The value and the gradients with respect to both the student's and
    the teacher's logits (or hidden states); ignored labels inside a
    row."""
    fn = LOSSES[name]
    s, t, lab = _logits(1)
    v_j, (gs_j, gt_j) = jax.value_and_grad(
        lambda a, b: fn(jdistill, a, b, jnp.asarray(lab)), argnums=(0, 1))(
            jnp.asarray(s), jnp.asarray(t))
    st, tt = (torch.tensor(a, requires_grad=True) for a in (s, t))
    v_t = fn(tdistill, st, tt, torch.from_numpy(lab))
    gs_t, gt_t = torch.autograd.grad(v_t, (st, tt))
    assert float(v_t) == pytest.approx(float(v_j), rel=RTOL)
    for g, w in ((gs_t, gs_j), (gt_t, gt_j)):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-5 * float(np.abs(w).max()))
    if name != "hidden":
        same = fn(tdistill, st, st, torch.from_numpy(lab))
        assert float(same) < float(fn(tdistill, st, -st,
                                      torch.from_numpy(lab)))


def test_calibration_set_picks_the_jax_batches():
    """The same numpy draw over the same stream: byte-equal batches, in
    step order, for several fractions, pools and seeds."""
    arch = "smollm-135m"
    js = jsyn.SyntheticStream(jbase.get_smoke_config(arch), 12, 2, seed=3)
    ts = tsyn.SyntheticStream(tbase.get_smoke_config(arch), 12, 2, seed=3)
    for kw in (dict(), dict(fraction=0.25, pool_batches=12, seed=5),
               dict(fraction=0.01, pool_batches=20, seed=1)):
        want = jcalib.calibration_set(js, **kw)
        got = tcalib.calibration_set(ts, **kw)
        assert len(got) == len(want) >= 1
        for a, b in zip(got, want):
            assert a.keys() == b.keys()
            for k in a:
                assert a[k].tobytes() == b[k].tobytes(), (kw, k)


@functools.lru_cache(maxsize=None)
def _bert():
    jcfg = jbase.get_smoke_config("bert-base-cobra")
    jm = jbuild(jcfg)
    tcfg = tbase.get_smoke_config("bert-base-cobra")
    return jm, tbuild(tcfg), jax_params(jm, 0), jcfg, tcfg


def _jax_collect(jm, cfg):
    """``tests/test_system.py``'s collector: a Python-loop forward keeping
    each layer's BiT-teacher scores and probabilities."""
    blk = JBlock(cfg, kind="attn")
    attn = blk._parts()["attn"]
    teacher = JAttn(**{**attn.__dict__, "attn_mode": "bit_softmax"})

    @jax.jit
    def collect(p, tokens):
        out = []
        x = jm._embed_tokens(p, tokens, None)
        for i in range(cfg.num_layers):
            lp = jax.tree.map(lambda t: t[i], p["blocks"])
            _, aux = teacher.qat(lp["attn"], x, collect_scores=True)
            out.append((aux["scores"], aux["probs"]))
            x, _ = blk.qat(lp, x)
        return out

    return lambda p, batch: collect(p, batch["tokens"])


def _port_collect(tm, cfg):
    blk = TBlock(cfg, kind="attn")
    attn = blk._parts()["attn"]
    teacher = TAttn(**{**attn.__dict__, "attn_mode": "bit_softmax"})

    def collect(p, batch):
        out = []
        x = tm._embed_tokens(p, torch.as_tensor(batch["tokens"]))
        for lp in p["blocks"]:
            _, aux = teacher.qat(lp["attn"], x, collect_scores=True)
            out.append((aux["scores"], aux["probs"]))
            x, _ = blk.qat(lp, x)
        return out

    return collect


@pytest.mark.parametrize("granularity", ["head", "layer"])
def test_search_and_install_thresholds_match_jax(granularity):
    """bert's smoke model on two calibration batches: per layer lambda*
    and its CDR as JAX's, then installed into each layer's
    ``attn/sps_lambda`` (JAX: one stacked leaf), other leaves shared."""
    jm, tm, params, jcfg, tcfg = _bert()
    rng = np.random.default_rng(0)
    batches = [{"tokens": rng.integers(0, jcfg.vocab_size, (2, 12)
                                       ).astype(np.int32)} for _ in range(2)]
    want = jdistill.search_model_thresholds(
        _jax_collect(jm, jcfg), jax.tree.map(jnp.asarray, params),
        [{k: jnp.asarray(v) for k, v in b.items()} for b in batches],
        granularity=granularity)
    tp = port_params(params)
    with torch.no_grad():
        got = tdistill.search_model_thresholds(
            _port_collect(tm, tcfg), tp, batches, granularity=granularity)
    assert len(got) == len(want) == jcfg.num_layers
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.lam.numpy(), np.asarray(w.lam))
        np.testing.assert_allclose(g.cdr.numpy(), np.asarray(w.cdr),
                                   rtol=0, atol=RTOL)
        assert g.granularity == granularity
    if granularity != "head":
        return
    j2 = jdistill.install_thresholds(jax.tree.map(jnp.asarray, params),
                                     want)
    t2 = tdistill.install_thresholds(tp, got)
    stacked = np.asarray(j2["blocks"]["attn"]["sps_lambda"])
    for i, layer in enumerate(t2["blocks"]):
        lam = layer["attn"]["sps_lambda"]
        assert lam.dtype == torch.float32 and lam.shape == (jcfg.num_heads,)
        np.testing.assert_array_equal(lam.numpy(), stacked[i])
        assert layer["attn"]["wq"] is tp["blocks"][i]["attn"]["wq"]
    assert tp["blocks"][0]["attn"]["sps_lambda"] is not \
        t2["blocks"][0]["attn"]["sps_lambda"]


def test_install_thresholds_into_another_stack():
    """``path`` names another layer list (an encoder's): each layer's
    lambda keeps its shape and dtype; a count that does not match the
    layers raises."""
    tm = tbuild(tbase.get_smoke_config("seamless-m4t-large-v2"))
    params = tm.init(torch.Generator().manual_seed(0))
    heads = params["encoder"][0]["attn"]["sps_lambda"].shape
    cal = [tdistill.sps_lib.SPSCalibration(
        lam=torch.full(heads, 0.05 * (i + 1)), cdr=torch.zeros(heads),
        granularity="head") for i in range(len(params["encoder"]))]
    out = tdistill.install_thresholds(params, cal, path=("encoder", "attn",
                                                         "sps_lambda"))
    for i, layer in enumerate(out["encoder"]):
        assert torch.equal(layer["attn"]["sps_lambda"],
                           torch.full(heads, 0.05 * (i + 1)))
    assert out["decoder"] is params["decoder"]
    with pytest.raises(ValueError, match="calibrations"):
        tdistill.install_thresholds(params, cal[:1],
                                    path=("encoder", "attn", "sps_lambda"))


@pytest.mark.parametrize("arch", ["mixtral-8x22b", "hymba-1.5b",
                                  "xlstm-350m", "seamless-m4t-large-v2"])
def test_cli_trains_each_family_then_resumes(arch, tmp_path, capsys):
    """``launch/train.py --device cpu --arch <arch>``: two smoke steps,
    then a rerun with the same ``--ckpt-dir`` that resumes at step 2 (in
    process, to read its state)."""
    args = ["--device", "cpu", "--arch", arch, "--batch", "2",
            "--seq-len", "8", "--ckpt-every", "1"]
    train_cli.main(["--steps", "2", "--ckpt-dir", str(tmp_path / "a"),
                    *args])
    out = capsys.readouterr().out
    assert f"[train] {arch} params=" in out and "step 1 loss" in out
    assert Checkpointer(str(tmp_path / "a")).latest_step() == 2
    resumed = train_cli.main(["--steps", "3", "--ckpt-dir",
                              str(tmp_path / "a"), *args])
    out = capsys.readouterr().out
    assert "step 2 loss" in out and "step 0 loss" not in out
    assert int(resumed.opt.step) == 3
    assert Checkpointer(str(tmp_path / "a")).manifest(3)["extra"] == {
        "data_step": 3}
    assert all(bool(torch.isfinite(t).all())
               for t in tree.leaves(resumed.params))
