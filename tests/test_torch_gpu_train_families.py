"""Training the MoE, recurrent and encoder-decoder families on a CUDA
card: the card twin of ``test_torch_qat_moe.py``,
``test_torch_qat_recurrent.py``, ``test_torch_qat_encdec.py`` and
``test_torch_distill.py``.

One bfloat16 step per family at a narrow width through the captured
step; the smoke configs (float32) trained 3 steps on the card and on the
CPU from one init (losses within 1e-5 relative; params within the rule
below: the embedding's backward adds with atomics on the card); the
donating captured step's params equal the eager step's; a donated state
is overwritten while a copy of it is not; ``search_model_thresholds``
on the card gives the CPU's lambda*.

Marked ``gpu``: without a card every test skips (the decision is made in
a fixture, so every worker collects the same tests).  On a card:

    PYTHONPATH=src python -m pytest -q -m gpu \\
        tests/test_torch_gpu_train_families.py

This file imports no JAX."""
import test_torch_threads  # noqa: F401  (first: one torch thread)
import numpy as np
import pytest
import torch

from repro_torch import tree
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import MoEConfig
from repro_torch.data.calib import calibration_set
from repro_torch.data.synthetic import SyntheticStream
from repro_torch.models.attention import SPSAttention
from repro_torch.models.blocks import Block
from repro_torch.models.lm import build_model
from repro_torch.optim import distill
from repro_torch.optim.adamw import AdamW
from repro_torch.optim.schedules import warmup_cosine
from repro_torch.train.trainer import Trainer, TrainerConfig

pytestmark = pytest.mark.gpu

LR = 3e-3
LOSS_RTOL = 1e-5
# Adam's m / sqrt(v) turns a last-bit difference of a gradient near zero
# into a step of up to lr: any element within 2 lr per step, all but 1
# in 1,000 within 1e-5
PARAM_ATOL, PARAM_SHARE = 1e-5, 1e-3
FAMILIES = ("mixtral-8x22b", "hymba-1.5b", "xlstm-350m",
            "seamless-m4t-large-v2")
# one bf16 step at a narrow width: the smoke shapes with wider layers
NARROW_BF16 = dict(d_model=256, d_ff=512, compute_dtype="bfloat16",
                   remat="block")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: trains on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _cfg(arch, **kw):
    cfg = get_smoke_config(arch).with_(**{"remat": "block", **kw})
    if arch == "mixtral-8x22b":            # claims drop
        cfg = cfg.with_(moe=MoEConfig(num_experts=4, top_k=2,
                                      capacity_factor=1.25))
    return cfg


def _trainer(cfg, device="cuda", graph=True, steps=3):
    opt = AdamW(lr=LR, schedule=warmup_cosine(1, steps))
    return Trainer(build_model(cfg), opt, TrainerConfig(), device=device,
                   graph=graph)


def _params_close(a, b, steps):
    diffs = torch.cat([(x.cpu() - y.cpu()).abs().reshape(-1)
                       for x, y in zip(tree.leaves(a), tree.leaves(b))])
    assert float(diffs.max()) <= 2 * LR * steps
    assert float((diffs > PARAM_ATOL).double().mean()) <= PARAM_SHARE


@pytest.mark.parametrize("arch", FAMILIES)
def test_bf16_step_per_family(cuda, arch):
    cfg = _cfg(arch, **NARROW_BF16)
    tr = _trainer(cfg)
    state = tr.init_state()
    stream = SyntheticStream(cfg, 32, 4, seed=0)
    losses = []
    for step in range(2):
        state, m = tr.train_step(state, stream.batch_at(step))
        losses.append(float(m["loss"]))
    assert all(np.isfinite(losses)) and tr.captures == 1
    assert all(bool(torch.isfinite(p).all())
               for p in tree.leaves(state.params))


@pytest.mark.parametrize("arch", FAMILIES)
def test_card_equals_cpu(cuda, arch):
    cfg = _cfg(arch)
    card, cpu = _trainer(cfg), _trainer(cfg, "cpu")
    s_card = card.init_state()
    s_cpu = tree.map(lambda t: t.cpu(), s_card)
    stream = SyntheticStream(cfg, 64, 8, seed=1)
    for step in range(3):
        s_card, m_card = card.train_step(s_card, stream.batch_at(step))
        s_cpu, m_cpu = cpu.train_step(s_cpu, stream.batch_at(step))
        assert float(m_card["loss_total"]) == pytest.approx(
            float(m_cpu["loss_total"]), rel=LOSS_RTOL)
    _params_close(s_card.params, s_cpu.params, 3)


def test_donating_step_equals_eager_step(cuda):
    """The captured step writes params and moments into its buffers group
    by group; the eager step is functional: equal within the rule."""
    cfg = _cfg("hymba-1.5b")
    graph, eager = _trainer(cfg), _trainer(cfg, graph=False)
    s_g = graph.init_state()
    s_e = tree.map(lambda t: t.clone(), s_g)
    stream = SyntheticStream(cfg, 64, 8, seed=2)
    for step in range(2):
        s_g, m_g = graph.train_step(s_g, stream.batch_at(step))
        s_e, m_e = eager.train_step(s_e, stream.batch_at(step))
        assert float(m_g["loss_total"]) == pytest.approx(
            float(m_e["loss_total"]), rel=LOSS_RTOL)
    _params_close(s_g.params, s_e.params, 2)
    _params_close(s_g.opt.mu, s_e.opt.mu, 2)


def test_donated_state_is_overwritten_and_a_copy_is_not(cuda):
    cfg = _cfg("xlstm-350m")
    tr = _trainer(cfg)
    state = tr.init_state()
    kept = tree.map(lambda t: t.clone(), state)
    before = state.params["blocks"][0]["cell"]["w_gates"]
    new, _ = tr.train_step(state, SyntheticStream(cfg, 32, 4).batch_at(0))
    assert new.params["blocks"][0]["cell"]["w_gates"] is before
    assert not torch.equal(before, kept.params["blocks"][0]["cell"][
        "w_gates"])
    assert int(kept.opt.step) == 0 and all(
        not bool(m.any()) for m in tree.leaves(kept.opt.mu))
    # a state that is not the graph's is copied in and left as it was
    again, _ = tr.train_step(kept, SyntheticStream(cfg, 32, 4).batch_at(0))
    assert again.params["blocks"][0]["cell"]["w_gates"] is before
    assert int(kept.opt.step) == 0


def test_search_model_thresholds_on_card_equals_cpu(cuda):
    """bert's smoke model in BiT-softmax mode: the per-layer scores and
    probabilities on the card and on the CPU give the same lambda*."""
    cfg = get_smoke_config("bert-base-cobra")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    stream = SyntheticStream(cfg, 12, 2, seed=0)
    batches = calibration_set(stream, fraction=0.1, pool_batches=20)

    def collect(p, batch):
        dev = p["embed"]["embedding"].device
        x = model._embed_tokens(p, torch.as_tensor(batch["tokens"],
                                                   device=dev))
        blk = Block(cfg, kind="attn")
        attn = blk._parts()["attn"]
        teacher = SPSAttention(**{**attn.__dict__,
                                  "attn_mode": "bit_softmax"})
        out = []
        for lp in p["blocks"]:
            _, aux = teacher.qat(lp["attn"], x, collect_scores=True)
            out.append((aux["scores"], aux["probs"]))
            x, _ = blk.qat(lp, x)
        return out

    with torch.no_grad():
        on_cpu = distill.search_model_thresholds(collect, params, batches)
        on_card = distill.search_model_thresholds(
            collect, tree.map(lambda t: t.cuda(), params), batches)
    for a, b in zip(on_card, on_cpu):
        assert torch.equal(a.lam.cpu(), b.lam)
    installed = distill.install_thresholds(
        tree.map(lambda t: t.cuda(), params), on_card)
    assert installed["blocks"][0]["attn"]["sps_lambda"].device.type == \
        "cuda"
