"""Training on a CUDA card: the card twin of ``test_torch_qat_lm.py`` and
``test_torch_train.py``.

A few bfloat16 steps of smollm-135m at full width (through the captured
step); the captured step against the eager step; the smoke config
(float32) trained 3 steps on the card and on the CPU from one init
(losses within 1e-5 relative, params within the rule below); the QAT
logits against the deploy logits (our kernels) within JAX's 2e-3; a
restart from a card checkpoint equal to an uninterrupted run; a card
state restored bitwise.

Marked ``gpu``: without a card every test skips (the decision is made in
a fixture, so every worker collects the same tests).  On a card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu_train.py

This file imports no JAX."""
import test_torch_threads  # noqa: F401  (first: one torch thread)
import numpy as np
import pytest
import torch

from repro_torch import tree
from repro_torch.checkpoint.ckpt import Checkpointer
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data.synthetic import SyntheticStream
from repro_torch.models.lm import build_model
from repro_torch.optim.adamw import AdamW
from repro_torch.optim.schedules import warmup_cosine
from repro_torch.train import ft
from repro_torch.train.trainer import Trainer, TrainerConfig

pytestmark = pytest.mark.gpu

LR = 3e-3
LOSS_RTOL = 1e-5
# Adam's m / sqrt(v) turns a last-bit difference of a gradient near zero
# into a step of up to lr: any element within 2 lr per step, all but 1
# in 1,000 within 1e-5
PARAM_ATOL, PARAM_SHARE = 1e-5, 1e-3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: trains on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _narrow(device="cuda", graph=True, steps=3):
    cfg = get_smoke_config("smollm-135m").with_(remat="block")
    opt = AdamW(lr=LR, schedule=warmup_cosine(1, steps))
    return (Trainer(build_model(cfg), opt, TrainerConfig(), device=device,
                    graph=graph), SyntheticStream(cfg, 64, 8, seed=1))


def _params_close(a, b, steps):
    diffs = torch.cat([(x.cpu() - y.cpu()).abs().reshape(-1)
                       for x, y in zip(tree.leaves(a), tree.leaves(b))])
    assert float(diffs.max()) <= 2 * LR * steps
    assert float((diffs > PARAM_ATOL).double().mean()) <= PARAM_SHARE


def test_full_width_bf16_steps(cuda):
    cfg = get_config("smollm-135m")
    stream = SyntheticStream(cfg, 64, 4, seed=0)
    tr = Trainer(build_model(cfg), AdamW(lr=LR), TrainerConfig())
    state = tr.init_state()
    losses = []
    for step in range(3):
        state, m = tr.train_step(state, stream.batch_at(step))
        losses.append(float(m["loss"]))
    assert all(np.isfinite(losses)) and tr.captures == 1
    assert int(state.opt.step) == 3
    assert state.params["blocks"][0]["attn"]["wq"]["w_latent"].dtype == \
        torch.float32


def test_captured_step_equals_eager_step(cuda):
    graph, stream = _narrow()
    eager, _ = _narrow(graph=False)
    s_g = graph.init_state()
    s_e = tree.map(lambda t: t.clone(), s_g)
    for step in range(2):
        s_g, m_g = graph.train_step(s_g, stream.batch_at(step))
        s_e, m_e = eager.train_step(s_e, stream.batch_at(step))
        assert float(m_g["loss_total"]) == pytest.approx(
            float(m_e["loss_total"]), rel=LOSS_RTOL)
    _params_close(s_g.params, s_e.params, 2)
    assert graph.captures == 1


def test_card_equals_cpu(cuda):
    card, stream = _narrow()
    cpu, _ = _narrow("cpu")
    s_card = card.init_state()
    s_cpu = tree.map(lambda t: t.cpu(), s_card)
    for step in range(3):
        s_card, m_card = card.train_step(s_card, stream.batch_at(step))
        s_cpu, m_cpu = cpu.train_step(s_cpu, stream.batch_at(step))
        assert float(m_card["loss_total"]) == pytest.approx(
            float(m_cpu["loss_total"]), rel=LOSS_RTOL)
    _params_close(s_card.params, s_cpu.params, 3)


def test_qat_logits_equal_deploy_logits_on_card(cuda):
    tr, stream = _narrow()
    state = tr.init_state()
    state, _ = tr.train_step(state, stream.batch_at(0))
    toks = stream.batch_at(5)["tokens"]
    with torch.no_grad():
        qat = tr.model.qat_logits(state.params, toks)
        dep = tr.model.prefill_logits(tr.model.convert(state.params), toks)
    assert float((qat - dep).abs().max()) <= 2e-3
    assert torch.equal(qat.argmax(-1), dep.argmax(-1))


def test_restart_on_card_equals_uninterrupted(cuda, tmp_path):
    seen = {"a": {}, "b": {}}

    def rec(tag):
        return lambda step, m, dt: seen[tag].update(
            {step: float(m["loss_total"])})

    tr, stream = _narrow(steps=4)
    ft.run(tr, stream, Checkpointer(str(tmp_path / "a")), steps=4,
           ckpt_every=2, log_fn=lambda m: None, on_step=rec("a"))
    ck = Checkpointer(str(tmp_path / "b"))
    tr, stream = _narrow(steps=4)
    ft.run(tr, stream, ck, steps=2, ckpt_every=2, log_fn=lambda m: None,
           on_step=rec("b"))
    tr, stream = _narrow(steps=4)
    state, data_step, _ = ft.restore_or_init(tr, ck)
    assert ck.verify(2, state) == len(tree.leaves(state)) and data_step == 2
    ft.run(tr, stream, ck, steps=4, ckpt_every=2, log_fn=lambda m: None,
           on_step=rec("b"))
    assert sorted(seen["b"]) == [0, 1, 2, 3]
    for step in range(4):
        assert seen["b"][step] == pytest.approx(seen["a"][step],
                                                rel=LOSS_RTOL)


def test_card_state_round_trips_bitwise(cuda, tmp_path):
    tr, _ = _narrow()
    state = tr.init_state()
    ck = Checkpointer(str(tmp_path))
    ck.save(1, state)
    ck.wait()
    got, _ = ck.restore(1, tree.map(torch.zeros_like, state))
    for a, b in zip(tree.leaves(got), tree.leaves(state)):
        assert a.device == b.device and torch.equal(a, b)
    assert ck.verify(1, got) == len(tree.leaves(state))
