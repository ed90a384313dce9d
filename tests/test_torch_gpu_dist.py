"""The mesh trainer and the 1-bit all-gather on a CUDA card: the card
twin of ``test_torch_dist_train.py`` and ``test_torch_dist_ft.py`` at the
smoke config (float32), in a one-rank NCCL world of this process.

A (1, 1) mesh trains 3 steps bitwise equal to the one-device eager
trainer (deterministic algorithms on: the embedding's backward otherwise
adds with atomics); ``allreduce_1bit`` packs its sign bits with the pack
kernel (one launch a call), its words equal to the plain version's and
its result to the plain path, bitwise; the mesh trainer's params,
gathered whole, convert and serve through the Hopper kernels.

Marked ``gpu``: without a card every test skips (the decision is made in
a fixture, so every worker collects the same tests).  On a card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu_dist.py

This file imports no JAX."""
import test_torch_threads  # noqa: F401  (first: one torch thread)
import pytest
import torch
import torch.distributed as dist

from repro_torch import kernels, tree
from repro_torch.configs import get_smoke_config
from repro_torch.data.synthetic import SyntheticStream
from repro_torch.kernels.pack import ops as pack_ops, ref as pack_ref
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models.lm import build_model
from repro_torch.optim import compress
from repro_torch.optim.adamw import AdamW
from repro_torch.optim.schedules import warmup_cosine
from repro_torch.train.trainer import Trainer, TrainerConfig

pytestmark = pytest.mark.gpu

STEPS = 3


@pytest.fixture(scope="module")
def mesh():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: an NCCL world on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield mesh_lib.make_host_mesh(1, "cuda")
    finally:
        dist.destroy_process_group()


def _trainer(mesh=None, case=None):
    cfg = get_smoke_config("smollm-135m").with_(remat="block")
    opt = AdamW(lr=3e-3, schedule=warmup_cosine(1, STEPS))
    return (Trainer(build_model(cfg), opt, TrainerConfig(**(case or {})),
                    graph=False, mesh=mesh),
            SyntheticStream(cfg, 64, 8, seed=1))


def _train(trainer, stream):
    state, losses = trainer.init_state(), []
    for i in range(STEPS):
        state, m = trainer.train_step(state, stream.batch_at(i))
        losses.append(float(m["loss_total"]))
    return state, losses


@pytest.mark.parametrize("case", [{}, {"grad_accum": 2},
                                  {"compress_grads": True}],
                         ids=["plain", "accum", "compress"])
def test_one_rank_mesh_equals_the_eager_trainer_bitwise(mesh, case):
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        s_e, l_e = _train(*_trainer(case=case))
        s_m, l_m = _train(*_trainer(mesh, case))
    finally:
        torch.use_deterministic_algorithms(False)
    assert l_m == l_e
    for a, b in zip(tree.leaves((s_m.params, s_m.opt, s_m.ef)),
                    tree.leaves((s_e.params, s_e.opt, s_e.ef))):
        assert torch.equal(a, b)


def test_allreduce_1bit_packs_with_the_kernel(mesh):
    gen = torch.Generator(device="cuda").manual_seed(0)
    for n in (1, 9, 31, 32, 33, 576, 4097):
        g = torch.randn(n, generator=gen, device="cuda")
        g[::7] = 0.0
        before = pack_ops.pack_threshold.launches
        out = compress.allreduce_1bit(g)
        assert pack_ops.pack_threshold.launches == before + 1
        words = compress.sign_words(g).cpu()
        plain = pack_ref.pack_threshold(g.cpu()[None],
                                        torch.zeros(()))[0]
        assert torch.equal(words, plain)
        scale = g.abs().mean()
        assert torch.equal(out, torch.where(g >= 0, scale, -scale))


def test_mesh_trained_params_serve_through_the_kernels(mesh):
    trainer, stream = _trainer(mesh)
    state, _ = _train(trainer, stream)
    model = trainer.model
    whole = trainer.whole_params(state.params)
    kernels.reset_launch_counts()
    with torch.no_grad():
        logits = model.prefill_logits(model.convert(whole),
                                      stream.batch_at(100)["tokens"])
    assert bool(torch.isfinite(logits).all())
    assert kernels.launch_counts()["pack_threshold"] > 0
