"""The port's mesh trainer against its one-device trainer, on gloo worlds
of CPU ranks (``test_torch_dist_worlds.run_world``; float32 smoke
configs, the stream's batches of 8 x 16, AdamW at lr 3e-3 with the
warmup-cosine schedule).  The one-device trainer is held to
``jax.value_and_grad(train_loss)`` then ``AdamW.update`` by
``test_torch_train.py``; JAX's own mesh trainer does not run on the CPU
(ROADMAP §3).

Tolerances: a (1, 1) mesh runs the one-device arithmetic, bitwise.  On
wider meshes the data indices' gradients are summed by an all-reduce,
and the global norm and the compression's scales sum per-block partials,
so sums run in another order: losses and the reported metrics within
1e-6 relative, but the gradient norm under compression within 1e-5 (the
compressed leaves hold +-scale, and the norm's sums of many equal
squares round by the blocks they are cut into); params within
``_close_params`` (Adam's m / sqrt(v) turns a last-bit difference of a
gradient near zero into a step of up to lr: every element within 2 lr a
step, all but 1 in 1,000 within 1e-5).  The MoE runs at capacity factor
0.5, so it drops claims.  The state's bytes per rank are
exact: each leaf's whole bytes over the sizes of the axes it is split
on."""
import test_torch_threads  # noqa: F401  (first: one torch thread)
import functools

import pytest
import torch

import test_torch_dist_worlds as worlds
from repro_torch import tree

ARCH = "smollm-135m"
STEPS = 3
CASES = {"plain": {}, "accum": {"grad_accum": 2},
         "compress": {"compress_grads": True}}
MESHES = {(2, 1): 2, (1, 2): 2, (2, 2): 4, (4, 1): 4}
FAMILIES = ("hymba-1.5b", "seamless-m4t-large-v2", "mixtral-8x22b")
LOSS_RTOL, NORM_RTOL, PARAM_ATOL, PARAM_SHARE = 1e-6, 1e-5, 1e-5, 1e-3


@functools.lru_cache(maxsize=None)
def one_device(arch: str, case: str, n_steps: int, remat: str = "none"):
    tr, stream = worlds.trainer(arch, CASES[case], remat=remat)
    state, losses, metrics, drops = worlds.steps(tr, stream, tr.init_state(),
                                                 n_steps)
    return losses, metrics, drops, tree.leaves(state.params)


@functools.lru_cache(maxsize=None)
def world(size: int):
    """Every case of smollm on the meshes of ``size`` ranks (remat per
    block: each block's params gathered inside its checkpoint), and at 2
    ranks one step of each family at (2, 1): {(data, model): {case:
    rank results}}."""
    shapes = [shape for shape, n in MESHES.items() if n == size]
    archs = FAMILIES if size == 2 else ()
    tasks = [(ARCH, m, list(CASES.values()), STEPS, "block")
             for _, m in shapes] + [(arch, 1, [{}], 1) for arch in archs]
    res = worlds.run_world(size, worlds.tasks_job, tasks)
    out = {shape: {c: [r[t][i] for r in res] for i, c in enumerate(CASES)}
           for t, shape in enumerate(shapes)}
    for t, arch in enumerate(archs, len(shapes)):
        out[arch] = [r[t][0] for r in res]
    return out


def _close_params(got, want, steps):
    diffs = torch.cat([(g - w).abs().reshape(-1)
                       for g, w in zip(got, want)])
    assert float(diffs.max()) <= 2 * worlds.LR * steps
    assert float((diffs > PARAM_ATOL).double().mean()) <= PARAM_SHARE


def _close_losses(got, want, rtol=LOSS_RTOL):
    for a, b in zip(got, want):
        assert abs(a - b) <= rtol * abs(b), (got, want)


def test_one_by_one_mesh_equals_the_one_device_trainer_bitwise():
    """A (1, 1) mesh: the same draws, steps and updates, bit for bit, in
    every case (losses, every metric, every param), with no collective."""
    res = worlds.run_world(1, worlds.train_job, ARCH, 1,
                           list(CASES.values()), STEPS, "block")[0]
    for r, case in zip(res, CASES):
        losses, metrics, _, params = one_device(ARCH, case, STEPS, "block")
        assert r["losses"] == losses and r["metrics"] == metrics
        assert all(torch.equal(a, b) for a, b in zip(r["params"], params))
        assert r["collectives"] == 0


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("shape", list(MESHES), ids=lambda s: "x".join(
    map(str, s)))
def test_mesh_equals_the_one_device_trainer(shape, case):
    """Three steps of smollm on the mesh: losses and reported metrics of
    the global batch, and the whole params, equal the one-device
    trainer's within the stated tolerances; every rank reports the same
    losses; the step runs collectives."""
    ranks = world(MESHES[shape])[shape][case]
    losses, metrics, _, params = one_device(ARCH, case, STEPS, "block")
    assert all(r["losses"] == ranks[0]["losses"] for r in ranks)
    _close_losses(ranks[0]["losses"], losses)
    for key in ("loss", "tokens", "grad_norm"):
        _close_losses([m[key] for m in ranks[0]["metrics"]],
                      [m[key] for m in metrics],
                      NORM_RTOL if key == "grad_norm" and
                      case == "compress" else LOSS_RTOL)
    _close_params(ranks[0]["params"], params, STEPS)
    assert ranks[0]["collectives"] > 0


@pytest.mark.parametrize("arch", FAMILIES)
def test_each_family_steps_on_a_2x1_mesh(arch):
    """One step at (2, 1) of the hybrid, the encoder-decoder and the MoE;
    the MoE routes the global batch, so it drops the claims the
    one-device trainer drops (each rank counts its rows')."""
    ranks = world(2)[arch]
    losses, _, drops, params = one_device(arch, "plain", 1)
    _close_losses(ranks[0]["losses"], losses)
    _close_params(ranks[0]["params"], params, 1)
    assert sum(r["drops"] for r in ranks) == drops
    if arch == "mixtral-8x22b":
        assert drops > 0


def test_each_ranks_state_is_its_share():
    """Each rank holds exactly its placements' blocks of the params,
    moments and error feedback: at most the total over |mesh| plus the
    leaves left whole along some axis (the leaves FSDP and the specs
    leave unsplit, and dims an axis does not divide)."""
    for shape, n in MESHES.items():
        for case in CASES:
            for r in world(n)[shape][case]:
                assert r["local"] == r["promised"]
                assert r["local"] <= r["total"] / n + r["left_whole"]
                assert r["local"] < r["total"] / 1.5
