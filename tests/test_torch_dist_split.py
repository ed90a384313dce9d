"""The mesh trainer with its compute split along "model" (attention by
query heads, the FFN by d_ff columns, the residual stream by sequence)
against the one-device trainer, on gloo worlds of CPU ranks
(``test_torch_dist_worlds.run_world``; the float32 smoke configs, the
stream's batches of 8 x 16, AdamW at lr 3e-3 with the warmup-cosine
schedule), under ``test_torch_dist_train.py``'s tolerances: losses and
the reported metrics within 1e-6 relative (the gradient norm under
compression within 1e-5), params within ``_close_params`` (every element
within 2 lr a step, all but 1 in 1,000 within 1e-5).

smollm's three cases (plain, accumulation, compression) at (1, 2), (2, 2)
and (1, 4) (3 heads over 4 ranks: one rank holds none, and its one KV
head is read on every rank), and one step at (1, 2) of each other family:
granite (KV heads shared by two ranks), qwen (the QKV bias), gemma
(windows), internvl2 (the frontend's 8 positions ahead of the sequence,
which carry no label), seamless (encoder, decoder, cross-attention over
the memory gathered whole), hymba (the Mamba branch), xlstm (recurrent
cells) and mixtral (the MoE, which each "model" rank routes and runs on
its own positions at the global batch's capacity and slots: the ranks'
drops sum to the one-device trainer's, and their load-balance losses'
shares to its loss).  Each rank's state is its placements' share, as
before the split."""
import test_torch_threads  # noqa: F401  (first: one torch thread)
import functools

import pytest

import test_torch_dist_worlds as worlds
from test_torch_dist_train import (ARCH, CASES, LOSS_RTOL, NORM_RTOL, STEPS,
                                   _close_losses, _close_params, one_device)

MESHES = {(1, 2): 2, (2, 2): 4, (1, 4): 4}
FAMILIES = ("granite-3-2b", "qwen1.5-32b", "gemma3-27b", "internvl2-76b",
            "seamless-m4t-large-v2", "hymba-1.5b", "xlstm-350m",
            "mixtral-8x22b")


@functools.lru_cache(maxsize=None)
def world(size: int):
    """smollm's cases on the meshes of ``size`` ranks (remat per block),
    and at 2 ranks one step of each family at (1, 2): {(data, model):
    {case: rank results}, arch: rank results}."""
    shapes = [shape for shape, n in MESHES.items() if n == size]
    archs = FAMILIES if size == 2 else ()
    tasks = [(ARCH, m, list(CASES.values()), STEPS, "block")
             for _, m in shapes] + [(arch, 2, [{}], 1) for arch in archs]
    res = worlds.run_world(size, worlds.tasks_job, tasks)
    out = {shape: {c: [r[t][i] for r in res] for i, c in enumerate(CASES)}
           for t, shape in enumerate(shapes)}
    for t, arch in enumerate(archs, len(shapes)):
        out[arch] = [r[t][0] for r in res]
    return out


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("shape", list(MESHES), ids=lambda s: "x".join(
    map(str, s)))
def test_split_mesh_equals_the_one_device_trainer(shape, case):
    """Three steps of smollm: every rank reports the global batch's losses
    and metrics, which equal the one-device trainer's, and the whole params
    equal its params, within the stated tolerances."""
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
def test_each_family_steps_split_at_1x2(arch):
    """One step of the family at (1, 2): losses, reported metrics and
    params equal the one-device trainer's; a MoE's ranks drop, between
    them, the claims the one-device trainer drops."""
    ranks = world(2)[arch]
    losses, metrics, drops, params = one_device(arch, "plain", 1)
    _close_losses(ranks[0]["losses"], losses)
    for key in ("loss", "tokens", "moe_aux"):
        _close_losses([m[key] for m in ranks[0]["metrics"]],
                      [m[key] for m in metrics])
    _close_params(ranks[0]["params"], params, 1)
    assert sum(r["drops"] for r in ranks) == drops
    if arch == "mixtral-8x22b":
        assert drops > 0 and metrics[0]["moe_aux"] > 0


def test_each_ranks_state_is_its_share_under_the_split():
    """The split moves compute, not state: each rank holds exactly its
    placements' blocks of the params, moments and error feedback, as
    without it (at most the total over |mesh| plus the leaves left whole
    along some axis)."""
    for shape, n in MESHES.items():
        for case in CASES:
            for r in world(n)[shape][case]:
                assert r["local"] == r["promised"]
                assert r["local"] <= r["total"] / n + r["left_whole"]
                assert r["local"] < r["total"] / 1.5
