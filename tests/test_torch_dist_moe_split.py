"""The MoE on a mesh against one device, on gloo worlds of CPU ranks
(``test_torch_dist_worlds.run_world``; the jobs in
``test_torch_moe_jobs.py``): mixtral's float32 smoke config (4 experts,
computed on the rank's positions with the stack's +-1 weights gathered
whole as sign bits) and arctic's overridden to 16 experts (expert
parallel: the claims go to their experts' ranks and back by
all-to-alls), both at capacity factor 0.5, which drops claims.

At (2, 1), (1, 2), (2, 2) and (1, 4) each rank routes its own positions
at the global batch's capacity and slots.  The trainer's first gradient:
the global batch's loss and load-balance loss (summed over the ranks'
shares) within ``test_torch_dist_train.py``'s 1e-6 relative, the ranks'
drops summed equal to one device's, every whole gradient within 5e-5 of
its leaf's largest magnitude (``test_torch_split_units.py``'s: sums over
the ranks run in another order); two steps' losses and params within
``test_torch_dist_split.py``'s tolerances.  The mesh ``prefill_logits``,
put together whole, equal the one-device logits bitwise.  A sequence
"model" does not divide stays whole on every rank (each routes every
position, its load-balance loss a width's share)."""
import test_torch_threads  # noqa: F401  (first: one torch thread)
import functools

import pytest

import test_torch_dist_worlds as worlds
import test_torch_moe_jobs as jobs
from test_torch_dist_train import _close_losses, _close_params
from test_torch_split_units import _close

SHAPES = {(2, 1): 2, (1, 2): 2, (2, 2): 4, (1, 4): 4}
NAMES = list(jobs.CONFIGS)
# the prefill's positions: 128 split into whole-word blocks over 2 and 4
# ranks; 100 do not (the whole route: every rank routes its data index's
# rows whole)
N, WHOLE_N = 128, 100


@functools.lru_cache(maxsize=None)
def one_device(name: str):
    return jobs.train_job(name)


@functools.lru_cache(maxsize=None)
def world(size: int):
    """Every task on the world of ``size`` ranks: {("train", name, shape):
    rank results, ("prefill", shape): rank results, "odd": ...}."""
    tasks, keys = [], []
    for shape, n in SHAPES.items():
        if n != size:
            continue
        for name in NAMES:
            tasks.append(("train", (name, shape[1])))
            keys.append(("train", name, shape))
        tasks.append(("prefill", (shape[1], [(name, 4, n_pos)
                                             for name in NAMES
                                             for n_pos in (N, WHOLE_N)])))
        keys.append(("prefill", shape))
    if size == 2:
        tasks.append(("odd", (2,)))
        keys.append("odd")
    res = worlds.run_world(size, jobs.tasks_job, tasks)
    return {k: [r[i] for r in res] for i, k in enumerate(keys)}


@pytest.mark.parametrize("shape", list(SHAPES), ids=lambda s: "x".join(
    map(str, s)))
@pytest.mark.parametrize("name", NAMES)
def test_mesh_train_step_equals_one_device(name, shape):
    """The first gradient and two steps on the mesh against one device:
    loss, load-balance loss, drops, every gradient, the steps' losses and
    params (see the module docstring)."""
    ranks = world(SHAPES[shape])[("train", name, shape)]
    want = one_device(name)
    assert want["drops"] > 0 and want["aux"] > 0
    for r in ranks:
        _close_losses([r["loss"], r["aux"]], [want["loss"], want["aux"]])
        assert r["drops"] == want["drops"], (name, shape)
        assert r["losses"] == ranks[0]["losses"]
    bad = [i for i, (a, b) in enumerate(zip(ranks[0]["grads"],
                                            want["grads"]))
           if not _close(b, a)]
    assert not bad, (name, shape, bad)
    _close_losses(ranks[0]["losses"], want["losses"])
    _close_params(ranks[0]["params"], want["params"], jobs.STEPS)


@pytest.mark.parametrize("name", NAMES)
def test_mesh_prefill_equals_one_device(name):
    """At every shape: each rank's logits block (its rows' block of the
    positions) put together whole equals the one-device logits, bitwise;
    the sequence is split over "model" where it is wider than one, and a
    length whose blocks would not be whole words takes the whole route,
    bitwise too."""
    for shape, n in SHAPES.items():
        for r, rank in enumerate(world(n)[("prefill", shape)]):
            for n_pos in (N, WHOLE_N):
                res = rank[(name, n_pos)]
                assert res["equal"], (name, n_pos, shape, r)
                assert res["model_dim"] == (
                    1 if shape[1] > 1 and n_pos == N else None)


def test_every_rank_runs_as_many_collectives():
    """The routes, the expert groups and the exchanges follow the shapes
    alone: every rank of a world runs as many collectives in each job."""
    for size in (2, 4):
        for key, ranks in world(size).items():
            if key == "odd":
                continue
            counts = {r["collectives"] for r in ranks}
            assert len(counts) == 1 and counts.pop() > 0, key


def test_a_sequence_model_does_not_divide_stays_whole():
    """7 positions on (1, 2): mixtral's and arctic's MoE blocks compute
    every position on every rank (the stack whole); the forward is bitwise
    the one-device block's and the gradients, summed over the ranks, its
    (each rank's load-balance loss a width's share)."""
    for rank in world(2)["odd"]:
        assert len(rank) == 2
        for r in rank:
            assert not r["seq"] and r["bitwise"] and r["grads"], r
