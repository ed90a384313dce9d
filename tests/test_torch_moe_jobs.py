"""Gloo-world jobs of the MoE on a mesh (no tests here;
``test_torch_dist_moe_split.py`` runs them through
``test_torch_dist_worlds.run_world``).  Like that module, this one imports
neither JAX nor a test file that does, so a spawned rank starts from
torch and the port alone.

The configs: the float32 smoke configs of mixtral (4 experts,
``expert_parallel`` off) and of arctic overridden to 16 experts (so
``expert_parallel`` holds and its stack splits by expert over "model"),
both at ``worlds.MOE_CF`` (0.5), which drops claims.

``train_job(name, model_axis)`` takes one gradient of the trainer on a
(world / model_axis, model_axis) mesh (``model_axis`` None: one device,
no process group) and then two steps: the global batch's loss and
load-balance loss, the drops summed over the ranks, the whole gradients,
the losses of the steps and the whole params after.  ``prefill_job``
runs the mesh ``prefill_logits`` against the one-device one
(``test_torch_prefill_jobs.run_case``); ``odd_job`` a MoE block at a
length "model" does not divide (``test_torch_split_units.block_case``)."""
import test_torch_threads  # noqa: F401  (first: one torch thread)
import dataclasses

import torch

import test_torch_dist_worlds as worlds
import test_torch_prefill_jobs as pjobs
from repro_torch import tree
from repro_torch.data.synthetic import SyntheticStream
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models.lm import build_model
from repro_torch.optim.adamw import AdamW
from repro_torch.optim.schedules import warmup_cosine
from repro_torch.train.trainer import Trainer, TrainerConfig

# name -> (arch, experts: 0 keeps the smoke config's)
CONFIGS = {"mixtral-8x22b": ("mixtral-8x22b", 0),
           "arctic 16 experts": ("arctic-480b", 16)}
STEPS = 2


def config(name: str):
    arch, experts = CONFIGS[name]
    cfg = worlds.config(arch)
    if experts:
        cfg = cfg.with_(moe=dataclasses.replace(cfg.moe,
                                                num_experts=experts))
    return cfg


def _world_sum(mesh, t: torch.Tensor) -> float:
    if mesh is None:
        return float(t)
    return float(mesh.all_reduce(t.detach().clone().reshape(1), None)[0])


def train_job(name: str, model_axis=None):
    """One gradient, then ``STEPS`` steps (see the module docstring)."""
    cfg = config(name)
    mesh = (None if model_axis is None else
            mesh_lib.make_host_mesh(model_axis, "cpu"))
    tr = Trainer(build_model(cfg), AdamW(lr=worlds.LR,
                                         schedule=warmup_cosine(2, 10)),
                 TrainerConfig(), device="cpu", mesh=mesh)
    stream = SyntheticStream(cfg, worlds.SEQ, worlds.BATCH, seed=0)
    state = tr.init_state()
    batch = tr.batch_on_device(stream.batch_at(0))
    with worlds.Drops() as drops:
        loss, metrics, grads = tr.loss_and_grads(state.params, batch)
    whole = [t.clone() for t in tree.leaves(tr.whole_params(grads))]
    out = dict(loss=_world_sum(mesh, loss),
               aux=_world_sum(mesh, metrics["moe_aux"]),
               drops=int(_world_sum(mesh, torch.tensor(float(
                   drops.dropped)))),
               collectives=None if mesh is None else mesh.collectives)
    state, losses, _, _ = worlds.steps(tr, stream, state, STEPS)
    params = [t.clone() for t in tree.leaves(tr.whole_params(
        state.params))]
    rank0 = mesh is None or mesh.rank == 0
    out.update(grads=whole if rank0 else None, losses=losses,
               params=params if rank0 else None)
    return out


def prefill_job(model_axis: int, cases):
    """Each case (name, batch, positions) of ``CONFIGS`` on a (world /
    model_axis, model_axis) mesh: ``run_case``'s results by (name,
    positions) (the logits dropped), and the mesh's collectives over all
    of them."""
    mesh = mesh_lib.make_host_mesh(model_axis, "cpu")
    out = {}
    for name, batch, n in cases:
        res = pjobs.run_case(mesh, config(name), batch, n)
        del res["logits"]
        out[(name, n)] = res
    out["collectives"] = mesh.collectives
    return out


def odd_job(model_axis: int):
    """Each config's MoE block under the split at ``ODD`` positions (a
    sequence "model" does not divide) against the one-device block
    (``test_torch_split_units.block_case``)."""
    import test_torch_split_units as units
    mesh = mesh_lib.make_host_mesh(model_axis, "cpu")
    return [units.block_case(mesh, build_model(config(name))._block(),
                             units.ODD) for name in CONFIGS]


def tasks_job(tasks):
    """Each task (job name, args) in one world."""
    jobs = {"train": train_job, "prefill": prefill_job, "odd": odd_job}
    return [jobs[name](*args) for name, args in tasks]
