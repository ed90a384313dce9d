"""Gloo worlds for the port's mesh tests (no tests here).

``run_world(n, job, *args)`` spawns ``n`` ranks (one torch thread each),
joins them in a gloo process group over a file store, runs ``job(*args)``
on every rank and returns the ranks' results in rank order.  The jobs live
here, in a module that imports neither JAX nor a test file that does, so
a spawned rank starts from torch and the port alone."""
import test_torch_threads  # noqa: F401  (first: one torch thread)
import dataclasses
import os
import tempfile

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch import tree
from repro_torch.checkpoint.ckpt import Checkpointer
from repro_torch.configs import base
from repro_torch.data.synthetic import SyntheticStream
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import ffn
from repro_torch.models.lm import build_model
from repro_torch.optim import compress
from repro_torch.optim.adamw import AdamW
from repro_torch.optim.schedules import warmup_cosine
from repro_torch.train import ft
from repro_torch.train.trainer import Trainer, TrainerConfig

LR = 3e-3
SEQ, BATCH = 16, 8


def _rank_main(rank, world, store, out, job, args):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        torch.save(job(*args), f"{out}.{rank}")
    finally:
        dist.destroy_process_group()


def run_world(n: int, job, *args):
    """``job(*args)`` on each of ``n`` spawned gloo ranks; their results."""
    with tempfile.TemporaryDirectory() as d:
        mp.start_processes(_rank_main, args=(n, os.path.join(d, "store"),
                                             os.path.join(d, "out"), job,
                                             args),
                           nprocs=n, start_method="spawn", join=True)
        return [torch.load(os.path.join(d, f"out.{r}"), weights_only=False)
                for r in range(n)]


# a MoE's capacity factor that drops claims at the smoke batch
MOE_CF = 0.5


def config(arch: str, remat: str = "none"):
    cfg = base.get_smoke_config(arch).with_(remat=remat)
    if cfg.moe.num_experts:
        cfg = cfg.with_(moe=dataclasses.replace(cfg.moe,
                                                capacity_factor=MOE_CF))
    return cfg


def trainer(arch: str, case: dict, mesh=None, remat: str = "none"):
    """The case's trainer (one device without ``mesh``) and stream."""
    cfg = config(arch, remat)
    opt = AdamW(lr=LR, schedule=warmup_cosine(2, 10))
    tr = Trainer(build_model(cfg), opt, TrainerConfig(**case), device="cpu",
                 mesh=mesh)
    return tr, SyntheticStream(cfg, SEQ, BATCH, seed=0)


class Drops:
    """Counts the dropped claims of every ``BinaryMoE._route`` call."""

    def __enter__(self):
        self.dropped, orig = 0, ffn.BinaryMoE._route
        self._orig = orig

        def route(moe, params, x2, *args):
            out = orig(moe, params, x2, *args)
            self.dropped += int((~out[3]).sum())
            return out
        ffn.BinaryMoE._route = route
        return self

    def __exit__(self, *exc):
        ffn.BinaryMoE._route = self._orig


def steps(tr, stream, state, n: int, first: int = 0):
    """``n`` steps from batch ``first``: (state, losses, metrics, drops)."""
    losses, metrics = [], []
    with Drops() as drops:
        for i in range(first, first + n):
            state, m = tr.train_step(state, stream.batch_at(i))
            losses.append(float(m["loss_total"]))
            metrics.append({k: float(v) for k, v in m.items()})
    return state, losses, metrics, drops.dropped


def train_job(arch: str, model_axis: int, cases, n_steps: int,
              remat: str = "none"):
    """Each case (TrainerConfig kwargs) trained ``n_steps`` on a
    (world / model_axis, model_axis) mesh; per case: losses, metrics,
    drops, whole params (rank 0), this rank's state bytes and the bytes
    its placements promise, and the collectives per step."""
    mesh = mesh_lib.make_host_mesh(model_axis, "cpu")
    out = []
    for case in cases:
        tr, stream = trainer(arch, case, mesh, remat)
        state = tr.init_state()
        before = mesh.collectives
        state, losses, metrics, drops = steps(tr, stream, state, n_steps)
        per_step = (mesh.collectives - before) / n_steps
        whole = [t.clone() for t in tree.leaves(tr.whole_params(
            state.params))]
        per_param = [state.params, state.opt.mu, state.opt.nu, state.ef]
        local = sum(t.numel() * t.element_size()
                    for t in tree.leaves(per_param))
        promised = whole_bytes = left_whole = 0
        for sub in per_param:
            for path, t in tree.leaves_with_paths(sub):
                pl = tr.placement(path)
                full = int(np.prod(pl.shape)) * t.element_size()
                promised += full * t.numel() // int(np.prod(pl.shape))
                whole_bytes += full
                if len(pl.dims) < sum(n > 1 for n in mesh.shape.values()):
                    left_whole += full      # whole along some axis
        out.append(dict(losses=losses, metrics=metrics, drops=drops,
                        params=whole if mesh.rank == 0 else None,
                        local=local, promised=promised, total=whole_bytes,
                        left_whole=left_whole,
                        collectives=per_step))
    return out


def tasks_job(tasks):
    """``train_job(*task)`` for each task, in one world."""
    return [train_job(*task) for task in tasks]


def elastic_save_job(arch: str, model_axis: int, directory: str,
                     n_steps: int):
    """``ft.run`` for ``n_steps`` on a mesh, checkpointing at the end;
    the whole params after (rank 0)."""
    mesh = mesh_lib.make_host_mesh(model_axis, "cpu")
    tr, stream = trainer(arch, {}, mesh)
    state = ft.run(tr, stream, Checkpointer(directory), steps=n_steps,
                   ckpt_every=0, log_every=100, log_fn=lambda s: None)
    whole = tr.whole_params(state.params)
    return [t.clone() for t in tree.leaves(whole)] if mesh.rank == 0 \
        else None


def elastic_restore_job(arch: str, model_axis: int, directory: str):
    """``ft.elastic_restore`` onto a mesh, the checkpoint's manifest
    checked against the restored state, then one step: (whole params
    restored, data step, leaves verified, loss, whole params after)."""
    mesh = mesh_lib.make_host_mesh(model_axis, "cpu")
    tr, stream = trainer(arch, {}, mesh)
    ckpt = Checkpointer(directory)
    state, data_step, _ = ft.elastic_restore(ckpt, tr)
    verified = ckpt.verify(ckpt.latest_step(), state, tr.layout)
    restored = [t.clone() for t in tree.leaves(tr.whole_params(
        state.params))]
    state, losses, _, _ = steps(tr, stream, state, 1, data_step)
    after = [t.clone() for t in tree.leaves(tr.whole_params(state.params))]
    return restored, data_step, verified, losses[0], after


def allreduce_1bit_job(g: np.ndarray):
    """``allreduce_1bit`` of this rank's row of ``g``."""
    local = torch.from_numpy(g[dist.get_rank()])
    return compress.allreduce_1bit(local).numpy()
