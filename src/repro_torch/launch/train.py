"""Training launcher CLI of the port (flags of ``repro.launch.train``,
plus ``--device``).

  PYTHONPATH=src python -m repro_torch.launch.train --full --steps 200 \
      --seq-len 128 --batch 16 --ckpt-dir ckpt

trains the arch (smollm-135m by default; every arch of ``ARCH_IDS``: the
dense, MoE, hybrid, xLSTM and encoder-decoder families) at full width on
the card; without ``--full`` the smoke (reduced) config.  ``--device
cpu`` runs the same loop on the CPU; without a card and without it the
CLI exits with a clear error.  Rerun with the same ``--ckpt-dir`` to
resume from its newest committed step.

Under torchrun (its ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``), or with
``--model-parallel`` m other than 1, the trainer runs on a (world / m, m)
(data, model) mesh of the process group (nccl on the card, gloo with
``--device cpu``; without torchrun's environment the world is this
process alone):

  PYTHONPATH=src python -m torch.distributed.run --standalone \
      --nproc-per-node 4 -m repro_torch.launch.train --device cpu \
      --model-parallel 2 --steps 4 --batch 4 --seq-len 16
"""
from __future__ import annotations

import argparse
import os
import tempfile
from typing import Optional, Sequence, Tuple

import torch

from repro_torch import resolve_device, tree
from repro_torch.checkpoint.ckpt import Checkpointer
from repro_torch.configs import base
from repro_torch.data.synthetic import SyntheticStream
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.lm import build_model
from repro_torch.optim.adamw import AdamW
from repro_torch.optim.schedules import warmup_cosine
from repro_torch.train import ft
from repro_torch.train.trainer import Trainer, TrainerConfig, TrainState


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default="smollm-135m",
                   choices=list(base.ARCH_IDS))
    p.add_argument("--smoke", action="store_true", default=True,
                   help="use the reduced same-family config (CPU scale)")
    p.add_argument("--full", dest="smoke", action="store_false")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--seq-len", type=int, default=128)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--lr", type=float, default=3e-3)
    p.add_argument("--grad-accum", type=int, default=1)
    p.add_argument("--compress-grads", action="store_true")
    p.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    p.add_argument("--ckpt-every", type=int, default=50)
    p.add_argument("--model-parallel", type=int, default=1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; exits without a card) or cpu")
    return p.parse_args(argv)


def build(args: argparse.Namespace
          ) -> Tuple[Trainer, SyntheticStream, Checkpointer]:
    """The trainer, the data stream and the checkpointer the CLI runs."""
    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(f"[train] {e}")
    mesh = None
    if args.model_parallel != 1 or "WORLD_SIZE" in os.environ:
        try:
            mesh = make_host_mesh(args.model_parallel, dev)
        except ValueError as e:
            raise SystemExit(f"[train] --model-parallel "
                             f"{args.model_parallel}: {e}")
    cfg = (base.get_smoke_config(args.arch) if args.smoke
           else base.get_config(args.arch))
    opt = AdamW(lr=args.lr, schedule=warmup_cosine(args.steps // 10 + 1,
                                                   args.steps),
                moment_dtype=getattr(torch, cfg.optim_moment_dtype))
    trainer = Trainer(build_model(cfg), opt,
                      TrainerConfig(grad_accum=args.grad_accum,
                                    compress_grads=args.compress_grads,
                                    seed=args.seed), device=dev, mesh=mesh)
    stream = SyntheticStream(cfg, args.seq_len, args.batch, seed=args.seed)
    return trainer, stream, Checkpointer(args.ckpt_dir)


def param_count(state: TrainState) -> int:
    return sum(p.numel() for p in tree.leaves(state.params))


def main(argv: Optional[Sequence[str]] = None) -> TrainState:
    args = parse_args(argv)
    trainer, stream, ckpt = build(args)
    n = param_count(trainer.init_state())
    where = trainer.device if trainer.mesh is None else trainer.mesh
    if trainer.rank == 0:
        print(f"[train] {trainer.model.cfg.name} params={n:,} "
              f"{'on this rank ' if trainer.mesh else ''}device={where} "
              f"steps={args.steps}")
    return ft.run(trainer, stream, ckpt, steps=args.steps,
                  ckpt_every=args.ckpt_every)


if __name__ == "__main__":
    main()
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
