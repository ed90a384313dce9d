"""The mesh prefill against the one-device prefill on a real process group.

Every rank draws the same deploy params and inputs from ``--seed``, runs
the one-device ``prefill_logits`` on its own device, then the mesh
``prefill_logits`` on its placed blocks of the params and its rows of the
batch (split along "model" by the sequence where the length allows:
``models.lm._OnMesh``), puts the mesh logits together whole by their
placement and compares.  Rank 0 prints one JSON line: the route (the dim
of the logits split along "model": 1 the positions, 2 the vocabulary,
null a stack computed whole), bitwise equality, the largest absolute
difference, the greedy tokens' agreement, the collectives a rank ran, a
MoE's routing (experts, top-k, capacity factor: ``--capacity-factor``
sets a dropping one), and with ``--iters`` the mesh and one-device
prefills' times (CUDA events on the card, the wall on the CPU; the
mesh's includes its collectives).

  PYTHONPATH=src python -m torch.distributed.run --standalone \\
      --nproc-per-node 4 -m repro_torch.launch.mesh_prefill \\
      --arch qwen1.5-32b --layers 2 --model-parallel 4 --batch 2 \\
      --positions 1024

runs one card a rank (``--arch mixtral-8x22b --layers 2 --batch 2
--positions 2048``: each of 4 ranks routes its 1,024 positions at the
global batch's capacity and slots, its experts whole) (nccl); ``--device cpu --smoke`` the smoke config on
gloo ranks.  ``--positions`` counts a frontend's patches (internvl2) and
is an encoder-decoder's frame count too.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Optional, Sequence

import torch

from repro_torch import resolve_device
from repro_torch.configs import base
from repro_torch.launch import mesh as mesh_lib, specs
from repro_torch.models.lm import EncDecModel, build_model


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default="smollm-135m",
                   choices=list(base.ARCH_IDS))
    p.add_argument("--smoke", action="store_true",
                   help="the reduced same-family config (CPU scale)")
    p.add_argument("--layers", type=int, default=0,
                   help="the first N layers (each stack's); 0: all")
    p.add_argument("--model-parallel", type=int, default=1)
    p.add_argument("--batch", type=int, default=2)
    p.add_argument("--positions", type=int, default=512)
    p.add_argument("--iters", type=int, default=0,
                   help="timed prefills of each kind after one warm-up")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--capacity-factor", type=float, default=0.0,
                   help="a MoE's capacity factor (0: the config's)")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def _config(args):
    cfg = (base.get_smoke_config if args.smoke else base.get_config)(
        args.arch)
    if args.layers:
        cfg = cfg.with_(num_layers=args.layers, **(
            {"num_encoder_layers": args.layers}
            if cfg.num_encoder_layers else {}))
    if args.capacity_factor and cfg.moe.num_experts:
        cfg = cfg.with_(moe=dataclasses.replace(
            cfg.moe, capacity_factor=args.capacity_factor))
    return cfg


def _rows(mesh, t: torch.Tensor) -> torch.Tensor:
    """This rank's placed rows of the global ``t``."""
    pl = mesh_lib.Placement(mesh, specs._batch_spec(mesh, tuple(t.shape),
                                                    t.shape[0]), t.shape)
    return mesh_lib.place(pl.shard(t), pl)


def _timed(fn, iters: int, device: torch.device) -> float:
    """ms a call of ``fn``, the mean of ``iters`` after one warm-up."""
    fn()
    if device.type == "cuda":
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "ab")
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return 1e3 * (time.perf_counter() - t0) / iters


def run(args) -> dict:
    dev = resolve_device(args.device)
    mesh = mesh_lib.make_host_mesh(args.model_parallel, dev)
    cfg = _config(args)
    model = build_model(cfg)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    dparams = model.init_deploy(gen, device=dev)
    host = torch.Generator().manual_seed(args.seed + 1)
    encdec = isinstance(model, EncDecModel)
    f = 0 if encdec else cfg.frontend_tokens
    tokens = torch.randint(0, cfg.vocab_size, (args.batch,
                                               args.positions - f),
                           generator=host, dtype=torch.int32).to(dev)
    fe = {}
    if cfg.frontend_tokens:
        fe["frontend_embeds"] = torch.randn(
            args.batch, args.positions if encdec else f, model.frontend_dim,
            generator=host).to(dev)
    local = mesh_lib.shard_tree(mesh, model.deploy_specs(), dparams)
    toks = _rows(mesh, tokens)
    fe_rows = {k: _rows(mesh, v) for k, v in fe.items()}
    with torch.inference_mode():
        want = model.prefill_logits(dparams, tokens, device=dev, **fe)
        before = mesh.collectives
        got = model.prefill_logits(local, toks, mesh=mesh, **fe_rows)
        ran = mesh.collectives - before
        pl = mesh_lib.placement_of(got)
        whole = pl.whole(got)[..., :cfg.vocab_size]
        out = {"arch": args.arch, "mesh": dict(mesh.shape),
               "layers": cfg.num_layers, "batch": args.batch,
               "positions": args.positions,
               "route": pl.dims.get("model"),
               "bitwise": bool(torch.equal(whole, want)),
               "max_abs_err": float((whole - want).abs().max()),
               "tokens_equal": bool(torch.equal(whole.argmax(-1),
                                                want.argmax(-1))),
               "collectives": ran}
        if cfg.moe.num_experts:
            out["moe"] = {"experts": cfg.moe.num_experts,
                          "top_k": cfg.moe.top_k,
                          "capacity_factor": cfg.moe.capacity_factor}
        del whole, got
        if args.iters:
            out["mesh_ms"] = _timed(lambda: model.prefill_logits(
                local, toks, mesh=mesh, **fe_rows), args.iters, dev)
            out["one_device_ms"] = _timed(lambda: model.prefill_logits(
                dparams, tokens, device=dev, **fe), args.iters, dev)
    return out


def main(argv: Optional[Sequence[str]] = None) -> None:
    import torch.distributed as dist
    out = run(parse_args(argv))
    if dist.get_rank() == 0:
        print(json.dumps(out), flush=True)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
