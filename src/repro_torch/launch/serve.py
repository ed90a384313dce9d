"""Serving launcher CLI of the port: deploy params drawn layer by layer
(``init_deploy``) + static batched generation on the card (or, with
``--device cpu``, the plain versions).

  PYTHONPATH=src python -m repro_torch.launch.serve --device cuda \
      --batch 4 --prompt-len 16 --new-tokens 32

Flags mirror ``repro.launch.serve`` (smoke-size config of ``--arch``),
plus ``--device`` and ``--sps-granularity`` (the config's by default;
``row`` reads a 512-column threshold table per head at each position).
An arch with a frontend stub (internvl2-76b, seamless-m4t-large-v2) gets
its ``frontend_embeds`` as standard normals drawn from ``--seed`` after
the prompts, and ``max_len`` covers its frontend tokens too, as the JAX
CLI does.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import base
from repro_torch.models.lm import build_model
from repro_torch.serve.engine import CacheConfig, ServeConfig, ServeEngine


def main(argv: Optional[Sequence[str]] = None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default="smollm-135m",
                   choices=list(base.ARCH_IDS))
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--prompt-len", type=int, default=16)
    p.add_argument("--new-tokens", type=int, default=32)
    p.add_argument("--max-len", type=int, default=0)
    p.add_argument("--sampler", default="greedy",
                   choices=["greedy", "temperature", "top_k"])
    p.add_argument("--temperature", type=float, default=0.8)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    p.add_argument("--sps-granularity", default=None,
                   choices=["layer", "head", "row"],
                   help="SPS threshold granularity (default: the config's)")
    args = p.parse_args(argv)

    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(f"[serve] {e}")
    cfg = base.get_smoke_config(args.arch)
    if args.sps_granularity:
        cfg = cfg.with_(binary=dataclasses.replace(
            cfg.binary, sps_granularity=args.sps_granularity))
    if cfg.skip_decode:
        raise SystemExit(f"{args.arch} is encoder-only: no decode face")
    model = build_model(cfg)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    dparams = model.init_deploy(gen)
    max_len = args.max_len or (args.prompt_len + args.new_tokens +
                               cfg.frontend_tokens + 8)
    eng = ServeEngine(model, dparams,
                      ServeConfig(sampler=args.sampler,
                                  temperature=args.temperature,
                                  seed=args.seed,
                                  cache=CacheConfig(max_len=max_len)),
                      device=dev)
    rng = np.random.default_rng(args.seed)
    prompts = rng.integers(0, cfg.vocab_size,
                           (args.batch, args.prompt_len)).astype(np.int32)
    kw = {}
    if cfg.frontend_tokens:
        kw["frontend_embeds"] = rng.standard_normal(
            (args.batch, cfg.frontend_tokens, model.frontend_dim),
            dtype=np.float32)
    t0 = time.perf_counter()
    toks, report = eng.generate(prompts, max_new_tokens=args.new_tokens,
                                **kw)
    dt = time.perf_counter() - t0
    tps = args.batch * args.new_tokens / dt
    print(f"[serve] {cfg.name} on {dev}: generated {toks.shape} in "
          f"{dt:.2f}s ({tps:.1f} tok/s)")
    print(f"[serve] binary KV cache: {report['total_bytes']:.0f} B "
          f"({report['compression_vs_bf16']:.1f}x smaller than bf16 KV)")
    print("[serve] sample:", toks[0, :16].tolist())


if __name__ == "__main__":
    main()
