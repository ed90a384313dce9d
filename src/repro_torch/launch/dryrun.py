"""The dry run of the port: every (arch x shape x mesh) cell traced on the
meta device as rank 0 of the production mesh (port of
``repro.launch.dryrun``).

For each cell this builds the port's step as it would run on a rank of
the 16 x 16 = 256-GPU single-pod mesh or the 2 x 16 x 16 = 512-GPU
multi-pod mesh (``launch.mesh.make_production_mesh``): the mesh trainer's
``train_step`` with its optimizer update (its compute split along "model":
``models.sharding``), the mesh ``prefill_logits`` (split along "model"
by the sequence: ``models.lm._OnMesh``; the record names the block of
the logits a rank holds, ``logits``), or
the mesh ``decode_step`` (its compute split along "model" too, and a batch
of one's rings over the data axes: ``models.lm._OnMesh``), on stand-ins
from ``launch.specs`` (this rank's blocks as meta tensors).  It traces the step once on the meta device
under ``launch.cost``'s census: nothing is allocated, no kernel is
launched and no process group is joined.  Each cell writes one JSON
record: per-rank memory (arguments, temp, outputs), dense FLOPs, bytes,
the hand-written kernels' launches and work, collective bytes by kind and
the H100 roofline (``launch.roofline``).  Where the JAX package lowers
and compiles its SPMD program, the port traces its eager step as rank 0
runs it (``trace_s`` in place of ``lower_s`` / ``compile_s``, ``kernels``
in place of ``popcnt_elems``).

Usage (the CPU is enough; records land in build/dryrun/):
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-135m \\
      --shape decode_32k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both \\
      [--jobs N]
Run as a program, the dry run and its ``--jobs`` workers end with the
process that started it (Linux): a sweep killed from above leaves no
process behind.
"""
from __future__ import annotations

import argparse
import functools
import json
import multiprocessing
import os
import signal
import sys
import time
import traceback
from concurrent.futures import ProcessPoolExecutor
from typing import Any, Dict, List, Optional

import torch

from repro_torch import tree
from repro_torch.configs import base as cfg_base
from repro_torch.launch import cost, mesh as mesh_lib, roofline, \
    specs as specs_lib
from repro_torch.models import sharding
from repro_torch.models.lm import EncDecModel, _qat_stack, build_model
from repro_torch.optim.adamw import AdamW
from repro_torch.train.trainer import Trainer, TrainerConfig

ARTIFACT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                            "build", "dryrun")
META = torch.device("meta")


def _mesh(kind: str):
    return mesh_lib.make_production_mesh(multi_pod=(kind == "multi"))


def _face(shape: cfg_base.ShapeConfig) -> str:
    return {"train": "train", "prefill": "prefill",
            "decode": "decode"}[shape.kind]


def _config(arch: str, impl: Optional[str],
            overrides: Optional[Dict[str, Any]]):
    cfg = cfg_base.get_config(arch)
    binary = dict(cfg.binary.__dict__)
    if impl:
        binary["impl"] = impl
    plain = {}
    for k, v in (overrides or {}).items():
        if k.startswith("binary."):
            binary[k.split(".", 1)[1]] = v
        elif "." not in k:
            plain[k] = v
    return cfg.with_(binary=cfg.binary.__class__(**binary), **plain)


def _whole_batch(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The global batch the trainer takes (it cuts this rank's rows): meta
    tensors of the placements' whole shapes."""
    return {k: torch.empty(mesh_lib.placement_of(v).shape, dtype=v.dtype,
                           device=META) for k, v in batch.items()}


def build_traced(arch: str, shape_name: str, mesh_kind: str,
                 impl: Optional[str] = None,
                 overrides: Optional[Dict[str, Any]] = None,
                 variant: str = "default"):
    """Returns (step, args, face, cfg, shape, mesh): ``step(*args)`` is the
    cell's step on this rank's stand-ins (the counterpart of JAX's
    ``build_lowered``).

    variant="qat_dense": a prefill cell runs the QAT forward (latent fp
    weights placed as the trainer places them) instead of the packed
    deploy forward, as the JAX package's."""
    cfg = _config(arch, impl, overrides)
    shape = cfg_base.SHAPES[shape_name]
    mesh = _mesh(mesh_kind)
    face = _face(shape)
    model = build_model(cfg)
    daxes = mesh_lib.data_axes(mesh)
    if face == "train" or (face == "prefill" and variant == "qat_dense"):
        moment = getattr(torch, cfg.optim_moment_dtype)
        trainer = Trainer(model, AdamW(lr=1e-4, moment_dtype=moment),
                          TrainerConfig(), device=META, mesh=mesh)
        state = specs_lib.train_state_specs(trainer)
        batch = specs_lib.batch_specs(cfg, shape, mesh)
        if face == "train":
            whole = _whole_batch(batch)

            def step(state, batch):
                return trainer.train_step(state, whole)
            return step, (state, batch), face, cfg, shape, mesh

        layers = model.layer_blocks()

        def qat_prefill(params, batch):
            # a layer's params gathered where the layer runs, as the
            # trainer gathers them
            use = tree.unflatten(params, [
                sharding.Gathered(t, mesh_lib.placement_of(t).gather,
                                  mesh_lib.placement_of(t))
                if p.split("/")[0] in layers
                else mesh_lib.placement_of(t).gather(t)
                for p, t in tree.leaves_with_paths(params)])
            with torch.no_grad(), sharding.activation_sharding(mesh, daxes):
                if isinstance(model, EncDecModel):
                    mem = model.encode(use, batch["frontend_embeds"],
                                       deploy=False)
                    x = model._embed_tokens(use, batch["tokens"])
                    x, _ = _qat_stack(cfg, [model._dec_block()] *
                                      cfg.num_layers, use["decoder"], x,
                                      mem)
                    return model._logits(use, x)
                kw = {}
                if "frontend_embeds" in batch:
                    kw["frontend_embeds"] = batch["frontend_embeds"]
                return model.qat_logits(use, batch["tokens"], **kw)
        return qat_prefill, (state.params, batch), face, cfg, shape, mesh
    if face == "prefill":
        dparams = specs_lib.deploy_param_specs(model, mesh)
        batch = specs_lib.batch_specs(cfg, shape, mesh)

        def prefill(dp, batch):
            kw = {}
            if "frontend_embeds" in batch:
                kw["frontend_embeds"] = batch["frontend_embeds"]
            return model.prefill_logits(dp, batch["tokens"], mesh=mesh, **kw)
        return prefill, (dparams, batch), face, cfg, shape, mesh
    dparams, token, caches = specs_lib.decode_specs(cfg, shape, mesh)

    def decode(dp, tok, cs):
        return model.decode_step(dp, tok, cs, mesh=mesh)
    return decode, (dparams, token, caches), face, cfg, shape, mesh


def run_cell(arch: str, shape_name: str, mesh_kind: str, *,
             out_dir: str = ARTIFACT_DIR, verbose: bool = True,
             impl: Optional[str] = None,
             overrides: Optional[Dict[str, Any]] = None,
             variant: str = "default", tag: str = "") -> Dict[str, Any]:
    cfg = cfg_base.get_config(arch)
    valid = cfg_base.valid_shapes(cfg)
    rec: Dict[str, Any] = {"arch": arch, "shape": shape_name,
                           "mesh": mesh_kind, "impl": impl or cfg.binary.impl,
                           "overrides": overrides or {}, "variant": variant,
                           "tag": tag}
    if shape_name not in valid:
        rec["status"] = "SKIP"
        rec["reason"] = ("needs sub-quadratic attention"
                         if shape_name == "long_500k" else "no decode face")
        _save(rec, out_dir, tag)
        if verbose:
            print(f"[dryrun] {arch} x {shape_name} x {mesh_kind}: SKIP "
                  f"({rec['reason']})")
        return rec
    t0 = time.time()
    try:
        step, args, face, cfg, shape, mesh = build_traced(
            arch, shape_name, mesh_kind, impl=impl, overrides=overrides,
            variant=variant)
        rec["build_s"] = time.time() - t0
        t1 = time.time()
        census, out = cost.measure(step, args)
        rec["trace_s"] = time.time() - t1
        pl = getattr(out, "placement", None)
        if face == "prefill" and pl is not None:    # the deploy face's
            rec["logits"] = {"block": list(out.shape),
                             "whole": list(pl.shape),
                             "model_dim": pl.dims.get("model")}
        rec.update(census.record())
        rec["face"] = face
        rec["ranks"] = mesh.size
        terms = roofline.terms_from_artifact(rec, cfg, shape, face,
                                             chips=mesh.size)
        rec["roofline"] = terms.to_dict()
        rec["status"] = "OK"
        if verbose:
            t = rec["roofline"]
            gib = 2 ** 30
            print(f"[dryrun] {arch} x {shape_name} x {mesh_kind}: OK "
                  f"trace {rec['trace_s']:.1f}s "
                  f"args {rec['argument_size_in_bytes'] / gib:.3f} GiB "
                  f"temp {rec['temp_size_in_bytes'] / gib:.3f} GiB "
                  f"flops {rec['flops']:.3g} bytes "
                  f"{rec['bytes_accessed']:.3g} coll "
                  f"{sum(rec['collectives'].values()):.3g} "
                  f"dominant={t['dominant']} step {t['step_time_s']:.4g}s")
    except Exception as e:  # noqa: BLE001 — record the failure, keep going
        rec["status"] = "FAIL"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
        if verbose:
            print(f"[dryrun] {arch} x {shape_name} x {mesh_kind}: FAIL "
                  f"{rec['error']}")
    _save(rec, out_dir, tag)
    return rec


def _save(rec: Dict[str, Any], out_dir: str, tag: str = "") -> None:
    os.makedirs(out_dir, exist_ok=True)
    suffix = f"__{tag}" if tag else ""
    name = f"{rec['arch']}__{rec['shape']}__{rec['mesh']}{suffix}.json"
    with open(os.path.join(out_dir, name), "w") as f:
        json.dump(rec, f, indent=1)


def _run_one(cell, **kwargs) -> Dict[str, Any]:
    return run_cell(*cell, **kwargs)


def _end_with_parent() -> None:
    """Have the kernel kill this process when its parent ends (Linux's
    ``PR_SET_PDEATHSIG``; elsewhere nothing): no worker outlives the
    sweep, and no sweep the process that started it."""
    if sys.platform.startswith("linux"):
        import ctypes
        ctypes.CDLL(None).prctl(1, int(signal.SIGKILL), 0, 0, 0)


def main(argv: Optional[List[str]] = None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default=None)
    p.add_argument("--shape", default=None,
                   choices=list(cfg_base.SHAPES) + [None])
    p.add_argument("--mesh", default="single",
                   choices=["single", "multi", "both"])
    p.add_argument("--impl", default=None,
                   choices=["popcount", "mxu", "dense", None])
    p.add_argument("--variant", default="default",
                   choices=["default", "qat_dense"])
    p.add_argument("--override", action="append", default=[],
                   help="ModelConfig override, e.g. remat=none")
    p.add_argument("--tag", default="")
    p.add_argument("--all", action="store_true")
    p.add_argument("--out", default=ARTIFACT_DIR)
    p.add_argument("--jobs", type=int, default=1,
                   help="cells traced side by side, each worker a CPU "
                        "process of its own")
    args = p.parse_args(argv)

    overrides: Dict[str, Any] = {}
    for kv in args.override:
        k, v = kv.split("=", 1)
        try:
            v = int(v)
        except ValueError:
            try:
                v = float(v)
            except ValueError:
                pass
        overrides[k] = v

    archs = [a for a in cfg_base.ARCH_IDS if a != "bert-base-cobra"] \
        if args.all or not args.arch else [args.arch]
    shapes = list(cfg_base.SHAPES) if args.all or not args.shape \
        else [args.shape]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    cells = [(a, s, m) for a in archs for s in shapes for m in meshes]
    one = functools.partial(_run_one, out_dir=args.out, impl=args.impl,
                            overrides=overrides or None,
                            variant=args.variant, tag=args.tag)
    t0 = time.time()
    if args.jobs > 1:
        # the longest traces first: the recurrent archs' (each traced
        # twice, see ``cost.measure``), then the train faces
        cells.sort(key=lambda c: (cfg_base.get_config(c[0]).ssm is None,
                                  list(cfg_base.SHAPES).index(c[1])))
        with ProcessPoolExecutor(args.jobs, mp_context=multiprocessing
                                 .get_context("spawn"),
                                 initializer=_end_with_parent) as pool:
            recs = list(pool.map(one, cells))
    else:
        recs = [one(c) for c in cells]
    fails = sum(r["status"] == "FAIL" for r in recs)
    print(f"[dryrun] {len(cells)} cells in {time.time() - t0:.1f}s, "
          f"{fails} failed")
    if fails:
        raise SystemExit(f"{fails} dry-run cells FAILED")


if __name__ == "__main__":
    _end_with_parent()
    main()
