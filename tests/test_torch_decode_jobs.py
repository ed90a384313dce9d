"""Gloo-world jobs of the mesh decode step split along "model" (no tests
here; ``test_torch_dist_decode_split.py`` runs them through
``test_torch_dist_worlds.run_world``).  Like that module, this one imports
neither JAX nor a test file that does, so a spawned rank starts from
torch and the port alone.

``decode_job(model_axis, cases)`` builds a (world / model_axis,
model_axis) mesh and, for each case, the one-device prefill and three
greedy ``decode_step``s beside the mesh ``decode_step`` on this rank's
placed blocks of the same params and caches: per step, whether the
logits of this rank's rows and every cache leaf's block equal the
one-device ones bitwise."""
import test_torch_threads  # noqa: F401  (first: one torch thread)
import dataclasses

import numpy as np
import torch

import test_torch_dist_worlds as worlds
from repro_torch import bridge, tree
from repro_torch.launch import mesh as mesh_lib, specs
from repro_torch.models.lm import EncDecModel, build_model

STEPS = 3
# the smoke configs' d = 128 gives Kp = 4 words, which the deploy specs'
# 16 partitions do not divide: every smoke leaf splits on its rows.  These
# widths split wo and w2 on their words (Kp = 16 and 32).
WIDE = dict(d_model=512, d_ff=1024)
# name -> (arch, config overrides, batch, prompt length, cache beyond it)
CASES = {
    "smollm-135m": ("smollm-135m", {}, 4, 12, 4),
    "granite-3-2b": ("granite-3-2b", {}, 4, 12, 4),
    "qwen1.5-32b": ("qwen1.5-32b", {}, 4, 12, 4),
    "gemma3-27b": ("gemma3-27b", {}, 4, 12, 4),
    "mixtral-8x22b": ("mixtral-8x22b", {}, 4, 20, 4),
    "arctic-480b": ("arctic-480b", {}, 4, 12, 4),
    # 16 experts: spread over "model" by expert (``expert_parallel``)
    "arctic 16 experts": ("arctic-480b", {"num_experts": 16}, 4, 12, 4),
    "seamless-m4t-large-v2": ("seamless-m4t-large-v2", {}, 4, 12, 4),
    "hymba-1.5b": ("hymba-1.5b", {}, 4, 12, 4),
    "xlstm-350m": ("xlstm-350m", {}, 4, 12, 4),
    "internvl2-76b": ("internvl2-76b", {}, 4, 12, 4),
    "smollm wide": ("smollm-135m", WIDE, 4, 12, 4),
    "mixtral wide": ("mixtral-8x22b", WIDE, 4, 12, 4),
}
# a batch of one row: its ring split over the data axes (a window's ring
# wrapped by the prompt; smollm's ring of 2,048 has V^T split on its words
# as K on its slots, the others split V^T on its d_h rows)
RINGS = {
    "gemma3-27b": ("gemma3-27b", {}, 1, 20, 4),
    "mixtral-8x22b": ("mixtral-8x22b", {}, 1, 20, 4),
    "hymba-1.5b": ("hymba-1.5b", {}, 1, 20, 4),
    "xlstm-350m": ("xlstm-350m", {}, 1, 12, 4),
    "smollm ring 2048": ("smollm-135m", {}, 1, 12, 2036),
}


def config(arch: str, over: dict):
    cfg = worlds.config(arch)
    over = dict(over)
    if "num_experts" in over:
        cfg = cfg.with_(moe=dataclasses.replace(
            cfg.moe, num_experts=over.pop("num_experts")))
    return cfg.with_(**over)


def _placed(mesh, t, spec):
    pl = mesh_lib.Placement(mesh, spec, t.shape)
    return mesh_lib.place(pl.shard(t), pl)


def _rows(mesh, t):
    return _placed(mesh, t, specs._batch_spec(mesh, tuple(t.shape),
                                              t.shape[0]))


def _prefill(model, dparams, tokens, extra: int, fe):
    cfg = model.cfg
    s = tokens.shape[1]
    if isinstance(model, EncDecModel):
        return model.prefill_with_cache(dparams, tokens, max_len=s + extra,
                                        frontend_embeds=fe)
    kw = {"frontend_embeds": fe} if cfg.frontend_tokens else {}
    return model.prefill_with_cache(
        dparams, tokens, max_len=cfg.frontend_tokens + s + extra, **kw)


def run_case(mesh, cfg, batch: int, s: int, extra: int, dparams=None,
             tokens=None):
    """The case on ``mesh``: per step (logits equal, every cache block
    equal); the tokens fed and this rank's mesh logits; which leaves
    split (a param on its words, a cache leaf over the data axes)."""
    model = build_model(cfg)
    if dparams is None:
        dparams = model.init_deploy(torch.Generator().manual_seed(0),
                                    device="cpu")
    g = torch.Generator().manual_seed(1)
    if tokens is None:
        tokens = torch.randint(0, cfg.vocab_size, (batch, s), generator=g)
    fe = None
    if cfg.frontend_tokens:
        fe = torch.randn(batch, cfg.frontend_tokens, model.frontend_dim,
                         generator=g)
    logits, caches = _prefill(model, dparams, tokens, extra, fe)
    local = mesh_lib.shard_tree(mesh, model.deploy_specs(), dparams)
    mine = tree.map(lambda t: _placed(mesh, t, specs.cache_spec(
        mesh, tuple(t.shape), batch=batch)), caches)
    tok = logits[:, -1:].argmax(-1).to(torch.int32)
    steps, fed, got_all = [], [], []
    for _ in range(STEPS):
        want, _ = model.decode_step(dparams, tok, caches)
        t1 = _rows(mesh, tok)
        rows = mesh_lib.placement_of(t1).block(torch.arange(batch))
        got, _ = model.decode_step(local, t1, mine, mesh=mesh)
        steps.append((torch.equal(got, want[rows]), all(
            torch.equal(m, mesh_lib.placement_of(m).block(w))
            for m, w in zip(tree.leaves(mine), tree.leaves(caches)))))
        fed.append(tok.numpy().copy())
        got_all.append(got.numpy().copy())
        tok = want.argmax(-1).to(torch.int32)
    pls = [mesh_lib.placement_of(t) for t in tree.leaves(local)]
    words = any(pl.dims.get("model") == len(pl.shape) - 1 for pl in pls
                if len(pl.shape) >= 2)
    ring = any(d != 0 and "model" not in axes
               for t in tree.leaves(mine)
               for axes, d in mesh_lib.placement_of(t).splits)
    return dict(steps=steps, fed=fed, logits=got_all, words=words,
                ring=ring)


def decode_job(model_axis: int, cases):
    """Each case (name, (arch, overrides, batch, prompt, extra)) on a
    (world / model_axis, model_axis) mesh: ``run_case``'s results by
    name, and the mesh's collectives over all of them."""
    mesh = mesh_lib.make_host_mesh(model_axis, "cpu")
    out = {}
    for name, (arch, over, batch, s, extra) in cases:
        res = run_case(mesh, config(arch, over), batch, s, extra)
        del res["fed"], res["logits"]
        out[name] = res
    out["collectives"] = mesh.collectives
    return out


def parity_job(model_axis: int, dparams_np, tokens: np.ndarray, extra: int):
    """smollm's smoke config from given deploy params (numpy, the JAX
    package's layout) and prompt: ``run_case``'s results with the tokens
    fed and this rank's mesh logits at each step."""
    mesh = mesh_lib.make_host_mesh(model_axis, "cpu")
    cfg = config("smollm-135m", {})
    dparams = bridge.from_jax_params(dparams_np, device="cpu")
    return run_case(mesh, cfg, tokens.shape[0], tokens.shape[1], extra,
                    dparams, torch.from_numpy(tokens))


def tasks_job(tasks):
    """Each task (job name, args) in one world."""
    jobs = {"decode": decode_job, "parity": parity_job}
    return [jobs[name](*args) for name, args in tasks]
