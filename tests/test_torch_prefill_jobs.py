"""Gloo-world jobs of the mesh prefill split along "model" (no tests here;
``test_torch_dist_prefill_split.py`` runs them through
``test_torch_dist_worlds.run_world``).  Like that module, this one imports
neither JAX nor a test file that does, so a spawned rank starts from
torch and the port alone.

``prefill_job(model_axis, cases)`` builds a (world / model_axis,
model_axis) mesh and, for each case, the one-device ``prefill_logits``
beside the mesh one on this rank's placed blocks of the same params and
inputs: whether the mesh logits, put together whole by their placement,
equal the one-device logits bitwise, and which route the split took.
``exchange_job`` sends packed words of every head to the heads' ranks and
back (``sharding.to_heads``, ``heads_to_rows``)."""
import test_torch_threads  # noqa: F401  (first: one torch thread)

import numpy as np
import torch

import test_torch_dist_worlds as worlds
from repro_torch import bridge
from repro_torch.launch import mesh as mesh_lib, specs
from repro_torch.models import sharding
from repro_torch.models.lm import EncDecModel, build_model

# the positions of every case's stream: 128 splits into whole-word blocks
# over 2 and 4 ranks (64, 32); 100 does not (the whole route)
N = 128
# name -> (arch, config overrides, batch, positions).  The smoke tables
# (V = 256) cost fewer bytes gathered whole than the streams' exchanges;
# a vocabulary of 4,096 takes the vocabulary blocks (as qwen, gemma,
# internvl2 and seamless do at full width)
CASES = {
    "smollm-135m": ("smollm-135m", {}, 4, N),
    "granite-3-2b": ("granite-3-2b", {}, 4, N),
    "qwen1.5-32b": ("qwen1.5-32b", {}, 4, N),
    "qwen vocab blocks": ("qwen1.5-32b", {"vocab_size": 4096}, 4, N),
    "gemma row table": ("gemma3-27b", {"binary.sps_granularity": "row",
                                       "vocab_size": 4096}, 4, N),
    "internvl2-76b": ("internvl2-76b", {}, 4, N),
    "seamless-m4t-large-v2": ("seamless-m4t-large-v2",
                              {"vocab_size": 4096}, 4, N),
    "bert-base-cobra": ("bert-base-cobra", {}, 4, N),
    "smollm whole length": ("smollm-135m", {}, 4, 100),
    "mixtral-8x22b": ("mixtral-8x22b", {}, 4, N),
    "hymba-1.5b": ("hymba-1.5b", {}, 4, N),
}


def config(arch: str, over: dict):
    cfg = worlds.config(arch)
    over = dict(over)
    gran = over.pop("binary.sps_granularity", None)
    if gran:
        cfg = cfg.with_(binary=cfg.binary.__class__(**dict(
            cfg.binary.__dict__, sps_granularity=gran)))
    return cfg.with_(**over)


def _rows(mesh, t):
    pl = mesh_lib.Placement(mesh, specs._batch_spec(mesh, tuple(t.shape),
                                                    t.shape[0]), t.shape)
    return mesh_lib.place(pl.shard(t), pl)


def inputs(cfg, model, batch: int, n: int, gen: torch.Generator):
    """(tokens, frontend embeddings or None) of a stream of ``n``
    positions: a frontend's patches count among them; an
    encoder-decoder's memory holds ``n`` frames."""
    encdec = isinstance(model, EncDecModel)
    f = 0 if encdec else cfg.frontend_tokens
    tokens = torch.randint(0, cfg.vocab_size, (batch, n - f), generator=gen,
                           dtype=torch.int32)
    fe = None
    if cfg.frontend_tokens:
        fe = torch.randn(batch, n if encdec else f, model.frontend_dim,
                         generator=gen)
    return tokens, fe


def run_case(mesh, cfg, batch: int, n: int, dparams=None, tokens=None):
    """The case on ``mesh``: (whole logits equal, this rank's mesh logits
    and their placement's spec, the spec's dim on "model" or None)."""
    model = build_model(cfg)
    if dparams is None:
        dparams = model.init_deploy(torch.Generator().manual_seed(0),
                                    device="cpu")
    g = torch.Generator().manual_seed(1)
    toks, fe = inputs(cfg, model, batch, n, g)
    if tokens is not None:
        toks = tokens
    kw = {} if fe is None else {"frontend_embeds": fe}
    want = model.prefill_logits(dparams, toks, device="cpu", **kw)
    local = mesh_lib.shard_tree(mesh, model.deploy_specs(), dparams)
    got = model.prefill_logits(local, _rows(mesh, toks), mesh=mesh,
                               **{k: _rows(mesh, v) for k, v in kw.items()})
    pl = mesh_lib.placement_of(got)
    whole = pl.whole(got)[..., :cfg.vocab_size]
    return dict(equal=torch.equal(whole, want), logits=got.numpy().copy(),
                model_dim=pl.dims.get("model"),
                shape=tuple(got.shape), whole_shape=pl.shape)


def prefill_job(model_axis: int, cases):
    """Each case (name, (arch, overrides, batch, positions)) on a (world /
    model_axis, model_axis) mesh: ``run_case``'s results by name (the
    logits dropped), and the mesh's collectives over all of them."""
    mesh = mesh_lib.make_host_mesh(model_axis, "cpu")
    out = {}
    for name, (arch, over, batch, n) in cases:
        res = run_case(mesh, config(arch, over), batch, n)
        del res["logits"]
        out[name] = res
    out["collectives"] = mesh.collectives
    return out


def parity_job(model_axis: int, dparams_np, tokens: np.ndarray):
    """smollm's smoke config from given deploy params (numpy, the JAX
    package's layout) and prompt: ``run_case``'s results."""
    mesh = mesh_lib.make_host_mesh(model_axis, "cpu")
    cfg = config("smollm-135m", {})
    dparams = bridge.from_jax_params(dparams_np, device="cpu")
    return run_case(mesh, cfg, tokens.shape[0], tokens.shape[1], dparams,
                    torch.from_numpy(tokens))


def exchange_job(model_axis: int, heads: int, kv: int, dh: int):
    """Packed words of ``heads`` query heads and ``kv`` KV heads (V^T
    along the sequence) at this rank's block of 128 positions, sent to the
    heads' ranks and the query heads' words back (as a context's): (each
    rank's heads over the whole sequence equal the whole's, the round
    trip equals what was sent, the spans)."""
    from repro_torch.models.attention import SPSAttention
    mesh = mesh_lib.make_host_mesh(model_axis, "cpu")
    split = sharding.prefill_split(mesh, 128)
    attn = SPSAttention(d_model=64, num_heads=heads, num_kv_heads=kv,
                        head_dim=dh)
    qs, kvs = attn.head_ranges(split)
    g = torch.Generator().manual_seed(3)
    w = dh // 32
    q = torch.randint(-2**31, 2**31 - 1, (2, heads, 128, w), generator=g,
                      dtype=torch.int32)
    vt = torch.randint(-2**31, 2**31 - 1, (2, kv, dh, 4), generator=g,
                       dtype=torch.int32)
    lo, hi = sharding.held(128, split)
    mine_q, mine_vt = sharding.to_heads(
        [(q[:, :, lo:hi], qs, 2), (vt[..., lo // 32:hi // 32], kvs, 3)],
        split)
    h0, h1 = qs[split.index]
    k0, k1 = kvs[split.index]
    heads_ok = (torch.equal(mine_q, q[:, h0:h1]) and
                torch.equal(mine_vt, vt[:, k0:k1]))
    # back: this rank's heads' words at every position, as a context's
    words = mine_q.transpose(1, 2).reshape(2, 128, (h1 - h0) * w)
    back = sharding.heads_to_rows(words, split, [(a * w, b * w)
                                                 for a, b in qs])
    sent = q[:, :, lo:hi].transpose(1, 2).reshape(2, hi - lo, heads * w)
    return heads_ok, torch.equal(back, sent), (qs, kvs), mesh.collectives


def tasks_job(tasks):
    """Each task (job name, args) in one world."""
    jobs = {"prefill": prefill_job, "parity": parity_job,
            "exchange": exchange_job}
    return [jobs[name](*args) for name, args in tasks]
