"""``init_deploy``, the port's way to build deploy params layer by layer,
on the CPU at smoke size.

Held: for every arch, ``init_deploy(gen)`` equals ``convert(init(gen))``
from the same seed (packed words bitwise, floats exactly, the same
paths);
the deploy params of ``cfg.truncated(n)`` are the first n blocks of the
full model's, and ``truncate_deploy`` of the full model gives them, for a
uniform, a mixed and an expert stack; and the draws' lifetime: at every
draw of ``nn.truncated_normal`` after the embedding, head and frontend,
the float32 masters alive that deploy does not keep are at most one
block's, and in an expert stack at most one expert's plus the router."""
import test_torch_threads  # noqa: F401  (first: one torch thread)
import weakref

import pytest
import torch

from repro_torch import tree
from repro_torch.configs import base
from repro_torch.models import ffn, nn
from repro_torch.models.ffn import BinaryMoE
from repro_torch.models.lm import build_model

SEED = 7


def assert_same_tree(got, want):
    """Equal paths, and every leaf of equal dtype, shape and value (int32
    words bitwise; floats exactly, NaNs nowhere)."""
    g, w = tree.leaves_with_paths(got), tree.leaves_with_paths(want)
    assert [p for p, _ in g] == [p for p, _ in w]
    for (path, a), (_, b) in zip(g, w):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert torch.equal(a, b), path


def _gen():
    return torch.Generator().manual_seed(SEED)


@pytest.mark.parametrize("arch", base.ARCH_IDS)
def test_init_deploy_equals_convert_of_init(arch):
    model = build_model(base.get_smoke_config(arch))
    assert_same_tree(model.init_deploy(_gen()),
                     model.convert(model.init(_gen())))


# a uniform stack, a mixed one (mLSTM and sLSTM layers) and an expert stack,
# each 4 layers deep
PREFIX = ("smollm-135m", "xlstm-350m", "mixtral-8x22b")


@pytest.mark.parametrize("arch", PREFIX)
def test_truncated_deploy_is_the_full_models_prefix(arch):
    cfg = base.get_smoke_config(arch).with_(num_layers=4)
    model = build_model(cfg)
    full = model.init_deploy(_gen())
    for n in (1, 3):
        cut = build_model(cfg.truncated(n)).init_deploy(_gen())
        want = dict(full, blocks=full["blocks"][:n])
        assert_same_tree(cut, want)
        draft_model, draft = model.truncate_deploy(full, n)
        assert draft_model.cfg == cfg.truncated(n)
        assert_same_tree(draft, cut)


def _numel(t) -> int:
    return sum(leaf.numel() for leaf in tree.leaves(t))


def _bound(model) -> int:
    """The most master elements one step of ``init_deploy`` may hold: one
    block's QAT params; in an expert stack, one expert's plus the router
    (and the other parts' and the residual FFN's each on its own)."""
    gen, most = _gen(), 0
    for blocks in model.layer_blocks().values():
        for blk in blocks:
            units = []
            for name, mod in blk._parts().items():
                qat = mod.init(gen, "cpu")
                if isinstance(mod, BinaryMoE):
                    one = _numel([qat["experts"][w] for w in
                                  ("w1", "w2", "w3")]) // mod.num_experts
                    router = _numel(qat["router"])
                    units.append(one + router)
                    assert one + router < _numel(qat["experts"])
                    if "residual" in qat:
                        units.append(_numel(qat["residual"]) + router)
                else:
                    units.append(_numel(qat))
            most = max(most, max(units) if any(
                isinstance(m, BinaryMoE) for m in blk._parts().values())
                else sum(units))
    return most


@pytest.mark.parametrize("arch", ("mixtral-8x22b", "arctic-480b",
                                  "hymba-1.5b", "seamless-m4t-large-v2"))
def test_masters_are_freed_layer_by_layer(arch, monkeypatch):
    cfg = base.get_smoke_config(arch).with_(num_layers=3)
    model = build_model(cfg)
    drawn, alive_at = [], []

    def register(t):
        drawn.append((weakref.ref(t), t.numel()))
        alive_at.append([i for i, (r, _) in enumerate(drawn)
                         if r() is not None])

    def tracked(*a, **kw):
        t = orig(*a, **kw)
        register(t)
        return t

    def stacked(one, n):
        """An expert stack of masters is one more master tensor."""
        out = orig_stacked(one, n)
        for path, t in tree.leaves_with_paths(out):
            if path.endswith("w_latent"):
                register(t)
        return out

    orig, orig_stacked = nn.truncated_normal, ffn._stacked
    monkeypatch.setattr(nn, "truncated_normal", tracked)
    monkeypatch.setattr(ffn, "_stacked", stacked)
    dparams = model.init_deploy(_gen())
    monkeypatch.undo()
    # a master alive now is one that deploy keeps (the embedding, head,
    # frontend, router, the recurrent blocks' fp projections)
    kept = {i for i, (r, _) in enumerate(drawn) if r() is not None}
    ids = {id(t) for t in tree.leaves(dparams)}
    assert all(id(drawn[i][0]()) in ids for i in kept)
    transient = [sum(drawn[i][1] for i in live if i not in kept)
                 for live in alive_at]
    bound = _bound(model)
    assert max(transient) <= bound, (max(transient), bound)
    # the stack's masters were drawn: the bound is a real limit
    assert sum(n for i, (_, n) in enumerate(drawn) if i not in kept) > \
        2 * bound
