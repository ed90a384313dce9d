"""Units of the mesh decode step split along "model", in one process: each
rank of a small mesh run in turn on the CPU (``Ranks``), or the dry run's
``AbstractMesh`` on the meta device.

* The word-block rule (``linear.rbmm_placed``): each rank's product of
  its block of the packed contraction words, of its true bit count (K =
  97: the last word holds one bit), summed over the ranks, equals the
  whole ``rbmm_int``, xnor and and_dc, over 2 and 4 blocks, bitwise.
* ``sharding.join_bits`` puts every rank's span of binary columns in
  place, word-aligned or not, a rank with an empty span among them.
* A ring split over the data axes (a batch of one, V^T on its words as K
  on its slots): the ranks' partial contexts (``_attend_heads``) sum to
  the whole ring's, wrapped or not, bitwise.
* The vocabulary blocks: the ranks' lookups sum to the whole table's
  rows, and their logits, put together, are the whole product's.
* The census of granite's smoke decode step on ``AbstractMesh((1, 4))``:
  no collective moves a leaf of the params or the attention caches (the
  ring, by then, stays a rank's block), and ``rbmm_int``'s word ops a rank
  are at most 0.3 of (1, 1)'s; mixtral at d = 512 on (1, 2), whose
  product pairs exchange nothing between them, all-gathers its logits
  alone; hymba's gathers are the parts ``sharding.WHOLE_PARTS`` names and
  its recurrent carries.
* A placement the rule cannot compute on raises; ``take_cols`` gathers on
  every rank or on none."""
import test_torch_threads  # noqa: F401  (first: one torch thread)

import pytest
import torch

from repro_torch import tree
from repro_torch.configs import base
from repro_torch.core import packing, rbmm
from repro_torch.launch import cost, mesh as mesh_lib, specs
from repro_torch.launch.mesh import P
from repro_torch.models import nn, sharding
from repro_torch.models.attention import SPSAttention
from repro_torch.models.linear import BinaryDense, rbmm_placed
from repro_torch.models.lm import build_model

META = torch.device("meta")


class Ranks(mesh_lib.AbstractMesh):
    """A mesh whose ranks run one after another in this process
    (``at(r)``), on CPU tensors: an all-reduce gives the rank's own term
    (the test sums the ranks'); an all-gather posts the rank's part and,
    once every rank of the axes has posted one of that shape, gives all
    of them in rank order (so each rank runs twice: to post, to read)."""

    def __init__(self, shape, names=("data", "model")):
        super().__init__(shape, names)
        self.parts = {}

    def at(self, rank: int) -> "Ranks":
        self.rank = rank
        return self

    def all_gather(self, x, axis, dim):
        n = self._width(axis)
        if n == 1:
            return x
        got = self.parts.setdefault((tuple(x.shape), dim % x.dim()), {})
        got[mesh_lib.block_index(self, self._axes(axis))] = x.clone()
        if len(got) < n:
            return torch.cat([x] * n, dim)
        return torch.cat([got[i] for i in range(n)], dim)


def _place(mesh, spec, t):
    pl = mesh_lib.Placement(mesh, spec, t.shape)
    return mesh_lib.place(pl.shard(t), pl)


def _words(gen, rows, k):
    """Random packed rows of k bits, the pad bits 0."""
    bits = torch.randint(0, 2, (rows, k), generator=gen).bool()
    return packing.pack_bits(bits)


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("scheme", ["xnor", "and_dc"])
def test_word_blocks_sum_to_the_whole_product(scheme, m):
    gen = torch.Generator().manual_seed(m)
    k = 97                                  # 4 words, the last one bit
    a, w = _words(gen, 6, k), _words(gen, 10, k)
    want = rbmm.rbmm_int(a, w, k, scheme=scheme)
    mesh = Ranks((1, m))
    total = 0
    for r in range(m):
        local = _place(mesh.at(r), P(None, "model"), w)
        lo, hi = mesh_lib.placement_of(local).span(1)
        got, cols = rbmm_placed(a, local, k, scheme=scheme)
        held, _ = rbmm_placed(a[:, lo:hi].contiguous(), local, k,
                              scheme=scheme, held=(lo, hi))
        assert cols == (0, 10) and torch.equal(got, held)
        total = total + got
    assert torch.equal(total, want)


@pytest.mark.parametrize("spans", [
    [(0, 64), (64, 64), (64, 128)],          # aligned, one rank empty
    [(0, 40), (40, 96), (96, 96), (96, 170)],  # unaligned, one empty
    [(0, 32), (32, 64), (64, 70)],           # aligned, a short last span
], ids=["aligned", "unaligned", "short"])
def test_join_bits_puts_every_span_in_place(spans):
    n = spans[-1][1]
    gen = torch.Generator().manual_seed(n)
    bits = torch.randint(0, 2, (3, 1, n), generator=gen).bool()
    mesh = Ranks((1, len(spans)))
    for _ in range(2):
        for r, (lo, hi) in enumerate(spans):
            split = sharding.Split(r, len(spans), mesh.at(r))
            got = sharding.join_bits(packing.pack_bits(bits[..., lo:hi]),
                                     split, spans, n)
    assert torch.equal(got, packing.pack_bits(bits))


@pytest.mark.parametrize("pos", [700, 2500], ids=["filling", "wrapped"])
def test_ring_blocks_sum_to_the_whole_context(pos):
    """One row's ring of 2,048 slots over 4 data ranks: K split on its
    slots and V^T on its words (``cache_spec`` for a batch of one)."""
    attn = SPSAttention(d_model=128, num_heads=4, num_kv_heads=2,
                        head_dim=32)
    gen = torch.Generator().manual_seed(pos)
    w = 2048
    kc = _words(gen, 2 * w, 32).reshape(1, 2, w, 1)
    vc = _words(gen, 2 * 32, w).reshape(1, 2, 32, w // 32)
    q = _words(gen, 4, 32).reshape(1, 4, 1, 1)
    th = torch.randint(-4, 5, (1, 4, 1), generator=gen, dtype=torch.int32)
    p = torch.tensor([pos])
    whole = attn._share(kc, vc)
    want = attn._attend_heads(q, kc, vc, th, attn._slots(whole, "cpu")[
        None] <= p[:, None], whole)
    mesh = Ranks((4, 1))
    total = 0
    for r in range(4):
        mesh.at(r)
        k_r, v_r = (_place(mesh, specs.cache_spec(mesh, tuple(t.shape),
                                                  batch=1), t)
                    for t in (kc, vc))
        share = attn._share(k_r, v_r)
        assert share.k_axes == share.w_axes == ("data",)
        assert share.slots == (512 * r, 512 * (r + 1))
        valid = attn._slots(share, "cpu")[None] <= p[:, None]
        total = total + attn._attend_heads(q, k_r, v_r, th, valid, share)
    assert torch.equal(total, want)


def test_vocabulary_block_lookup():
    gen = torch.Generator().manual_seed(0)
    emb = nn.Embedding(512, 16)
    table = emb.init(gen, "cpu")
    ids = torch.randint(0, 512, (3, 5), generator=gen)
    mesh = Ranks((1, 4))
    total = sum(emb.apply({"embedding": _place(mesh.at(r), P("model", None),
                                               table["embedding"])}, ids)
                for r in range(4))
    assert torch.equal(total, emb.apply(table, ids))


def test_vocabulary_block_logits():
    """The tied head's and the untied head's (``Dense``) logits of each
    rank's block, put together, are the whole product's, bitwise."""
    gen = torch.Generator().manual_seed(1)
    emb, head = nn.Embedding(512, 64), nn.Dense(64, 512, use_bias=False)
    table, kernel = emb.init(gen, "cpu"), head.init(gen, "cpu")
    x = torch.randn(3, 1, 64, generator=gen)
    meshes = Ranks((1, 4)), Ranks((1, 4))
    for _ in range(2):
        for r in range(4):
            tied = emb.attend({"embedding": _place(
                meshes[0].at(r), P("model", None), table["embedding"])}, x)
            untied = head.apply({"kernel": _place(
                meshes[1].at(r), P(None, "model"), kernel["kernel"])}, x)
    assert torch.equal(tied, emb.attend(table, x))
    assert torch.equal(untied, head.apply(kernel, x))


def _decode_trace(arch: str, shape, **over):
    """(census, the placements gathered, the step's params and caches) of
    ``arch``'s smoke decode step (B = 4, a cache of 64; ``over`` its
    config's overrides) traced on an ``AbstractMesh`` of ``shape``."""
    cfg = base.get_smoke_config(arch).with_(**over)
    mesh = mesh_lib.AbstractMesh(shape, ("data", "model"))
    model = build_model(cfg)
    dp = specs.deploy_param_specs(model, mesh)
    caches = specs.cache_shardings(mesh, model.init_caches(4, 64, META),
                                   batch=4)
    tok = specs._shard_batch_dim(mesh, {"t": torch.empty(
        (4, 1), dtype=torch.int32, device=META)}, 4)["t"]
    seen, orig = [], mesh_lib.Placement._gather

    def gather(pl, local, skip=()):
        seen.append(pl)
        return orig(pl, local, skip)
    mesh_lib.Placement._gather = gather
    try:
        census, _ = cost.measure(
            lambda d, t, cs: model.decode_step(d, t, cs, mesh=mesh),
            (dp, tok, caches))
    finally:
        mesh_lib.Placement._gather = orig
    return census, seen, dp, caches


def _word_ops(census) -> int:
    return sum(census.kernels["rbmm_int"]["ops"].values())


def test_granite_census_moves_activations_not_leaves():
    census, seen, _, _ = _decode_trace("granite-3-2b", (1, 4))
    whole, _, _, _ = _decode_trace("granite-3-2b", (1, 1))
    assert seen == []
    assert census.collectives["all-gather"] > 0
    assert census.collectives["all-reduce"] > 0
    assert _word_ops(census) <= 0.3 * _word_ops(whole)
    assert census.launches() == whole.launches()


def test_wide_pairs_exchange_nothing_between_products():
    """mixtral at d = 512, d_ff = 1,024 on (1, 2): each rank's heads are
    its rows of wq and its words of wo, each rank's rows of the experts'
    w1/w3 its words of w2, so the only all-gather is the logits' (B x V
    float32), and each product pair ends in one all-reduce."""
    census, seen, _, _ = _decode_trace("mixtral-8x22b", (1, 2),
                                       d_model=512, d_ff=1024)
    assert [pl for pl in seen if pl.splits] == []   # the router is whole
    assert census.collectives["all-gather"] == 4 * 256 * 4
    # the embedding's rows, and per layer wo's and the claims' int32 sums
    assert census.collectives["all-reduce"] == 4 * 512 * 4 + 2 * (
        4 * 512 * 4 + 4 * 2 * 512 * 4)


def test_hymba_gathers_only_the_parts_kept_whole():
    _, seen, dp, caches = _decode_trace("hymba-1.5b", (1, 4))
    named = {id(mesh_lib.placement_of(t))
             for path, t in tree.leaves_with_paths(dp)
             if sharding.kept_whole(path)}
    carries = {id(mesh_lib.placement_of(t)) for c in caches
               for t in tree.leaves(c["mamba"])}
    assert seen and {id(pl) for pl in seen} <= named | carries
    assert any(id(pl) in named for pl in seen)


def _raises_data_split():
    mesh = mesh_lib.AbstractMesh((2, 2), ("data", "model"))
    t = specs.stand_in(mesh, P("data", None), (8, 4), torch.int32)
    sharding.placed_block(t, (0, 1))


def _raises_fused_on_words():
    mesh = Ranks((1, 2)).at(0)
    dense = BinaryDense(64, 64, partition="row")
    p = dense.init_deploy(torch.Generator().manual_seed(0), "cpu")
    p["w_packed"] = _place(mesh, P(None, "model"), p["w_packed"])
    dense.apply_deploy_fused(p, torch.randn(2, 64), torch.zeros(()))


def _raises_cache_split_on_words():
    mesh = mesh_lib.AbstractMesh((1, 2), ("data", "model"))
    attn = SPSAttention(d_model=128, num_heads=4, num_kv_heads=2,
                        head_dim=64)
    kc = specs.stand_in(mesh, P(None, None, None, "model"), (4, 2, 64, 2),
                        torch.int32)
    vc = specs.stand_in(mesh, P(), (4, 2, 64, 2), torch.int32)
    attn._share(kc, vc)


@pytest.mark.parametrize("case", [_raises_data_split, _raises_fused_on_words,
                                  _raises_cache_split_on_words],
                         ids=lambda f: f.__name__[8:])
def test_a_placement_the_rule_cannot_compute_on_raises(case):
    with pytest.raises(ValueError, match="a decode step"):
        case()


def test_take_cols_gathers_on_every_rank_or_on_none():
    """qwen's shapes: wq's rows of 320 columns a rank against heads of
    128 columns, three on the first 8 of 16 ranks and two on the rest
    (the last rank's heads lie in its rows, the others' do not): every
    rank gathers; gemma's two heads a rank in rows of 256: none does."""
    for n, heads, want in ((5120, 40, True), (4096, 32, False)):
        split = sharding.Split(0, 16, None)
        spans = [(lo * 128, hi * 128) for lo, hi in
                 sharding.ranges(heads, split)]
        blk = n // 16
        gathers = []
        for r in range(16):
            mesh = Ranks((1, 16)).at(r)
            y = torch.zeros(2, blk)
            got = sharding.take_cols(y, sharding.Split(r, 16, mesh),
                                     (r * blk, (r + 1) * blk), n, spans)
            gathers.append(bool(mesh.parts))
            assert got.shape == (2, spans[r][1] - spans[r][0])
        assert gathers == [want] * 16
