"""The compute split along "model" piece by piece (``models.sharding``'s
split context, ``launch.mesh.Placement``'s range gathers and gradient
rule, ``Block.qat`` under a split), on gloo worlds of CPU ranks
(``test_torch_dist_worlds.run_world``; one world of 2 ranks, one of 4,
each a (1, m) mesh) and on the dry run's ``AbstractMesh``.

Tolerances: a block's split forward, its rows gathered, equals the
one-device block bitwise in float32 (the +-1 products are exact integer
sums and every other op is per position or per head); the gradients, whose
sums over the ranks run in another order, within 5e-5 of each leaf's
largest magnitude (a scalar's gradient sums every position's terms, which
cancel: ctx_beta's is 0.27 from terms near 1, and it lands 1.06e-5 of
that away).  The gradient rule, the sign gathers and the exchanges are
exact."""
import test_torch_threads  # noqa: F401  (first: one torch thread)
import dataclasses
import functools

import pytest
import torch

import test_torch_dist_worlds as worlds
from repro_torch import tree
from repro_torch.configs import base
from repro_torch.core import binarize
from repro_torch.launch import cost, mesh as mesh_lib, specs
from repro_torch.launch.mesh import P
from repro_torch.models import sharding
from repro_torch.models.attention import SPSAttention
from repro_torch.models.linear import pm1_matmul
from repro_torch.models.lm import build_model
from repro_torch.optim.adamw import AdamW
from repro_torch.train.trainer import Trainer, TrainerConfig

B, S, ODD = 2, 16, 7
RTOL, ATOL = 5e-5, 1e-7
# (arch, BinaryConfig overrides): every kind of block, the GQA duplicate
# KV heads, uneven head ranges (smollm's 3 heads), a rank with no head
# (smollm at 4), the row table, the BiT teacher's bit_alpha, windows, the
# QKV bias, cross-attention, and the parts that compute whole
CASES = {"smollm": ("smollm-135m", {}),
         "smollm-row": ("smollm-135m", {"sps_granularity": "row"}),
         "granite-bit-softmax": ("granite-3-2b",
                                 {"attn_mode": "bit_softmax"}),
         "qwen": ("qwen1.5-32b", {}),
         "gemma": ("gemma3-27b", {}),
         "seamless": ("seamless-m4t-large-v2", {}),
         "hymba": ("hymba-1.5b", {}),
         "xlstm": ("xlstm-350m", {}),
         "mixtral": ("mixtral-8x22b", {})}


def _config(arch: str, binary: dict):
    cfg = base.get_smoke_config(arch)
    return cfg.with_(binary=dataclasses.replace(cfg.binary, **binary))


def _blocks(cfg):
    """Each distinct block of the model (kind, window, stack)."""
    seen = {}
    for key, blocks in build_model(cfg).layer_blocks().items():
        for blk in blocks:
            seen.setdefault((key, blk.kind, blk.window, blk.causal), blk)
    return list(seen.values())


def _params(blk, gen):
    """The block's init with every vector and scalar drawn away from its
    init (a zero threshold or a unit scale hides a wrong head)."""
    params = blk.init(gen, "cpu")

    def draw(path, t):
        if path.endswith("w_latent") or t.dim() > 2:
            return t
        if "alpha" in path or "scale" in path:
            return t * (0.5 + torch.rand(t.shape, generator=gen))
        return t + 0.1 * torch.randn(t.shape, generator=gen)
    return tree.unflatten(params, [draw(p, t) for p, t in
                                   tree.leaves_with_paths(params)])


def _close(want: torch.Tensor, got: torch.Tensor) -> bool:
    """Within ``RTOL`` of the leaf's largest magnitude (a gradient summed
    over many positions cancels: an element's own magnitude says little
    of its rounding)."""
    return float((got - want).abs().max()) <= \
        RTOL * float(want.abs().max()) + ATOL


def _grads(loss, leaves):
    return torch.autograd.grad(loss, leaves, allow_unused=True)


def block_case(mesh, blk, s: int, seed: int = 0) -> dict:
    """One block's forward and gradients under the split on ``mesh``
    against the one-device block: {bitwise, the largest relative
    difference of the output, gradients within the tolerance}."""
    cfg = blk.cfg
    gen = torch.Generator().manual_seed(seed)
    params = _params(blk, gen)
    x = torch.randn((B, s, cfg.d_model), generator=gen)
    w = torch.randn((B, s, cfg.d_model), generator=gen)
    mem = (torch.randn((B, 8, cfg.d_model), generator=gen)
           if blk.kind == "dec" else None)

    def run(split, x_in, mem_in, leaves):
        p = tree.unflatten(params, leaves)
        y, aux = blk.qat(p, x_in, memory=mem_in, split=split,
                         collect_scores=True)
        lo, hi = sharding.held(s, split)
        a, b = sharding.loss_rows(s, split)
        loss = (y[:, a - lo:b - lo] * w[:, a:b]).sum()
        scores.append([aux[k].detach() for k in ("attn_scores", "attn_probs")
                       if k in aux])
        return y, loss + aux.get("moe_aux_loss", 0.0)

    scores = []

    leaves1 = [t.clone().requires_grad_() for t in tree.leaves(params)]
    x1 = x.clone().requires_grad_()
    m1 = None if mem is None else mem.clone().requires_grad_()
    y1, loss1 = run(sharding.WHOLE, x1, m1, leaves1)
    g1 = _grads(loss1, leaves1 + [x1] + ([m1] if mem is not None else []))

    with sharding.activation_sharding(mesh, sharding.data_axes(mesh)):
        split = sharding.model_split(s)
        leaves2 = [t.clone().requires_grad_() for t in tree.leaves(params)]
        x2 = sharding.seq_local(x, split).requires_grad_()
        m2 = None if mem is None else mem.clone().requires_grad_()
        y2, loss2 = run(split, x2, m2, leaves2)
        g2 = list(_grads(loss2, leaves2 + [x2] +
                         ([m2] if mem is not None else [])))
        y2 = sharding.seq_gather(y2.detach(), split)
    n = len(leaves2)
    shapes = [t.shape for t in leaves2] + [x.shape] + \
        ([mem.shape] if mem is not None else [])
    for i, g in enumerate(g2):
        g = torch.zeros(x2.shape if i == n else shapes[i]) if g is None \
            else g
        if i == n and split.seq:        # this rank's rows of x
            g2[i] = mesh.all_gather(g.contiguous(), "model", 1)
        else:                           # partial over the ranks: summed
            g2[i] = mesh.all_reduce(g.clone(), "model")
    rel = float(((y2 - y1).abs() / y1.abs().clamp_min(1e-30)).max())
    grads_close = all(_close(torch.zeros_like(b) if a is None else a, b)
                      for a, b in zip(g1, g2))
    return dict(kind=blk.kind, bitwise=torch.equal(y2, y1.detach()) and
                all(torch.equal(a, b) for a, b in zip(*scores)),
                rel=rel, grads=grads_close, seq=split.seq)


def placement_case(mesh) -> dict:
    """A (4, 6) leaf split P(None, "model") on a (1, 2) mesh, gathered
    whole, on the ranks' own blocks and on uneven spans, as values and as
    signs: each gradient against the rule's by hand."""
    r = mesh.index("model")
    full = torch.arange(-12, 12, dtype=torch.float32).reshape(4, 6) / 9
    pl = mesh_lib.Placement(mesh, P(None, "model"), full.shape)
    weights = [torch.arange(24, dtype=torch.float32).reshape(4, 6) / 5 + k
               for k in range(2)]          # rank k's output weights
    out = {}

    def grad_of(fn):
        local = pl.shard(full).requires_grad_()
        y = fn(local)
        (y * weights[r][tuple(slice(0, n) for n in y.shape)]).sum().backward()
        return y.detach(), local.grad

    # whole: the gradient summed over "model", then cut
    y, g = grad_of(pl.gather)
    want = pl.block(weights[0] + weights[1])
    out["whole"] = torch.equal(y, full) and torch.equal(g, want)
    # the ranks' own blocks: no sum over "model"
    own = [(0, 3), (3, 6)]
    y, g = grad_of(lambda t: pl.gather_range(t, 1, own, r))
    out["own"] = (torch.equal(y, pl.block(full)) and
                  torch.equal(g, weights[r][:, :3]))
    # uneven spans (4 and 2 columns): the whole gradient, each rank's in
    # its span, summed, then cut
    spans = [(0, 4), (4, 6)]
    lo, hi = spans[r]
    y, g = grad_of(lambda t: pl.gather_range(t, 1, spans, r))
    placed = torch.zeros(4, 6)
    for k, (a, b) in enumerate(spans):
        placed[:, a:b] += weights[k][:, :b - a]
    out["uneven"] = (torch.equal(y, full[:, lo:hi]) and
                     torch.equal(g, pl.block(placed)))
    # signs: the values of sign_ste, the mask on this rank's block
    y, g = grad_of(lambda t: pl.gather(t, signs=True))
    mask = (full.abs() <= 1.0).float()
    out["signs"] = (torch.equal(y, binarize.sign_ste(full)) and
                    torch.equal(g, pl.block((weights[0] + weights[1]) *
                                            mask)))
    y, g = grad_of(lambda t: pl.gather_range(t, 1, spans, r, signs=True))
    out["signs_uneven"] = (torch.equal(y, binarize.sign_ste(
        full[:, lo:hi])) and torch.equal(g, pl.block(placed * mask)))
    return out


def exchange_case(mesh) -> dict:
    """``seq_gather`` (values and sign bits) and ``to_rows`` (signs and
    {0, 1}, even and uneven spans) against the whole tensors, with their
    backward (each rank's gradient of a fixed weighting)."""
    m, r = mesh.shape["model"], mesh.index("model")
    split = sharding.Split(r, m, mesh, True)
    gen = torch.Generator().manual_seed(3)
    signs = (torch.randn(B, S, 70, generator=gen) >= 0).float() * 2 - 1
    vals = torch.randn(B, S, 70, generator=gen)
    out = {}
    for name, t, as_signs in (("values", vals, False),
                              ("signs", signs, True)):
        local = sharding.seq_local(t, split).requires_grad_()
        got = sharding.seq_gather(local, split, signs=as_signs)
        weight = torch.arange(t.numel(), dtype=torch.float32).reshape(
            t.shape) % 7 + r
        (got * weight).sum().backward()
        want_g = sum(torch.arange(t.numel(), dtype=torch.float32).reshape(
            t.shape) % 7 + k for k in range(m))
        out[name] = (torch.equal(got, t) and torch.equal(
            local.grad, sharding.seq_local(want_g, split)))
    for name, units, signed in (("rows_even", 8 * m, True),
                                ("rows_uneven", 9, True),
                                ("rows_bits", 9, False)):
        spans = sharding.ranges(units, split, 40)
        lo, hi = spans[r]
        whole = torch.randn(B, S, 40 * units, generator=gen)
        whole = (whole >= 0).float() * 2 - 1 if signed else \
            (whole >= 0).float()
        mine = whole[..., lo:hi].clone().requires_grad_()
        got = sharding.to_rows(mine, split, spans, signed)
        weight = torch.randn(whole.shape, generator=gen)
        (got * sharding.seq_local(weight, split)).sum().backward()
        out[name] = (torch.equal(got, sharding.seq_local(whole, split)) and
                     torch.equal(mine.grad, weight[..., lo:hi]))
    return out


def col_product_case(mesh) -> dict:
    """``col_product`` against ``seq_gather`` then the product, on spans
    of their own and on spans two ranks share (a KV head read on both):
    the output, this rank's input gradient and the columns' gradient,
    bitwise (integer weights: every sum is exact in float32)."""
    m, r = mesh.shape["model"], mesh.index("model")
    split = sharding.Split(r, m, mesh, True)
    gen = torch.Generator().manual_seed(5)
    k = 24
    signs = (torch.randn(B, S, k, generator=gen) >= 0).float() * 2 - 1
    out = {}
    for name, spans in (("own", sharding.ranges(2 * m + 1, split, 8)),
                        ("shared", [(j // 2 * 8, j // 2 * 8 + 8)
                                    for j in range(m)])):
        leaf = torch.randn(k, max(hi for _, hi in spans), generator=gen)
        lo, hi = spans[r]
        weight = (torch.arange(B * S * (hi - lo)).reshape(B, S, hi - lo)
                  % 5 - 2 + r).float()
        got = []
        for route in ("col_product", "gather"):
            own = sharding.seq_local(signs, split).requires_grad_()
            w = ((leaf[:, lo:hi] >= 0).float() * 2 - 1).requires_grad_()
            every = sharding.seq_gather(own, split, signs=True)
            y = (sharding.col_product(own, every, w, leaf, split, spans,
                                      torch.float32)
                 if route == "col_product" else
                 pm1_matmul(every, w, torch.float32))
            (y * weight).sum().backward()
            got.append((y, own.grad, w.grad))
        out[name] = all(torch.equal(a, b) for a, b in zip(*got))
    return out


def units_job():
    """Everything of this file on a (1, world) mesh."""
    mesh = mesh_lib.make_host_mesh(torch.distributed.get_world_size(), "cpu")
    blocks = {name: [block_case(mesh, blk, S) for blk in
                     _blocks(_config(arch, binary))]
              for name, (arch, binary) in CASES.items()}
    out = dict(blocks=blocks, exchange=exchange_case(mesh),
               col_product=col_product_case(mesh))
    if mesh.shape["model"] == 2:
        out["odd"] = [block_case(mesh, blk, ODD) for blk in
                      _blocks(_config("smollm-135m", {}))]
        out["placement"] = placement_case(mesh)
    return out


@functools.lru_cache(maxsize=None)
def _world(size: int):
    return worlds.run_world(size, units_job)


def test_split_range_gives_ceil_to_the_first_ranks():
    """n units over m ranks: the first n % m ranks take ceil(n / m), the
    rest floor(n / m), contiguous and in order; rank 0 holds the most."""
    for n, m in ((40, 16), (9, 16), (9, 4), (27392, 16), (3, 2), (16, 16)):
        spans = sharding.ranges(n, sharding.Split(0, m))
        assert spans[0][0] == 0 and spans[-1][1] == n
        assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
        sizes = [hi - lo for lo, hi in spans]
        assert sizes == [-(-n // m)] * (n % m) + [n // m] * (m - n % m)
        assert sizes[0] == max(sizes)
    assert sharding.split_range(40, 0, 16) == (0, 3)
    assert sharding.split_range(40, 15, 16) == (38, 40)
    assert sharding.split_range(9, 12, 16) == (9, 9)     # no head
    assert sharding.ranges(8, sharding.WHOLE, 32) == [(0, 256)]


def test_head_ranges_read_their_kv_heads():
    """Each rank's KV heads are the ones its query heads read: a KV head
    shared by two ranks (granite's 8 KV heads on 16) is on both."""
    attn = SPSAttention(d_model=2048, num_heads=32, num_kv_heads=8,
                        head_dim=64)
    qs, kvs = attn.head_ranges(sharding.Split(0, 16))
    assert qs == [(2 * r, 2 * r + 2) for r in range(16)]
    assert kvs == [(r // 2, r // 2 + 1) for r in range(16)]
    qwen = SPSAttention(d_model=5120, num_heads=40, num_kv_heads=40,
                        head_dim=128)
    qs, kvs = qwen.head_ranges(sharding.Split(0, 16))
    assert qs == kvs and [hi - lo for lo, hi in qs] == [3] * 8 + [2] * 8
    smol = SPSAttention(d_model=576, num_heads=9, num_kv_heads=3,
                        head_dim=64)
    qs, kvs = smol.head_ranges(sharding.Split(0, 4))
    assert qs == [(0, 3), (3, 5), (5, 7), (7, 9)]
    assert kvs == [(0, 1), (1, 2), (1, 3), (2, 3)]
    assert smol.head_ranges() == ([(0, 9)], [(0, 3)])


@pytest.mark.parametrize("case", list(CASES))
def test_block_split_forward_is_the_one_device_block(case):
    """Every distinct block of the arch at (1, 2) and (1, 4): this rank's
    rows of the split forward, gathered, equal the one-device block's
    output bitwise, and the attention's collected scores and
    probabilities, gathered over the heads, its; the ranks' gradients
    (params and memory summed over the ranks, the input's rows gathered)
    equal its gradients within the tolerance."""
    for size in (2, 4):
        for rank in _world(size):
            for r in rank["blocks"][case]:
                assert r["seq"]
                assert r["bitwise"], (size, r)
                assert r["grads"], (size, r)


def test_a_sequence_that_model_does_not_divide_stays_whole():
    """A sequence of 7 positions on 2 ranks: every rank holds it whole,
    the row-parallel exchange gathers the columns, each rank counts the
    loss of its split_range of the rows; the forward is bitwise the
    one-device block's and the gradients, summed over the ranks, its."""
    for rank in _world(2):
        for r in rank["odd"]:
            assert not r["seq"] and r["bitwise"] and r["grads"], r


def test_the_gradient_rule_of_a_placement():
    """A leaf split over "model": gathered whole, its gradient is summed
    over "model" and cut to the block; gathered on the ranks' own blocks
    it is not summed; on uneven spans each rank's span of the gradient is
    summed; as signs, the values are sign_ste's and the straight-through
    mask applies to the block of the summed gradient."""
    for rank in _world(2):
        assert rank["placement"] == {"whole": True, "own": True,
                                     "uneven": True, "signs": True,
                                     "signs_uneven": True}


def test_exchanges_round_trip():
    """``seq_gather`` of values and of sign bits gives the whole sequence
    and reduce-scatters the gradient; ``to_rows`` of +-1 and {0, 1}
    values on even and uneven spans gives every column of this rank's
    rows and sends each rank its columns of the gradient; exact, at 2
    and 4 ranks."""
    for size in (2, 4):
        for rank in _world(size):
            assert all(rank["exchange"].values()), rank["exchange"]


def test_col_product_sends_the_gradient_to_the_positions_ranks():
    """A column product on a split sequence, whose input gradient goes to
    the positions' ranks by an all-to-all and one product with the whole
    weight's signs, equals gathering the input and multiplying: output,
    input gradient and the columns' gradient bitwise, on spans of each
    rank's own and on spans two ranks share, at 2 and 4 ranks."""
    for size in (2, 4):
        for rank in _world(size):
            assert all(rank["col_product"].values()), rank["col_product"]


def test_the_split_follows_the_mesh():
    """A mesh context splits the compute along "model" wherever the axis
    is wider than one (no switch): this rank's index and the width, the
    sequence split where the width divides it and whole where not;
    outside a context, or at a width of one, ``WHOLE``."""
    assert sharding.model_split(16) is sharding.WHOLE
    for shape, want in (((1, 4), (0, 4)), ((4, 1), None), ((2, 2), (0, 2))):
        mesh = mesh_lib.AbstractMesh(shape, ("data", "model"))
        with sharding.activation_sharding(mesh, sharding.data_axes(mesh)):
            got = sharding.model_split(16)
            if want is None:
                assert got is sharding.WHOLE
                continue
            assert (got.index, got.width, got.seq) == want + (True,)
            assert got.mesh is mesh and not sharding.model_split(7).seq


def test_a_reduce_scatter_counts_what_a_rank_sends():
    """The census counts a reduce-scatter by its input, the bytes a rank
    sends (m times its result), as an all-gather by its result; once a
    call over several axes."""
    mesh = mesh_lib.AbstractMesh((2, 4), ("data", "model"))
    x = torch.empty(16, 6, device="meta")

    def step(x):
        return (mesh.reduce_scatter(x, "model", 0),
                mesh.reduce_scatter(x, ("data", "model"), 0),
                mesh.all_gather(x, "model", 1))

    census, (one, both, gathered) = cost.measure(step, (x,))
    assert one.shape == (4, 6) and both.shape == (2, 6)
    assert census.collectives["reduce-scatter"] == 2 * 16 * 6 * 4
    assert census.collectives["all-gather"] == 16 * 24 * 4


def _census(shape):
    cfg = worlds.config("granite-3-2b")
    mesh = mesh_lib.AbstractMesh(shape, ("data", "model"))
    tr = Trainer(build_model(cfg), AdamW(lr=worlds.LR), TrainerConfig(),
                 device=torch.device("meta"), mesh=mesh)
    batch = {k: torch.empty(v.shape, dtype=torch.as_tensor(v).dtype,
                            device="meta")
             for k, v in worlds.SyntheticStream(
                 cfg, worlds.SEQ, worlds.BATCH, seed=0).batch_at(0).items()}
    census, _ = cost.measure(lambda st: tr.train_step(st, batch),
                             (specs.train_state_specs(tr),))
    return cfg, census


def test_census_of_the_split_granite_step():
    """The granite smoke train step traced on a (1, 4) AbstractMesh: its
    dense FLOPs per rank are a quarter of (1, 1)'s but for the KV heads
    two query-head ranks share (each of its 2 KV heads is computed on 2
    of the 4 ranks: k and v at 1/2, not 1/4, forward and both backward
    products); it counts the reduce-scatters and all-to-alls that (1, 1)
    does not run."""
    cfg, one = _census((1, 1))
    _, four = _census((1, 4))
    t = worlds.BATCH * worlds.SEQ
    kv_dim = cfg.num_kv_heads * cfg.resolved_head_dim
    # per layer: k and v, each 3 products of 2 * t * d * (kv/2 - kv/4)
    extra = cfg.num_layers * 2 * 3 * 2 * t * cfg.d_model * kv_dim // 4
    assert 4 * four.flops == one.flops + 4 * extra
    assert one.collectives["reduce-scatter"] == 0
    assert one.collectives["all-to-all"] == 0
    assert four.collectives["reduce-scatter"] > 0
    assert four.collectives["all-to-all"] > 0
