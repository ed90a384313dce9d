"""Sharding specs and the activation-sharding context (port of
``repro.models.sharding``): models stay mesh-agnostic, the trainer opts in.

``PartitionSpec`` (``P``) is the port's own counterpart of JAX's: one
entry per dimension, each None (whole), an axis name, or a tuple of axis
names.  It is a leaf of ``repro_torch.tree`` (not a tuple), so a spec tree
mirrors the param tree it describes.

``with activation_sharding(mesh, data_axes):`` is what the trainer's mesh
step runs the model's loss in.  The trainer splits the batch over the
data axes; on a mesh whose "model" axis is wider than one, a QAT face
also splits its compute along "model", as the JAX package's param specs
and ``constrain`` name it (``Split``, from ``model_split(n)`` for a
stream of n positions):
  * the residual stream between blocks holds this rank's block of the
    sequence (``constrain(x, "batch", "model", None)`` cuts it; a length
    that "model" does not divide stays whole on every rank);
  * a block gathers its normed input along the sequence (``seq_gather``;
    the attention's and the FFN's as sign bits, ``signs=True``), computes
    its attention on this rank's query heads and its FFN on this rank's
    d_ff columns (``split_range``: the first n % m ranks take ceil(n/m)
    units, the rest floor(n/m)); the context's and the mid-activation's
    binary values then go to the ranks whose positions they are
    (``to_rows``: an all-to-all of packed bits), and ``wo`` and ``w2``
    multiply this rank's positions by their whole weights;
  * what still computes whole (recurrent cells, the Mamba branch) runs
    on the gathered sequence and keeps this rank's rows (``seq_local``);
    a MoE routes and runs this rank's positions (``claim_offsets``,
    ``to_experts``, ``from_experts``).
Each is an ``autograd.Function``: an all-gather's backward is a
reduce-scatter, an all-to-all's the all-to-all back; the column products
that read a gathered input (``col_product``: ``wq``/``wk``/``wv``,
``w1``/``w3``) send their output's gradient to the positions' ranks by an
all-to-all instead, each rank's span of columns (B S c / m values where
the reduce-scatter of the input's gradient would move B S d).  A block's binary
weights travel as sign bits (``columns(..., signs=True)``,
``whole(..., signs=True)``: the forward reads nothing else of a latent
weight, and the straight-through mask applies to this rank's block after
the gradient's reduction).  At a "model" axis of one every one of them
is the identity, and the code path is the one a single device runs.  What
the port's model asks of the context on a data axis wider than one:
  * ``batch_sum`` — a count over the global batch (the loss's number of
    valid labels, with ``seq=True`` over the ranks' sequence blocks too);
  * ``claim_shares`` / ``claim_offsets`` — the shares of a MoE's batch and
    its claims' global slots from every share's counts (in global token
    order: the capacity and the slots of the global batch);
  * ``materialize`` / ``columns`` — a layer's params gathered whole, or on
    this rank's range, where the layer runs (``Gathered`` leaves: the
    port's just-in-time all-gather of FSDP-sharded params, which XLA
    inserts in the JAX package).
Outside a context, or on axes of one index, each gives its argument back.

A rank's block of a leaf carries its ``launch.mesh.Placement``: ``place``
marks it, ``placement_of`` reads it, and ``rows_split`` says whether a
placed batch's rows are split over the data axes (``data_axes``); the
models' deploy faces on a mesh read them.

The context is the process's, not a thread's (JAX keeps it per thread):
a block's checkpoint recomputes the block inside the backward, which on
the card runs on autograd's own device thread, and the recomputation
must route and gather as the forward did.
"""
from __future__ import annotations

import contextlib
import math
from typing import (Any, Callable, List, NamedTuple, Optional,
                    Sequence, Tuple)

import torch

from repro_torch import tree

# [the context in force]: (mesh, data axes), or None
_CTX: List[Optional[Tuple[Any, Tuple[str, ...]]]] = [None]


class PartitionSpec:
    """Per-dimension mesh axes of one leaf; compares by its entries."""
    __slots__ = ("entries",)

    def __init__(self, *entries):
        self.entries = tuple(entries)

    def __iter__(self):
        return iter(self.entries)

    def __len__(self) -> int:
        return len(self.entries)

    def __getitem__(self, i):
        return self.entries[i]

    def __eq__(self, other) -> bool:
        return isinstance(other, PartitionSpec) and \
            self.entries == other.entries

    def __hash__(self) -> int:
        return hash(self.entries)

    def __repr__(self) -> str:
        return f"P{self.entries!r}"


P = PartitionSpec


class Gathered:
    """A param leaf held as this rank's shard (``local``); ``gather(local)``
    gives the whole leaf, differentiably (its backward reduces the
    gradient to the shard).  With its ``placement`` (a
    ``launch.mesh.Placement``) it can also be gathered on a range of one
    dim (``columns``)."""
    __slots__ = ("local", "gather", "placement")

    def __init__(self, local: torch.Tensor,
                 gather: Callable[[torch.Tensor], torch.Tensor],
                 placement: Any = None):
        self.local, self.gather, self.placement = local, gather, placement


@contextlib.contextmanager
def activation_sharding(mesh, data_axes: Sequence[str]):
    """Run model code on ``mesh`` with the global batch split over
    ``data_axes`` (``mesh``: ``repro_torch.launch.mesh.Mesh``), and the
    QAT faces' compute split along its "model" axis (``model_split``)."""
    prev = _CTX[0]
    _CTX[0] = (mesh, tuple(data_axes))
    try:
        yield
    finally:
        _CTX[0] = prev


def current() -> Optional[Tuple[Any, Tuple[str, ...]]]:
    return _CTX[0]


def batch_axes() -> Tuple[str, ...]:
    ctx = current()
    return ctx[1] if ctx else ("data",)


def _split_mesh():
    """The context's mesh when its data axes hold more than one index."""
    ctx = current()
    if ctx is None or ctx[0].data_size == 1:
        return None
    return ctx[0]


def batch_sum(t: torch.Tensor, seq: bool = False) -> torch.Tensor:
    """``t`` summed over the data indices (no gradient); with ``seq`` also
    over "model" where the compute is split along it, whose ranks count
    their own rows of the sequence (the loss's valid labels)."""
    axes = batch_axes() if _split_mesh() is not None else ()
    if seq and model_split(0).width > 1:
        axes = axes + ("model",)
    if not axes:
        return t
    return current()[0].all_reduce(t.detach().clone(), axes)


# ---------------------------------------------------------------------------
# The compute split along "model"
# ---------------------------------------------------------------------------


class Split(NamedTuple):
    """This rank's share of the compute along "model" for one stream of
    positions: its ``index`` on the axis, the axis' ``width``, the
    ``mesh`` that runs the collectives, and whether the stream's sequence
    is split (``seq``: each rank holds a block of it) or whole on every
    rank (a length the width does not divide).  ``WHOLE`` is one device's
    (and a "model" axis of one's): every function below gives its
    argument back."""
    index: int = 0
    width: int = 1
    mesh: Any = None
    seq: bool = False


WHOLE = Split()


def model_split(n: int) -> Split:
    """The split in force for a stream of ``n`` positions; ``WHOLE``
    outside a context, or on a mesh without a "model" axis wider than
    one."""
    ctx = current()
    if ctx is None:
        return WHOLE
    mesh = ctx[0]
    m = getattr(mesh, "shape", {}).get("model", 1)
    if m == 1:
        return WHOLE
    return Split(mesh.index("model"), m, mesh, n % m == 0)


def split_range(n: int, index: int, width: int) -> Tuple[int, int]:
    """[lo, hi) of rank ``index``'s share of ``n`` units over ``width``
    ranks: the first n % width ranks take ceil(n / width) units, the rest
    floor(n / width) (so index 0 holds the largest share; a rank may hold
    none)."""
    q, rem = divmod(n, width)
    lo = index * q + min(index, rem)
    return lo, lo + q + (index < rem)


def ranges(n: int, split: Split, unit: int = 1) -> List[Tuple[int, int]]:
    """Every rank's ``split_range`` of ``n`` units, in elements of
    ``unit`` each (heads of ``unit`` columns), in rank order."""
    return [(lo * unit, hi * unit) for lo, hi in
            (split_range(n, r, split.width) for r in range(split.width))]


def held(n: int, split: Split) -> Tuple[int, int]:
    """[lo, hi) of the positions of a stream of ``n`` this rank holds: its
    block of the sequence, or all of them when the sequence is whole."""
    if not split.seq:
        return 0, n
    b = n // split.width
    return split.index * b, (split.index + 1) * b


def loss_rows(n: int, split: Split) -> Tuple[int, int]:
    """[lo, hi) of the positions whose loss this rank counts: the ones it
    holds, or its ``split_range`` of a sequence whole on every rank (each
    position counted once over the ranks)."""
    if split.seq or split.width == 1:
        return held(n, split)
    return split_range(n, split.index, split.width)


def constrain(x, *axes):
    """JAX's activation constraint, for a whole ``x``: where the context
    splits the compute and an entry is "model", this rank's block of that
    dim (``seq_local``: the residual stream's sequence); the batch is
    split by the trainer and None stays whole, so otherwise ``x``
    itself."""
    for d, a in enumerate(axes):
        if a == "model":
            x = seq_local(x, model_split(x.shape[d]), dim=d)
    return x


def seq_local(x: torch.Tensor, split: Split, dim: int = 1) -> torch.Tensor:
    """This rank's block of the whole ``x`` along the sequence (``dim``),
    in memory of its own; ``x`` itself when the sequence is whole.  Its
    backward puts the gradient back in place, zeros elsewhere."""
    if not split.seq:
        return x
    lo, hi = held(x.shape[dim], split)
    return x.narrow(dim, lo, hi - lo).clone(
        memory_format=torch.contiguous_format)


class _SeqGather(torch.autograd.Function):
    """The ranks' blocks of the sequence gathered whole (optionally as
    packed sign bits); backward: the gradient summed over "model" and cut
    to this rank's block (a reduce-scatter)."""

    @staticmethod
    def forward(ctx, x, split, dim, signs):
        ctx.split, ctx.dim = split, dim
        mesh = split.mesh
        if not signs:
            return mesh.all_gather(x, "model", dim)
        # +-1 values along the last dim, 1 bit each on the wire
        words = mesh.all_gather(to_words(x, True), "model", dim)
        return from_words(words, x.shape[-1], True, x.dtype)

    @staticmethod
    def backward(ctx, g):
        dt = g.dtype
        out = ctx.split.mesh.reduce_scatter(g.to(torch.float32), "model",
                                            ctx.dim)
        return out.to(dt), None, None, None


def seq_gather(x: torch.Tensor, split: Split, dim: int = 1,
               signs: bool = False) -> torch.Tensor:
    """This rank's block of the sequence (``dim``) -> the whole sequence
    (all-gather over "model"); ``signs``: ``x`` holds +-1 values only,
    which travel as packed bits.  ``x`` itself when the sequence is
    whole."""
    if not split.seq:
        return x
    return _SeqGather.apply(x, split, dim, signs)


def to_words(t: torch.Tensor, signed: bool) -> torch.Tensor:
    """Packed bits (int32 words along the last dim, by the pack kernel) of
    +-1 (``signed``: bit = t >= 0) or {0, 1} values."""
    from repro_torch.kernels.pack import ops as pack_ops
    if t.shape[-1] == 0:            # a rank with no head sends no word
        return t.new_zeros(t.shape, dtype=torch.int32)
    theta = torch.full((), 0.0 if signed else 0.5, dtype=torch.float32,
                       device=t.device)
    return pack_ops.pack_threshold(t.to(torch.float32), theta)


def from_words(words: torch.Tensor, k: int, signed: bool,
               dtype: torch.dtype) -> torch.Tensor:
    """``to_words``' values back, the first ``k`` along the last dim, in
    ``dtype``."""
    from repro_torch.core import packing
    bits = packing.unpack_bits(words[..., :packing.packed_len(k)], k)
    return (2 * bits - 1 if signed else bits).to(dtype)


def _column_index(spans: Sequence[Tuple[int, int]], most: int,
                  device) -> Optional[torch.Tensor]:
    """The index that takes every rank's span out of a layout of ``most``
    columns a rank: None where every span fills its ``most``."""
    if all(hi - lo == most for lo, hi in spans):
        return None
    return torch.tensor([j * most + c for j, (lo, hi) in enumerate(spans)
                         for c in range(hi - lo)], device=device)


class _ToRows(torch.autograd.Function):
    """Every rank's columns (its span) of every position -> every column
    of this rank's positions, the values travelling as packed bits (an
    all-to-all; an all-gather along the columns where the sequence is
    whole).  Backward: each rank's columns of the gradient sent back to
    it (an all-to-all; a reduce-scatter along the columns, in float32,
    where the sequence is whole)."""

    @staticmethod
    def forward(ctx, t, split, spans, signed):
        from repro_torch.core import packing
        ctx.split, ctx.spans = split, spans
        mesh, m = split.mesh, split.width
        bits = 32 * packing.packed_len(max(hi - lo for lo, hi in spans))
        b, s, c = t.shape
        if split.seq:       # chunks by the rank whose rows they are
            t = t.reshape(b, m, s // m, c).transpose(0, 1)
        words = to_words(t, signed)
        pad = bits // 32 - words.shape[-1]
        if pad:
            words = torch.cat([words, words.new_zeros(
                words.shape[:-1] + (pad,))], -1)
        if split.seq:
            got = mesh.all_to_all(words.contiguous(), "model")
        else:
            got = mesh.all_gather(words[None], "model", 0)
        vals = from_words(got, bits, signed, t.dtype)   # (m, B, S', bits)
        vals = vals.movedim(0, -2).reshape(vals.shape[1:3] + (m * bits,))
        idx = _column_index(spans, bits, t.device)
        return vals if idx is None else vals.index_select(-1, idx)

    @staticmethod
    def backward(ctx, g):
        split, spans = ctx.split, ctx.spans
        mesh, m = split.mesh, split.width
        most = max(hi - lo for lo, hi in spans)
        lo, hi = spans[split.index]
        g32 = g.to(torch.float32)
        idx = _column_index(spans, most, g.device)
        if idx is not None:         # every rank's span padded to ``most``
            g32 = g32.new_zeros(g32.shape[:-1] + (m * most,)).index_copy_(
                -1, idx, g32)
        parts = g32.reshape(g32.shape[:2] + (m, most)).movedim(2, 0)
        if split.seq:
            got = mesh.all_to_all(parts.contiguous(), "model")
            out = got.transpose(0, 1).reshape(got.shape[1], -1, most)
        else:
            out = mesh.reduce_scatter(parts.contiguous(), "model", 0)[0]
        return out[..., :hi - lo].to(g.dtype), None, None, None


def to_rows(t: torch.Tensor, split: Split,
            spans: Sequence[Tuple[int, int]],
            signed: bool = True) -> torch.Tensor:
    """``t`` (B, S, c): +-1 (``signed``) or {0, 1} values of this rank's
    span ``spans[split.index]`` of C columns (every rank's span given: a
    head range's context, a d_ff range's mid-activation) at every
    position -> (B, S_held, C): every rank's columns of this rank's
    positions (``held``), where the next product runs on whole weights.
    ``t`` itself on one rank."""
    if split.width == 1:
        return t
    return _ToRows.apply(t, split, tuple(spans), signed)


def _rows_of(t: torch.Tensor, split: Split,
             spans: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """``t`` (B, S, c): this rank's span of columns at every position of a
    split sequence -> (B, S_held, sum of the spans): every rank's span at
    this rank's positions, in rank order (an all-to-all, in ``t``'s
    dtype)."""
    mesh, m = split.mesh, split.width
    most = max(hi - lo for lo, hi in spans)
    b, s, c = t.shape
    if c < most:
        t = torch.cat([t, t.new_zeros((b, s, most - c))], -1)
    got = mesh.all_to_all(
        t.reshape(b, m, s // m, most).transpose(0, 1).contiguous(), "model")
    vals = got.movedim(0, -2).reshape(b, s // m, m * most)
    idx = _column_index(spans, most, t.device)
    return vals if idx is None else vals.index_select(-1, idx)


class _ColProduct(torch.autograd.Function):
    """``pm1_matmul(every, w_cols)``, whose input gradient goes to the
    ranks whose positions it is: each rank's output gradient at every
    position is sent to the position's rank (``_rows_of``), which
    multiplies its positions' gradient of every rank's span by the whole
    weight's signs in one product (in place of a reduce-scatter of every
    position's partial input gradient: B S sum(spans) / m values a rank
    where that would move B S K)."""

    @staticmethod
    def forward(ctx, own, every, w_cols, leaf, split, spans, dtype):
        ctx.save_for_backward(every, w_cols)
        ctx.leaf, ctx.split, ctx.spans, ctx.dtype = leaf, split, spans, dtype
        ctx.own_dtype = own.dtype
        return torch.matmul(every.to(dtype).to(torch.float32),
                            w_cols.to(dtype).to(torch.float32))

    @staticmethod
    def backward(ctx, g):
        every, w_cols = ctx.saved_tensors
        dt = ctx.dtype
        dw = torch.matmul(
            every.to(dt).to(torch.float32).flatten(0, -2).transpose(0, 1),
            g.flatten(0, -2))
        w = whole_signs(ctx.leaf)
        w = torch.cat([w[:, lo:hi] for lo, hi in ctx.spans], 1)
        d_own = torch.matmul(_rows_of(g, ctx.split, ctx.spans),
                             w.to(dt).to(torch.float32).transpose(0, 1))
        return (d_own.to(dt).to(ctx.own_dtype), None,
                dw.to(dt).to(w_cols.dtype), None, None, None, None)


def col_product(own: torch.Tensor, every: torch.Tensor, w_cols: torch.Tensor,
                leaf, split: Split, spans: Sequence[Tuple[int, int]],
                dtype: torch.dtype) -> torch.Tensor:
    """A column range's +-1 product on a split sequence: ``every`` (B, S,
    K), the +-1 values of every position (``seq_gather`` of ``own``,
    detached), times ``w_cols`` (K, c), the signs of this rank's span
    ``spans[split.index]`` of the weight ``leaf`` (K, C), summed in float32
    as ``linear.pm1_matmul``; the gradient goes to ``own`` (this rank's
    positions, B, S_held, K) and ``w_cols``.  ``pm1_matmul(own, w_cols)``
    itself where the sequence is whole."""
    if not split.seq:
        from repro_torch.models.linear import pm1_matmul
        return pm1_matmul(own, w_cols, dtype)
    return _ColProduct.apply(own, every.detach(), w_cols, leaf, split,
                             tuple(spans), dtype)


def whole_signs(leaf) -> torch.Tensor:
    """sign(leaf) (+-1, sign(0) = +1) of a whole ``Gathered`` leaf or a
    tensor, with no gradient (a placed leaf's travelling as bits)."""
    if isinstance(leaf, Gathered) and leaf.placement is not None:
        return leaf.placement.whole(leaf.local, signs=True)
    t = (leaf.gather(leaf.local) if isinstance(leaf, Gathered)
         else leaf).detach()
    return (t >= 0).to(t.dtype) * 2 - 1


def gather_heads(t: torch.Tensor, split: Split, dim: int,
                 spans: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """Every rank's ``t`` (its ``spans[rank]`` of a dim split unevenly)
    put together whole along ``dim`` (no gradient: ``collect_scores``)."""
    if split.width == 1:
        return t
    most = max(hi - lo for lo, hi in spans)
    pad = list(t.shape)
    pad[dim] = most - t.shape[dim]
    t = torch.cat([t.detach(), t.new_zeros(pad)], dim=dim)
    every = split.mesh.all_gather(t, "model", dim)
    return torch.cat([every.narrow(dim, r * most, hi - lo)
                      for r, (lo, hi) in enumerate(spans)], dim=dim)


def data_axes(mesh) -> Tuple[str, ...]:
    """The axes of ``mesh`` that split the batch, slow to fast."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def place(local: torch.Tensor, placement) -> torch.Tensor:
    """``local`` (this rank's block) marked with its ``placement`` (a
    ``launch.mesh.Placement``)."""
    local.placement = placement
    return local


def placement_of(t: torch.Tensor):
    pl = getattr(t, "placement", None)
    if pl is None:
        raise ValueError(f"a mesh face takes placed shards (place); got a "
                         f"tensor of shape {tuple(t.shape)} without a "
                         f"placement")
    return pl


def rows_split(mesh, t: torch.Tensor) -> bool:
    """Are the rows (dim 0) of placed ``t`` split over the data axes (the
    batch of a mesh face; unplaced rows are whole)?"""
    pl = getattr(t, "placement", None)
    return pl is not None and any(
        d == 0 and set(axes) <= set(data_axes(mesh)) for axes, d in pl.splits)


def whole(leaf, signs: bool = False) -> torch.Tensor:
    """A ``Gathered`` leaf gathered whole; a tensor as it is.  ``signs``:
    sign(leaf) (+-1, sign(0) = +1) through the straight-through estimator,
    a placed leaf's travelling as bits (``Placement.gather``)."""
    if isinstance(leaf, Gathered) and leaf.placement is not None:
        return leaf.placement.gather(leaf.local, signs=signs)
    t = leaf.gather(leaf.local) if isinstance(leaf, Gathered) else leaf
    if signs:
        from repro_torch.core import binarize
        return binarize.sign_ste(t)
    return t


def materialize(params: Any) -> Any:
    """``params`` with each ``Gathered`` leaf gathered whole."""
    return tree.map(whole, params)


def columns(leaf, dim: int, spans: Sequence[Tuple[int, int]],
            split: Split = WHOLE, signs: bool = False) -> torch.Tensor:
    """This rank's span (``spans[split.index]``, every rank's given) of
    ``leaf`` along ``dim``: a placed ``Gathered`` leaf gathered for it
    (``Placement.gather_range``), else the whole leaf narrowed (itself
    when the span is all of it).  ``signs`` as in ``whole``."""
    lo, hi = spans[split.index]
    if isinstance(leaf, Gathered) and leaf.placement is not None:
        pl = leaf.placement
        dim %= len(pl.shape)
        if (lo, hi) == (0, pl.shape[dim]):
            return pl.gather(leaf.local, signs=signs)
        return pl.gather_range(leaf.local, dim, spans, split.index,
                               signs=signs)
    t = whole(leaf)
    if (lo, hi) != (0, t.shape[dim]):
        t = t.narrow(dim, lo, hi - lo)
    return whole(t, signs) if signs else t


# ---------------------------------------------------------------------------
# The deploy decode on a mesh: each product on this rank's block of its
# weight (``models.linear.rbmm_placed``), attention on this rank's heads
# (``SPSAttention.deploy_decode``), the embedding and the head on
# vocabulary blocks (``models.nn``); what crosses "model" is activations.
# ---------------------------------------------------------------------------

# the leaves a decode step computes with whole on every rank, gathered
# whole where they run (by the end of their path in a block's params): the
# Mamba branch's float32 leaves and the sLSTM's forget bias (the
# recurrences' per-position math), the mLSTM's fp gate projection and the
# MoE's router.  Every other leaf is read as this rank's block.
WHOLE_PARTS = ("mamba/conv_w", "mamba/conv_b", "mamba/x_proj",
               "mamba/dt_proj", "mamba/dt_bias", "mamba/a_log",
               "mamba/d_skip", "cell/f_bias", "cell/w_gates",
               "cell/b_gates", "router/kernel")


def kept_whole(path: str) -> bool:
    """Is the leaf at ``path`` one of ``WHOLE_PARTS``?"""
    return any(path == p or path.endswith("/" + p) for p in WHOLE_PARTS)


def decode_split(t) -> Split:
    """The "model" axis a decode step's products on placed ``t`` run
    over: this rank's index and the axis' width on ``t``'s mesh; ``WHOLE``
    for an unplaced tensor or an axis of one (every exchange below is then
    the identity)."""
    pl = getattr(t, "placement", None)
    m = 1 if pl is None else pl.mesh.shape.get("model", 1)
    if m == 1:
        return WHOLE
    return Split(pl.mesh.index("model"), m, pl.mesh)


def placed_block(t, dims: Sequence[int]) -> Tuple[Optional[int], int, int]:
    """The decode rule's reading of a leaf: (the dim of ``t`` split along
    "model", this rank's block [lo, hi) of it), or (None, 0, dim 0's
    size) where ``t`` is whole.  Raises for a split the rule cannot
    compute on: over other axes than "model", or on a dim not in
    ``dims``."""
    pl = getattr(t, "placement", None)
    if pl is None or not pl.splits:
        return None, 0, t.shape[0] if t.dim() else 0
    allowed = {d % len(pl.shape) for d in dims}
    for axes, d in pl.splits:
        if tuple(axes) != ("model",) or d not in allowed:
            raise ValueError(f"a decode step computes on a leaf split along "
                             f"\"model\" on dims {sorted(allowed)}; got "
                             f"{pl}")
    d = pl.splits[0][1]
    return (d,) + pl.span(d)


def take_cols(y: torch.Tensor, split: Split, own: Tuple[int, int], n: int,
              cols=None) -> torch.Tensor:
    """``y`` (..., hi - lo): this rank's columns ``own`` = [lo, hi) of n
    (all n, or its block of a product split on its output rows, the
    ranks' blocks equal and in rank order) -> this rank's columns of
    ``cols``: the columns [lo, hi) every "model" rank wants, in rank order
    (or one pair for all; default all n).  Narrowed where every rank's
    block holds what it wants, else all-gathered over "model" first (each
    rank decides alike, so each runs the same collectives)."""
    cols = (0, n) if cols is None else cols
    every = [cols] * split.width if isinstance(cols[0], int) else cols
    a, b = every[split.index]
    lo, hi = own
    blk = hi - lo
    if blk < n and not all(r * blk <= ca and cb <= (r + 1) * blk
                           for r, (ca, cb) in enumerate(every)):
        y = split.mesh.all_gather(y.contiguous(), "model", y.dim() - 1)
        lo = 0
    if (a - lo, b - lo) == (0, y.shape[-1]):
        return y
    return y[..., a - lo:b - lo]


def join_bits(words: torch.Tensor, split: Split,
              spans: Sequence[Tuple[int, int]], n: int) -> torch.Tensor:
    """``words`` (..., ceil((hi - lo) / 32)): the packed bits of this
    rank's span ``spans[split.index]`` = [lo, hi) of n binary columns
    (every rank's span given, in order, covering [0, n)) -> the packed
    bits of all n columns, every span in its place: the words
    all-gathered where each span starts on a word, else the bits, one
    byte each.  ``words`` itself on one rank."""
    from repro_torch.core import packing
    if split.width == 1:
        return words
    if all(lo % packing.WORD == 0 for lo, _ in spans):
        w_spans = [(lo // packing.WORD, packing.packed_len(hi))
                   for lo, hi in spans]
        return gather_heads(words, split, words.dim() - 1, w_spans)
    lo, hi = spans[split.index]
    vals = packing.unpack_bits(words, hi - lo).to(torch.uint8)
    every = gather_heads(vals, split, vals.dim() - 1, spans)
    return packing.pack_bits(every.bool())


# ---------------------------------------------------------------------------
# The deploy prefill on a mesh: each rank computes its block of the
# sequence on whole 1-bit weights (gathered a block at a time), attention
# on its query heads over the whole sequence; what crosses "model" is the
# heads' packed bits (``to_heads``, then ``_rows_of`` of the context's
# words), and the embedding's and the head's rows or vocabulary blocks.
# ---------------------------------------------------------------------------


def prefill_split(mesh, n: int) -> Optional[Split]:
    """The split of a mesh prefill's stream of ``n`` positions along
    "model": rank r holds positions [r n / m, (r + 1) n / m), where m
    divides n into blocks of whole 32-bit words (V^T packs along a block
    as along the whole sequence); any length on an axis of one.  None
    where the blocks would not be whole words (the stream stays whole on
    every rank)."""
    m = mesh.shape.get("model", 1)
    if m > 1 and (n % m or (n // m) % 32):
        return None
    return Split(mesh.index("model") if m > 1 else 0, m, mesh, True)


def to_heads(parts: Sequence[Tuple[torch.Tensor, Sequence[Tuple[int, int]],
                                   int]], split: Split
             ) -> List[torch.Tensor]:
    """Each (t, spans, seq_dim) of ``parts``: t (B, n, ...) packed words
    of all n heads (dim 1) at this rank's block of the sequence (dim
    ``seq_dim``) -> (B, hi - lo, ...), this rank's heads ``spans[index]``
    = [lo, hi) at every position, the ranks' blocks put together along
    ``seq_dim`` in rank order, contiguous (as the kernels take them).
    One all-to-all over "model" carries every part: rank r is sent each
    part's heads ``spans[r]`` (spans may overlap, a KV head read by query
    heads on two ranks going to both, or be empty), padded to the widest
    span.  On one rank (whose span is every head) each ``t`` itself."""
    if split.width == 1:
        return [t for t, _, _ in parts]
    m, r = split.width, split.index
    flat, shapes = [[] for _ in range(m)], []
    for t, spans, _ in parts:
        most = max(hi - lo for lo, hi in spans)
        shape = (t.shape[0], most) + tuple(t.shape[2:])
        for j, (lo, hi) in enumerate(spans):
            p = t[:, lo:hi]
            if hi - lo < most:
                p = torch.cat([p, p.new_zeros((t.shape[0], most - hi + lo)
                                              + tuple(t.shape[2:]))], 1)
            flat[j].append(p.reshape(-1))
        shapes.append(shape)
    got = split.mesh.all_to_all(torch.stack([torch.cat(f) for f in flat]),
                                "model")
    out, at = [], 0
    for (t, spans, seq_dim), shape in zip(parts, shapes):
        size = math.prod(shape)
        lo, hi = spans[r]
        blk = got[:, at:at + size].reshape((m,) + shape)[:, :, :hi - lo]
        at += size
        whole = list(blk.shape[1:])
        whole[seq_dim] *= m
        out.append(blk.movedim(0, seq_dim).reshape(whole).contiguous())
    return out


def heads_to_rows(words: torch.Tensor, split: Split,
                  spans: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """``words`` (B, S, w): packed words of this rank's heads' span
    ``spans[index]`` (in words; every rank's given, in order) at every
    position -> (B, S_held, sum of the spans): every rank's words at this
    rank's block of the sequence, in rank order (one all-to-all over
    "model").  ``words`` itself on one rank."""
    if split.width == 1:
        return words
    return _rows_of(words, split, spans)


def gather_bool(t: torch.Tensor, mesh, axes: Sequence[str]) -> torch.Tensor:
    """``t`` (..., w) bool: this rank's block of the last dim, split over
    ``axes`` -> the packed bits (..., ceil(w * n / 32)) of the whole dim:
    the words all-gathered where a block holds whole words, else the
    values, one byte each, then packed."""
    from repro_torch.core import packing
    axes = tuple(a for a in axes if mesh.shape[a] > 1)
    if not axes:
        return packing.pack_bits(t)
    if t.shape[-1] % packing.WORD == 0:
        return mesh.all_gather(packing.pack_bits(t).contiguous(), axes,
                               t.dim() - 1)
    every = mesh.all_gather(t.to(torch.uint8).contiguous(), axes,
                            t.dim() - 1)
    return packing.pack_bits(every.bool())


# ---------------------------------------------------------------------------
# The MoE on a mesh: each rank routes its own positions.  A claim's slot on
# its expert is its place among the global batch's claims on that expert in
# token order (data index, batch row, block of the sequence, position, then
# the k choices), which per-segment counts give (``claim_offsets``: a
# segment is one batch row's block of the sequence).  Expert-parallel
# stacks send their claims to the experts' ranks and back
# (``to_experts``, ``from_experts``: all-to-alls along "model").
# ---------------------------------------------------------------------------


def claim_shares(split: Split = WHOLE) -> Tuple[Any, Tuple[str, ...], int]:
    """(mesh, axes, shares) of a MoE's batch: the axes whose ranks hold
    other shares of the global batch's positions (the data axes where the
    context splits the batch, then "model" where ``split`` splits the
    sequence), the mesh that runs their collectives, and how many shares
    the global batch holds; (None, (), 1) on one device, or where every
    rank holds the whole batch."""
    mesh = _split_mesh()
    axes = batch_axes() if mesh is not None else ()
    shares = mesh.data_size if mesh is not None else 1
    if split.seq and split.width > 1:
        mesh, axes, shares = split.mesh, axes + ("model",), \
            shares * split.width
    return mesh, axes, shares


def claim_offsets(counts: torch.Tensor, split: Split = WHOLE,
                  idx: Optional[torch.Tensor] = None
                  ) -> Optional[torch.Tensor]:
    """``counts`` (b, E) int32: the claims on each expert of this rank's b
    segments, in row order (``idx``: the claims' experts, b equal
    segments of rows) -> (b, E) int32: the global slot of each segment's
    first claim on each expert less the claims on it of this rank's
    earlier segments (a claim's global slot is its place among this
    rank's claims on its expert plus its segment's offset).  Every share's
    counts are all-gathered over the axes of ``claim_shares`` (no
    gradient), or its claims' experts where those are fewer numbers (a
    decode step's one position a row; every rank decides alike, from the
    shapes), and their exclusive cumsum taken in global token order.
    None where this rank holds the whole batch (every offset 0)."""
    mesh, axes, shares = claim_shares(split)
    if not axes:
        return None
    b, e = counts.shape
    m = split.width if "model" in axes else 1
    if idx is not None and idx.numel() < counts.numel():
        ids = mesh.all_gather(idx.reshape(1, -1).to(torch.int32), axes, 0)
        every = torch.nn.functional.one_hot(
            ids.reshape(shares * b, -1).long(), e).sum(1, dtype=torch.int32)
    else:
        every = mesh.all_gather(counts.contiguous(), axes, 0)
    # (data, model, row) as gathered -> (data, row, model): token order
    every = every.reshape(shares // m, m, b, e).transpose(1, 2).reshape(
        -1, e)
    first = torch.cumsum(every, 0, dtype=torch.int32) - every
    i = mesh.data_index if _split_mesh() is not None else 0
    mine = first.reshape(shares // m, b, m, e)[i, :, split.index if m > 1
                                                 else 0]
    return mine - (torch.cumsum(counts, 0, dtype=torch.int32) - counts)


class _ToExperts(torch.autograd.Function):
    """+-1 rows (n, d) -> the claims each rank of "model" is sent (m, c,
    d) and their int32 tags (m, c): rank j gets the rows ``src`` (m * c,)
    picks for it (n: a zero row, padding), as packed sign bits, one
    all-to-all with the tags as one more word.  Backward: the float32
    gradient of what each rank received sent back (an all-to-all) and
    added onto the rows it came from."""

    @staticmethod
    def forward(ctx, s, src, tags, split):
        ctx.split, ctx.n, ctx.dtype = split, s.shape[0], s.dtype
        ctx.save_for_backward(src)
        m, d = split.width, s.shape[1]
        words = to_words(s, True)
        words = torch.cat([words, words.new_zeros((1, words.shape[1]))])
        sent = torch.cat([words.index_select(0, src).reshape(m, -1,
                                                             words.shape[1]),
                          tags[..., None]], -1)
        got = split.mesh.all_to_all(sent.contiguous(), "model")
        got_tags = got[..., -1].contiguous()
        ctx.mark_non_differentiable(got_tags)
        return from_words(got[..., :-1], d, True, s.dtype), got_tags

    @staticmethod
    def backward(ctx, g, _):
        src, = ctx.saved_tensors
        back = ctx.split.mesh.all_to_all(g.to(torch.float32).contiguous(),
                                         "model")
        out = back.new_zeros((ctx.n + 1, back.shape[-1])).index_add_(
            0, src, back.reshape(-1, back.shape[-1]))
        return out[:ctx.n].to(ctx.dtype), None, None, None


def to_experts(s: torch.Tensor, src: torch.Tensor, tags: torch.Tensor,
               split: Split) -> Tuple[torch.Tensor, torch.Tensor]:
    """``s`` (n, d): +-1 values of this rank's rows; ``src`` (m * c,): the
    row each of the m * c slots carries to rank slot // c (n: none);
    ``tags`` (m, c) int32, one a slot -> (the +-1 values every rank of
    "model" sent this one (m, c, d), row j from rank j; their tags (m,
    c)).  Differentiable in ``s``."""
    return _ToExperts.apply(s, src, tags, split)


class _FromExperts(torch.autograd.Function):
    """Expert outputs (r, d) -> the claims' rows (q,) of what each rank of
    "model" sent back, float32: ``rows`` (m * c,) picks each slot's output
    row for the rank that sent the slot (r: a zero row), one all-to-all;
    ``claims`` (q,) then picks each claim's slot (m * c: a zero row).
    Backward: the claims' float32 gradient placed at their slots, sent
    back, and added onto the output rows."""

    @staticmethod
    def forward(ctx, out, rows, claims, split):
        ctx.split, ctx.r, ctx.dtype = split, out.shape[0], out.dtype
        ctx.save_for_backward(rows, claims)
        d = out.shape[1]
        y = torch.cat([out.to(torch.float32), out.new_zeros((1, d),
                                                            dtype=torch.float32)])
        got = split.mesh.all_to_all(
            y.index_select(0, rows).reshape(split.width, -1, d).contiguous(),
            "model").reshape(-1, d)
        got = torch.cat([got, got.new_zeros((1, d))])
        return got.index_select(0, claims)

    @staticmethod
    def backward(ctx, g):
        rows, claims = ctx.saved_tensors
        m, d = ctx.split.width, g.shape[1]
        slots = g.new_zeros((rows.shape[0] + 1, d)).index_add_(
            0, claims, g.to(torch.float32))[:-1]
        back = ctx.split.mesh.all_to_all(slots.reshape(m, -1, d).contiguous(),
                                         "model").reshape(-1, d)
        out = back.new_zeros((ctx.r + 1, d)).index_add_(0, rows, back)
        return out[:ctx.r].to(ctx.dtype), None, None, None


def from_experts(out: torch.Tensor, rows: torch.Tensor, claims: torch.Tensor,
                 split: Split) -> torch.Tensor:
    """``out`` (r, d): this rank's expert outputs; ``rows`` (m * c,): for
    each slot of what rank slot // c sent (``to_experts``), its output row
    (r: none); ``claims`` (q,): each of this rank's claims' slot in what
    came back (m * c: none) -> (q, d) float32, each claim's expert output
    (zeros for none).  Differentiable in ``out``."""
    return _FromExperts.apply(out, rows, claims, split)
