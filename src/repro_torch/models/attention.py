"""SPS binary attention (port of ``repro.models.attention``): the QAT
face and the deploy faces.

  qat             the training forward on latent weights: shared input
                  binarization, Q/K/V projections (``BinaryDense.apply``),
                  RoPE, per-head sign STEs, float32 +-1 scores, SPS through
                  ``core.sps.sps_ste`` (or, with ``attn_mode=
                  "bit_softmax"``, the BiT teacher: softmax and the
                  unsigned round STE), the +-1 context, its binarization
                  and the output projection; a dense masked (S, Skv) score
                  matrix (the JAX package's query chunks and its static
                  window slice give the same values).
  deploy_prefill  packed-bit forward over a whole prompt: shared input
                  binarization (pack kernel) -> Q/K/V projections (RBMM
                  kernels) -> RoPE -> per-head binarization (pack kernel)
                  -> fused causal SPS attention (sps_attention kernel) ->
                  context binarization -> output projection; also builds
                  the contiguous binary ring cache.
  deploy_decode   one token per sequence.  On a contiguous ring (K packed
                  along d_h, V^T packed along the ring, probabilities
                  packed in flight) score and context run on the rbmm_int
                  kernel (xnor, then and_dc); on a ``PagedKVCache`` the new
                  bits are written through the block table and the
                  paged_gather_decode kernel attends over the pages.
  deploy_prefill_chunk
                  a chunk of queries continuing sequences whose prefix
                  already lives in a ring or a page arena: prefix scores on
                  the rbmm_int kernel, probabilities packed by the pack
                  kernel, context as the and_dc rbmm_int; the intra-chunk
                  causal block is an integer-exact float32 matmul; then the
                  chunk's bits are written.
  deploy_verify_chunk / commit_chunk
                  speculative decode: the chunk attend without the write,
                  then the write of each sequence's accepted prefix only.
  build_memory_cache / attend_memory
                  cross-attention (``cross``: no RoPE): an encoder's output
                  projected once into a static binary memory (K bits, V^T
                  packed along the memory by the pack kernel), then any
                  number of queries against it: xnor score and and_dc
                  context on the rbmm_int kernel, the probabilities packed
                  in between, no causal mask.

Attention reads caches grouped by KV head (the query heads of one group
are the rows of one RBMM against their KV head's ring) — the same integers
as repeating K/V to every head, without the copy.  Caches, their lengths
included, are updated IN PLACE (the JAX package returns new arrays), so a
cache keeps its addresses from step to step.  Supports GQA, RoPE, the
three SPS threshold granularities (``layer``, ``head``, and ``row``: a
(H, 512) table read at each query's absolute position, clamped to 511)
and causal sliding windows: a layer's ``window`` masks prefill and chunk
keys at positions <= p - window, and its decode ring holds exactly the
window (gemma's 5:1 local:global stacks pass each layer's own).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch

from repro_torch.core import binarize, packing, rbmm, sps
from repro_torch.kernels.pack import ops as pack_ops
from repro_torch.kernels.paged_attn import ops as paged_ops
from repro_torch.kernels.paged_attn import ref as paged_ref
from repro_torch.kernels.sps_attn import ops as sps_ops
from repro_torch.models import sharding
from repro_torch.models.linear import BinaryDense, act_bits_packed
from repro_torch.models.sharding import P

Params = Dict[str, Any]

SCORE_IMPLS = ("auto", "popcount", "mxu", "dense")
GRANULARITIES = ("layer", "head", "row")
ATTN_MODES = ("sps", "bit_softmax")
ROW_TABLE = 512  # row-granularity lambda table (the paper's l = 512)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """x: (..., S, H, dh), positions: (..., S) integer."""
    dh = x.shape[-1]
    half = dh // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions[..., :, None, None].to(torch.float32) * freqs
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


class _Share(NamedTuple):
    """This rank's share of a decode step's attention over a ring or a
    memory (``SPSAttention._share``; one device's is all of it): the
    "model" axis (``split``); its query heads [h0, h1) and every rank's,
    in rank order (``spans``); the KV heads [kv0, kv1) its cache block
    holds (all of them where the cache is whole along "model", whose
    ranks then write every head); the ring's ``ring`` slots, of which its
    K block holds [s0, s1) (over the data axes ``k_axes``: a batch of
    one's ring) and its V^T block the words [w0, w1) (over ``w_axes``)
    and the d_h rows [d0, d1) (over ``d_axes``); the mesh."""
    split: Any
    heads: Tuple[int, int]
    spans: List[Tuple[int, int]]
    kv: Tuple[int, int]
    ring: int
    slots: Tuple[int, int]
    words: Tuple[int, int]
    rows: Tuple[int, int]
    k_axes: Tuple[str, ...] = ()
    w_axes: Tuple[str, ...] = ()
    d_axes: Tuple[str, ...] = ()
    mesh: Any = None

    @property
    def whole(self) -> bool:
        return self.mesh is None


class KVCache(NamedTuple):
    """Binary KV ring.  k_bits: (B, Hkv, W, ceil(dh/32)) packed along d_h;
    vt_bits: (B, Hkv, dh, ceil(W/32)) packed along the ring; length: (B,)
    int32 tokens written per sequence (the ring wraps at W)."""
    k_bits: torch.Tensor
    vt_bits: torch.Tensor
    length: torch.Tensor


def _last_writer(key: torch.Tensor, writes: torch.Tensor, rows: torch.Tensor,
                 n_keys: int) -> torch.Tensor:
    """(B, N) bool: True where row b is the highest row that writes
    ``key[b, n]`` (``writes`` marks the writes; ``rows`` (B, 1) the row
    indices).  The max is order-free, so the result is the same on every
    run and device."""
    who = torch.where(writes, rows, -1).expand_as(key)
    last = torch.full((n_keys,), -1, dtype=who.dtype, device=key.device)
    last.scatter_reduce_(0, key.reshape(-1), who.reshape(-1), reduce="amax")
    return last[key] == who


class PagedKVCache(NamedTuple):
    """Paged binary KV cache: a page arena plus per-sequence block tables.

    Token position t occupies logical ring slot s = t % ring_len, which
    resolves to page ``block_table[b, s // page_size]``, offset
    ``s % page_size``.  Physical page 0 is the trash page: unmapped table
    entries are 0, so decode writes of free pool slots land there.  Every
    write routed there writes zeros, so the trash page stays all zero and
    a free row that reads it reads a fixed state (colliding writes of
    other values would leave it in an order no run fixes; a MoE routes
    free rows, and their claims take capacity from the live rows').

      k_pages:     (P+1, Hkv, page_size, ceil(dh/32)) int32 words
      vt_pages:    (P+1, Hkv, dh, page_size/32) int32 words
      block_table: (B, num_blocks) int32 physical page ids (0 = unmapped)
      length:      (B,) int32 tokens written per sequence
      ring_len:    logical ring length, a Python int (the JAX package holds
                   a 0-d array; it is fixed when the cache is built, and a
                   host int spares a device read on every launch)
    """
    k_pages: torch.Tensor
    vt_pages: torch.Tensor
    block_table: torch.Tensor
    length: torch.Tensor
    ring_len: int


def _check_page_size(page_size: int) -> None:
    """A positive multiple of the 32-bit packing word, so V^T packing never
    straddles pages."""
    if page_size <= 0 or page_size % packing.WORD:
        raise ValueError(
            f"page_size must be a positive multiple of the packing "
            f"word ({packing.WORD}), got {page_size}")


@dataclasses.dataclass(frozen=True)
class PageSpec:
    """Sizing of paged caches (validated on construction).

    page_size:  tokens per page, a positive multiple of 32.
    max_blocks: block-table width; capacity is ``max_blocks * page_size``.
    num_pages:  usable arena pages of the full-capacity ring group; 0 means
                fully provisioned (num_slots * max_blocks).
    """
    page_size: int = 32
    max_blocks: int = 1
    num_pages: int = 0

    def __post_init__(self):
        self.validate()

    @property
    def capacity(self) -> int:
        return self.max_blocks * self.page_size

    def ring_for(self, window: int) -> int:
        """Logical ring length of a layer: its window, or the capacity."""
        return min(window or self.capacity, self.capacity)

    def blocks_for_ring(self, ring_len: int) -> int:
        return -(-ring_len // self.page_size)

    def arena_pages(self, ring_len: int, num_slots: int) -> int:
        """Usable pages of a ring group's arena: ``num_pages`` for the
        full-capacity group, fully provisioned otherwise.  The host-side
        ``PageArena`` and ``init_paged_cache`` both size from here."""
        if self.num_pages and ring_len == self.capacity:
            return self.num_pages
        return num_slots * self.blocks_for_ring(ring_len)

    def validate(self) -> None:
        _check_page_size(self.page_size)
        if self.max_blocks < 1:
            raise ValueError(f"max_blocks must be >= 1, got "
                             f"{self.max_blocks}")
        if self.num_pages and self.num_pages < self.max_blocks:
            raise ValueError(
                f"num_pages ({self.num_pages}) < max_blocks "
                f"({self.max_blocks}): one full-capacity sequence must fit "
                f"the arena or admission deadlocks")


@dataclasses.dataclass(frozen=True)
class SPSAttention:
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    causal: bool = True
    use_rope: bool = True
    rope_theta: float = 10_000.0
    qkv_bias: bool = False
    sps_granularity: str = "head"   # layer | head | row
    dtype: torch.dtype = torch.float32
    impl: str = "auto"              # projection route (core.rbmm)
    score_impl: str = "auto"        # decode score route; auto = popcount
    cross: bool = False             # cross-attention (K/V from a memory)
    attn_mode: str = "sps"          # QAT face: sps | bit_softmax (BiT teacher)
    wo_partition: str = "row"       # the output projection's sharding

    def __post_init__(self):
        if self.sps_granularity not in GRANULARITIES:
            raise NotImplementedError(
                f"sps_granularity={self.sps_granularity!r} is not ported "
                f"yet; the port supports {GRANULARITIES}")
        if self.cross and self.use_rope:
            raise ValueError("cross-attention takes no RoPE")
        if self.attn_mode not in ATTN_MODES:
            raise ValueError(f"attn_mode must be one of {ATTN_MODES}, got "
                             f"{self.attn_mode!r}")

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def groups(self) -> int:
        return self.num_heads // self.num_kv_heads

    def _dense(self, in_dim, out_dim, part: str) -> BinaryDense:
        return BinaryDense(in_dim, out_dim, use_bias=self.qkv_bias and
                           part == "col", external_act=True,
                           dtype=self.dtype, partition=part)

    def _denses(self) -> Dict[str, BinaryDense]:
        return {"wq": self._dense(self.d_model, self.q_dim, "col"),
                "wk": self._dense(self.d_model, self.kv_dim, "col"),
                "wv": self._dense(self.d_model, self.kv_dim, "col"),
                "wo": self._dense(self.q_dim, self.d_model,
                                  self.wo_partition)}

    # -- params ---------------------------------------------------------------

    def init(self, gen: torch.Generator, device) -> Params:
        h, hkv = self.num_heads, self.num_kv_heads
        ones = lambda *s: torch.ones(s, device=device)
        zeros = lambda *s: torch.zeros(s, device=device)
        p: Params = {name: d.init(gen, device)
                     for name, d in self._denses().items()}
        p.update(act_alpha=ones(), act_beta=zeros(),
                 q_alpha=ones(h), q_beta=zeros(h),
                 k_alpha=ones(hkv), k_beta=zeros(hkv),
                 v_alpha=ones(hkv), v_beta=zeros(hkv),
                 ctx_alpha=ones(), ctx_beta=zeros(),
                 sps_lambda={"layer": zeros(), "head": zeros(h),
                             "row": zeros(h, ROW_TABLE)}[
                                 self.sps_granularity],
                 bit_alpha=0.5 * ones(h))
        return p

    def specs(self) -> Params:
        """The QAT params' specs (the JAX package's): the per-head scale
        and threshold vectors are tiny and replicated (head counts need
        not divide the model axis)."""
        lam_spec = {"layer": P(), "head": P(None),
                    "row": P(None, None)}[self.sps_granularity]
        p: Params = {name: d.specs() for name, d in self._denses().items()}
        p.update(act_alpha=P(), act_beta=P(), q_alpha=P(None),
                 q_beta=P(None), k_alpha=P(None), k_beta=P(None),
                 v_alpha=P(None), v_beta=P(None), ctx_alpha=P(),
                 ctx_beta=P(), sps_lambda=lam_spec, bit_alpha=P(None))
        return p

    def deploy_specs(self) -> Params:
        """The deploy params' specs (the JAX package's)."""
        p: Params = {name: d.deploy_specs()
                     for name, d in self._denses().items()}
        p.update(act_alpha=P(), act_beta=P(), ctx_alpha=P(), ctx_beta=P(),
                 q_alpha=P(None), q_beta=P(None), k_alpha=P(None),
                 k_beta=P(None), v_alpha=P(None), v_beta=P(None),
                 sps_lambda={"layer": P(), "head": P(None),
                             "row": P(None, None)}[self.sps_granularity])
        return p

    def init_deploy(self, gen: torch.Generator, device) -> Params:
        """``convert(init(gen, device))``: one layer's masters at most."""
        return self.convert(self.init(gen, device))

    def convert(self, params: Params) -> Params:
        d: Params = {name: dense.convert(params[name])
                     for name, dense in self._denses().items()}
        for k in ("act_alpha", "act_beta", "q_alpha", "q_beta", "k_alpha",
                  "k_beta", "v_alpha", "v_beta", "ctx_alpha", "ctx_beta",
                  "sps_lambda"):
            d[k] = params[k]
        return d

    # -- QAT face -------------------------------------------------------------

    def _lambda_for_rows(self, lam: torch.Tensor,
                         rows: torch.Tensor) -> torch.Tensor:
        """The SPS threshold of query rows ``rows``, broadcastable to (H,
        rows, cols): the layer's scalar, the heads' (H, 1, 1), or the row
        table read at each row (clamped to ROW_TABLE - 1), (H, rows, 1)."""
        if self.sps_granularity == "layer":
            return lam[None, None, None]
        if self.sps_granularity == "head":
            return lam[:, None, None]
        return lam[:, rows.clamp(0, ROW_TABLE - 1)][:, :, None]

    def _mask(self, rows: torch.Tensor, cols: torch.Tensor, kv_len,
              window) -> torch.Tensor:
        """(rows, cols) validity: key below ``kv_len``, and for causal
        self-attention at or before the row and inside ``window``."""
        r, c = rows[:, None], cols[None, :]
        m = c < kv_len
        if self.causal and not self.cross:
            m = m & (c <= r)
            if window is not None:
                m = m & (c > r - window)
        return m

    def _repeat_kv(self, x: torch.Tensor,
                   heads: Optional[Tuple[int, int]] = None) -> torch.Tensor:
        """(B, Hkv, ...) -> (B, H, ...): each KV head for its G query
        heads.  ``heads`` (h0, h1): ``x`` holds the KV heads that query
        heads h0..h1-1 read, from KV head h0 // G on, and the result those
        query heads."""
        g = self.groups
        if heads is not None and (heads[0] % g or heads[1] % g):
            h0, h1 = heads
            idx = torch.arange(h0, h1, device=x.device) // g - h0 // g
            return x.index_select(1, idx)
        if g == 1:
            return x
        b, hkv = x.shape[:2]
        return x[:, :, None].expand(b, hkv, g, *x.shape[2:]
                                    ).reshape(b, hkv * g, *x.shape[2:])

    def head_ranges(self, split: sharding.Split = sharding.WHOLE
                    ) -> Tuple[List[Tuple[int, int]],
                               List[Tuple[int, int]]]:
        """Every "model" rank's query heads [h0, h1) (``split_range``) and
        the KV heads [k0, k1) they read, in rank order."""
        g = self.groups
        qs = sharding.ranges(self.num_heads, split)
        kvs = [(lo // g, -(-hi // g)) if hi > lo else (lo // g, lo // g)
               for lo, hi in qs]
        return qs, kvs

    def _head_params(self, params: Params, split: sharding.Split,
                     qs, kvs) -> Params:
        """This rank's params: the signs of ``wq``'s columns of its query
        heads and of ``wk``/``wv``'s columns of their KV heads, with their
        scales and biases; the per-head vectors of both
        (``sharding.columns``); ``wo``'s signs and the rest whole."""
        dh = self.head_dim

        def take(leaf, dim, spans, signs=False):
            return sharding.columns(leaf, dim, spans, split, signs)

        def dense_cols(p, heads):
            spans = [(lo * dh, hi * dh) for lo, hi in heads]
            out = {"w_sign": take(p["w_latent"], 1, spans, True),
                   "alpha_w": take(p["alpha_w"], 0, spans)}
            if "bias" in p:
                out["bias"] = take(p["bias"], 0, spans)
            return out

        wo = params["wo"]
        out: Params = {
            "wq": dense_cols(params["wq"], qs),
            "wk": dense_cols(params["wk"], kvs),
            "wv": dense_cols(params["wv"], kvs),
            "wo": {"w_sign": sharding.whole(wo["w_latent"], signs=True),
                   **{k: sharding.whole(v) for k, v in wo.items()
                      if k != "w_latent"}}}
        for k in ("q_alpha", "q_beta", "bit_alpha"):
            out[k] = take(params[k], 0, qs)
        for k in ("k_alpha", "k_beta", "v_alpha", "v_beta"):
            out[k] = take(params[k], 0, kvs)
        lam = params["sps_lambda"]
        out["sps_lambda"] = (sharding.whole(lam)
                             if self.sps_granularity == "layer"
                             else take(lam, 0, qs))
        for k in ("act_alpha", "act_beta", "ctx_alpha", "ctx_beta"):
            out[k] = sharding.whole(params[k])
        return out

    def qat(self, params: Params, x: torch.Tensor, *, memory=None,
            positions: Optional[torch.Tensor] = None, window=None,
            kv_len=None, collect_scores: bool = False,
            split: sharding.Split = sharding.WHOLE
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """QAT forward: x (B, S, d) -> (out (B, S, d) in ``dtype``, aux).
        Cross-attention takes its keys and values from ``memory`` (B,
        S_kv, d), binarized with this block's own ``act_alpha`` and
        ``act_beta``; its mask is the key length alone, and RoPE is off.
        ``window`` masks keys at or before row - window (causal only);
        ``kv_len`` masks keys from there on; ``collect_scores`` returns the
        float32 scores and probabilities (B, H, S, S_kv) in aux.

        ``split`` (``sharding.Split``, the compute split along "model"):
        ``x`` and the output are this rank's block of the sequence (whole
        where the split leaves it whole; ``memory`` is whole); the signs
        of ``x`` are gathered whole along the sequence, the rank computes
        its query heads (``head_ranges``) and the KV heads they read
        (``sharding.col_product``: the projections' input gradient goes to
        the positions' ranks by an all-to-all); the context's signs go to
        the ranks whose positions they are
        (``sharding.to_rows``), and ``wo`` multiplies this rank's
        positions by its whole weight.  ``params`` may hold
        ``sharding.Gathered`` leaves."""
        if self.cross and memory is None:
            raise ValueError("cross-attention's QAT face needs memory")
        dh = self.head_dim
        qs, kvs = self.head_ranges(split)
        h0, h1 = qs[split.index]
        latent = {n: params[n]["w_latent"] for n in ("wq", "wk", "wv")}
        params = self._head_params(params, split, qs, kvs)
        alpha = params["act_alpha"].clamp_min(1e-6)
        beta = params["act_beta"]

        def signs(t):
            return binarize.sign_ste(
                (binarize.promote(t, alpha, beta) - beta) / alpha)

        s_own = signs(x)
        s_x = sharding.seq_gather(s_own.detach(), split, signs=True)
        b, s, _ = s_x.shape
        dev = x.device
        skv = memory.shape[1] if self.cross else s
        if positions is None:
            positions = torch.arange(s, device=dev)[None, :]
        dense = self._denses()

        def proj(n, heads):
            y = sharding.col_product(
                s_own, s_x, params[n]["w_sign"], latent[n], split,
                [(lo * dh, hi * dh) for lo, hi in heads], dense[n].dtype)
            return dense[n].finish(params[n], y, alpha)

        q = proj("wq", qs)
        if self.cross:
            s_kv = signs(memory)
            k, v = (dense[n].apply(params[n], act_values=s_kv,
                                   act_scale=alpha) for n in ("wk", "wv"))
        else:
            k, v = proj("wk", kvs), proj("wv", kvs)
        q = q.reshape(b, s, h1 - h0, dh)
        k = k.reshape(b, skv, -1, dh)
        v = v.reshape(b, skv, -1, dh)
        if self.use_rope and not self.cross:
            q = rope(q, positions, self.rope_theta)
            k = rope(k, positions[:, :s], self.rope_theta)

        def headwise_sign(t, alpha_h, beta_h):
            t = t.transpose(1, 2)                       # (B, H*, S, dh)
            z = (t - beta_h[None, :, None, None]) / \
                alpha_h[None, :, None, None].clamp_min(1e-6)
            return binarize.sign_ste(z)

        def per_head(t):
            return self._repeat_kv(t, (h0, h1))

        s_q = headwise_sign(q, params["q_alpha"], params["q_beta"])
        s_k = per_head(headwise_sign(k, params["k_alpha"], params["k_beta"]))
        s_v = per_head(headwise_sign(v, params["v_alpha"], params["v_beta"]))
        scale_qk = (params["q_alpha"][:, None, None] *
                    per_head(params["k_alpha"][None])[0][:, None, None] /
                    math.sqrt(dh))
        rows = torch.arange(s, device=dev)
        m = self._mask(rows, torch.arange(skv, device=dev),
                       skv if kv_len is None else kv_len, window)[None, None]
        z = torch.matmul(s_q, s_k.transpose(-1, -2)) * scale_qk[None]
        if self.attn_mode == "bit_softmax":
            p = torch.softmax(torch.where(m, z, float("-inf")), dim=-1)
            zp = p / params["bit_alpha"][None, :, None, None].clamp_min(
                1e-6)
            probs = binarize.clip(binarize.round_ste(zp), 0.0, 1.0)
        else:
            lam = self._lambda_for_rows(params["sps_lambda"], rows)[None]
            probs = sps.sps_ste(z, lam)
        probs = torch.where(m, probs, 0.0)
        ctx = torch.matmul(probs, s_v)
        aux: Dict[str, torch.Tensor] = {}
        if collect_scores:
            aux["scores"], aux["probs"] = (sharding.gather_heads(
                t, split, 1, qs) for t in (z, probs))
        av = per_head(params["v_alpha"][None])[0]
        ctx = ctx * av[None, :, None, None]
        ca = params["ctx_alpha"].clamp_min(1e-6)
        s_c = binarize.sign_ste((ctx - params["ctx_beta"]) / ca)
        s_c = s_c.transpose(1, 2).reshape(b, s, (h1 - h0) * dh)
        s_c = sharding.to_rows(s_c, split, [(lo * dh, hi * dh)
                                            for lo, hi in qs])
        out = dense["wo"].apply(params["wo"], act_values=s_c,
                                act_scale=params["ctx_alpha"])
        return out, aux

    # -- shared deploy pieces -------------------------------------------------

    def _score_impl(self) -> str:
        if self.score_impl not in SCORE_IMPLS:
            raise ValueError(f"score_impl must be one of {SCORE_IMPLS}, "
                             f"got {self.score_impl!r}")
        return "popcount" if self.score_impl == "auto" else self.score_impl

    def _per_query_head(self, t: torch.Tensor) -> torch.Tensor:
        """(Hkv,) -> (H,): each KV head's value for the G query heads of
        its group."""
        return t[:, None].expand(self.num_kv_heads, self.groups).reshape(
            self.num_heads)

    def _theta_int(self, params: Params) -> torch.Tensor:
        """Integer SPS thresholds per query head, (H,) int32; for the
        ``row`` granularity a table (H, ROW_TABLE)."""
        aq = params["q_alpha"]
        ak = self._per_query_head(params["k_alpha"])
        lam = params["sps_lambda"]
        if self.sps_granularity == "row":
            aq, ak = aq[:, None], ak[:, None]
        else:
            lam = lam.expand(self.num_heads)
        return sps.integer_threshold(lam, self.head_dim, aq, ak).to(
            torch.int32)

    def _theta_at(self, theta: torch.Tensor,
                  positions: torch.Tensor) -> torch.Tensor:
        """Thresholds of queries at absolute ``positions`` (...):
        (..., H), each row table read at min(position, ROW_TABLE - 1),
        or the (H,) thresholds broadcast."""
        if self.sps_granularity != "row":
            return theta.expand(positions.shape + theta.shape)
        col = positions.long().clamp(0, ROW_TABLE - 1)
        return theta[:, col].movedim(0, -1)

    def _share(self, k_bits: torch.Tensor,
               vt_bits: torch.Tensor) -> _Share:
        """This rank's ``_Share`` of the attention over the ring or memory
        ``k_bits`` (B, Hkv, W, dhp) / ``vt_bits`` (B, Hkv, dh, W/32),
        from their placements (``launch.specs.cache_spec``): a cache split
        on its KV heads along "model" gives the rank the query heads of
        its KV heads; one whole along it, its ``split_range`` of the query
        heads (every rank writing every KV head).  A batch of one's ring
        split over the data axes gives it a block of K's slots and of
        V^T's words or d_h rows.  Raises for a split the rule cannot
        compute on."""
        h, hkv, g, dh = (self.num_heads, self.num_kv_heads, self.groups,
                         self.head_dim)
        kpl = getattr(k_bits, "placement", None)
        if kpl is None:
            w = k_bits.shape[2]
            return _Share(sharding.WHOLE, (0, h), [(0, h)], (0, hkv), w,
                          (0, w), (0, vt_bits.shape[3]), (0, dh))
        vpl = sharding.placement_of(vt_bits)
        for pl, dims in ((kpl, (0, 2)), (vpl, (0, 2, 3))):
            for axes, d in pl.splits:
                if not (axes == ("model",) and d == 1 or
                        "model" not in axes and d in dims):
                    raise ValueError(f"a decode step cannot attend over a "
                                     f"cache placed {pl}")
        split = sharding.decode_split(k_bits)
        if kpl.dims.get("model") == 1:
            n = hkv // split.width * g
            spans = [(r * n, (r + 1) * n) for r in range(split.width)]
        else:
            spans = sharding.ranges(h, split)
        heads = spans[split.index]
        kv = kpl.span(1)

        def axes(pl, dim):
            return next((a for a, d in pl.splits if d == dim), ())
        return _Share(split, heads, spans, kv, kpl.shape[2], kpl.span(2),
                      vpl.span(3), vpl.span(2), axes(kpl, 2),
                      axes(vpl, 3), axes(vpl, 2), kpl.mesh)

    def _project_qkv_deploy(self, params: Params, x: torch.Tensor,
                            positions: torch.Tensor,
                            parts: Tuple[str, ...] = ("wq", "wk", "wv"),
                            share: Optional[_Share] = None
                            ) -> Tuple[Optional[torch.Tensor],
                                       Optional[torch.Tensor],
                                       Optional[torch.Tensor]]:
        """x (B,S,d) -> q_bits (B,H,S,dhp), k_bits (B,Hkv,S,dhp) and the fp
        V projection (B,S,Hkv,dh), which prefill packs along S and decode
        thresholds per element.  Only the projections of ``parts`` run
        (the others come back None): cross-attention projects its queries
        and its memory apart.  With a ``share`` (a decode step on a mesh)
        q holds its query heads and k, v the KV heads its cache block
        holds, each product on this rank's block of its weight."""
        b, s, _ = x.shape
        dh = self.head_dim
        dense = self._denses()
        bits_x = act_bits_packed(x, params["act_beta"])
        alpha = params["act_alpha"]
        (h0, h1), (k0, k1) = ((0, self.num_heads), (0, self.num_kv_heads)) \
            if share is None else (share.heads, share.kv)
        cols = {"wq": None, "wk": None, "wv": None}
        if share is not None:
            cols["wq"] = [(lo * dh, hi * dh) for lo, hi in share.spans]
            n = (k1 - k0) * dh  # every rank's KV heads: its block, or all
            cols["wk"] = cols["wv"] = [
                (r * n, (r + 1) * n) if n < self.kv_dim else (0, n)
                for r in range(share.split.width)]
        proj = {name: dense[name].apply_deploy(
                    params[name], bits=bits_x, act_alpha=alpha,
                    impl=self.impl, cols=cols[name]) for name in parts}
        heads = {"wq": h1 - h0, "wk": k1 - k0, "wv": k1 - k0}
        q, k, v = (proj[n].reshape(b, s, heads[n], dh) if n in proj
                   else None for n in ("wq", "wk", "wv"))
        if self.use_rope:
            q = rope(q, positions, self.rope_theta)
            k = rope(k, positions, self.rope_theta)
        # per-head binarize + pack on the (B,S,H,dh) layout, then move the
        # (32x smaller) words to the head-major layout
        q_bits, k_bits = (
            None if t is None else self._pack_heads(
                t, params[beta] if share is None else params[beta][lo:hi])
            for t, beta, lo, hi in ((q, "q_beta", h0, h1),
                                    (k, "k_beta", k0, k1)))
        return q_bits, k_bits, v

    @staticmethod
    def _pack_heads(t: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
        """(B, S, n, dh) fp -> (B, n, S, dhp) words of t >= beta (n,) (a
        rank with no head packs nothing)."""
        if t.shape[2] == 0:
            return t.new_zeros((t.shape[0], 0, t.shape[1],
                                packing.packed_len(t.shape[3])),
                               dtype=torch.int32)
        return pack_ops.pack_threshold(t, beta[:, None]).transpose(
            1, 2).contiguous()

    def _output_deploy(self, params: Params, ctx_int: torch.Tensor,
                       share: Optional[_Share] = None) -> torch.Tensor:
        """ctx_int (B, H, S, dh) int32 -> wo -> (B, S, d).  With a
        ``share``, ctx_int holds its query heads: their context is scaled
        and binarized here, and its bits go to ``wo`` as they are where
        ``wo`` is split on its words and every rank's block is its heads'
        (nothing crosses), else put together whole over "model"
        (``sharding.join_bits``)."""
        b, h, s, dh = ctx_int.shape
        av = self._per_query_head(params["v_alpha"])
        if share is not None:
            av = av[share.heads[0]:share.heads[1]]
        ctx = ctx_int.to(torch.float32) * av[None, :, None, None]
        ctx = ctx.transpose(1, 2).reshape(b, s, h * dh)
        wo, held = self._denses()["wo"], None
        if share is None or h:
            bits = pack_ops.pack_threshold(ctx, params["ctx_beta"])
        else:
            bits = ctx.new_zeros((b, s, 0), dtype=torch.int32)
        if share is not None:
            blk = wo.words_held(params["wo"])
            spans = [(lo * dh, hi * dh) for lo, hi in share.spans]
            n = None if blk is None else (blk[1] - blk[0]) * packing.WORD
            if n is not None and spans == [(r * n, (r + 1) * n)
                                           for r in range(len(spans))]:
                held = blk
            else:
                bits = sharding.join_bits(bits, share.split, spans,
                                          self.q_dim)
        return wo.apply_deploy(params["wo"], bits=bits,
                               act_alpha=params["ctx_alpha"],
                               impl=self.impl, held=held)

    # -- prefill --------------------------------------------------------------

    def deploy_prefill(self, params: Params, x: torch.Tensor, *,
                       positions: Optional[torch.Tensor] = None,
                       window: int = 0, cache_size: int = 0,
                       seq_lens: Optional[torch.Tensor] = None,
                       split: Optional[sharding.Split] = None
                       ) -> Tuple[torch.Tensor, Optional[KVCache]]:
        """Full-sequence deploy forward.  Returns (out, cache); the ring
        cache (W = cache_size) is built when cache_size > 0.

        ``window`` > 0 masks the keys at positions <= p - window out of
        query p (the kernel's ``window`` operand, which also skips the
        key tiles no query of a block sees).  The query rows are the
        positions 0..S-1 (the ``row`` granularity reads its table there).

        ``seq_lens`` (B,) takes a ragged, right-padded batch: keys at
        columns >= seq_lens[b] are masked out of every row of sequence b
        (the ``lens`` operand of the sps_attention kernel), and the cache
        holds each sequence's own ring contents and length.  Pad rows
        still compute, but no real row reads them.

        ``split`` (``sharding.prefill_split``, a mesh prefill): ``x`` and
        the output are this rank's block of the sequence, at
        ``positions`` (1, S_held); the rank attends its query heads over
        the whole sequence (``_prefill_heads``, ``_attend_span``,
        ``_prefill_output``).  No cache, no ``seq_lens``."""
        if split is not None:
            if cache_size or seq_lens is not None:
                raise ValueError("a split prefill builds no cache and takes "
                                 "no seq_lens")
            return self._prefill_split(params, x, positions, window,
                                       split), None
        b, s, _ = x.shape
        if positions is None:
            positions = torch.arange(s, device=x.device)[None, :]
        lens = None if seq_lens is None else torch.as_tensor(
            seq_lens, device=x.device).to(torch.int32).expand(b).contiguous()
        q_bits, k_bits, v = self._project_qkv_deploy(params, x, positions)
        # V^T packed along the sequence, straight from the fp projection
        vt_bits = pack_ops.pack_threshold(v.permute(0, 2, 3, 1),
                                          params["v_beta"][:, None, None])
        ctx = sps_ops.sps_attention_gqa(q_bits, k_bits, vt_bits,
                                        self._theta_int(params),
                                        d_h=self.head_dim,
                                        causal=self.causal, lens=lens,
                                        window=window if self.causal else 0)
        out = self._output_deploy(params, ctx)
        cache = None
        if cache_size:
            if lens is None:
                lens = torch.full((b,), s, dtype=torch.int32,
                                  device=x.device)
            cache = self._ring_cache(k_bits, vt_bits, lens, cache_size)
        return out, cache

    # -- prefill split along "model" ----------------------------------------

    def _split_heads(self, split: sharding.Split
                     ) -> Tuple[List[Tuple[int, int]], List[Tuple[int, int]]]:
        """``head_ranges`` of a split prefill, which exchanges whole words
        of each head (d_h a multiple of 32)."""
        if self.head_dim % packing.WORD:
            raise ValueError(f"a split prefill exchanges whole words of each "
                             f"head; d_h = {self.head_dim} is not a multiple "
                             f"of {packing.WORD}")
        return self.head_ranges(split)

    def _prefill_heads(self, split: sharding.Split, spans, parts):
        """``parts`` ((words, "q" or "kv", seq_dim), ...) of this rank's
        positions -> those of this rank's query heads (``spans``: every
        rank's query heads and KV heads, ``head_ranges``) over the whole
        sequence: one all-to-all of packed bits (``sharding.to_heads``)."""
        qs, kvs = spans
        return sharding.to_heads([(t, qs if kind == "q" else kvs, sd)
                                  for t, kind, sd in parts], split)

    def _attend_span(self, q_bits: torch.Tensor, k_bits: torch.Tensor,
                     vt_bits: torch.Tensor, theta: torch.Tensor,
                     heads: Tuple[int, int], kv0: int, *, causal: bool,
                     window: int) -> torch.Tensor:
        """``sps_attention_gqa`` of query heads ``heads`` = [h0, h1):
        q_bits (B, h1 - h0, S, dhp), k_bits / vt_bits the KV heads they
        read from KV head ``kv0`` on, theta their rows of ``_theta_int``
        -> (B, h1 - h0, S, d_h) int32.  Whole KV groups go in one call, a
        partial group apart (``_segments``); each head's integers are the
        one-device call's."""
        b, _, s, _ = q_bits.shape
        h0, h1 = heads
        ctxs = []
        for a, c, k0, n in self._segments(h0, h1):
            whole = (a, c) == (h0, h1)

            def kv(t, i=k0 - kv0, n=n):
                return t if (i, n) == (0, t.shape[1]) else \
                    t[:, i:i + n].contiguous()
            ctxs.append(sps_ops.sps_attention_gqa(
                q_bits if whole else q_bits[:, a - h0:c - h0].contiguous(),
                kv(k_bits), kv(vt_bits),
                theta if whole else theta[a - h0:c - h0],
                d_h=self.head_dim, causal=causal, window=window))
        if not ctxs:
            return q_bits.new_zeros((b, 0, s, self.head_dim))
        return ctxs[0] if len(ctxs) == 1 else torch.cat(ctxs, 1)

    def _prefill_output(self, params: Params, ctx_int: torch.Tensor,
                        split: sharding.Split,
                        qs: List[Tuple[int, int]]) -> torch.Tensor:
        """ctx_int (B, h, S, d_h) int32 of this rank's query heads ``qs[
        split.index]`` over the whole sequence -> wo -> (B, S_held, d):
        the context scaled and thresholded into bits (as
        ``_output_deploy``), the words sent to the positions' ranks (one
        all-to-all, ``sharding.heads_to_rows``), ``wo`` on its whole
        weight."""
        b, h, s, dh = ctx_int.shape
        h0, h1 = qs[split.index]
        av = self._per_query_head(params["v_alpha"])[h0:h1]
        ctx = ctx_int.to(torch.float32) * av[None, :, None, None]
        ctx = ctx.transpose(1, 2).reshape(b, s, h * dh)
        if h:
            bits = pack_ops.pack_threshold(ctx, params["ctx_beta"])
        else:
            bits = ctx.new_zeros((b, s, 0), dtype=torch.int32)
        per = dh // packing.WORD
        bits = sharding.heads_to_rows(bits, split, [(lo * per, hi * per)
                                                    for lo, hi in qs])
        return self._denses()["wo"].apply_deploy(
            params["wo"], bits=bits, act_alpha=params["ctx_alpha"],
            impl=self.impl)

    def _prefill_split(self, params: Params, x: torch.Tensor,
                       positions: torch.Tensor, window: int,
                       split: sharding.Split) -> torch.Tensor:
        """``deploy_prefill`` on a split (see there): the projections on
        this rank's positions (whole weights), q and k packed per head and
        V^T along this rank's block of the sequence (whole words), the
        three sent to the ranks of their heads, ``sps_attention_gqa`` on
        this rank's query heads, the context back to the positions'
        ranks, ``wo``."""
        qs, kvs = spans = self._split_heads(split)
        heads, kv = qs[split.index], kvs[split.index]
        q_bits, k_bits, v = self._project_qkv_deploy(params, x, positions)
        vt_bits = pack_ops.pack_threshold(v.permute(0, 2, 3, 1),
                                          params["v_beta"][:, None, None])
        q_bits, k_bits, vt_bits = self._prefill_heads(
            split, spans, [(q_bits, "q", 2), (k_bits, "kv", 2),
                           (vt_bits, "kv", 3)])
        theta = self._theta_int(params)[heads[0]:heads[1]]
        ctx = self._attend_span(q_bits, k_bits, vt_bits, theta, heads,
                                kv[0], causal=self.causal,
                                window=window if self.causal else 0)
        return self._prefill_output(params, ctx, split, qs)

    @staticmethod
    def _ring_cache(k_bits: torch.Tensor, vt_bits: torch.Tensor,
                    lens: torch.Tensor, w: int) -> KVCache:
        """Each sequence's last min(lens[b], W) tokens at ring slots
        t % W; empty slots 0.  The W tokens a row considers are
        consecutive, so its slots are a permutation of 0..W-1."""
        dev = k_bits.device
        b, hkv, s, dhp = k_bits.shape
        t = lens.long()[:, None] - w + torch.arange(w, device=dev)  # (B,W)
        valid = t >= 0
        tc = t.clamp(0, max(s - 1, 0))
        slots = torch.remainder(t, w)
        kg = torch.gather(k_bits, 2, tc[:, None, :, None].expand(
            b, hkv, w, dhp)) * valid[:, None, :, None]
        kc = torch.zeros_like(kg).scatter_(
            2, slots[:, None, :, None].expand(b, hkv, w, dhp), kg)
        v_seq = packing.unpack_bits(vt_bits, s)          # (B,Hkv,dh,S)
        dh = v_seq.shape[2]
        vg = torch.gather(v_seq, 3, tc[:, None, None, :].expand(
            b, hkv, dh, w)) * valid[:, None, None, :]
        v_ring = torch.zeros_like(vg).scatter_(
            3, slots[:, None, None, :].expand(b, hkv, dh, w), vg)
        return KVCache(kc, packing.pack_bits(v_ring),
                       lens.to(torch.int32, copy=True))

    # -- chunked prefill (cache continuation) ---------------------------------

    def _grouped(self, t: torch.Tensor) -> torch.Tensor:
        """(B, H, C, X) -> (B, Hkv, G*C, X): the query rows of a KV group
        become the rows of one RBMM against that KV head."""
        b, _, c, x = t.shape
        return t.reshape(b, self.num_kv_heads, self.groups * c, x)

    def _chunk_attend(self, params: Params, q_bits: torch.Tensor,
                      k_bits: torch.Tensor, v_bits: torch.Tensor,
                      kc_old: torch.Tensor, vc_old: torch.Tensor,
                      start: torch.Tensor, valid: torch.Tensor,
                      ring: int, window: int = 0) -> torch.Tensor:
        """A chunk of queries (B,H,C,dhp) over the cached prefix plus the
        chunk's own keys.  kc_old/vc_old is the packed K / V^T ring view
        holding the first ``start[b]`` tokens (ring slot s holds token
        ``start-1 - ((start-1-s) mod ring)``); k_bits (B,Hkv,C,dhp) and
        v_bits (B,Hkv,C,dh) bool are the chunk's own.  SPS has no softmax
        state, so the two blocks add as integers.  Chunk rows at/after
        ``valid[b]`` are pad: masked out of every real row.  ``window`` >
        0 hides the tokens at positions <= p - window from the query at
        position p, in the prefix and in the chunk."""
        b, h, c_len, _ = q_bits.shape
        hkv, g, dh = self.num_kv_heads, self.groups, self.head_dim
        w = kc_old.shape[2]
        dev = q_bits.device
        positions = start[:, None] + torch.arange(c_len, device=dev)  # (B,C)
        theta = self._theta_int(params)
        if self.sps_granularity == "row":
            # each query's threshold at its own position, (B, Hkv, G, C, 1)
            th = self._theta_at(theta, positions).transpose(1, 2).reshape(
                b, hkv, g, c_len, 1)
        else:
            th = theta.reshape(hkv, g, 1, 1)
        th_rows = th.expand(th.shape[:-3] + (g, c_len, 1)).reshape(
            th.shape[:-3] + (g * c_len, 1))
        qg = self._grouped(q_bits)                           # (B,Hkv,G*C,dhp)
        # cached prefix: which token each ring slot holds
        s_idx = torch.arange(w, device=dev)[None, :]
        st = start[:, None]
        t_old = st - 1 - torch.remainder(st - 1 - s_idx, ring)   # (B, W)
        m_pre = (t_old >= 0) & (s_idx < ring)
        if window:
            # per query: the cached tokens inside its window, (B, 1, G*C, W)
            m_pre = (m_pre[:, None, :] &
                     (t_old[:, None, :] > positions[:, :, None] - window))
            m_words = packing.pack_bits(m_pre)[:, None, None].expand(
                b, 1, g, c_len, -1).reshape(b, 1, g * c_len, -1)
        else:
            m_words = packing.pack_bits(m_pre)[:, None, None, :]
        c_pre = rbmm.rbmm_int(qg, kc_old, dh, scheme="xnor",
                              impl=self._score_impl())      # (B,Hkv,G*C,W)
        probs_p = pack_ops.pack_threshold(c_pre, th_rows) & m_words
        # context = 2*popcount(P & V^T) - nnz(P): the and_dc RBMM with
        # k = W, whose derived dc = W - nnz cancels the -W
        ctx = rbmm.rbmm_int(probs_p, vc_old, w, scheme="and_dc",
                            impl="popcount")                # (B,Hkv,G*C,dh)
        # intra-chunk causal block
        c_in = rbmm.rbmm_int(qg, k_bits, dh, scheme="xnor",
                             impl=self._score_impl())       # (B,Hkv,G*C,C)
        i_idx = torch.arange(c_len, device=dev)
        m_in = ((i_idx[:, None] >= i_idx[None, :])[None] &
                (i_idx[None, None, :] < valid[:, None, None]))  # (B,C,C)
        if window:
            m_in = m_in & (i_idx[None, :] > i_idx[:, None] - window)[None]
        probs_in = ((c_in.reshape(b, hkv, g, c_len, c_len) >= th) &
                    m_in[:, None, None])
        s_v = torch.where(v_bits, 1.0, -1.0)                 # (B,Hkv,C,dh)
        # integer-exact: {0,1} x ±1 sums of at most C terms in float32
        ctx_in = torch.matmul(
            probs_in.reshape(b, hkv, g * c_len, c_len).to(torch.float32),
            s_v)
        ctx = ctx + ctx_in.to(torch.int32)
        return ctx.reshape(b, h, c_len, dh)

    def _cache_ring_view(self, cache) -> Tuple[torch.Tensor, torch.Tensor,
                                                int]:
        """(kc, vc, ring): the contiguous ring tensors themselves, or the
        block-table gather of a ``PagedKVCache`` (a contiguous copy, as
        the kernels take it) laid out so logical ring slot s is column
        s."""
        if not isinstance(cache, PagedKVCache):
            return cache.k_bits, cache.vt_bits, cache.k_bits.shape[2]
        kc, vc = paged_ref.gather_ring_view(cache.k_pages, cache.vt_pages,
                                            cache.block_table)
        return kc.contiguous(), vc.contiguous(), cache.ring_len

    def _write_chunk(self, cache, k_bits: torch.Tensor,
                     v_bits: torch.Tensor, start: torch.Tensor,
                     valid: torch.Tensor, vc_old: torch.Tensor):
        """Commit the chunk's K/V bits into the ring, in place (select,
        last writer wins).  Slot s takes chunk token t_new = the largest
        t < start+valid with t % ring == s, IF that token is the chunk's
        (>= start); other slots keep their contents.  Rows with
        valid == 0 write nothing and keep their length.  ``vc_old`` is
        the V^T ring view read before any write.  Returns the same cache,
        its ``length`` set in place to ``start + valid`` where anything
        was written."""
        b, hkv, c_len, dhp = k_bits.shape
        dh = self.head_dim
        dev = k_bits.device
        paged = isinstance(cache, PagedKVCache)
        if paged:
            page = cache.k_pages.shape[2]
            ring = cache.ring_len
            w = cache.block_table.shape[1] * page
        else:
            w = ring = cache.k_bits.shape[2]
        lv = start + valid
        new_len = torch.where(valid > 0, lv, cache.length.to(lv.dtype)
                              ).to(torch.int32)
        s_all = torch.arange(w, device=dev)
        t_new = lv[:, None] - 1 - torch.remainder(
            lv[:, None] - 1 - s_all[None, :], ring)            # (B, W)
        wr = ((t_new >= start[:, None]) & (t_new >= 0) &
              (s_all[None, :] < ring) & (valid[:, None] > 0))
        j = (t_new - start[:, None]).clamp(0, c_len - 1)
        kg = torch.gather(k_bits, 2, j[:, None, :, None].expand(
            b, hkv, w, dhp))                                   # (B,Hkv,W,dhp)
        vg = torch.gather(v_bits, 2, j[:, None, :, None].expand(
            b, hkv, w, dh)).transpose(2, 3)                    # (B,Hkv,dh,W)
        wr_words = packing.pack_bits(wr)                       # (B, W/32)
        new_words = pack_ops.pack_threshold(
            (vg & wr[:, None, None, :]).to(torch.int32),
            torch.ones((), dtype=torch.int32, device=dev))
        merged = (vc_old & ~wr_words[:, None, None, :]) | new_words
        cache.length.copy_(new_len)
        if not paged:
            cache.k_bits.copy_(torch.where(wr[:, None, :, None], kg,
                                           cache.k_bits))
            cache.vt_bits.copy_(merged)
            return cache
        # scatter written slots / words through the block table; unwritten
        # positions route to the trash page 0 and write zeros there
        # (page_size % 32 keeps whole V^T words inside one page).  A
        # physical slot or word that several rows write (a prefix page
        # shared by rows that prefill it in one chunk) takes the last
        # (highest) row's bits only: their bits agree wherever a
        # position's K/V depends on its prefix alone, but a MoE's drops
        # depend on the whole batch, and colliding writes of different
        # values would land in an order no run fixes
        bt = cache.block_table.long()
        rows = torch.arange(b, device=dev)[:, None]
        phys = torch.where(wr, bt[:, s_all // page], 0)        # (B, W)
        off = (s_all % page).expand(b, w)
        wr = wr & _last_writer(phys * page + off, wr, rows,
                               cache.k_pages.shape[0] * page)
        phys = torch.where(wr, phys, 0)
        cache.k_pages[phys, :, off] = torch.where(
            wr[:, :, None, None], kg.transpose(1, 2), 0)
        j32 = torch.arange(w // packing.WORD, device=dev) * packing.WORD
        wpp = page // packing.WORD
        hit = wr_words != 0
        physw = torch.where(hit, bt[:, j32 // page], 0)
        wj = ((j32 % page) // packing.WORD).expand(b, -1)
        hit = hit & _last_writer(physw * wpp + wj, hit, rows,
                                 cache.vt_pages.shape[0] * wpp)
        physw = torch.where(hit, physw, 0)
        cache.vt_pages[physw, :, :, wj] = torch.where(
            hit[:, :, None, None], merged.permute(0, 3, 1, 2), 0)
        return cache

    def deploy_prefill_chunk(self, params: Params, x: torch.Tensor, cache,
                             *, window: int = 0,
                             start: Optional[torch.Tensor] = None,
                             valid_len: Optional[torch.Tensor] = None):
        """Cache-resuming chunk prefill: x (B, C, d) continues sequences
        whose first ``start[b]`` tokens (default: ``cache.length``) live in
        ``cache``, a ``KVCache`` ring or a ``PagedKVCache`` whose pages
        covering the chunk are mapped.  ``valid_len`` (B,) marks the real
        chunk rows; pad rows never write and never leak into real rows.
        ``window`` is the layer's (0: full attention).  The attend reads
        the prefix BEFORE the chunk is written (in place): a wrapping
        chunk would otherwise overwrite prefix tokens still inside earlier
        rows' windows.
        Returns (out (B, C, d), the same cache, its ``length`` set in place
        to ``start + valid_len`` on the rows that wrote)."""
        b, c_len, _ = x.shape
        dev = x.device
        start = cache.length if start is None else start
        start = torch.as_tensor(start, device=dev).to(torch.int64).expand(b)
        valid = (torch.full((b,), c_len, dtype=torch.int64, device=dev)
                 if valid_len is None else
                 torch.as_tensor(valid_len, device=dev).to(
                     torch.int64).expand(b))
        positions = start[:, None] + torch.arange(c_len, device=dev)[None, :]
        q_bits, k_bits, v = self._project_qkv_deploy(params, x, positions)
        v_bits = self._v_bits(params, v).transpose(1, 2)       # (B,Hkv,C,dh)
        kc_old, vc_old, ring = self._cache_ring_view(cache)
        ctx = self._chunk_attend(params, q_bits, k_bits, v_bits, kc_old,
                                 vc_old, start, valid, ring, window)
        out = self._output_deploy(params, ctx)
        return out, self._write_chunk(cache, k_bits, v_bits, start, valid,
                                      vc_old)

    # -- speculative verify (attend only) and the deferred commit -------------

    def deploy_verify_chunk(self, params: Params, x: torch.Tensor, cache, *,
                            window: int = 0,
                            start: Optional[torch.Tensor] = None,
                            valid: Optional[torch.Tensor] = None):
        """Score a candidate chunk WITHOUT writing the cache: the attend of
        ``deploy_prefill_chunk`` with the write deferred.  x (B, C, d) holds
        each sequence's pending token and its drafted tokens; ``valid``
        (B,) the real leading positions (default all C).  Returns (out (B,
        C, d), (k_bits (B,Hkv,C,dhp), v_bits (B,Hkv,C,dh) bool)), which
        ``commit_chunk`` writes once acceptance is known, so a rejected
        draft never reaches the cache."""
        b, c_len, _ = x.shape
        dev = x.device
        start = cache.length if start is None else start
        start = torch.as_tensor(start, device=dev).to(torch.int64).expand(b)
        valid = (torch.full((b,), c_len, dtype=torch.int64, device=dev)
                 if valid is None else
                 torch.as_tensor(valid, device=dev).to(torch.int64).expand(b))
        positions = start[:, None] + torch.arange(c_len, device=dev)[None, :]
        q_bits, k_bits, v = self._project_qkv_deploy(params, x, positions)
        v_bits = self._v_bits(params, v).transpose(1, 2)       # (B,Hkv,C,dh)
        kc_old, vc_old, ring = self._cache_ring_view(cache)
        ctx = self._chunk_attend(params, q_bits, k_bits, v_bits, kc_old,
                                 vc_old, start, valid, ring, window)
        return self._output_deploy(params, ctx), (k_bits, v_bits)

    def commit_chunk(self, cache, proj: Tuple[torch.Tensor, torch.Tensor],
                     start: torch.Tensor, n_commit: torch.Tensor):
        """Write the first ``n_commit[b]`` positions of a verified chunk
        (the projections of ``deploy_verify_chunk``) at ``start[b]``, in
        place.  Rows with n_commit == 0 keep their content and length.
        The V^T ring view is read here, after the verify, which wrote
        nothing.  Returns the same cache."""
        k_bits, v_bits = proj
        b = k_bits.shape[0]
        dev = k_bits.device
        start = torch.as_tensor(start, device=dev).to(torch.int64).expand(b)
        n_commit = torch.as_tensor(n_commit, device=dev).to(
            torch.int64).expand(b)
        vc_old = self._cache_ring_view(cache)[1]
        return self._write_chunk(cache, k_bits, v_bits, start, n_commit,
                                 vc_old)

    # -- cross-attention over a static memory ---------------------------------

    def build_memory_cache(self, params: Params, memory: torch.Tensor,
                           split: Optional[sharding.Split] = None
                           ) -> KVCache:
        """Project an encoder's output (B, S_enc, d) once into the binary
        memory: K bits (B, Hkv, S_enc, dhp) and V^T (B, Hkv, d_h,
        ceil(S_enc/32)) packed along the memory by the pack kernel's
        strided route (as ``deploy_prefill`` packs V^T), with length
        S_enc.  No RoPE: the keys carry no position.  ``split`` (a split
        prefill): ``memory`` is this rank's block of the memory, and the
        result the KV heads its query heads read over the whole memory
        (the bits sent by one all-to-all, as ``deploy_prefill``'s)."""
        b, s, _ = memory.shape
        _, k_bits, v = self._project_qkv_deploy(params, memory, None,
                                                parts=("wk", "wv"))
        vt_bits = pack_ops.pack_threshold(v.permute(0, 2, 3, 1),
                                          params["v_beta"][:, None, None])
        if split is not None:
            k_bits, vt_bits = self._prefill_heads(
                split, self._split_heads(split),
                [(k_bits, "kv", 2), (vt_bits, "kv", 3)])
            s *= split.width
        return KVCache(k_bits, vt_bits,
                       torch.full((b,), s, dtype=torch.int32,
                                  device=memory.device))

    def attend_memory(self, params: Params, x: torch.Tensor,
                      mem: KVCache,
                      split: Optional[sharding.Split] = None
                      ) -> torch.Tensor:
        """Cross-attention of x (B, S, d), any S, over the static memory
        ``mem`` (read, never written; no causal mask).  The G*S query rows
        of each KV head are the M of one xnor ``rbmm_int`` against its
        memory keys (the decode route at M <= 16, the tensor cores above);
        the SPS threshold, and the mask of memory columns >= ``mem.length``;
        the probabilities packed along the memory (by the pack kernel
        where M > 16); the context 2*popcount(P & V^T) - nnz(P) as the
        and_dc ``rbmm_int`` over K = S_enc, whose derived dc cancels the
        -K (``_attend_heads``).  Queries sit at rows 0..S-1 of the ``row``
        table, as in the JAX package: a decode step reads row 0.  On a
        mesh (a placed memory) the rank attends its query heads over its
        block of the memory (``_share``), which is read, never
        gathered.  ``split`` (a split prefill): ``x`` and the output are
        this rank's block of the queries, ``mem`` its KV heads'
        (``build_memory_cache(split=)``); the rank attends its query heads
        at every query position, their bits sent to it and the context's
        back by an all-to-all each."""
        s = x.shape[1]
        if split is not None:
            return self._attend_memory_split(params, x, mem, split)
        share = self._share(mem.k_bits, mem.vt_bits)
        part = None if share.whole else share
        q_bits, _, _ = self._project_qkv_deploy(params, x, None,
                                                parts=("wq",), share=part)
        th = self._theta_at(self._theta_heads(params, share),
                            torch.arange(s, device=x.device))   # (S, nh)
        valid = self._slots(share, x.device)[None, :] < \
            mem.length.reshape(-1, 1)                        # (B, Skv)
        ctx = self._attend_heads(q_bits, mem.k_bits, mem.vt_bits, th.T[None],
                                 valid, share)
        return self._output_deploy(params, ctx, part)

    def _attend_memory_split(self, params: Params, x: torch.Tensor,
                             mem: KVCache,
                             split: sharding.Split) -> torch.Tensor:
        """``attend_memory`` on a split (see there)."""
        qs, kvs = spans = self._split_heads(split)
        heads, kv = qs[split.index], kvs[split.index]
        q_bits, _, _ = self._project_qkv_deploy(params, x, None,
                                                parts=("wq",))
        q_bits, = self._prefill_heads(split, spans, [(q_bits, "q", 2)])
        s, w = q_bits.shape[2], mem.k_bits.shape[2]
        share = _Share(split, heads, qs, kv, w, (0, w),
                       (0, mem.vt_bits.shape[3]), (0, self.head_dim))
        th = self._theta_at(self._theta_int(params)[heads[0]:heads[1]],
                            torch.arange(s, device=x.device))   # (S, nh)
        valid = torch.arange(w, device=x.device)[None, :] < \
            mem.length.reshape(-1, 1)                        # (B, Skv)
        ctx = self._attend_heads(q_bits, mem.k_bits, mem.vt_bits, th.T[None],
                                 valid, share)
        return self._prefill_output(params, ctx, split, qs)

    # -- a rank's query heads over a ring or a memory -------------------------

    def _theta_heads(self, params: Params, share: _Share) -> torch.Tensor:
        """``_theta_int`` of ``share``'s query heads."""
        theta = self._theta_int(params)
        return theta if share.whole else theta[share.heads[0]:
                                               share.heads[1]]

    @staticmethod
    def _slots(share: _Share, device) -> torch.Tensor:
        """The ring slots (memory positions) of this rank's K block."""
        s0, s1 = share.slots
        idx = torch.arange(s1 - s0, device=device)
        return idx if s0 == 0 else idx + s0

    def _segments(self, h0: int, h1: int) -> List[Tuple[int, int, int, int]]:
        """Query heads [h0, h1) cut by KV group: (first head, end, first KV
        head, KV heads) a cut; whole groups go together, a partial group
        alone (one at each end at most)."""
        g, out, a = self.groups, [], h0
        while a < h1:
            if a % g == 0 and a + g <= h1:
                n = (h1 - a) // g
                out.append((a, a + n * g, a // g, n))
            else:
                out.append((a, min(h1, (a // g + 1) * g), a // g, 1))
            a = out[-1][1]
        return out

    def _attend_heads(self, q_bits: torch.Tensor, kc: torch.Tensor,
                      vc: torch.Tensor, th: torch.Tensor, valid: torch.Tensor,
                      share: _Share) -> torch.Tensor:
        """The context of ``share``'s query heads over a ring or a memory:
        q_bits (B, nh, R, dhp), R query rows of each head; kc (B, nk, W,
        dhp) and vc (B, nk, dh', W'/32) the K and V^T blocks, KV heads from
        ``share.kv[0]`` on; th (B or 1, nh, R) int32 thresholds; valid
        (B, W) the keys of kc's slots that count -> (B, nh, R, dh) int32.

        Each KV group's query rows are the M of one xnor ``rbmm_int``
        against its KV head's keys (a cut of whole groups batched over
        them, a partial group alone: ``_segments``); the probabilities are
        packed along the keys (by the pack kernel where M > 16); the
        context 2 popc(P & V^T) - nnz(P) is the and_dc ``rbmm_int`` over
        them, whose derived dc cancels the -K.  A ring split over the data
        axes (``share``): with V^T split on its words as K on its slots,
        each rank's int32 partial context is summed over them (exact);
        with V^T split on its d_h rows (or whole), the probabilities' bits
        are gathered over K's axes, and the context's d_h rows over
        V^T's."""
        b, _, r, dhp = q_bits.shape
        (h0, h1), kv0 = share.heads, share.kv[0]
        gather = bool(share.k_axes) and not share.w_axes
        keys = share.ring if gather else kc.shape[2]
        thr = th if th.shape[0] > 1 else th[0]
        ctxs = []
        for a, c, k0, n in self._segments(h0, h1):
            rows = (c - a) // n * r

            def heads_of(t, i=k0 - kv0, n=n):
                return t if (i, n) == (0, t.shape[1]) else \
                    t[:, i:i + n].contiguous()
            q = q_bits if (a, c) == (h0, h1) else q_bits[:, a - h0:c - h0]
            sc = rbmm.rbmm_int(q.reshape(b, n, rows, dhp), heads_of(kc),
                               self.head_dim, scheme="xnor",
                               impl=self._score_impl())  # (B, n, rows, W)
            t = thr[..., a - h0:c - h0, :]
            t = t.reshape(t.shape[:-2] + (n, rows, 1))
            if gather:
                probs_p = sharding.gather_bool(
                    (sc >= t) & valid[:, None, None, :], share.mesh,
                    share.k_axes)
            elif rows > 16:
                probs_p = (pack_ops.pack_threshold(sc, t) &
                           packing.pack_bits(valid)[:, None, None, :])
            else:
                probs_p = packing.pack_bits((sc >= t) &
                                            valid[:, None, None, :])
            ctx = rbmm.rbmm_int(probs_p, heads_of(vc), keys,
                                scheme="and_dc", impl="popcount")
            ctxs.append(ctx.reshape(b, c - a, r, ctx.shape[-1]))
        if not ctxs:
            return q_bits.new_zeros((b, 0, r, self.head_dim))
        ctx = ctxs[0] if len(ctxs) == 1 else torch.cat(ctxs, 1)
        if share.w_axes:
            ctx = share.mesh.all_reduce(ctx, share.w_axes)
        elif share.d_axes:
            ctx = share.mesh.all_gather(ctx.contiguous(), share.d_axes, 3)
        return ctx

    # -- decode ---------------------------------------------------------------

    def init_cache(self, batch: int, max_len: int, device) -> KVCache:
        hkv, dh = self.num_kv_heads, self.head_dim
        return KVCache(
            torch.zeros((batch, hkv, max_len, packing.packed_len(dh)),
                        dtype=torch.int32, device=device),
            torch.zeros((batch, hkv, dh, packing.packed_len(max_len)),
                        dtype=torch.int32, device=device),
            torch.zeros((batch,), dtype=torch.int32, device=device))

    def init_paged_cache(self, batch: int, *, ring_len: int,
                         page_size: int, num_blocks: int, num_pages: int,
                         device) -> PagedKVCache:
        """An empty page arena (``num_pages`` usable pages plus the trash
        page 0) and block tables for this layer; ``num_blocks`` pages of
        ``page_size`` must cover ``ring_len``."""
        _check_page_size(page_size)
        if num_blocks * page_size < ring_len:
            raise ValueError(f"{num_blocks} blocks of {page_size} cannot "
                             f"cover ring_len={ring_len}")
        hkv, dh = self.num_kv_heads, self.head_dim
        zeros = lambda *s: torch.zeros(s, dtype=torch.int32, device=device)
        return PagedKVCache(
            k_pages=zeros(num_pages + 1, hkv, page_size,
                          packing.packed_len(dh)),
            vt_pages=zeros(num_pages + 1, hkv, dh,
                           page_size // packing.WORD),
            block_table=zeros(batch, num_blocks),
            length=zeros(batch),
            ring_len=int(ring_len))

    def _v_bits(self, params: Params, v: torch.Tensor,
                kv: Optional[Tuple[int, int]] = None) -> torch.Tensor:
        """fp V projection (B, S, Hkv, dh) -> its per-head bits, bool (of
        the KV heads [kv0, kv1) where ``kv`` names them)."""
        beta = params["v_beta"] if kv is None else \
            params["v_beta"][kv[0]:kv[1]]
        return v.to(torch.float32) >= beta[:, None]

    def _write_token(self, params: Params, k_store: torch.Tensor,
                     vt_store: torch.Tensor, row: torch.Tensor,
                     col: torch.Tensor, k_new: torch.Tensor,
                     v: torch.Tensor,
                     keep: Optional[torch.Tensor] = None,
                     share: Optional[_Share] = None) -> None:
        """Write one decode token per sequence in place: K words at
        ``k_store[row, :, col]`` and the V^T bit (col % 32) of word
        (col // 32) in ``vt_store[row, :, :, ...]``.  ``row`` is the
        sequence of a ring or the physical page of an arena, ``col`` the
        ring slot or the in-page offset.  Sequences where ``keep`` (B,) is
        False write zeros (the trash page's rows).  With a ``share`` the
        stores are this rank's blocks of a ring and ``k_new``, ``v`` the
        new token of the KV heads they hold; where the ring is split over
        the data axes only the rank whose block holds the slot (the word)
        writes it, each rank its d_h rows of V^T."""
        k_row = k_new[:, :, 0]
        word = col // packing.WORD
        mask = packing.bit_mask(col % packing.WORD)[:, None, None]
        v_bit = self._v_bits(params, v[:, 0], share and share.kv
                             ).to(torch.int32)                 # (B,Hkv,dh)
        own_v = None
        if share is not None:
            if share.d_axes:
                v_bit = v_bit[..., share.rows[0]:share.rows[1]]
            if share.k_axes:
                s0, s1 = share.slots
                own, col = (col >= s0) & (col < s1), (col - s0).clamp(
                    0, s1 - s0 - 1)
                k_row = torch.where(own[:, None, None], k_row,
                                    k_store[row, :, col])
            if share.w_axes:
                w0, w1 = share.words
                own_v, word = (word >= w0) & (word < w1), (word - w0).clamp(
                    0, w1 - w0 - 1)
        old = vt_store[row, :, :, word]
        new = (old & ~mask) | (v_bit * mask)
        if own_v is not None:
            new = torch.where(own_v[:, None, None], new, old)
        if keep is not None:
            k_row = torch.where(keep[:, None, None], k_row, 0)
            new = torch.where(keep[:, None, None], new, 0)
        k_store[row, :, col] = k_row
        vt_store[row, :, :, word] = new

    def deploy_decode(self, params: Params, x: torch.Tensor,
                      cache: KVCache) -> Tuple[torch.Tensor, KVCache]:
        """x: (B, 1, d) one new token per sequence.  Every sequence
        advances from its own ``cache.length``.  A ``PagedKVCache`` takes
        the paged path.  A windowed layer's ring (or ring group) is its
        window, so the ring itself enforces the window: once it has
        wrapped, every slot holds one of the last W tokens.  The cache
        tensors, ``length`` included, are
        updated IN PLACE (the JAX package returns new arrays), and the
        same cache is returned: a captured CUDA graph of the step keeps
        reading the addresses it was captured with.

        On a mesh (``cache`` this rank's placed blocks, ``params`` its
        blocks of the weights) the rank projects and attends its query
        heads (``_share``), writes the new token of the KV heads its block
        holds, and scores the keys of its slots, each masked by its global
        slot (``_attend_heads``): nothing of the ring is gathered."""
        if isinstance(cache, PagedKVCache):
            return self._deploy_decode_paged(params, x, cache)
        b = x.shape[0]
        share = self._share(cache.k_bits, cache.vt_bits)
        part = None if share.whole else share
        pos = cache.length.to(torch.int32)
        q_bits, k_new, v = self._project_qkv_deploy(params, x, pos[:, None],
                                                    share=part)
        self._write_token(params, cache.k_bits, cache.vt_bits,
                          torch.arange(b, device=x.device),
                          torch.remainder(pos, share.ring).long(), k_new, v,
                          share=part)
        valid = self._slots(share, x.device)[None, :] <= pos[:, None]
        th = self._theta_at(self._theta_heads(params, share), pos)
        ctx = self._attend_heads(q_bits, cache.k_bits, cache.vt_bits,
                                 th[:, :, None], valid, share)
        out = self._output_deploy(params, ctx, part)
        cache.length.add_(1)      # pos aliases it: every reader comes first
        return out, cache

    def _deploy_decode_paged(self, params: Params, x: torch.Tensor,
                             cache: PagedKVCache
                             ) -> Tuple[torch.Tensor, PagedKVCache]:
        """Paged decode step: write the new K/V^T bits through the block
        table (free pool rows have table rows of 0 and write zeros to the
        trash page), then attend over the pages with the paged_gather_decode
        kernel; the gathered ring view is never built.  ``ring_len`` is
        a host int, so a captured graph of the step bakes it in: that is
        right, because it is fixed for the arena's life."""
        b = x.shape[0]
        page = cache.k_pages.shape[2]
        pos = cache.length.to(torch.int32)
        q_bits, k_new, v = self._project_qkv_deploy(params, x, pos[:, None])
        # logical ring slot -> (physical page, in-page offset)
        slot = torch.remainder(pos, cache.ring_len).long()
        phys = cache.block_table[torch.arange(b, device=x.device),
                                 slot // page].long()
        self._write_token(params, cache.k_pages, cache.vt_pages, phys,
                          slot % page, k_new, v, keep=phys != 0)
        theta = self._theta_at(self._theta_int(params), pos)     # (B, H)
        ctx = paged_ops.paged_gather_decode(
            q_bits[:, :, 0], cache.k_pages, cache.vt_pages,
            cache.block_table, pos, cache.ring_len, theta.contiguous(),
            d_h=self.head_dim)
        out = self._output_deploy(params, ctx[:, :, None, :])
        cache.length.add_(1)      # pos aliases it: every reader comes first
        return out, cache
