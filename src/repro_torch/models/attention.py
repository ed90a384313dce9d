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
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.core import binarize, packing, rbmm, sps
from repro_torch.kernels.pack import ops as pack_ops
from repro_torch.kernels.paged_attn import ops as paged_ops
from repro_torch.kernels.paged_attn import ref as paged_ref
from repro_torch.kernels.sps_attn import ops as sps_ops
from repro_torch.models.linear import BinaryDense, act_bits_packed

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

    def _dense(self, in_dim, out_dim, col: bool) -> BinaryDense:
        return BinaryDense(in_dim, out_dim, use_bias=self.qkv_bias and col,
                           external_act=True, dtype=self.dtype)

    def _denses(self) -> Dict[str, BinaryDense]:
        return {"wq": self._dense(self.d_model, self.q_dim, True),
                "wk": self._dense(self.d_model, self.kv_dim, True),
                "wv": self._dense(self.d_model, self.kv_dim, True),
                "wo": self._dense(self.q_dim, self.d_model, False)}

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

    def _repeat_kv(self, x: torch.Tensor) -> torch.Tensor:
        """(B, Hkv, ...) -> (B, H, ...): each KV head for its G query
        heads."""
        if self.groups == 1:
            return x
        b, hkv = x.shape[:2]
        return x[:, :, None].expand(b, hkv, self.groups, *x.shape[2:]
                                    ).reshape(b, hkv * self.groups,
                                              *x.shape[2:])

    def qat(self, params: Params, x: torch.Tensor, *, memory=None,
            positions: Optional[torch.Tensor] = None, window=None,
            kv_len=None, collect_scores: bool = False
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """QAT forward: x (B, S, d) -> (out (B, S, d) in ``dtype``, aux).
        Cross-attention takes its keys and values from ``memory`` (B,
        S_kv, d), binarized with this block's own ``act_alpha`` and
        ``act_beta``; its mask is the key length alone, and RoPE is off.
        ``window`` masks keys at or before row - window (causal only);
        ``kv_len`` masks keys from there on; ``collect_scores`` returns the
        float32 scores and probabilities (B, H, S, S_kv) in aux."""
        if self.cross and memory is None:
            raise ValueError("cross-attention's QAT face needs memory")
        b, s, _ = x.shape
        h, hkv, dh = self.num_heads, self.num_kv_heads, self.head_dim
        dev = x.device
        xkv = memory if self.cross else x
        skv = xkv.shape[1]
        if positions is None:
            positions = torch.arange(s, device=dev)[None, :]
        alpha = params["act_alpha"].clamp_min(1e-6)
        beta = params["act_beta"]

        def signs(t):
            return binarize.sign_ste(
                (binarize.promote(t, alpha, beta) - beta) / alpha)

        s_x = signs(x)
        s_kv = signs(xkv) if self.cross else s_x
        dense = self._denses()
        q = dense["wq"].apply(params["wq"], act_values=s_x, act_scale=alpha)
        k, v = (dense[n].apply(params[n], act_values=s_kv, act_scale=alpha)
                for n in ("wk", "wv"))
        q = q.reshape(b, s, h, dh)
        k = k.reshape(b, skv, hkv, dh)
        v = v.reshape(b, skv, hkv, dh)
        if self.use_rope and not self.cross:
            q = rope(q, positions, self.rope_theta)
            k = rope(k, positions[:, :s], self.rope_theta)

        def headwise_sign(t, alpha_h, beta_h):
            t = t.transpose(1, 2)                       # (B, H*, S, dh)
            z = (t - beta_h[None, :, None, None]) / \
                alpha_h[None, :, None, None].clamp_min(1e-6)
            return binarize.sign_ste(z)

        s_q = headwise_sign(q, params["q_alpha"], params["q_beta"])
        s_k = self._repeat_kv(headwise_sign(k, params["k_alpha"],
                                            params["k_beta"]))
        s_v = self._repeat_kv(headwise_sign(v, params["v_alpha"],
                                            params["v_beta"]))
        scale_qk = (params["q_alpha"][:, None, None] *
                    self._repeat_kv(params["k_alpha"][None])[0][
                        :, None, None] / math.sqrt(dh))
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
            aux["scores"], aux["probs"] = z, probs
        av = self._repeat_kv(params["v_alpha"][None])[0]
        ctx = ctx * av[None, :, None, None]
        ca = params["ctx_alpha"].clamp_min(1e-6)
        s_c = binarize.sign_ste((ctx - params["ctx_beta"]) / ca)
        s_c = s_c.transpose(1, 2).reshape(b, s, self.q_dim)
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

    def _project_qkv_deploy(self, params: Params, x: torch.Tensor,
                            positions: torch.Tensor,
                            parts: Tuple[str, ...] = ("wq", "wk", "wv")
                            ) -> Tuple[Optional[torch.Tensor],
                                       Optional[torch.Tensor],
                                       Optional[torch.Tensor]]:
        """x (B,S,d) -> q_bits (B,H,S,dhp), k_bits (B,Hkv,S,dhp) and the fp
        V projection (B,S,Hkv,dh), which prefill packs along S and decode
        thresholds per element.  Only the projections of ``parts`` run
        (the others come back None): cross-attention projects its queries
        and its memory apart."""
        b, s, _ = x.shape
        h, hkv, dh = self.num_heads, self.num_kv_heads, self.head_dim
        dense = self._denses()
        bits_x = act_bits_packed(x, params["act_beta"])
        alpha = params["act_alpha"]
        proj = {name: dense[name].apply_deploy(
                    params[name], bits=bits_x, act_alpha=alpha,
                    impl=self.impl) for name in parts}
        heads = {"wq": h, "wk": hkv, "wv": hkv}
        q, k, v = (proj[n].reshape(b, s, heads[n], dh) if n in proj
                   else None for n in ("wq", "wk", "wv"))
        if self.use_rope:
            q = rope(q, positions, self.rope_theta)
            k = rope(k, positions, self.rope_theta)
        # per-head binarize + pack on the (B,S,H,dh) layout, then move the
        # (32x smaller) words to the head-major layout
        q_bits, k_bits = (
            None if t is None else pack_ops.pack_threshold(
                t, params[beta][:, None]).transpose(1, 2).contiguous()
            for t, beta in ((q, "q_beta"), (k, "k_beta")))
        return q_bits, k_bits, v

    def _output_deploy(self, params: Params,
                       ctx_int: torch.Tensor) -> torch.Tensor:
        """ctx_int (B, H, S, dh) int32 -> wo -> (B, S, d)."""
        b, h, s, dh = ctx_int.shape
        av = self._per_query_head(params["v_alpha"])
        ctx = ctx_int.to(torch.float32) * av[None, :, None, None]
        ctx = ctx.transpose(1, 2).reshape(b, s, self.q_dim)
        bits = pack_ops.pack_threshold(ctx, params["ctx_beta"])
        return self._denses()["wo"].apply_deploy(
            params["wo"], bits=bits, act_alpha=params["ctx_alpha"],
            impl=self.impl)

    # -- prefill --------------------------------------------------------------

    def deploy_prefill(self, params: Params, x: torch.Tensor, *,
                       positions: Optional[torch.Tensor] = None,
                       window: int = 0, cache_size: int = 0,
                       seq_lens: Optional[torch.Tensor] = None
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
        still compute, but no real row reads them."""
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

    def build_memory_cache(self, params: Params,
                           memory: torch.Tensor) -> KVCache:
        """Project an encoder's output (B, S_enc, d) once into the binary
        memory: K bits (B, Hkv, S_enc, dhp) and V^T (B, Hkv, d_h,
        ceil(S_enc/32)) packed along the memory by the pack kernel's
        strided route (as ``deploy_prefill`` packs V^T), with length
        S_enc.  No RoPE: the keys carry no position."""
        b, s, _ = memory.shape
        _, k_bits, v = self._project_qkv_deploy(params, memory, None,
                                                parts=("wk", "wv"))
        vt_bits = pack_ops.pack_threshold(v.permute(0, 2, 3, 1),
                                          params["v_beta"][:, None, None])
        return KVCache(k_bits, vt_bits,
                       torch.full((b,), s, dtype=torch.int32,
                                  device=memory.device))

    def attend_memory(self, params: Params, x: torch.Tensor,
                      mem: KVCache) -> torch.Tensor:
        """Cross-attention of x (B, S, d), any S, over the static memory
        ``mem`` (read, never written; no causal mask).  The G*S query rows
        of each KV head are the M of one xnor ``rbmm_int`` against its
        memory keys (the decode route at M <= 16, the tensor cores above);
        the SPS threshold, and the mask of memory columns >= ``mem.length``;
        the probabilities packed along the memory (by the pack kernel
        where M > 16); the context 2*popcount(P & V^T) - nnz(P) as the
        and_dc ``rbmm_int`` over K = S_enc, whose derived dc cancels the
        -K.  Queries sit at rows 0..S-1 of the ``row`` table, as in the
        JAX package: a decode step reads row 0."""
        b, s, _ = x.shape
        h, hkv, g, dh = (self.num_heads, self.num_kv_heads, self.groups,
                         self.head_dim)
        skv = mem.k_bits.shape[2]
        dev = x.device
        q_bits, _, _ = self._project_qkv_deploy(params, x, None,
                                                parts=("wq",))
        qg = self._grouped(q_bits)                           # (B,Hkv,G*S,dhp)
        c = rbmm.rbmm_int(qg, mem.k_bits, dh, scheme="xnor",
                          impl=self._score_impl())          # (B,Hkv,G*S,Skv)
        th = self._theta_at(self._theta_int(params),
                            torch.arange(s, device=dev))     # (S, H)
        th_rows = th.T.reshape(hkv, g * s, 1)
        valid = (torch.arange(skv, device=dev)[None, :] <
                 mem.length.reshape(-1, 1))                  # (B, Skv)
        if g * s > 16:
            probs_p = (pack_ops.pack_threshold(c, th_rows) &
                       packing.pack_bits(valid)[:, None, None, :])
        else:
            probs_p = packing.pack_bits((c >= th_rows) &
                                        valid[:, None, None, :])
        ctx = rbmm.rbmm_int(probs_p, mem.vt_bits, skv, scheme="and_dc",
                            impl="popcount")                # (B,Hkv,G*S,dh)
        return self._output_deploy(params, ctx.reshape(b, h, s, dh))

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

    def _v_bits(self, params: Params, v: torch.Tensor) -> torch.Tensor:
        """fp V projection (B, S, Hkv, dh) -> its per-head bits, bool."""
        return v.to(torch.float32) >= params["v_beta"][:, None]

    def _write_token(self, params: Params, k_store: torch.Tensor,
                     vt_store: torch.Tensor, row: torch.Tensor,
                     col: torch.Tensor, k_new: torch.Tensor,
                     v: torch.Tensor,
                     keep: Optional[torch.Tensor] = None) -> None:
        """Write one decode token per sequence in place: K words at
        ``k_store[row, :, col]`` and the V^T bit (col % 32) of word
        (col // 32) in ``vt_store[row, :, :, ...]``.  ``row`` is the
        sequence of a ring or the physical page of an arena, ``col`` the
        ring slot or the in-page offset.  Sequences where ``keep`` (B,) is
        False write zeros (the trash page's rows)."""
        k_row = k_new[:, :, 0]
        word = col // packing.WORD
        mask = packing.bit_mask(col % packing.WORD)[:, None, None]
        v_bit = self._v_bits(params, v[:, 0]).to(torch.int32)  # (B,Hkv,dh)
        old = vt_store[row, :, :, word]
        new = (old & ~mask) | (v_bit * mask)
        if keep is not None:
            k_row = torch.where(keep[:, None, None], k_row, 0)
            new = torch.where(keep[:, None, None], new, 0)
        k_store[row, :, col] = k_row
        vt_store[row, :, :, word] = new

    def _attend_cache(self, params: Params, q_bits: torch.Tensor,
                      kc: torch.Tensor, vc: torch.Tensor, pos: torch.Tensor,
                      valid: torch.Tensor) -> torch.Tensor:
        """One query token per sequence (B,H,1,dhp) at positions ``pos``
        (B,) against the packed K (B,Hkv,W,dhp) / V^T (B,Hkv,dh,W/32)
        ring; ``valid`` (B, W)."""
        b = q_bits.shape[0]
        h, hkv, dh, g = (self.num_heads, self.num_kv_heads, self.head_dim,
                         self.groups)
        w = kc.shape[2]
        # each KV head scores its G query heads as the rows of one RBMM
        qg = q_bits.reshape(b, hkv, g, q_bits.shape[-1])
        c = rbmm.rbmm_int(qg, kc, dh, scheme="xnor",
                          impl=self._score_impl()).reshape(b, h, 1, w)
        th = self._theta_at(self._theta_int(params), pos)[:, :, None, None]
        probs = (c >= th) & valid[:, None, None, :]
        probs_p = packing.pack_bits(probs).reshape(b, hkv, g, -1)
        # context = 2*popcount(P & V^T) - nnz(P): the and_dc RBMM over the
        # ring (k = W; its derived dc = W - nnz cancels the -W)
        ctx = rbmm.rbmm_int(probs_p, vc, w, scheme="and_dc",
                            impl="popcount")
        return self._output_deploy(params, ctx.reshape(b, h, 1, dh))

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
        reading the addresses it was captured with."""
        if isinstance(cache, PagedKVCache):
            return self._deploy_decode_paged(params, x, cache)
        b = x.shape[0]
        w = cache.k_bits.shape[2]
        pos = cache.length.to(torch.int32)
        q_bits, k_new, v = self._project_qkv_deploy(params, x,
                                                    pos[:, None])
        self._write_token(params, cache.k_bits, cache.vt_bits,
                          torch.arange(b, device=x.device),
                          torch.remainder(pos, w).long(), k_new, v)
        valid = torch.arange(w, device=x.device)[None, :] <= pos[:, None]
        out = self._attend_cache(params, q_bits, cache.k_bits,
                                 cache.vt_bits, pos, valid)
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
