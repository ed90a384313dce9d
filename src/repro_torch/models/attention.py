"""SPS binary attention, deploy faces (port of ``repro.models.attention``).

  deploy_prefill  packed-bit forward over a whole prompt: shared input
                  binarization (pack kernel) -> Q/K/V projections (RBMM
                  kernels) -> RoPE -> per-head binarization (pack kernel)
                  -> fused causal SPS attention (sps_attention kernel) ->
                  context binarization -> output projection; also builds
                  the contiguous binary ring cache.
  deploy_decode   one token per sequence against the ring: K packed along
                  d_h, V^T packed along the ring, probabilities packed in
                  flight; score and context both run on the rbmm_int kernel
                  (xnor, then and_dc).

Decode always reads the cache grouped by KV head (the query heads of one
group are the rows of one RBMM against their KV head's ring) — the same
integers as repeating K/V to every head, without the copy.  Supports GQA,
RoPE and the ``layer`` / ``head`` SPS threshold granularities; ``row``,
sliding windows, cross-attention, chunked prefill, speculation and paging
are not ported yet.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.core import packing, rbmm
from repro_torch.kernels.pack import ops as pack_ops
from repro_torch.kernels.sps_attn import ops as sps_ops
from repro_torch.models.linear import BinaryDense, act_bits_packed

Params = Dict[str, Any]

SCORE_IMPLS = ("auto", "popcount", "mxu", "dense")
GRANULARITIES = ("layer", "head")


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
    sps_granularity: str = "head"   # layer | head
    dtype: torch.dtype = torch.float32
    impl: str = "auto"              # projection route (core.rbmm)
    score_impl: str = "auto"        # decode score route; auto = popcount

    def __post_init__(self):
        if self.sps_granularity not in GRANULARITIES:
            raise NotImplementedError(
                f"sps_granularity={self.sps_granularity!r} is not ported "
                f"yet; the port supports {GRANULARITIES}")

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
                 sps_lambda=zeros() if self.sps_granularity == "layer"
                 else zeros(h),
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

    # -- shared deploy pieces -------------------------------------------------

    def _score_impl(self) -> str:
        if self.score_impl not in SCORE_IMPLS:
            raise ValueError(f"score_impl must be one of {SCORE_IMPLS}, "
                             f"got {self.score_impl!r}")
        return "popcount" if self.score_impl == "auto" else self.score_impl

    def _theta_int(self, params: Params) -> torch.Tensor:
        """Integer SPS thresholds per query head, (H,) int32."""
        ak = params["k_alpha"].repeat_interleave(self.groups)
        scale = (params["q_alpha"] * ak) / math.sqrt(self.head_dim)
        lam = params["sps_lambda"].expand(self.num_heads)
        return torch.ceil(lam / scale.clamp_min(1e-12)).to(torch.int32)

    def _project_qkv_deploy(self, params: Params, x: torch.Tensor,
                            positions: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
        """x (B,S,d) -> q_bits (B,H,S,dhp), k_bits (B,Hkv,S,dhp) and the fp
        V projection (B,S,Hkv,dh), which prefill packs along S and decode
        thresholds per element."""
        b, s, _ = x.shape
        h, hkv, dh = self.num_heads, self.num_kv_heads, self.head_dim
        dense = self._denses()
        bits_x = act_bits_packed(x, params["act_beta"])
        alpha = params["act_alpha"]
        proj = {name: dense[name].apply_deploy(
                    params[name], bits=bits_x, act_alpha=alpha,
                    impl=self.impl) for name in ("wq", "wk", "wv")}
        q = proj["wq"].reshape(b, s, h, dh)
        k = proj["wk"].reshape(b, s, hkv, dh)
        v = proj["wv"].reshape(b, s, hkv, dh)
        if self.use_rope:
            q = rope(q, positions, self.rope_theta)
            k = rope(k, positions, self.rope_theta)
        # per-head binarize + pack on the (B,S,H,dh) layout, then move the
        # (32x smaller) words to the head-major layout
        q_bits = pack_ops.pack_threshold(q, params["q_beta"][:, None])
        k_bits = pack_ops.pack_threshold(k, params["k_beta"][:, None])
        return (q_bits.transpose(1, 2).contiguous(),
                k_bits.transpose(1, 2).contiguous(), v)

    def _output_deploy(self, params: Params,
                       ctx_int: torch.Tensor) -> torch.Tensor:
        """ctx_int (B, H, S, dh) int32 -> wo -> (B, S, d)."""
        b, h, s, dh = ctx_int.shape
        av = params["v_alpha"].repeat_interleave(self.groups)
        ctx = ctx_int.to(torch.float32) * av[None, :, None, None]
        ctx = ctx.transpose(1, 2).reshape(b, s, self.q_dim)
        bits = pack_ops.pack_threshold(ctx, params["ctx_beta"])
        return self._denses()["wo"].apply_deploy(
            params["wo"], bits=bits, act_alpha=params["ctx_alpha"],
            impl=self.impl)

    # -- prefill --------------------------------------------------------------

    def deploy_prefill(self, params: Params, x: torch.Tensor, *,
                       positions: Optional[torch.Tensor] = None,
                       cache_size: int = 0
                       ) -> Tuple[torch.Tensor, Optional[KVCache]]:
        """Full-sequence deploy forward.  Returns (out, cache); the ring
        cache (W = cache_size) is built when cache_size > 0."""
        b, s, _ = x.shape
        if positions is None:
            positions = torch.arange(s, device=x.device)[None, :]
        q_bits, k_bits, v = self._project_qkv_deploy(params, x, positions)
        # V^T packed along the sequence, straight from the fp projection
        vt_bits = pack_ops.pack_threshold(v.permute(0, 2, 3, 1),
                                          params["v_beta"][:, None, None])
        ctx = sps_ops.sps_attention_gqa(q_bits, k_bits, vt_bits,
                                        self._theta_int(params),
                                        d_h=self.head_dim,
                                        causal=self.causal)
        out = self._output_deploy(params, ctx)
        cache = (self._ring_cache(k_bits, vt_bits, s, cache_size)
                 if cache_size else None)
        return out, cache

    @staticmethod
    def _ring_cache(k_bits: torch.Tensor, vt_bits: torch.Tensor, s: int,
                    w: int) -> KVCache:
        """The last min(s, W) tokens at ring slots t % W; empty slots 0."""
        dev = k_bits.device
        b = k_bits.shape[0]
        t = s - w + torch.arange(w, device=dev)         # token per entry
        valid = t >= 0
        tc = t.clamp(0, max(s - 1, 0))
        slots = torch.remainder(t, w)                   # a permutation
        kc = torch.zeros(k_bits.shape[:2] + (w, k_bits.shape[-1]),
                         dtype=torch.int32, device=dev)
        kc[:, :, slots] = k_bits[:, :, tc] * valid[None, None, :, None]
        v_seq = packing.unpack_bits(vt_bits, s)          # (B,Hkv,dh,S)
        v_ring = torch.zeros(v_seq.shape[:3] + (w,), dtype=torch.int32,
                             device=dev)
        v_ring[..., slots] = v_seq[..., tc] * valid
        length = torch.full((b,), s, dtype=torch.int32, device=dev)
        return KVCache(kc, packing.pack_bits(v_ring), length)

    # -- decode ---------------------------------------------------------------

    def init_cache(self, batch: int, max_len: int, device) -> KVCache:
        hkv, dh = self.num_kv_heads, self.head_dim
        return KVCache(
            torch.zeros((batch, hkv, max_len, packing.packed_len(dh)),
                        dtype=torch.int32, device=device),
            torch.zeros((batch, hkv, dh, packing.packed_len(max_len)),
                        dtype=torch.int32, device=device),
            torch.zeros((batch,), dtype=torch.int32, device=device))

    def _attend_cache(self, params: Params, q_bits: torch.Tensor,
                      kc: torch.Tensor, vc: torch.Tensor,
                      valid: torch.Tensor) -> torch.Tensor:
        """One query token per sequence (B,H,1,dhp) against the packed
        K (B,Hkv,W,dhp) / V^T (B,Hkv,dh,W/32) ring; ``valid`` (B, W)."""
        b = q_bits.shape[0]
        h, hkv, dh, g = (self.num_heads, self.num_kv_heads, self.head_dim,
                         self.groups)
        w = kc.shape[2]
        # each KV head scores its G query heads as the rows of one RBMM
        qg = q_bits.reshape(b, hkv, g, q_bits.shape[-1])
        c = rbmm.rbmm_int(qg, kc, dh, scheme="xnor",
                          impl=self._score_impl()).reshape(b, h, 1, w)
        th = self._theta_int(params)[None, :, None, None]
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
        advances from its own ``cache.length``.  The ring tensors are
        updated IN PLACE (the JAX package returns new arrays); the
        returned cache shares them and carries the new lengths."""
        b = x.shape[0]
        w = cache.k_bits.shape[2]
        pos = cache.length.to(torch.int32)
        q_bits, k_new, v = self._project_qkv_deploy(params, x,
                                                    pos[:, None])
        bar = torch.arange(b, device=x.device)
        slot = torch.remainder(pos, w).long()
        cache.k_bits[bar, :, slot] = k_new[:, :, 0]
        # V^T ring update: set bit (slot % 32) of word (slot // 32)
        word = slot // packing.WORD
        mask = packing.bit_mask(slot % packing.WORD)[:, None, None]
        v_bit = (v[:, 0].to(torch.float32) >=
                 params["v_beta"][:, None]).to(torch.int32)  # (B,Hkv,dh)
        old = cache.vt_bits[bar, :, :, word]
        cache.vt_bits[bar, :, :, word] = (old & ~mask) | (v_bit * mask)
        valid = torch.arange(w, device=x.device)[None, :] <= pos[:, None]
        out = self._attend_cache(params, q_bits, cache.k_bits,
                                 cache.vt_bits, valid)
        return out, KVCache(cache.k_bits, cache.vt_bits, pos + 1)
