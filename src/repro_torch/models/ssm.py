"""Recurrent blocks (port of ``repro.models.ssm``): Mamba (hymba's
parallel branch) and the xLSTM cells (mLSTM, sLSTM), with the QAT face
(``deploy=False``) and the deploy faces.

Every in/out/QKV-like projection is a ``BinaryDense``: its QAT face
(``BinaryDense.apply``) when ``deploy`` is False, else the port's kernels
(``pack_threshold``, then ``rbmm_int`` at decode shapes and ``rbmm_mxu``
at prefill shapes).  The recurrences (the selective scan, the
exponential-gate cells, the depthwise causal conv) stay fp, as they are
``jnp`` outside any Pallas kernel in the JAX package: here they are plain
PyTorch, a Python loop over time whose step body is shared by the
whole-sequence ``apply`` and the one-token ``decode_step`` (the JAX
package's ``lax.scan`` bodies).  The loop writes nothing in place, so
autograd runs through it (the QAT face).

Each block is functional, as in the JAX package: ``apply`` and
``decode_step`` return new carries (``MambaCache``, ``XLSTMCache``);
``Block`` (``models/blocks.py``) copies them into the caches it was given,
in place.  ``seq_lens`` (B,) freezes each sequence's carry past its true
length (a masked scan), so a right-padded ragged batch, a resumed chunk
(``state=``) and an inactive pool row (length 0) keep exact carries.
Where the JAX cells write ``jnp.maximum`` of a value that can tie with
its bound (the sLSTM's normalizer is exactly 1 after its first step),
the port writes ``torch.maximum``, whose gradient splits a tie in half as
JAX's does (``torch.clamp`` would pass all of it).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch import census
from repro_torch.models import nn
from repro_torch.models.linear import BinaryDense
from repro_torch.models.sharding import P

Params = Dict[str, Any]


class MambaCache(NamedTuple):
    conv: torch.Tensor   # (B, d_inner, conv_width-1) rolling conv inputs
    h: torch.Tensor      # (B, d_inner, state) SSM state


class XLSTMCache(NamedTuple):
    c: torch.Tensor      # mLSTM: (B, H, dv, dk) matrix cell | sLSTM: (B, di)
    n: torch.Tensor      # normalizer: (B, H, dk) | (B, d_inner)
    m: torch.Tensor      # max-gate stabilizer: (B, H) | (B, d_inner)


def _proj(dense: BinaryDense, p: Params, x: torch.Tensor,
          deploy: bool) -> torch.Tensor:
    return dense.apply_deploy(p, x) if deploy else dense.apply(p, x)


def _live_mask(batch: int, length: int, seq_lens: Optional[torch.Tensor],
               device) -> Optional[torch.Tensor]:
    """(B, L) bool: True at real positions, False at right-padding; None
    when every position is real (no freeze needed)."""
    if seq_lens is None:
        return None
    sl = torch.as_tensor(seq_lens, device=device).to(torch.int64)
    return torch.arange(length, device=device)[None, :] < sl[:, None]


def _freeze_cache(new: Sequence[torch.Tensor], old: Sequence[torch.Tensor],
                  live_t: Optional[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
    """Per-sequence carry freeze for masked scans: sequences whose
    ``live_t`` (B,) is False keep their old carry, bit for bit."""
    if live_t is None:
        return tuple(new)
    return tuple(torch.where(live_t.reshape((-1,) + (1,) * (n.dim() - 1)),
                             n, o) for n, o in zip(new, old))


def _scan_cells(cell: Callable, carry: XLSTMCache,
                seqs: Sequence[torch.Tensor], live: Optional[torch.Tensor]
                ) -> Tuple[XLSTMCache, torch.Tensor]:
    """Run an xLSTM ``cell`` over batch-major inputs (B, L, ...), one step
    per position.  ``apply`` and ``decode_step`` (the L = 1 case) both go
    through this one step body, as the JAX package's do through its one
    ``lax.scan``.  Returns (last carry, outputs (L, B, ...)).  A dry run's
    census may run fewer steps (``census.steps``): the outputs keep
    their L steps."""
    n = seqs[0].shape[1]
    hs = []
    for t in census.steps(n):
        new, h = cell(carry, tuple(s[:, t] for s in seqs))
        carry = XLSTMCache(*_freeze_cache(
            new, carry, None if live is None else live[:, t]))
        hs.append(h)
    return carry, torch.stack(census.pad_steps(hs, n), 0)


def _log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """-softplus(-x), as the JAX cells write it."""
    return -F.softplus(-x)


# ---------------------------------------------------------------------------
# Mamba
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MambaBlock:
    d_model: int
    state_size: int = 16
    conv_width: int = 4
    expand: int = 2
    dt_rank: int = 0                # 0 => ceil(d_model / 16)
    dtype: torch.dtype = torch.float32

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def rank(self) -> int:
        return self.dt_rank or -(-self.d_model // 16)

    def _in_proj(self) -> BinaryDense:
        return BinaryDense(self.d_model, 2 * self.d_inner, dtype=self.dtype,
                           partition="col")

    def _out_proj(self) -> BinaryDense:
        return BinaryDense(self.d_inner, self.d_model, dtype=self.dtype,
                           partition="row")

    def specs(self) -> Params:
        """The QAT params' specs (the JAX package's)."""
        return self._specs(BinaryDense.specs)

    def deploy_specs(self) -> Params:
        """The deploy params' specs (JAX's ``specs(deploy=True)``)."""
        return self._specs(BinaryDense.deploy_specs)

    def _specs(self, dense_specs) -> Params:
        return {"in_proj": dense_specs(self._in_proj()),
                "out_proj": dense_specs(self._out_proj()),
                "conv_w": P(None, "model"), "conv_b": P("model"),
                "x_proj": P("model", None), "dt_proj": P(None, "model"),
                "dt_bias": P("model"), "a_log": P("model", None),
                "d_skip": P("model")}

    def init(self, gen: torch.Generator, device) -> Params:
        di, st = self.d_inner, self.state_size
        a_init = torch.arange(1, st + 1, dtype=torch.float32,
                              device=device)[None].repeat(di, 1)
        return {
            "in_proj": self._in_proj().init(gen, device),
            "out_proj": self._out_proj().init(gen, device),
            "conv_w": nn.truncated_normal(gen, (self.conv_width, di),
                                          0.5 / self.conv_width, device),
            "conv_b": torch.zeros(di, device=device),
            # fp selective-parameter projection: d_inner -> r + 2 * state
            "x_proj": nn.truncated_normal(gen, (di, self.rank + 2 * st),
                                          di ** -0.5, device),
            "dt_proj": nn.truncated_normal(gen, (self.rank, di),
                                           self.rank ** -0.5, device),
            "dt_bias": torch.full((di,), -4.0, device=device),
            "a_log": torch.log(a_init),
            "d_skip": torch.ones(di, device=device),
        }

    def init_deploy(self, gen: torch.Generator, device) -> Params:
        """``convert(init(gen, device))``: one layer's masters at most."""
        return self.convert(self.init(gen, device))

    def convert(self, params: Params) -> Params:
        d = dict(params)
        d["in_proj"] = self._in_proj().convert(params["in_proj"])
        d["out_proj"] = self._out_proj().convert(params["out_proj"])
        return d

    # -- selective scan ------------------------------------------------------

    def _ssm_params(self, params: Params, u: torch.Tensor):
        """u (..., di) conv output -> (dt, b, c) selective params."""
        xp = u.to(torch.float32) @ params["x_proj"]
        dt, b, c = torch.split(xp, [self.rank, self.state_size,
                                    self.state_size], dim=-1)
        dt = F.softplus(dt @ params["dt_proj"] + params["dt_bias"])
        return dt, b, c                  # (..., di), (..., st), (..., st)

    def _scan(self, params: Params, u: torch.Tensor, h0: torch.Tensor,
              seq_lens: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """u (B, L, di): the sequential selective scan, one step per
        position (``decode_step`` is its L = 1 case).  Returns (y (B, L,
        di), h_last (B, di, st)).  ``seq_lens`` (B,) freezes each
        sequence's state past its true length; pad positions' outputs
        are garbage the caller ignores."""
        a = -torch.exp(params["a_log"])                      # (di, st)
        dt, b, c = self._ssm_params(params, u)
        uf = u.to(torch.float32)
        live = _live_mask(u.shape[0], u.shape[1], seq_lens, u.device)
        h, ys, n = h0, [], u.shape[1]
        for t in census.steps(n):     # all n but in a dry run's census
            dt_t = dt[:, t, :, None]                         # (B, di, 1)
            da = torch.exp(dt_t * a[None])                   # (B, di, st)
            dbu = dt_t * b[:, t, None, :] * uf[:, t, :, None]
            h_new = da * h + dbu
            h = h_new if live is None else torch.where(
                live[:, t, None, None], h_new, h)
            ys.append(torch.einsum("bds,bs->bd", h, c[:, t]))
        y = torch.stack(census.pad_steps(ys, n), 1) + uf * params["d_skip"]
        return y, h

    def _conv(self, params: Params, u_p: torch.Tensor,
              length: int) -> torch.Tensor:
        """Depthwise causal conv over time: u_p (B, length + width - 1,
        di) -> silu of the left-to-right tap sum (B, length, di), in the
        JAX package's order."""
        w = params["conv_w"]
        acc = u_p[:, 0:length] * w[0]
        for i in range(1, self.conv_width):
            acc = acc + u_p[:, i:i + length] * w[i]
        return F.silu(acc + params["conv_b"])

    # -- faces ----------------------------------------------------------------

    def apply(self, params: Params, x: torch.Tensor, *, deploy: bool = False,
              return_state: bool = False,
              seq_lens: Optional[torch.Tensor] = None,
              state: Optional[MambaCache] = None):
        """x (B, L, d) -> (B, L, d) [, MambaCache to continue from].

        ``seq_lens`` (B,) takes a right-padded ragged batch: the state
        freezes at each sequence's true length and the conv cache is read
        there.  ``state`` resumes a prior chunk: the conv window starts
        from ``state.conv`` and the scan from ``state.h``, so a prompt in
        chunks gives the outputs and final state of one whole call."""
        b, length, _ = x.shape
        di, pad = self.d_inner, self.conv_width - 1
        xz = _proj(self._in_proj(), params["in_proj"], x, deploy)
        u, z = torch.chunk(xz, 2, dim=-1)
        if state is None:
            u_p = F.pad(u, (0, 0, pad, 0))
            h0 = torch.zeros((b, di, self.state_size), dtype=torch.float32,
                             device=x.device)
        else:
            u_p = torch.cat([state.conv.transpose(1, 2).to(u.dtype), u],
                            dim=1)
            h0 = state.h
        y, h_last = self._scan(params, self._conv(params, u_p, length), h0,
                               seq_lens=seq_lens)
        y = y * F.silu(z)
        out = _proj(self._out_proj(), params["out_proj"], y.to(self.dtype),
                    deploy)
        if not return_state:
            return out
        # the conv cache: the last (width - 1) raw inputs before each
        # sequence's end; u_p[pad + t] holds input t, so with seq_lens the
        # tail is u_p[sl : sl + pad]
        if seq_lens is None:
            tail = u_p[:, u_p.shape[1] - pad:]
        else:
            sl = torch.as_tensor(seq_lens, device=x.device).to(torch.int64)
            idx = (sl[:, None] + torch.arange(pad, device=x.device)[None]
                   ).clamp(0, u_p.shape[1] - 1)
            tail = torch.gather(u_p, 1, idx[..., None].expand(-1, -1, di))
        return out, MambaCache(tail.transpose(1, 2).to(torch.float32),
                               h_last)

    def init_values(self) -> Tuple[float, float]:
        """Each carry field's value at ``init_cache``."""
        return (0.0, 0.0)

    def init_cache(self, batch: int, device) -> MambaCache:
        shapes = ((batch, self.d_inner, self.conv_width - 1),
                  (batch, self.d_inner, self.state_size))
        return MambaCache(*[torch.full(s, v, dtype=torch.float32,
                                       device=device)
                            for s, v in zip(shapes, self.init_values())])

    def decode_step(self, params: Params, x: torch.Tensor,
                    cache: MambaCache, *, deploy: bool = True
                    ) -> Tuple[torch.Tensor, MambaCache]:
        """x (B, 1, d) -> (B, 1, d) and the next carry: the conv history
        shifts by one input, the state takes one step of ``_scan``."""
        xz = _proj(self._in_proj(), params["in_proj"], x, deploy)
        u, z = torch.chunk(xz[:, 0], 2, dim=-1)              # (B, di)
        hist = torch.cat([cache.conv, u.to(torch.float32)[..., None]],
                         dim=-1)
        u_c = self._conv(params, hist.transpose(1, 2), 1)    # (B, 1, di)
        y, h = self._scan(params, u_c, cache.h)
        y = y[:, 0] * F.silu(z)
        out = _proj(self._out_proj(), params["out_proj"],
                    y[:, None].to(self.dtype), deploy)
        return out, MambaCache(hist[..., 1:], h)


# ---------------------------------------------------------------------------
# xLSTM (mLSTM + sLSTM)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MLSTMBlock:
    """Matrix-memory LSTM (xLSTM's mLSTM) with binary q/k/v projections."""
    d_model: int
    num_heads: int
    expand: int = 2
    dtype: torch.dtype = torch.float32

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def dh(self) -> int:
        return self.d_inner // self.num_heads

    def _qkv(self) -> BinaryDense:
        return BinaryDense(self.d_model, 3 * self.d_inner, dtype=self.dtype,
                           partition="col")

    def _out(self) -> BinaryDense:
        return BinaryDense(self.d_inner, self.d_model, dtype=self.dtype,
                           partition="row")

    def specs(self) -> Params:
        """The QAT params' specs (the JAX package's): the gate
        projections are (d, 2H) with small H, replicated."""
        return self._specs(BinaryDense.specs)

    def deploy_specs(self) -> Params:
        """The deploy params' specs (JAX's ``specs(deploy=True)``)."""
        return self._specs(BinaryDense.deploy_specs)

    def _specs(self, dense_specs) -> Params:
        return {"qkv": dense_specs(self._qkv()),
                "out": dense_specs(self._out()),
                "w_gates": P(None, None), "b_gates": P(None)}

    def init(self, gen: torch.Generator, device) -> Params:
        h = self.num_heads
        return {
            "qkv": self._qkv().init(gen, device),
            "out": self._out().init(gen, device),
            # fp gate projections (i, f per head)
            "w_gates": nn.truncated_normal(gen, (self.d_model, 2 * h),
                                           self.d_model ** -0.5, device),
            "b_gates": torch.cat([torch.zeros(h, device=device),
                                  3.0 * torch.ones(h, device=device)]),
        }

    def init_deploy(self, gen: torch.Generator, device) -> Params:
        """``convert(init(gen, device))``: one layer's masters at most."""
        return self.convert(self.init(gen, device))

    def convert(self, params: Params) -> Params:
        return {"qkv": self._qkv().convert(params["qkv"]),
                "out": self._out().convert(params["out"]),
                "w_gates": params["w_gates"], "b_gates": params["b_gates"]}

    def init_values(self) -> Tuple[float, float, float]:
        return (0.0, 0.0, -1e9)

    def init_cache(self, batch: int, device) -> XLSTMCache:
        h, dh = self.num_heads, self.dh
        shapes = ((batch, h, dh, dh), (batch, h, dh), (batch, h))
        return XLSTMCache(*[torch.full(s, v, dtype=torch.float32,
                                       device=device)
                            for s, v in zip(shapes, self.init_values())])

    @staticmethod
    def _cell(carry: XLSTMCache, qkvg) -> Tuple[XLSTMCache, torch.Tensor]:
        q, k, v, ig, fg = qkvg      # (B, H, dh) x3, (B, H), (B, H)
        c, n, m = carry
        log_f = _log_sigmoid(fg)
        m_new = torch.maximum(log_f + m, ig)
        i_ = torch.exp(ig - m_new)
        f_ = torch.exp(log_f + m - m_new)
        c = f_[..., None, None] * c + \
            i_[..., None, None] * v[..., :, None] * k[..., None, :]
        n = f_[..., None] * n + i_[..., None] * k
        qn = torch.einsum("bhk,bhk->bh", n, q)
        denom = torch.maximum(qn.abs(), qn.new_ones(()))
        h_out = torch.einsum("bhvk,bhk->bhv", c, q) / denom[..., None]
        return XLSTMCache(c, n, m_new), h_out

    def _qkv_gates(self, params: Params, x: torch.Tensor, deploy: bool):
        b, length, _ = x.shape
        h, dh = self.num_heads, self.dh
        qkv = _proj(self._qkv(), params["qkv"], x, deploy)
        q, k, v = torch.chunk(qkv, 3, dim=-1)
        shape = (b, length, h, dh)
        q = q.reshape(shape).to(torch.float32)
        k = k.reshape(shape).to(torch.float32) / math.sqrt(dh)
        v = v.reshape(shape).to(torch.float32)
        gates = x.to(torch.float32) @ params["w_gates"] + params["b_gates"]
        ig, fg = torch.chunk(gates, 2, dim=-1)               # (B, L, H)
        return q, k, v, ig, fg

    def apply(self, params: Params, x: torch.Tensor, *, deploy: bool = False,
              return_state: bool = False,
              seq_lens: Optional[torch.Tensor] = None,
              state: Optional[XLSTMCache] = None):
        b, length, _ = x.shape
        seqs = self._qkv_gates(params, x, deploy)
        cache0 = self.init_cache(b, x.device) if state is None else state
        last, hs = _scan_cells(self._cell, cache0, seqs,
                               _live_mask(b, length, seq_lens, x.device))
        hs = hs.transpose(0, 1).reshape(b, length, self.d_inner)
        out = _proj(self._out(), params["out"],
                    hs.contiguous().to(self.dtype), deploy)
        return (out, last) if return_state else out

    def decode_step(self, params: Params, x: torch.Tensor,
                    cache: XLSTMCache, *, deploy: bool = True
                    ) -> Tuple[torch.Tensor, XLSTMCache]:
        b = x.shape[0]
        cache, hs = _scan_cells(self._cell, cache,
                                self._qkv_gates(params, x, deploy), None)
        out = _proj(self._out(), params["out"],
                    hs[0].reshape(b, 1, self.d_inner).to(self.dtype),
                    deploy)
        return out, cache


@dataclasses.dataclass(frozen=True)
class SLSTMBlock:
    """Scalar-memory LSTM (xLSTM's sLSTM) with binary in/out projections."""
    d_model: int
    expand: int = 2
    dtype: torch.dtype = torch.float32

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    def _in(self) -> BinaryDense:
        return BinaryDense(self.d_model, 4 * self.d_inner, dtype=self.dtype,
                           partition="col")

    def _out(self) -> BinaryDense:
        return BinaryDense(self.d_inner, self.d_model, dtype=self.dtype,
                           partition="row")

    def specs(self) -> Params:
        """The QAT params' specs (the JAX package's)."""
        return self._specs(BinaryDense.specs)

    def deploy_specs(self) -> Params:
        """The deploy params' specs (JAX's ``specs(deploy=True)``)."""
        return self._specs(BinaryDense.deploy_specs)

    def _specs(self, dense_specs) -> Params:
        return {"in_proj": dense_specs(self._in()),
                "out_proj": dense_specs(self._out()), "f_bias": P("model")}

    def init(self, gen: torch.Generator, device) -> Params:
        return {"in_proj": self._in().init(gen, device),
                "out_proj": self._out().init(gen, device),
                "f_bias": torch.full((self.d_inner,), 3.0, device=device)}

    def init_deploy(self, gen: torch.Generator, device) -> Params:
        """``convert(init(gen, device))``: one layer's masters at most."""
        return self.convert(self.init(gen, device))

    def convert(self, params: Params) -> Params:
        return {"in_proj": self._in().convert(params["in_proj"]),
                "out_proj": self._out().convert(params["out_proj"]),
                "f_bias": params["f_bias"]}

    def init_values(self) -> Tuple[float, float, float]:
        return (0.0, 1e-6, -1e9)

    def init_cache(self, batch: int, device) -> XLSTMCache:
        return XLSTMCache(*[torch.full((batch, self.d_inner), v,
                                       dtype=torch.float32, device=device)
                            for v in self.init_values()])

    @staticmethod
    def _cell(carry: XLSTMCache, zifo) -> Tuple[XLSTMCache, torch.Tensor]:
        z, ig, fg, og = zifo
        c, n, m = carry
        log_f = _log_sigmoid(fg)
        m_new = torch.maximum(log_f + m, ig)
        i_ = torch.exp(ig - m_new)
        f_ = torch.exp(log_f + m - m_new)
        c = f_ * c + i_ * torch.tanh(z)
        n = f_ * n + i_
        h = torch.sigmoid(og) * c / torch.maximum(n, n.new_ones(()))
        return XLSTMCache(c, n, m_new), h

    def _zifo(self, params: Params, x: torch.Tensor, deploy: bool):
        zi = _proj(self._in(), params["in_proj"], x, deploy)
        z, ig, fg, og = torch.chunk(zi.to(torch.float32), 4, dim=-1)
        return z, ig, fg + params["f_bias"], og

    def apply(self, params: Params, x: torch.Tensor, *, deploy: bool = False,
              return_state: bool = False,
              seq_lens: Optional[torch.Tensor] = None,
              state: Optional[XLSTMCache] = None):
        b, length, _ = x.shape
        seqs = self._zifo(params, x, deploy)
        last, hs = _scan_cells(
            self._cell, self.init_cache(b, x.device) if state is None
            else state, seqs, _live_mask(b, length, seq_lens, x.device))
        out = _proj(self._out(), params["out_proj"],
                    hs.transpose(0, 1).contiguous().to(self.dtype),
                    deploy)
        return (out, last) if return_state else out

    def decode_step(self, params: Params, x: torch.Tensor,
                    cache: XLSTMCache, *, deploy: bool = True
                    ) -> Tuple[torch.Tensor, XLSTMCache]:
        cache, hs = _scan_cells(self._cell, cache,
                                self._zifo(params, x, deploy), None)
        out = _proj(self._out(), params["out_proj"],
                    hs[0][:, None].to(self.dtype), deploy)
        return out, cache
