"""AdamW with a configurable moment dtype (port of ``repro.optim.adamw``).

``init`` and ``update`` are functions of trees (``repro_torch.tree``), as
in the JAX package: ``update`` returns new params and a new state and
changes none of its arguments.  The element-wise arithmetic is the JAX
package's, op by op in float32 (each product and sum rounded where the
JAX expression rounds it), run as multi-tensor ``torch._foreach_*`` ops
so a step costs a few launches per op, not one per leaf.

Two differences of layout, none of value:
  * ``AdamWState.step`` is a 0-d int32 tensor on the host (the JAX
    package keeps it on the device): the learning rate and the bias
    corrections 1 - b^step are computed from it in float32 on the host,
    so a step reads nothing back from the card but the grad norm's
    scale, which stays on the device.
  * The port keeps a stacked layer subtree (``blocks``) as a list of
    per-layer trees, where the JAX package's leaves carry a leading
    layer axis.  Weight decay applies to the leaves whose JAX counterpart
    has ndim >= 2 (JAX's rule), so a per-layer leaf under a stacked key
    decays when its own ndim + 1 >= 2: norm scales, per-head scales and
    lambdas, ``alpha_w`` decay; the per-layer scalar scales do not.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, NamedTuple, Optional, \
    Sequence, Tuple

import torch

from repro_torch import tree

Params = Any

STACKED = ("blocks",)   # the port's lists of layers that JAX stacks


class AdamWState(NamedTuple):
    step: torch.Tensor      # () int32, on the host
    mu: Params
    nu: Params


def _f32(v) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32)


def decayed(params: Params, stacked: Sequence[str] = STACKED) -> List[bool]:
    """Per leaf (in flattening order): does the JAX package decay its
    counterpart?  A leaf under ``stacked``'s per-layer lists stands for
    one slice of a JAX leaf with one more axis."""
    out = []
    for path, leaf in tree.leaves_with_paths(params):
        parts = path.split("/")
        extra = int(len(parts) > 1 and parts[0] in stacked and
                    parts[1].isdigit())
        out.append(leaf.dim() + extra >= 2)
    return out


def global_norm(grads: Params) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, float32."""
    gs = [g.to(torch.float32) for g in tree.leaves(grads)]
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(gs)))


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: float = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.01
    grad_clip: float = 1.0
    moment_dtype: torch.dtype = torch.float32
    # step -> multiplier (``repro_torch.optim.schedules``); None = constant
    schedule: Optional[Callable] = None

    def init(self, params: Params) -> AdamWState:
        z = lambda p: torch.zeros(p.shape, dtype=self.moment_dtype,
                                  device=p.device)
        return AdamWState(torch.zeros((), dtype=torch.int32),
                          tree.map(z, params), tree.map(z, params))

    def scalars(self, step: int) -> Tuple[float, float, float]:
        """(lr, 1 - b1^step, 1 - b2^step) at ``step`` (counted from 1), in
        float32 as the JAX package computes them."""
        s = _f32(step)
        mult = self.schedule(step) if self.schedule else _f32(1.0)
        lr = self.lr * mult
        c1 = 1.0 - torch.pow(_f32(self.b1), s)
        c2 = 1.0 - torch.pow(_f32(self.b2), s)
        return lr.item(), c1.item(), c2.item()

    def update(self, grads: Params, state: AdamWState, params: Params, *,
               stacked: Sequence[str] = STACKED, scalars=None
               ) -> Tuple[Params, AdamWState, Dict[str, torch.Tensor]]:
        """One step: clip by the global norm, moments, bias correction,
        decoupled decay of the leaves ``decayed`` marks.  ``stacked``
        names the per-layer lists of a uniform stack (the JAX package
        keeps a mixed stack, xlstm's, as a list too: pass ()).
        ``scalars`` (lr, c1, c2), 0-d float32 device tensors, replace
        ``self.scalars(step)``: a captured step reads them at replay."""
        step = state.step + 1
        lr, c1, c2 = scalars or self.scalars(int(step))
        b1, b2 = self.b1, self.b2
        ps, gs = tree.leaves(params), tree.leaves(grads)
        gnorm = global_norm(grads)
        g = [x.to(torch.float32) for x in gs]
        if self.grad_clip:
            scale = torch.clamp(self.grad_clip / gnorm.clamp_min(1e-9),
                                max=1.0)
            g = torch._foreach_mul(g, scale)
        mu = [m.to(torch.float32) for m in tree.leaves(state.mu)]
        nu = [n.to(torch.float32) for n in tree.leaves(state.nu)]
        mu = torch._foreach_add(torch._foreach_mul(mu, b1),
                                torch._foreach_mul(g, 1 - b1))
        nu = torch._foreach_add(
            torch._foreach_mul(nu, b2),
            torch._foreach_mul(torch._foreach_mul(g, 1 - b2), g))
        delta = list(torch._foreach_div(
            torch._foreach_div(mu, c1),
            torch._foreach_add(torch._foreach_sqrt(
                torch._foreach_div(nu, c2)), self.eps)))
        if self.weight_decay:
            idx = [i for i, d in enumerate(decayed(params, stacked)) if d]
            if idx:
                decay = torch._foreach_mul(
                    [ps[i].to(torch.float32) for i in idx],
                    self.weight_decay)
                for i, v in zip(idx, torch._foreach_add(
                        [delta[i] for i in idx], decay)):
                    delta[i] = v
        new_p = torch._foreach_sub([p.to(torch.float32) for p in ps],
                                   torch._foreach_mul(delta, lr))
        new_p = [v.to(p.dtype) for v, p in zip(new_p, ps)]
        md = self.moment_dtype
        new_state = AdamWState(step, tree.unflatten(params, [
            m.to(md) for m in mu]), tree.unflatten(params, [
                n.to(md) for n in nu]))
        metrics = {"grad_norm": gnorm, "lr": torch.as_tensor(
            lr, dtype=torch.float32, device=gnorm.device)}
        return tree.unflatten(params, new_p), new_state, metrics
