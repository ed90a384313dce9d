"""1-bit gradient compression with error feedback (port of
``repro.optim.compress``): sign(g + e) times the per-tensor mean |g + e| (per tensor of the JAX
package's tree: a stacked leaf's scale spans all its layers),
1/32 of float32's bytes on the wire, with the error-feedback accumulator
e keeping the optimizer convergent (Seide et al. 2014, Bernstein et al.
2018).  ``Trainer`` applies it to the gradients before the optimizer
(``compress_grads``), the numerical simulation of the JAX package's plain
path.  The explicit collective (``allreduce_1bit``) is not ported yet: it
comes with the torch.distributed work."""
from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple

import torch

from repro_torch import tree
from repro_torch.optim.adamw import STACKED

Params = Any


def compress(g: torch.Tensor, ef: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One tensor: (g_hat, new_ef), g_hat = scale * sign(g + ef)."""
    x = g.to(torch.float32) + ef
    scale = x.abs().mean()
    g_hat = torch.where(x >= 0, scale, -scale)
    return g_hat.to(g.dtype), x - g_hat


def stacked_groups(grads: Params, stacked: Sequence[str] = STACKED
                   ) -> List[List[int]]:
    """Leaf indices (flattening order) grouped as the JAX package's leaves:
    the per-layer leaves at one path under a stacked key are one JAX
    leaf with a leading layer axis; every other leaf is its own."""
    groups: Dict[str, List[int]] = {}
    for i, (path, _) in enumerate(tree.leaves_with_paths(grads)):
        parts = path.split("/")
        if len(parts) > 1 and parts[0] in stacked and parts[1].isdigit():
            path = "/".join([parts[0]] + parts[2:])
        groups.setdefault(path, []).append(i)
    return list(groups.values())


def compress_tree(grads: Params, ef: Params,
                  stacked: Sequence[str] = STACKED
                  ) -> Tuple[Params, Params]:
    """``compress`` leaf by leaf of the JAX package's tree: one scale per
    stacked leaf, the mean |g + ef| over all its layers."""
    gs, es = tree.leaves(grads), tree.leaves(ef)
    g_hat, new_ef = [None] * len(gs), [None] * len(gs)
    for idx in stacked_groups(grads, stacked):
        xs = [gs[i].to(torch.float32) + es[i] for i in idx]
        scale = torch.cat([x.reshape(-1) for x in xs]).abs().mean()
        for i, x in zip(idx, xs):
            hat = torch.where(x >= 0, scale, -scale)
            g_hat[i], new_ef[i] = hat.to(gs[i].dtype), x - hat
    return tree.unflatten(grads, g_hat), tree.unflatten(grads, new_ef)


def init_error_feedback(params: Params) -> Params:
    return tree.map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)
