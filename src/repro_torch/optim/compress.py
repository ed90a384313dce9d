"""1-bit gradient compression with error feedback (port of
``repro.optim.compress``): sign(g + e) times the per-tensor mean |g + e| (per tensor of the JAX
package's tree: a stacked leaf's scale spans all its layers),
1/32 of float32's bytes on the wire, with the error-feedback accumulator
e keeping the optimizer convergent (Seide et al. 2014, Bernstein et al.
2018).  ``Trainer`` applies it to the gradients before the optimizer
(``compress_grads``), the numerical simulation of the JAX package's plain
path; on a mesh the gradients are shards and each scale's sum of |g + e|
runs over every rank's blocks (``sharded_scales``).

``allreduce_1bit`` is the explicit collective: each rank packs the sign
bits of its local gradient with the pack kernel (``pack_threshold`` at
threshold 0: the hand-written CUDA kernel on the card, its plain version
on the CPU), all-gathers the packed words and the scales (n/32 words a
rank, where an fp all-reduce moves n floats), unpacks and averages.  The
trainer does not call it: its reduction is exact, as the JAX package's
``Trainer`` is."""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch import tree
from repro_torch.core import packing
from repro_torch.kernels.pack import ops as pack_ops
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
                  stacked: Sequence[str] = STACKED,
                  scales: Optional[Sequence[torch.Tensor]] = None
                  ) -> Tuple[Params, Params]:
    """``compress`` leaf by leaf of the JAX package's tree: one scale per
    stacked leaf, the mean |g + ef| over all its layers, or
    ``scales[j]`` for ``stacked_groups``' j-th group (a mesh's)."""
    gs, es = tree.leaves(grads), tree.leaves(ef)
    g_hat, new_ef = [None] * len(gs), [None] * len(gs)
    for j, idx in enumerate(stacked_groups(grads, stacked)):
        xs = [gs[i].to(torch.float32) + es[i] for i in idx]
        scale = (torch.cat([x.reshape(-1) for x in xs]).abs().mean()
                 if scales is None else scales[j])
        for i, x in zip(idx, xs):
            hat = torch.where(x >= 0, scale, -scale)
            g_hat[i], new_ef[i] = hat.to(gs[i].dtype), x - hat
    return tree.unflatten(grads, g_hat), tree.unflatten(grads, new_ef)


def init_error_feedback(params: Params) -> Params:
    return tree.map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def sharded_scales(grads: Params, ef: Params, stacked: Sequence[str],
                   owned: Sequence[bool], numels: Sequence[int],
                   all_reduce: Callable[[torch.Tensor], torch.Tensor]
                   ) -> List[torch.Tensor]:
    """``compress_tree``'s scales when ``grads`` and ``ef`` are this rank's
    shards: per group, the sum of |g + ef| over the leaves this rank
    counts for the mesh (``owned``: a replica counts once), summed over
    every rank by ``all_reduce`` (in place), over the group's whole
    leaves' elements (``numels``)."""
    gs, es = tree.leaves(grads), tree.leaves(ef)
    groups = stacked_groups(grads, stacked)
    sums = torch.zeros(len(groups), dtype=torch.float32,
                       device=gs[0].device)
    for j, idx in enumerate(groups):
        for i in idx:
            if owned[i]:
                sums[j] += (gs[i].to(torch.float32) + es[i]).abs().sum()
    sums = all_reduce(sums)
    return [sums[j] / sum(numels[i] for i in idx)
            for j, idx in enumerate(groups)]


def sign_words(flat: torch.Tensor) -> torch.Tensor:
    """(n,) -> (ceil(n/32),) int32 words of the bits (x >= 0), LSB-first:
    the pack kernel at threshold 0 on the float32 row (1, n)."""
    x = flat.to(torch.float32).reshape(1, -1)
    theta = torch.zeros((), dtype=torch.float32, device=x.device)
    return pack_ops.pack_threshold(x, theta)[0]


def allreduce_1bit(g_local: torch.Tensor, group=None) -> torch.Tensor:
    """The explicit 1-bit all-reduce over the ranks of ``group`` (a
    torch.distributed group; None: the world): pack the local sign bits,
    all-gather the packed words and the scales, unpack and average.
    ``g_local``: this rank's gradient, any shape; every rank gets the
    mean over ranks of sign(g) * mean |g| (sign(0) = +1)."""
    shape = g_local.shape
    flat = g_local.reshape(-1)
    scale = flat.abs().mean().reshape(1)
    bits = sign_words(flat)
    n = dist.get_world_size(group)
    all_bits = [torch.empty_like(bits) for _ in range(n)]
    all_scale = [torch.empty_like(scale) for _ in range(n)]
    dist.all_gather(all_bits, bits, group=group)
    dist.all_gather(all_scale, scale, group=group)
    vals = packing.unpack_bits(torch.stack(all_bits), flat.numel())
    signs = (2 * vals - 1).to(torch.float32)
    avg = (signs * torch.cat(all_scale)[:, None]).sum(0) / n
    return avg.reshape(shape)
