"""Parameters of the JAX package -> parameters of the port.

``from_jax_params`` takes a parameter tree of the JAX package — its QAT
tree or its ``convert()``-ed deploy tree, of a model or of one module — as
nested dicts and lists of
numpy arrays (the caller converts, e.g. with ``jax.tree.map(np.asarray,
...)``; this module never imports JAX) and returns the port's tree:

  * every array becomes a tensor on ``device``;
  * ``uint32`` packed words become ``int32`` tensors with the same bits;
  * the stacked ``blocks`` subtree (leading layer axis, as the JAX package
    keeps it for ``scan``) becomes a list of per-layer dicts.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch import resolve_device


def _tensor(a: Any, dev: torch.device) -> torch.Tensor:
    a = np.array(a, copy=True)          # C-contiguous, keeps 0-d shape
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a).to(dev)


def _convert(tree: Any, dev: torch.device) -> Any:
    if isinstance(tree, dict):
        return {k: _convert(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_convert(v, dev) for v in tree]
    return _tensor(tree, dev)


def _layer(tree: Any, i: int) -> Any:
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


def _num_layers(tree: Any) -> int:
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return np.asarray(tree).shape[0]


def from_jax_params(tree: dict, device="cuda") -> dict:
    """Nested numpy tree of the JAX package (a model's, or one module's)
    -> the port's param tree on ``device``."""
    dev = resolve_device(device)
    out = _convert({k: v for k, v in tree.items() if k != "blocks"}, dev)
    if "blocks" in tree:
        blocks = tree["blocks"]
        if isinstance(blocks, dict):    # stacked for scan: split by layer
            blocks = [_layer(blocks, i)
                      for i in range(_num_layers(blocks))]
        out["blocks"] = [_convert(b, dev) for b in blocks]
    return out
