"""Parameters of the JAX package -> parameters of the port.

``from_jax_params`` takes a parameter tree of the JAX package — its QAT
tree or its ``convert()``-ed deploy tree, of a model or of one module — as
nested dicts and lists of
numpy arrays (the caller converts, e.g. with ``jax.tree.map(np.asarray,
...)``; this module never imports JAX) and returns the port's tree:

  * every array becomes a tensor on ``device``;
  * ``uint32`` packed words become ``int32`` tensors with the same bits,
    bfloat16 arrays bfloat16 tensors;
  * the stacked layer subtrees, ``blocks`` and an encoder-decoder's
    ``encoder`` and ``decoder`` (leading layer axis, as the JAX package
    keeps a uniform stack for ``scan``: hymba's hybrid layers, seamless'
    encoder and decoder) become lists of per-layer dicts under the same
    keys; a list (a stack of mixed kinds, as xlstm's mLSTM and sLSTM
    layers) stays one, layer by layer.

The same holds for any tree of the params' structure: gradients, AdamW
moments, error feedback.  ``from_jax_train_state`` carries a whole JAX
``TrainState`` (params, opt = (step, mu, nu), ef) into the port's.

``deploy_from_jax`` takes a JAX QAT tree (numpy, e.g. memory-mapped from
disk) to the port's deploy params layer by layer, so a full-depth model
reaches the card holding at most one layer's float32 masters there.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.optim.adamw import AdamWState
from repro_torch.train.trainer import TrainState


def _tensor(a: Any, dev: torch.device) -> torch.Tensor:
    a = np.array(a, copy=True)          # C-contiguous, keeps 0-d shape
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    if a.dtype.name == "bfloat16":      # ml_dtypes' bfloat16 (moments)
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(
            dev)
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


STACKS = ("blocks", "encoder", "decoder")   # the layer subtrees


def from_jax_params(tree: dict, device="cuda") -> dict:
    """Nested numpy tree of the JAX package (a model's, or one module's)
    -> the port's param tree on ``device``."""
    dev = resolve_device(device)
    out = _convert({k: v for k, v in tree.items() if k not in STACKS}, dev)
    for key in STACKS:
        if key not in tree:
            continue
        layers = tree[key]
        if isinstance(layers, dict):    # stacked for scan: split by layer
            layers = [_layer(layers, i)
                      for i in range(_num_layers(layers))]
        out[key] = [_convert(b, dev) for b in layers]
    return out


def deploy_from_jax(model: Any, tree: dict, device="cuda") -> dict:
    """A JAX QAT param tree of ``model`` (nested numpy arrays; memory-mapped
    ones are read a slice at a time) -> the port's deploy params on
    ``device``, equal to ``model.convert(from_jax_params(tree))``: the
    embedding, head and frontend are carried as they are; each layer of
    ``blocks``, ``encoder`` and ``decoder`` (split as ``from_jax_params``
    splits them) is carried to ``device`` one part at a time, converted
    and freed, an expert stack one expert at a time."""
    dev = resolve_device(device)

    def load(t: Any) -> Any:
        return _convert(t, dev)

    out = load({k: v for k, v in tree.items() if k not in STACKS})
    for key, blocks in model.layer_blocks().items():
        layers = tree[key]
        if isinstance(layers, dict):    # stacked for scan: split by layer
            layers = [_layer(layers, i)
                      for i in range(_num_layers(layers))]
        out[key] = [blk.convert(lp, load)
                    for blk, lp in zip(blocks, layers)]
    return out


def from_jax_train_state(state: Any, device="cuda") -> TrainState:
    """A JAX ``TrainState`` with numpy leaves (``jax.tree.map(np.asarray,
    state)`` keeps its NamedTuples) -> the port's ``TrainState``: params,
    moments and error feedback on ``device``, the step on the host (where
    the port's AdamW keeps it)."""
    conv = lambda t: None if t is None else from_jax_params(t, device)
    step = torch.tensor(int(np.asarray(state.opt.step)), dtype=torch.int32)
    return TrainState(conv(state.params),
                      AdamWState(step, conv(state.opt.mu),
                                 conv(state.opt.nu)), conv(state.ef))
