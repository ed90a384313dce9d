"""Public wrapper for the pack kernel — the data-packing conversion unit.

Contract (the TPU kernel's, generalised to a broadcast threshold):
``pack_threshold(x (..., K), theta)`` returns ``(..., ceil(K/32))`` int32
words with bit i of word w set iff ``x[..., 32*w + i] >= theta[...]``,
pad bits 0.  ``theta`` broadcasts against ``x``: ``(K,)`` is the TPU
kernel's per-column threshold, a 0-d tensor one threshold for all, and
``(H, 1)`` against ``(..., H, d_h)`` a per-head threshold.  ``x`` is
bfloat16, float32 or int32 with up to 4 dims and any strides; ``theta`` is
float32 for a float ``x`` (the comparison runs in float32) and int32 for
an int32 ``x``.

Dispatch: CUDA tensors launch ``csrc/pack.cu``; CPU tensors take
``ref.pack_threshold``; meta tensors the shape-only route
(``kernels.use_kernel``).  ``pack_threshold.launches`` counts kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch import census, kernels
from repro_torch.kernels import work
from repro_torch.core import packing
from repro_torch.kernels.pack import ref

_DTYPES = {torch.bfloat16: (0, torch.float32),
           torch.float32: (1, torch.float32),
           torch.int32: (2, torch.int32)}
_ARGTYPES = ([kernels.PTR, kernels.INT, kernels.PTR] + [kernels.I64] * 12 +
             [kernels.PTR])


def _check(x: torch.Tensor, theta: torch.Tensor) -> int:
    if x.dtype not in _DTYPES:
        raise TypeError(f"pack_threshold takes bfloat16, float32 or int32 "
                        f"x, got {x.dtype}")
    code, theta_dtype = _DTYPES[x.dtype]
    if theta.dtype != theta_dtype:
        raise TypeError(f"pack_threshold: theta for {x.dtype} x must be "
                        f"{theta_dtype}, got {theta.dtype}")
    if not 1 <= x.dim() <= 4 or x.shape[-1] == 0:
        raise ValueError(f"pack_threshold takes 1-4 dims with K > 0, got "
                         f"shape {tuple(x.shape)}")
    try:
        fits = torch.broadcast_shapes(theta.shape, x.shape) == x.shape
    except RuntimeError:
        fits = False
    if not fits:
        raise ValueError(f"theta {tuple(theta.shape)} does not broadcast "
                         f"to x {tuple(x.shape)}")
    return code


def pack_threshold(x: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    code = _check(x, theta)
    on = kernels.use_kernel(x, theta)
    if on == "cpu":
        return ref.pack_threshold(x, theta)
    out = torch.empty(x.shape[:-1] + (packing.packed_len(x.shape[-1]),),
                      dtype=torch.int32, device=x.device)
    if on == "meta":
        census.kernel("pack_threshold", work.pack(x, theta, out))
        return out
    pad = 4 - x.dim()
    shape = (1,) * pad + tuple(x.shape)
    xs = (0,) * pad + tuple(x.stride())
    ts = (0,) * pad + tuple(theta.expand(x.shape).stride())
    kernels.launch("cobra_pack_threshold", _ARGTYPES, x.device,
                   x.data_ptr(), code, theta.data_ptr(), *shape, *xs, *ts,
                   out.data_ptr())
    pack_threshold.launches += 1
    return out


pack_threshold.launches = 0
