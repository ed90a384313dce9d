"""Public wrappers for the RBMM kernels (paper Eq. 7 and Eq. 10).

Contract: packed operands ``a (..., M, ceil(K/32))`` and
``b (..., P, ceil(K/32))`` int32 with equal leading dims give the
``(..., M, P)`` int32 product of the underlying value matrices:
``2*popcount(a XNOR b) - (K + 2*pad)`` for the ±1 "xnor" scheme, or
``2*popcount(a AND b) - K + dc`` for the {0,1} "and_dc" scheme, where the
don't-care count ``dc (..., M)`` is derived from ``a`` when not given.
The leading dims let decode attention score one query group against its
KV head's whole ring in one launch.

``rbmm_binary`` is the quantization-fused variant (the TPU kernel's
``rbmm_binary``): the same operands and scores, thresholded in the
epilogue, ``bit = c >= theta``, with ``theta`` int32 broadcastable to
``(..., M, P)`` (the TPU kernel's ``(P,)``, a scalar, a per-row or a full
table), optionally masked causally (``col <= row``), plus the DC RETURN
``(..., M)`` int32, the zeros of each output row.  ``pack_output=False``
returns the TPU kernel's ``(..., M, P)`` {0,1} bits (as int32);
``pack_output=True`` returns them packed, ``(..., M, ceil(P/32))`` int32
words, straight from the epilogue.

Padding contract (both): operands carry exactly ``ceil(k/32)`` words per
row, and the wrappers raise otherwise.

Dispatch: CUDA tensors launch ``csrc/rbmm.cu``; CPU tensors take
``ref.rbmm_int`` / ``ref.rbmm_binary``; meta tensors the shape-only route
(``kernels.use_kernel``).  ``rbmm_int.launches`` and
``rbmm_binary.launches`` count kernel launches.  ``rbmm_int`` has two
kernels, and ``route`` picks one from the shape alone: the decode kernel
at M <= 16 (groups of lanes split each column's words, its tile from
``decode_tile``), the int8 tensor-core kernel above; both count in
``rbmm_int.launches``.
"""
from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import torch

from repro_torch import census, kernels
from repro_torch.kernels import work
from repro_torch.core import packing
from repro_torch.kernels.rbmm import ref

SCHEMES = ("xnor", "and_dc")
_ARGTYPES = ([kernels.PTR] * 3 + [kernels.I64] * 5 + [kernels.INT] * 5 +
             [kernels.PTR])
_TC_ARGTYPES = ([kernels.PTR] * 3 + [kernels.I64] * 5 +
                [kernels.INT] * 2 + [kernels.PTR])
_BINARY_ARGTYPES = ([kernels.PTR] * 4 + [kernels.I64] * 8 +
                    [kernels.INT] * 3 + [kernels.PTR] * 2)


def _check(a, b, k, scheme, dc, name="rbmm_int") -> None:
    if scheme not in SCHEMES:
        raise ValueError(f"scheme must be one of {SCHEMES}, got {scheme!r}")
    if a.dtype != torch.int32 or b.dtype != torch.int32:
        raise TypeError(f"{name} takes int32 words, got {a.dtype} and "
                        f"{b.dtype}")
    if a.dim() < 2 or a.shape[:-2] != b.shape[:-2]:
        raise ValueError(f"{name} needs (..., M, Kp) and (..., P, Kp) "
                         f"with equal leading dims, got {tuple(a.shape)} "
                         f"and {tuple(b.shape)}")
    kp = packing.packed_len(k)
    if a.shape[-1] != kp or b.shape[-1] != kp:
        raise ValueError(f"{name}: operands must carry ceil(k/32)={kp} "
                         f"words for k={k}, got {a.shape[-1]} and "
                         f"{b.shape[-1]}")
    if dc is not None and (dc.dtype != torch.int32 or
                           dc.shape != a.shape[:-1]):
        raise ValueError(f"dc must be int32 of shape {tuple(a.shape[:-1])},"
                         f" got {dc.dtype} {tuple(dc.shape)}")


ROUTES = ("scalar", "tc")
# the tensor-core kernel's tile widths (wgmma n), widest first
TC_TILE_N = (192, 128, 64)


def route(m: int, p: int, kp: int) -> str:
    """The ``rbmm_int`` kernel for an (M x Kp words) by (P x Kp) product:
    "scalar" (the decode kernel: popcounts, no tensor cores) at M <= 16,
    where the launch is the floor; "tc" (int8 tensor cores) above, which
    was faster at every larger shape the main paths give it on the H100
    (``PERF.md`` §6)."""
    return "scalar" if m <= 16 else "tc"


@functools.lru_cache(maxsize=None)
def tile_n(p: int) -> int:
    """The tensor-core kernel's N tile for P columns: the fewest padded
    columns, then the widest tile (cached: it runs on every launch)."""
    return min(TC_TILE_N, key=lambda bn: (-(-p // bn) * bn, -bn))


# the decode kernel: its row blocks, the popcounts a lane makes per column
# at most (rows times the words it takes, where M allows), the warps a
# block may have, and the blocks a grid keeps at least where the columns
# allow (half the 132 SMs of an H100 SXM)
DECODE_ROWS = (1, 2, 4, 8)
DECODE_LANE_WORDS = 8
DECODE_WARPS = (8, 4, 2, 1)
DECODE_MIN_BLOCKS = 66


def decode_rows(m: int) -> int:
    """The smallest row block of ``DECODE_ROWS`` that holds M rows (the
    largest above it)."""
    return next((r for r in DECODE_ROWS if r >= m), DECODE_ROWS[-1])


@functools.lru_cache(maxsize=None)
def decode_tile(batch: int, m: int, p: int,
                kp: int) -> Tuple[int, int, int, int]:
    """The decode kernel's (rows per block, lanes per column, warps per
    block, words per load) for ``batch`` products of (M x Kp words) by
    (P x Kp): 16-byte loads where Kp allows (the kernel lowers them where
    the operands' bases do not), then 8- and 4-byte ones; one load a lane
    where 32 lanes allow; the most rows (up to M's block) that keep a
    lane's popcounts per column at ``DECODE_LANE_WORDS``; the most warps
    that keep ``DECODE_MIN_BLOCKS`` blocks (fewer, larger blocks were
    faster down to there on the H100, ``PERF.md`` §6).  Cached: it runs on
    every launch."""
    vec = 4 if kp % 4 == 0 else 2 if kp % 2 == 0 else 1
    vecs = kp // vec
    lanes = min(32, 1 << (vecs - 1).bit_length())
    words = -(-vecs // lanes) * vec
    rows = max([r for r in DECODE_ROWS if r <= decode_rows(m) and
                r * words <= DECODE_LANE_WORDS] or [1])
    warps = next((w for w in DECODE_WARPS if decode_grid(
        batch, m, p, rows, lanes, w) >= DECODE_MIN_BLOCKS), DECODE_WARPS[-1])
    return rows, lanes, warps, vec


def decode_grid(batch: int, m: int, p: int, rows: int, lanes: int,
                warps: int) -> int:
    """The decode kernel's blocks (as ``cobra_rbmm_int`` launches them):
    column tiles of ``32 * warps / lanes`` by row blocks by batch items."""
    return -(-p // (32 * warps // lanes)) * -(-m // rows) * batch


def rbmm_int(a: torch.Tensor, b: torch.Tensor, k: int, *,
             scheme: str = "xnor",
             dc: Optional[torch.Tensor] = None) -> torch.Tensor:
    _check(a, b, k, scheme, dc)
    on = kernels.use_kernel(a, b, dc)
    if on == "cpu":
        return ref.rbmm_int(a, b, k, scheme=scheme, dc=dc)
    if on == "meta":
        kernels.require_contiguous("rbmm_int", a, b, dc)
        out = torch.empty(a.shape[:-1] + (b.shape[-2],), dtype=torch.int32,
                          device=a.device)
        census.kernel("rbmm_int", work.rbmm(math.prod(a.shape[:-1]),
                                         b.shape[-2], k, a, b, dc, out))
        return out
    return _launch_int(route(a.shape[-2], b.shape[-2], a.shape[-1]), a, b,
                       k, scheme, dc)


def launch_int(which: str, a: torch.Tensor, b: torch.Tensor, k: int, *,
               scheme: str = "xnor",
               dc: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch route ``which`` of ``rbmm_int`` on CUDA operands, whatever
    the shape: the card tests and ``launch/kernel_times.py`` hold and time
    each route; ``rbmm_int`` takes ``route(M, P, Kp)``."""
    _check(a, b, k, scheme, dc)
    if which not in ROUTES or kernels.use_kernel(a, b, dc) != "cuda":
        raise ValueError(f"launch_int takes a route of {ROUTES} and CUDA "
                         f"operands, got {which!r} on {a.device}")
    return _launch_int(which, a, b, k, scheme, dc)


def _launch_int(which, a, b, k, scheme, dc) -> torch.Tensor:
    kernels.require_contiguous("rbmm_int", a, b, dc)
    m, p = a.shape[-2], b.shape[-2]
    batch = math.prod(a.shape[:-2])
    out = torch.empty(a.shape[:-1] + (p,), dtype=torch.int32,
                      device=a.device)
    args = (a.data_ptr(), b.data_ptr(), kernels.ptr(dc), batch, m, p,
            a.shape[-1], k, SCHEMES.index(scheme))
    if which == "tc":
        kernels.launch("cobra_rbmm_int_tc", _TC_ARGTYPES, a.device, *args,
                       tile_n(p), out.data_ptr())
    else:
        kernels.launch("cobra_rbmm_int", _ARGTYPES, a.device, *args,
                       *decode_tile(batch, m, p, a.shape[-1]),
                       out.data_ptr())
    rbmm_int.launches += 1
    return out


rbmm_int.launches = 0


def rbmm_binary(a: torch.Tensor, b: torch.Tensor, k: int,
                theta: torch.Tensor, *, scheme: str = "xnor",
                dc: Optional[torch.Tensor] = None, causal: bool = False,
                pack_output: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    _check(a, b, k, scheme, dc, name="rbmm_binary")
    if theta.dtype != torch.int32:
        raise TypeError(f"rbmm_binary: theta must be int32, got "
                        f"{theta.dtype}")
    m, p = a.shape[-2], b.shape[-2]
    shape = a.shape[:-1] + (p,)
    try:
        fits = torch.broadcast_shapes(theta.shape, shape) == shape
    except RuntimeError:
        fits = False
    if not fits:
        raise ValueError(f"rbmm_binary: theta {tuple(theta.shape)} does not "
                         f"broadcast to the output {tuple(shape)}")
    on = kernels.use_kernel(a, b, dc, theta)
    if on == "cpu":
        bits, dc_ret = ref.rbmm_binary(a, b, k, theta, scheme=scheme, dc=dc,
                                       causal=causal)
        return (packing.pack_bits(bits) if pack_output else bits), dc_ret
    kernels.require_contiguous("rbmm_binary", a, b, dc)
    batch = math.prod(a.shape[:-2])
    width = packing.packed_len(p) if pack_output else p
    out = torch.empty(a.shape[:-1] + (width,), dtype=torch.int32,
                      device=a.device)
    dc_ret = torch.zeros(a.shape[:-1], dtype=torch.int32, device=a.device)
    th, th_strides = _theta_view(theta, shape, batch)
    if on == "meta":
        census.kernel("rbmm_binary", work.rbmm(batch * m, p, k, a, b, dc, th,
                                            out, dc_ret))
        return out, dc_ret
    kernels.launch("cobra_rbmm_binary", _BINARY_ARGTYPES, a.device,
                   a.data_ptr(), b.data_ptr(), kernels.ptr(dc),
                   th.data_ptr(), *th_strides, batch, m, p, a.shape[-1], k,
                   SCHEMES.index(scheme), int(causal), int(pack_output),
                   out.data_ptr(), dc_ret.data_ptr())
    rbmm_binary.launches += 1
    return out, dc_ret


rbmm_binary.launches = 0


def _theta_view(theta: torch.Tensor, shape, batch: int):
    """(tensor, its element strides over the (batch, M, P) output ``shape``,
    0 on broadcast axes).  A theta of at most two dims (the (P,) vector, a
    scalar, a per-row or an (M, P) table) is read in place through its own
    strides, with no tensor op on the host; a higher one through a
    (batch, M, P) view of it (or a copy where no view exists)."""
    if theta.dim() > 2:
        th = theta.expand(shape).reshape(batch, shape[-2], shape[-1])
        return th, th.stride()
    size = (1,) * (2 - theta.dim()) + tuple(theta.shape)
    stride = (0,) * (2 - theta.dim()) + tuple(theta.stride())
    return theta, (0,) + tuple(0 if n == 1 else st
                               for n, st in zip(size, stride))
