"""Public wrapper for the paged gather-decode kernel.

Contract: ``paged_gather_decode(q_bits (B, H, ceil(d_h/32)), k_pages
(P+1, Hkv, page_size, ceil(d_h/32)), vt_pages (P+1, Hkv, d_h,
page_size/32), block_table (B, num_blocks), lengths (B,), ring_len,
theta (B, H))`` -> the (B, H, d_h) int32 SPS decode context of one new
token per sequence, attending over the packed page arena THROUGH the block
table (clipped to ``[0, P]``): the gathered ring view is never built.
Words, tables, lengths and thresholds are int32.  Page 0 is the trash
page; unmapped table entries point at it.  Masking is positional only
(``col <= lengths[b]`` and ``col < ring_len``), so callers keep a row's
mapped pages a prefix covering every position < ``min(lengths[b]+1,
ring_len)``; trash-page columns are then always masked.  ``ring_len`` is
a host int, fixed when the cache is built (no device read per launch).

Padding contract: q and k carry exactly ``ceil(d_h/32)`` words with ZERO
pad bits (the score's pad correction is in the formula, so d_h need not
be a multiple of 32); page_size is a multiple of 32 with ``vt_pages``
packing ``page_size/32`` words per page.  The wrapper checks both.

Dispatch: CUDA tensors launch ``csrc/paged_attn.cu``; CPU tensors take
``ref.paged_gather_decode_popcount``; meta tensors the shape-only route
(``kernels.use_kernel``, reading every table block within the ring).
``paged_gather_decode.launches`` counts kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch import census, kernels
from repro_torch.kernels import work
from repro_torch.core import packing
from repro_torch.kernels.paged_attn import ref

# the kernel's per-block limits (csrc/paged_attn.cu)
MAX_DH = 256
MAX_GROUPS = 16
MAX_PAGE = 256
_ARGTYPES = [kernels.PTR] * 6 + [kernels.I64] * 8 + [kernels.PTR]


def _validate(q_bits, k_pages, vt_pages, d_h: int) -> None:
    dhp = packing.packed_len(d_h)
    if q_bits.shape[-1] != dhp or k_pages.shape[-1] != dhp:
        raise ValueError(
            f"paged_gather_decode: packed K operands must carry "
            f"ceil(d_h/32)={dhp} words for d_h={d_h}, got "
            f"q={q_bits.shape[-1]} k_pages={k_pages.shape[-1]} — repack "
            f"with repro_torch.core.packing (pad bits must be 0)")
    page = k_pages.shape[2]
    if page % packing.WORD or vt_pages.shape[-1] != page // packing.WORD:
        raise ValueError(
            f"paged_gather_decode: page_size={page} must be a multiple of "
            f"{packing.WORD} with vt_pages packing {page // packing.WORD} "
            f"words per page, got {vt_pages.shape[-1]}")


def _check(q, kp, vtp, bt, lengths, theta, d_h) -> None:
    _validate(q, kp, vtp, d_h)
    for name, t in (("q_bits", q), ("k_pages", kp), ("vt_pages", vtp),
                    ("block_table", bt), ("lengths", lengths),
                    ("theta", theta)):
        if t.dtype != torch.int32:
            raise TypeError(f"paged_gather_decode: {name} must be int32, "
                            f"got {t.dtype}")
    b, h, _ = q.shape
    npages, hkv, page, _ = kp.shape
    if hkv == 0 or h % hkv or tuple(vtp.shape[:3]) != (npages, hkv, d_h):
        raise ValueError(f"paged_gather_decode: k_pages {tuple(kp.shape)} "
                         f"and vt_pages {tuple(vtp.shape)} do not match "
                         f"q {tuple(q.shape)} (KV heads must divide heads)")
    if bt.dim() != 2 or bt.shape[0] != b or tuple(lengths.shape) != (b,) \
            or tuple(theta.shape) != (b, h):
        raise ValueError(f"paged_gather_decode: block_table (B, nblk), "
                         f"lengths (B,) and theta (B, H) for B={b}, H={h};"
                         f" got {tuple(bt.shape)}, {tuple(lengths.shape)},"
                         f" {tuple(theta.shape)}")


def paged_gather_decode(q_bits: torch.Tensor, k_pages: torch.Tensor,
                        vt_pages: torch.Tensor, block_table: torch.Tensor,
                        lengths: torch.Tensor, ring_len: int,
                        theta: torch.Tensor, *, d_h: int) -> torch.Tensor:
    _check(q_bits, k_pages, vt_pages, block_table, lengths, theta, d_h)
    on = kernels.use_kernel(q_bits, k_pages, vt_pages, block_table,
                            lengths, theta)
    if on == "cpu":
        return ref.paged_gather_decode_popcount(
            q_bits, k_pages, vt_pages, block_table, lengths, ring_len,
            theta, d_h=d_h)
    b, h, _ = q_bits.shape
    npages, hkv, page, _ = k_pages.shape
    if d_h > MAX_DH or h // hkv > MAX_GROUPS or page > MAX_PAGE:
        raise ValueError(f"paged_gather_decode: the kernel takes d_h <= "
                         f"{MAX_DH}, <= {MAX_GROUPS} query heads per KV "
                         f"head and pages <= {MAX_PAGE}; got d_h={d_h}, "
                         f"{h // hkv}, page={page}")
    kernels.require_contiguous("paged_gather_decode", q_bits, k_pages,
                               vt_pages, block_table, lengths, theta)
    out = torch.empty((b, h, d_h), dtype=torch.int32, device=q_bits.device)
    if on == "meta":
        # no lengths to read: every table block within the ring
        blocks = min(block_table.shape[1], -(-int(ring_len) // page))
        census.kernel("paged_gather_decode", work.paged(
            q_bits, k_pages, vt_pages, b * blocks * hkv, block_table,
            lengths, theta, out))
        return out
    kernels.launch("cobra_paged_gather_decode", _ARGTYPES, q_bits.device,
                   q_bits.data_ptr(), k_pages.data_ptr(),
                   vt_pages.data_ptr(), block_table.data_ptr(),
                   lengths.data_ptr(), theta.data_ptr(), b, h, hkv, d_h,
                   page, block_table.shape[1], npages, int(ring_len),
                   out.data_ptr())
    paged_gather_decode.launches += 1
    return out


paged_gather_decode.launches = 0
