"""Plain PyTorch versions of the paged gather-decode kernel (port of
``repro.kernels.paged_attn.ref``).

``paged_gather_decode``          materialize the gathered ring view,
    unpack to ±1, attend with dense integer matmuls; the ground truth.
``paged_gather_decode_popcount`` the same gather, but scores and context
    stay on packed words end to end (Eq. 7 xnor score with the pad
    correction, then popcount(probs & V^T) - nnz).
``paged_gather_decode_split``    no gather: the page-split kernel's
    per-page int32 partials added in any order (a test helper).

Words are int32 tensors holding the reference's uint32 bits."""
from __future__ import annotations

import torch

from repro_torch.core import packing


def gather_ring_view(k_pages: torch.Tensor, vt_pages: torch.Tensor,
                     block_table: torch.Tensor):
    """Block tables -> the contiguous ring view: k (B, Hkv, nblk*page, dhp)
    and v^T (B, Hkv, d_h, nblk*page/32); logical ring slot s is column s.
    Table entries are clipped to [0, P]."""
    b, nblk = block_table.shape
    _, hkv, page, dhp = k_pages.shape
    dh = vt_pages.shape[2]
    bt = block_table.long().clamp(0, k_pages.shape[0] - 1)
    kc = k_pages[bt].movedim(1, 2).reshape(b, hkv, nblk * page, dhp)
    vc = vt_pages[bt].movedim(1, 3).reshape(
        b, hkv, dh, nblk * page // packing.WORD)
    return kc, vc


def _valid(lengths, ring_len, wg: int, device) -> torch.Tensor:
    """(B, Wg) mask: col <= lengths[b] and col < ring_len."""
    cols = torch.arange(wg, device=device)[None, :]
    ring = int(ring_len)
    return (cols <= lengths.to(torch.int64)[:, None]) & (cols < ring)


def paged_gather_decode(q_bits, k_pages, vt_pages, block_table, lengths,
                        ring_len, theta, *, d_h: int) -> torch.Tensor:
    """Same contract as ``ops.paged_gather_decode``, via gather + unpack +
    dense integer matmuls -> (B, H, d_h) int32."""
    h = q_bits.shape[1]
    hkv = k_pages.shape[1]
    g = h // hkv
    kc, vc = gather_ring_view(k_pages, vt_pages, block_table)
    wg = kc.shape[2]
    q = packing.unpack_signs(q_bits, d_h, torch.int64)     # (B, H, dh)
    k = packing.unpack_signs(kc, d_h, torch.int64).repeat_interleave(g, 1)
    c = torch.einsum("bhd,bhwd->bhw", q, k)
    probs = (c >= theta[:, :, None].to(torch.int64)).to(torch.int64)
    probs = probs * _valid(lengths, ring_len, wg, q_bits.device)[:, None, :]
    v = packing.unpack_signs(vc, wg, torch.int64).repeat_interleave(g, 1)
    return torch.einsum("bhw,bhdw->bhd", probs, v).to(torch.int32)


def paged_gather_decode_popcount(q_bits, k_pages, vt_pages, block_table,
                                 lengths, ring_len, theta, *,
                                 d_h: int) -> torch.Tensor:
    """Same contract, no ±1 unpack: scores and context on packed words."""
    h = q_bits.shape[1]
    hkv = k_pages.shape[1]
    g = h // hkv
    kc, vc = gather_ring_view(k_pages, vt_pages, block_table)
    wg = kc.shape[2]
    kc = kc.repeat_interleave(g, 1)                        # (B, H, Wg, dhp)
    c = packing.xnor_popcount_score(q_bits[:, :, None, :], kc, d_h)
    probs = (c >= theta[:, :, None]) & \
        _valid(lengths, ring_len, wg, q_bits.device)[:, None, :]
    probs_p = packing.pack_bits(probs)                     # (B, H, Wg/32)
    nnz = probs.sum(-1, dtype=torch.int32)
    vc = vc.repeat_interleave(g, 1)                        # (B, H, dh, Wg/32)
    pc = packing.popcount_words(probs_p[:, :, None, :] & vc).sum(
        -1, dtype=torch.int32)
    return 2 * pc - nnz[..., None]


def paged_gather_decode_split(q_bits, k_pages, vt_pages, block_table,
                              lengths, ring_len, theta, *, d_h: int,
                              generator=None) -> torch.Tensor:
    """The page-split kernel's arithmetic, a test helper that no model
    path calls: per sequence, each live page's int32 partial context
    (``2*popcount(P_page & V^T_page) - nnz(P_page)`` for every query head)
    is added into the output in a random order drawn from ``generator``
    (table order when None).  A page is live up to the one holding
    column ``min(lengths[b], ring_len - 1)``; columns are masked by their
    position only.  Same contract as ``paged_gather_decode``."""
    b, h, _ = q_bits.shape
    npages, hkv, page, _ = k_pages.shape
    nblk = block_table.shape[1]
    groups = h // hkv
    dh = vt_pages.shape[2]
    out = torch.zeros((b, h, dh), dtype=torch.int32, device=q_bits.device)
    for i in range(b):
        last = min(int(lengths[i]), int(ring_len) - 1)
        live = 0 if last < 0 else min(nblk, last // page + 1)
        order = (range(live) if generator is None else
                 torch.randperm(live, generator=generator).tolist())
        for j in order:
            phys = min(max(int(block_table[i, j]), 0), npages - 1)
            k = k_pages[phys].repeat_interleave(groups, 0)  # (H, page, dhp)
            c = packing.xnor_popcount_score(q_bits[i][:, None, :], k, d_h)
            cols = j * page + torch.arange(page, device=q_bits.device)
            probs = (c >= theta[i][:, None]) & (cols <= last)[None, :]
            pw = packing.pack_bits(probs)                 # (H, page/32)
            vt = vt_pages[phys].repeat_interleave(groups, 0)
            pc = packing.popcount_words(pw[:, None, :] & vt).sum(
                -1, dtype=torch.int32)
            out[i] += 2 * pc - probs.sum(-1, dtype=torch.int32)[:, None]
    return out
