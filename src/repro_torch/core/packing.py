"""Bit-packing along the contraction dimension (the paper's "datapacks").

Port of ``repro.core.packing``.  32 binary values pack into one word along
the last axis, LSB-first, "+1" -> bit 1, "-1" (or "0" in the unsigned
scheme) -> bit 0, pad bits 0.  Words are ``torch.int32`` holding the JAX
package's ``uint32`` bits exactly, so three rules keep the int32 view
honest:

  * words are assembled in int64, where the 32 disjoint shifted bits add
    up to their OR without overflowing, then wrapped into int32;
  * bits are read back as ``(w >> i) & 1``, which masks away the sign
    extension of the arithmetic int32 shift;
  * popcounts run on the word zero-extended to int64 (a SWAR count).
"""
from __future__ import annotations

import torch

WORD = 32
_TWO32 = 1 << 32
_TWO31 = 1 << 31


def packed_len(k: int) -> int:
    return (k + WORD - 1) // WORD


def _to_word(w64: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 with the same 32 bits."""
    return torch.where(w64 >= _TWO31, w64 - _TWO32, w64).to(torch.int32)


def bit_mask(offset: torch.Tensor) -> torch.Tensor:
    """int32 words with only bit ``offset`` (0..31) set."""
    return _to_word(torch.ones_like(offset, dtype=torch.int64) <<
                    offset.to(torch.int64))


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """Pack a {0,1} tensor along the last axis into int32 words.

    bits: (..., K) any dtype holding exactly {0,1}.
    returns (..., ceil(K/32)) int32."""
    k = bits.shape[-1]
    kp = packed_len(k)
    pad = kp * WORD - k
    b = bits.to(torch.int64)
    if pad:
        fill = torch.zeros(bits.shape[:-1] + (pad,), dtype=torch.int64,
                           device=bits.device)
        b = torch.cat([b, fill], dim=-1)
    b = b.reshape(bits.shape[:-1] + (kp, WORD))
    shifts = torch.arange(WORD, dtype=torch.int64, device=bits.device)
    return _to_word((b << shifts).sum(dim=-1))


def unpack_bits(packed: torch.Tensor, k: int) -> torch.Tensor:
    """Inverse of pack_bits -> (..., k) int32 in {0,1}."""
    kp = packed.shape[-1]
    shifts = torch.arange(WORD, dtype=torch.int32, device=packed.device)
    bits = (packed.unsqueeze(-1) >> shifts) & 1
    bits = bits.reshape(packed.shape[:-1] + (kp * WORD,))
    return bits[..., :k].to(torch.int32)


def pack_signs(x: torch.Tensor) -> torch.Tensor:
    """{-1,+1}-scheme packing of a real tensor: bit = (x >= 0)."""
    return pack_bits(x >= 0)


def pack_unsigned(x: torch.Tensor) -> torch.Tensor:
    """{0,1}-scheme packing: bit = (x > 0)."""
    return pack_bits(x > 0)


def unpack_signs(packed: torch.Tensor, k: int,
                 dtype=torch.float32) -> torch.Tensor:
    """Unpack to ±1 values (bit 1 -> +1, bit 0 -> -1)."""
    return (2 * unpack_bits(packed, k) - 1).to(dtype)


def popcount_words(packed: torch.Tensor) -> torch.Tensor:
    """Per-word popcount (SWAR on the zero-extended word) -> int32."""
    x = packed.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    x = x + (x >> 8)
    x = x + (x >> 16)
    return (x & 0x3F).to(torch.int32)


def dc_count(packed: torch.Tensor, k: int) -> torch.Tensor:
    """Don't-care count: zeros in the true K region of a {0,1}-scheme
    datapack (Eq. 7, second case).  Pad bits are 0, so ``k - popcount``
    is exact for every k."""
    return k - popcount_words(packed).sum(dim=-1, dtype=torch.int32)


def xnor_popcount_score(a: torch.Tensor, b: torch.Tensor,
                        k: int) -> torch.Tensor:
    """Eq. 7 signed-scheme score on packed words (pad-0 convention):
    ``sum_w 2*popcount(XNOR(a_w, b_w)) - (k + 2*pad)`` — the ±1 dot product
    of the encoded values for every k (each zero pad-bit pair adds
    XNOR(0,0)=1 to the popcount, folded into the constant)."""
    kp = a.shape[-1]
    if b.shape[-1] != kp:
        raise ValueError(
            f"packed operands disagree on word count: {kp} vs "
            f"{b.shape[-1]}")
    if kp != packed_len(k):
        raise ValueError(
            f"operands carry {kp} packed words but k={k} needs "
            f"ceil(k/32)={packed_len(k)}")
    pad = kp * WORD - k
    pc = popcount_words(~(a ^ b)).sum(dim=-1, dtype=torch.int32)
    return 2 * pc - (k + 2 * pad)
