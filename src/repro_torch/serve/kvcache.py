"""Cache sizing report (port of the contiguous part of
``repro.serve.kvcache``).  The slot-pool, page-arena, speculative and
traffic fields of the JAX package's ``EngineReport`` belong to the
continuous engine and arrive with it."""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterator, List, Tuple

import torch

from repro_torch.models.attention import KVCache

Caches = List[Dict[str, Any]]

_PACKED_FIELDS = ("k_bits", "vt_bits")


def _leaves(caches: Caches) -> Iterator[Tuple[str, torch.Tensor]]:
    for layer in caches:
        for part in layer.values():
            if isinstance(part, KVCache):
                yield from zip(part._fields, part)
            else:
                raise TypeError(f"cannot size cache part {type(part)}")


def cache_bytes(caches: Caches) -> int:
    """Device bytes held by the caches (every tensor counts)."""
    return sum(t.numel() * t.element_size() for _, t in _leaves(caches))


def bf16_equivalent_bytes(caches: Caches) -> int:
    """What the same caches would cost with bf16 K/V: a packed word holds
    32 values (64 bytes in bf16); other tensors count 2 bytes per element,
    as the JAX package counts them."""
    return sum(t.numel() * (64 if name in _PACKED_FIELDS else 2)
               for name, t in _leaves(caches))


@dataclasses.dataclass
class EngineReport:
    """Typed serving report (the memory group of the JAX package's
    schema).  It also answers ``report["total_bytes"]``, ``.keys()`` and
    ``.items()``, like the JAX package's report."""
    total_bytes: float = 0.0
    bytes_per_token: float = 0.0
    bf16_equivalent_bytes: float = 0.0
    compression_vs_bf16: float = 0.0

    @classmethod
    def field_names(cls) -> Tuple[str, ...]:
        return tuple(f.name for f in dataclasses.fields(cls))

    def __getitem__(self, key: str) -> Any:
        if key not in self.field_names():
            raise KeyError(key)
        return getattr(self, key)

    def keys(self) -> List[str]:
        return list(self.field_names())

    def items(self) -> Iterator[Tuple[str, Any]]:
        return ((k, getattr(self, k)) for k in self.keys())


def cache_report(caches: Caches, *, seq_len: int,
                 batch: int) -> EngineReport:
    """Memory report of contiguous caches; ``seq_len * batch`` is the
    nominal capacity behind ``bytes_per_token``."""
    total = cache_bytes(caches)
    bf16 = bf16_equivalent_bytes(caches)
    return EngineReport(total_bytes=float(total),
                        bytes_per_token=float(total / max(seq_len * batch,
                                                          1)),
                        bf16_equivalent_bytes=float(bf16),
                        compression_vs_bf16=float(bf16) / max(total, 1))
