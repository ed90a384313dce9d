"""The work of one kernel call: the bytes it must move and its operations,
by the unit that does them, and the least time the card could take for it.

``launch/kernel_times.py`` reads its bounds from here, and the kernel
wrappers' shape-only route (operands on the ``meta`` device) adds the
same ``Work`` to the dry run's census, so the bound of a timed call and
the work a traced step counts are one arithmetic.

A call moves each operand once and writes each output once (``nbytes``).
Its operations are counted on the unit that can do them fastest where
there are two ways (``cheaper``): an RBMM's words as popcounts on the
32-bit ALUs (3 operations a word pair) or its unpacked values' multiply-
adds on the int8 tensor cores (2 operations a MAC); ``rbmm_mxu``'s on the
bf16 tensor cores; the pack kernel's one compare per element on the ALUs.

H100 SXM5 peaks (NVIDIA H100 Tensor Core GPU data sheet, SXM5, dense, 700
W): HBM3 3.35 TB/s, bf16 989 TFLOP/s, int8 1,979 TOP/s; 32-bit integer
operations outside the tensor cores 67 TOP/s (the data sheet's FP32 rate,
which the integer ALUs match).
"""
from __future__ import annotations

from typing import NamedTuple

HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
INT8_OPS = 1979e12
SCALAR32_OPS = 67e12     # 32-bit operations outside the tensor cores

# unit -> peak operations per second
RATES = {"bf16": BF16_FLOPS, "int8": INT8_OPS, "word": SCALAR32_OPS}
UNITS = tuple(RATES)


class Work(NamedTuple):
    bytes: int          # each operand read once, each output written once
    ops: int            # operations on ``unit``
    unit: str           # "bf16", "int8" or "word" (a key of RATES)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def bound(moved_bytes: float, ops: float, op_rate: float):
    """(ms, "bytes" or "operations"): the larger of the bytes at the memory
    rate and the operations at ``op_rate``."""
    t_bytes = moved_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / op_rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bound_of(work: Work):
    """``bound`` of one call's ``Work``."""
    return bound(work.bytes, work.ops, RATES[work.unit])


def cheaper(*works: Work) -> Work:
    """The way to do a call's work with the least bound (the first of
    equal ones)."""
    return min(works, key=bound_of)


def rbmm(m: int, p: int, k: int, *tensors) -> Work:
    """An RBMM of (m x k) by (p x k) values (all products of a batch: m
    counts every row): popcount words on the ALUs or int8 MACs."""
    moved = nbytes(*tensors)
    return cheaper(Work(moved, 3 * m * p * ((k + 31) // 32), "word"),
                   Work(moved, 2 * m * p * k, "int8"))


def mxu(batch: int, m: int, k: int, p: int, *tensors) -> Work:
    """``rbmm_mxu``: (m x k) bf16 values by (p x k) unpacked weights, per
    batch item, on the bf16 tensor cores."""
    return Work(nbytes(*tensors), 2 * batch * m * k * p, "bf16")


def pack(x, theta, out) -> Work:
    """``pack_threshold``: one compare a value on the ALUs."""
    return Work(nbytes(x, theta, out), x.numel(), "word")


def sps(q, k, vt, theta, out, causal: bool, window: int = 0,
        lens=None) -> Work:
    """One ``sps_attention`` call: the score and context words on the ALUs
    (3 operations a word pair) or their multiply-adds on the int8 tensor
    cores, over the (query, key) pairs its mask lets through (a causal
    window: min(row + 1, window) a row)."""
    b, h, length, dhp = q.shape
    dh = vt.shape[2]
    if causal and 0 < window < length:
        per_seq = window * (window + 1) // 2 + (length - window) * window
    elif causal:
        per_seq = length * (length + 1) // 2
    else:
        per_seq = length * length
    pairs = b * h * per_seq
    moved = nbytes(q, k, vt, theta, out, lens)
    return cheaper(Work(moved, 3 * pairs * dhp + 3 * pairs * dh // 32,
                        "word"),
                   Work(moved, 2 * 2 * pairs * dh, "int8"))


def paged(q, k_pages, vt_pages, pages_read: int, *small) -> Work:
    """One ``paged_gather_decode`` call that reads ``pages_read`` (page,
    KV head) blocks: their words, and q, the table, lengths, thresholds
    and output (``small``); the words' popcount operations on the ALUs."""
    _, h, dhp = q.shape
    _, hkv, page, _ = k_pages.shape
    dh = vt_pages.shape[2]
    groups = h // hkv
    moved = pages_read * 4 * (page * dhp + dh * page // 32) + nbytes(
        q, *small)
    return Work(moved, pages_read * 3 * groups * (page * dhp + dh * page //
                                                   32), "word")

