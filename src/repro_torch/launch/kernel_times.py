"""Times of the port's RBMM, pack and attention kernels at the shapes the
main paths give them, on one CUDA card.

    PYTHONPATH=src python -m repro_torch.launch.kernel_times
    PYTHONPATH=src python -m repro_torch.launch.kernel_times --trace
    PYTHONPATH=src python -m repro_torch.launch.kernel_times --ksteps
    PYTHONPATH=src python -m repro_torch.launch.kernel_times --tiles
    PYTHONPATH=src python -m repro_torch.launch.kernel_times --only 'sps_|paged_'
    PYTHONPATH=src python -m repro_torch.launch.kernel_times --moe

For each shape it prints one JSON object: the device time of one call
(``ms``: every CUDA kernel the call launches, under torch.profiler), the
time per call with the wrapper's host work (``eager_ms``: CUDA events
around a loop of calls), the least time the card could take (``bound_ms``:
the larger of the bytes moved, each input read once and each output
written once, at 3.35 TB/s and the operations at the data-sheet rate of
the fastest unit that can do them) and the time of one PyTorch call that
computes the same function (``library_ms``: bf16 ``torch.matmul`` of the
unpacked operands for the RBMM kernels; none for pack and the
attention kernels).  ``sps_attention`` is also timed at L = 64, 128, 256
and 512 (the encoder's heads, bidirectional) for its cost per key tile;
``rbmm_int`` at every decode call of smollm-135m at M = 8 and 16 and at
w2 for M = 32, 64 and 128, where its routes would cross;
``paged_gather_decode`` at the continuous path's decode shape with lengths
drawn from a fixed seed, so every checkout reads the same pages; every
call of the speculative iteration (``SPEC_CALLS``, rows named ``... spec
...``, each with its launches per iteration, ``spec_launches``); every
call of granite-3-2b's and qwen1.5-32b's serve paths at full width
(``ARCH_CALLS``, rows named by the arch, each with its launches per layer
of its step, ``layer_launches``); every call of gemma3-27b's serve paths
at full width (``GEMMA_CALLS``, rows named ``... gemma ...``, each with
its launches per step, ``step_launches``: the static path at the full
62 layers, the continuous one at 12; the windowed and full-attention
prefills, the row table, the 1,024-slot rings and both paged ring
groups); every call of
hymba-1.5b's and xlstm-350m's serve paths at full width and depth
(``RECURRENT_CALLS``, rows named ``... hymba ...`` / ``... xlstm ...``
by path, each with its launches per step of that path,
``step_launches``; ``recurrent_calls`` sizes them from a config); every
call of seamless-m4t-large-v2's and internvl2-76b's static serve paths
at full width and depth (``ENCDEC_CALLS``, rows
named ``... seamless ...`` / ``... internvl2 ...``, each with its
launches per step, ``step_launches``; ``encdec_calls`` sizes them from a
config; the fused F1 ``rbmm_binary`` of seamless' decode among them).
``--moe``
instead checks and times every expert-batched call of mixtral-8x22b's
and arctic-480b's serve paths at full width (``MOE_CALLS``, rows named
``... moe ...``, one call's operands on the card at a time: each row
says whether the kernel equals its plain version, and its launches per
step).  Where the
checkout's ``rbmm_int`` has two routes, each is timed on its own too (rows
ending in ``[route ...]``).  ``--trace`` instead traces a loop of calls of
each tensor-core kernel and of the decode route at wq and w2 under
torch.profiler (host and card) and prints where the host time per call
goes; ``--ksteps`` times the int8 mainloop
against its number of K-steps; ``--tiles`` times ``rbmm_int``'s decode
kernel at every decode call for the tiles around its rule.

It calls the wrappers' public signatures, so run by path under another
checkout's ``src`` (``PYTHONPATH=<checkout>/src python
<this file>``) it times that checkout's kernels at this file's shapes,
which is how two versions are compared inside one call on one card (the
``window`` and row-table calls of ``sps_attention`` need a checkout whose
wrapper takes them).
"""
from __future__ import annotations

import argparse
import json
import re
import time
from typing import Callable, Dict, List

import numpy as np
import torch

from repro_torch.kernels import work
# H100 SXM peaks (NVIDIA data sheet; dense, 700 W) and the bound arithmetic
# the kernels' dry-run census shares (``repro_torch.kernels.work``)
from repro_torch.kernels.work import (  # noqa: F401
    BF16_FLOPS, HBM_BYTES_PER_S, INT8_OPS, SCALAR32_OPS, bound, nbytes)

M_ENC, D_ENC = 4096, 768   # bert-base-cobra, B = 8 x 512 tokens
# chunked prefill of the continuous path: 16 slots, 3 KV heads of 3 query
# heads each, chunks of 128 tokens, a ring view of 12 pages of 32 tokens
CH_B, CH_HKV, CH_ROWS, CH_C, CH_W, CH_DH = 16, 3, 3 * 128, 128, 384, 64


def device_ms(fn: Callable, iters: int = 20, tries: int = 3) -> float:
    """Device milliseconds per call: the summed time of the CUDA kernels
    it launches (torch.profiler, after one warm call), host work
    excluded.  A profile that saw no kernel at all (one in a few hundred
    did on the H100) is taken again, up to ``tries`` times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    ms = 0.0
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        ms = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA) / iters / 1e3
        if ms > 0:
            break
    return ms


def eager_ms(fn: Callable, iters: int = 50, warmup: int = 5,
             repeats: int = 3) -> float:
    """Milliseconds per call from CUDA events around a loop of calls, the
    median of ``repeats`` loops: the wrapper's host work included, which
    is what a caller waits."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return sorted(times)[len(times) // 2]


# rbmm_int's decode calls at smollm-135m's full width (d = 576, 9/3 heads,
# d_h = 64, d_ff = 1536, a ring of 128 + 32 tokens): M is the batch (8 in a
# static decode step, 16 slots in a pure-decode iteration), or, for the
# ring's score and context, the 3 query heads of a KV head over (batch, 3
# KV heads) products
DECODE_CALLS = {   # name: (lead dims, M, P, K, scheme; and_dc: dc derived)
    "wq/wo": (0, None, 576, 576, "xnor"),
    "wk/wv": (0, None, 192, 576, "xnor"),
    "w1/w3": (0, None, 1536, 576, "xnor"),
    "w2": (0, None, 576, 1536, "and_dc"),
    "ring score": (2, 3, 160, 64, "xnor"),
    "ring context": (2, 3, 64, 160, "and_dc"),
}


def decode_calls(batches=(8, 16), crossover=(32, 64, 128)
                 ) -> Dict[str, tuple]:
    """``rbmm_int decode <call> ...``: (lead, M, P, K, scheme) of every
    decode call at each batch; ``rbmm_int w2 crossover ...``: w2 at the M
    of ``crossover``, where the decode and tensor-core routes meet."""
    out = {}
    for n in batches:
        for call, (nlead, m, p, k, scheme) in DECODE_CALLS.items():
            lead = (n, 3)[:nlead]
            m = n if m is None else m
            kp = (k + 31) // 32
            sa = ",".join(map(str, lead + (m, kp)))
            sb = ",".join(map(str, lead + (p, kp)))
            dims = (f"({sa})x({sb})" if lead else
                    f"({m}x{k})x({p}x{k})")
            tail = ", dc derived" if scheme == "and_dc" else ""
            out[f"rbmm_int decode {call} {dims} {scheme}{tail}"] = (
                lead, m, p, k, scheme)
    for m in crossover:
        out[f"rbmm_int w2 crossover ({m}x1536)x(576x1536) and_dc, dc "
            f"derived"] = ((), m, 576, 1536, "and_dc")
    return out


def word_or_mac(m, p, k, *tensors):
    """The bound of an RBMM: its operands' and output's bytes against the
    faster of two ways to do the work, popcount words (3 ops a word pair)
    on the ALUs or the MACs of the unpacked values on the int8 tensor
    cores (``work.rbmm``)."""
    return work.bound_of(work.rbmm(m, p, k, *tensors))


def rbmm_shapes(seed: int = 0) -> Dict[str, Dict]:
    """The RBMM kernels: each shape's call, library call and bound."""
    from repro_torch.core import packing
    from repro_torch.kernels.rbmm import ops as rbmm
    from repro_torch.kernels.rbmm_mxu import ops as mxu
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def words(*shape_k):
        *shape, k = shape_k
        w = torch.randint(-2**31, 2**31, (*shape, (k + 31) // 32),
                          generator=gen, device="cuda",
                          dtype=torch.int64).to(torch.int32)
        if k % 32:
            w[..., -1] &= (1 << (k % 32)) - 1
        return w

    def signs(rows, k):
        bits = torch.randint(0, 2, (rows, k), generator=gen, device="cuda")
        return (2 * bits - 1).to(torch.bfloat16)

    out = {}
    for name, (m, k, p) in {
            "rbmm_mxu prefill w1 (1024x576)x(576x1536)": (1024, 576, 1536),
            "rbmm_mxu encoder Q/K/V/O (4096x768)x(768x768)":
                (M_ENC, D_ENC, D_ENC)}.items():
        a, w = signs(m, k), words(p, k)
        wv = packing.unpack_signs(w, k, torch.bfloat16)
        res = mxu.rbmm_mxu(a, w)
        out[name] = dict(
            kernel=lambda a=a, w=w: mxu.rbmm_mxu(a, w),
            library=lambda a=a, wv=wv: torch.matmul(a, wv.T),
            bound=work.bound_of(work.mxu(1, m, k, p, a, w, res)))
    m, k, p = M_ENC, D_ENC, D_ENC
    a, w = words(m, k), words(p, k)
    av = packing.unpack_signs(a, k, torch.bfloat16)
    wv = packing.unpack_signs(w, k, torch.bfloat16)
    theta = torch.randint(-40, 40, (p,), generator=gen, device="cuda",
                          dtype=torch.int32)
    bits, dc_ret = rbmm.rbmm_binary(a, w, k, theta, pack_output=True)
    out["rbmm_binary F1 (4096x768)x(768x768) xnor, packed, theta (768,)"] = \
        dict(kernel=lambda: rbmm.rbmm_binary(a, w, k, theta,
                                             pack_output=True),
             library=lambda: torch.matmul(av, wv.T),
             bound=word_or_mac(m, p, k, a, w, theta, bits, dc_ret))
    # rbmm_int at the main paths' shapes: every decode call at M = 8 and
    # 16 and w2 at M = 32, 64 and 128 (the routes' crossing), the encoder's F2
    # and chunked prefill's prefix score, context and intra-chunk score
    dc = torch.randint(0, k, (m,), generator=gen, device="cuda",
                       dtype=torch.int32)
    lead = (CH_B, CH_HKV)
    calls = {name: (words(*lead_, mm, kk), words(*lead_, pp, kk), kk,
                    scheme, None)
             for name, (lead_, mm, pp, kk, scheme) in decode_calls().items()}
    for name, (x, y, kk, scheme, d) in {
            **calls,
            "rbmm_int F2 (4096x768)x(768x768) and_dc, dc given":
                (a, w, k, "and_dc", dc),
            "rbmm_int chunk prefix score (16,3,384,2)x(16,3,384,2) xnor":
                (words(*lead, CH_ROWS, CH_DH), words(*lead, CH_W, CH_DH),
                 CH_DH, "xnor", None),
            "rbmm_int chunk context (16,3,384,12)x(16,3,64,12) and_dc, dc "
            "derived": (words(*lead, CH_ROWS, CH_W),
                        words(*lead, CH_DH, CH_W), CH_W, "and_dc", None),
            "rbmm_int chunk intra score (16,3,384,2)x(16,3,128,2) xnor":
                (words(*lead, CH_ROWS, CH_DH), words(*lead, CH_C, CH_DH),
                 CH_DH, "xnor", None)}.items():
        mm, pp = x.shape[-2], y.shape[-2]
        xv = packing.unpack_signs(x, kk, torch.bfloat16)
        yv = packing.unpack_signs(y, kk, torch.bfloat16)
        res = rbmm.rbmm_int(x, y, kk, scheme=scheme, dc=d)
        batch = x.numel() // (mm * x.shape[-1])
        row = dict(library=lambda xv=xv, yv=yv: torch.matmul(
                       xv, yv.transpose(-1, -2)),
                   bound=word_or_mac(batch * mm, pp, kk, *(
                       t for t in (x, y, d, res) if t is not None)))
        out[name] = dict(row, kernel=lambda x=x, y=y, kk=kk, s=scheme, d=d:
                         rbmm.rbmm_int(x, y, kk, scheme=s, dc=d))
        for which in getattr(rbmm, "ROUTES", ()):
            out[f"{name} [route {which}]"] = dict(
                row, kernel=lambda x=x, y=y, kk=kk, s=scheme, d=d, r=which:
                rbmm.launch_int(r, x, y, kk, scheme=s, dc=d))
    return out


def pack_shapes(seed: int = 0) -> Dict[str, Dict]:
    """pack_threshold at the main paths' shapes: (x, theta) each."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)

    def ints(*shape, lo=-40, hi=40):
        return torch.randint(lo, hi, shape, generator=g, device="cuda",
                             dtype=torch.int32)

    zero = torch.zeros((), device="cuda")
    return {
        "pack decode x (8,1,576) bf16, one theta": (randn(8, 1, 576), zero),
        "pack decode q (8,1,9,64) bf16, per-head theta":
            (randn(8, 1, 9, 64), randn(9, 1, dtype=torch.float32)),
        "pack continuous decode x (16,1,576) bf16, one theta":
            (randn(16, 1, 576), zero),
        "pack continuous decode q (16,1,9,64) bf16, per-head theta":
            (randn(16, 1, 9, 64), randn(9, 1, dtype=torch.float32)),
        "pack prefill x (1024,576) bf16, one theta": (randn(1024, 576), zero),
        "pack prefill V^T (8,3,64,128) bf16 strided, per-head theta":
            (randn(8, 128, 3, 64).permute(0, 2, 3, 1),
             randn(3, 1, 1, dtype=torch.float32)),
        "pack encoder x (8,512,768) bf16, one theta":
            (randn(8, 512, 768), zero),
        "pack encoder ctx (8,512,768) f32, one theta":
            (randn(8, 512, 768, dtype=torch.float32), zero),
        "pack encoder q (8,512,12,64) bf16, per-head theta":
            (randn(8, 512, 12, 64), randn(12, 1, dtype=torch.float32)),
        "pack encoder V^T (8,12,64,512) bf16 strided, per-head theta":
            (randn(8, 512, 12, 64).permute(0, 2, 3, 1),
             randn(12, 1, 1, dtype=torch.float32)),
        "pack chunk probs (16,3,384,384) int32, per-row theta":
            (ints(CH_B, CH_HKV, CH_ROWS, CH_W),
             ints(CH_HKV, CH_ROWS, 1, lo=-8, hi=8)),
        "pack chunk V^T words (16,3,64,384) int32 strided, one theta":
            (ints(CH_B, CH_HKV, CH_W, CH_DH, lo=0, hi=2).transpose(2, 3),
             torch.ones((), dtype=torch.int32, device="cuda")),
    }


def sps_bound(q, k, vt, theta, out, causal: bool, window: int = 0):
    """The bound of one sps_attention call (``work.sps``): the bytes of its
    operands and output against the faster of two ways to do the work,
    the score and context words on the ALUs (3 operations a word pair) or
    their multiply-adds on the int8 tensor cores, over the (query, key)
    pairs its mask lets through (a causal window: min(row + 1, window) a
    row)."""
    return work.bound_of(work.sps(q, k, vt, theta, out, causal, window))


def paged_pages_read(lengths, ring: int, page: int, blocks: int,
                     hkv: int) -> int:
    """The (page, KV head) blocks a paged_gather_decode call reads at these
    lengths: the pages up to each row's last valid column."""
    last = torch.clamp(lengths.long(), max=ring - 1)
    live = torch.clamp(torch.div(last, page, rounding_mode="floor") + 1,
                       min=0, max=blocks)
    return int(live.sum()) * hkv


def paged_bound(q, k_pages, vt_pages, block_table, lengths, ring: int,
                theta, out):
    """The bound of one paged_gather_decode call at these lengths
    (``work.paged``): the pages up to each row's last valid column, once
    per KV head, and q, table, lengths, thresholds and output; the words'
    popcount operations at the ALU rate."""
    pages = paged_pages_read(lengths, ring, k_pages.shape[2],
                             block_table.shape[1], k_pages.shape[1])
    return work.bound_of(work.paged(q, k_pages, vt_pages, pages,
                                    block_table, lengths, theta, out))


# continuous decode: 16 slots, H = 9 over 3, d_h = 64, 12 blocks of 32 over
# an arena of 96 pages
PG_B, PG_H, PG_HKV, PG_DH, PG_PAGE, PG_NBLK, PG_PAGES = 16, 9, 3, 64, 32, \
    12, 96
PG_RING = PG_NBLK * PG_PAGE


def attention_shapes(seed: int = 0) -> Dict[str, Dict]:
    """sps_attention and paged_gather_decode: each shape's call and bound
    (no PyTorch call computes either function)."""
    from repro_torch.kernels.paged_attn import ops as paged
    from repro_torch.kernels.sps_attn import ops as sps
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def words(*shape, k):
        w = torch.randint(-2**31, 2**31, shape, generator=gen,
                          device="cuda", dtype=torch.int64).to(torch.int32)
        if k % 32:
            w[..., -1] &= (1 << (k % 32)) - 1
        return w

    def ints(*shape, lo, hi):
        return torch.randint(lo, hi, shape, generator=gen, device="cuda",
                             dtype=torch.int32)

    out = {}
    for name, (b, h, hkv, length, causal) in {
            "sps_attention prefill B=8 L=128 H=9/3 causal":
                (8, 9, 3, 128, True),
            "sps_attention encoder B=8 L=512 H=12/12 bidirectional":
                (8, 12, 12, 512, False),
            "sps_attention B=8 L=64 H=12/12 bidirectional":
                (8, 12, 12, 64, False),
            "sps_attention B=8 L=128 H=12/12 bidirectional":
                (8, 12, 12, 128, False),
            "sps_attention B=8 L=256 H=12/12 bidirectional":
                (8, 12, 12, 256, False)}.items():
        dh = 64
        q = words(b, h, length, 2, k=dh)
        k = words(b, hkv, length, 2, k=dh)
        vt = words(b, hkv, dh, (length + 31) // 32, k=length)
        th = ints(h, lo=-8, hi=9)
        res = sps.sps_attention_gqa(q, k, vt, th, d_h=dh, causal=causal)
        out[name] = dict(
            kernel=lambda q=q, k=k, vt=vt, th=th, c=causal:
            sps.sps_attention_gqa(q, k, vt, th, d_h=dh, causal=c),
            library=None, bound=sps_bound(q, k, vt, th, res, causal))
    lens = torch.from_numpy(np.random.default_rng(seed).integers(
        0, PG_RING, (PG_B,)).astype(np.int32)).cuda()
    args = (words(PG_B, PG_H, 2, k=PG_DH),
            words(PG_PAGES + 1, PG_HKV, PG_PAGE, 2, k=PG_DH),
            words(PG_PAGES + 1, PG_HKV, PG_DH, PG_PAGE // 32, k=PG_PAGE),
            ints(PG_B, PG_NBLK, lo=0, hi=PG_PAGES + 1), lens, PG_RING,
            ints(PG_B, PG_H, lo=-12, hi=12))
    res = paged.paged_gather_decode(*args, d_h=PG_DH)
    out["paged_gather_decode decode 16 slots H=9/3 d_h=64, 12 blocks of 32"
        ", seeded lengths"] = dict(
        kernel=lambda: paged.paged_gather_decode(*args, d_h=PG_DH),
        library=None, bound=paged_bound(*args, res))
    return out


# The speculative iteration of the continuous path (smollm-135m, 16 slots,
# k = 4, a one-layer draft over a 384-slot ring, 30 trunk layers): every
# call it makes, as (kernel, operands, launches per spec iteration).  The
# verify runs the trunk over 16 x 5 candidates (projections at M = 80 on
# rbmm_mxu; per layer the prefix score, context and intra-chunk score of
# the chunk attend over the 384-slot ring view, the 3 query heads of a KV
# head times 5 positions as M = 15 rows); the draft runs 5 decode steps at
# M = 16.  Operands: rbmm_int (lead, M, P, K, scheme; and_dc: dc derived);
# rbmm_mxu (M, K, P, values in {0,1}); pack_threshold (x shape, x dtype,
# theta shape, x a strided view of the packed axis).
SPEC_K, SPEC_LAYERS, SPEC_STEPS = 4, 30, 5
SPEC_CALLS = {
    "rbmm_int spec verify prefix score (16,3,15,2)x(16,3,384,2) xnor":
        ("rbmm_int", ((16, 3), 15, 384, 64, "xnor"), SPEC_LAYERS),
    "rbmm_int spec verify context (16,3,15,12)x(16,3,64,12) and_dc, dc "
    "derived": ("rbmm_int", ((16, 3), 15, 64, 384, "and_dc"), SPEC_LAYERS),
    "rbmm_int spec verify intra score (16,3,15,2)x(16,3,5,2) xnor":
        ("rbmm_int", ((16, 3), 15, 5, 64, "xnor"), SPEC_LAYERS),
    "rbmm_int spec draft ring score (16,3,3,2)x(16,3,384,2) xnor":
        ("rbmm_int", ((16, 3), 3, 384, 64, "xnor"), SPEC_STEPS),
    "rbmm_int spec draft ring context (16,3,3,12)x(16,3,64,12) and_dc, dc "
    "derived": ("rbmm_int", ((16, 3), 3, 64, 384, "and_dc"), SPEC_STEPS),
    "rbmm_int spec draft wq/wo (16x576)x(576x576) xnor":
        ("rbmm_int", ((), 16, 576, 576, "xnor"), 2 * SPEC_STEPS),
    "rbmm_int spec draft wk/wv (16x576)x(192x576) xnor":
        ("rbmm_int", ((), 16, 192, 576, "xnor"), 2 * SPEC_STEPS),
    "rbmm_int spec draft w1/w3 (16x576)x(1536x576) xnor":
        ("rbmm_int", ((), 16, 1536, 576, "xnor"), 2 * SPEC_STEPS),
    "rbmm_int spec draft w2 (16x1536)x(576x1536) and_dc, dc derived":
        ("rbmm_int", ((), 16, 576, 1536, "and_dc"), SPEC_STEPS),
    "rbmm_mxu spec verify wq/wo (80x576)x(576x576)":
        ("rbmm_mxu", (80, 576, 576, False), 2 * SPEC_LAYERS),
    "rbmm_mxu spec verify wk/wv (80x576)x(192x576)":
        ("rbmm_mxu", (80, 576, 192, False), 2 * SPEC_LAYERS),
    "rbmm_mxu spec verify w1/w3 (80x576)x(1536x576)":
        ("rbmm_mxu", (80, 576, 1536, False), 2 * SPEC_LAYERS),
    "rbmm_mxu spec verify w2 (80x1536)x(576x1536) {0,1}":
        ("rbmm_mxu", (80, 1536, 576, True), SPEC_LAYERS),
    "pack spec verify x (16,5,576) bf16, one theta":
        ("pack_threshold", ((16, 5, 576), "bfloat16", (), False),
         2 * SPEC_LAYERS),
    "pack spec verify ctx (16,5,576) f32, one theta":
        ("pack_threshold", ((16, 5, 576), "float32", (), False), SPEC_LAYERS),
    "pack spec verify h (16,5,1536) f32, one theta":
        ("pack_threshold", ((16, 5, 1536), "float32", (), False),
         SPEC_LAYERS),
    "pack spec verify q (16,5,9,64) bf16, per-head theta":
        ("pack_threshold", ((16, 5, 9, 64), "bfloat16", (9, 1), False),
         SPEC_LAYERS),
    "pack spec verify k (16,5,3,64) bf16, per-head theta":
        ("pack_threshold", ((16, 5, 3, 64), "bfloat16", (3, 1), False),
         SPEC_LAYERS),
    "pack spec verify probs (16,3,15,384) int32, per-row theta":
        ("pack_threshold", ((16, 3, 15, 384), "int32", (3, 15, 1), False),
         SPEC_LAYERS),
    "pack spec commit V^T words (16,3,64,384) int32 strided, one theta":
        ("pack_threshold", ((16, 3, 64, 384), "int32", (), True),
         SPEC_LAYERS),
    "pack spec draft x (16,1,576) f32, one theta":
        ("pack_threshold", ((16, 1, 576), "float32", (), False),
         3 * SPEC_STEPS),
    "pack spec draft h (16,1,1536) f32, one theta":
        ("pack_threshold", ((16, 1, 1536), "float32", (), False),
         SPEC_STEPS),
    "pack spec draft q (16,1,9,64) bf16, per-head theta":
        ("pack_threshold", ((16, 1, 9, 64), "bfloat16", (9, 1), False),
         SPEC_STEPS),
    "pack spec draft k (16,1,3,64) bf16, per-head theta":
        ("pack_threshold", ((16, 1, 3, 64), "bfloat16", (3, 1), False),
         SPEC_STEPS),
}


def spec_launches() -> Dict[str, int]:
    """Launches of each kernel per speculative iteration, from
    ``SPEC_CALLS``."""
    out: Dict[str, int] = {}
    for kernel, _, n in SPEC_CALLS.values():
        out[kernel] = out.get(kernel, 0) + n
    return out


def call_operands(calls: Dict[str, tuple], seed: int = 0
                  ) -> Dict[str, tuple]:
    """{name: (kernel, call, plain, library, bound)} for every call of a
    table of (kernel, operands, launches) (``SPEC_CALLS``, ``ARCH_CALLS``)
    on random operands on the card: ``call`` and ``plain`` run the public
    wrapper and its plain version (``ref.py``; both return a tuple for
    ``rbmm_binary``), ``library`` one PyTorch call computing the same
    function (None for pack and attention)."""
    from repro_torch.core import packing
    from repro_torch.kernels.pack import ops as pack, ref as pack_ref
    from repro_torch.kernels.paged_attn import ops as paged, ref as paged_ref
    from repro_torch.kernels.rbmm import ops as rbmm, ref as rbmm_ref
    from repro_torch.kernels.rbmm_mxu import ops as mxu, ref as mxu_ref
    from repro_torch.kernels.sps_attn import ops as sps, ref as sps_ref
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def words(*shape, k):
        w = torch.randint(-2**31, 2**31, shape + ((k + 31) // 32,),
                          generator=gen, device="cuda",
                          dtype=torch.int64).to(torch.int32)
        if k % 32:
            w[..., -1] &= (1 << (k % 32)) - 1
        return w

    def ints(*shape, lo, hi):
        return torch.randint(lo, hi, shape, generator=gen, device="cuda",
                             dtype=torch.int32)

    out = {}
    for name, (kernel, spec, _) in calls.items():
        if kernel == "rbmm_int":
            lead, m, p, k, scheme = spec
            x, y = words(*lead, m, k=k), words(*lead, p, k=k)
            xv = packing.unpack_signs(x, k, torch.bfloat16)
            yv = packing.unpack_signs(y, k, torch.bfloat16)
            res = rbmm.rbmm_int(x, y, k, scheme=scheme)
            batch = x.numel() // (m * x.shape[-1])
            out[name] = (
                kernel,
                lambda x=x, y=y, k=k, s=scheme: rbmm.rbmm_int(x, y, k,
                                                              scheme=s),
                lambda x=x, y=y, k=k, s=scheme: rbmm_ref.rbmm_int(
                    x, y, k, scheme=s),
                lambda xv=xv, yv=yv: torch.matmul(xv, yv.transpose(-1, -2)),
                word_or_mac(batch * m, p, k, x, y, res))
        elif kernel == "rbmm_binary":
            # the ReLU FFN's fused F1: xnor scores thresholded per column,
            # the bits packed, with the zeros of each row (DC RETURN); the
            # call returns (bits, dc)
            m, p, k = spec
            x, y = words(m, k=k), words(p, k=k)
            th = ints(p, lo=-k // 8, hi=k // 8 + 1)
            xv = packing.unpack_signs(x, k, torch.bfloat16)
            yv = packing.unpack_signs(y, k, torch.bfloat16)
            res = rbmm.rbmm_binary(x, y, k, th, pack_output=True)

            def plain(x=x, y=y, k=k, th=th):
                bits, dc = rbmm_ref.rbmm_binary(x, y, k, th)
                return packing.pack_bits(bits), dc
            out[name] = (
                kernel,
                lambda x=x, y=y, k=k, th=th: rbmm.rbmm_binary(
                    x, y, k, th, pack_output=True),
                plain,
                lambda xv=xv, yv=yv: torch.matmul(xv, yv.transpose(-1, -2)),
                word_or_mac(m, p, k, x, y, th, *res))
        elif kernel == "rbmm_mxu":
            # an optional fifth entry: leading (batch) dims, e.g. experts
            m, k, p, unsigned, *lead = spec
            lead = tuple(lead[0]) if lead else ()
            bits = torch.randint(0, 2, lead + (m, k), generator=gen,
                                 device="cuda")
            a = (bits if unsigned else 2 * bits - 1).to(torch.bfloat16)
            del bits
            w = words(*lead, p, k=k)
            wv = packing.unpack_signs(w, k, torch.bfloat16)
            res = mxu.rbmm_mxu(a, w)
            macs = int(np.prod(lead, dtype=np.int64)) * m * k * p
            out[name] = (kernel, lambda a=a, w=w: mxu.rbmm_mxu(a, w),
                         lambda a=a, w=w: mxu_ref.rbmm_mxu(a, w),
                         lambda a=a, wv=wv: torch.matmul(
                             a, wv.transpose(-1, -2)),
                         work.bound_of(work.mxu(1, 1, 1, macs, a, w, res)))
        elif kernel == "sps_attention":
            b, h, hkv, length, dh, causal, lens, window, rows = spec
            q, k = words(b, h, length, k=dh), words(b, hkv, length, k=dh)
            vt = words(b, hkv, dh, k=length)
            th = ints(*((h, rows) if rows else (h,)), lo=-dh // 8,
                      hi=dh // 8 + 1)
            ln = None if lens is None else torch.tensor(
                lens, dtype=torch.int32, device="cuda")
            kw = dict(d_h=dh, causal=causal, lens=ln, window=window)
            res = sps.sps_attention_gqa(q, k, vt, th, **kw)
            out[name] = (
                kernel,
                lambda q=q, k=k, vt=vt, th=th, kw=kw:
                sps.sps_attention_gqa(q, k, vt, th, **kw),
                # the plain version one sequence at a time: its L x L
                # words stay a few GB at gemma's prefill
                lambda q=q, k=k, vt=vt, th=th, kw=kw: torch.cat([
                    sps_ref.sps_attention_gqa(
                        q[i:i + 1], k[i:i + 1], vt[i:i + 1], th,
                        **dict(kw, lens=None if kw["lens"] is None
                               else kw["lens"][i:i + 1]))
                    for i in range(q.shape[0])]),
                None, sps_bound(q, k, vt, th, res, causal, window))
        elif kernel == "paged_gather_decode":
            # lengths in [lo, hi) (default: within the ring); a row table
            # of thresholds (rows > 0) is gathered at each row's position,
            # as the ``row`` face passes it
            b, h, hkv, dh, page, nblk, pages, *extra = spec
            ring, lo, hi, rows = extra or (nblk * page, 0, nblk * page, 0)
            lens = torch.from_numpy(np.random.default_rng(seed).integers(
                lo, hi, (b,)).astype(np.int32)).cuda()
            th = ints(h, rows, lo=-dh // 6, hi=dh // 6 + 1)[
                :, lens.long().clamp(max=rows - 1)].T.contiguous() \
                if rows else ints(b, h, lo=-dh // 6, hi=dh // 6 + 1)
            args = (words(b, h, k=dh), words(pages + 1, hkv, page, k=dh),
                    words(pages + 1, hkv, dh, k=page),
                    ints(b, nblk, lo=0, hi=pages + 1), lens, ring, th)
            res = paged.paged_gather_decode(*args, d_h=dh)
            out[name] = (
                kernel,
                lambda a=args, dh=dh: paged.paged_gather_decode(*a, d_h=dh),
                lambda a=args, dh=dh: paged_ref.paged_gather_decode_popcount(
                    *a, d_h=dh),
                None, paged_bound(*args, res))
        else:
            shape, dtype, th_shape, strided = spec
            if dtype == "int32":
                lo, hi = (0, 2) if strided else (-40, 40)
                x = torch.randint(lo, hi, shape, generator=gen,
                                  device="cuda", dtype=torch.int32)
                th = (torch.ones(th_shape, dtype=torch.int32, device="cuda")
                      if strided else
                      torch.randint(-8, 8, th_shape, generator=gen,
                                    device="cuda", dtype=torch.int32))
            else:
                x = torch.randn(shape, generator=gen, device="cuda").to(
                    getattr(torch, dtype))
                th = 0.2 * torch.randn(th_shape, generator=gen,
                                       device="cuda")
            if strided:     # the packed axis strided, as the commit's view
                x = x.transpose(-1, -2).contiguous().transpose(-1, -2)
            res = pack.pack_threshold(x, th)
            out[name] = (kernel, lambda x=x, th=th: pack.pack_threshold(x, th),
                         lambda x=x, th=th: pack_ref.pack_threshold(x, th),
                         None,
                         work.bound_of(work.pack(x, th, res)))
    return out


def spec_operands(seed: int = 0) -> Dict[str, tuple]:
    """``call_operands`` of ``SPEC_CALLS``."""
    return call_operands(SPEC_CALLS, seed)


# granite-3-2b and qwen1.5-32b at full width (repro_torch/configs; written
# out so this file times another checkout's kernels too): d_model, query
# heads, KV heads, d_h, d_ff.  The static path's shapes: B = 8 prompts of
# 128 tokens (1,024 rows at prefill), a ring of 128 + 32; the continuous
# path's: 16 slots, 12 blocks of 32 over 96 pages.
DENSE_ARCHS = {"granite-3-2b": (2048, 32, 8, 64, 8192),
               "qwen1.5-32b": (5120, 40, 40, 128, 27392)}
ARCH_B, ARCH_S, ARCH_RING, ARCH_SLOTS = 8, 128, 160, 16
DTYPE_TAGS = {"bfloat16": "bf16", "float32": "f32", "int32": "int32"}


def _arch_calls() -> Dict[str, tuple]:
    """Every call the two archs' serve paths make per layer, at their own
    shapes: (kernel, operands, launches per layer of its step).  The
    decode calls at M = 8 (a static decode step) and 16 (a pure-decode
    iteration; its ring calls do not run there: the paged kernel attends),
    the prefill projections at M = 1,024, the activation packs, the
    prefill attention (and its ragged form, with ``lens``), the paged
    decode attention."""
    out = {}
    for arch, (d, h, hkv, dh, ff) in DENSE_ARCHS.items():
        g = h // hkv
        proj = {"wq/wo": (d, d, 2), "wk/wv": (hkv * dh, d, 2),
                "w1/w3": (ff, d, 2), "w2": (d, ff, 1)}
        for n in (ARCH_B, ARCH_SLOTS):
            for call, (p, k, per) in proj.items():
                scheme = "and_dc" if call == "w2" else "xnor"
                tail = ", dc derived" if scheme == "and_dc" else ""
                out[f"rbmm_int {arch} decode {call} ({n}x{k})x({p}x{k}) "
                    f"{scheme}{tail}"] = ("rbmm_int",
                                          ((), n, p, k, scheme), per)
            ring = n == ARCH_B
            lead = f"{n},{hkv}"
            out[f"rbmm_int {arch} decode ring score ({lead},{g},"
                f"{(dh + 31) // 32})x({lead},{ARCH_RING},{(dh + 31) // 32})"
                f" xnor"] = ("rbmm_int",
                             ((n, hkv), g, ARCH_RING, dh, "xnor"), int(ring))
            out[f"rbmm_int {arch} decode ring context ({lead},{g},"
                f"{ARCH_RING // 32})x({lead},{dh},{ARCH_RING // 32}) and_dc,"
                f" dc derived"] = ("rbmm_int", ((n, hkv), g, dh, ARCH_RING,
                                                "and_dc"), int(ring))
        m = ARCH_B * ARCH_S
        for call, (p, k, per) in proj.items():
            out[f"rbmm_mxu {arch} prefill {call} ({m}x{k})x({p}x{k})"
                f"{' {0,1}' if call == 'w2' else ''}"] = (
                "rbmm_mxu", (m, k, p, call == "w2"), per)
        for shape, dtype, th, strided, per in (
                ((m, d), "bfloat16", (), False, 2),      # x, attn and FFN
                ((m, d), "float32", (), False, 1),       # ctx
                ((m, ff), "float32", (), False, 1),      # h
                ((ARCH_B, ARCH_S, h, dh), "bfloat16", (h, 1), False, 1),
                ((ARCH_B, ARCH_S, hkv, dh), "bfloat16", (hkv, 1), False, 1),
                ((ARCH_B, hkv, dh, ARCH_S), "bfloat16", (hkv, 1, 1), True,
                 1),                                     # V^T, strided
                ((ARCH_SLOTS, 1, d), "float32", (), False, 3),
                ((ARCH_SLOTS, 1, ff), "float32", (), False, 1),
                ((ARCH_SLOTS, 1, h, dh), "bfloat16", (h, 1), False, 1),
                ((ARCH_SLOTS, 1, hkv, dh), "bfloat16", (hkv, 1), False, 1)):
            name = (f"pack {arch} ({','.join(map(str, shape))}) "
                    f"{DTYPE_TAGS[dtype]}{' strided' if strided else ''}, "
                    f"{'one' if th == () else 'per-head'} theta")
            n0 = out.pop(name, (None, None, 0))[2]   # q and k of MHA agree
            out[name] = ("pack_threshold", (shape, dtype, th, strided),
                         n0 + per)
        for causal in (True, False):
            mode = "causal" if causal else "bidirectional"
            out[f"sps_attention {arch} prefill B={ARCH_B} L={ARCH_S} "
                f"H={h}/{hkv} d_h={dh} {mode}"] = (
                "sps_attention",
                (ARCH_B, h, hkv, ARCH_S, dh, causal, None, 0, 0),
                int(causal))
        lens = (1, ARCH_S, 63, 64, 65, 127, 100, 2)
        out[f"sps_attention {arch} ragged prefill B={ARCH_B} L={ARCH_S} "
            f"H={h}/{hkv} d_h={dh} causal, lens {lens}"] = (
            "sps_attention", (ARCH_B, h, hkv, ARCH_S, dh, True, lens, 0, 0),
            0)
        out[f"paged_gather_decode {arch} {ARCH_SLOTS} slots H={h}/{hkv} "
            f"d_h={dh}, 12 blocks of 32, seeded lengths"] = (
            "paged_gather_decode", (ARCH_SLOTS, h, hkv, dh, 32, 12, 96), 1)
    return out


ARCH_CALLS = _arch_calls()

# gemma3-27b at full width (5:1 local:global periods: layer i is global
# when i % 6 == 5; local layers attend within a window of 1,024):
# d_model, query heads, KV heads, d_h, d_ff, window.  The static path runs
# the full depth (62 layers, 10 of them global): B = 4 prompts of 1,536
# tokens (6,144 rows at prefill), rings of 1,024 (local, wrapped) and
# 1,568 (global); the continuous path 12 of the 62 layers (two periods,
# 2 global): 8 slots, pages of 32, the local ring group of 32 blocks fully
# provisioned (256 pages), the global one of 68 blocks over 208 pages.
GEMMA = (5376, 32, 16, 128, 21504, 1024)
GEMMA_FULL, GEMMA_LAYERS = 62, 12
GEMMA_B, GEMMA_S, GEMMA_NEW, GEMMA_SLOTS = 4, 1536, 32, 8
GEMMA_ROW_TABLE = 512


def _globals(layers: int) -> int:
    """Global layers among gemma's first ``layers`` (i % 6 == 5)."""
    return (layers + 1) // 6


def _gemma_calls() -> Dict[str, tuple]:
    """Every call gemma3-27b's serve paths make, at its own shapes:
    (kernel, operands, launches per step of its path: a static decode step
    at M = 4 and the static prefill at the full depth, a pure-decode
    iteration at M = 8 at ``GEMMA_LAYERS``; M = 16 and the row table are
    timed beside them, launched by no gemma path)."""
    d, h, hkv, dh, ff, win = GEMMA
    g, q_dim = h // hkv, h * dh
    full, full_global = GEMMA_FULL, _globals(GEMMA_FULL)
    cut, cut_global = GEMMA_LAYERS, _globals(GEMMA_LAYERS)
    out = {}
    proj = {"wq": (q_dim, d, 1), "wo": (d, q_dim, 1),
            "wk/wv": (hkv * dh, d, 2), "w1/w3": (ff, d, 2), "w2": (d, ff, 1)}
    depth = {GEMMA_B: full, GEMMA_SLOTS: cut, 16: 0}
    for n in (GEMMA_B, GEMMA_SLOTS, 16):
        for call, (p, k, per) in proj.items():
            scheme = "and_dc" if call == "w2" else "xnor"
            tail = ", dc derived" if scheme == "and_dc" else ""
            out[f"rbmm_int gemma decode {call} ({n}x{k})x({p}x{k}) "
                f"{scheme}{tail}"] = ("rbmm_int", ((), n, p, k, scheme),
                                      per * depth[n])
    dhp = (dh + 31) // 32
    for ring, layers in ((win, full - full_global),
                         (GEMMA_S + GEMMA_NEW, full_global)):
        lead = f"{GEMMA_B},{hkv}"
        out[f"rbmm_int gemma decode ring score ({lead},{g},{dhp})x({lead},"
            f"{ring},{dhp}) xnor"] = (
            "rbmm_int", ((GEMMA_B, hkv), g, ring, dh, "xnor"), layers)
        out[f"rbmm_int gemma decode ring context ({lead},{g},"
            f"{-(-ring // 32)})x({lead},{dh},{-(-ring // 32)}) and_dc, dc "
            f"derived"] = ("rbmm_int", ((GEMMA_B, hkv), g, dh, ring,
                                        "and_dc"), layers)
    m = GEMMA_B * GEMMA_S
    for call, (p, k, per) in proj.items():
        out[f"rbmm_mxu gemma prefill {call} ({m}x{k})x({p}x{k})"
            f"{' {0,1}' if call == 'w2' else ''}"] = (
            "rbmm_mxu", (m, k, p, call == "w2"), per * full)
    for shape, dtype, th, strided, per in (
            ((m, d), "bfloat16", (), False, 2 * full),   # x, attn and FFN
            ((m, q_dim), "float32", (), False, full),    # ctx
            ((m, ff), "float32", (), False, full),       # h
            ((GEMMA_B, GEMMA_S, h, dh), "bfloat16", (h, 1), False, full),
            ((GEMMA_B, GEMMA_S, hkv, dh), "bfloat16", (hkv, 1), False,
             full),
            ((GEMMA_B, hkv, dh, GEMMA_S), "bfloat16", (hkv, 1, 1), True,
             full),
            ((GEMMA_SLOTS, 1, d), "float32", (), False, 2 * cut),
            ((GEMMA_SLOTS, 1, q_dim), "float32", (), False, cut),
            ((GEMMA_SLOTS, 1, ff), "float32", (), False, cut),
            ((GEMMA_SLOTS, 1, h, dh), "bfloat16", (h, 1), False, cut),
            ((GEMMA_SLOTS, 1, hkv, dh), "bfloat16", (hkv, 1), False, cut)):
        name = (f"pack gemma ({','.join(map(str, shape))}) "
                f"{DTYPE_TAGS[dtype]}{' strided' if strided else ''}, "
                f"{'one' if th == () else 'per-head'} theta")
        out[name] = ("pack_threshold", (shape, dtype, th, strided), per)
    for tag, window, rows, layers in (
            (f"window {win}", win, 0, full - full_global),
            ("full", 0, 0, full_global),
            (f"row table of {GEMMA_ROW_TABLE}", 0, GEMMA_ROW_TABLE, 0)):
        out[f"sps_attention gemma prefill B={GEMMA_B} L={GEMMA_S} "
            f"H={h}/{hkv} d_h={dh} causal, {tag}"] = (
            "sps_attention",
            (GEMMA_B, h, hkv, GEMMA_S, dh, True, None, window, rows), layers)
    cap_blocks = 68
    for tag, ring, nblk, pages, lo, layers, rows in (
            (f"local ring {win}, lengths {win}..{cap_blocks * 32}", win,
             win // 32, GEMMA_SLOTS * win // 32, win, cut - cut_global,
             0),
            (f"global ring {cap_blocks * 32} over 208 pages", cap_blocks * 32,
             cap_blocks, 208, 0, cut_global, 0),
            (f"local ring {win}, a row table gathered by position", win,
             win // 32, GEMMA_SLOTS * win // 32, win, 0, GEMMA_ROW_TABLE)):
        out[f"paged_gather_decode gemma {GEMMA_SLOTS} slots H={h}/{hkv} "
            f"d_h={dh}, pages of 32, {tag}"] = (
            "paged_gather_decode", (GEMMA_SLOTS, h, hkv, dh, 32, nblk, pages,
                                    ring, lo, cap_blocks * 32, rows), layers)
    return out


GEMMA_CALLS = _gemma_calls()


# the MoE archs at full width (repro_torch/configs) and the layers their
# card runs take: mixtral-8x22b serves 8 prompts of 512 tokens statically
# at its full depth (56 layers) and 8 slots with chunks of 512
# continuously and speculatively (k = 4: a verify of 8 x 5 rows) at 4 of
# its layers (``MOE_CUT``); arctic-480b (a dense residual FFN beside its
# experts) 8 prompts of 128 tokens statically at its full depth (35
# layers).  Capacity dispatch runs every expert at its capacity
# (``BinaryMoE.capacity``): mixtral 4 rows at a decode step (n = 8), 2,048
# at a prefill or a mixed iteration (n = 4,096), 20 at a verify (n = 40);
# arctic 1 and 32.
MOE_ARCHS = ("mixtral-8x22b", "arctic-480b")
MOE_CUT = 4
MOE_B, MOE_VERIFY = 8, 5
MOE_PREFILL = {"mixtral-8x22b": 512, "arctic-480b": 128}


def _moe_calls() -> Dict[str, tuple]:
    """Every expert-batched kernel call of the two MoE archs' serve paths
    (and arctic's dense residual FFN) at full width: (kernel, operands,
    launches per step of its path: a static decode step and prefill at the
    full depth, a verify at ``MOE_CUT`` layers)."""
    from repro_torch.configs import get_config
    from repro_torch.models.blocks import Block
    out = {}
    for arch in MOE_ARCHS:
        cfg = get_config(arch)
        moe = Block(cfg)._ffn()
        d, ff, e, name = cfg.d_model, cfg.d_ff, moe.num_experts, \
            arch.split("-")[0]
        steps = {"decode": MOE_B, "prefill": MOE_B * MOE_PREFILL[arch]}
        if name == "mixtral":
            steps["verify"] = MOE_B * MOE_VERIFY
        for step, n in steps.items():
            c = moe.capacity(n)
            layers = MOE_CUT if step == "verify" else cfg.num_layers
            proj = {"w1/w3": (ff, d, 2), "w2": (d, ff, 1)}
            for call, (p, kk, per) in proj.items():
                dims = (f"({e},{c},{(kk + 31) // 32})x({e},{p},"
                        f"{(kk + 31) // 32})")
                if c <= 16:     # the decode route of rbmm_int
                    scheme = "and_dc" if call == "w2" else "xnor"
                    tail = ", dc derived" if scheme == "and_dc" else ""
                    out[f"rbmm_int moe {name} {step} experts {call} {dims} "
                        f"{scheme}{tail}"] = (
                        "rbmm_int", ((e,), c, p, kk, scheme), per * layers)
                else:
                    out[f"rbmm_mxu moe {name} {step} experts {call} "
                        f"({e},{c},{kk})x({e},{p},{kk})"
                        f"{' {0,1}' if call == 'w2' else ''}"] = (
                        "rbmm_mxu", (c, kk, p, call == "w2", (e,)),
                        per * layers)
            for shape, dtype in (((e, c, d), "bfloat16"),
                                 ((e, c, ff), "float32")):
                out[f"pack moe {name} {step} experts "
                    f"({','.join(map(str, shape))}) {DTYPE_TAGS[dtype]}, one "
                    f"theta"] = ("pack_threshold", (shape, dtype, (), False),
                                 layers)
            if moe.dense_residual:  # the dense residual FFN on all n rows
                for call, (p, kk, per) in proj.items():
                    if n <= 16:
                        scheme = "and_dc" if call == "w2" else "xnor"
                        tail = ", dc derived" if scheme == "and_dc" else ""
                        out[f"rbmm_int moe {name} {step} residual {call} "
                            f"({n}x{kk})x({p}x{kk}) {scheme}{tail}"] = (
                            "rbmm_int", ((), n, p, kk, scheme), per * layers)
                    else:
                        out[f"rbmm_mxu moe {name} {step} residual {call} "
                            f"({n}x{kk})x({p}x{kk})"
                            f"{' {0,1}' if call == 'w2' else ''}"] = (
                            "rbmm_mxu", (n, kk, p, call == "w2"),
                            per * layers)
    return out


MOE_CALLS = _moe_calls()


# hymba-1.5b and xlstm-350m at full width and full depth
# (repro_torch/configs) and the shapes of their card runs: the static path
# (B prompts of S tokens, then decode steps at M = B on contiguous rings of
# min(window, S + new)) and the continuous path (16 slots, chunks of 128,
# pages of 32: 12 blocks over 48 pages, smollm's cell).
RECURRENT_STATIC = {"hymba-1.5b": (4, 1536, 32), "xlstm-350m": (8, 512, 32)}
RECURRENT_CELL = dict(slots=16, chunk=128, page=32, blocks=12, pages=48)


def _call_dims(kernel: str, spec: tuple) -> str:
    """The operands of a call of a ``recurrent_calls`` / ``encdec_calls``
    table, as its name reads them (RBMM and pack kernels)."""
    if kernel == "rbmm_int":
        lead, m, p, k, scheme = spec
        kp = -(-k // 32)
        return (f"({','.join(map(str, lead + (m,)))},{kp})"
                f"x({','.join(map(str, lead + (p,)))},{kp}) {scheme}")
    if kernel == "rbmm_binary":
        m, p, k = spec
        return f"({m}x{k})x({p}x{k}) xnor, packed bits and dc"
    if kernel == "rbmm_mxu":
        m, k, p, unsigned = spec
        return f"({m}x{k})x({p}x{k}){' {0,1}' if unsigned else ''}"
    shape, dtype, th, strided = spec
    per = {0: "one", 2: "per-head", 3: "per-row"}[len(th)]
    return (f"({','.join(map(str, shape))}) {DTYPE_TAGS[dtype]}"
            f"{' strided' if strided else ''}, {per} theta")


def _merge(rows: List[tuple]) -> List[tuple]:
    """[(call name, spec, launches)] with equal specs merged: the names
    joined by "/", the launches summed (in first-seen order)."""
    out: Dict[tuple, list] = {}
    for name, spec, n in rows:
        if spec in out:
            if name not in out[spec][0].split("/"):
                out[spec][0] += f"/{name}"
            out[spec][1] += n
        else:
            out[spec] = [name, n]
    return [(name, spec, n) for spec, (name, n) in out.items()]


def recurrent_calls(cfg, static, slots: int, chunk: int, page: int,
                    blocks: int, pages: int) -> Dict[str, tuple]:
    """Every kernel call of a hybrid or SSM arch's serve paths at ``cfg``'s
    widths: {name: (kernel, operands, launches per step of its path)}.
    The paths: ``prefill``, the static prefill of B = ``static[0]``
    prompts of S = ``static[1]`` tokens; ``decode``, a static decode step
    at M = B on contiguous rings of min(window, S + new); ``pure-decode``,
    a pooled decode iteration of ``slots`` rows on the paged pool (pages
    of ``page``, ``blocks`` a table row, ``pages`` in the arena);
    ``mixed``, a unified iteration at chunk width ``chunk``.  Names read
    ``"<kernel> <arch> <path> <calls> <dims>"``.  The recurrences
    themselves run no kernel of ours."""
    from repro_torch.models.attention import PageSpec
    from repro_torch.models.lm import layer_plan
    arch = cfg.name.split("-")[0]
    b, s, new = static
    d, h, hkv, dh = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                     cfg.resolved_head_dim)
    ff, g, qd, kvd = cfg.d_ff, h // hkv, cfg.q_dim, cfg.kv_dim
    di = cfg.ssm.expand * d
    cdt = cfg.compute_dtype
    kinds = [k for k, _ in layer_plan(cfg)]
    window = cfg.window_size
    ring_static = min(window or s + new, s + new)
    spec = PageSpec(page_size=page, max_blocks=blocks, num_pages=pages)
    ring_paged = spec.ring_for(window)
    nblk = spec.blocks_for_ring(ring_paged)
    arena = spec.arena_pages(ring_paged, slots)
    paths = {"prefill": (b, s), "decode": (b, 1), "pure-decode": (slots, 1),
             "mixed": (slots, chunk)}
    out: Dict[str, tuple] = {}

    def put(kernel, path, rows):
        for call, spec, n in _merge(rows):
            if kernel in ("rbmm_int", "rbmm_mxu", "pack_threshold"):
                dims = _call_dims(kernel, spec)
            elif kernel == "sps_attention":
                dims = (f"B={b} L={s} H={h}/{hkv} d_h={dh} causal, window "
                        f"{window or 'full'}")
            else:
                dims = (f"{slots} slots H={h}/{hkv} d_h={dh}, {nblk} blocks "
                        f"of {page} over {arena} pages")
            out[f"{kernel} {arch} {path} {call} {dims}".rstrip()] = (
                kernel, spec, n)

    for path, (n, width) in paths.items():
        m = n * width
        decode = width == 1
        xdt = "float32" if decode else cdt   # decode keeps f32 residuals
        proj, packs, attn = [], [], []
        for kind in kinds:
            dense = []
            if kind == "hybrid":
                dense += [("wq", qd, d), ("wk", kvd, d), ("wv", kvd, d),
                          ("wo", d, qd), ("in_proj", 2 * di, d),
                          ("out_proj", d, di), ("w1", ff, d),
                          ("w3", ff, d), ("w2", d, ff)]
                packs += [("x", ((n, width, d), xdt, (), False), 3),
                          ("ctx", ((n, width, qd), "float32", (), False),
                           1),
                          ("y", ((n, width, di), cdt, (), False), 1),
                          ("h", ((n, width, ff), "float32", (), False), 1),
                          ("q", ((n, width, h, dh), cdt, (h, 1), False), 1),
                          ("k", ((n, width, hkv, dh), cdt, (hkv, 1), False),
                           1)]
                if path == "prefill":
                    packs.append(("V^T", ((n, hkv, dh, width), cdt,
                                          (hkv, 1, 1), True), 1))
                    attn.append(("sps_attention", "attention", (
                        n, h, hkv, width, dh, True, None, window, 0)))
                elif path == "decode":
                    attn += [("rbmm_int", "ring score", (
                        (n, hkv), g, ring_static, dh, "xnor")),
                             ("rbmm_int", "ring context", (
                                 (n, hkv), g, dh, ring_static, "and_dc"))]
                elif path == "pure-decode":
                    attn.append(("paged_gather_decode", "attention", (
                        n, h, hkv, dh, page, nblk, arena, ring_paged, 0,
                        ring_paged, 0)))
                else:
                    w = nblk * page
                    attn += [("rbmm_int", "prefix score", (
                        (n, hkv), g * width, w, dh, "xnor")),
                             ("rbmm_int", "prefix context", (
                                 (n, hkv), g * width, dh, w, "and_dc")),
                             ("rbmm_int", "intra score", (
                                 (n, hkv), g * width, width, dh, "xnor"))]
                    packs += [("probs", ((n, hkv, g * width, w), "int32",
                                         (hkv, g * width, 1), False), 1),
                              ("V^T words", ((n, hkv, dh, width), "int32",
                                             (), True), 1)]
            elif kind == "mlstm":
                dense += [("qkv", 3 * di, d), ("out", d, di)]
            else:
                dense += [("in", 4 * di, d), ("out", d, di)]
            if kind != "hybrid":
                packs += [("x", ((n, width, d), xdt, (), False), 1),
                          ("hs", ((n, width, di), cdt, (), False), 1)]
            for call, p, k in dense:
                unsigned = call == "w2"
                if m <= 16:
                    proj.append((call, ((), m, p, k,
                                        "and_dc" if unsigned else "xnor"),
                                 1))
                else:
                    proj.append((call, (m, k, p, unsigned), 1))
        put("rbmm_int" if m <= 16 else "rbmm_mxu", path, proj)
        put("pack_threshold", path, packs)
        for kernel in ("rbmm_int", "sps_attention", "paged_gather_decode"):
            put(kernel, path, [(call, spec, 1) for kn, call, spec in attn
                               if kn == kernel])
    return out


def _recurrent_table() -> Dict[str, tuple]:
    """``recurrent_calls`` of both archs at full width and depth, and the
    paged decode on rings of the window (1,024; lengths past it, so
    wrapped), which no counted path of the card run takes (0 launches)."""
    from repro_torch.configs import get_config
    out = {}
    for arch, static in RECURRENT_STATIC.items():
        out.update(recurrent_calls(get_config(arch), static,
                                   **RECURRENT_CELL))
    cfg = get_config("hymba-1.5b")
    h, hkv, dh, w = (cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim,
                     cfg.window_size)
    slots, page = RECURRENT_CELL["slots"], RECURRENT_CELL["page"]
    out[f"paged_gather_decode hymba {slots} slots H={h}/{hkv} d_h={dh}, "
        f"a window ring of {w}, lengths {w}..{2 * w}"] = (
            "paged_gather_decode", (slots, h, hkv, dh, page, w // page,
                                    slots * w // page, w, w, 2 * w, 0), 0)
    return out


RECURRENT_CALLS = _recurrent_table()


# seamless-m4t-large-v2 (24 encoder and 24 decoder layers) and
# internvl2-76b (80 layers) at full width and depth (repro_torch/configs),
# and the shapes of their card runs: the static path only (B prompts of S
# tokens after F frontend embeddings, then decode steps at M = B on
# contiguous rings of S + new tokens, F + S + new for internvl2, whose
# rings hold the patches too).
ENCDEC_STATIC = {"seamless-m4t-large-v2": (4, 64, 32),
                 "internvl2-76b": (4, 64, 32)}


def encdec_calls(cfg, static) -> Dict[str, tuple]:
    """Every kernel call of a model's static serve path at ``cfg``'s widths
    and depth (an encoder-decoder, or a decoder-only model with or without
    a frontend, windowed layers and expert stacks included): {name:
    (kernel, operands, launches per step of its path)}.  The paths:
    ``prefill``, the static prefill of B = ``static[0]`` prompts of S =
    ``static[1]`` tokens after ``cfg.frontend_tokens`` F embeddings (an
    encoder-decoder encodes F frames, then its decoder prefills the
    prompt: causal self-attention, the memory built from the encoder's
    output, cross-attention over it); ``decode``, a static decode step at
    M = B (rings of S + new, F + S + new for a frontend model, a windowed
    layer's at most its window).  A MoE layer dispatches its n rows into
    (E, C) expert buffers (C = ``BinaryMoE.capacity(n)``) and runs each
    projection as one expert-batched call (``rbmm_int``'s decode route at
    C <= 16), arctic's dense residual FFN on the n rows beside it.  The
    residual stream's dtype follows the
    models: an encoder runs float32 (its frontend's projection is), a
    frontend model's prefill too (the patches promote it), the
    encoder-decoder's decoder runs ``compute_dtype``, a decoder-only
    decode float32.  Names read ``"<kernel> <arch> <path> <calls>
    <dims>"``."""
    from repro_torch.models.blocks import _ffn_from_cfg
    from repro_torch.models.lm import build_model, layer_plan
    arch = cfg.name.split("-")[0]
    b, s, new = static
    f = cfg.frontend_tokens
    d, h, hkv, dh = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                     cfg.resolved_head_dim)
    ff, g, qd, kvd = cfg.d_ff, h // hkv, cfg.q_dim, cfg.kv_dim
    cdt = cfg.compute_dtype
    encdec = type(build_model(cfg)).__name__ == "EncDecModel"
    rows: Dict[str, List[tuple]] = {}

    def call(kernel, path, name, spec, n=1):
        rows.setdefault(path, []).append((kernel, name, spec, n))

    def project(path, name, m, p, k, n=1):
        """A BinaryDense's product: ``rbmm_int``'s decode route at M <=
        16, ``rbmm_mxu`` above (an FFN's w2: {0,1} operands)."""
        unsigned = name.endswith("w2")
        if m <= 16:
            call("rbmm_int", path, name, ((), m, p, k, "and_dc" if unsigned
                                          else "xnor"), n)
        else:
            call("rbmm_mxu", path, name, (m, k, p, unsigned), n)

    def pack(path, name, shape, dtype, th=(), strided=False):
        call("pack_threshold", path, name, (tuple(shape), dtype, th,
                                            strided))

    def attention(path, n, length, xdt, causal, ring=0, window=0):
        """A self-attention block's calls over n rows of ``length``
        positions (one, against a ring of ``ring``, at decode; a windowed
        layer's ring holds its window)."""
        if window:
            ring = min(ring, window)
        pack(path, "x", (n, length, d), xdt)
        m = n * length
        for name, p in (("wq", qd), ("wk", kvd), ("wv", kvd)):
            project(path, name, m, p, d)
        pack(path, "q", (n, length, h, dh), cdt, (h, 1))
        pack(path, "k", (n, length, hkv, dh), cdt, (hkv, 1))
        if ring:
            call("rbmm_int", path, "ring score",
                 ((n, hkv), g, ring, dh, "xnor"))
            call("rbmm_int", path, "ring context",
                 ((n, hkv), g, dh, ring, "and_dc"))
        else:
            pack(path, "V^T", (n, hkv, dh, length), cdt, (hkv, 1, 1), True)
            call("sps_attention", path, "attention",
                 (n, h, hkv, length, dh, causal, None, window, 0))
        pack(path, "ctx", (n, length, qd), "float32")
        project(path, "wo", m, d, qd)

    def cross(path, n, length):
        """A "dec" layer's cross-attention over the memory of f frames
        (built at prefill from the float32 encoder output)."""
        if path == "prefill":
            pack(path, "memory", (n, f, d), "float32")
            for name in ("wk", "wv"):
                project(path, f"memory {name}", n * f, kvd, d)
            pack(path, "memory k", (n, f, hkv, dh), cdt, (hkv, 1))
            pack(path, "memory V^T", (n, hkv, dh, f), cdt, (hkv, 1, 1),
                 True)
        m, rows_ = n * length, g * length
        pack(path, "cross x", (n, length, d), cdt)
        project(path, "cross wq", m, qd, d)
        pack(path, "cross q", (n, length, h, dh), cdt, (h, 1))
        call("rbmm_int", path, "cross score",
             ((n, hkv), rows_, f, dh, "xnor"))
        if rows_ > 16:
            pack(path, "cross probs", (n, hkv, rows_, f), "int32",
                 (hkv, rows_, 1))
        call("rbmm_int", path, "cross context",
             ((n, hkv), rows_, dh, f, "and_dc"))
        pack(path, "cross ctx", (n, length, qd), "float32")
        project(path, "cross wo", m, d, qd)

    def experts(path, moe, m, xdt):
        """A MoE layer's expert-batched calls over m routed rows (the
        dense residual FFN's on the rows themselves)."""
        e, c = moe.num_experts, moe.capacity(m)

        def product(name, p, k):
            unsigned = name == "w2"
            if c <= 16:
                call("rbmm_int", path, f"experts {name}", (
                    (e,), c, p, k, "and_dc" if unsigned else "xnor"))
            else:
                call("rbmm_mxu", path, f"experts {name}", (c, k, p,
                                                           unsigned))
        if moe.dispatch_bits:
            pack(path, "experts x", (m, d), xdt)
        else:
            pack(path, "experts x", (e, c, d), xdt)
        product("w1", ff, d)
        product("w3", ff, d)
        pack(path, "experts h", (e, c, ff), "float32")
        product("w2", d, ff)
        if moe.dense_residual:
            pack(path, "residual x", (m, d), xdt)
            project(path, "residual w1", m, ff, d)
            project(path, "residual w3", m, ff, d)
            pack(path, "residual h", (m, ff), "float32")
            project(path, "residual w2", m, d, ff)

    def ffn(path, n, length, xdt):
        m = n * length
        if cfg.moe.num_experts:
            experts(path, _ffn_from_cfg(cfg), m, xdt)
            return
        pack(path, "ffn x", (n, length, d), xdt)
        if cfg.glu:
            project(path, "w1", m, ff, d)
            project(path, "w3", m, ff, d)
            pack(path, "h", (n, length, ff), "float32")
        elif m <= 16:      # F1 fused: the bits of ReLU(x W1) >= theta
            call("rbmm_binary", path, "F1", (m, ff, d))
        else:              # F1 on the tensor cores, thresholded after
            project(path, "F1", m, ff, d)
        project(path, "w2", m, d, ff)

    def layers(fn, count):
        """Repeat the calls ``fn`` adds ``count`` times (one per layer)."""
        before = {p: len(r) for p, r in rows.items()}
        fn()
        for p, r in rows.items():
            start = before.get(p, 0)
            r[start:] = [(k, nm, sp, n * count) for k, nm, sp, n in
                         r[start:]]

    if encdec:
        def encoder():
            attention("prefill", b, f, "float32", causal=False)
            ffn("prefill", b, f, "float32")
        layers(encoder, cfg.num_encoder_layers)

        def decoder(path, length, ring=0):
            attention(path, b, length, cdt, causal=True, ring=ring)
            cross(path, b, length)
            ffn(path, b, length, cdt)
        layers(lambda: decoder("prefill", s), cfg.num_layers)
        layers(lambda: decoder("decode", 1, s + new), cfg.num_layers)
    else:
        length = f + s
        xdt = "float32" if f else cdt   # the patches promote the stream

        def block(path, length, xdt, ring=0, window=0):
            attention(path, b, length, xdt, causal=True, ring=ring,
                      window=window)
            ffn(path, b, length, xdt)
        windows = [w for _, w in layer_plan(cfg)]
        for w in sorted(set(windows)):
            layers(lambda: block("prefill", length, xdt, window=w),
                   windows.count(w))
            layers(lambda: block("decode", 1, "float32", length + new, w),
                   windows.count(w))

    out: Dict[str, tuple] = {}
    for path, entries in rows.items():
        for kernel in ("rbmm_int", "rbmm_binary", "rbmm_mxu",
                       "pack_threshold", "sps_attention"):
            for name, spec, n in _merge([(nm, sp, n) for k, nm, sp, n
                                         in entries if k == kernel]):
                if kernel == "sps_attention":
                    bb, hh, hk, length, dd, causal, _, window, _ = spec
                    dims = (f"B={bb} L={length} H={hh}/{hk} d_h={dd} "
                            f"{'causal' if causal else 'bidirectional'}"
                            f"{f', window {window}' if window else ''}")
                else:
                    dims = _call_dims(kernel, spec)
                out[f"{kernel} {arch} {path} {name} {dims}"] = (kernel, spec,
                                                                 n)
    return out


def _encdec_table() -> Dict[str, tuple]:
    """``encdec_calls`` of both archs at full width and depth."""
    from repro_torch.configs import get_config
    out = {}
    for arch, static in ENCDEC_STATIC.items():
        out.update(encdec_calls(get_config(arch), static))
    return out


ENCDEC_CALLS = _encdec_table()


def path_launches(calls: Dict[str, tuple], arch: str,
                  path: str) -> Dict[str, int]:
    """Launches of each kernel per step of one path of a
    ``recurrent_calls`` table."""
    out: Dict[str, int] = {}
    for name, (kernel, _, n) in calls.items():
        if name.startswith(f"{kernel} {arch} {path} "):
            out[kernel] = out.get(kernel, 0) + n
    return out


def moe_rows(seed: int = 0, only: str = ""):
    """Each ``MOE_CALLS`` call (whose name matches ``only``), one at a time
    so the card holds one call's operands (arctic's experts unpacked to
    bf16 for the library's batched matmul take 8.9 GB): the kernel
    against its plain version (``equal``: bitwise), the kernel's and the
    library's device ms (``torch.bmm``/``matmul`` of the unpacked bf16
    operands; none for pack) and per-call ms with the host work, the
    bound, and the launches per step of its path.  Yields one row per
    call."""
    for name, spec in MOE_CALLS.items():
        if not re.search(only, name):
            continue
        (kernel, call, plain, lib, (b_ms, by)), = call_operands(
            {name: spec}, seed).values()
        got, want = call(), plain()
        equal = got.dtype == want.dtype and torch.equal(got, want)
        del got, want
        row = {"shape": name, "kernel": kernel, "equal": bool(equal),
               "step_launches": spec[2], "eager_ms": eager_ms(call, iters=10),
               "library_eager_ms": None if lib is None else eager_ms(
                   lib, iters=10),
               "ms": device_ms(call, iters=5),
               "library_ms": None if lib is None else device_ms(lib,
                                                                iters=5),
               "bound_ms": b_ms, "bound_by": by}
        del call, plain, lib
        torch.cuda.empty_cache()
        yield row


def shapes(seed: int = 0) -> Dict[str, Dict]:
    """Each shape: the kernel's call, the library call and the bound (and,
    for the speculative iteration's calls, the launches per iteration)."""
    from repro_torch.kernels.pack import ops as pack
    out = rbmm_shapes(seed)
    for name, (_, call, _, lib, bnd) in spec_operands(seed).items():
        out[name] = dict(kernel=call, library=lib, bound=bnd,
                         spec_launches=SPEC_CALLS[name][2])
    for name, (_, call, _, lib, bnd) in call_operands(ARCH_CALLS,
                                                      seed).items():
        out[name] = dict(kernel=call, library=lib, bound=bnd,
                         layer_launches=ARCH_CALLS[name][2])
    for name, (_, call, _, lib, bnd) in call_operands(GEMMA_CALLS,
                                                      seed).items():
        out[name] = dict(kernel=call, library=lib, bound=bnd,
                         step_launches=GEMMA_CALLS[name][2])
    for table in (RECURRENT_CALLS, ENCDEC_CALLS):
        for name, (_, call, _, lib, bnd) in call_operands(table,
                                                          seed).items():
            out[name] = dict(kernel=call, library=lib, bound=bnd,
                             step_launches=table[name][2])
    for name, (x, th) in pack_shapes(seed).items():
        res = pack.pack_threshold(x, th)
        out[name] = dict(
            kernel=lambda x=x, th=th: pack.pack_threshold(x, th),
            library=None,
            bound=work.bound_of(work.pack(x, th, res)))
    out.update(attention_shapes(seed))
    return out


def time_all(seed: int = 0, only: str = "") -> List[Dict]:
    """One row per shape (those whose name matches the regular expression
    ``only``).  The per-call times are all taken before the first profiler
    session, which would otherwise leave its tracing costs in the next
    loop."""
    todo = {n: s for n, s in shapes(seed).items() if re.search(only, n)}
    eager = {n: (eager_ms(s["kernel"]), None if s["library"] is None
                 else eager_ms(s["library"])) for n, s in todo.items()}
    rows = []
    for name, s in todo.items():
        b_ms, by = s["bound"]
        lib = s["library"]
        rows.append({"shape": name, "ms": device_ms(s["kernel"]),
                     "eager_ms": eager[name][0],
                     "bound_ms": b_ms, "bound_by": by,
                     "library_ms": None if lib is None else device_ms(lib),
                     "library_eager_ms": eager[name][1],
                     **{k: s[k] for k in ("spec_launches", "layer_launches",
                                          "step_launches") if k in s}})
    return rows


def host_trace(fn: Callable, iters: int = 50, top: int = 8) -> Dict:
    """Where one call's time goes on the host: the wall time per call of a
    loop with no sync inside (the host's enqueue rate; the card keeps up
    when it is the faster), and the traced host ops and runtime calls by
    self time per call (torch.profiler, host and card)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host = (time.perf_counter() - t0) / iters * 1e3
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        traced = (time.perf_counter() - t0) / iters * 1e3
        torch.cuda.synchronize()
    ev = prof.key_averages()
    ops = sorted(((e.key, e.self_cpu_time_total / iters / 1e3,
                   e.count / iters) for e in ev
                  if e.device_type == DeviceType.CPU), key=lambda t: -t[1])
    dev = sum(e.self_device_time_total for e in ev
              if e.device_type == DeviceType.CUDA) / iters / 1e3
    return {"host_ms_per_call": host, "traced_ms_per_call": traced,
            "device_ms_per_call": dev,
            "traced_op_ms_per_call": sum(t for _, t, _ in ops),
            "top_ops": [[k, round(t, 5), c] for k, t, c in ops[:top]]}


TRACED = ("rbmm_mxu prefill w1", "rbmm_binary F1", "rbmm_int F2",
          "rbmm_int decode wq/wo", "rbmm_int decode w2")


def decode_tiles(seed: int = 0, iters: int = 30) -> List[Dict]:
    """The decode kernel's device time at every decode call for the tiles
    around the rule's (``ops.decode_tile``): each lane count and load width
    at the rule's rows and warps, each warp count at the rule's rows, lanes
    and width, and every row block with the rule's lanes, half and twice
    them (the weights are read once per row block).  Every tile's output
    must equal the public wrapper's."""
    from repro_torch import kernels
    from repro_torch.kernels.rbmm import ops as rbmm
    gen = torch.Generator(device="cuda").manual_seed(seed)
    table = []
    for name, (lead, m, p, k, scheme) in decode_calls().items():
        kp = (k + 31) // 32
        a, b = (torch.randint(-2**31, 2**31, lead + (n, kp), generator=gen,
                              device="cuda", dtype=torch.int64).to(
                                  torch.int32) for n in (m, p))
        batch = int(np.prod(lead, dtype=np.int64))
        want = rbmm.rbmm_int(a, b, k, scheme=scheme)
        rule = rbmm.decode_tile(batch, m, p, kp)
        rows, lanes, warps, vec = rule
        tiles = sorted(
            {(rows, g, warps, v) for g in (1, 2, 4, 8, 16, 32)
             for v in (1, 2, 4) if kp % v == 0} |
            {(rows, lanes, w, vec) for w in (1, 2, 4, 8)} |
            {(r, g, warps, vec) for r in rbmm.DECODE_ROWS
             for g in (max(1, lanes // 2), lanes, min(32, 2 * lanes))})
        out = torch.empty_like(want)

        def run(tile):
            kernels.launch("cobra_rbmm_int", rbmm._ARGTYPES, a.device,
                           a.data_ptr(), b.data_ptr(), None, batch, m, p, kp,
                           k, rbmm.SCHEMES.index(scheme), *tile,
                           out.data_ptr())
        for tile in tiles:
            out.zero_()
            run(tile)
            if not torch.equal(out, want):
                raise AssertionError(f"decode tile {tile} at {name} differs "
                                     f"from the wrapper")
            table.append(dict(shape=name, rows=tile[0], lanes=tile[1],
                              warps=tile[2], vec=tile[3], rule=tile == rule,
                              ms=device_ms(lambda: run(tile), iters)))
    return table


def ksteps(seed: int = 0) -> List[Dict]:
    """The int8 mainloop's cost per K-step: rbmm_binary's device time at
    one block (128 x 192) and at F1's grid against Kp (4 words a step)."""
    from repro_torch.kernels.rbmm import ops as rbmm
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rows = []
    for m, p in ((128, 192), (M_ENC, D_ENC)):
        for kp in (4, 8, 24, 48, 96):
            a, b = (torch.randint(-2**31, 2**31, (n, kp), generator=gen,
                                  device="cuda", dtype=torch.int64).to(
                                      torch.int32) for n in (m, p))
            th = torch.zeros(p, dtype=torch.int32, device="cuda")
            rows.append({"kernel": "rbmm_binary", "m": m, "p": p, "kp": kp,
                         "ms": device_ms(lambda: rbmm.rbmm_binary(
                             a, b, 32 * kp, th, pack_output=True))})
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trace", action="store_true",
                    help="trace the host side of the tensor-core kernels")
    ap.add_argument("--ksteps", action="store_true",
                    help="time the int8 mainloop against its K-steps")
    ap.add_argument("--tiles", action="store_true",
                    help="time the decode kernel's tiles around its rule")
    ap.add_argument("--moe", action="store_true",
                    help="check and time the MoE archs' expert-batched "
                    "calls (MOE_CALLS), one at a time")
    ap.add_argument("--only", default="",
                    help="time only the shapes whose name matches this "
                    "regular expression")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("kernel_times: needs a CUDA card")
    if args.ksteps:
        for row in ksteps():
            print(json.dumps(row), flush=True)
        return 0
    if args.tiles:
        for row in decode_tiles():
            print(json.dumps(row), flush=True)
        return 0
    if args.trace:
        for name, s in rbmm_shapes().items():
            if name.startswith(TRACED):
                print(json.dumps({"shape": name, **host_trace(s["kernel"])}),
                      flush=True)
        return 0
    if args.moe:
        for row in moe_rows(only=args.only):
            print(json.dumps(row), flush=True)
        return 0
    for row in time_all(only=args.only):
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
