#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure is an uncaught exception and a non-zero exit:

  1. device     the card's name and power limit (nvidia-smi)
  2. build      nvcc builds every kernel of ``src/repro_torch/csrc``
  3. kernels    each kernel against its plain PyTorch version on the card,
                at the main-path shapes, at every shape the encode phase
                and chunked prefill give it, at ragged shapes and, for the
                tensor-core kernels, at their tile edges and K-step counts;
                both routes of ``rbmm_int`` (also at every decode call of
                smollm-135m at M = 8 and 16, M of 1 to 17, Kp of 1 to 256
                with pad bits set and bases off 16 bytes) and every layout of
                ``pack_threshold``; ``sps_attention`` at its query and key
                tile edges in both masks, G = 16 and d_h = 256;
                ``paged_gather_decode`` with more pages than warps, G = 16,
                d_h = 256 and pages of 256; every call of the speculative
                iteration at its exact shape; ``sps_attention`` with
                per-sequence key lengths (``lens``: 1, L, tile edges +-1,
                0); every call of granite-3-2b's and qwen1.5-32b's serve
                paths at full width (``kernel_times.ARCH_CALLS``: decode
                projections up to Kp = 856 words, prefill projections up
                to K = 27,392, d_h = 128 with G = 1) and of gemma3-27b's
                (``kernel_times.GEMMA_CALLS``); ``sps_attention`` with a
                causal window (1, 31, 32, 33, 1,024 at L = 64, 1,100,
                1,536; with ``lens``) and an (H, 512) row table at L =
                600; ``paged_gather_decode`` with a row table's
                thresholds gathered by position on wrapped rings of
                1,024; integer and float32 outputs
                must be bitwise equal; every expert-batched call of
                mixtral-8x22b's and arctic-480b's serve paths at full
                width (``kernel_times.MOE_CALLS``: ``rbmm_int``'s decode
                route over 8 and 128 experts, ``rbmm_mxu`` batched over
                experts at M = 2,048, 20 and 32 per expert,
                ``pack_threshold`` on (E, C, d) buffers; arctic's dense
                residual), one call's operands at a time, bitwise, with
                device and per-call times, the bound, the library's
                batched matmul and the launches per step; every call of
                hymba-1.5b's and xlstm-350m's serve paths at full width
                (``kernel_times.RECURRENT_CALLS``), bitwise; CUDA-event
                timings of kernel, plain
                version and (where one exists) the one PyTorch call
                computing the same function; then
                ``repro_torch.launch.kernel_times`` at the main-path shapes
                of the RBMM, pack and attention kernels
  4. serve      full-width smollm-135m (random weights from a seed) serves
                8 prompts of 128 tokens, 32 greedy tokens each, through
                ``ServeEngine.generate``, its decode step a replayed CUDA
                graph (captured by a first, untimed call on the same
                engine; captures, capture time and graph pool printed);
                the launch count of every kernel of the static path must
                move during that run, and each replay must credit the
                launches of the eager step; a test-local eager loop of
                ``decode_step`` from the same state gives equal tokens and
                bitwise-equal logits (eager and graphed ms per step);
                100 replays allocate nothing; a profile of one replay
                with each of our kernels' device ms
  5. continuous the same model serves a 24-request trace through
                ``ServeEngine.serve`` on a page arena a quarter of full
                provisioning (16 slots, 12 blocks of 32, 48 pages, prefix
                sharing, chunks of 128), every step a replayed graph: a
                first serve of the trace captures them, the timed second
                one captures nothing and gives the same tokens;
                at least one preemption and one prefix hit, every budget
                served, the launch counts of the paged path's kernels
                move, exactly one ``paged_gather_decode`` per layer in
                every pure-decode iteration; iteration times, page
                statistics and a profile of one pure-decode replay with
                each of our kernels' device ms; then the unified and
                decode graphs against eager steps from the same paged
                state (live rows' logits bitwise, pages and lengths)
  5b. speculative
                the same trace and engine with speculative decode (k = 4,
                a one-layer draft on the trunk's weights), served twice
                on one engine (the first serve captures one unified and
                one spec graph), every budget served, every spec
                iteration one replay with the launches of
                ``kernel_times.SPEC_CALLS``; acceptance, tokens per step,
                rollback frees, preemptions, ms per spec iteration, a
                profile of one spec replay; then the unified and spec
                graphs against eager steps from the same paged state
                (greedy and top_k), and the draft's rings after each
                rollback against a draft that ingested only the committed
                tokens; the bf16 tokens against phase 5's, beside the
                plain engine's own on a roomier arena (in bf16 tokens
                follow the schedule); and the gate: in float32 the same
                trace and engine give equal tokens by rid plainly and
                speculatively
  6. crosscheck the same model in float32 on the card and on the CPU
                (plain versions): static B=2, S=32, 4 tokens with equal
                greedy tokens and logits within a stated tolerance; then
                4 requests continuously on 2 slots and a 3-page arena,
                plainly and speculatively, with equal tokens by rid and
                equal page, engine and spec counters, the speculative
                tokens equal to the plain ones; a full-depth draft on the
                card accepts every draft
  7. encode     full-width bert-base-cobra (random weights from a seed,
                bf16) encodes B=8 x 512 tokens through
                ``LMModel.prefill_logits`` captured as one CUDA graph
                (``graphs.prefill_logits_graph``; its logits bitwise
                equal to the eager forward's): exactly 48 ``rbmm_binary``,
                48 ``rbmm_int`` and 12 ``sps_attention`` launches per
                replay and every kernel of the path launched; ms per
                replay and per eager forward, tokens/s, device busy share
                of one replay, peak memory and the top kernels; then
                float32 card vs CPU at B=2, S=64 with equal argmax and
                logits within a stated tolerance

  8. granite   full-width, full-depth granite-3-2b (40 layers, bf16,
                random weights from a seed): phase 4's static serving
                (``[granite]`` lines, graph == eager), the ragged
                whole-prompt prefill (8 rows of 1 to 128 tokens: each
                row's rings bitwise equal to its own unpadded prefill,
                logits within a stated tolerance), then phase 5's
                continuous paged serving (``[granite continuous]``: a
                preemption, a prefix hit, 40 ``paged_gather_decode`` per
                pure-decode iteration, graphs == eager)
  9. qwen       qwen1.5-32b at full width and depth (64 layers, its
                deploy params built block by block by ``init_deploy``,
                whose first 8 blocks equal the 8-layer build's): static
                serving and the ragged prefill as in phase 8 (``[qwen]``;
                the launches per prefill and per decode step equal
                ``kernel_times.encdec_calls``' per-layer calls times the
                depth; ``[qwen full depth]``: the build's seconds, GiB and
                peak, prefill and decode ms), then continuous serving on
                the first 8 blocks (``truncate_deploy``, ``[qwen
                continuous]``): d_h = 128, G = 1, the QKV bias and the
                untied 152,064-wide head through every kernel
  10. crosscheck
                a narrow qwen-shaped config (2 layers, d = 256, 2 heads of
                d_h = 128, G = 1, the QKV bias drawn off zero) in float32
                on the card and on the CPU: equal greedy tokens, logits
                within a stated tolerance
  11. gemma    gemma3-27b at full width and depth (62 layers in 5:1
                local:global periods; bf16, random weights from a seed):
                static serving of 4 prompts of 1,536 tokens (``[gemma]``:
                the local layers' rings of 1,024 wrap, graph == eager,
                the launches of ``encdec_calls``), the ragged windowed
                prefill (8 rows of 1 to 1,536 tokens, each row's local
                and global rings equal to its own prefill's), ``[gemma
                full depth]``; then on the first 12 blocks (two periods,
                equal to the 12-layer build's) continuous paged serving
                of a 16-request
                trace on two ring groups (``[gemma continuous]``: 8
                slots, chunks of 512, prefix hits and preemptions by
                group, graphs == eager) and the same trace
                speculatively (``[gemma speculative]``: a one-layer
                draft whose ring wraps; a spec replay against the eager
                iteration on wrapped draft rings)
  12. crosscheck
                a narrow gemma-shaped config (6 layers at 5:1, window
                64, G = 2, d_h = 128, the GELU GLU) and a ``row``
                configuration (smollm's widths, 2 layers, a seeded
                lambda table, prompts across position 511) in float32
                on the card and on the CPU: statically (tokens equal,
                logits within a stated tolerance), continuously and
                speculatively (tokens by rid and counters equal)

  13. mixtral  first ``init_deploy`` == ``convert(init)`` bitwise on the
                card for mixtral cut to 2 layers at full width
                (``[init_deploy]``); then mixtral-8x22b at full width (d
                = 6,144, 48/8 heads of d_h = 128, d_ff = 16,384, 8
                experts top-2 at capacity factor 2, a window of 4,096,
                the untied head over 32,768) and depth (56 layers; bf16,
                random weights from a seed): static serving of 8 prompts
                of 512 tokens (``[mixtral]``, graph == eager, the
                launches of ``encdec_calls``) and the expert weights'
                share of a decode step, ``[mixtral full depth]``; then on
                the first 4 blocks (equal to the 4-layer build's)
                continuous paged serving of
                phase 11's trace and engine shape (``[mixtral
                continuous]``: each pure-decode iteration launches 7
                ``rbmm_int`` a layer and no ``rbmm_mxu``, each mixed one 7
                ``rbmm_mxu`` a layer; graphs == eager) and the same
                speculatively (``[mixtral speculative]``: k = 4, a
                one-layer draft, graph == eager); the claims dropped in
                the eager runs of each iteration kind
  14. arctic   arctic-480b at full width (d = 7,168, 56/8 heads, d_ff =
                4,864, 128 experts top-2 and the dense residual FFN) and
                depth (35 layers: ~57 GiB of deploy params, drawn and
                packed expert by expert): static serving of 8 prompts of
                128 tokens (``[arctic]``, graph == eager, the launches of
                ``encdec_calls``), the expert weights' share of a decode
                step, the drops, ``[arctic full depth]``
  15. crosscheck
                the mixtral and arctic smoke configs (float32, dropless)
                on the card and on the CPU: static tokens equal and
                logits within a stated tolerance, continuous and
                speculative tokens by rid and counters equal,
                speculative == plain; then the smoke mixtral at capacity
                factor 0.5 statically (claims dropped): tokens, logits
                and the drops equal
  16. hymba    hymba-1.5b at full width and full depth (32 layers, each an
                attention with a 1,024-token window and a Mamba branch of
                state 16, averaged, then the SiLU GLU; bf16, random
                weights from a seed): static serving of 4 prompts of
                1,536 tokens (``[hymba]``: the rings wrap, graph ==
                eager, the prefill's and each decode step's launches
                equal ``kernel_times.RECURRENT_CALLS``'); on its first
                8 layers, continuous paged serving of phase 5's trace
                and engine shape (``[hymba continuous]``: every
                pure-decode and mixed iteration at
                the table's launches, graphs == eager with the carries
                and an inactive row's frozen, a second serve equal) and
                the same with ``spec_decode=4`` requested (``[hymba
                speculative]``: plain decode, the same tokens, no spec
                iteration); the recurrences' device ms, kernels and
                capture seconds alone within a decode step and a mixed
                iteration (``recurrence_ms``)
  17. xlstm    xlstm-350m at full width and depth (20 mLSTM and 4 sLSTM
                layers, no attention): static B=8 x 512 (``[xlstm]``);
                on its first 6 layers (5 mLSTM, 1 sLSTM), continuous on
                the paged pool (no arena) and on contiguous rings
                (``[xlstm continuous paged|contiguous]``, equal tokens),
                ``spec_decode=4`` requested, the same checks
  18. crosscheck
                the hymba and xlstm smoke configs (float32) on the card
                and on the CPU: static tokens equal and logits within a
                stated tolerance, continuous tokens by rid and counters
                equal, plainly and with ``spec_decode=4`` requested
  19. seamless seamless-m4t-large-v2 at full width and depth (24
                bidirectional encoder layers over 1,024 frames, 24 decoder
                layers with cross-attention over the binary memory, the
                ReLU FFN; bf16, random weights from a seed): static
                serving of B=4 x 64 prompt tokens with (4, 1,024, 1,024)
                frame embeddings from the seed, 32 new (``[seamless]``:
                the prefill's and each decode step's launches equal
                ``kernel_times.ENCDEC_CALLS``', the fused F1
                ``rbmm_binary`` among them; the decode step a replayed
                graph, bitwise equal to the eager step, caches included);
                ``prefill_logits`` as one graph equal to the eager
                forward; the encoder's ms alone; the memories' bytes
                against bf16
  20. internvl2
                internvl2-76b at full width and depth (80 layers), 1,024
                patch embeddings before each prompt (``[internvl2]``), the
                same checks, ``[internvl2 full depth]``
  21. crosscheck
                both smoke configs (float32) on the card and on the CPU:
                greedy tokens equal, logits within a stated tolerance, the
                static engines' tokens equal; seamless over memories of 8
                and 40 frames

  22. train    smollm-135m at full width and depth trains through the
                port's ``launch/train.py`` (``build`` and ``ft.run``:
                AdamW at lr 3e-3 with warmup-cosine, the synthetic bigram
                stream of B=16 x 128 tokens, bf16 compute, float32 masters
                and moments, remat per block), 30 steps with a checkpoint
                every 10: losses finite and falling, ms per step,
                tokens/s, peak memory, one profiled step's busy share and
                top kernels (``[train]``); a fresh trainer restarts from
                the step-10 checkpoint (restored bitwise against the
                manifest's sha256) and runs to step 30 with the
                uninterrupted run's losses (``[train restart]``); a narrow
                float32 config trains 3 steps on the card and on the CPU
                from one init (``[train card==cpu]``); the trained
                full-width params convert and serve 8 prompts of the
                stream greedily through the Hopper kernels, the decode
                step a graph replay (``[train serve]``), and the narrow
                model's QAT logits equal its deploy logits on the card;
                the captured step donates its state (peak memory logged)
  23. train families
                one cell per family trains 10 steps at full width
                through ``ft.run`` with the CLI's optimizer, one captured
                step that donates its state (``[train-mixtral]``:
                mixtral-8x22b, 1 of 56 layers, B=4 x 128;
                ``[train-hymba]``, 8 of 32 layers, and ``[train-xlstm]``,
                6 of 24 (5 mLSTM, 1 sLSTM), B=8 x 64;
                ``[train-seamless]`` at full depth, B=4 x 128 after
                1,024 frames): losses finite, one capture, the new leaves'
                gradients (router, experts, a_log, dt_bias, f_bias,
                w_gates, cross-attention's wq, the encoder's lambdas)
                finite and nonzero after the first step; ms per step,
                tokens/s, peak memory, kernels in the captured step; then
                each cell's params convert and serve 4 prompts of its
                stream, 16 greedy tokens, through the Hopper kernels (the
                ``[... serve]`` lines, as phase 4's); the smoke configs of
                mixtral (capacity factor 1.25: claims drop), arctic,
                hymba, xlstm and seamless (float32) train 3 steps on the
                card and on the CPU from one init and the card on to 20
                (``[train-families card==cpu]``: losses, params, the loss
                falling), and mixtral's, hymba's and xlstm's QAT logits
                equal their deploy logits on the card
                (``[train-families qat==deploy]``)
  24. train on a mesh
                a one-rank NCCL world in this process (an in-memory
                store) and a (1, 1) (data, model) mesh: smollm-135m at
                full width and depth, the CLI's optimizer, B=16 x 128,
                seed 0, trains 10 steps with the mesh trainer (eager; its
                compute split along "model" as on any mesh, every exchange
                the identity at a width of one) and
                10 with the one-device eager trainer from the same init,
                in turns, under deterministic algorithms: losses, params and
                moments bitwise equal; ms per mesh step beside the
                one-device eager and captured steps', collectives per
                step, peak memory (``[train-mesh]``); ``allreduce_1bit``
                of every leaf of a gradient over the NCCL world (its sign
                bits packed by the pack kernel; every packed word equal
                to the plain version, every result to the plain path);
                the trained params, gathered whole, serve through the
                Hopper kernels as phase 22's do (``[train-mesh serve]``)
  25. dryrun   the dry run (``repro_torch.launch.dryrun``) held to the
                card: smollm-135m's static decode step (B = 8, phase 4's
                cache) traced on meta gives the launches per kernel that
                one eager step on the card counts, exactly, and the dense
                FLOPs that ``FlopCounterMode`` counts over it; the train
                face at phase 24's size traced on a (1, 1)
                ``AbstractMesh`` gives the mesh trainer's state bytes,
                exactly, and its traced arguments + temp lie within 20%
                of the measured peak of one eager mesh step (less the
                memory resident beside it); on phase 24's one-rank NCCL
                (1, 1) mesh the mesh ``prefill_logits`` (split along
                "model" by the sequence as on any mesh: the rank's block
                of the positions on whole 1-bit weights, attention on its
                heads through all-to-alls of packed bits) and
                ``decode_step`` (its compute split along "model" as on
                any mesh: each product on the rank's block of its weight,
                attention on its heads, the embedding and the head on
                vocabulary blocks; every exchange the identity at a width
                of one) equal the one-device ones bitwise, and
                greedy decoding through the mesh ``decode_step`` gives
                phase 4's tokens; each compared step's roofline
                ``step_time_s`` is at most its measured device time; and
                every arch x shape cell on the single-pod production
                mesh (traced by ``DRY_WORKERS`` CPU workers beside this
                phase's checks, after the last host-timed phase, so that
                no host-timed number runs beside them; the multi-pod mesh
                is the CLI's, ``--mesh both``) is OK or SKIP, one line per
                cell (``[dryrun]``); the train_4k cells against the mesh
                trainer's before its compute was split along "model"
                (``DRY_UNSPLIT``): qwen1.5-32b's, gemma3-27b's,
                granite-3-2b's, internvl2-76b's and seamless-m4t-large-v2's
                arguments + temp and dense FLOPs a rank fall at least 8x,
                fit 80 GB (under 74.5 GiB), and their collective bytes a
                step (a reduce-scatter's by its input) do not grow, but
                for granite-3-2b's and seamless-m4t-large-v2's, which do
                and are held to this slice's figures
                (``DRY_COLL_GROWN``); no other train cell's arguments + temp
                grows (``[dryrun split]``); against the cells before the
                decode step was split (``DRY_GATHERED``): the collective
                bytes a rank and step of the decode_32k cells of
                ``DRY_DECODE_SPLIT`` and the long_500k cells of
                ``DRY_LONG_SPLIT`` fall at least 10x, those decode_32k
                cells' dense FLOPs and ``rbmm_int`` word ops a rank at least
                8x (arctic-480b's FLOPs held to this slice's figure: its
                router computes whole, ``DRY_FLOPS_WHOLE``), hymba-1.5b's and
                xlstm-350m's decode and long_500k bytes at least 2x, no
                decode or long_500k cell's arguments + temp grows, and the
                train cells and the prefill cells of the archs that
                compute whole equal them (``[dryrun decode]``); the
                prefill_32k cells of ``DRY_PREFILL_SPLIT`` against them
                and against the kernels' work before the prefill was split
                (``DRY_PREFILL_SPLIT``): arguments + temp a rank fall at
                least 4x, dense FLOPs and ``rbmm_mxu``'s and
                ``sps_attention``'s work a rank at least 8x, collective
                bytes a rank at most 1.25x (smollm-135m's held to this
                slice's figure, ``DRY_PREFILL_COLL_HELD``), ``step_time_s``
                falls (``[dryrun prefill]``); the sps_attention kernel on
                the operands the split hands it (a rank's query heads cut
                by KV group, a span starting inside one, the row table
                sliced to them) equals its plain version, bitwise
                (``[dryrun prefill kernels]``); the MoE cells of
                ``DRY_MOE`` against ``DRY_GATHERED`` (each rank routes and
                runs its own positions): mixtral-8x22b's and
                arctic-480b's prefill_32k arguments + temp a rank fall at
                least 20x and 10.6x and fit, their ``rbmm_mxu`` work
                falls at least 8x and their collective bytes stay within
                1.05x; their train_4k arguments + temp fall at least 16x
                and 8x, dense FLOPs at least 8x, collective bytes to at
                most 0.5x and 0.25x; every ``step_time_s`` falls
                (``[dryrun moe]``); on the NCCL (1, 1) mesh mixtral-8x22b
                at full width, cut in depth, trains one step's gradient
                and prefills bitwise as one device does (``[dryrun moe
                mesh]``), each rank's MoE rows of one block of
                mixtral-8x22b and arctic-480b on a simulated (1, 4) mesh
                equal one device's rows bitwise (``[dryrun moe ranks]``),
                and ``rbmm_mxu`` on expert groups' buffers equals its
                plain version (``[dryrun moe kernels]``); the
                sweep ends with the script
The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.  Without a CUDA card the
script exits non-zero and prints no result.
"""
from __future__ import annotations

import collections
import dataclasses
import hashlib
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.launch.kernel_times import (  # noqa: E402
    ARCH_CALLS, BF16_FLOPS, ENCDEC_CALLS, ENCDEC_STATIC,
    GEMMA_CALLS, GEMMA_LAYERS, HBM_BYTES_PER_S, INT8_OPS,
    MOE_CALLS, MOE_CUT, RECURRENT_CALLS, RECURRENT_CELL, RECURRENT_STATIC,
    SCALAR32_OPS, bound, call_operands, decode_calls, device_ms,
    eager_ms, encdec_calls, moe_rows, nbytes, paged_bound, path_launches,
    recurrent_calls, spec_launches, spec_operands, sps_bound, time_all)

SEED = 0


def log(msg: str) -> None:
    print(msg, flush=True)


def digest(obj) -> str:
    """A short digest of a JSON-able value (generated tokens), so two
    checkouts' runs compare token for token."""
    return hashlib.sha256(json.dumps(obj).encode()).hexdigest()[:16]


# -- timing and bounds --------------------------------------------------------


def device_profile(fn, iters: int, warm: bool = True, host: bool = False):
    """Run fn ``iters`` times under torch.profiler (after one warm call,
    unless ``warm`` is False); returns (device ms per call summed over
    every CUDA kernel, kernel launches per call, {kernel name: device ms
    per call}).  With ``host`` the host side is traced too and a fourth
    item lists the host ops by self time: [(op, ms per call, calls per
    call)], most expensive first (tracing inflates host times, so read
    them as shares)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    if warm:
        fn()
    torch.cuda.synchronize()
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host else [])
    with profile(activities=acts) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    by_name = {e.key: e.self_device_time_total / iters / 1e3
               for e in kernels}
    out = (sum(by_name.values()), sum(e.count for e in kernels) / iters,
           by_name)
    if not host:
        return out
    ops = sorted(((e.key, e.self_cpu_time_total / iters / 1e3,
                   e.count / iters) for e in events
                  if e.device_type == DeviceType.CPU), key=lambda t: -t[1])
    return out + (ops,)


# each of our kernels' CUDA functions carries the stem of its name
KERNEL_STEMS = {"pack_threshold": "pack_", "rbmm_int": "rbmm_int",
                "rbmm_binary": "rbmm_binary", "rbmm_mxu": "rbmm_mxu",
                "sps_attention": "sps_attention",
                "paged_gather_decode": "paged_gather_decode"}


def our_kernels_ms(by_name) -> dict:
    """Device ms of each of our kernels, whatever its rank, from a
    profile's {CUDA kernel name: ms}."""
    return {n: round(sum(ms for k, ms in by_name.items() if stem in k), 4)
            for n, stem in KERNEL_STEMS.items()}


# -- phase 1 and 2 ------------------------------------------------------------


def phase_device_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        check=True).stdout.strip()


def phase_device() -> str:
    import torch
    smi = phase_device_line()
    log(smi)
    log(f"[device] {torch.cuda.get_device_name(0)}, torch {torch.__version__}"
        f", CUDA {torch.version.cuda}, {torch.cuda.device_count()} card(s)")
    return smi


def phase_build() -> None:
    from repro_torch import kernels
    t0 = time.perf_counter()
    lib = kernels.build()
    kernels.library()
    log(f"[build] {lib.relative_to(ROOT)} in "
        f"{time.perf_counter() - t0:.1f} s")


# -- phase 3: kernels ---------------------------------------------------------


def _words(rng, shape, k):
    """Random packed words for k true values per row (zero pad bits; every
    bit random when k is None)."""
    import torch
    w = rng.integers(0, 2**32, shape, dtype=np.uint64).astype(np.uint32)
    pad = 0 if k is None else w.shape[-1] * 32 - k
    if pad:
        w[..., -1] &= np.uint32((1 << (32 - pad)) - 1)
    return torch.from_numpy(w.view(np.int32)).cuda()


def _pm1(rng, shape, unsigned=False):
    import torch
    bits = rng.integers(0, 2, shape)
    vals = bits if unsigned else 2 * bits - 1
    return torch.from_numpy(vals.astype(np.float32)).cuda().to(
        torch.bfloat16)


def _same(name: str, case: str, got, want) -> float:
    import torch
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{name} [{case}]: kernel gave "
                             f"{tuple(got.shape)} {got.dtype}, plain "
                             f"version {tuple(want.shape)} {want.dtype}")
    err = (got.double() - want.double()).abs().max().item() \
        if got.numel() else 0.0
    if not torch.equal(got, want):
        raise AssertionError(f"{name} [{case}]: kernel differs from its "
                             f"plain version, max |diff| {err}")
    return err


def _same_call(name: str, case: str, got, want) -> None:
    """``_same`` of a call's result, element by element where the call
    returns a tuple (``rbmm_binary``: the bits and the DC RETURN)."""
    if isinstance(got, tuple):
        for i, (a, b) in enumerate(zip(got, want)):
            _same(name, f"{case} [{i}]", a, b)
    else:
        _same(name, case, got, want)


def check_pack(rng):
    import torch
    from repro_torch.kernels.pack import ops, ref
    f = lambda x, th: (ops.pack_threshold(x, th), ref.pack_threshold(x, th))
    cases = {
        "ragged K=100 f32 per-column":
            (torch.randn(37, 100, device="cuda"),
             0.3 * torch.randn(100, device="cuda")),
        "int32 per-column":
            (torch.randint(-50, 50, (37, 100), device="cuda",
                           dtype=torch.int32),
             torch.randint(-5, 5, (100,), device="cuda",
                           dtype=torch.int32)),
        "bf16 per-head d_h=48":
            (torch.randn(5, 7, 3, 48, device="cuda").to(torch.bfloat16),
             0.2 * torch.randn(3, 1, device="cuda")),
        "strided V^T view":
            (torch.randn(2, 77, 3, 48, device="cuda").permute(0, 2, 3, 1),
             0.2 * torch.randn(3, 1, 1, device="cuda")),
        # the encode path's shapes: bert-base, B=8 x 512 tokens
        "encode x (8, 512, 768) bf16":
            (torch.randn(8, 512, 768, device="cuda").to(torch.bfloat16),
             torch.zeros((), device="cuda")),
        "encode x (8, 512, 768) f32":
            (torch.randn(8, 512, 768, device="cuda"),
             torch.zeros((), device="cuda")),
        "encode per-head q/k (8, 512, 12, 64) bf16":
            (torch.randn(8, 512, 12, 64, device="cuda").to(torch.bfloat16),
             0.2 * torch.randn(12, 1, device="cuda")),
        "encode strided V^T (8, 12, 64, 512) bf16":
            (torch.randn(8, 512, 12, 64, device="cuda").to(
                torch.bfloat16).permute(0, 2, 3, 1),
             0.2 * torch.randn(12, 1, 1, device="cuda")),
        # decode: 8 (static) or 16 (continuous) rows of 576, per-head q/k
        "decode x (8, 1, 576) bf16":
            (torch.randn(8, 1, 576, device="cuda").to(torch.bfloat16),
             torch.zeros((), device="cuda")),
        "decode x (16, 1, 576) bf16":
            (torch.randn(16, 1, 576, device="cuda").to(torch.bfloat16),
             torch.zeros((), device="cuda")),
        "decode q (8, 1, 9, 64) bf16 per-head":
            (torch.randn(8, 1, 9, 64, device="cuda").to(torch.bfloat16),
             0.2 * torch.randn(9, 1, device="cuda")),
        "decode k (16, 1, 3, 64) bf16 per-head":
            (torch.randn(16, 1, 3, 64, device="cuda").to(torch.bfloat16),
             0.2 * torch.randn(3, 1, device="cuda")),
        "prefill strided V^T (8, 3, 64, 128) bf16":
            (torch.randn(8, 128, 3, 64, device="cuda").to(
                torch.bfloat16).permute(0, 2, 3, 1),
             0.2 * torch.randn(3, 1, 1, device="cuda")),
        # chunked prefill: int32 scores by a per-row theta, V^T words
        "chunk probs (16, 3, 384, 384) int32 per-row":
            (torch.randint(-40, 40, (16, 3, 384, 384), device="cuda",
                           dtype=torch.int32),
             torch.randint(-8, 8, (3, 384, 1), device="cuda",
                           dtype=torch.int32)),
        "chunk strided V^T words (16, 3, 64, 384) int32":
            (torch.randint(0, 2, (16, 3, 384, 64), device="cuda",
                           dtype=torch.int32).transpose(2, 3),
             torch.ones((), device="cuda", dtype=torch.int32)),
        # the layouts' fallbacks: per-column theta past shared memory,
        # unaligned rows, odd strides, no unit stride
        "K=4100 f32 per-column":
            (torch.randn(5, 4100, device="cuda"),
             torch.randn(4100, device="cuda")),
        "row offset of one value bf16":
            (torch.randn(9, 577, device="cuda").to(torch.bfloat16)[:, 1:],
             torch.randn(576, device="cuda")),
        "odd strided V^T bf16":
            (torch.randn(2, 77, 3, 49, device="cuda").to(
                torch.bfloat16)[..., 1:].permute(0, 2, 3, 1),
             0.2 * torch.randn(3, 1, 1, device="cuda")),
        "no unit stride, per-element theta":
            (torch.randn(40, 7, 5, device="cuda").permute(2, 1, 0),
             torch.randn(5, 7, 40, device="cuda")),
    }
    for case, (x, th) in cases.items():
        _same("pack_threshold", case, *f(x, th))
    # main path: prefill input binarization, x (B*S, d) bf16
    x = torch.randn(1024, 576, device="cuda").to(torch.bfloat16)
    th = torch.zeros((), device="cuda")
    out, want = f(x, th)
    err = _same("pack_threshold", "main (1024, 576) bf16", out, want)
    b, by = bound(nbytes(x, th, out), x.numel(), SCALAR32_OPS)
    return dict(err=err, bound_ms=b, bound_by=by,
                kernel=lambda: ops.pack_threshold(x, th),
                plain=lambda: ref.pack_threshold(x, th), library=None)


def check_rbmm_int(rng):
    import torch
    from repro_torch.core import packing
    from repro_torch.kernels.rbmm import ops, ref

    def both(case, x, y, k, scheme, d):
        """Each route and the public wrapper against the plain version."""
        want = ref.rbmm_int(x, y, k, scheme=scheme, dc=d)
        for which in ops.ROUTES:
            _same("rbmm_int", f"{case} [route {which}]",
                  ops.launch_int(which, x, y, k, scheme=scheme, dc=d), want)
        _same("rbmm_int", f"{case} [route "
              f"{ops.route(x.shape[-2], y.shape[-2], x.shape[-1])}, public]",
              ops.rbmm_int(x, y, k, scheme=scheme, dc=d), want)

    def dcs(lead, m, k):
        return torch.randint(0, k + 1, lead + (m,), device="cuda",
                             dtype=torch.int32)

    a, b = _words(rng, (13, 4), 100), _words(rng, (70, 4), 100)
    ab, bb = _words(rng, (2, 3, 5, 2), 48), _words(rng, (2, 3, 67, 2), 48)
    ch = (16, 3)   # chunked prefill: 16 slots, 3 KV heads
    cases = {
        "ragged K=100 xnor": (a, b, 100, "xnor", None),
        "ragged K=100 and_dc, dc derived": (a, b, 100, "and_dc", None),
        "ragged K=100 and_dc, dc given": (a, b, 100, "and_dc",
                                          dcs((), 13, 100)),
        "batched d_h=48 xnor": (ab, bb, 48, "xnor", None),
        "batched d_h=48 and_dc": (ab, bb, 48, "and_dc", None),
        "bert F2 (4096x768)x(768x768) and_dc, dc given":
            (_words(rng, (4096, 24), 768), _words(rng, (768, 24), 768),
             768, "and_dc", dcs((), 4096, 768)),
        "chunk prefix score (16,3,384,2)x(16,3,384,2) xnor":
            (_words(rng, ch + (384, 2), 64), _words(rng, ch + (384, 2), 64),
             64, "xnor", None),
        "chunk context (16,3,384,12)x(16,3,64,12) and_dc, dc derived":
            (_words(rng, ch + (384, 12), 384),
             _words(rng, ch + (64, 12), 384), 384, "and_dc", None),
        "chunk intra score (16,3,384,2)x(16,3,128,2) xnor":
            (_words(rng, ch + (384, 2), 64), _words(rng, ch + (128, 2), 64),
             64, "xnor", None),
    }
    # tile edges (128 rows; 64, 128 or 192 columns), Kp of 1 to 5, 24 and
    # 25 words with pad bits set, batches; xnor, and_dc with dc derived
    # and given
    for lead, m, p, k in (((), 17, 65, 20), ((), 127, 193, 33),
                          ((), 129, 64, 70), ((2,), 65, 127, 100),
                          ((), 300, 129, 130), ((3,), 200, 384, 768),
                          ((), 129, 257, 790)):
        kp = (k + 31) // 32
        x, y = _words(rng, lead + (m, kp), None), \
            _words(rng, lead + (p, kp), None)
        for scheme, d in (("xnor", None), ("and_dc", None),
                          ("and_dc", dcs(lead, m, k))):
            cases[f"edge b={lead or 1} M={m} P={p} K={k} Kp={kp} pad bits "
                  f"set {scheme}{' dc given' if d is not None else ''}"] = \
                (x, y, k, scheme, d)
    # the decode route: every decode call of smollm-135m at M = 8 and 16
    # (kernel_times.decode_calls), M of 1 to 17, Kp of 1 to 256 with pad
    # bits set, P off the column tile, batches, and operands whose base is
    # 4, 8 or 12 bytes past a 16-byte boundary
    for name, (lead, m, p, k, scheme) in decode_calls(crossover=()).items():
        kp = (k + 31) // 32
        x, y = _words(rng, lead + (m, kp), k), _words(rng, lead + (p, kp), k)
        cases[name] = (x, y, k, scheme, None)
        if scheme == "and_dc":
            cases[f"{name}, dc given"] = (x, y, k, scheme, dcs(lead, m, k))
    for lead, m, p, k in (((), 1, 576, 575), ((), 3, 77, 33),
                          ((), 16, 193, 1530), ((5,), 2, 33, 8),
                          ((2, 3), 5, 160, 150), ((), 9, 100, 540),
                          ((), 8, 129, 600), ((), 17, 65, 1560),
                          ((), 12, 31, 8190)):
        kp = (k + 31) // 32
        x, y = _words(rng, lead + (m, kp), None), \
            _words(rng, lead + (p, kp), None)
        for scheme, d in (("xnor", None), ("and_dc", None),
                          ("and_dc", dcs(lead, m, k))):
            cases[f"decode edge b={lead or 1} M={m} P={p} K={k} Kp={kp} pad "
                  f"bits set {scheme}{' dc given' if d is not None else ''}"
                  ] = (x, y, k, scheme, d)
    for off in (1, 2, 3):
        for m, p, kp in ((8, 576, 48), (16, 192, 18)):
            flat = _words(rng, (off + (m + p) * kp,), None)
            x = flat[off:off + m * kp].view(m, kp)
            y = flat[off + m * kp:].view(p, kp)
            cases[f"decode base +{4 * off} bytes M={m} P={p} Kp={kp}"] = (
                x, y, 32 * kp - 3, "and_dc", None)
    for case, (x, y, k, scheme, d) in cases.items():
        both(case, x, y, k, scheme, d)
    # main path: wq at decode, M = batch = 8, K = P = 576
    a, w = _words(rng, (8, 18), 576), _words(rng, (576, 18), 576)
    out = ops.rbmm_int(a, w, 576)
    err = _same("rbmm_int", "main wq decode (8x576)x(576x576)", out,
                ref.rbmm_int(a, w, 576))
    av = packing.unpack_signs(a, 576, torch.bfloat16)
    wv = packing.unpack_signs(w, 576, torch.bfloat16)
    b, by = bound(nbytes(a, w, out), 3 * a.shape[0] * w.shape[0] * 18,
                  SCALAR32_OPS)
    return dict(err=err, bound_ms=b, bound_by=by,
                kernel=lambda: ops.rbmm_int(a, w, 576),
                plain=lambda: ref.rbmm_int(a, w, 576),
                library=lambda: torch.matmul(av, wv.T))


def check_rbmm_binary(rng):
    import torch
    from repro_torch.core import packing
    from repro_torch.kernels.rbmm import ops, ref

    def theta(*shape, lo=-20, hi=20):
        return torch.randint(lo, hi, shape, device="cuda", dtype=torch.int32)

    def both(a, b, k, th, **kw):
        """The kernel against its plain version, bits and packed words."""
        want, want_dc = ref.rbmm_binary(a, b, k, th, **kw)
        for pack in (False, True):
            got, got_dc = ops.rbmm_binary(a, b, k, th, pack_output=pack,
                                          **kw)
            yield (got, packing.pack_bits(want) if pack else want,
                   "packed" if pack else "bits")
            yield got_dc, want_dc, ("packed" if pack else "bits") + " dc"

    a, b = _words(rng, (70, 4), 100), _words(rng, (45, 4), 100)
    dc = torch.randint(0, 100, (70,), device="cuda", dtype=torch.int32)
    ab, bb = _words(rng, (3, 33, 2), 48), _words(rng, (3, 65, 2), 48)
    al, bl = _words(rng, (40, 35), 1100), _words(rng, (150, 35), 1100)
    cases = {
        "ragged M=70 P=45 K=100 xnor": (a, b, 100, theta(45), {}),
        "ragged and_dc, dc derived": (a, b, 100, theta(45),
                                      dict(scheme="and_dc")),
        "ragged and_dc, dc given": (a, b, 100, theta(45),
                                    dict(scheme="and_dc", dc=dc)),
        "causal M=70 > P=45": (a, b, 100, theta(45), dict(causal=True)),
        "batched M=33 P=65 K=48 and_dc causal": (
            ab, bb, 48, theta(65), dict(scheme="and_dc", causal=True)),
        "K=1100 > one staged chunk of 1024": (al, bl, 1100,
                                             theta(150, lo=-90, hi=90), {}),
        "(M, P) theta, P=150": (al, bl, 1100, theta(40, 150, lo=-90, hi=90),
                                {}),
        "scalar theta, batched": (ab, bb, 48, theta(), {}),
    }
    # the 128 x 192 tile's edges and K-step counts (128 values a step, a
    # 4-stage ring)
    for bt, m, p, k, thf, kw in (
            (1, 63, 193, 48, "P", dict(scheme="and_dc")),
            (1, 127, 65, 100, "P", dict(causal=True)),
            (1, 129, 127, 2048, "P", dict(scheme="and_dc", dc="given")),
            (1, 128, 192, 576, "MP", {}),
            (1, 65, 191, 768, "scalar", dict(scheme="and_dc", causal=True)),
            (2, 64, 63, 1100, "MP", {}), (1, 300, 400, 768, "P", {})):
        lead = (bt,) if bt > 1 else ()
        x, y = _words(rng, lead + (m, (k + 31) // 32), k), \
            _words(rng, lead + (p, (k + 31) // 32), k)
        th = {"P": theta(p, lo=-k // 8, hi=k // 8), "scalar": theta(),
              "MP": theta(*lead, m, p, lo=-k // 8, hi=k // 8)}[thf]
        if kw.get("dc") == "given":
            kw = dict(kw, dc=torch.randint(0, k, lead + (m,), device="cuda",
                                           dtype=torch.int32))
        cases[f"edge b={bt} M={m} P={p} K={k} theta {thf} "
              f"{kw.get('scheme', 'xnor')}"
              f"{' causal' if kw.get('causal') else ''}"
              f"{' dc given' if 'dc' in kw else ''}"] = (x, y, k, th, kw)
    for case, (x, y, k, th, kw) in cases.items():
        for got, want, store in both(x, y, k, th, **kw):
            _same("rbmm_binary", f"{case}, {store}", got, want)
    # main path: bert-base F1, x (B*S = 4096, 768) against one R-chunk of
    # W1 (768 of the 3072 columns), packed store, zeros per row
    a, w = _words(rng, (4096, 24), 768), _words(rng, (768, 24), 768)
    th = theta(768, lo=-40, hi=40)
    err = 0.0
    for got, want, store in both(a, w, 768, th):
        err = max(err, _same("rbmm_binary", f"main F1 (4096x768)x(768x768)"
                             f" xnor, {store}", got, want))
    out, dc_out = ops.rbmm_binary(a, w, 768, th, pack_output=True)
    av = packing.unpack_signs(a, 768, torch.bfloat16)
    wv = packing.unpack_signs(w, 768, torch.bfloat16)
    # the least of two ways to do the work: 32-bit word operations at the
    # ALU rate, or the MACs of the unpacked values at the int8 tensor rate
    b_ms, by = min(bound(nbytes(a, w, th, out, dc_out), 3 * 4096 * 768 * 24,
                         SCALAR32_OPS),
                   bound(nbytes(a, w, th, out, dc_out), 2 * 4096 * 768 * 768,
                         INT8_OPS))
    # the floor of the popcount route, which the table's rate does not see:
    # the SMs issue 16 32-bit popcounts per clock each (one per word pair)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], stdout=subprocess.PIPE,
        text=True, check=True).stdout.split()[0])
    popc = 4096 * 768 * 24
    log(f"[kernels] rbmm_binary main: {popc} popcounts at 16 per clock per "
        f"SM, {sms} SMs, {mhz:.0f} MHz max SM clock: floor "
        f"{popc / (16 * sms * mhz * 1e6) * 1e3:.5f} ms; word operations at "
        f"{SCALAR32_OPS / 1e12:.0f} T/s "
        f"{3 * popc / SCALAR32_OPS * 1e3:.5f} ms; MACs at the int8 tensor "
        f"rate {INT8_OPS / 1e12:.0f} T/s "
        f"{2 * 4096 * 768 * 768 / INT8_OPS * 1e3:.5f} ms: bound "
        f"{b_ms:.5f} ms ({by})")

    def plain():
        bits, d = ref.rbmm_binary(a, w, 768, th)
        return packing.pack_bits(bits), d

    return dict(err=err, bound_ms=b_ms, bound_by=by,
                kernel=lambda: ops.rbmm_binary(a, w, 768, th,
                                               pack_output=True),
                plain=plain, library=lambda: torch.matmul(av, wv.T))


def check_rbmm_mxu(rng):
    import torch
    from repro_torch.core import packing
    from repro_torch.kernels.rbmm_mxu import ops, ref
    cases = {
        "ragged M=70 P=45 K=100 ±1":
            (_pm1(rng, (70, 100)), _words(rng, (45, 4), 100)),
        "ragged {0,1} K=100":
            (_pm1(rng, (70, 100), unsigned=True), _words(rng, (45, 4), 100)),
        "batched M=33 P=65 K=48":
            (_pm1(rng, (2, 33, 48)), _words(rng, (2, 65, 2), 48)),
        "encode Q/K/V/O (4096x768)x(768x768)":
            (_pm1(rng, (4096, 768)), _words(rng, (768, 24), 768)),
    }
    # tile edges (64 and 128), K-step counts of 1 to 32 (64 values a step,
    # a 3- or 4-stage ring), K % 8 != 0, batches, {0,1} values; the last
    # three reach the 128 x 64 and 128 x 128 tiles at ragged M and P, the
    # last with P * 4 % 16 != 0 (masked stores instead of TMA stores)
    for bt, m, k, p, unsigned in (
            (1, 63, 48, 63, False), (1, 64, 100, 64, True),
            (1, 65, 576, 65, False), (1, 127, 768, 127, True),
            (1, 128, 1100, 128, False), (1, 129, 2048, 129, False),
            (3, 65, 100, 129, True), (2, 129, 576, 63, False),
            (1, 1100, 576, 1100, False), (1, 2000, 768, 1300, True),
            (1, 1500, 100, 1501, False)):
        lead = (bt,) if bt > 1 else ()
        cases[f"edge b={bt} M={m} K={k} P={p} "
              f"{'{0,1}' if unsigned else '±1'} tile "
              f"{ops.tile_for(bt, m, p)}"] = (
            _pm1(rng, lead + (m, k), unsigned=unsigned),
            _words(rng, lead + (p, (k + 31) // 32), k))
    for case, (a, w) in cases.items():
        _same("rbmm_mxu", case, ops.rbmm_mxu(a, w), ref.rbmm_mxu(a, w))
    # main path: w1 at prefill, M = B*S = 1024, K = 576, P = 1536
    a, w = _pm1(rng, (1024, 576)), _words(rng, (1536, 18), 576)
    out = ops.rbmm_mxu(a, w)
    err = _same("rbmm_mxu", "main w1 prefill (1024x576)x(576x1536)", out,
                ref.rbmm_mxu(a, w))
    wv = packing.unpack_signs(w, 576, torch.bfloat16)
    b, by = bound(nbytes(a, w, out), 2 * 1024 * 576 * 1536, BF16_FLOPS)
    return dict(err=err, bound_ms=b, bound_by=by,
                kernel=lambda: ops.rbmm_mxu(a, w),
                plain=lambda: ref.rbmm_mxu(a, w),
                library=lambda: torch.matmul(a, wv.T))


def check_paged_gather_decode(rng):
    import torch
    from repro_torch.kernels.paged_attn import ops, ref

    def inputs(b, h, hkv, dh, page, nblk, pages, ring, lens=None):
        """Random pages (trash page 0 included), a random table over the
        arena with trash entries, ragged lengths (0 and >= ring among
        them unless given)."""
        dhp = (dh + 31) // 32
        bt = rng.integers(0, pages + 1, (b, nblk)).astype(np.int32)
        bt[-1, -1] = 0
        if lens is None:
            lens = rng.integers(0, ring + 20, (b,))
            lens[0], lens[-1] = 0, ring + 5
        th = rng.integers(-12, 12, (b, h)).astype(np.int32)
        return (_words(rng, (b, h, dhp), dh),
                _words(rng, (pages + 1, hkv, page, dhp), dh),
                _words(rng, (pages + 1, hkv, dh, page // 32), page),
                torch.from_numpy(bt).cuda(),
                torch.from_numpy(np.asarray(lens, np.int32)).cuda(), ring,
                torch.from_numpy(th).cuda())

    f = lambda a, dh: (ops.paged_gather_decode(*a, d_h=dh),
                       ref.paged_gather_decode_popcount(*a, d_h=dh))
    for case, shape in {
            "d_h=48 H=9/3": (3, 9, 3, 48, 32, 3, 6, 96),
            "page=64 G=3": (3, 3, 1, 64, 64, 2, 4, 128),
            "G=1 single block": (2, 4, 4, 32, 32, 1, 2, 32),
            "G=2 page=64": (1, 6, 3, 32, 64, 2, 5, 128),
            "ring 48 < nblk*page 64": (2, 2, 2, 32, 32, 2, 3, 48),
            # the page split's edges: more pages than the 16 warps of a
            # sequence (page 96: three words), a warp past 32 table
            # entries, G = 16 with d_h = 256 and pages of 256
            "nblk=40 page=96 d_h=48": (3, 4, 2, 48, 96, 40, 60, 3800),
            "nblk=530": (2, 2, 1, 32, 32, 530, 540, 16950),
            "G=16 d_h=256 page=256": (2, 32, 2, 256, 256, 3, 4, 700)
    }.items():
        _same("paged_gather_decode", f"{case}, trash entries, lengths 0 "
              f"and >= ring", *f(inputs(*shape), shape[3]))
    # the row granularity's thresholds: an (H, 512) table gathered at each
    # row's position (clamped to 511), on gemma's local ring of 1,024
    # slots with lengths past it (wrapped rings), G = 2, d_h = 128
    a = inputs(8, 32, 16, 128, 32, 32, 256, 1024,
               lens=rng.integers(1025, 2176, (8,)))
    table = torch.from_numpy(rng.integers(-20, 21, (32, 512)).astype(
        np.int32)).cuda()
    a = a[:-1] + (table[:, a[4].long().clamp(max=511)].T.contiguous(),)
    _same("paged_gather_decode", "row-table thresholds gathered by "
          "position, ring 1024, lengths 1025..2175, H=32/16 d_h=128",
          *f(a, 128))
    # main path: 16 slots, H=9 over 3, d_h=64, 12 blocks of 32 over an
    # arena of 96 pages, ragged lengths
    b, h, hkv, dh, page, nblk, ring = 16, 9, 3, 64, 32, 12, 384
    lens = rng.integers(0, ring, (b,))
    a = inputs(b, h, hkv, dh, page, nblk, 96, ring, lens)
    out, want = f(a, dh)
    err = _same("paged_gather_decode", "main 16 slots H=9/3 d_h=64, 12 "
                "blocks of 32, 96 pages", out, want)
    # what this run's data needs: the pages up to each row's last valid
    # column, once per KV head, and q, table, lengths, thresholds, output
    bnd, by = paged_bound(*a, out)
    return dict(err=err, bound_ms=bnd, bound_by=by,
                kernel=lambda: ops.paged_gather_decode(*a, d_h=dh),
                plain=lambda: ref.paged_gather_decode_popcount(*a, d_h=dh),
                library=None)


def check_sps_attention(rng):
    import torch
    from repro_torch.kernels.sps_attn import ops, ref

    def theta(h):
        return torch.randint(-6, 7, (h,), device="cuda", dtype=torch.int32)

    def gqa(b, h, hkv, length, dh):
        dhp, lw = (dh + 31) // 32, (length + 31) // 32
        return (_words(rng, (b, h, length, dhp), dh),
                _words(rng, (b, hkv, length, dhp), dh),
                _words(rng, (b, hkv, dh, lw), length), theta(h))

    cases = {
        "ragged L=77 d_h=48 GQA 3:1": (2, 3, 1, 77, 48),
        "L=40 d_h=64 MHA": (1, 2, 2, 40, 64),
        # the tensor-core design's edges: 64-row query tiles, 128-key
        # tiles, three heads a block (G = 16: six blocks a group, G = 4:
        # two of two), 64 context columns a pass, odd d_h, six key tiles
        "G=16 d_h=256 L=130": (1, 16, 1, 130, 256),
        "G=4 d_h=95 L=200": (2, 8, 2, 200, 95),
        "L=700 d_h=96": (1, 6, 2, 700, 96)}
    for length in (63, 64, 65, 129):
        cases[f"L={length} d_h=64 GQA 3:1"] = (2, 6, 2, length, 64)
    for case, (b, h, hkv, length, dh) in cases.items():
        q, k, vt, th = gqa(b, h, hkv, length, dh)
        for causal in (True, False):
            _same("sps_attention", f"{case} causal={causal}",
                  ops.sps_attention_gqa(q, k, vt, th, d_h=dh, causal=causal),
                  ref.sps_attention_gqa(q, k, vt, th, d_h=dh, causal=causal))
    # per-sequence key lengths (ragged prefill): 1, L, the 64-row query
    # and 128-key tile edges +-1, 0
    for case, (h, hkv, length, dh) in {
            "L=200 d_h=64 GQA 3:1": (6, 2, 200, 64),
            "L=130 d_h=128 MHA": (4, 4, 130, 128)}.items():
        lens = torch.tensor([1, length, 63, 64, 65, 127, 129, 0],
                            dtype=torch.int32, device="cuda")
        q, k, vt, th = gqa(len(lens), h, hkv, length, dh)
        for causal in (True, False):
            _same("sps_attention", f"{case} lens {lens.tolist()} "
                  f"causal={causal}",
                  ops.sps_attention_gqa(q, k, vt, th, d_h=dh, causal=causal,
                                        lens=lens),
                  ref.sps_attention_gqa(q, k, vt, th, d_h=dh, causal=causal,
                                        lens=lens))
    # causal windows (gemma's local layers: 1,024): a window of one key,
    # the 32-bit word's edges, the 64-row query and 128-key tile edges
    # below and above; with lens; d_h 64 and 128 (G = 2)
    for length in (64, 1100, 1536):
        for window in (1, 31, 32, 33, 1024):
            for dh in (64, 128):
                q, k, vt, th = gqa(1, 4, 2, length, dh)
                _same("sps_attention", f"L={length} window={window} "
                      f"d_h={dh} G=2",
                      ops.sps_attention_gqa(q, k, vt, th, d_h=dh,
                                            window=window),
                      ref.sps_attention_gqa(q, k, vt, th, d_h=dh,
                                            window=window))
    lens = torch.tensor([1100, 1, 1024, 1025, 130, 0], dtype=torch.int32,
                        device="cuda")
    q, k, vt, th = gqa(len(lens), 4, 2, 1100, 128)
    _same("sps_attention", f"L=1100 window=1024 lens {lens.tolist()}",
          ops.sps_attention_gqa(q, k, vt, th, d_h=128, window=1024,
                                lens=lens),
          ref.sps_attention_gqa(q, k, vt, th, d_h=128, window=1024,
                                lens=lens))
    # the row granularity's (H, 512) table at L = 600: rows 511.. read
    # column 511; with a window and lens too
    table = torch.randint(-20, 21, (4, 512), device="cuda",
                          dtype=torch.int32)
    for dh in (64, 128):
        q, k, vt, _ = gqa(2, 4, 2, 600, dh)
        for kw in (dict(), dict(window=33, lens=lens[:2].clamp(max=600))):
            _same("sps_attention", f"L=600 row table (4, 512) d_h={dh} "
                  f"{kw}",
                  ops.sps_attention_gqa(q, k, vt, table, d_h=dh, **kw),
                  ref.sps_attention_gqa(q, k, vt, table, d_h=dh, **kw))
    # the encode path's shape: bert-base, bidirectional, B=8, L=512
    q, k, vt, th = gqa(8, 12, 12, 512, 64)
    _same("sps_attention", "encode B=8 L=512 H=12/12 d_h=64 causal=False",
          ops.sps_attention_gqa(q, k, vt, th, d_h=64, causal=False),
          ref.sps_attention_gqa(q, k, vt, th, d_h=64, causal=False))
    # the TPU signature, both context paths, one sequence
    q, k, vt, th = gqa(1, 3, 3, 77, 48)
    v = 2 * ((torch.rand(3, 77, 48, device="cuda") > 0.5).float()) - 1
    want = ref.sps_attention_gqa(q, k, ref.v_transpose_packed(v)[None], th,
                                 d_h=48)[0]
    for path in ("vpu", "mxu"):
        vin = ref.v_transpose_packed(v) if path == "vpu" else v
        _same("sps_attention", f"one sequence path={path}",
              ops.sps_attention(q[0], k[0], vin, th, d_h=48, path=path),
              want)
    # main path: prefill of B=8, S=128, H=9 over Hkv=3, d_h=64
    q, k, vt, th = gqa(8, 9, 3, 128, 64)
    out = ops.sps_attention_gqa(q, k, vt, th, d_h=64)
    err = _same("sps_attention", "main prefill B=8 L=128 H=9/3", out,
                ref.sps_attention_gqa(q, k, vt, th, d_h=64))
    b, by = sps_bound(q, k, vt, th, out, causal=True)
    return dict(err=err, bound_ms=b, bound_by=by,
                kernel=lambda: ops.sps_attention_gqa(q, k, vt, th, d_h=64),
                plain=lambda: ref.sps_attention_gqa(q, k, vt, th, d_h=64),
                library=None)


KERNEL_ROWS = {
    # name: (check, source, the TPU kernel's pallas_call)
    "pack_threshold": (check_pack, "src/repro_torch/csrc/pack.cu",
                       "src/repro/kernels/pack/kernel.py:62"),
    "rbmm_int": (check_rbmm_int, "src/repro_torch/csrc/rbmm.cu",
                 "src/repro/kernels/rbmm/kernel.py:129"),
    "rbmm_binary": (check_rbmm_binary, "src/repro_torch/csrc/rbmm.cu",
                    "src/repro/kernels/rbmm/kernel.py:173"),
    "rbmm_mxu": (check_rbmm_mxu, "src/repro_torch/csrc/rbmm_mxu.cu",
                 "src/repro/kernels/rbmm_mxu/kernel.py:89"),
    "sps_attention": (check_sps_attention,
                      "src/repro_torch/csrc/sps_attn.cu",
                      "src/repro/kernels/sps_attn/kernel.py:159"),
    "paged_gather_decode": (check_paged_gather_decode,
                            "src/repro_torch/csrc/paged_attn.cu",
                            "src/repro/kernels/paged_attn/kernel.py:124"),
}
# the kernels each serving path must launch
STATIC_PATH = ("pack_threshold", "rbmm_int", "rbmm_mxu", "sps_attention")
PAGED_PATH = ("pack_threshold", "rbmm_int", "rbmm_mxu",
              "paged_gather_decode")
ENCODE_PATH = ("pack_threshold", "rbmm_int", "rbmm_binary", "rbmm_mxu",
               "sps_attention")


def check_spec_calls() -> None:
    """Every call of the speculative iteration at its exact shape
    (``kernel_times.SPEC_CALLS``: the verify's chunk attend at M = 15
    rows over the 384-slot ring view and its projections at M = 80, the
    draft's ring decode and projections at M = 16, every pack), kernel
    against plain version, bitwise."""
    calls = spec_operands(SEED)
    for name, (kernel, call, plain, _, _) in calls.items():
        _same(kernel, name, call(), plain())
    by_kernel = {}
    for kernel, *_ in calls.values():
        by_kernel[kernel] = by_kernel.get(kernel, 0) + 1
    log(f"[kernels] the speculative iteration's {len(calls)} calls "
        f"{json.dumps(by_kernel)} equal their plain versions bitwise")


def check_arch_calls() -> None:
    """Every call of granite-3-2b's and qwen1.5-32b's serve paths at full
    width (``kernel_times.ARCH_CALLS``: the decode projections at M = 8
    and 16 up to Kp = 856 words, the ring score and context, the prefill
    projections up to K = 27,392, the packs, the prefill attention at
    d_h = 64 and 128 with and without ``lens``, the paged decode at G = 4
    and G = 1), then of gemma3-27b's (``kernel_times.GEMMA_CALLS``: the
    decode projections at M = 4, 8 and 16 up to Kp = 672, the rings of
    1,024 and 1,568, the prefill projections at M = 6,144, the prefill
    attention windowed, full and with a row table, both paged ring
    groups), and of hymba-1.5b's and xlstm-350m's at full width
    (``kernel_times.RECURRENT_CALLS``: the projections at K = 1,600 /
    3,200 / 5,504 and 1,024 / 2,048, ``sps_attention`` at H = 25/5 with a
    window of 1,024, ``paged_gather_decode`` at G = 5, the chunk attend
    at M = 640), and of seamless-m4t-large-v2's and internvl2-76b's static
    paths at full width (``kernel_times.ENCDEC_CALLS``: the encoder's
    bidirectional attention at L = 1,024, the cross score and context
    over memories of 1,024 frames at M = 1 and 64 a KV head, the fused F1
    ``rbmm_binary`` at M = 4, internvl2's prefill of 1,088 positions and
    its decode projections up to Kp = 896), kernel against plain version,
    bitwise."""
    for label, table in (("granite-3-2b's and qwen1.5-32b's", ARCH_CALLS),
                         ("gemma3-27b's", GEMMA_CALLS),
                         ("hymba-1.5b's and xlstm-350m's",
                          RECURRENT_CALLS),
                         ("seamless-m4t-large-v2's and internvl2-76b's",
                          ENCDEC_CALLS)):
        calls = call_operands(table, SEED)
        by_kernel = {}
        for name, (kernel, call, plain, _, _) in calls.items():
            _same_call(kernel, name, call(), plain())
            by_kernel[kernel] = by_kernel.get(kernel, 0) + 1
        del calls
        log(f"[kernels] {label} {sum(by_kernel.values())} calls "
            f"{json.dumps(by_kernel)} equal their plain versions bitwise")


def check_moe_calls() -> dict:
    """Every expert-batched call of mixtral-8x22b's and arctic-480b's serve
    paths at full width (``kernel_times.MOE_CALLS``: ``rbmm_int``'s
    decode route over 8 and 128 experts, ``rbmm_mxu`` batched over
    experts, ``pack_threshold`` on (E, C, d) buffers; arctic's dense
    residual beside them), one call's operands on the card at a time:
    kernel against plain version, bitwise; device µs of the kernel and of
    the library's batched matmul of the unpacked bf16 operands, per-call
    ms, the bound and the launches per step.  Returns the rows by
    name."""
    rows, by_kernel = {}, {}
    for row in moe_rows(SEED):
        if not row["equal"]:
            raise AssertionError(f"[kernels] {row['shape']}: the kernel "
                                 f"differs from its plain version")
        rows[row["shape"]] = row
        by_kernel[row["kernel"]] = by_kernel.get(row["kernel"], 0) + 1
        lib = row["library_ms"]
        log(f"[kernels] {row['shape']}: equal to its plain version; device "
            f"us kernel {1e3 * row['ms']:.2f}, library "
            f"{'none' if lib is None else f'{1e3 * lib:.2f}'}, bound "
            f"{1e3 * row['bound_ms']:.2f} ({row['bound_by']}); per call "
            f"with host work: kernel {row['eager_ms']:.4f} ms, library "
            f"{row['library_eager_ms']}; {row['step_launches']} launches "
            f"per step of its path")
    log(f"[kernels] the MoE archs' {len(rows)} expert-batched calls "
        f"{json.dumps(by_kernel)} equal their plain versions bitwise")
    return rows


def phase_kernels():
    """Each kernel against its plain version; its row of the kernels line
    (``ms``, ``plain_ms`` and ``library_ms`` are device times from the
    profiler, the ``*eager_ms`` keys CUDA-event times per call with the
    host work included).  Returns (the rows by kernel, the MoE calls' rows
    of ``check_moe_calls``)."""
    import torch
    torch.manual_seed(SEED)
    rng = np.random.default_rng(SEED)
    rows = {}
    for name, (check, source, replaces) in KERNEL_ROWS.items():
        r = check(rng)
        torch.cuda.synchronize()
        lib = r["library"]
        row = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces, "launches": None,
               "max_abs_err": r["err"], "ms": device_ms(r["kernel"]),
               "plain_ms": device_ms(r["plain"]),
               "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
               "library_ms": None if lib is None else device_ms(lib),
               "eager_ms": eager_ms(r["kernel"]),
               "plain_eager_ms": eager_ms(r["plain"]),
               "library_eager_ms": None if lib is None else eager_ms(lib)}
        rows[name] = row
        log(f"[kernels] {name}: equal to its plain version; device ms: "
            f"kernel {row['ms']:.5f}, plain {row['plain_ms']:.5f}, library "
            f"{row['library_ms']}, bound {row['bound_ms']:.5f} "
            f"({row['bound_by']}); per call with host work: kernel "
            f"{row['eager_ms']:.4f}, plain {row['plain_eager_ms']:.4f}, "
            f"library {row['library_eager_ms']}")
    check_spec_calls()
    check_arch_calls()
    moe = check_moe_calls()
    for t in time_all(SEED):
        per_layer = (f"; {t['layer_launches']} launches per layer of its "
                     f"step" if "layer_launches" in t else
                     f"; {t['step_launches']} launches per step of its path"
                     if "step_launches" in t else "")
        log(f"[kernels] {t['shape']}: device ms kernel {t['ms']:.5f}, "
            f"library {t['library_ms']}, bound {t['bound_ms']:.5f} "
            f"({t['bound_by']}); per call with host work: kernel "
            f"{t['eager_ms']:.4f}, library {t['library_eager_ms']}"
            f"{per_layer}")
    return rows, moe


# -- phase 4: serve -----------------------------------------------------------

SERVE_B, SERVE_S, SERVE_NEW = 8, 128, 32


# the conversion's temporaries beyond the masters: the |w| of a
# projection's activation scale (one largest-projection master) and a
# block of ``packing.PACK_BLOCK`` signs held as bool, int64, its
# contiguous copy and shifted int64 values (25 bytes each, if all alive
# at once); the draws themselves run in place (``nn.truncated_normal``)
BUILD_TEMPS = 1
PACK_TEMP_BYTES_PER_SIGN = 25


def master_bytes(model) -> tuple:
    """(the float32 masters one step of ``init_deploy`` holds at most: one
    block's, or in an expert stack the largest of its attention's, one
    expert's plus the router's and the residual FFN's plus the router's;
    the largest projection's master), in bytes, from the blocks' QAT
    params drawn on the meta device (no memory)."""
    import torch
    from repro_torch import tree
    from repro_torch.models.ffn import BinaryMoE
    gen = torch.Generator()

    def size(t) -> int:
        return 4 * sum(leaf.numel() for leaf in tree.leaves(t))

    unit = proj = 0
    for blocks in model.layer_blocks().values():
        for blk in set(blocks):
            parts = []
            for mod in blk._parts().values():
                p = mod.init(gen, "meta")
                if isinstance(mod, BinaryMoE):
                    router = size(p["router"])
                    parts += [size(p["experts"]) // mod.num_experts + router,
                              size(p.get("residual")) + router]
                else:
                    parts.append(size(p))
                for path, t in tree.leaves_with_paths(p):
                    if path.endswith("w_latent"):
                        experts = path.startswith("experts")
                        proj = max(proj, 4 * t[0].numel() if experts
                                   else 4 * t.numel())
            moe = any(isinstance(m, BinaryMoE)
                      for m in blk._parts().values())
            unit = max(unit, max(parts) if moe else sum(parts))
    return unit, proj


def free_card() -> None:
    """Give back what earlier phases left: engines and graphs that hold
    each other (reference cycles) are collected, then the cache freed."""
    import gc
    import torch
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def load_model(arch: str, tag: str):
    """``arch``'s model at full width and depth, deploy params drawn from
    ``SEED`` on the card block by block (``init_deploy``: at most one
    block's float32 masters alive, one expert's in an expert stack).  The
    build's peak must stay under the final allocation plus those masters,
    ``BUILD_TEMPS`` times the largest projection's (``master_bytes``) and
    a packed block's temporaries.  Returns (model, deploy params, {"s", "gib",
    "peak_gib"}: the build's seconds, GiB after it and its peak)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.lm import build_model
    cfg = get_config(arch)
    model = build_model(cfg)
    free_card()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with torch.inference_mode():
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        dparams = model.init_deploy(gen)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    final, peak = (torch.cuda.memory_allocated(),
                   torch.cuda.max_memory_allocated())
    from repro_torch.core.packing import PACK_BLOCK
    unit, proj = master_bytes(model)
    pack = PACK_TEMP_BYTES_PER_SIGN * PACK_BLOCK
    bound = final + unit + BUILD_TEMPS * proj + pack
    torch.cuda.empty_cache()
    log(f"{tag} {cfg.name}: {cfg.num_layers} layers"
        f"{f' and {cfg.num_encoder_layers} encoder layers' if cfg.num_encoder_layers else ''}, "
        f"d={cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads of "
        f"d_h={cfg.resolved_head_dim}, d_ff={cfg.d_ff}, vocab "
        f"{cfg.vocab_size}, qkv bias {cfg.attn_bias}, tied head "
        f"{cfg.tie_embeddings}, {cfg.compute_dtype}"
        f"{moe_text(cfg)}; "
        f"{cfg.param_count() / 1e9:.3f} B parameters; init_deploy "
        f"{secs:.1f} s; {final / 2**30:.2f} GiB on the card, the build's "
        f"peak {peak / 2**30:.2f} GiB <= {bound / 2**30:.2f} (the final "
        f"allocation + {unit / 2**30:.3f} GiB of masters + {BUILD_TEMPS} x "
        f"the largest projection's {proj / 2**30:.3f} GiB + "
        f"{pack / 2**30:.3f} GiB of a packed block's temporaries); peak - "
        f"final = {(peak - final) / proj:.2f} largest projection masters")
    if peak > bound:
        raise AssertionError(f"{tag} init_deploy's peak {peak} bytes "
                             f"exceeds {bound}")
    return model, dparams, {"s": secs, "gib": final / 2**30,
                            "peak_gib": peak / 2**30}


def full_depth_line(tag: str, model, built: dict, served: dict) -> None:
    """The ``[<arch> full depth]`` summary of a full-depth static cell."""
    from repro_torch.configs import get_config
    log(f"{tag} {model.cfg.num_layers} layers (of the config's "
        f"{get_config(model.cfg.name).num_layers}), init_deploy "
        f"{built['s']:.1f} s, "
        f"{built['gib']:.2f} GiB allocated after the build, the build's "
        f"peak {built['peak_gib']:.2f} GiB; prefill "
        f"{served['prefill_ms']:.1f} ms, decode {served['step_ms']:.2f} "
        f"ms/step, {served['tok_s']:.1f} tok/s; launches per prefill "
        f"{json.dumps(served['prefill'])}, per decode step "
        f"{json.dumps(served['decode'])}")


def static_expect(cfg, shape) -> dict:
    """Launches per prefill and per decode step of ``cfg``'s static path
    at ``shape`` (``kernel_times.encdec_calls``: each layer's calls
    times the depth)."""
    calls = encdec_calls(cfg, shape)
    short = cfg.name.split("-")[0]
    return {p: path_launches(calls, short, p) for p in ("prefill", "decode")}


def words_digest(params) -> str:
    """sha256 of every leaf's path and bytes, in flattening order."""
    import torch
    from repro_torch import tree
    h = hashlib.sha256()
    for path, t in tree.leaves_with_paths(params):
        h.update(path.encode())
        h.update(t.detach().reshape(-1).contiguous().view(torch.uint8)
                 .cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def check_prefix(model, dparams, n: int, tag: str) -> None:
    """``init_deploy`` of ``cfg.truncated(n)`` on the card against the
    full-depth params: its n blocks' words digest as the full model's
    first n blocks', and its embedding, norm and head are equal."""
    import torch
    from repro_torch import tree
    from repro_torch.models.lm import build_model
    cut_model = build_model(model.cfg.truncated(n))
    t0 = time.perf_counter()
    with torch.inference_mode():
        cut = cut_model.init_deploy(
            torch.Generator(device="cuda").manual_seed(SEED))
        got, want = words_digest(cut["blocks"]), \
            words_digest(dparams["blocks"][:n])
        rest = [k for k in cut if k != "blocks"]
        same = all(torch.equal(a, b) for k in rest for a, b in zip(
            tree.leaves(cut[k]), tree.leaves(dparams[k])))
    if got != want or not same:
        raise AssertionError(f"{tag} the {n}-layer build's blocks digest "
                             f"{got}, the full model's first {n} {want}; "
                             f"{rest} equal: {same}")
    log(f"{tag} init_deploy of {n} layers == the full-depth model's first "
        f"{n} blocks (words digest {got}) and its {rest}, bitwise "
        f"({time.perf_counter() - t0:.1f} s)")
    del cut
    torch.cuda.empty_cache()


def check_init_deploy(arch: str, n: int) -> None:
    """On the card, ``init_deploy`` against ``convert(init)`` of ``arch``
    cut to ``n`` layers at full width: every leaf bitwise (the expert
    path and the card generator's offsets over ~20 GB of draws for
    mixtral's 2 layers)."""
    import torch
    from repro_torch import tree
    from repro_torch.configs import get_config
    from repro_torch.models.lm import build_model
    model = build_model(get_config(arch).truncated(n))
    t0 = time.perf_counter()
    with torch.inference_mode():
        want = model.convert(model.init(
            torch.Generator(device="cuda").manual_seed(SEED)))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        torch.cuda.empty_cache()
        got = model.init_deploy(
            torch.Generator(device="cuda").manual_seed(SEED))
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        g, w = tree.leaves_with_paths(got), tree.leaves_with_paths(want)
        bad = sum(not (p == q and a.dtype == b.dtype and torch.equal(a, b))
                  for (p, a), (q, b) in zip(g, w))
        size = sum(a.numel() * a.element_size() for _, a in g)
    if bad or len(g) != len(w):
        raise AssertionError(f"[init_deploy] {arch}, {n} layers: {bad} of "
                             f"{len(w)} leaves differ from "
                             f"convert(init)")
    log(f"[init_deploy] {arch} at full width, {n} layers: init_deploy == "
        f"convert(init) bitwise, all {len(g)} leaves ({size / 2**30:.2f}"
        f" GiB of deploy params; {model.cfg.param_count() / 1e9:.2f} B "
        f"parameters drawn); convert(init) {t1 - t0:.1f} s, init_deploy "
        f"{t2 - t1:.1f} s")
    del got, want, g, w
    torch.cuda.empty_cache()


def moe_text(cfg) -> str:
    """A MoE config's routing and its active parameters, for the logs."""
    if not cfg.moe.num_experts:
        return ""
    m = cfg.moe
    residual = ", a dense residual FFN" if m.dense_residual else ""
    return (f", {m.num_experts} experts top-{m.top_k} at capacity factor "
            f"{m.capacity_factor}{residual}, window "
            f"{cfg.window_size or 'full'}; "
            f"{cfg.active_param_count() / 1e9:.3f} B active")


def serve_static(model, dparams, tag: str,
                 shape=(SERVE_B, SERVE_S, SERVE_NEW), path=STATIC_PATH,
                 expect=None, frontend=None, caches_equal=False,
                 prompts=None, stats=None) -> tuple:
    """B = 8 prompts of 128 tokens and 32 greedy tokens each (or the
    (B, S, new tokens) of ``shape``) through ``ServeEngine.generate``,
    rings of S + new tokens (a windowed layer's: its window), the decode
    step a replayed graph; every kernel of ``path`` must launch, and with
    ``expect`` ({"prefill" / "decode": {kernel: launches}}) the prefill
    and each decode step launch exactly those.  ``frontend`` passes the
    frontend embeddings (a decoder-only model's rings then hold them
    too); ``caches_equal`` also holds the graph's caches to the eager
    steps' bitwise (``check_static_graph``).  ``prompts`` (B, S) replace
    the ones drawn from ``SEED``.  Returns the launch counts of the run
    and the wall ms per decode step; ``stats`` (a dict) also takes the
    prefill ms, the tokens per second and the launches per prefill and
    per decode step."""
    import torch
    from repro_torch import kernels
    from repro_torch.serve.engine import (CacheConfig, ServeConfig,
                                          ServeEngine)
    cfg = model.cfg
    n_b, n_s, n_new = shape
    if prompts is None:
        prompts = np.random.default_rng(SEED).integers(
            0, cfg.vocab_size, (n_b, n_s)).astype(np.int32)
    fe = {} if frontend is None else {"frontend_embeds": frontend}
    max_len = n_s + n_new + ring_prefix(model, frontend)
    eng = ServeEngine(model, dparams, ServeConfig(
        cache=CacheConfig(max_len=max_len)))
    t0 = time.perf_counter()
    eng.generate(prompts, max_new_tokens=2, **fe)   # warm-up: captures
    torch.cuda.synchronize()
    log_captures(tag, eng, time.perf_counter() - t0)
    captures = dict(eng._graphs.captures)
    torch.cuda.reset_peak_memory_stats()

    marks = []

    def on_token(step, tokens):
        # generate copied the tokens to the host: the card is idle here
        marks.append((time.perf_counter(), kernels.launch_counts()))

    probe = IterationProbe(eng)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    toks, report = eng.generate(prompts, max_new_tokens=n_new,
                                stream_cb=on_token, **fe)
    total = time.perf_counter() - t0
    launches = kernels.launch_counts()
    if toks.shape != (n_b, n_new) or toks.min() < 0 or \
            toks.max() >= cfg.vocab_size:
        raise AssertionError(f"{tag} bad tokens {toks.shape} "
                             f"[{toks.min()}, {toks.max()}]")
    idle = [n for n in path if launches[n] == 0]
    if idle:
        raise AssertionError(f"{tag} kernels {idle} never launched on the "
                             f"static path: {launches}")
    if eng._graphs.captures != captures or captures["decode"] != 1:
        raise AssertionError(f"{tag} captures {eng._graphs.captures} "
                             f"after the warm-up's {captures}")
    (t_pre, c_pre), (t_end, c_end) = marks[0], marks[-1]
    steps = n_new - 1
    per_step = {n: (c_end[n] - c_pre[n]) / steps for n in launches}
    eager_step = check_static_graph(model, dparams, prompts, tag,
                                    max_len, frontend, caches_equal)
    if per_step != {n: float(c) for n, c in eager_step.items()}:
        raise AssertionError(f"{tag} launches per replayed decode step "
                             f"{per_step}, per eager step {eager_step}")
    for kind, got in (("prefill", c_pre), ("decode", per_step)):
        want = (expect or {}).get(kind)
        if want is not None and {n: c for n, c in got.items() if c} != want:
            raise AssertionError(f"{tag} launches per {kind} {got}, "
                                 f"expected {want}")
    log(f"{tag} launches per prefill {json.dumps(c_pre)}")
    log(f"{tag} launches per decode step (credited by the replays, equal "
        f"to the eager step's) {json.dumps(per_step)}")
    log(f"{tag} B={n_b} prompts of {n_s} tokens, {n_new} "
        f"greedy tokens: prefill {1e3 * (t_pre - t0):.1f} ms, decode "
        f"{1e3 * (t_end - t_pre) / steps:.2f} ms/step (graph replays), "
        f"total {total:.3f} s,"
        f" {n_b * n_new / total:.1f} tok/s, decode "
        f"{n_b * steps / (t_end - t_pre):.1f} tok/s; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB; KV cache "
        f"{report['total_bytes'] / 2**20:.2f} MiB "
        f"({report['compression_vs_bf16']:.2f}x below its bf16 "
        f"equivalent, {report['bf16_equivalent_bytes'] / 2**20:.2f} MiB)")
    log(f"{tag} sample tokens {toks[0, :8].tolist()}; all {toks.size} "
        f"tokens' digest {digest(toks.tolist())}")
    step_ms = 1e3 * (t_end - t_pre) / steps
    if stats is not None:
        stats.update(tokens=toks, prefill_ms=1e3 * (t_pre - t0),
                     step_ms=step_ms,
                     tok_s=n_b * n_new / total,
                     prefill={n: c for n, c in c_pre.items() if c},
                     decode={n: c for n, c in per_step.items() if c})
    walls = [1e3 * (t1 - t0) for (t0, _), (t1, _) in zip(marks, marks[1:])]
    replays = [r for k, _, _, r in probe.stamps if k == "decode"]
    host = [w - r for w, r in zip(walls, replays)]
    log(f"{tag} decode replay to its end (median) "
        f"{np.median(replays):.2f} ms; the host's own work per step outside "
        f"the replay (median, mean) {np.median(host):.2f}, "
        f"{np.mean(host):.2f} ms")
    profile_decode(eng, step_ms, tag, n_b)
    return launches, step_ms


GRAPH_CHECK_STEPS = 8


def ring_prefix(model, frontend) -> int:
    """Positions a decoder-only model's rings hold before the prompt: its
    frontend embeddings (an encoder-decoder's rings hold the prompt
    only)."""
    if frontend is None or not hasattr(model, "plan"):
        return 0
    return frontend.shape[1]


def check_static_graph(model, dparams, prompts, tag: str,
                       max_len: int = SERVE_S + SERVE_NEW, frontend=None,
                       caches_equal: bool = False) -> dict:
    """The decode step captured as a graph against a test-local eager loop
    of ``decode_step`` from the same prefilled state: equal tokens and
    bitwise-equal logits at every step (the first call captures), the
    same launches per step (with ``caches_equal`` also every cache tensor
    bitwise after the steps); each step's wall time (ending in the tokens'
    copy to the host, as the engine's) in turns, eager then graph.
    ``frontend`` passes the frontend embeddings to the prefill.
    Returns the eager step's launch counts."""
    import torch
    from repro_torch import kernels
    from repro_torch.serve import graphs
    fe = {} if frontend is None else {
        "frontend_embeds": torch.as_tensor(frontend, device="cuda")}
    with torch.inference_mode():
        logits, eager = model.prefill_with_cache(
            dparams, torch.as_tensor(prompts, device="cuda"),
            max_len=max_len, **fe)
        caches = clone_caches(eager)
        g = graphs.StepGraph(
            lambda tokens: model.decode_step(dparams, tokens, caches)[0],
            {"tokens": (len(prompts), 1)}, device=torch.device("cuda"),
            state=graphs.cache_tensors(caches))
        tok = logits.argmax(-1).cpu()
        ms = {"eager": [], "graph": []}
        for step in range(GRAPH_CHECK_STEPS):
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            want, _ = model.decode_step(dparams, tok.cuda(), eager)
            tok_e = want[:, -1:].argmax(-1).cpu()
            t1 = time.perf_counter()
            counted = kernels.launch_counts()
            kernels.reset_launch_counts()
            got = g(tokens=tok.numpy())
            tok_g = got[:, -1:].argmax(-1).cpu()
            t2 = time.perf_counter()
            if step:     # the first graph call warms up and captures
                ms["eager"].append(1e3 * (t1 - t0))
                ms["graph"].append(1e3 * (t2 - t1))
                if kernels.launch_counts() != counted:
                    raise AssertionError(
                        f"{tag} graph check: a replay credited "
                        f"{kernels.launch_counts()}, the eager step "
                        f"counted {counted}")
            if not (torch.equal(got, want) and torch.equal(tok_e, tok_g)):
                raise AssertionError(
                    f"{tag} graph check: decode step {step} replayed "
                    f"differs from eager, max |logit diff| "
                    f"{(got - want).abs().max().item()}")
            tok = tok_e
        if caches_equal:
            pairs = list(zip(graphs.cache_tensors(caches),
                             graphs.cache_tensors(eager)))
            if not all(torch.equal(a, b) for a, b in pairs):
                raise AssertionError(f"{tag} graph check: the replayed "
                                     f"steps' caches differ from the eager "
                                     f"steps'")
    out = {k: float(np.median(v)) for k, v in ms.items()}
    log(f"{tag} graph == eager: {GRAPH_CHECK_STEPS} decode steps from the "
        f"same prefill, equal tokens, logits bitwise equal"
        f"{f', all {len(pairs)} cache tensors bitwise equal' if caches_equal else ''}"
        f"; median ms per step (tokens on the host), in turns: eager "
        f"{out['eager']:.2f}, graph replay {out['graph']:.2f}")
    return counted


def profile_decode(eng, step_ms: float, tag: str, batch: int) -> None:
    """Where a decode step's time goes: device busy time of a replay of the
    engine's decode graph (sum of kernel times under torch.profiler)
    against the step's wall time from the serve run; the rest is the card
    waiting for the host."""
    import torch
    g = next(g for (kind, _), g in eng._graphs.graphs.items()
             if kind == "decode")
    tok = np.zeros((batch, 1), np.int64)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    for _ in range(100):
        g(tokens=tok)
    torch.cuda.synchronize()
    if torch.cuda.memory_allocated() != before:
        raise AssertionError(f"{tag} 100 replays moved memory_allocated "
                             f"from {before} to "
                             f"{torch.cuda.memory_allocated()}")
    log(f"{tag} 100 decode replays allocated nothing "
        f"(memory_allocated {before} bytes before and after)")
    with torch.inference_mode():
        busy, launches, by_name, host_ops = device_profile(
            lambda: g(tokens=tok), iters=3, host=True)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    log(f"{tag} decode replay profile: device busy {busy:.3f} ms of "
        f"{step_ms:.2f} ms wall (idle share {1 - busy / step_ms:.3f}), "
        f"{launches:.0f} CUDA kernels per replay")
    for name, ms in top:
        log(f"{tag}   {ms:.4f} ms/step  {name[:90]}")
    log(f"{tag} device ms per decode step of our kernels "
        f"{json.dumps(our_kernels_ms(by_name))}")
    log_host_ops(tag, host_ops)


def log_captures(tag: str, eng, first_s: float) -> None:
    """The engine's captured steps: count by kind, the seconds spent
    warming up and capturing, the graph pool's reserved memory."""
    g = eng._graphs
    log(f"{tag} captures {json.dumps(g.captures)}: {g.capture_s:.3f} s of "
        f"warm-up and capture within the first call's {first_s:.3f} s; graph "
        f"pool {g.pool_bytes() / 2**20:.1f} MiB")


def clone_caches(caches):
    """A copy of per-layer caches, every tensor cloned."""
    import torch
    return [{k: type(v)(*[t.clone() if isinstance(t, torch.Tensor) else t
                          for t in v]) for k, v in c.items()}
            for c in caches]


def log_host_ops(tag: str, host_ops) -> None:
    """The host side of a profiled step: total self time, op calls and
    the largest ops."""
    log(f"{tag} host ops per step (traced): "
        f"{sum(t for _, t, _ in host_ops):.2f} ms of self time in "
        f"{sum(n for _, _, n in host_ops):.0f} op calls; the largest:")
    for name, t, n in host_ops[:10]:
        log(f"{tag}   {t:.3f} ms  {n:5.0f} calls  {name[:70]}")


# -- phase 5: continuous ------------------------------------------------------

CONT_TRACE = dict(n_requests=24, mean_prompt=96, max_prompt=256,
                  mean_new=32, max_new=64, seed=SEED)
# 16 slots, 12 blocks of 32 tokens, 48 pages (a quarter of 16 x 12: the
# trace shares its 64-token system prompt, so half would never preempt),
# chunks of 128
CONT_SLOTS, CONT_PAGE, CONT_BLOCKS = 16, 32, 12
CONT_PAGES, CONT_CHUNK = 48, 128


@dataclasses.dataclass(frozen=True)
class Cell:
    """A continuous-serving run: the ``serve/trace.py`` trace (its shared
    system prompt of ``system_prompt`` tokens, every arrival at 0) and the
    engine's shape (slots; pages of ``page`` tokens, ``blocks`` a table
    row, ``pages`` in the full-capacity group's arena; chunks)."""
    trace: dict
    system_prompt: int
    slots: int
    page: int
    blocks: int
    pages: int
    chunk: int
    paged: bool = True


CONT = Cell(CONT_TRACE, 64, CONT_SLOTS, CONT_PAGE, CONT_BLOCKS, CONT_PAGES,
            CONT_CHUNK)


class IterationProbe:
    """The engine's captured steps, with a stamp at the start of every
    replay the engine runs: wall time and launch counts (the replays
    credit them).  The engine copies each iteration's sampled tokens to
    the host before the next one starts, so the span between two stamps
    is one whole iteration, host work included.  Each replay is timed to
    its end (a synchronize right after it, where the engine's sampling
    would wait anyway), so the rest of the iteration is the host's own
    work outside the replay.  After ``profile_after[kind]`` iterations of
    a kind (``decode``, ``spec``, ``mixed``), one more replays under
    torch.profiler
    (and is left out of the timings)."""

    def __init__(self, eng, profile_after=None):
        self.stamps = []    # [kind, perf_counter, launch counts, replay ms]
        self.profile_after = profile_after or {}
        self.profile = {}   # kind -> (busy ms, CUDA kernels, by name, host)
        get = eng._graphs.get

        def probed(kind, *args, **kw):
            g = get(kind, *args, **kw)
            return lambda **values: self._run(
                "mixed" if kind == "unified" else kind, g, values)
        eng._graphs.get = probed

    def _stamp(self, kind):
        from repro_torch import kernels
        self.stamps.append([kind, time.perf_counter(),
                            kernels.launch_counts(), None])

    def _run(self, kind, g, values):
        import torch
        n = sum(1 for k, *_ in self.stamps if k == kind)
        if kind not in self.profile and kind in self.profile_after and \
                n >= self.profile_after[kind]:
            self._stamp("profiled")
            out = {}

            def step():
                out["r"] = g(**values)
            self.profile[kind] = device_profile(step, iters=1, warm=False,
                                                host=True)
            return out["r"]
        self._stamp(kind)
        t0 = time.perf_counter()
        out = g(**values)
        torch.cuda.synchronize()
        self.stamps[-1][3] = 1e3 * (time.perf_counter() - t0)
        return out

    def iterations(self, end_time, end_counts):
        """[(kind, ms, {kernel: launches}, replay ms)] per iteration."""
        marks = self.stamps + [("end", end_time, end_counts, None)]
        return [(k, 1e3 * (t1 - t0), {n: c1[n] - c0[n] for n in c0}, r)
                for (k, t0, c0, r), (_, t1, c1, _) in zip(marks, marks[1:])]


def continuous_requests(cfg, cell: Cell = CONT):
    """The trace's requests, every arrival at 0."""
    from repro_torch.serve import trace
    reqs = trace.as_requests(trace.generate_trace(trace.TraceConfig(
        vocab=cfg.vocab_size, tenants=(trace.TenantSpec(
            "default", system_prompt_len=cell.system_prompt),),
        **cell.trace)))
    for r in reqs:
        r.arrival_s = 0.0
    return reqs


def continuous_config(spec_k=None, cell: Cell = CONT):
    """The continuous phase's engine: 16 slots, 48 pages of 32 with prefix
    sharing, chunks of 128 (or ``cell``'s shape); with ``spec_k``
    speculative decode by a one-layer draft."""
    from repro_torch.serve.engine import (CacheConfig, PolicyConfig,
                                          ServeConfig, SpecConfig)
    return ServeConfig(num_slots=cell.slots, cache=CacheConfig(
        max_len=cell.blocks * cell.page, paged=cell.paged,
        page_size=cell.page, max_blocks=cell.blocks,
        num_pages=cell.pages, prefix_share=True),
        policy=PolicyConfig(prefill_chunk=cell.chunk),
        spec=SpecConfig(k=spec_k, draft_layers=SPEC_DRAFT))


def phase_continuous(model, dparams, tag: str = "[continuous]",
                     cell: Cell = CONT, expect=None, path=PAGED_PATH,
                     pressure: bool = True, stats=None):
    """Full-width smollm-135m (or ``model``) through ``ServeEngine.serve``
    on the pool of ``cell`` (paged, or contiguous rings); ``expect``
    ({iteration kind: {kernel: launches}}) holds every iteration of a kind
    to those counts; every kernel of ``path`` must launch; ``pressure``
    demands a preemption and a prefix hit (a stack without attention has
    no page arena).  Each pure-decode iteration launches one
    ``paged_gather_decode`` per attention layer of a paged pool.  A dict
    ``stats`` takes the median ms per iteration by kind.  Returns the
    launch counts of the run and its tokens by rid."""
    import torch
    from repro_torch import kernels
    from repro_torch.serve.engine import ServeEngine
    cfg = continuous_config(cell=cell)
    reqs = continuous_requests(model.cfg, cell)
    eng = ServeEngine(model, dparams, cfg)
    t0 = time.perf_counter()
    first, _ = eng.serve(continuous_requests(model.cfg, cell))  # captures
    torch.cuda.synchronize()
    log_captures(tag, eng, time.perf_counter() - t0)
    captures = dict(eng._graphs.captures)
    probe = IterationProbe(eng, profile_after={"decode": 8, "mixed": 2})
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    res, rep = eng.serve(reqs)
    total = time.perf_counter() - t0
    launches = kernels.launch_counts()
    its = probe.iterations(t0 + total, launches)
    if eng._graphs.captures != captures or \
            captures != {"unified": 1, "decode": 1, "spec": 0}:
        raise AssertionError(f"{tag} captures {eng._graphs.captures} "
                             f"after the first serve's {captures}")
    changed = [rid for rid in res if not np.array_equal(res[rid],
                                                        first[rid])]
    if changed:
        raise AssertionError(f"{tag} the second serve's tokens differ "
                             f"from the first's for rids {changed}")
    short = [r.rid for r in reqs if len(res[r.rid]) != r.max_new_tokens]
    if short:
        raise AssertionError(f"{tag} requests {short} did not get "
                             f"their budget (no EOS is set)")
    if pressure and (rep.preemptions < 1 or rep.prefix_hits < 1):
        raise AssertionError(f"{tag} expected a preemption and a "
                             f"prefix hit, got {rep.preemptions} and "
                             f"{rep.prefix_hits}")
    idle = [n for n in path if launches[n] == 0]
    if idle:
        raise AssertionError(f"{tag} kernels {idle} never launched "
                             f"on the paged path: {launches}")
    dec = [(ms, c) for k, ms, c, _ in its if k == "decode"]
    mix = [(ms, c) for k, ms, c, _ in its if k == "mixed"]
    host = {kind: [ms - r for k, ms, _, r in its if k == kind]
            for kind in ("decode", "mixed")}
    replay = {kind: [r for k, _, _, r in its if k == kind]
              for kind in ("decode", "mixed")}
    check_iterations(tag, its, expect)
    per_layer = {c["paged_gather_decode"] for _, c in dec}
    n_attn = sum(k in ("attn", "hybrid") for k, _ in model.plan) \
        if cell.paged else 0
    if per_layer != {n_attn}:
        raise AssertionError(f"{tag} paged_gather_decode launches "
                             f"per pure-decode iteration {per_layer}, not "
                             f"{n_attn}")
    tokens = sum(len(t) for t in res.values())
    profiled_s = sum(ms for k, ms, _, _ in its if k == "profiled") / 1e3
    by_rid = sorted((rid, [int(x) for x in t]) for rid, t in res.items())
    log(f"{tag} tokens by rid, digest {digest(by_rid)}")
    ms = lambda rows: [m for m, _ in rows]
    if stats is not None:
        stats.update(decode=float(np.median(ms(dec))),
                     mixed=float(np.median(ms(mix))))
    prompt = sum(len(r.tokens) for r in reqs)
    pool = (f"{cell.pages} pages of {cell.page} "
            f"({cell.pages / (cell.slots * cell.blocks):.2f} of "
            f"{cell.slots} x {cell.blocks})" if cell.paged else
            f"contiguous rings of {cell.blocks * cell.page}")
    log(f"{tag} {len(reqs)} requests ({prompt} prompt tokens, "
        f"{tokens} generated), {cell.slots} slots, {pool}, chunks of "
        f"{cell.chunk}: {total:.3f} s, "
        f"{tokens / total:.1f} tok/s; without the profiled iterations "
        f"{total - profiled_s:.3f} s, {tokens / (total - profiled_s):.1f} "
        f"tok/s")
    log(f"{tag} iterations (graph replays): {len(dec)} pure-decode, "
        f"median {np.median(ms(dec)):.2f} ms, mean {np.mean(ms(dec)):.2f} "
        f"ms; {len(mix)} mixed, median {np.median(ms(mix)):.2f} ms, mean "
        f"{np.mean(ms(mix)):.2f} ms; 1 of each profiled (not timed); "
        f"engine report: unified_compiles {rep.unified_compiles:.0f}, "
        f"engine_compiles {rep.engine_compiles:.0f}")
    log(f"{tag} replay to its end (median): pure-decode "
        f"{np.median(replay['decode']):.2f} ms, mixed "
        f"{np.median(replay['mixed']):.2f} ms; the host's own work outside "
        f"the replay (median, mean): pure-decode "
        f"{np.median(host['decode']):.2f}, {np.mean(host['decode']):.2f} ms; "
        f"mixed {np.median(host['mixed']):.2f}, "
        f"{np.mean(host['mixed']):.2f} ms")
    mix_mean = {n: float(np.mean([c[n] for _, c in mix])) for n in launches}
    log(f"{tag} launches per pure-decode iteration "
        f"{json.dumps(dec[0][1])}; per mixed iteration (mean) "
        f"{json.dumps(mix_mean)}")
    if eng.arenas:
        log(f"{tag} preemptions {rep.preemptions:.0f}, peak page "
            f"utilization {rep.peak_page_utilization:.3f}, prefix hit rate "
            f"{rep.prefix_hit_rate:.3f} ({rep.prefix_hits:.0f} of "
            f"{rep.prefix_lookups:.0f}), COW copies {rep.cow_copies:.0f}, "
            f"pages freed {rep.pages_freed_retire:.0f}, peak mapped pages "
            f"{rep.peak_page_bytes / 2**20:.2f} MiB")
    log(f"{tag} peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB; caches "
        f"(pages, rings, tables, carries) {rep.total_bytes / 2**20:.2f} "
        f"MiB against {rep.bf16_equivalent_bytes / 2**20:.2f} MiB in bf16 "
        f"({rep.compression_vs_bf16:.2f}x)")
    log(f"{tag} by ring group (logical ring length: pages, peak used, "
        f"prefix lookups, hits, COW copies) " + json.dumps({
            ring: [a.num_pages, a.peak_pages, a.prefix_lookups,
                   a.share_hits, a.cow_copies]
            for ring, a in eng.arenas.items()}))
    busy, n_kernels, by_name, _ = probe.profile["mixed"]
    mix_ms = float(np.median(ms(mix)))
    log(f"{tag} mixed replay profile: device busy {busy:.3f} ms of "
        f"{mix_ms:.2f} ms wall (idle share {1 - busy / mix_ms:.3f}), "
        f"{n_kernels:.0f} CUDA kernels; our kernels' device ms "
        f"{json.dumps(our_kernels_ms(by_name))}")
    for name, t in sorted(by_name.items(), key=lambda kv: -kv[1])[:6]:
        log(f"{tag}   {t:.4f} ms  {name[:90]}")
    busy, n_kernels, by_name, host_ops = probe.profile["decode"]
    step_ms = float(np.median(ms(dec)))
    log(f"{tag} pure-decode replay profile: device busy "
        f"{busy:.3f} ms of {step_ms:.2f} ms wall (idle share "
        f"{1 - busy / step_ms:.3f}), {n_kernels:.0f} CUDA kernels")
    for name, t in sorted(by_name.items(), key=lambda kv: -kv[1])[:6]:
        log(f"{tag}   {t:.4f} ms  {name[:90]}")
    log(f"{tag} device ms per pure-decode iteration of our kernels "
        f"{json.dumps(our_kernels_ms(by_name))}")
    log_host_ops(tag, host_ops)
    check_paged_graph(model, dparams, tag, cell)
    return launches, res


def check_iterations(tag: str, its, expect) -> None:
    """Every iteration of a kind in ``expect`` ({kind: {kernel:
    launches}}) launched those counts (the replays credit them)."""
    for kind, want in (expect or {}).items():
        got = [{n: c[n] for n in want} for k, _, c, _ in its if k == kind]
        bad = [g for g in got if g != want]
        if not got or bad:
            raise AssertionError(f"{tag} launches per {kind} iteration "
                                 f"{bad[:1] or got}, expected {want}")
        log(f"{tag} each of {len(got)} {kind} iterations launched "
            f"{json.dumps(want)}")


def shared_tables(caches):
    """Per-layer paged caches whose layers of one ring group share one
    block table (the first layer's of the group), as the engine's do."""
    tables = {}
    return [dict(c, attn=c["attn"]._replace(block_table=tables.setdefault(
        c["attn"].ring_len, c["attn"].block_table))) if "attn" in c else c
        for c in caches]


def set_tables(caches, rng, live: int, pages: int = 4) -> None:
    """Map ``pages`` distinct random pages to each of the first ``live``
    rows of every ring group's (shared) table; the other rows stay on
    the trash page."""
    import torch
    done = set()
    for c in caches:
        pg = c.get("attn")
        if pg is None or pg.ring_len in done:
            continue
        done.add(pg.ring_len)
        b, nblk = pg.block_table.shape
        table = np.zeros((b, nblk), np.int32)
        n = min(pages, nblk)
        table[:live, :n] = 1 + rng.permutation(pg.k_pages.shape[0] - 1)[
            :n * live].reshape(live, n)
        pg.block_table.copy_(torch.from_numpy(table))


def check_paged_graph(model, dparams, tag: str, cell: Cell = CONT) -> None:
    """The unified and pooled decode steps captured as graphs against eager
    steps from the same paged state, at the continuous phase's shapes (16
    slots, chunks of 128, 12 blocks of 32, 48 pages; or ``cell``'s): 3/4
    of the rows live with 4 pages each in every ring group, the others
    inactive on the trash page: equal tokens and bitwise-equal logits on
    the live rows, equal pages 1.., lengths and recurrent carries (every
    row's; after the unified step the inactive rows' carries still hold
    their init values bit for bit).  The trash page takes colliding
    writes in an order no version fixes, so the inactive rows' logits are
    not compared."""
    import torch
    from repro_torch.models.attention import PageSpec
    from repro_torch.serve import graphs
    dev = torch.device("cuda")
    spec = PageSpec(page_size=cell.page, max_blocks=cell.blocks,
                    num_pages=cell.pages)
    b = cell.slots
    live = 3 * b // 4

    rng = np.random.default_rng(SEED + 4)
    with torch.inference_mode():
        eager = shared_tables(model.init_caches(b, 0, dev, paged=spec))
        set_tables(eager, rng, live)
        caches = shared_tables(clone_caches(eager))
        state = graphs.cache_tensors(caches)

        def unified(tokens, start, valid):
            return model.prefill_with_cache(dparams, tokens, caches=caches,
                                            start=start, seq_lens=valid)[0]
        uni = graphs.StepGraph(unified, {"tokens": (b, cell.chunk),
                                         "start": (b,), "valid": (b,)},
                               device=dev, state=state)
        dec = graphs.StepGraph(
            lambda tokens: model.decode_step(dparams, tokens, caches)[0],
            {"tokens": (b, 1)}, device=dev, state=state)
        init = clone_caches(eager)
        valid = np.zeros(b, np.int64)
        valid[:live] = rng.integers(1, 121, live)
        toks = rng.integers(0, model.cfg.vocab_size, (b, cell.chunk))
        start = np.zeros(b, np.int64)
        steps = [("unified", dict(tokens=toks, start=start, valid=valid))]
        steps += [("decode", None)] * 6
        tok = None
        for i, (kind, kw) in enumerate(steps):
            if kind == "unified":
                want = model.prefill_with_cache(
                    dparams, torch.from_numpy(toks).to(dev), caches=eager,
                    start=torch.from_numpy(start).to(dev),
                    seq_lens=torch.from_numpy(valid).to(dev))[0]
                got = uni(**kw)
            else:
                want, _ = model.decode_step(dparams, tok.to(dev), eager)
                got = dec(tokens=tok.numpy())
            if not torch.equal(got[:live], want[:live]):
                raise AssertionError(
                    f"{tag} graph check: paged {kind} step {i} replayed "
                    f"differs from eager, max |logit diff| "
                    f"{(got[:live] - want[:live]).abs().max().item()}")
            for e, c, z in zip(eager, caches, init):
                if "attn" in e:
                    e1, c1 = e["attn"], c["attn"]
                    if not (torch.equal(e1.k_pages[1:], c1.k_pages[1:]) and
                            torch.equal(e1.vt_pages[1:], c1.vt_pages[1:])
                            and torch.equal(e1.length, c1.length)):
                        raise AssertionError(f"{tag} graph check: paged "
                                             f"{kind} step {i}: pages or "
                                             f"lengths differ")
                for name in set(e) & {"mamba", "cell"}:
                    same = all(torch.equal(a, g)
                               for a, g in zip(e[name], c[name]))
                    frozen = kind != "unified" or all(
                        torch.equal(g[live:], i0[live:])
                        for g, i0 in zip(c[name], z[name]))
                    if not (same and frozen):
                        raise AssertionError(
                            f"{tag} graph check: {kind} step {i}: the "
                            f"{name} carries differ from eager ({not same}) "
                            f"or an inactive row's moved ({not frozen})")
            tok = want[:, -1:].argmax(-1).cpu()
    carries = ("; recurrent carries bitwise equal, inactive rows frozen"
               if any("mamba" in c or "cell" in c for c in caches) else "")
    log(f"{tag} graph == eager: a unified chunk of {cell.chunk} "
        f"(valid {valid[:live].min()}..{valid[:live].max()}, "
        f"{b - live} inactive rows) and 6 pooled decode steps from the same "
        f"paged state: live rows' logits bitwise equal, pages and lengths "
        f"equal{carries}")


# -- phase 5b: speculative ----------------------------------------------------

# k = 4 drafted tokens per slot, a one-layer draft on the trunk's weights
SPEC_K, SPEC_DRAFT = 4, 1
# the kernels a speculative serve launches (its verify attends over the
# gathered ring view, as the JAX engine's does: no paged_gather_decode)
SPEC_PATH = ("pack_threshold", "rbmm_int", "rbmm_mxu")


def phase_speculative(model, dparams, plain):
    """Phase 5's trace and engine shape with speculative decode, in bf16:
    served twice on one engine (the first serve captures) and measured;
    its tokens by rid against phase 5's plain tokens ``plain`` (logged:
    in bf16 the tokens depend on the schedule, see
    ``log_bf16_schedule``); then the gate in float32 (``gate_float32``).
    Returns the launch counts of the timed serve."""
    import torch
    from repro_torch import kernels
    from repro_torch.serve.engine import ServeEngine
    reqs = continuous_requests(model.cfg)
    eng = ServeEngine(model, dparams, continuous_config(SPEC_K))
    t0 = time.perf_counter()
    first, _ = eng.serve(continuous_requests(model.cfg))  # captures
    torch.cuda.synchronize()
    log_captures("[speculative]", eng, time.perf_counter() - t0)
    captures = dict(eng._graphs.captures)
    probe = IterationProbe(eng, profile_after={"spec": 8, "mixed": 2})
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    res, rep = eng.serve(reqs)
    total = time.perf_counter() - t0
    launches = kernels.launch_counts()
    its = probe.iterations(t0 + total, launches)
    if eng._graphs.captures != captures or \
            captures != {"unified": 1, "decode": 0, "spec": 1}:
        raise AssertionError(f"speculative: captures "
                             f"{eng._graphs.captures} after the first "
                             f"serve's {captures}")
    changed = [rid for rid in res if not np.array_equal(res[rid],
                                                        first[rid])]
    if changed:
        raise AssertionError(f"speculative: the second serve's tokens "
                             f"differ from the first's for rids {changed}")
    short = [r.rid for r in reqs if len(res[r.rid]) != r.max_new_tokens]
    if short or sorted(res) != sorted(plain):
        raise AssertionError(f"speculative: requests {short} did not get "
                             f"their budget (no EOS is set)")
    if rep.spec_steps < 1:
        raise AssertionError("speculative: no speculative iteration ran")
    idle = [n for n in SPEC_PATH if launches[n] == 0]
    if idle:
        raise AssertionError(f"speculative: kernels {idle} never launched: "
                             f"{launches}")
    spec = [(ms, c) for k, ms, c, _ in its if k == "spec"]
    mix = [(ms, c) for k, ms, c, _ in its if k == "mixed"]
    want = {n: spec_launches().get(n, 0) for n in launches}
    bad = [c for _, c in spec if c != want]
    if bad:
        raise AssertionError(f"speculative: launches per spec iteration "
                             f"{bad[0]}, expected {want}")
    host = [ms - r for k, ms, _, r in its if k == "spec"]
    replay = [r for k, _, _, r in its if k == "spec"]
    tokens = sum(len(t) for t in res.values())
    profiled_s = sum(ms for k, ms, _, _ in its if k == "profiled") / 1e3
    by_rid = sorted((rid, [int(x) for x in t]) for rid, t in res.items())
    ms = lambda rows: [m for m, _ in rows]
    log(f"[speculative] tokens by rid, digest {digest(by_rid)}")
    log(f"[speculative] k={SPEC_K}, a {SPEC_DRAFT}-layer draft: spec_steps "
        f"{rep.spec_steps:.0f}, spec_accept_rate {rep.spec_accept_rate:.4f},"
        f" spec_tokens_per_step {rep.spec_tokens_per_step:.4f}, "
        f"pages_freed_rollback {rep.pages_freed_rollback:.0f}, preemptions "
        f"{rep.preemptions:.0f}, COW copies {rep.cow_copies:.0f}, prefix "
        f"hit rate {rep.prefix_hit_rate:.3f}")
    log(f"[speculative] {len(reqs)} requests, {tokens} tokens: {total:.3f} "
        f"s, {tokens / total:.1f} tok/s; without the profiled iterations "
        f"{total - profiled_s:.3f} s, {tokens / (total - profiled_s):.1f} "
        f"tok/s; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB")
    log(f"[speculative] iterations (graph replays): {len(spec)} spec, "
        f"median {np.median(ms(spec)):.2f} ms, mean {np.mean(ms(spec)):.2f} "
        f"ms; {len(mix)} mixed, median {np.median(ms(mix)):.2f} ms, mean "
        f"{np.mean(ms(mix)):.2f} ms; 1 of each profiled (not timed); one "
        f"replay per iteration")
    log(f"[speculative] spec replay to its end (median) "
        f"{np.median(replay):.2f} ms; the host's own work outside it "
        f"(median, mean) {np.median(host):.2f}, {np.mean(host):.2f} ms")
    log(f"[speculative] launches per spec iteration {json.dumps(spec[0][1])}")
    busy, n_kernels, by_name, host_ops = probe.profile["spec"]
    step_ms = float(np.median(ms(spec)))
    log(f"[speculative] spec replay profile: device busy {busy:.3f} ms of "
        f"{step_ms:.2f} ms wall (idle share {1 - busy / step_ms:.3f}), "
        f"{n_kernels:.0f} CUDA kernels")
    for name, t in sorted(by_name.items(), key=lambda kv: -kv[1])[:6]:
        log(f"[speculative]   {t:.4f} ms  {name[:90]}")
    log(f"[speculative] device ms per spec iteration of our kernels "
        f"{json.dumps(our_kernels_ms(by_name))}")
    log_host_ops("[speculative]", host_ops)
    for sampler in ("greedy", "top_k"):
        check_spec_graph(model, dparams, sampler)
    log_bf16_schedule(model, dparams, plain, res)
    gate_float32(dparams)
    return launches


def _differ(a, b) -> list:
    """Rids whose tokens differ between two results by rid."""
    return sorted(rid for rid in a if not np.array_equal(a[rid], b[rid]))


def log_bf16_schedule(model, dparams, plain, spec) -> None:
    """In bf16 a token's bits depend on the iteration that computes it:
    ``decode_step`` keeps a float32 residual stream, the unified forward
    (prefill chunks, and decode rows beside them) a bf16 one, and a
    preempted request recomputes its tokens' K/V through the latter.  So
    any change of schedule may move tokens, in the plain engine too: the
    same plain engine on an arena of twice phase 5's pages (no
    preemption) is served and compared with phase 5 beside the
    speculative serve."""
    from repro_torch.serve.engine import ServeEngine
    cfg = continuous_config()
    cfg.cache.num_pages = 2 * CONT_PAGES
    roomy, rep = ServeEngine(model, dparams, cfg).serve(
        continuous_requests(model.cfg))
    log(f"[speculative] bf16 tokens by rid against phase 5's plain serve: "
        f"{len(_differ(spec, plain))} of {len(plain)} requests differ "
        f"{_differ(spec, plain)}; the plain engine on {2 * CONT_PAGES} pages "
        f"({rep.preemptions:.0f} preemptions, against phase 5's 48 pages) "
        f"differs from phase 5 on {len(_differ(roomy, plain))} "
        f"{_differ(roomy, plain)}: in bf16 the tokens follow the schedule")


def gate_float32(dparams) -> None:
    """The gate of phase 5b: in float32, where every path computes the
    same function (decode == a width-1 chunk == a verify position, bit for
    bit), phase 5's trace on phase 5's engine shape must give the same
    tokens by rid plainly and speculatively."""
    from repro_torch.configs import get_config
    from repro_torch.models.lm import build_model
    from repro_torch.serve.engine import ServeEngine
    model = build_model(get_config("smollm-135m").with_(
        compute_dtype="float32"))
    runs = {}
    for k in (None, SPEC_K):
        runs[k] = ServeEngine(model, dparams, continuous_config(k)).serve(
            continuous_requests(model.cfg))
    (plain, _), (spec, rep) = runs[None], runs[SPEC_K]
    differ = _differ(spec, plain)
    if differ or sorted(spec) != sorted(plain) or rep.spec_steps < 1:
        raise AssertionError(f"speculative float32: tokens differ from the "
                             f"plain serve's for rids {differ}")
    by_rid = sorted((rid, [int(x) for x in t]) for rid, t in spec.items())
    log(f"[speculative] float32, phase 5's trace and engine shape: "
        f"speculative tokens equal the plain serve's for all {len(spec)} "
        f"requests (digest {digest(by_rid)}); spec_accept_rate "
        f"{rep.spec_accept_rate:.4f}, spec_tokens_per_step "
        f"{rep.spec_tokens_per_step:.4f}, preemptions "
        f"{rep.preemptions:.0f}")


SPEC_CHECK_ITERS = 3


def check_spec_graph(model, dparams, sampler: str) -> None:
    """The speculative engine's graphs against the same steps run eagerly
    from the same paged state, at phase 5b's shapes (16 slots, 48 pages of
    32, chunks of 128; 12 live rows of 4 pages, 4 inactive rows): a
    unified chunk that the draft ingests too, then speculative iterations.
    Live rows' logits and outputs bitwise equal, trunk pages 1.. and
    lengths equal, the draft's rings equal, the launches credited by a
    replay equal to the eager iteration's; and after each rollback the
    draft's rings equal those of a draft that ingested only the committed
    tokens.  ``top_k`` (temperature 1.5) draws from uniforms given to the
    graph, so some drafts are accepted and some rejected."""
    import torch
    from repro_torch import kernels
    from repro_torch.serve import sampler as sampler_lib
    from repro_torch.serve.engine import ServeEngine
    dev = torch.device("cuda")
    b, live, k = CONT_SLOTS, 12, SPEC_K
    cfg = continuous_config(SPEC_K)
    cfg.sampler, cfg.temperature = sampler, 1.5
    eng = ServeEngine(model, dparams, cfg)
    spec = cfg.page_spec()
    rng = np.random.default_rng(SEED + 5)
    t = lambda a: torch.from_numpy(np.asarray(a)).to(dev)

    def shared_table(caches):
        tb = caches[0]["attn"].block_table
        return [dict(c, attn=c["attn"]._replace(block_table=tb))
                for c in caches]

    def same(a, b, trash):
        for x, y in zip(a, b):
            x, y = x["attn"], y["attn"]
            pairs = ((x.k_pages[1:], y.k_pages[1:]),
                     (x.vt_pages[1:], y.vt_pages[1:]),
                     (x.length, y.length)) if trash else [
                (s, u) for s, u in zip(x, y) if isinstance(s, torch.Tensor)]
            if not all(torch.equal(s, u) for s, u in pairs):
                return False
        return True

    ms = {"eager": [], "graph": []}
    accepted = []
    with torch.inference_mode():
        key, caches = eng._pool_caches(b, spec)
        eng._resolve_draft()
        draft = eng._draft_caches(b, spec.capacity)
        dmodel, ddp = eng.draft_model, eng.draft_dparams
        table = np.zeros((b, CONT_BLOCKS), np.int32)
        table[:live, :4] = 1 + rng.permutation(CONT_PAGES)[:4 * live].reshape(
            live, 4)
        caches[0]["attn"].block_table.copy_(torch.from_numpy(table))
        eager = shared_table(clone_caches(caches))
        deager, dcommit = clone_caches(draft[1]), clone_caches(draft[1])
        valid = np.zeros(b, np.int64)
        valid[:live] = rng.integers(1, 101, live)   # + 3 x 5 within 4 pages
        toks = rng.integers(0, model.cfg.vocab_size, (b, CONT_CHUNK))
        zero = np.zeros(b, np.int64)
        got = eng._unified_graph(key, caches, CONT_CHUNK, draft)(
            tokens=toks, start=zero, valid=valid, fresh=(valid > 0) * 1)
        want, _ = model.prefill_with_cache(dparams, t(toks), caches=eager,
                                           start=t(zero), seq_lens=t(valid))
        for dc in (deager, dcommit):
            dmodel.prefill_with_cache(ddp, t(toks), caches=dc, start=t(zero),
                                      seq_lens=t(valid))
        if not (torch.equal(got[:live], want[:live]) and
                same(caches, eager, True) and same(draft[1], deager, False)):
            raise AssertionError(f"spec graph check ({sampler}): the unified "
                                 f"graph with the draft differs from eager")
        graph = eng._spec_graph(key, caches, draft)
        step = eng.spec_forward(eager, deager)
        gen = torch.Generator(device=dev).manual_seed(SEED)
        pending = want[:, -1].argmax(-1, keepdim=True).cpu().numpy()
        start, active = valid.copy(), (valid > 0) * 1
        for i in range(SPEC_CHECK_ITERS):
            inputs = dict(tokens=pending, start=start, active=active)
            if sampler != "greedy":
                inputs["rand"] = torch.randint(
                    0, 2 ** sampler_lib.UNIFORM_BITS, (b, 2 * k + 2),
                    generator=gen, device=dev)
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            res_g = graph(**inputs).cpu()
            t1 = time.perf_counter()
            credited = kernels.launch_counts()
            kernels.reset_launch_counts()
            res_e = step(**{n: v if isinstance(v, torch.Tensor) else t(v)
                            for n, v in inputs.items()}).cpu()
            t2 = time.perf_counter()
            if i:       # the first graph call warms up and captures
                ms["graph"].append(1e3 * (t1 - t0))
                ms["eager"].append(1e3 * (t2 - t1))
                if credited != kernels.launch_counts():
                    raise AssertionError(
                        f"spec graph check ({sampler}): a replay credited "
                        f"{credited}, the eager iteration counted "
                        f"{kernels.launch_counts()}")
            if not (torch.equal(res_g[:live], res_e[:live]) and
                    same(caches, eager, True) and
                    same(draft[1], deager, False)):
                raise AssertionError(f"spec graph check ({sampler}): "
                                     f"iteration {i} replayed differs from "
                                     f"eager")
            res = res_e.numpy()
            n_acc = res[:, k + 1]
            n_commit = active * (n_acc + 1)
            accepted += n_acc[:live].tolist()
            committed = np.concatenate([pending, res[:, :k]], axis=1)
            dmodel.prefill_with_cache(ddp, t(committed), caches=dcommit,
                                      start=t(start), seq_lens=t(n_commit))
            if not same(draft[1], dcommit, False):
                raise AssertionError(f"spec graph check ({sampler}): after "
                                     f"iteration {i} the draft's rings "
                                     f"differ from a draft that ingested "
                                     f"only the committed tokens")
            pending = res[np.arange(b), n_acc][:, None]
            start = start + n_commit
    log(f"[speculative] graph == eager ({sampler}): a unified chunk of "
        f"{CONT_CHUNK} with the draft and {SPEC_CHECK_ITERS} spec iterations "
        f"from the same paged state ({b - live} inactive rows): live rows "
        f"bitwise equal, pages, lengths and draft rings equal, launches "
        f"credited equal; accepted drafts per live row "
        f"{np.bincount(accepted, minlength=k + 1).tolist()} (0..{k}); the "
        f"draft's rings after each rollback equal a committed-only draft's;"
        f" median ms per iteration, in turns: eager "
        f"{np.median(ms['eager']):.2f}, graph replay "
        f"{np.median(ms['graph']):.2f}")


# -- phase 6: card vs CPU -----------------------------------------------------

CROSS_B, CROSS_S, CROSS_NEW = 2, 32, 4
CROSS_ATOL = 2e-3   # float32 logits; sums differ in order between devices


def _greedy_run(model, dparams, prompts, device,
                max_len: int = CROSS_S + CROSS_NEW, frontend=None):
    """prefill + greedy decode; returns (tokens (B, NEW), logits list).
    ``frontend`` passes frontend embeddings to the prefill."""
    import torch
    toks = torch.as_tensor(prompts, device=device)
    fe = {} if frontend is None else {
        "frontend_embeds": torch.as_tensor(frontend, device=device)}
    logits, caches = model.prefill_with_cache(dparams, toks, max_len=max_len,
                                              **fe)
    out, lgs = [], [logits.float().cpu()]
    for _ in range(CROSS_NEW):
        token = logits[:, -1:].argmax(-1)
        out.append(token.cpu())
        if len(out) == CROSS_NEW:
            break
        logits, caches = model.decode_step(dparams, token, caches)
        lgs.append(logits.float().cpu())
    return torch.cat(out, 1).numpy(), lgs


def phase_crosscheck(dparams):
    import torch
    from repro_torch import to_device
    from repro_torch.configs import get_config
    from repro_torch.models.lm import build_model
    from repro_torch.serve.engine import (CacheConfig, ServeConfig,
                                          ServeEngine)
    model = build_model(get_config("smollm-135m").with_(
        compute_dtype="float32"))
    prompts = np.random.default_rng(SEED + 1).integers(
        0, model.cfg.vocab_size, (CROSS_B, CROSS_S))
    on_cpu = to_device(dparams, "cpu")
    with torch.inference_mode():
        tok_card, lg_card = _greedy_run(model, dparams, prompts, "cuda")
        tok_cpu, lg_cpu = _greedy_run(model, on_cpu, prompts, "cpu")
    diff = max((a - b).abs().max().item() for a, b in zip(lg_card, lg_cpu))
    if not np.array_equal(tok_card, tok_cpu) or diff > CROSS_ATOL:
        raise AssertionError(
            f"crosscheck: card tokens {tok_card.tolist()} vs CPU "
            f"{tok_cpu.tolist()}, max |logit diff| {diff} (tol "
            f"{CROSS_ATOL})")
    cfg = ServeConfig(cache=CacheConfig(max_len=CROSS_S + CROSS_NEW))
    eng_card, _ = ServeEngine(model, dparams, cfg).generate(
        prompts, max_new_tokens=CROSS_NEW)
    eng_cpu, _ = ServeEngine(model, on_cpu, cfg, device="cpu").generate(
        prompts, max_new_tokens=CROSS_NEW)
    if not (np.array_equal(eng_card, tok_card) and
            np.array_equal(eng_cpu, tok_cpu)):
        raise AssertionError("crosscheck: ServeEngine tokens differ from "
                             "the prefill/decode loop")
    log(f"[crosscheck] float32 B={CROSS_B} S={CROSS_S} {CROSS_NEW} tokens: "
        f"card == CPU tokens {tok_card.tolist()}, max |logit diff| "
        f"{diff:.3g} <= {CROSS_ATOL}")
    plain = crosscheck_continuous(model, dparams, on_cpu)
    spec = crosscheck_continuous(model, dparams, on_cpu, spec_k=SPEC_K)
    differ = [rid for rid in plain if not np.array_equal(spec[rid],
                                                         plain[rid])]
    if differ:
        raise AssertionError(f"crosscheck: speculative tokens differ from "
                             f"plain ones for rids {differ}")
    crosscheck_full_depth_draft(model, dparams, plain)


# continuous card-vs-CPU: two requests share a 32-token page (a prefix
# hit), two fit one page at admission and both outgrow it on a 3-page
# arena (a preemption); chunks of 32 split the longer prompts
CROSS_CONT_NEW = 6
CROSS_CONT_COUNTERS = ("preemptions", "prefix_hits", "prefix_lookups",
                       "cow_copies", "pages_freed_retire", "iterations",
                       "prefill_chunks", "prefill_batches",
                       "peak_page_utilization")
CROSS_SPEC_COUNTERS = ("spec_steps", "spec_drafted", "spec_accepted",
                       "pages_freed_rollback", "unified_compiles",
                       "engine_compiles")


def cross_prompts(vocab: int, shared_len: int, with_shared, alone,
                  seed: int = SEED + 2):
    """Prompts of the continuous card-vs-CPU checks: a shared prefix of
    ``shared_len`` tokens followed by each of ``with_shared`` tokens, then
    prompts of ``alone`` tokens."""
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, vocab, shared_len)
    return [np.concatenate([shared, rng.integers(0, vocab, n)])
            for n in with_shared] + [rng.integers(0, vocab, n)
                                     for n in alone]


def crosscheck_continuous(model, dparams, on_cpu, spec_k=None, prompts=None,
                          blocks: int = 2, pages: int = 3, chunk: int = 32,
                          tag: str = "[crosscheck]", pressure: bool = True):
    """The same 4 requests on the card and on the CPU (plain versions),
    served plainly or, with ``spec_k``, speculatively by a one-layer draft:
    equal tokens by rid and equal counters (the spec group's too).  By
    default two requests share a 32-token page and two fit one page at
    admission and outgrow it on a 3-page arena; ``prompts``, ``blocks``,
    ``pages`` and ``chunk`` size another run; ``pressure`` False drops the
    demand for a preemption and a prefix hit (a stack of windows shorter
    than a page has neither).  Returns the card's tokens by rid."""
    import torch
    from repro_torch.serve.engine import (CacheConfig, PolicyConfig,
                                          Request, ServeConfig, ServeEngine,
                                          SpecConfig)
    if prompts is None:
        prompts = cross_prompts(model.cfg.vocab_size, 32, (2, 8), (30, 29))
    cfg = ServeConfig(num_slots=2, cache=CacheConfig(
        paged=True, page_size=32, max_blocks=blocks, num_pages=pages),
        policy=PolicyConfig(prefill_chunk=chunk),
        spec=SpecConfig(k=spec_k, draft_layers=SPEC_DRAFT))
    runs = {}
    for dev, params in (("cuda", dparams), ("cpu", on_cpu)):
        reqs = [Request(rid=i, tokens=p.astype(np.int32),
                        max_new_tokens=CROSS_CONT_NEW)
                for i, p in enumerate(prompts)]
        with torch.inference_mode():
            runs[dev] = ServeEngine(model, params, cfg,
                                    device=dev).serve(reqs)
    (res_card, rep_card), (res_cpu, rep_cpu) = runs["cuda"], runs["cpu"]
    bad = [rid for rid in res_cpu
           if not np.array_equal(res_card[rid], res_cpu[rid])]
    names = CROSS_CONT_COUNTERS + (CROSS_SPEC_COUNTERS if spec_k else ())
    counters = {k: (rep_card.get(k), rep_cpu.get(k)) for k in names}
    label, tag = tag, f"speculative k={spec_k}" if spec_k else "plain"
    if bad or sorted(res_card) != sorted(res_cpu) or \
            any(a != b for a, b in counters.values()):
        raise AssertionError(f"crosscheck continuous ({tag}): tokens differ "
                             f"for rids {bad}, counters (card, CPU) "
                             f"{counters}")
    if pressure and (rep_cpu.preemptions < 1 or rep_cpu.prefix_hits < 1):
        raise AssertionError(f"crosscheck continuous ({tag}): expected a "
                             f"preemption and a prefix hit: {counters}")
    log(f"{label} float32 continuous, {tag}, {len(prompts)} requests of "
        f"{[len(p) for p in prompts]} tokens on 2 slots and {pages} pages: "
        f"card == CPU tokens by rid "
        f"{ {rid: res_cpu[rid].tolist() for rid in sorted(res_cpu)} }; "
        f"equal counters "
        f"{json.dumps({k: a for k, (a, _) in counters.items()})}")
    return res_card


def crosscheck_full_depth_draft(model, dparams, plain) -> None:
    """A draft as deep as the trunk is the trunk on its own weights: on
    the card every draft is accepted, each verify commits k+1 tokens, and
    the tokens are the plain serve's ``plain``."""
    import torch
    from repro_torch.serve.engine import (CacheConfig, PolicyConfig,
                                          Request, ServeConfig, ServeEngine,
                                          SpecConfig)
    prompts = cross_prompts(model.cfg.vocab_size, 32, (2, 8), (30, 29))
    cfg = ServeConfig(num_slots=2, cache=CacheConfig(
        paged=True, page_size=32, max_blocks=2, num_pages=3),
        policy=PolicyConfig(prefill_chunk=32),
        spec=SpecConfig(k=SPEC_K, draft_layers=model.cfg.num_layers))
    reqs = [Request(rid=i, tokens=p.astype(np.int32),
                    max_new_tokens=CROSS_CONT_NEW)
            for i, p in enumerate(prompts)]
    with torch.inference_mode():
        res, rep = ServeEngine(model, dparams, cfg).serve(reqs)
    bad = [rid for rid in plain if not np.array_equal(res[rid], plain[rid])]
    if bad or rep.spec_accept_rate != 1.0 or \
            rep.spec_tokens_per_step != SPEC_K + 1:
        raise AssertionError(f"full-depth draft: tokens differ from plain "
                             f"for rids {bad}, spec_accept_rate "
                             f"{rep.spec_accept_rate}, spec_tokens_per_step "
                             f"{rep.spec_tokens_per_step}")
    log(f"[crosscheck] float32, a {model.cfg.num_layers}-layer draft (the "
        f"whole trunk), k={SPEC_K}, on the card: spec_accept_rate "
        f"{rep.spec_accept_rate}, spec_tokens_per_step "
        f"{rep.spec_tokens_per_step} over {rep.spec_steps:.0f} spec steps; "
        f"tokens equal to the plain serve's")


# -- phase 7: encode ------------------------------------------------------------

ENC_B, ENC_S, ENC_ITERS = 8, 512, 5
# per forward: R = 4 F1 (rbmm_binary) and 4 F2 (rbmm_int) per layer, one
# bidirectional sps_attention per layer
ENC_PER_LAYER = {"rbmm_binary": 4, "rbmm_int": 4, "sps_attention": 1}
ENC_CROSS_B, ENC_CROSS_S = 2, 64
ENC_CROSS_ATOL = 2e-3   # float32 logits; LayerNorm and head sums differ in
#                         order between the devices


def phase_encode():
    """Full-width bert-base-cobra through ``LMModel.prefill_logits``;
    returns the launch counts of one forward."""
    import torch
    from repro_torch import kernels, to_device
    from repro_torch.configs import get_config
    from repro_torch.models.lm import build_model
    from repro_torch.serve import graphs
    cfg = get_config("bert-base-cobra")
    model = build_model(cfg)
    t0 = time.perf_counter()
    with torch.inference_mode():
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        dparams = model.init_deploy(gen)
    torch.cuda.synchronize()
    log(f"[encode] {cfg.name}: {cfg.num_layers} layers, d={cfg.d_model}, "
        f"{cfg.num_heads} heads, d_ff={cfg.d_ff}, vocab {cfg.vocab_size}, "
        f"{cfg.norm}, {cfg.act} FFN blocked R={cfg.binary.ffn_block_r}, "
        f"causal={cfg.causal}, {cfg.compute_dtype}; init_deploy "
        f"{time.perf_counter() - t0:.1f} s")
    tokens = torch.as_tensor(np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (ENC_B, ENC_S)), device="cuda")

    def forward():
        return model.prefill_logits(dparams, tokens)

    with torch.inference_mode():
        forward()                                          # warm-up
        torch.cuda.synchronize()
        g = graphs.prefill_logits_graph(model, dparams, ENC_B, ENC_S)
        t0 = time.perf_counter()
        g(tokens=tokens)                                   # captures
        torch.cuda.synchronize()
        log(f"[encode] captured the forward (B={ENC_B}, S={ENC_S}) as one "
            f"graph: {g.capture_s:.3f} s of warm-up and capture within the "
            f"first call's {time.perf_counter() - t0:.3f} s; graph pool "
            f"{graphs.pool_bytes(g.graph.pool()) / 2**20:.1f} MiB")
        torch.cuda.reset_peak_memory_stats()
        want = forward()
        kernels.reset_launch_counts()
        logits = g(tokens=tokens)
        torch.cuda.synchronize()
        launches = kernels.launch_counts()
        if not torch.equal(logits, want):
            raise AssertionError(f"encode: the replay differs from the eager"
                                 f" forward, max |logit diff| "
                                 f"{(logits - want).abs().max().item()}")
        want = {n: c * cfg.num_layers for n, c in ENC_PER_LAYER.items()}
        got = {n: launches[n] for n in want}
        idle = [n for n in ENCODE_PATH if launches[n] == 0]
        if got != want or idle:
            raise AssertionError(f"encode: launches per forward {launches},"
                                 f" want {want} and every one of "
                                 f"{ENCODE_PATH} > 0")
        if logits.shape != (ENC_B, ENC_S, cfg.vocab_size) or \
                not torch.isfinite(logits).all():
            raise AssertionError(f"encode: bad logits {tuple(logits.shape)}"
                                 f" {logits.dtype}")
        peak = torch.cuda.max_memory_allocated()
        walls = {}
        for name, fn in (("eager", forward), ("graph",
                                              lambda: g(tokens=tokens)),
                         ("graph2", lambda: g(tokens=tokens)),
                         ("eager2", forward)):
            t0 = time.perf_counter()
            for _ in range(ENC_ITERS):
                fn()
            torch.cuda.synchronize()
            walls[name] = 1e3 * (time.perf_counter() - t0) / ENC_ITERS
        wall = min(walls["graph"], walls["graph2"])
        busy, n_kernels, by_name, host_ops = device_profile(
            lambda: g(tokens=tokens), iters=2, host=True)
    tokens_n = ENC_B * ENC_S
    log(f"[encode] launches per replay {json.dumps(launches)}; logits "
        f"bitwise equal to the eager forward's")
    log(f"[encode] B={ENC_B} x {ENC_S} tokens: {wall:.2f} ms per replay "
        f"(means of {ENC_ITERS}, in turns: eager {walls['eager']:.2f}, graph "
        f"{walls['graph']:.2f}, graph {walls['graph2']:.2f}, eager "
        f"{walls['eager2']:.2f}), {tokens_n / wall * 1e3:.0f} tokens/s; "
        f"logits {tuple(logits.shape)} {logits.dtype}, finite; peak device "
        f"memory {peak / 2**20:.0f} MiB")
    log(f"[encode] replay profile: device busy {busy:.3f} ms of "
        f"{wall:.2f} ms wall (busy share {busy / wall:.3f}, idle share "
        f"{1 - busy / wall:.3f}), {n_kernels:.0f} CUDA kernels per forward")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
        log(f"[encode]   {ms:.4f} ms/forward  {name[:90]}")
    log(f"[encode] device ms per forward of our kernels "
        f"{json.dumps(our_kernels_ms(by_name))}")
    log_host_ops("[encode]", host_ops)
    crosscheck_encode(cfg, to_device(dparams, "cpu"), dparams)
    return launches


def crosscheck_encode(cfg, on_cpu, dparams):
    """The same weights in float32 on the card and on the CPU (plain
    versions): equal argmax at every position, logits within a tolerance."""
    import torch
    from repro_torch.models.lm import build_model
    model = build_model(cfg.with_(compute_dtype="float32"))
    toks = np.random.default_rng(SEED + 3).integers(
        0, cfg.vocab_size, (ENC_CROSS_B, ENC_CROSS_S))
    with torch.inference_mode():
        card = model.prefill_logits(
            dparams, torch.as_tensor(toks, device="cuda")).cpu()
        cpu = model.prefill_logits(on_cpu, toks, device="cpu")
    diff = (card - cpu).abs().max().item()
    same = torch.equal(card.argmax(-1), cpu.argmax(-1))
    if not same or diff > ENC_CROSS_ATOL or not torch.isfinite(card).all():
        raise AssertionError(f"encode crosscheck: argmax equal {same}, max "
                             f"|logit diff| {diff} (tol {ENC_CROSS_ATOL})")
    log(f"[crosscheck] encode float32 B={ENC_CROSS_B} S={ENC_CROSS_S}: card "
        f"== CPU argmax at every position, max |logit diff| {diff:.3g} <= "
        f"{ENC_CROSS_ATOL}")


# -- phase 8: granite-3-2b; phase 9: qwen1.5-32b --------------------------------

# the ragged prefill's 8 rows: 1 to 128 tokens, tile edges (64) +-1 among
# them
RAGGED_LENS = (1, 128, 63, 64, 65, 127, 100, 2)
# bf16 logits of a row in the ragged batch against its own prefill: the
# residual stream and the rings are bitwise equal, the head is a float32
# cuBLAS product whose algorithm may change with M
RAGGED_ATOL = 1e-3
# qwen's continuous cell runs 8 of the 64 layers (the full-depth model's
# first 8, ``truncate_deploy``), to keep the script's time
QWEN_LAYERS = 8


def phase_dense_arch(arch: str, tag: str, cut: int = 0) -> dict:
    """``arch`` at full width and depth: static serving (phase 4's shapes,
    graph == eager; with ``cut``, the launches per prefill and per decode
    step equal ``static_expect``'s and a ``[... full depth]`` line), the
    ragged whole-prompt prefill, then continuous paged serving of phase
    5's trace on phase 5's engine shape (a preemption, a prefix hit, one
    ``paged_gather_decode`` per layer in every pure-decode iteration) on
    the first ``cut`` layers when given (``truncate_deploy`` of the full
    model, whose first ``cut`` blocks equal ``init_deploy`` of the cut
    config).  Returns the launch counts of the two serves."""
    import torch
    model, dparams, built = load_model(arch, tag)
    served, expect = {}, None
    if cut:
        check_prefix(model, dparams, cut, tag)
        expect = static_expect(model.cfg, (SERVE_B, SERVE_S, SERVE_NEW))
    launches, _ = serve_static(model, dparams, tag, expect=expect,
                               stats=served)
    check_ragged_prefill(model, dparams, tag)
    if cut:
        full_depth_line(f"{tag[:-1]} full depth]", model, built, served)
        model, dparams = model.truncate_deploy(dparams, cut)
    paged, _ = phase_continuous(model, dparams, f"{tag[:-1]} continuous]")
    del model, dparams
    torch.cuda.empty_cache()
    return {n: launches[n] + paged[n] for n in launches}


def check_ragged_prefill(model, dparams, tag: str, lens=RAGGED_LENS,
                         shape=(SERVE_S, SERVE_NEW)) -> None:
    """``prefill_with_cache(..., seq_lens=...)`` on 8 right-padded rows of
    ``lens`` tokens, padded to S (``shape``: S, new tokens): one
    ``sps_attention`` per layer (with its ``lens``, and a windowed
    layer's window); each row's ring caches (S + new tokens slots, a
    windowed layer's: its window) bitwise equal to that row's own
    unpadded prefill's, its logits within ``RAGGED_ATOL``."""
    import torch
    from repro_torch import kernels
    n_s, n_new = shape
    lens = np.asarray(lens, np.int32)
    width = n_s + n_new
    toks = np.random.default_rng(SEED + 5).integers(
        0, model.cfg.vocab_size, (len(lens), n_s))
    toks = np.where(np.arange(n_s) < lens[:, None], toks, 0)
    with torch.inference_mode():
        kernels.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, caches = model.prefill_with_cache(
            dparams, torch.as_tensor(toks, device="cuda"), max_len=width,
            seq_lens=torch.as_tensor(lens, device="cuda"))
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        launches = kernels.launch_counts()
        if launches["sps_attention"] != model.cfg.num_layers:
            raise AssertionError(f"{tag} ragged prefill: sps_attention "
                                 f"launches {launches}")
        diff, bad = 0.0, []
        for i, n in enumerate(lens):
            own, own_caches = model.prefill_with_cache(
                dparams, torch.as_tensor(toks[i:i + 1, :n], device="cuda"),
                max_len=width)
            diff = max(diff, (logits[i] - own[0]).abs().max().item())
            for layer, (c, o) in enumerate(zip(caches, own_caches)):
                c, o = c["attn"], o["attn"]
                if not (torch.equal(c.k_bits[i], o.k_bits[0]) and
                        torch.equal(c.vt_bits[i], o.vt_bits[0]) and
                        int(c.length[i]) == int(o.length[0]) == n):
                    bad.append((i, int(n), layer))
    if bad or diff > RAGGED_ATOL or not torch.isfinite(logits).all():
        raise AssertionError(f"{tag} ragged prefill: rings differ from the "
                             f"rows' own prefills at (row, length, layer) "
                             f"{bad[:12]} ({len(bad)} in all); max |logit "
                             f"diff| {diff} (tol {RAGGED_ATOL})")
    rings = sorted({c["attn"].k_bits.shape[2] for c in caches})
    log(f"{tag} ragged whole-prompt prefill, 8 rows of lengths "
        f"{lens.tolist()} padded to {n_s}: {ms:.1f} ms, launches "
        f"{json.dumps(launches)}; every row's rings ({rings} slots, "
        f"{model.cfg.num_layers} layers) bitwise equal to its own unpadded "
        f"prefill, max |logit diff| {diff:.3g} <= {RAGGED_ATOL}")


# -- phase 10: card vs CPU on a narrow qwen-shaped config ----------------------

# qwen's head width, G = 1 and the QKV bias at a size the CPU runs: 2
# layers, d = 256, 2 heads of d_h = 128
NARROW_QWEN = dict(num_layers=2, d_model=256, num_heads=2, num_kv_heads=2,
                   d_ff=512, compute_dtype="float32")


def phase_crosscheck_qwen() -> None:
    """The narrow qwen-shaped config in float32 on the card and on the CPU
    (plain versions), with the QKV bias drawn off zero: static greedy
    tokens equal and logits within ``CROSS_ATOL`` (phase 6's
    ``_greedy_run``)."""
    import torch
    from repro_torch import to_device
    from repro_torch.configs import get_config
    from repro_torch.models.lm import build_model
    cfg = get_config("qwen1.5-32b").with_(**NARROW_QWEN)
    model = build_model(cfg)
    with torch.inference_mode():
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        qat = model.init(gen)
        for bp in qat["blocks"]:
            for name in ("wq", "wk", "wv"):
                bias = bp["attn"][name]["bias"]
                bias.copy_(0.1 * torch.randn(bias.shape, generator=gen,
                                             device="cuda"))
        dparams = model.convert(qat)
        prompts = np.random.default_rng(SEED + 6).integers(
            0, cfg.vocab_size, (CROSS_B, CROSS_S))
        tok_card, lg_card = _greedy_run(model, dparams, prompts, "cuda")
        tok_cpu, lg_cpu = _greedy_run(model, to_device(dparams, "cpu"),
                                      prompts, "cpu")
    diff = max((a - b).abs().max().item() for a, b in zip(lg_card, lg_cpu))
    if not np.array_equal(tok_card, tok_cpu) or diff > CROSS_ATOL:
        raise AssertionError(
            f"qwen crosscheck: card tokens {tok_card.tolist()} vs CPU "
            f"{tok_cpu.tolist()}, max |logit diff| {diff} (tol "
            f"{CROSS_ATOL})")
    log(f"[crosscheck] float32 qwen-shaped ({cfg.num_layers} layers, "
        f"d={cfg.d_model}, {cfg.num_heads} heads of d_h="
        f"{cfg.resolved_head_dim}, G=1, QKV bias, untied head over "
        f"{cfg.vocab_size}) B={CROSS_B} S={CROSS_S} {CROSS_NEW} tokens: card "
        f"== CPU tokens {tok_card.tolist()}, max |logit diff| {diff:.3g} <= "
        f"{CROSS_ATOL}")


# -- phase 11: gemma3-27b --------------------------------------------------------

# gemma's continuous and speculative cells run 12 of the 62 layers
# (``kernel_times.GEMMA_LAYERS``: two 5:1 local:global periods, layers 5
# and 11 global), the full-depth model's first 12
# static: B = 4 prompts of 1,536 tokens, 32 greedy tokens, rings of 1,568:
# the local layers' rings of 1,024 wrap
GEMMA_STATIC = (4, 1536, 32)
# the ragged prefill's rows: the window (1,024) and the 64-row query and
# 128-key tile edges among them
GEMMA_RAGGED = (1, 2, 64, 1023, 1024, 1025, 1100, 1536)
# continuous: 16 requests, 8 slots, 68 blocks of 32 (capacity 2,176), 208
# pages in the global group, chunks of 512 (the local group is fully
# provisioned at 8 x 32).  The trace's own peak is 236 global pages (the
# engine's schedule on the CPU, which no model output changes: no EOS is
# set), so half of 8 x 68 (272) would never preempt; 208 preempts twice
GEMMA_CONT = Cell(dict(n_requests=16, mean_prompt=768, max_prompt=2048,
                       mean_new=24, max_new=48, seed=SEED), 64, 8, 32, 68,
                  208, 512)


def phase_gemma() -> dict:
    """gemma3-27b at full width and depth (62 layers), bf16, random weights
    from ``SEED``: static serving (``GEMMA_STATIC``, graph == eager, the
    launches of ``static_expect``), the ragged windowed prefill
    (``GEMMA_RAGGED``); then on its first ``GEMMA_LAYERS`` blocks
    (``truncate_deploy``) continuous paged serving of ``GEMMA_CONT`` on
    two ring groups and the same speculatively.  Returns the launch
    counts of the serves."""
    import torch
    model, dparams, built = load_model("gemma3-27b", "[gemma]")
    check_prefix(model, dparams, GEMMA_LAYERS, "[gemma]")
    served = {}
    launches, _ = serve_static(
        model, dparams, "[gemma]", GEMMA_STATIC, stats=served,
        expect=static_expect(model.cfg, GEMMA_STATIC))
    check_ragged_prefill(model, dparams, "[gemma]", GEMMA_RAGGED,
                         GEMMA_STATIC[1:])
    full_depth_line("[gemma full depth]", model, built, served)
    model, dparams = model.truncate_deploy(dparams, GEMMA_LAYERS)
    paged, _ = phase_continuous(model, dparams, "[gemma continuous]",
                                GEMMA_CONT)
    spec = phase_cell_speculative(model, dparams, "[gemma speculative]",
                                  GEMMA_CONT)
    del model, dparams
    torch.cuda.empty_cache()
    return {n: launches[n] + paged[n] + spec[n] for n in launches}


def phase_cell_speculative(model, dparams, tag: str, cell: Cell,
                           expect=None) -> dict:
    """``cell`` with ``SpecConfig(k=4, draft_layers=1)``: the draft is layer
    0 (gemma's: local, its ring of 1,024 wraps on the long requests).
    Served twice on one engine (the first serve captures one unified and
    one spec graph), every budget served; acceptance, tokens per step, ms
    per spec iteration; ``expect`` as ``phase_continuous`` takes it; then
    ``check_cell_spec_graph``.  Returns the launch counts of the timed
    serve."""
    import torch
    from repro_torch import kernels
    from repro_torch.serve.engine import ServeEngine
    eng = ServeEngine(model, dparams, continuous_config(SPEC_K, cell))
    t0 = time.perf_counter()
    first, _ = eng.serve(continuous_requests(model.cfg, cell))
    torch.cuda.synchronize()
    log_captures(tag, eng, time.perf_counter() - t0)
    captures = dict(eng._graphs.captures)
    probe = IterationProbe(eng)
    reqs = continuous_requests(model.cfg, cell)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    res, rep = eng.serve(reqs)
    total = time.perf_counter() - t0
    launches = kernels.launch_counts()
    its = probe.iterations(t0 + total, launches)
    if eng._graphs.captures != captures or \
            captures != {"unified": 1, "decode": 0, "spec": 1}:
        raise AssertionError(f"{tag} captures {eng._graphs.captures} after "
                             f"the first serve's {captures}")
    changed = _differ(res, first)
    short = [r.rid for r in reqs if len(res[r.rid]) != r.max_new_tokens]
    idle = [n for n in SPEC_PATH if launches[n] == 0]
    if changed or short or idle or rep.spec_steps < 1:
        raise AssertionError(f"{tag} the second serve's tokens differ for "
                             f"rids {changed}; budgets not served {short}; "
                             f"kernels never launched {idle}; spec_steps "
                             f"{rep.spec_steps}")
    check_iterations(tag, its, expect)
    spec = [ms for k, ms, _, _ in its if k == "spec"]
    mix = [ms for k, ms, _, _ in its if k == "mixed"]
    tokens = sum(len(t) for t in res.values())
    by_rid = sorted((rid, [int(x) for x in t]) for rid, t in res.items())
    log(f"{tag} tokens by rid, digest {digest(by_rid)}")
    window = model.plan[0][1]
    log(f"{tag} k={SPEC_K}, a {SPEC_DRAFT}-layer draft (layer 0, "
        f"{f'a window of {window}' if window else 'full attention'}): "
        f"spec_steps {rep.spec_steps:.0f},"
        f" spec_accept_rate {rep.spec_accept_rate:.4f}, "
        f"spec_tokens_per_step {rep.spec_tokens_per_step:.4f}, "
        f"pages_freed_rollback {rep.pages_freed_rollback:.0f}, preemptions "
        f"{rep.preemptions:.0f}, prefix hits {rep.prefix_hits:.0f}")
    log(f"{tag} {len(reqs)} requests, {tokens} tokens: {total:.3f} s, "
        f"{tokens / total:.1f} tok/s; {len(spec)} spec iterations, median "
        f"{np.median(spec):.2f} ms, mean {np.mean(spec):.2f} ms; {len(mix)} "
        f"mixed, median {np.median(mix):.2f} ms; launches per spec "
        f"iteration {json.dumps(next(c for k, _, c, _ in its if k == 'spec'))}")
    check_cell_spec_graph(model, dparams, eng, tag, cell)
    return launches


def check_cell_spec_graph(model, dparams, eng, tag: str, cell: Cell) -> None:
    """The engine's spec graph against ``spec_forward`` run eagerly from
    the same state, on the engine's own pool shape: 3 live rows of 1,022,
    1,021 and 700 tokens (chunks of ``cell.chunk`` into the paged trunk
    and the draft's rings), the rest inactive; ``SPEC_CHECK_ITERS``
    greedy iterations.  A draft window of 1,024 (gemma's) wraps during the
    first iteration's 5 steps on the two long rows.  Live rows' outputs,
    the trunk's pages 1.. and lengths and every draft ring bitwise
    equal."""
    import torch
    from repro_torch.serve import graphs
    dev = torch.device("cuda")
    spec = eng.cfg.page_spec()
    b, lens = cell.slots, np.array([1022, 1021, 700])
    live, k = len(lens), SPEC_K
    t = lambda a: torch.from_numpy(np.asarray(a, np.int64)).to(dev)
    rng = np.random.default_rng(SEED + 7)

    def same(a, c, trash):
        for x, y in zip(a, c):
            x, y = x["attn"], y["attn"]
            pairs = ((x.k_pages[1:], y.k_pages[1:]),
                     (x.vt_pages[1:], y.vt_pages[1:]),
                     (x.length, y.length)) if trash else tuple(zip(x, y))
            if not all(torch.equal(p, q) for p, q in pairs):
                return False
        return True

    with torch.inference_mode():
        key, caches = eng._pool_caches(b, spec)
        draft = eng._draft_caches(b, spec.capacity)
        for x in graphs.cache_tensors(caches) + graphs.cache_tensors(
                draft[1]):
            x.zero_()
        set_tables(caches, rng, live, pages=-(-(lens.max() + 3 * (k + 1))
                                              // spec.page_size))
        done = np.zeros(b, np.int64)
        while (done[:live] < lens).any():
            valid = np.zeros(b, np.int64)
            valid[:live] = np.minimum(lens - done[:live], cell.chunk)
            toks = t(rng.integers(0, model.cfg.vocab_size,
                                  (b, cell.chunk)))
            for m, p, c in ((model, dparams, caches),
                            (eng.draft_model, eng.draft_dparams, draft[1])):
                logits, _ = m.prefill_with_cache(p, toks, caches=c,
                                                 start=t(done),
                                                 seq_lens=t(valid))
                if m is model:
                    pending = logits[:, -1].argmax(-1, keepdim=True).cpu()
            done += valid
        eager = shared_tables(clone_caches(caches))
        deager = clone_caches(draft[1])
        graph = eng._spec_graph(key, caches, draft)
        step = eng.spec_forward(eager, deager)
        start, active = done.copy(), (done > 0) * 1
        for i in range(SPEC_CHECK_ITERS):
            inputs = dict(tokens=pending.numpy(), start=start, active=active)
            res_g = graph(**inputs).cpu()
            res_e = step(**{n: t(v) for n, v in inputs.items()}).cpu()
            if not (torch.equal(res_g[:live], res_e[:live]) and
                    same(caches, eager, True) and
                    same(draft[1], deager, False)):
                raise AssertionError(f"{tag} graph check: iteration {i} "
                                     f"replayed differs from eager")
            n_acc = res_e[:, k + 1].numpy()
            start = start + active * (n_acc + 1)
            pending = res_e[torch.arange(b), res_e[:, k + 1]][:, None]
        dlen = draft[1][0]["attn"].length.cpu().numpy()
    ring = draft[1][0]["attn"].k_bits.shape[2]
    # the first iteration's k + 1 steps take the two long rows past the ring
    must_wrap = ring < lens[:2].min() + k + 1
    wrapped = bool((dlen[:2] > ring).all())
    if must_wrap and not wrapped:
        raise AssertionError(f"{tag} graph check: the draft's rings did not "
                             f"wrap (lengths {dlen})")
    log(f"{tag} graph == eager: {SPEC_CHECK_ITERS} spec iterations from "
        f"rows of {lens.tolist()} tokens ({b - live} inactive), the draft's "
        f"ring of {ring} {'wrapped' if wrapped else 'not wrapped'} (lengths "
        f"now {dlen[:live].tolist()}): live rows' outputs, trunk pages and "
        f"lengths and every draft ring bitwise equal")


# -- phase 12: card vs CPU, narrow gemma-shaped and row configs -----------------

# gemma's head shape (G = 2, d_h = 128), the GELU GLU and a 5:1 plan of 6
# layers with a window of 64 at a size the CPU runs; prompts of 100-200
# tokens wrap the local rings
NARROW_GEMMA = dict(num_layers=6, d_model=256, num_heads=2, num_kv_heads=1,
                    head_dim=128, d_ff=512, window_size=64,
                    compute_dtype="float32")
# smollm's widths with the row granularity, 2 layers; prompts cross 511
NARROW_ROW = dict(num_layers=2, compute_dtype="float32")


def phase_crosscheck_narrow(tag: str, arch: str, kw: dict, static_s: int,
                            cont: tuple, row: bool = False,
                            smoke: bool = False,
                            pressure: bool = True) -> None:
    """A narrow config in float32 on the card and on the CPU (plain
    versions): static greedy tokens equal and logits within
    ``CROSS_ATOL`` (B = 2 prompts of ``static_s`` tokens); then 4
    requests (``cont``: shared prefix, lengths after it, lengths alone,
    blocks, pages, chunk) continuously on 2 slots, plainly and
    speculatively (k = 4, one-layer draft), tokens by rid and counters
    equal, the speculative tokens equal to the plain ones.  With ``row``
    the config takes the ``row`` granularity and each layer a seeded,
    non-zero (H, 512) lambda table.  With ``smoke`` ``kw`` changes the
    arch's smoke config; ``pressure`` as ``crosscheck_continuous`` takes
    it."""
    import dataclasses as dc
    import torch
    from repro_torch import to_device
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.models.lm import build_model
    cfg = (get_smoke_config if smoke else get_config)(arch).with_(**kw)
    if row:
        cfg = cfg.with_(binary=dc.replace(cfg.binary, sps_granularity="row"))
    model = build_model(cfg)
    with torch.inference_mode():
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        qat = model.init(gen)
        if row:
            for bp in qat["blocks"]:
                lam = bp["attn"]["sps_lambda"]
                lam.copy_(0.4 * torch.randn(lam.shape, generator=gen,
                                            device="cuda"))
        dparams = model.convert(qat)
        on_cpu = to_device(dparams, "cpu")
        prompts = np.random.default_rng(SEED + 8).integers(
            0, cfg.vocab_size, (CROSS_B, static_s))
        tok_card, lg_card = _greedy_run(model, dparams, prompts, "cuda",
                                        static_s + CROSS_NEW)
        tok_cpu, lg_cpu = _greedy_run(model, on_cpu, prompts, "cpu",
                                      static_s + CROSS_NEW)
    diff = max((a - b).abs().max().item() for a, b in zip(lg_card, lg_cpu))
    if not np.array_equal(tok_card, tok_cpu) or diff > CROSS_ATOL:
        raise AssertionError(f"{tag} card tokens {tok_card.tolist()} vs CPU "
                             f"{tok_cpu.tolist()}, max |logit diff| {diff} "
                             f"(tol {CROSS_ATOL})")
    log(f"{tag} float32 {cfg.num_layers} layers (plan "
        f"{[w for _, w in model.plan]}), d={cfg.d_model}, "
        f"{cfg.num_heads}/{cfg.num_kv_heads} heads of d_h="
        f"{cfg.resolved_head_dim}, {cfg.act} GLU{moe_text(cfg)}, SPS "
        f"{cfg.binary.sps_granularity}; static B={CROSS_B} S={static_s} "
        f"{CROSS_NEW} tokens: card == CPU tokens {tok_card.tolist()}, max "
        f"|logit diff| {diff:.3g} <= {CROSS_ATOL}")
    shared, with_shared, alone, blocks, pages, chunk = cont
    prompts = cross_prompts(cfg.vocab_size, shared, with_shared, alone)
    runs = [crosscheck_continuous(model, dparams, on_cpu, spec_k, prompts,
                                  blocks, pages, chunk, tag, pressure)
            for spec_k in (None, SPEC_K)]
    differ = _differ(runs[1], runs[0])
    if differ:
        raise AssertionError(f"{tag} speculative tokens differ from plain "
                             f"ones for rids {differ}")


# -- phase 13: mixtral-8x22b; phase 14: arctic-480b ---------------------------

# mixtral's continuous and speculative cells run 4 of the 56 layers
# (``kernel_times.MOE_CUT``), the full-depth model's first 4
MIXTRAL_LAYERS = MOE_CUT
# static, at full depth: B = 8 prompts of 512 tokens, 32 greedy tokens (n =
# 4,096 rows at prefill, capacity 2,048 per expert; 8 at a decode step,
# capacity 4)
MIXTRAL_STATIC = (8, 512, 32)
# continuous and speculative: gemma's trace and engine shape (16 requests,
# 8 slots, chunks of 512, 68 blocks of 32 on 208 pages).  The window of
# 4,096 covers the capacity (2,176), so every layer's ring is the
# capacity: one ring group, with preemptions and prefix sharing
MIXTRAL_CONT = GEMMA_CONT
# static, at full depth (35 layers, ~57 GiB of deploy params): B = 8
# prompts of 128 tokens, 16 greedy tokens (capacity 32 per expert at
# prefill, 1 at a decode step)
ARCTIC_STATIC = (8, 128, 16)
# the card's allocation before arctic's build: earlier phases' engines and
# graph pools must be gone, or 57 GiB and the prefill's buffers do not fit
ARCTIC_BEFORE_GIB = 2.0
# init_deploy == convert(init) on the card: mixtral at full width, 2
# layers (~20 GB of float32 masters held by convert(init))
INIT_DEPLOY_CHECK = ("mixtral-8x22b", 2)


class DropCounter:
    """While active, counts the claims and drops of every eager
    ``BinaryMoE._route`` call (a replay runs no Python; a capture is
    skipped) by (``label``, routed rows n, capacity): the static prefill,
    the graphs' warm-ups and the graph checks' eager steps of each kind.
    Each count reads the keep mask on the host, so the eager steps it
    watches wait for the card once per layer."""

    def __init__(self):
        self.counts = {}
        self.label = ""

    def __enter__(self):
        import torch
        from repro_torch.models import ffn
        orig = self._orig = ffn.BinaryMoE._route

        def route(moe, params, x2, *args):
            out = orig(moe, params, x2, *args)
            if not torch.cuda.is_current_stream_capturing():
                keep = out[3]
                c = self.counts.setdefault(
                    (self.label, x2.shape[0], out[4]), [0, 0, 0])
                c[0] += 1
                c[1] += keep.numel()
                c[2] += int((~keep).sum())
            return out
        ffn.BinaryMoE._route = route
        return self

    def __exit__(self, *exc):
        from repro_torch.models import ffn
        ffn.BinaryMoE._route = self._orig

    def log(self, tag: str) -> None:
        for (label, n, cap), (calls, claims, dropped) in sorted(
                self.counts.items()):
            log(f"{tag} drops, {label}: {calls} routings of n = {n} rows "
                f"(capacity {cap} per expert): {dropped} of {claims} claims "
                f"dropped ({dropped / claims:.4f})")


def log_expert_share(tag: str, cfg, step_ms: float, moe: dict) -> None:
    """How much of a decode step the expert weights take: capacity
    dispatch runs every expert at its capacity each step, whichever the
    tokens chose, so the step reads all L x E x 3 x d x d_ff weight bits;
    their calls' device time from phase 3 (``MOE_CALLS``, kernel µs times
    launches per step)."""
    e, d, ff, layers = (cfg.moe.num_experts, cfg.d_model, cfg.d_ff,
                        cfg.num_layers)
    gb = layers * e * 3 * d * ff / 8 / 1e9
    arch = cfg.name.split("-")[0]
    calls = {n: r for n, r in moe.items()
             if f"moe {arch} decode experts" in n}
    dev = sum(r["ms"] * r["step_launches"] for r in calls.values())
    log(f"{tag} expert weights per decode step: {layers} layers x {e} "
        f"experts x 3 x {d} x {ff} bits = {gb:.3f} GB, "
        f"{gb * 1e12 / HBM_BYTES_PER_S:.3f} ms at 3.35 TB/s; their "
        f"{len(calls)} calls' device time per step (phase 3's MoE rows, "
        f"us x launches) {dev:.3f} ms of the {step_ms:.2f} ms decode step "
        f"({dev / step_ms:.3f})")


def phase_mixtral(moe: dict) -> dict:
    """``init_deploy`` == ``convert(init)`` on the card (``INIT_DEPLOY_
    CHECK``); then mixtral-8x22b at full width and depth (56 layers),
    bf16, random weights from ``SEED``: static serving (``MIXTRAL_STATIC``,
    graph == eager, the launches of ``static_expect``), the expert
    weights' share of a decode step; then on its first ``MIXTRAL_LAYERS``
    blocks (``truncate_deploy``) continuous paged serving of
    ``MIXTRAL_CONT`` (each pure-decode iteration launches 7 ``rbmm_int``
    a layer, 4 projections and 3 expert products, and no ``rbmm_mxu``;
    each mixed one 7 ``rbmm_mxu`` a layer), then the same speculatively
    (7 ``rbmm_mxu`` a layer in each spec iteration's verify); the drops by
    iteration kind.  Returns the launch counts of the serves."""
    import torch
    check_init_deploy(*INIT_DEPLOY_CHECK)
    tag, n = "[mixtral]", MIXTRAL_LAYERS
    model, dparams, built = load_model("mixtral-8x22b", tag)
    check_prefix(model, dparams, n, tag)
    served = {}
    with DropCounter() as drops:
        drops.label = "static"
        launches, step_ms = serve_static(
            model, dparams, tag, MIXTRAL_STATIC, stats=served,
            expect=static_expect(model.cfg, MIXTRAL_STATIC))
        log_expert_share(tag, model.cfg, step_ms, moe)
        full_depth_line("[mixtral full depth]", model, built, served)
        model, dparams = model.truncate_deploy(dparams, n)
        drops.label = "continuous"
        paged, _ = phase_continuous(
            model, dparams, "[mixtral continuous]", MIXTRAL_CONT,
            expect={"decode": {"rbmm_int": 7 * n, "rbmm_mxu": 0},
                    "mixed": {"rbmm_mxu": 7 * n}})
        drops.label = "speculative"
        spec = phase_cell_speculative(
            model, dparams, "[mixtral speculative]", MIXTRAL_CONT,
            expect={"spec": {"rbmm_mxu": 7 * n}})
    drops.log(tag)
    del model, dparams
    torch.cuda.empty_cache()
    return {k: launches[k] + paged[k] + spec[k] for k in launches}


def phase_arctic(moe: dict) -> dict:
    """arctic-480b at full width and depth (35 layers of 128 experts and
    the dense residual FFN: ~57 GiB of deploy params, built expert by
    expert), bf16, random weights from ``SEED``: static serving
    (``ARCTIC_STATIC``, graph == eager, the launches of
    ``static_expect``), the expert weights' share of a decode step, the
    drops.  Returns the launch counts of the serve."""
    import torch
    tag = "[arctic]"
    free_card()
    before, reserved = (torch.cuda.memory_allocated() / 2**30,
                        torch.cuda.memory_reserved() / 2**30)
    log(f"{tag} before the build: {before:.2f} GiB allocated, "
        f"{reserved:.2f} GiB reserved")
    if before > ARCTIC_BEFORE_GIB:
        raise AssertionError(f"{tag} {before:.2f} GiB still allocated "
                             f"before the build (at most "
                             f"{ARCTIC_BEFORE_GIB})")
    model, dparams, built = load_model("arctic-480b", tag)
    served = {}
    with DropCounter() as drops:
        drops.label = "static"
        launches, step_ms = serve_static(
            model, dparams, tag, ARCTIC_STATIC, stats=served,
            expect=static_expect(model.cfg, ARCTIC_STATIC))
        log_expert_share(tag, model.cfg, step_ms, moe)
    full_depth_line("[arctic full depth]", model, built, served)
    drops.log(tag)
    del model, dparams
    torch.cuda.empty_cache()
    return launches


# -- phase 15: card vs CPU, the narrow MoE configs ----------------------------

# the smoke configs' continuous check: two requests share a 32-token page,
# two fit one page and outgrow it (arctic's full attention on a 3-page
# arena preempts; mixtral's windows of 16 fit one page a slot: neither a
# preemption nor a shared page)
MOE_CROSS_CONT = (32, (2, 8), (30, 29), 2, 3, 32)
MOE_CROSS_S = 40
MOE_DROP_CF = 0.5


def phase_crosscheck_moe() -> None:
    """The mixtral and arctic smoke configs (float32, dropless) on the card
    and on the CPU through ``phase_crosscheck_narrow`` (static tokens and
    logits; continuous and speculative tokens by rid and counters;
    speculative == plain); then the narrow mixtral at capacity factor 0.5,
    statically: tokens dropped, card == CPU."""
    import dataclasses as dc
    import torch
    from repro_torch import to_device
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.lm import build_model
    phase_crosscheck_narrow("[mixtral card==cpu]", "mixtral-8x22b", {},
                            MOE_CROSS_S, MOE_CROSS_CONT, smoke=True,
                            pressure=False)
    phase_crosscheck_narrow("[arctic card==cpu]", "arctic-480b", {},
                            MOE_CROSS_S, MOE_CROSS_CONT, smoke=True)
    cfg = get_smoke_config("mixtral-8x22b")
    cfg = cfg.with_(moe=dc.replace(cfg.moe, capacity_factor=MOE_DROP_CF))
    model = build_model(cfg)
    prompts = np.random.default_rng(SEED + 9).integers(
        0, cfg.vocab_size, (CROSS_B, MOE_CROSS_S))
    with torch.inference_mode(), DropCounter() as drops:
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        dparams = model.convert(model.init(gen))
        drops.label = "card"
        tok_card, lg_card = _greedy_run(model, dparams, prompts, "cuda",
                                        MOE_CROSS_S + CROSS_NEW)
        drops.label = "cpu"
        tok_cpu, lg_cpu = _greedy_run(model, to_device(dparams, "cpu"),
                                      prompts, "cpu",
                                      MOE_CROSS_S + CROSS_NEW)
    diff = max((a - b).abs().max().item() for a, b in zip(lg_card, lg_cpu))
    # (n, capacity, claims dropped) of each device's routings
    by = {dev: [(k[1], k[2], v[2]) for k, v in sorted(drops.counts.items())
                if k[0] == dev] for dev in ("card", "cpu")}
    if not np.array_equal(tok_card, tok_cpu) or diff > CROSS_ATOL or \
            sum(d for *_, d in by["card"]) < 1 or by["card"] != by["cpu"]:
        raise AssertionError(f"[mixtral card==cpu] capacity factor "
                             f"{MOE_DROP_CF}: card tokens "
                             f"{tok_card.tolist()} vs CPU "
                             f"{tok_cpu.tolist()}, max |logit diff| {diff} "
                             f"(tol {CROSS_ATOL}); drops {by}")
    log(f"[mixtral card==cpu] float32 smoke config at capacity factor "
        f"{MOE_DROP_CF}: static B={CROSS_B} S={MOE_CROSS_S} {CROSS_NEW} "
        f"tokens: card == CPU tokens {tok_card.tolist()}, max |logit diff| "
        f"{diff:.3g} <= {CROSS_ATOL}; the same claims dropped on both")
    drops.log("[mixtral card==cpu]")


# -- phase 16: hymba-1.5b; phase 17: xlstm-350m; phase 18: card vs CPU ----

# both at full width and full depth: hymba 32 hybrid layers (~1.6 B
# parameters, ~6 GB of float32 masters), xlstm 24 layers (20 mLSTM, 4
# sLSTM).  Static: hymba B = 4 prompts of 1,536 tokens and 32 new (its
# rings of the window, 1,024, wrap), xlstm B = 8 x 512.  Continuous:
# phase 5's trace and engine shape (16 slots, chunks of 128, 12 blocks of
# 32 over 48 pages); hymba's windows exceed the capacity of 384, so its
# one ring group is the capacity; xlstm has no attention, so its paged
# pool has no arena (served contiguously too)
RECURRENT_CONT = Cell(CONT_TRACE, 64, **RECURRENT_CELL)
RECURRENT_PATH = ("pack_threshold", "rbmm_int", "rbmm_mxu")


def _graph(fn):
    """``fn`` captured as a CUDA graph after a warm-up on a side stream;
    returns (graph, capture seconds)."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    t0 = time.perf_counter()
    with torch.cuda.graph(graph):
        fn()
    torch.cuda.synchronize()
    return graph, time.perf_counter() - t0


def recurrence_ms(model, dparams, tag: str, label: str, batch: int,
                  width: int, step_ms: float) -> float:
    """The recurrences' share of a step of ``batch`` rows at chunk width
    ``width`` (1: a decode step, whose scan freezes nothing; else a
    unified chunk with every row's valid length): each recurrent kind's
    fp recurrence alone (Mamba: the depthwise conv and the selective
    scan, ``MambaBlock._conv`` and ``_scan``; xLSTM: ``_scan_cells`` of
    its cell) on seeded random inputs, captured as a graph as the engine
    captures its steps; its device ms per replay (torch.profiler) and
    CUDA kernels times the layers of that kind, and the capture seconds,
    against the step's ``step_ms``.  Returns the device ms."""
    import torch
    from repro_torch.models.blocks import compute_dtype
    from repro_torch.models.ssm import _scan_cells
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    kinds = {}
    for i, (kind, _) in enumerate(model.plan):
        kinds.setdefault(kind, [i, 0])[1] += 1
    total = kernels = cap = 0.0
    with torch.inference_mode():
        for kind, (first, n) in kinds.items():
            name = "mamba" if kind == "hybrid" else "cell"
            part = model._block(kind)._parts()[name]
            params = dparams["blocks"][first][name]
            lens = None if width == 1 else torch.full(
                (batch,), width, device=dev)
            live = None if lens is None else torch.ones(
                (batch, width), dtype=torch.bool, device=dev)
            if kind == "hybrid":
                dt = torch.float32 if width == 1 else compute_dtype(
                    model.cfg)
                u_p = torch.randn(
                    (batch, width + part.conv_width - 1, part.d_inner),
                    generator=gen, device=dev).to(dt)
                h0 = part.init_cache(batch, dev).h

                def fn(part=part, params=params, u_p=u_p, h0=h0, lens=lens):
                    part._scan(params, part._conv(params, u_p, width), h0,
                               lens)
            else:
                carry = part.init_cache(batch, dev)
                shapes = ([carry.n.shape[1:]] * 3 + [carry.m.shape[1:]] * 2
                          if kind == "mlstm" else [carry.c.shape[1:]] * 4)
                seqs = [torch.randn((batch, width) + tuple(sh),
                                    generator=gen, device=dev)
                        for sh in shapes]

                def fn(part=part, carry=carry, seqs=seqs, live=live):
                    _scan_cells(part._cell, carry, seqs, live)
            graph, secs = _graph(fn)
            busy, launches, _ = device_profile(graph.replay, iters=3)
            total += n * busy
            kernels += n * launches
            cap += n * secs
            del graph
    layers = {k: n for k, (_, n) in kinds.items()}
    log(f"{tag} the recurrences of {label} (B={batch}, width {width}): "
        f"{total:.3f} device ms of the step's {step_ms:.2f} ms wall "
        f"({total / step_ms:.3f}), {kernels:.0f} CUDA kernels; their own "
        f"capture {cap:.3f} s (layers {json.dumps(layers)})")
    return total


def check_spec_ignored(model, dparams, tag: str, cell: Cell,
                       plain: dict) -> None:
    """``SpecConfig(k=4)`` requested on a recurrent stack: the engine
    decodes plainly, as the JAX engine does (a verify cannot leave
    recurrent carries unwritten): the plain serve's tokens by rid, no
    speculative iteration, no spec capture."""
    import torch
    from repro_torch.serve.engine import ServeEngine
    eng = ServeEngine(model, dparams, continuous_config(SPEC_K, cell))
    with torch.inference_mode():
        res, rep = eng.serve(continuous_requests(model.cfg, cell))
    differ = _differ(res, plain)
    if differ or rep.spec_steps != 0 or rep.spec_drafted is not None or \
            eng._graphs.captures["spec"] != 0:
        raise AssertionError(f"{tag} spec_decode={SPEC_K} on a recurrent "
                             f"stack: tokens differ for rids {differ}, "
                             f"spec steps {rep.spec_steps}, captures "
                             f"{eng._graphs.captures}")
    log(f"{tag} spec_decode={SPEC_K} requested: plain decode, the plain "
        f"serve's tokens for all {len(res)} rids, 0 speculative iterations, "
        f"captures {json.dumps(eng._graphs.captures)}")


# the continuous serves' depth of the recurrent archs (the script's
# 1,200 s): hymba's first 8 of 32 layers, xlstm's first 6 of 24 (5 mLSTM,
# 1 sLSTM)
HYMBA_CONT_LAYERS, XLSTM_CONT_LAYERS = 8, 6


def continuous_depth(tag: str, model, dparams, layers: int):
    """The first ``layers`` layers of ``model`` (``truncate_deploy``: the
    full model's blocks, no copy) and the launches per pure-decode and
    mixed iteration that ``kernel_times.recurrent_calls`` gives at that
    depth; returns (model, dparams, {path: {kernel: launches}})."""
    full = model.cfg.num_layers
    model, dparams = model.truncate_deploy(dparams, layers)
    arch = model.cfg.name.split("-")[0]
    calls = recurrent_calls(model.cfg, RECURRENT_STATIC[model.cfg.name],
                            **RECURRENT_CELL)
    kinds = collections.Counter(k for k, _ in model.plan)
    log(f"{tag} on the first {layers} of {full} layers "
        f"({json.dumps(kinds)}; truncate_deploy: the full model's blocks, "
        f"no copy)")
    return model, dparams, {p: path_launches(calls, arch, p)
                            for p in ("pure-decode", "mixed")}


def phase_hymba() -> dict:
    """hymba-1.5b at full width and depth, bf16, random weights from
    ``SEED``: static serving (``RECURRENT_STATIC``: the rings of 1,024
    wrap; graph == eager; the prefill and every decode step launch
    ``kernel_times.RECURRENT_CALLS``' counts) and the recurrences' share
    of a decode step; then on its first ``HYMBA_CONT_LAYERS`` layers
    (``continuous_depth``) continuous paged serving of ``RECURRENT_CONT``
    (every pure-decode and mixed iteration at the table's counts of that
    depth, graphs == eager with the carries, a second serve equal) and
    the recurrences' share of a mixed iteration; ``spec_decode=4``
    requested decodes plainly.  Returns the launch counts of the
    serves."""
    import torch
    tag, arch = "[hymba]", "hymba-1.5b"
    model, dparams, _ = load_model(arch, tag)
    expect = {p: path_launches(RECURRENT_CALLS, "hymba", p)
              for p in ("prefill", "decode")}
    shape = RECURRENT_STATIC[arch]
    launches, step_ms = serve_static(model, dparams, tag, shape,
                                     expect=expect)
    recurrence_ms(model, dparams, tag, "a static decode step", shape[0], 1,
                  step_ms)
    model, dparams, expect = continuous_depth("[hymba continuous]", model,
                                              dparams, HYMBA_CONT_LAYERS)
    ctag, cell, stats = "[hymba continuous]", RECURRENT_CONT, {}
    paged, plain = phase_continuous(
        model, dparams, ctag, cell,
        expect={"decode": expect["pure-decode"], "mixed": expect["mixed"]},
        stats=stats)
    recurrence_ms(model, dparams, ctag, "a pure-decode iteration",
                  cell.slots, 1, stats["decode"])
    recurrence_ms(model, dparams, ctag, "a mixed iteration", cell.slots,
                  cell.chunk, stats["mixed"])
    check_spec_ignored(model, dparams, "[hymba speculative]", cell, plain)
    del model, dparams
    torch.cuda.empty_cache()
    return {n: launches[n] + paged[n] for n in launches}


def phase_xlstm() -> dict:
    """xlstm-350m at full width and depth (20 mLSTM and 4 sLSTM layers,
    no attention), bf16, random weights from ``SEED``: static serving
    (``RECURRENT_STATIC``, graph == eager, the table's counts) and the
    recurrences' share of a decode step; then on its first
    ``XLSTM_CONT_LAYERS`` layers (``continuous_depth``, the table's
    counts of that depth) ``RECURRENT_CONT`` served on the paged pool
    (no arena: no layer has attention) and on contiguous rings, each
    twice with equal tokens, graphs == eager with the carries, each the
    same tokens; the recurrences' share of a mixed iteration;
    ``spec_decode=4`` requested decodes plainly.  Returns the launch
    counts of the serves."""
    import torch
    tag, arch = "[xlstm]", "xlstm-350m"
    model, dparams, _ = load_model(arch, tag)
    expect = {p: path_launches(RECURRENT_CALLS, "xlstm", p)
              for p in ("prefill", "decode")}
    shape = RECURRENT_STATIC[arch]
    launches, step_ms = serve_static(model, dparams, tag, shape,
                                     path=RECURRENT_PATH, expect=expect)
    recurrence_ms(model, dparams, tag, "a static decode step", shape[0], 1,
                  step_ms)
    model, dparams, expect = continuous_depth("[xlstm continuous]", model,
                                              dparams, XLSTM_CONT_LAYERS)
    runs, total, stats = {}, dict(launches), {}
    for paged in (True, False):
        ctag = f"[xlstm continuous {'paged' if paged else 'contiguous'}]"
        cell = dataclasses.replace(RECURRENT_CONT, paged=paged)
        got, runs[paged] = phase_continuous(
            model, dparams, ctag, cell,
            expect={"decode": expect["pure-decode"],
                    "mixed": expect["mixed"]},
            path=RECURRENT_PATH, pressure=False,
            stats=stats if paged else None)
        total = {n: total[n] + got[n] for n in total}
    differ = _differ(runs[True], runs[False])
    if differ:
        raise AssertionError(f"[xlstm continuous] paged and contiguous "
                             f"pools give other tokens for rids {differ}")
    log(f"[xlstm continuous] paged (no arena) == contiguous tokens for all "
        f"{len(runs[True])} rids")
    cell, ctag = RECURRENT_CONT, "[xlstm continuous paged]"
    recurrence_ms(model, dparams, ctag, "a pure-decode iteration",
                  cell.slots, 1, stats["decode"])
    recurrence_ms(model, dparams, ctag, "a mixed iteration", cell.slots,
                  cell.chunk, stats["mixed"])
    check_spec_ignored(model, dparams, "[xlstm speculative]", cell,
                       runs[True])
    del model, dparams
    torch.cuda.empty_cache()
    return total


# the smoke configs' continuous check (float32): two requests share a
# 32-token page, two fit one page and outgrow it; hymba's windows of 16
# fit one page a slot and xlstm has no arena: neither preempts nor shares
RECURRENT_CROSS_CONT = (32, (2, 8), (30, 29), 2, 3, 32)
RECURRENT_CROSS_S = 40


def phase_crosscheck_recurrent() -> None:
    """The hymba and xlstm smoke configs (float32) on the card and on the
    CPU through ``phase_crosscheck_narrow``: static tokens equal and
    logits within ``CROSS_ATOL``, continuous tokens by rid and counters
    equal, plainly and with ``spec_decode=4`` requested (plain decode:
    the same tokens)."""
    for arch in ("hymba-1.5b", "xlstm-350m"):
        phase_crosscheck_narrow(f"[{arch.split('-')[0]} card==cpu]", arch,
                                {}, RECURRENT_CROSS_S, RECURRENT_CROSS_CONT,
                                smoke=True, pressure=False)


# -- phase 19: seamless-m4t-large-v2; phase 20: internvl2-76b; phase 21 ---

# seamless at full width and depth (24 encoder and 24 decoder layers,
# ~1.63 B parameters); internvl2 at full width and depth (80 layers,
# ~17 GB of deploy params).  Static serving only, as in the JAX package:
# B = 4 prompts of 64 tokens after 1,024 frontend embeddings each
# (seamless' frames through the encoder; internvl2's patches before the
# prompt), 32 new tokens (``kernel_times.ENCDEC_STATIC``)
ENCDEC_PATH = ("pack_threshold", "rbmm_int", "rbmm_binary", "rbmm_mxu",
               "sps_attention")
FRONTEND_ITERS = 2


def frontend_embeds(model, batch: int, frames: int = 0,
                    seed: int = SEED) -> np.ndarray:
    """Standard normal frontend embeddings (B, frames, frontend_dim) from
    ``seed`` (frames: the config's ``frontend_tokens`` by default)."""
    return np.random.default_rng(seed).standard_normal(
        (batch, frames or model.cfg.frontend_tokens, model.frontend_dim),
        dtype=np.float32)


def timed(fn, iters: int = FRONTEND_ITERS) -> float:
    """Wall ms per call of ``fn`` (mean of ``iters``, after one call)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / iters


def check_prefill_graph(model, dparams, tag: str, shape, fe) -> None:
    """``prefill_logits`` (tokens and frontend embeddings -> logits at
    every position) captured as one CUDA graph: the replay bitwise equal
    to the eager forward, finite logits of the expected shape; ms per
    replay and per eager forward in turns, the replay's device busy
    time."""
    import torch
    n_b, n_s, _ = shape
    toks = torch.as_tensor(np.random.default_rng(SEED).integers(
        0, model.cfg.vocab_size, (n_b, n_s)), device="cuda")
    fe_dev = torch.as_tensor(fe, device="cuda")
    out = {}

    def forward():
        out["logits"] = model.prefill_logits(dparams, toks,
                                             frontend_embeds=fe_dev)

    with torch.inference_mode():
        forward()
        want = out.pop("logits")
        graph, secs = _graph(forward)
        graph.replay()
        torch.cuda.synchronize()
        got = out["logits"]
        rows = n_s + ring_prefix(model, fe)
        if got.shape != (n_b, rows, model.cfg.vocab_size) or \
                not torch.isfinite(got).all():
            raise AssertionError(f"{tag} prefill_logits: bad logits "
                                 f"{tuple(got.shape)} {got.dtype}")
        if not torch.equal(got, want):
            raise AssertionError(f"{tag} prefill_logits: the replay differs "
                                 f"from the eager forward, max |logit "
                                 f"diff| {(got - want).abs().max().item()}")
        del want
        walls = [("eager", timed(forward)), ("graph", timed(graph.replay)),
                 ("graph", timed(graph.replay)), ("eager", timed(forward))]
        busy, n_kernels, by_name = device_profile(graph.replay, iters=2)
    wall = min(ms for k, ms in walls if k == "graph")
    log(f"{tag} prefill_logits (B={n_b}, S={n_s}, {fe.shape[1]} frontend "
        f"embeddings) as one graph ({secs:.3f} s to capture): the replay "
        f"bitwise equal to the eager forward, logits {tuple(got.shape)} "
        f"{got.dtype}, finite; ms per forward in turns "
        f"{', '.join(f'{k} {ms:.2f}' for k, ms in walls)}; replay device "
        f"busy {busy:.3f} ms of {wall:.2f} (idle share "
        f"{1 - busy / wall:.3f}), {n_kernels:.0f} CUDA kernels")
    log_top_kernels(f"{tag} prefill_logits", by_name)
    del graph, out
    torch.cuda.empty_cache()


def log_top_kernels(tag: str, by_name, top: int = 6) -> None:
    """The largest CUDA kernels of a profile ({name: device ms}) and the
    device ms of each of ours."""
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]:
        log(f"{tag}   {ms:.4f} ms  {name[:90]}")
    log(f"{tag} device ms of our kernels "
        f"{json.dumps(our_kernels_ms(by_name))}")


def log_memory_caches(model, tag: str, batch: int, frames: int) -> None:
    """The encoder-decoder's static memories ("cross") of a pool of
    ``batch`` rows over ``frames`` positions: their bytes against their
    bf16 equivalents."""
    from repro_torch.serve import kvcache
    caches = model.init_caches(batch, 1, "cuda", memory_len=frames)
    cross = [{"cross": c["cross"]} for c in caches]
    own, bf16 = kvcache.cache_bytes(cross), \
        kvcache.bf16_equivalent_bytes(cross)
    log(f"{tag} the decoder's binary memories of {frames} frames, "
        f"{len(caches)} layers, B={batch}: {own / 2**20:.2f} MiB, "
        f"{bf16 / own:.2f}x below their bf16 equivalent "
        f"({bf16 / 2**20:.2f} MiB)")


def phase_frontend(arch: str, tag: str, path,
                   full_depth: bool = False) -> dict:
    """``arch`` at full width and depth, bf16, random weights from
    ``SEED``: static serving of ``ENCDEC_STATIC`` with seeded frontend
    embeddings (graph == eager, caches included; the prefill and each
    decode step launch ``kernel_times.ENCDEC_CALLS``' counts; every
    kernel of ``path`` launches), ``prefill_logits`` as one graph equal to
    the eager forward; for the encoder-decoder the encoder's ms alone and
    its memories' bytes; with ``full_depth`` a ``[... full depth]`` line.
    Returns the launch counts of the serve."""
    import torch
    model, dparams, built = load_model(arch, tag)
    shape = ENCDEC_STATIC[arch]
    fe = frontend_embeds(model, shape[0])
    short = arch.split("-")[0]
    expect = {p: path_launches(ENCDEC_CALLS, short, p)
              for p in ("prefill", "decode")}
    served = {}
    launches, _ = serve_static(model, dparams, tag, shape, path=path,
                               expect=expect, frontend=fe,
                               caches_equal=True, stats=served)
    check_prefill_graph(model, dparams, tag, shape, fe)
    if full_depth:
        full_depth_line(f"{tag[:-1]} full depth]", model, built, served)
    if not hasattr(model, "plan"):           # the encoder-decoder
        fe_dev = torch.as_tensor(fe, device="cuda")
        with torch.inference_mode():
            ms = timed(lambda: model.encode(dparams, fe_dev))
            busy, n_kernels, by_name = device_profile(
                lambda: model.encode(dparams, fe_dev), iters=2)
        log(f"{tag} encoder alone ({model.enc_layers} layers, B={shape[0]} "
            f"x {fe.shape[1]} frames): {ms:.2f} ms per eager call, device "
            f"busy {busy:.3f} ms, {n_kernels:.0f} CUDA kernels")
        log_top_kernels(f"{tag} encoder", by_name)
        log_memory_caches(model, tag, shape[0], fe.shape[1])
    del model, dparams
    torch.cuda.empty_cache()
    return launches


# the smoke configs in float32, card against CPU: seamless over memories
# of 8 and 40 frames (the last V^T word's pad bits), internvl2 with its 8
# patches; B = 2 prompts of 20 tokens, greedy
FRONTEND_CROSS = {"seamless-m4t-large-v2": (8, 40), "internvl2-76b": (8,)}
FRONTEND_CROSS_S = 20


def phase_crosscheck_frontend() -> None:
    """Both smoke configs (float32) on the card and on the CPU (plain
    versions): prefill + greedy decode, tokens equal and logits within
    ``CROSS_ATOL``; the static engine's tokens equal to the loop's on
    each device."""
    import torch
    from repro_torch import to_device
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.lm import build_model
    from repro_torch.serve.engine import (CacheConfig, ServeConfig,
                                          ServeEngine)
    for arch, frames in FRONTEND_CROSS.items():
        model = build_model(get_smoke_config(arch))
        with torch.inference_mode():
            dparams = model.convert(model.init(
                torch.Generator(device="cuda").manual_seed(SEED)))
        on_cpu = to_device(dparams, "cpu")
        prompts = np.random.default_rng(SEED + 21).integers(
            0, model.cfg.vocab_size, (CROSS_B, FRONTEND_CROSS_S))
        for n in frames:
            fe = frontend_embeds(model, CROSS_B, n, SEED + 22)
            max_len = FRONTEND_CROSS_S + CROSS_NEW + ring_prefix(model, fe)
            with torch.inference_mode():
                tok_card, lg_card = _greedy_run(model, dparams, prompts,
                                                "cuda", max_len, fe)
                tok_cpu, lg_cpu = _greedy_run(model, on_cpu, prompts, "cpu",
                                              max_len, fe)
            diff = max((a - b).abs().max().item()
                       for a, b in zip(lg_card, lg_cpu))
            tag = f"[{arch.split('-')[0]} card==cpu]"
            if not np.array_equal(tok_card, tok_cpu) or diff > CROSS_ATOL:
                raise AssertionError(
                    f"{tag} {n} frontend embeddings: card tokens "
                    f"{tok_card.tolist()} vs CPU {tok_cpu.tolist()}, max "
                    f"|logit diff| {diff} (tol {CROSS_ATOL})")
            cfg = ServeConfig(cache=CacheConfig(max_len=max_len))
            eng_card, _ = ServeEngine(model, dparams, cfg).generate(
                prompts, max_new_tokens=CROSS_NEW, frontend_embeds=fe)
            eng_cpu, _ = ServeEngine(model, on_cpu, cfg,
                                     device="cpu").generate(
                prompts, max_new_tokens=CROSS_NEW, frontend_embeds=fe)
            if not (np.array_equal(eng_card, tok_card) and
                    np.array_equal(eng_cpu, tok_cpu)):
                raise AssertionError(f"{tag} ServeEngine tokens differ from "
                                     f"the prefill/decode loop")
            log(f"{tag} float32 B={CROSS_B} S={FRONTEND_CROSS_S}, {n} "
                f"frontend embeddings, {CROSS_NEW} tokens: card == CPU "
                f"tokens {tok_card.tolist()} (the engines' too), max |logit "
                f"diff| {diff:.3g} <= {CROSS_ATOL}")


# -- phase 22: train ----------------------------------------------------------

TRAIN_STEPS, TRAIN_CKPT_EVERY = 30, 10
TRAIN_LOGGED = (0, 10, 20, 29)
TRAIN_MEDIAN_FROM = 5            # steps 5..29 give the median step time
TRAIN_TOP = 8
TRAIN_EAGER_STEPS = 3
# Restarted run against the uninterrupted one, per step's loss: the
# restored state is the saved one bitwise and every op of a step is
# deterministic on one card but for reductions whose order the library
# may pick per call; a flipped sign in a binary net moves the loss far
# more than rounding, so the gate is loose and the log says whether the
# two runs were bitwise equal
TRAIN_RESTART_RTOL = 1e-3
# narrow float32 config, card against CPU over 3 steps from one init
TRAIN_NARROW = dict(remat="block")   # on the smollm smoke config
TRAIN_NARROW_B, TRAIN_NARROW_S, TRAIN_NARROW_STEPS = 8, 64, 3
TRAIN_LOSS_RTOL = 1e-5
# params: Adam's m / sqrt(v) turns a last-bit difference of a near-zero
# gradient into a step of up to lr, so the largest difference is bounded
# by 2 lr per step, and almost every element must agree to 1e-5
TRAIN_PARAM_ATOL, TRAIN_PARAM_SHARE = 1e-5, 1e-3
QAT_DEPLOY_ATOL = 2e-3           # JAX's own QAT == deploy tolerance


def _train_args(ckpt_dir: str, extra=()):
    from repro_torch.launch import train as train_cli
    return train_cli.parse_args(
        ["--full", "--steps", str(TRAIN_STEPS), "--ckpt-every",
         str(TRAIN_CKPT_EVERY), "--ckpt-dir", ckpt_dir, "--seed",
         str(SEED), *extra])


def _run_train(trainer, stream, ckpt, tag: str) -> dict:
    """``ft.run`` to TRAIN_STEPS; {step: (loss, seconds)}."""
    from repro_torch.train import ft
    record = {}

    def on_step(step, metrics, dt):
        record[step] = (float(metrics["loss"]), dt)

    state = ft.run(trainer, stream, ckpt, steps=TRAIN_STEPS,
                   ckpt_every=TRAIN_CKPT_EVERY, log_every=TRAIN_CKPT_EVERY,
                   log_fn=lambda m: log(f"{tag} {m}"), on_step=on_step)
    return state, record


def train_full(tmp: Path):
    """(a): full-width training through the CLI's ``build`` and
    ``ft.run``; returns (trainer, stream, final state, {step: (loss,
    s)})."""
    import torch
    from repro_torch.launch import train as train_cli
    tag = "[train]"
    trainer, stream, ckpt = train_cli.build(_train_args(str(tmp / "run")))
    cfg = trainer.model.cfg
    n = train_cli.param_count(trainer.init_state())
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, record = _run_train(trainer, stream, ckpt, tag)
    total = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    losses = [record[i][0] for i in range(TRAIN_STEPS)]
    ms = [1e3 * record[i][1] for i in range(TRAIN_MEDIAN_FROM, TRAIN_STEPS)]
    med = float(np.median(ms))
    tokens = stream.global_batch * stream.seq_len
    log(f"{tag} {cfg.name}: {cfg.num_layers} layers, d={cfg.d_model}, "
        f"{cfg.num_heads}/{cfg.num_kv_heads} heads, d_ff={cfg.d_ff}, vocab "
        f"{cfg.vocab_size}, {cfg.compute_dtype} compute, float32 masters, "
        f"{cfg.optim_moment_dtype} moments, remat {cfg.remat}; {n:,} "
        f"parameters; B={stream.global_batch} x {stream.seq_len} tokens")
    log(f"{tag} {TRAIN_STEPS} steps in {total:.1f} s (checkpoints every "
        f"{TRAIN_CKPT_EVERY} and the step's capture included); ms per step (median of steps "
        f"{TRAIN_MEDIAN_FROM}-{TRAIN_STEPS - 1}) {med:.2f} (min "
        f"{min(ms):.2f}, max {max(ms):.2f}), {tokens / med * 1e3:.0f} "
        f"tokens/s; first step {1e3 * record[0][1]:.1f} ms; peak memory "
        f"{peak / 2**30:.2f} GiB (the step donates its state; before the "
        f"donating step, PR 26: 8.27 GiB)")
    log(f"{tag} losses at steps "
        + ", ".join(f"{i}: {losses[i]:.4f}" for i in TRAIN_LOGGED)
        + f"; all {json.dumps([round(x, 4) for x in losses])}")
    if not all(np.isfinite(losses)) or \
            np.mean(losses[-5:]) >= losses[0]:
        raise AssertionError(f"{tag} losses not finite or not falling: "
                             f"{losses}")
    if trainer.captures != 1:
        raise AssertionError(f"{tag} {trainer.captures} step captures")
    return trainer, stream, state, record


def train_profile(trainer, stream, state) -> None:
    """(a), after the serve: the captured step against the eager step
    from one state (the eager step is functional; the replay then
    overwrites ``state``), the eager step's time, and a profile of one
    replay."""
    import torch
    from repro_torch import tree
    from repro_torch.train.trainer import Trainer
    tag = "[train]"
    batch = stream.batch_at(TRAIN_STEPS)
    eager = Trainer(trainer.model, trainer.opt, trainer.cfg, graph=False)
    walls = []
    for _ in range(TRAIN_EAGER_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s_e, m_e = eager.train_step(state, batch)
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
    p_e = [t.clone() for t in tree.leaves(s_e.params)]
    loss_e = float(m_e["loss_total"])
    del s_e
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s_g, m_g = trainer.train_step(state, batch)
    torch.cuda.synchronize()
    wall = 1e3 * (time.perf_counter() - t0)
    diff = max((a - b).abs().max().item()
               for a, b in zip(p_e, tree.leaves(s_g.params)))
    log(f"{tag} graph replay against the eager step from one state: "
        f"loss {float(m_g['loss_total'])!r} vs {loss_e!r}, params max "
        f"|diff| {diff:.3g}; eager step {np.median(walls):.2f} ms "
        f"(median of {TRAIN_EAGER_STEPS}), replay {wall:.2f} ms")
    if float(m_g["loss_total"]) != loss_e or diff > TRAIN_PARAM_ATOL:
        raise AssertionError(f"{tag} the captured step differs from the "
                             f"eager step")
    dev, launches, by_name = device_profile(
        lambda: trainer.train_step(s_g, batch), iters=1)
    log(f"{tag} one profiled replay: device busy {dev:.2f} ms of a "
        f"{wall:.2f} ms step ({dev / wall:.3f}), {launches:.0f} kernels; "
        f"top {TRAIN_TOP} by device time:")
    log_top_kernels(tag, by_name, TRAIN_TOP)
    kinds = {"gemm": 0.0, "multi_tensor": 0.0, "copy": 0.0, "other": 0.0}
    for name, ms in by_name.items():
        kind = next((k for k in ("gemm", "multi_tensor", "copy")
                     if k in name), "other")
        kinds[kind] += ms
    log(f"{tag} device ms by kind: " + ", ".join(
        f"{k} {v:.2f}" for k, v in kinds.items())
        + " (gemm: the float32 +-1 products and the head; multi_tensor: "
        "the optimizer's foreach ops; copy: dtype casts and copies)")
    pm1_product_times(tag, stream.global_batch * stream.seq_len,
                      trainer.model.cfg)


def pm1_product_times(tag: str, m: int, cfg) -> None:
    """The QAT face's +-1 product at the FFN's w1 shape on float32
    operands (what the port runs) against bf16 operands with a float32
    output where this torch offers one (``torch.mm(..., out_dtype=)``;
    exact too); CUDA-event times, for the record."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    a = (torch.rand(m, cfg.d_model, device="cuda", generator=gen) > 0.5
         ).float() * 2 - 1
    w = (torch.rand(cfg.d_model, cfg.d_ff, device="cuda", generator=gen)
         > 0.5).float() * 2 - 1
    f32 = eager_ms(lambda: torch.matmul(a, w), 20)
    ab, wb = a.bfloat16(), w.bfloat16()

    def mixed():
        return torch.mm(ab, wb, out_dtype=torch.float32)

    try:
        exact = torch.equal(mixed(), torch.matmul(a, w))
        bf16 = f"{eager_ms(mixed, 20) * 1e3:.2f} us (equal: {exact})"
    except (RuntimeError, TypeError) as e:
        bf16 = f"not offered ({type(e).__name__})"
    log(f"{tag} +-1 product ({m} x {cfg.d_model}) x ({cfg.d_model} x "
        f"{cfg.d_ff}): float32 operands {f32 * 1e3:.2f} us, bf16 operands "
        f"with a float32 output {bf16}")


def train_restart(tmp: Path, record: dict) -> None:
    """(b): a fresh trainer restores the step-10 checkpoint (bitwise
    against the manifest) and runs to TRAIN_STEPS."""
    import shutil
    from repro_torch.launch import train as train_cli
    from repro_torch.train import ft
    tag = "[train restart]"
    name = f"step_{TRAIN_CKPT_EVERY:08d}"
    shutil.copytree(tmp / "run" / name, tmp / "restart" / name)
    trainer, stream, ckpt = train_cli.build(_train_args(str(tmp / "restart")))
    state, data_step, _ = ft.restore_or_init(trainer, ckpt)
    leaves = ckpt.verify(TRAIN_CKPT_EVERY, state)
    if int(state.opt.step) != TRAIN_CKPT_EVERY or \
            data_step != TRAIN_CKPT_EVERY:
        raise AssertionError(f"{tag} restored step {int(state.opt.step)}, "
                             f"data step {data_step}")
    del state
    _, again = _run_train(trainer, stream, ckpt, tag)
    steps = range(TRAIN_CKPT_EVERY, TRAIN_STEPS)
    if sorted(again) != list(steps):
        raise AssertionError(f"{tag} ran steps {sorted(again)}")
    diff = [abs(again[i][0] - record[i][0]) / abs(record[i][0])
            for i in steps]
    bitwise = all(again[i][0] == record[i][0] for i in steps)
    log(f"{tag} restored step {TRAIN_CKPT_EVERY}: {leaves} leaves equal to "
        f"the manifest's sha256; steps {TRAIN_CKPT_EVERY}-"
        f"{TRAIN_STEPS - 1} losses against the uninterrupted run: max "
        f"relative difference {max(diff):.3g} (tol {TRAIN_RESTART_RTOL}), "
        f"bitwise equal: {bitwise}")
    if max(diff) > TRAIN_RESTART_RTOL:
        raise AssertionError(f"{tag} losses differ: "
                             f"{[(again[i][0], record[i][0]) for i in steps]}")


def train_narrow():
    """(c): the narrow float32 config, 3 steps on the card and on the CPU
    from one init; returns (model, card params after the steps)."""
    import torch
    from repro_torch import tree
    from repro_torch.configs import get_smoke_config
    from repro_torch.data.synthetic import SyntheticStream
    from repro_torch.models.lm import build_model
    from repro_torch.optim.adamw import AdamW
    from repro_torch.optim.schedules import warmup_cosine
    from repro_torch.train.trainer import Trainer, TrainerConfig
    tag = "[train card==cpu]"
    cfg = get_smoke_config("smollm-135m").with_(**TRAIN_NARROW)
    model = build_model(cfg)
    opt = AdamW(lr=3e-3, schedule=warmup_cosine(
        TRAIN_NARROW_STEPS // 10 + 1, TRAIN_NARROW_STEPS))
    card = Trainer(model, opt, TrainerConfig(seed=SEED))
    cpu = Trainer(model, opt, TrainerConfig(seed=SEED), device="cpu")
    s_card = card.init_state()
    s_cpu = tree.map(lambda t: t.cpu(), s_card)
    s_eager = tree.map(lambda t: t.clone(), s_card)
    eager = Trainer(model, opt, TrainerConfig(seed=SEED), graph=False)
    stream = SyntheticStream(cfg, TRAIN_NARROW_S, TRAIN_NARROW_B, seed=SEED)
    rel = []
    for i in range(TRAIN_NARROW_STEPS):
        batch = stream.batch_at(i)
        s_card, m_card = card.train_step(s_card, batch)
        s_cpu, m_cpu = cpu.train_step(s_cpu, batch)
        s_eager, _ = eager.train_step(s_eager, batch)
        a, b = float(m_card["loss_total"]), float(m_cpu["loss_total"])
        rel.append(abs(a - b) / abs(b))
    diffs = torch.cat([(a.cpu() - b).abs().reshape(-1) for a, b in zip(
        tree.leaves(s_card.params), tree.leaves(s_cpu.params))])
    worst = diffs.max().item()
    share = (diffs > TRAIN_PARAM_ATOL).double().mean().item()
    replay_eager = max((a - b).abs().max().item() for a, b in zip(
        tree.leaves(s_card.params), tree.leaves(s_eager.params)))
    bound = 2 * opt.lr * TRAIN_NARROW_STEPS
    log(f"{tag} {cfg.name} smoke ({cfg.num_layers} layers, d="
        f"{cfg.d_model}, float32, remat {cfg.remat}), B={TRAIN_NARROW_B} x "
        f"{TRAIN_NARROW_S}, {TRAIN_NARROW_STEPS} steps: loss relative "
        f"differences {[f'{r:.3g}' for r in rel]} (tol {TRAIN_LOSS_RTOL}); "
        f"params: max |diff| {worst:.3g} (bound 2 lr x steps = {bound:.3g}),"
        f" share above {TRAIN_PARAM_ATOL} {share:.3g} (tol "
        f"{TRAIN_PARAM_SHARE}); the card's graph replays against its eager "
        f"steps: params max |diff| {replay_eager:.3g}")
    if max(rel) > TRAIN_LOSS_RTOL or worst > bound or \
            share > TRAIN_PARAM_SHARE or replay_eager > TRAIN_PARAM_ATOL:
        raise AssertionError(f"{tag} card and CPU training differ")
    return model, s_card.params, stream


def train_qat_deploy(model, params, stream,
                     tag: str = "[train qat==deploy]") -> None:
    """(d), narrow: the trained model's QAT logits against its deploy
    logits (our kernels) on the card."""
    import torch
    toks = stream.batch_at(100)["tokens"]
    with torch.no_grad():
        qat = model.qat_logits(params, toks)
        dparams = model.convert(params)
        dep = model.prefill_logits(dparams, toks)
    diff = (qat - dep).abs().max().item()
    same = bool(torch.equal(qat.argmax(-1), dep.argmax(-1)))
    log(f"{tag} narrow float32 model after its steps, B={toks.shape[0]} x "
        f"{toks.shape[1]}: QAT logits against prefill_logits on the card: "
        f"max |diff| {diff:.3g} (tol {QAT_DEPLOY_ATOL}), argmax equal "
        f"{same}")
    if diff > QAT_DEPLOY_ATOL or not same:
        raise AssertionError(f"{tag} QAT and deploy logits differ")


def train_serve(trainer, stream, state, tag: str = "[train serve]") -> dict:
    """(d): the trained full-width params, converted, serve 8 prompts of
    the stream greedily through ``ServeEngine.generate`` (the decode step
    a replayed graph); returns the run's launch counts."""
    import torch
    from repro_torch import kernels, tree
    from repro_torch.serve.engine import (CacheConfig, ServeConfig,
                                          ServeEngine)
    model = trainer.model
    with torch.no_grad():
        dparams = model.convert(tree.map(lambda t: t.detach(),
                                         state.params))
    prompts = stream.batch_at(1000)["tokens"][:SERVE_B]
    eng = ServeEngine(model, dparams, ServeConfig(
        cache=CacheConfig(max_len=prompts.shape[1] + SERVE_NEW)))
    eng.generate(prompts, max_new_tokens=2)            # warm-up: captures
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks, _ = eng.generate(prompts, max_new_tokens=SERVE_NEW)
    total = time.perf_counter() - t0
    launches = kernels.launch_counts()
    idle = [n for n in STATIC_PATH if launches[n] == 0]
    if idle or eng._graphs.captures["decode"] != 1:
        raise AssertionError(f"{tag} kernels {idle} idle, captures "
                             f"{eng._graphs.captures}: {launches}")
    seq = np.concatenate([prompts[:, -1:], toks], axis=1)
    succ = stream.successors
    hits = [int(b) in succ[a] for row in seq for a, b in zip(row, row[1:])]
    log(f"{tag} trained params converted; B={SERVE_B} stream prompts of "
        f"{prompts.shape[1]} tokens, {SERVE_NEW} greedy tokens in "
        f"{total:.3f} s ({SERVE_B * SERVE_NEW / total:.1f} tok/s); "
        f"launches {json.dumps(launches)}; generated bigrams in the "
        f"stream's table {np.mean(hits):.3f} ({sum(hits)} of {len(hits)}; "
        f"chance {stream.branching / model.cfg.vocab_size:.2e}); sample "
        f"{toks[0, :8].tolist()}")
    return launches


def phase_train() -> dict:
    """Phase 22 (see the module docstring); returns the serve's launch
    counts."""
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        tmp = Path(d)
        trainer, stream, state, record = train_full(tmp)
        launches = train_serve(trainer, stream, state)
        train_profile(trainer, stream, state)
        del trainer, state
        train_restart(tmp, record)
    train_qat_deploy(*train_narrow())
    return launches


# -- phase 23: train families ------------------------------------------------

# (tag, arch, layers (0: full depth), batch, seq_len): one chip each
FAMILY_CELLS = (("[train-mixtral]", "mixtral-8x22b", 1, 4, 128),
                ("[train-hymba]", "hymba-1.5b", 8, 8, 64),
                ("[train-xlstm]", "xlstm-350m", 6, 8, 64),
                ("[train-seamless]", "seamless-m4t-large-v2", 0, 4, 128))
FAMILY_STEPS, FAMILY_MEDIAN_FROM = 10, 3     # median over steps 3..9
# the leaves this slice made trainable, by path: after the first step
# each must have a finite, nonzero gradient, read from its first moment
# (after one step from zero moments, (1 - b1) * clip scale * gradient)
FAMILY_NEW_LEAVES = {
    "mixtral-8x22b": (r"/ffn/router/kernel$",
                      r"/ffn/experts/w[123]/w_latent$"),
    "hymba-1.5b": (r"/mamba/a_log$", r"/mamba/dt_bias$"),
    "xlstm-350m": (r"/cell/f_bias$", r"/cell/w_gates$"),
    "seamless-m4t-large-v2": (r"^decoder/\d+/cross/wq/w_latent$",
                              r"^encoder/\d+/attn/sps_lambda$")}
FAMILY_PATHS = {"mixtral-8x22b": STATIC_PATH, "hymba-1.5b": STATIC_PATH,
                "xlstm-350m": RECURRENT_PATH,
                "seamless-m4t-large-v2": ENCDEC_PATH}
FAMILY_SERVE_B, FAMILY_SERVE_NEW = 4, 16
# (b): the smoke configs (float32, remat per block) card against CPU;
# mixtral at its full config's capacity factor 1.25, so claims drop
FAMILY_NARROW = ("mixtral-8x22b", "arctic-480b", "hymba-1.5b",
                 "xlstm-350m", "seamless-m4t-large-v2")
FAMILY_NARROW_CF = 1.25
FAMILY_NARROW_B, FAMILY_NARROW_S = 8, 64
FAMILY_NARROW_CPU_STEPS, FAMILY_NARROW_STEPS = 3, 20
# (c): JAX's QAT == deploy list (``tests/test_models_deploy.py``)
FAMILY_QAT_DEPLOY = ("mixtral-8x22b", "hymba-1.5b", "xlstm-350m")


class NoCheckpoint:
    """``ft.run``'s checkpointer for the family cells: nothing to restore
    and nothing written (phase 22 holds checkpoints and restarts;
    mixtral's layer alone would write 35 GB of state)."""

    def latest_step(self):
        return None

    def save(self, *args, **kwargs) -> None:
        pass


def _optimizer(cfg, steps: int):
    """``launch/train.build``'s optimizer for ``steps`` steps."""
    import torch
    from repro_torch.optim.adamw import AdamW
    from repro_torch.optim.schedules import warmup_cosine
    return AdamW(lr=3e-3, schedule=warmup_cosine(steps // 10 + 1, steps),
                 moment_dtype=getattr(torch, cfg.optim_moment_dtype))


def first_step_gradients(tag: str, state, patterns) -> None:
    """Gate: every leaf whose path matches one of ``patterns`` has a
    finite, nonzero first moment after the first step (so a finite,
    nonzero gradient)."""
    import re
    import torch
    from repro_torch import tree
    report = []
    for pat in patterns:
        hits = [(n, m) for n, m in tree.leaves_with_paths(state.opt.mu)
                if re.search(pat, n)]
        bad = [n for n, m in hits if not (bool(torch.isfinite(m).all())
                                          and bool((m != 0).any()))]
        report.append(f"{pat} {len(hits)} leaves, {len(bad)} zero or "
                      f"not finite")
        if not hits or bad:
            raise AssertionError(f"{tag} gradients after the first step: "
                                 f"{pat}: {len(hits)} leaves, bad {bad[:4]}")
    log(f"{tag} after the first step, the new leaves' gradients are finite "
        f"and nonzero (read from the first moments): " + "; ".join(report))


def family_cell(tag: str, arch: str, layers: int, batch: int,
                seq_len: int) -> dict:
    """(a) and (d) of one cell: ``arch`` at full width (``layers`` of its
    depth when given) trains FAMILY_STEPS steps of the seeded stream
    through ``ft.run`` as ``launch/train.build`` builds the trainer, one
    captured step that donates its state; then its params convert and
    serve FAMILY_SERVE_B prompts of the stream through the Hopper
    kernels.  Returns the serve's launch counts."""
    import gc
    import torch
    from repro_torch import tree
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import SyntheticStream
    from repro_torch.models.lm import build_model
    from repro_torch.train import ft
    from repro_torch.train.trainer import Trainer, TrainerConfig
    cfg = get_config(arch)
    if layers:
        cfg = cfg.with_(num_layers=layers)
    model = build_model(cfg)
    trainer = Trainer(model, _optimizer(cfg, FAMILY_STEPS),
                      TrainerConfig(seed=SEED))
    stream = SyntheticStream(cfg, seq_len, batch, seed=SEED)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    record, aux, gnorms = {}, [], []

    def on_step(step, metrics, dt):
        record[step] = (float(metrics["loss"]), dt)
        aux.append(float(metrics["moe_aux"]))
        gnorms.append(float(metrics["grad_norm"]))
        if step == 0:
            graph = next(iter(trainer._graphs.values()))
            first_step_gradients(tag, graph.state, FAMILY_NEW_LEAVES[arch])

    drops = DropCounter()
    drops.label = "the step's eager warm-ups"
    t0 = time.perf_counter()
    with drops:
        state = ft.run(trainer, stream, NoCheckpoint(), steps=FAMILY_STEPS,
                       ckpt_every=0, log_every=FAMILY_STEPS,
                       log_fn=lambda m: log(f"{tag} {m}"), on_step=on_step)
    total = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    n = sum(p.numel() for p in tree.leaves(state.params))
    state_gib = sum(t.numel() * t.element_size() for t in tree.leaves(
        (state.params, state.opt.mu, state.opt.nu))) / 2**30
    losses = [record[i][0] for i in range(FAMILY_STEPS)]
    ms = [1e3 * record[i][1] for i in range(FAMILY_MEDIAN_FROM,
                                               FAMILY_STEPS)]
    med = float(np.median(ms))
    tokens = batch * seq_len
    depth = (f"{cfg.num_layers} of {get_config(arch).num_layers} layers"
             if layers else f"{cfg.num_layers} layers")
    if cfg.num_encoder_layers:
        depth += f" + {cfg.num_encoder_layers} encoder layers"
    log(f"{tag} {arch}: {depth}, d={cfg.d_model}, {cfg.num_heads}/"
        f"{cfg.num_kv_heads} heads, d_ff={cfg.d_ff}, vocab "
        f"{cfg.vocab_size}{moe_text(cfg)}; {cfg.compute_dtype} compute, "
        f"float32 masters, {cfg.optim_moment_dtype} moments, remat "
        f"{cfg.remat}; {n:,} parameters; B={batch} x {seq_len} tokens"
        + (f" after {cfg.frontend_tokens} frames" if cfg.frontend_tokens
           else ""))
    log(f"{tag} {FAMILY_STEPS} steps in {total:.1f} s; ms per step (median "
        f"of steps {FAMILY_MEDIAN_FROM}-{FAMILY_STEPS - 1}) {med:.2f} (min "
        f"{min(ms):.2f}, max {max(ms):.2f}), {tokens / med * 1e3:.0f} "
        f"tokens/s; first step (warm-ups and capture) "
        f"{record[0][1]:.2f} s; peak memory {peak / 2**30:.2f} GiB "
        f"(params and moments {state_gib:.2f} GiB)")
    log(f"{tag} losses {json.dumps([round(x, 4) for x in losses])}"
        + (f"; load-balance losses {json.dumps([round(x, 4) for x in aux])}"
           if cfg.moe.num_experts else "")
        + f"; gradient norms {[f'{g:.4g}' for g in gnorms]} (inf: the "
        f"float32 sum of squares overflows, as JAX's global_norm would, "
        f"and the clip then zeroes the step's gradients)")
    if cfg.moe.num_experts:
        drops.log(tag)
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{tag} losses not finite: {losses}")
    if trainer.captures != 1:
        raise AssertionError(f"{tag} {trainer.captures} step captures")
    batch_np = stream.batch_at(FAMILY_STEPS)
    dev, launches, by_name = device_profile(
        lambda: trainer.train_step(state, batch_np), iters=1, warm=False)
    log(f"{tag} one profiled replay (an 11th step): device busy {dev:.2f} "
        f"ms, {launches:.0f} kernels in the captured step; top by device "
        f"time:")
    log_top_kernels(tag, by_name, 5)
    params = state.params
    del state
    trainer._graphs.clear()
    gc.collect()
    torch.cuda.empty_cache()
    with torch.no_grad():
        dparams = model.convert(params)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    serve = stream.batch_at(1000)
    prompts = serve["tokens"][:FAMILY_SERVE_B]
    fe = serve.get("frontend_embeds")
    launches, _ = serve_static(
        model, dparams, f"{tag[:-1]} serve]",
        (FAMILY_SERVE_B, prompts.shape[1], FAMILY_SERVE_NEW),
        path=FAMILY_PATHS[arch], prompts=prompts,
        frontend=None if fe is None else fe[:FAMILY_SERVE_B])
    del dparams
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def family_narrow(arch: str):
    """(b) of one arch: its smoke config (float32, remat per block) trains
    FAMILY_NARROW_CPU_STEPS steps on the card and on the CPU from one
    init, then the card runs on to FAMILY_NARROW_STEPS; returns (model,
    the card's params)."""
    import torch
    from repro_torch import tree
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import MoEConfig
    from repro_torch.data.synthetic import SyntheticStream
    from repro_torch.models.lm import build_model
    from repro_torch.train.trainer import Trainer, TrainerConfig
    tag = f"[train-families card==cpu] {arch}:"
    cfg = get_smoke_config(arch).with_(remat="block")
    if arch == "mixtral-8x22b":
        cfg = cfg.with_(moe=MoEConfig(
            num_experts=cfg.moe.num_experts, top_k=cfg.moe.top_k,
            capacity_factor=FAMILY_NARROW_CF))
    model = build_model(cfg)
    opt = _optimizer(cfg, FAMILY_NARROW_STEPS)
    card = Trainer(model, opt, TrainerConfig(seed=SEED))
    cpu = Trainer(model, opt, TrainerConfig(seed=SEED), device="cpu")
    s_card = card.init_state()
    s_cpu = tree.map(lambda t: t.cpu(), s_card)
    stream = SyntheticStream(cfg, FAMILY_NARROW_S, FAMILY_NARROW_B,
                             seed=SEED)
    rel, losses = [], []
    drops = DropCounter()
    drops.label = "the CPU's steps"
    for i in range(FAMILY_NARROW_STEPS):
        batch = stream.batch_at(i)
        s_card, m_card = card.train_step(s_card, batch)
        losses.append(float(m_card["loss_total"]))
        if i < FAMILY_NARROW_CPU_STEPS:
            with drops:
                s_cpu, m_cpu = cpu.train_step(s_cpu, batch)
            b = float(m_cpu["loss_total"])
            rel.append(abs(losses[-1] - b) / abs(b))
        if i == FAMILY_NARROW_CPU_STEPS - 1:
            diffs = torch.cat([(a.cpu() - b).abs().reshape(-1)
                               for a, b in zip(tree.leaves(s_card.params),
                                               tree.leaves(s_cpu.params))])
    worst = diffs.max().item()
    share = (diffs > TRAIN_PARAM_ATOL).double().mean().item()
    bound = 2 * opt.lr * FAMILY_NARROW_CPU_STEPS
    log(f"{tag} smoke ({cfg.num_layers} layers, d={cfg.d_model}, float32, "
        f"remat {cfg.remat}{moe_text(cfg)}), B={FAMILY_NARROW_B} x "
        f"{FAMILY_NARROW_S}, {FAMILY_NARROW_CPU_STEPS} steps: loss "
        f"relative differences {[f'{r:.3g}' for r in rel]} (tol "
        f"{TRAIN_LOSS_RTOL}); params: max |diff| {worst:.3g} (bound 2 lr x "
        f"steps = {bound:.3g}), share above {TRAIN_PARAM_ATOL} {share:.3g} "
        f"(tol {TRAIN_PARAM_SHARE}; the embedding's and index_put's "
        f"backward add with atomics on the card); the card's losses over "
        f"{FAMILY_NARROW_STEPS} steps {json.dumps([round(x, 4) for x in losses])}")
    if cfg.moe.num_experts:
        drops.log(tag)
    if max(rel) > TRAIN_LOSS_RTOL or worst > bound or \
            share > TRAIN_PARAM_SHARE:
        raise AssertionError(f"{tag} card and CPU training differ")
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"{tag} the loss did not fall over "
                             f"{FAMILY_NARROW_STEPS} steps: {losses}")
    if card.captures != 1:
        raise AssertionError(f"{tag} {card.captures} step captures")
    return model, s_card.params, stream


def phase_train_families() -> dict:
    """Phase 23 (see the module docstring); returns the serves' launch
    counts."""
    t0 = time.perf_counter()
    total = {}
    for cell in FAMILY_CELLS:
        for name, n in family_cell(*cell).items():
            total[name] = total.get(name, 0) + n
    for arch in FAMILY_NARROW:
        model, params, stream = family_narrow(arch)
        if arch in FAMILY_QAT_DEPLOY:
            train_qat_deploy(model, params, stream,
                             f"[train-families qat==deploy] {arch}:")
    log(f"[train-families] phase 23 took {time.perf_counter() - t0:.1f} s")
    return total


# -- phase 24: train on a mesh -------------------------------------------------

MESH_STEPS = 10
MESH_CAPTURED_STEPS = 5          # the captured one-device step, after capture


def _timed_step(trainer, state, batch):
    """One step, timed to the device's end: (state, loss, ms)."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, m = trainer.train_step(state, batch)
    loss = float(m["loss_total"])
    torch.cuda.synchronize()
    return state, loss, 1e3 * (time.perf_counter() - t0)


def mesh_train(tag: str, mesh):
    """(a): the CLI's smollm-135m trainer: the captured one-device step's
    time, then MESH_STEPS steps of the one-device eager trainer and of
    the mesh trainer on the (1, 1) mesh from the same init, in turns
    (eager, mesh, eager, ...), under deterministic algorithms (the
    embedding's backward otherwise adds with atomics), bitwise equal;
    returns (mesh trainer, stream, its state)."""
    import gc
    import torch
    from repro_torch import tree
    from repro_torch.launch import train as train_cli
    from repro_torch.train.trainer import Trainer
    captured, stream, _ = train_cli.build(train_cli.parse_args(
        ["--full", "--steps", str(MESH_STEPS), "--seed", str(SEED)]))
    model, opt, cfg = captured.model, captured.opt, captured.cfg
    s_c, cap_ms = captured.init_state(), []
    for i in range(1 + MESH_CAPTURED_STEPS):
        s_c, _, ms = _timed_step(captured, s_c, stream.batch_at(i))
        cap_ms.append(ms)
    del captured, s_c
    gc.collect()
    torch.cuda.empty_cache()
    eager = Trainer(model, opt, cfg, graph=False)
    meshed = Trainer(model, opt, cfg, mesh=mesh)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        s_e = eager.init_state()
        torch.cuda.reset_peak_memory_stats()
        s_m = meshed.init_state()
        before = mesh.collectives
        losses_e, losses_m, ms_e, ms_m = [], [], [], []
        for i in range(MESH_STEPS):
            batch = stream.batch_at(i)
            s_e, loss, ms = _timed_step(eager, s_e, batch)
            losses_e.append(loss)
            ms_e.append(ms)
            s_m, loss, ms = _timed_step(meshed, s_m, batch)
            losses_m.append(loss)
            ms_m.append(ms)
        peak = torch.cuda.max_memory_allocated()
        per_step = (mesh.collectives - before) / MESH_STEPS
    finally:
        torch.use_deterministic_algorithms(False)
    parts = {"params": (s_m.params, s_e.params),
             "mu": (s_m.opt.mu, s_e.opt.mu), "nu": (s_m.opt.nu, s_e.opt.nu)}
    equal = {k: all(torch.equal(a, b) for a, b in
                    zip(tree.leaves(m), tree.leaves(e)))
             for k, (m, e) in parts.items()}
    state_gib = sum(t.numel() * t.element_size() for t in tree.leaves(
        (s_m.params, s_m.opt.mu, s_m.opt.nu))) / 2**30
    med = lambda xs: float(np.median(xs[1:]))
    log(f"{tag} {model.cfg.name} at full width and depth, B="
        f"{stream.global_batch} x {stream.seq_len}, seed {SEED}, on a "
        f"{mesh} mesh of a one-rank NCCL world: ms per step (median of "
        f"steps 1-{MESH_STEPS - 1}, the two trainers in turns) mesh "
        f"{med(ms_m):.2f}, one-device eager {med(ms_e):.2f} (both under "
        f"deterministic algorithms), one-device captured "
        f"{float(np.median(cap_ms[1:])):.2f} (median of "
        f"{MESH_CAPTURED_STEPS} replays; its capture step "
        f"{cap_ms[0]:.1f}); collectives per mesh step {per_step:g} (every "
        f"group of a one-rank world has one rank); peak memory over both "
        f"runs {peak / 2**30:.2f} GiB (each state {state_gib:.2f} GiB)")
    log(f"{tag} the mesh step splits its compute along \"model\" "
        f"(attention by heads, the FFN by columns, the residual stream by "
        f"sequence) at a width of {mesh.shape['model']}: every exchange the "
        f"identity, the one-device arithmetic")
    log(f"{tag} mesh against one-device eager over {MESH_STEPS} steps: "
        f"losses equal {losses_m == losses_e}, params / moments bitwise "
        f"equal {equal}; losses {json.dumps([round(x, 4) for x in losses_m])}")
    if losses_m != losses_e or not all(equal.values()):
        raise AssertionError(f"{tag} the mesh trainer differs from the "
                             f"one-device trainer: {losses_m} vs {losses_e}")
    if not losses_m[-1] < losses_m[0]:
        raise AssertionError(f"{tag} the loss did not fall: {losses_m}")
    return meshed, stream, s_m


def mesh_allreduce_1bit(tag: str, trainer, stream, state) -> dict:
    """(b): ``allreduce_1bit`` of every leaf of a gradient of the trained
    model over the one-rank NCCL world (counted launches: one pack per
    leaf); then each leaf's packed words against the pack kernel's plain
    version on the CPU and each result against the plain path, bitwise.
    Returns the counted launches."""
    import torch
    from repro_torch import kernels, tree
    from repro_torch.kernels.pack import ref as pack_ref
    from repro_torch.optim import compress
    batch = trainer.batch_on_device(stream.batch_at(MESH_STEPS))
    grads = tree.leaves_with_paths(trainer.loss_and_grads(state.params,
                                                          batch)[2])
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = [compress.allreduce_1bit(g) for _, g in grads]
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    launches = kernels.launch_counts()
    if launches["pack_threshold"] != len(grads):
        raise AssertionError(f"{tag} {launches['pack_threshold']} pack "
                             f"launches for {len(grads)} leaves")
    ragged = bad = 0
    zero = torch.zeros((), dtype=torch.float32)
    for (path, g), out in zip(grads, outs):
        flat = g.reshape(-1)
        words = compress.sign_words(flat).cpu()
        plain = pack_ref.pack_threshold(flat.float().cpu()[None], zero)[0]
        scale = flat.abs().mean()
        want = torch.where(flat >= 0, scale, -scale).reshape(g.shape)
        ragged += flat.numel() % 32 != 0
        if not (torch.equal(words, plain) and torch.equal(out, want)):
            bad += 1
            log(f"{tag} allreduce_1bit differs at {path}")
    n = sum(g.numel() for _, g in grads)
    log(f"{tag} allreduce_1bit over {len(grads)} gradient leaves ({n:,} "
        f"values, {ragged} of lengths not a multiple of 32) on the NCCL "
        f"world: {launches['pack_threshold']} pack_threshold launches, "
        f"{ms:.1f} ms in all; packed words bitwise equal to the plain "
        f"version and results to the plain path: {bad == 0}")
    if bad or not ragged:
        raise AssertionError(f"{tag} allreduce_1bit: {bad} leaves differ, "
                             f"{ragged} ragged lengths")
    return launches


def phase_train_mesh() -> dict:
    """Phase 24 (see the module docstring); returns the counted runs'
    launch counts."""
    import torch.distributed as dist
    from repro_torch.launch import mesh as mesh_lib
    tag = "[train-mesh]"
    t0 = time.perf_counter()
    log(f"{tag} {phase_device_line()}")
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = mesh_lib.make_host_mesh(1, "cuda")
        trainer, stream, state = mesh_train(tag, mesh)
        launches = mesh_allreduce_1bit(tag, trainer, stream, state)
        served = train_serve(trainer, stream, state._replace(
            params=trainer.whole_params(state.params)),
            "[train-mesh serve]")
    finally:
        dist.destroy_process_group()
    log(f"{tag} phase 24 took {time.perf_counter() - t0:.1f} s")
    return {k: launches[k] + served[k] for k in launches}


DRY_WORKERS = 7            # CPU processes that run the dry run's sweep
                           # (the card's machine has 8 cores)
DRY_OUT = ROOT / "build" / "dryrun-smoke"
DRY_RATIO = (0.8, 1.2)     # traced args + temp over the measured peak
DRY_ARCH = "smollm-135m"
# the single-pod train_4k cells as the dry run traced the mesh trainer
# before its compute was split along "model" (every activation and FLOP of
# a rank's rows whole along it; ``python -m repro_torch.launch.dryrun
# --all --mesh single``): (arguments + temp bytes a rank, dense FLOPs a
# rank, collective bytes a rank and step)
DRY_UNSPLIT = {
    "arctic-480b": (2450698717204, 128113205082849280, 4172446005412),
    "gemma3-27b": (398422125636, 15065783201693696, 230371831516),
    "granite-3-2b": (260509779224, 1667065786138624, 21753173276),
    "hymba-1.5b": (201920230576, 1057528322457600, 14108228764),
    "internvl2-76b": (702222432664, 39013215174131712, 608548573724),
    "mixtral-8x22b": (4524848029044, 571599399080165376, 1230856129756),
    "qwen1.5-32b": (383190758232, 19349686661939200, 301405658140),
    "seamless-m4t-large-v2": (209913418136, 604628316061696, 12070623644),
    "smollm-135m": (72503853672, 141012366262272, 1059195204),
    "xlstm-350m": (290030168116, 141360258613248, 2303578140),
}
# the cells the split must bring onto one 80 GB card: memory and FLOPs a
# rank at least DRY_FALL times smaller, memory under DRY_FITS, collective
# bytes no more than before
DRY_SPLIT = ("qwen1.5-32b", "gemma3-27b", "granite-3-2b", "internvl2-76b",
             "seamless-m4t-large-v2")
# the two of them whose split step moves more collective bytes than before
# (at d = 1,024 and 2,048 the activations' gradients outweigh the
# weights): held to the split's own bytes a rank and step, as the dry run
# traced them (``python -m repro_torch.launch.dryrun --shape train_4k``)
DRY_COLL_GROWN = {"granite-3-2b": 28855294172,
                  "seamless-m4t-large-v2": 19591039356}
DRY_FALL = 8
DRY_FITS = 74.5 * 2**30
# the single-pod cells as the dry run traced them before the mesh decode
# step was split along "model" (every deploy leaf and every split cache
# leaf gathered whole at each step; ``python -m repro_torch.launch.dryrun
# --all --mesh single``): (arguments + temp bytes a rank, dense FLOPs a
# rank, collective bytes a rank and step, rbmm_int's word ops a rank)
DRY_GATHERED = {
    ("arctic-480b", "decode_32k"): (10193467088, 4183818240, 61686374400,
                                    193880064000),
    ("arctic-480b", "prefill_32k"): (847543191664, 34273839022080,
                                     62273505280, 0),
    ("arctic-480b", "train_4k"): (2272264570552, 125033520258088960,
                                  6196438647972, 0),
    ("gemma3-27b", "decode_32k"): (6662292512, 22548578304, 10409918464,
                                   21539192832),
    ("gemma3-27b", "long_500k"): (6884098108, 2818572288, 11730731008,
                                  6467272704),
    ("gemma3-27b", "prefill_32k"): (77734216384, 184717953466368,
                                    8849637376, 0),
    ("gemma3-27b", "train_4k"): (32826087028, 941611450105856,
                                 147623349900, 0),
    ("granite-3-2b", "decode_32k"): (1979108768, 1619001344, 711950336,
                                     5851054080),
    ("granite-3-2b", "prefill_32k"): (16917241216, 13262859010048,
                                      711950336, 0),
    ("granite-3-2b", "train_4k"): (17652681612, 106940390703104,
                                   28855294172, 0),
    ("hymba-1.5b", "decode_32k"): (503530272, 1232076800, 774406144,
                                   1228800000),
    ("hymba-1.5b", "long_500k"): (469214612, 154009600, 722960384,
                                  153600000),
    ("hymba-1.5b", "prefill_32k"): (11884063488, 10093173145600, 712146944,
                                    0),
    ("hymba-1.5b", "train_4k"): (63798361236, 327051290607616, 51584759452,
                                 0),
    ("internvl2-76b", "decode_32k"): (15344259616, 16810770432,
                                      16983392256, 83550535680),
    ("internvl2-76b", "prefill_32k"): (72206131840, 137748191117312,
                                       16983392256, 0),
    ("internvl2-76b", "train_4k"): (60957321940, 2463455802032128,
                                    313751130652, 0),
    ("mixtral-8x22b", "decode_32k"): (3870437104, 3265265664, 19199279104,
                                      5813305344),
    ("mixtral-8x22b", "long_500k"): (3160858404, 408158208, 19257884672,
                                     13410238464),
    ("mixtral-8x22b", "prefill_32k"): (1994687279488, 26749056319488,
                                       20138688512, 0),
    ("mixtral-8x22b", "train_4k"): (4309286470860, 567738463999229952,
                                    1945539183804, 0),
    ("qwen1.5-32b", "decode_32k"): (28650506688, 12457082880, 10456530944,
                                    41334865920),
    ("qwen1.5-32b", "prefill_32k"): (60839008384, 102048422952960,
                                     10456530944, 0),
    ("qwen1.5-32b", "train_4k"): (39589964276, 1251686614040576,
                                  216400288796, 0),
    ("seamless-m4t-large-v2", "decode_32k"): (2579844320, 4198498304,
                                              3837067264, 1509949440),
    ("seamless-m4t-large-v2", "prefill_32k"): (68917108096, 34398393073664,
                                               2240118784, 309237645312),
    ("seamless-m4t-large-v2", "train_4k"): (15291589016, 37853694263296,
                                            19591039356, 0),
    ("smollm-135m", "decode_32k"): (549790732, 452984832, 127070208,
                                    928972800),
    ("smollm-135m", "prefill_32k"): (13308819464, 3710851743744, 127070208,
                                     0),
    ("smollm-135m", "train_4k"): (8292260392, 13426671747072, 5427785412,
                                  0),
    ("xlstm-350m", "decode_32k"): (1216143648, 1165099008, 440795136,
                                   157286400),
    ("xlstm-350m", "long_500k"): (468850084, 145637376, 524156928, 19660800),
    ("xlstm-350m", "prefill_32k"): (14199337984, 9544491073536, 440008704,
                                    0),
    ("xlstm-350m", "train_4k"): (286513129524, 122322816073728, 16441176092,
                                 0),
}
# the decode cells whose collective bytes the split must cut at least
# DRY_COLL_FALL times (and, at decode_32k, their dense FLOPs and rbmm_int's
# word ops a rank at least DRY_FALL times); hymba's and xlstm's decode
# cells, whose recurrences compute whole, at least DRY_WHOLE_FALL times
DRY_DECODE_SPLIT = ("qwen1.5-32b", "gemma3-27b", "granite-3-2b",
                    "smollm-135m", "internvl2-76b", "seamless-m4t-large-v2",
                    "mixtral-8x22b", "arctic-480b")
DRY_LONG_SPLIT = ("gemma3-27b", "mixtral-8x22b")
DRY_COLL_FALL = 10
DRY_WHOLE_FALL = 2
# the single-pod prefill_32k cells as the dry run traced them before the
# mesh prefill was split along "model" (every block whole on every rank's
# rows; ``python -m repro_torch.launch.dryrun --shape prefill_32k``), the
# work a rank that ``DRY_GATHERED`` does not hold: (``rbmm_mxu``'s
# operations, ``sps_attention``'s operations, the roofline's
# ``step_time_s``)
DRY_PREFILL_SPLIT = {
    "qwen1.5-32b": (4409041627381760, 1407417833226240, 8.38412422434388),
    "gemma3-27b": (3355228451635200, 232209353015296, 6.616772346001194),
    "granite-3-2b": (318858372055040, 351854458306560, 1.657175535799403),
    "smollm-135m": (13915694039040, 74219299799040, 0.3105339893898508),
    "internvl2-76b": (8972014882652160, 2814835666452480,
                      12.079447252747462),
    "seamless-m4t-large-v2": (74835510165504, 105762495922176,
                              0.9280209348011941),
}
DRY_PREFILL_MEM_FALL = 4
DRY_PREFILL_COLL = 1.25
# smollm's rank 0 holds one of its 9 heads, whose query bits and KV head's
# K and V^T bits it takes over the whole sequence (3 x 2 x 32,768 x 64
# bits a layer), beside the tied table gathered whole (1.13e8 B): held to
# the split's own bytes a rank, as the dry run traced them
DRY_PREFILL_COLL_HELD = {"smollm-135m": 189984768}
# arctic's MoE router computes whole on every rank
# (``models.sharding.WHOLE_PARTS``): 513,802,240 of its 743,178,240 dense
# FLOPs a rank, a 5.6x fall; held to that figure
DRY_FLOPS_WHOLE = {"arctic-480b": 743178240}
# the MoE cells whose rank computes only its share since the MoE routes a
# rank's own positions (against ``DRY_GATHERED``, which no longer holds
# them equal): (arguments + temp fall at least, collective bytes at most
# this share of before, dense FLOPs fall at least, ``rbmm_mxu``'s
# operations a rank before (the sweep of the tree whose MoE ran whole) or
# None, ``step_time_s``
# before); a prefill cell also fits (under ``DRY_FITS``) and its
# ``rbmm_mxu`` work falls at least ``DRY_FALL`` times
DRY_MOE = {
    ("mixtral-8x22b", "prefill_32k"): (20, 1.05, None, 142509901099302912,
                                       190.4530113194794),
    ("arctic-480b", "prefill_32k"): (10.6, 1.05, None, 31727954207703040,
                                     67.35805795654926),
    ("mixtral-8x22b", "train_4k"): (16, 0.5, 8, None, 856.3986758478447),
    ("arctic-480b", "train_4k"): (8, 0.25, 8, None, 294.3227925448024),
}
# phase 25's MoE checks on the NCCL (1, 1) mesh: mixtral at full width and
# capacity factor ``MOE_DROP_CF`` (claims drop), one block a train step on
# B x S tokens, two a prefill of B x S positions
MOE_MESH_TRAIN = (1, 2, 64)
MOE_MESH_PREFILL = (2, 2, 2048)
# the simulated "model" width of ``dryrun_moe_ranks`` (each rank 1,024
# rows of MOE_MESH_PREFILL's batch: one router block)
MOE_RANKS = 4
# rbmm_mxu on an expert group's buffer: (experts, rows, K, P) of mixtral's
# w1 and arctic's w2 (a group of 18 at 7,168 outputs), rows cut so the
# plain version ends in seconds
MOE_MXU_SHAPES = ((8, 1024, 6144, 16384), (18, 512, 4864, 7168))


def dryrun_start():
    """Start the dry run's sweep: every arch x shape cell on the
    single-pod mesh, traced by ``DRY_WORKERS`` CPU processes (no card:
    they trace on the meta device).  ``phase_dryrun`` starts it when the
    last host-timed phase has ended and waits for it.  The sweep stays in
    this script's process group and ends with this process (``dryrun``
    run as a program, and each of its workers, die with their parent);
    if the script ends first, it is killed.  Returns (process, its log's
    path, its start on ``time.perf_counter``)."""
    import atexit
    import os
    import shutil
    shutil.rmtree(DRY_OUT, ignore_errors=True)
    DRY_OUT.mkdir(parents=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    log_path = DRY_OUT / "sweep.log"
    with open(log_path, "w") as out:
        proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--all",
             "--mesh", "single", "--out", str(DRY_OUT), "--jobs",
             str(DRY_WORKERS)], env=env, cwd=str(ROOT), stdout=out,
            stderr=subprocess.STDOUT)

    def stop():
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    atexit.register(stop)
    return proc, log_path, time.perf_counter()


def _meta_like(tree_):
    import torch
    from repro_torch import tree
    return tree.map(lambda t: torch.empty_like(t, device="meta"), tree_)


def dryrun_census(tag: str, model, dparams, prompts) -> dict:
    """The static decode step (B = 8, phase 4's cache) traced on meta
    against one eager step on the card: launches and dense FLOPs exact,
    the roofline's step time at most the step's device time.  Returns
    the card's launches."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch import kernels, tree
    from repro_torch.launch import cost, roofline
    max_len = SERVE_S + SERVE_NEW
    with torch.inference_mode():
        logits, caches = model.prefill_with_cache(
            dparams, torch.as_tensor(prompts, device="cuda"),
            max_len=max_len)
        tok = logits[:, -1:].argmax(-1)
        census, _ = cost.measure(
            lambda dp, t, cs: model.decode_step(dp, t, cs),
            (_meta_like(dparams), torch.empty_like(tok, device="meta"),
             _meta_like(caches)))
        step_caches = clone_caches(caches)
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        with FlopCounterMode(display=False) as fc:
            model.decode_step(dparams, tok, step_caches)
        torch.cuda.synchronize()
        launches = kernels.launch_counts()
        # the step again on its own caches: 6 more positions of 160
        ms, _, _ = device_profile(
            lambda: model.decode_step(dparams, tok, step_caches), iters=5)
    counted = {n: c for n, c in launches.items() if c}
    rec = census.record()
    terms = roofline.terms_from_artifact(rec)
    log(f"{tag} {DRY_ARCH} static decode step, B={SERVE_B}, a cache of "
        f"{max_len}: traced on meta {json.dumps(census.launches())}, "
        f"counted on the card {json.dumps(counted)}; dense FLOPs traced "
        f"{census.flops:,}, FlopCounterMode on the card "
        f"{fc.get_total_flops():,}; traced bytes {census.bytes:,}, "
        f"arguments {census.arguments / 2**20:.2f} MiB, temp "
        f"{census.temp / 2**20:.2f} MiB; roofline step {1e3 * terms.step_time_s:.4f} "
        f"ms ({terms.dominant}) <= device time {ms:.4f} ms (a step, mean "
        f"of 5 under torch.profiler)")
    if census.launches() != counted or \
            census.flops != fc.get_total_flops():
        raise AssertionError(f"{tag} the census differs from the card's "
                             f"step")
    if counted != {"pack_threshold": 180, "rbmm_int": 270}:
        raise AssertionError(f"{tag} launches per decode step {counted}")
    if 1e3 * terms.step_time_s > ms:
        raise AssertionError(f"{tag} the roofline's step time exceeds the "
                             f"measured step: a counting error")
    return launches


def dryrun_mesh_deploy(tag: str, model, dparams, prompts, mesh,
                       phase4_tokens) -> dict:
    """The mesh ``prefill_logits`` / ``decode_step`` on the one-rank NCCL
    (1, 1) mesh against the one-device ones, bitwise, and greedy decoding
    through the mesh step against phase 4's tokens.  Returns the counted
    launches."""
    import torch
    from repro_torch import kernels, tree
    from repro_torch.launch import mesh as mesh_lib
    placed = mesh_lib.shard_tree(mesh, model.deploy_specs(), dparams)
    kernels.reset_launch_counts()
    with torch.inference_mode():
        toks = torch.as_tensor(prompts, device="cuda")
        want = model.prefill_logits(dparams, toks)
        pl = mesh_lib.Placement(mesh, mesh_lib.P(mesh_lib.data_axes(mesh),
                                                 None), toks.shape)
        got = model.prefill_logits(placed, mesh_lib.place(toks.clone(), pl),
                                   mesh=mesh)
        # the rank's placed block of the logits, put together whole
        got = mesh_lib.placement_of(got).whole(got)[..., :want.shape[-1]]
        prefill_equal = torch.equal(got, want)
        del got, want
        logits, caches = model.prefill_with_cache(
            dparams, toks, max_len=SERVE_S + SERVE_NEW)
        mine = tree.map(lambda t: mesh_lib.place(t.clone(), mesh_lib.Placement(
            mesh, mesh_lib.P(*([None] * t.dim())), t.shape)), caches)
        tok = logits[:, -1:].argmax(-1)
        out, steps_equal = [tok], True
        for _ in range(SERVE_NEW - 1):
            want, _ = model.decode_step(dparams, tok, caches)
            t_pl = mesh_lib.Placement(mesh, mesh_lib.P(None, None), tok.shape)
            got, _ = model.decode_step(placed, mesh_lib.place(tok.clone(),
                                                              t_pl),
                                       mine, mesh=mesh)
            steps_equal &= torch.equal(got, want)
            tok = got[:, -1:].argmax(-1)
            out.append(tok)
        tokens = torch.cat(out, 1).cpu().numpy()
    launches = kernels.launch_counts()
    same = np.array_equal(tokens, phase4_tokens)
    log(f"{tag} on the one-rank NCCL {mesh}: mesh prefill_logits of B="
        f"{SERVE_B} x {SERVE_S} bitwise equal to the one-device one "
        f"{prefill_equal}; {SERVE_NEW - 1} mesh decode steps' logits "
        f"bitwise equal to the one-device steps' {steps_equal}; greedy "
        f"tokens through the mesh step equal phase 4's {same} (digest "
        f"{digest(tokens.tolist())})")
    if not (prefill_equal and steps_equal and same):
        raise AssertionError(f"{tag} the mesh deploy faces differ from the "
                             f"one-device ones")
    return launches


def dryrun_train(tag: str, mesh) -> None:
    """The train face at phase 24's size traced on a (1, 1) AbstractMesh
    against the mesh trainer on the NCCL (1, 1) mesh: state bytes exact,
    traced arguments + temp within ``DRY_RATIO`` of one eager mesh step's
    peak less the memory resident beside its state, the roofline's step
    time at most the step's device time."""
    import gc
    import torch
    from repro_torch import tree
    from repro_torch.launch import cost, mesh as mesh_lib, roofline, specs
    from repro_torch.launch import train as train_cli
    from repro_torch.train.trainer import Trainer
    captured, stream, _ = train_cli.build(train_cli.parse_args(
        ["--full", "--steps", "1", "--seed", str(SEED)]))
    model, opt, cfg = captured.model, captured.opt, captured.cfg
    del captured
    abstract = mesh_lib.AbstractMesh((1, 1), ("data", "model"))
    traced = Trainer(model, opt, cfg, device="meta", mesh=abstract)
    batch = stream.batch_at(0)
    meta_batch = {k: torch.empty(np.shape(v), dtype=torch.as_tensor(v).dtype,
                                 device="meta") for k, v in batch.items()}
    census, _ = cost.measure(lambda st: traced.train_step(st, meta_batch),
                             (specs.train_state_specs(traced),))
    meshed = Trainer(model, opt, cfg, mesh=mesh)
    state = meshed.init_state()
    state_bytes = sum(t.numel() * t.element_size()
                      for t in tree.leaves(state))
    on_card = sum(t.numel() * t.element_size() for t in tree.leaves(state)
                  if t.is_cuda)
    gc.collect()
    torch.cuda.synchronize()
    other = torch.cuda.memory_allocated() - on_card
    torch.cuda.reset_peak_memory_stats()
    new, _ = meshed.train_step(state, batch)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    del new
    measured = peak - other
    got = census.arguments + census.temp
    ratio = got / measured
    ms, _, _ = device_profile(lambda: meshed.train_step(state, batch),
                              iters=1)
    terms = roofline.terms_from_artifact(census.record())
    log(f"{tag} {model.cfg.name} train step at full width and depth, B="
        f"{stream.global_batch} x {stream.seq_len}: traced state "
        f"{census.arguments:,} bytes, the mesh trainer's {state_bytes:,}; "
        f"traced arguments + temp {got / 2**30:.3f} GiB against the "
        f"measured peak {peak / 2**30:.3f} GiB less {other / 2**30:.3f} "
        f"GiB resident beside the state = {measured / 2**30:.3f} GiB: "
        f"ratio {ratio:.3f} (band {DRY_RATIO}); traced dense FLOPs "
        f"{census.flops:.4g}, bytes {census.bytes:.4g}, kernels "
        f"{json.dumps(census.launches())}; roofline step "
        f"{1e3 * terms.step_time_s:.3f} ms ({terms.dominant}) <= device "
        f"time {ms:.3f} ms (one eager mesh step under torch.profiler)")
    if census.arguments != state_bytes:
        raise AssertionError(f"{tag} traced state bytes {census.arguments}"
                             f" != {state_bytes}")
    if not DRY_RATIO[0] <= ratio <= DRY_RATIO[1]:
        raise AssertionError(f"{tag} traced memory {got} against the "
                             f"measured {measured}: ratio {ratio:.3f}")
    if 1e3 * terms.step_time_s > ms:
        raise AssertionError(f"{tag} the roofline's step time exceeds the "
                             f"measured step: a counting error")


def dryrun_sweep(tag: str, sweep) -> None:
    """Wait for the sweep; one line per cell; every cell OK or SKIP, 40
    records."""
    t0 = time.perf_counter()
    proc, path, start = sweep
    if proc.wait():
        raise AssertionError(f"{tag} the sweep exited {proc.returncode}:"
                             f"\n{path.read_text()[-4000:]}")
    waited, ran = time.perf_counter() - t0, time.perf_counter() - start
    recs = sorted((json.loads(p.read_text()) for p in DRY_OUT.glob("*.json")),
                  key=lambda r: (r["mesh"], r["arch"], r["shape"]))
    gib, worst = 2**30, 0.0
    for r in recs:
        if r["status"] == "OK":
            t = r["roofline"]
            worst = max(worst, r["trace_s"])
            log(f"{tag} {r['arch']} x {r['shape']} x {r['mesh']}: OK args "
                f"{r['argument_size_in_bytes'] / gib:.3f} GiB, temp "
                f"{r['temp_size_in_bytes'] / gib:.3f} GiB per rank, "
                f"{t['dominant']}, step_time_s {t['step_time_s']:.6g}, "
                f"collectives {sum(r['collectives'].values()):.4g} B, "
                f"build {r['build_s']:.1f} s, trace {r['trace_s']:.1f} s")
        else:
            log(f"{tag} {r['arch']} x {r['shape']} x {r['mesh']}: "
                f"{r['status']} {r.get('reason') or r.get('error')}")
    dryrun_split(tag, recs)
    dryrun_decode(tag, recs)
    dryrun_prefill(tag, recs)
    dryrun_moe(tag, recs)
    status = [r["status"] for r in recs]
    log(f"{tag} sweep: {len(recs)} cells, {status.count('OK')} OK, "
        f"{status.count('SKIP')} SKIP, {status.count('FAIL')} FAIL, in "
        f"{DRY_WORKERS} CPU workers in {ran:.1f} s, {waited:.1f} s of them "
        f"after this phase's checks (the slowest cell's trace "
        f"{worst:.1f} s)")
    if len(recs) != 40 or status.count("FAIL"):
        raise AssertionError(f"{tag} the sweep: {len(recs)} records, "
                             f"{status.count('FAIL')} FAIL")


def dryrun_split(tag: str, recs) -> None:
    """The sweep's train_4k cells against ``DRY_UNSPLIT``: the falls, the
    fit and the collectives of ``DRY_SPLIT``'s cells (``DRY_COLL_GROWN``'s
    against their own figures), and no other cell's memory grown; one
    ``[dryrun split]`` line a cell."""
    tag = tag[:-1] + " split]"
    gib, bad = 2**30, []
    train = {r["arch"]: r for r in recs if r["shape"] == "train_4k"}
    for arch, (mem0, flops0, coll0) in DRY_UNSPLIT.items():
        r = train.get(arch)
        if r is None or r["status"] != "OK":
            bad.append(f"{arch}: no OK record")
            continue
        mem = r["argument_size_in_bytes"] + r["temp_size_in_bytes"]
        coll = sum(r["collectives"].values())
        log(f"{tag} {arch} x train_4k: arguments + temp {mem0 / gib:.2f} -> "
            f"{mem / gib:.2f} GiB a rank ({mem0 / mem:.2f}x), dense FLOPs "
            f"{flops0:.4g} -> {r['flops']:.4g} ({flops0 / r['flops']:.2f}x)"
            f", collectives {coll0:.4g} -> {coll:.4g} B a step ("
            + ", ".join(f"{k} {v:.4g}" for k, v in r["collectives"].items()
                        if v) + ")")
        if arch in DRY_SPLIT:
            if not (mem0 >= DRY_FALL * mem and mem < DRY_FITS and
                    flops0 >= DRY_FALL * r["flops"] and
                    coll <= DRY_COLL_GROWN.get(arch, coll0)):
                bad.append(f"{arch}: memory {mem0} -> {mem}, FLOPs {flops0}"
                           f" -> {r['flops']}, collectives {coll0} -> "
                           f"{coll}")
        elif mem > mem0:
            bad.append(f"{arch}: memory grew {mem0} -> {mem}")
    if bad:
        raise AssertionError(f"{tag} " + "; ".join(bad))


def dryrun_decode(tag: str, recs) -> None:
    """The sweep's cells against ``DRY_GATHERED``: the decode and long_500k
    cells' falls (collective bytes, dense FLOPs, rbmm_int's word ops) and
    no memory grown; the train cells and the prefill cells but
    ``DRY_PREFILL_SPLIT``'s and ``DRY_MOE``'s equal; one ``[dryrun
    decode]`` line a decode cell."""
    tag = tag[:-1] + " decode]"
    gib, bad = 2**30, []
    got = {(r["arch"], r["shape"]): r for r in recs}
    for (arch, shape), before in DRY_GATHERED.items():
        r = got.get((arch, shape))
        if r is None or r["status"] != "OK":
            bad.append(f"{arch} x {shape}: no OK record")
            continue
        now = (r["argument_size_in_bytes"] + r["temp_size_in_bytes"],
               int(r["flops"]), int(sum(r["collectives"].values())),
               int(sum(r["kernels"].get("rbmm_int", {}).get(
                   "ops", {}).values())))
        if (shape == "prefill_32k" and arch in DRY_PREFILL_SPLIT) or \
                (arch, shape) in DRY_MOE:
            continue        # ``dryrun_prefill``'s, ``dryrun_moe``'s
        if shape in ("train_4k", "prefill_32k"):
            if now != before:
                bad.append(f"{arch} x {shape}: {before} -> {now}")
            continue
        (mem0, flops0, coll0, ops0), (mem, flops, coll, ops) = before, now
        log(f"{tag} {arch} x {shape}: collectives {coll0:.4g} -> {coll:.4g}"
            f" B a step ({coll0 / coll:.1f}x: " + ", ".join(
                f"{k} {v:.4g}" for k, v in r["collectives"].items() if v) +
            f"), dense FLOPs {flops0:.4g} -> {flops:.4g} ({flops0 / flops:.1f}"
            f"x), rbmm_int word ops {ops0:.4g} -> {ops:.4g} ("
            f"{ops0 / ops:.1f}x), arguments + temp {mem0 / gib:.3f} -> "
            f"{mem / gib:.3f} GiB a rank, step_time_s "
            f"{r['roofline']['step_time_s']:.6g} ({r['roofline']['dominant']})")
        ok = mem <= mem0
        if arch in DRY_DECODE_SPLIT and shape == "decode_32k":
            ok &= (DRY_COLL_FALL * coll <= coll0 and DRY_FALL * ops <= ops0
                   and (flops <= DRY_FLOPS_WHOLE[arch]
                        if arch in DRY_FLOPS_WHOLE
                        else DRY_FALL * flops <= flops0))
        elif arch in DRY_LONG_SPLIT:
            ok &= DRY_COLL_FALL * coll <= coll0
        else:
            ok &= DRY_WHOLE_FALL * coll <= coll0
        if not ok:
            bad.append(f"{arch} x {shape}: {before} -> {now}")
    if bad:
        raise AssertionError(f"{tag} " + "; ".join(bad))


def dryrun_prefill(tag: str, recs) -> None:
    """The sweep's prefill_32k cells of ``DRY_PREFILL_SPLIT`` against
    ``DRY_GATHERED`` and ``DRY_PREFILL_SPLIT``: the falls of memory, dense
    FLOPs and the kernels' work, the collectives' bound, ``step_time_s``;
    one ``[dryrun prefill]`` line a cell."""
    tag = tag[:-1] + " prefill]"
    bad = []
    got = {(r["arch"], r["shape"]): r for r in recs}

    def work(r, name):
        return sum(r["kernels"].get(name, {}).get("ops", {}).values())
    for arch, (mxu0, sps0, step0) in DRY_PREFILL_SPLIT.items():
        r = got.get((arch, "prefill_32k"))
        if r is None or r["status"] != "OK":
            bad.append(f"{arch}: no OK record")
            continue
        mem0, flops0, coll0, _ = DRY_GATHERED[(arch, "prefill_32k")]
        mem = r["argument_size_in_bytes"] + r["temp_size_in_bytes"]
        coll = int(sum(r["collectives"].values()))
        mxu, sps = work(r, "rbmm_mxu"), work(r, "sps_attention")
        step = r["roofline"]["step_time_s"]
        log(f"{tag} {arch} x prefill_32k: arguments + temp {mem0:.4g} -> "
            f"{mem:.4g} B a rank ({mem0 / mem:.2f}x), dense FLOPs "
            f"{flops0:.4g} -> {r['flops']:.4g} ({flops0 / r['flops']:.2f}x), "
            f"rbmm_mxu ops {mxu0:.4g} -> {mxu:.4g} ({mxu0 / mxu:.2f}x), "
            f"sps_attention ops {sps0:.4g} -> {sps:.4g} ({sps0 / sps:.2f}x), "
            f"collectives {coll0:.4g} -> {coll:.4g} B ({coll / coll0:.3f}x: "
            + ", ".join(f"{k} {v:.4g}" for k, v in
                        r["collective_sites"].items()) +
            f"), step_time_s {step0:.6g} -> {step:.6g} "
            f"({r['roofline']['dominant']})")
        if not (DRY_PREFILL_MEM_FALL * mem <= mem0 and
                DRY_FALL * r["flops"] <= flops0 and DRY_FALL * mxu <= mxu0
                and DRY_FALL * sps <= sps0 and step < step0 and
                (coll <= DRY_PREFILL_COLL_HELD[arch]
                 if arch in DRY_PREFILL_COLL_HELD
                 else coll <= DRY_PREFILL_COLL * coll0)):
            bad.append(f"{arch}: memory {mem0} -> {mem}, FLOPs {flops0} -> "
                       f"{r['flops']}, rbmm_mxu {mxu0} -> {mxu}, "
                       f"sps_attention {sps0} -> {sps}, collectives "
                       f"{coll0} -> {coll}, step {step0} -> {step}")
    if bad:
        raise AssertionError(f"{tag} " + "; ".join(bad))


def dryrun_moe(tag: str, recs) -> None:
    """The sweep's cells of ``DRY_MOE`` against ``DRY_GATHERED``: the falls
    of memory, dense FLOPs and ``rbmm_mxu``'s work, the prefill cells'
    fit, the collectives' bound, ``step_time_s``; one ``[dryrun moe]``
    line a cell."""
    tag = tag[:-1] + " moe]"
    gib, bad = 2**30, []
    got = {(r["arch"], r["shape"]): r for r in recs}
    for (arch, shape), (mem_fall, coll_share, flops_fall, mxu0,
                        step0) in DRY_MOE.items():
        r = got.get((arch, shape))
        if r is None or r["status"] != "OK":
            bad.append(f"{arch} x {shape}: no OK record")
            continue
        mem0, flops0, coll0, _ = DRY_GATHERED[(arch, shape)]
        mem = r["argument_size_in_bytes"] + r["temp_size_in_bytes"]
        coll = int(sum(r["collectives"].values()))
        mxu = sum(r["kernels"].get("rbmm_mxu", {}).get("ops", {}).values())
        step = r["roofline"]["step_time_s"]
        log(f"{tag} {arch} x {shape}: arguments + temp {mem0 / gib:.2f} -> "
            f"{mem / gib:.2f} GiB a rank ({mem0 / mem:.2f}x"
            f"{', fits' if mem < DRY_FITS else ', over 74.5 GiB'}), dense "
            f"FLOPs {flops0:.4g} -> {r['flops']:.4g} ("
            f"{flops0 / r['flops']:.2f}x), rbmm_mxu ops "
            + (f"{mxu0:.4g} -> {mxu:.4g} ({mxu0 / mxu:.2f}x)" if mxu0 else
               f"{mxu:.4g}") +
            f", collectives {coll0:.4g} -> {coll:.4g} B ({coll / coll0:.3f}x:"
            f" " + ", ".join(f"{k} {v:.4g}" for k, v in
                             r["collective_sites"].items()) +
            f"), step_time_s {step0:.6g} -> {step:.6g} "
            f"({r['roofline']['dominant']})")
        ok = (mem_fall * mem <= mem0 and coll <= coll_share * coll0 and
              step < step0)
        if flops_fall:
            ok &= flops_fall * r["flops"] <= flops0
        if mxu0:
            ok &= mem < DRY_FITS and DRY_FALL * mxu <= mxu0
        if not ok:
            bad.append(f"{arch} x {shape}: memory {mem0} -> {mem}, FLOPs "
                       f"{flops0} -> {r['flops']}, rbmm_mxu {mxu0} -> {mxu},"
                       f" collectives {coll0} -> {coll}, step {step0} -> "
                       f"{step}")
    if bad:
        raise AssertionError(f"{tag} " + "; ".join(bad))


def dryrun_moe_kernels(tag: str) -> int:
    """``rbmm_mxu`` on expert groups' buffers (``MOE_MXU_SHAPES``: ±1
    bf16 rows of a group's experts against their packed weights, one
    batched call) on the card against its plain version, bitwise; returns
    the launches."""
    from repro_torch.kernels.rbmm_mxu import ops, ref
    tag = tag[:-1] + " moe kernels]"
    rng = np.random.default_rng(SEED)
    before = ops.rbmm_mxu.launches
    for e, rows, k, p in MOE_MXU_SHAPES:
        a = _pm1(rng, (e, rows, k))
        w = _words(rng, (e, p, (k + 31) // 32), k)
        _same("rbmm_mxu", f"expert group ({e}, {rows}, {k}) x ({e}, {p}, "
              f"{k})", ops.rbmm_mxu(a, w), ref.rbmm_mxu(a, w))
    calls = ops.rbmm_mxu.launches - before
    log(f"{tag} rbmm_mxu on expert groups' buffers " + ", ".join(
        f"({e} experts, {rows} rows, K={k}, P={p})"
        for e, rows, k, p in MOE_MXU_SHAPES) +
        f": {calls} launches, each bitwise equal to its plain version")
    return calls


class _SimulatedRank:
    """Rank r of a simulated (1, m) ("data", "model") mesh on one card:
    its all-gather gives ``every`` (each rank's tensor, in rank order),
    what the ranks of a real mesh would send."""

    def __init__(self, m: int, r: int, every):
        self.shape = {"data": 1, "model": m}
        self.axis_names = ("data", "model")
        self.data_size, self.data_index, self._r = 1, 0, r
        self.every = every

    def index(self, axis: str) -> int:
        return self._r if axis == "model" else 0

    def all_gather(self, x, axes, dim):
        import torch
        return torch.cat(list(self.every), dim)


def dryrun_moe_ranks(tag: str) -> None:
    """One block's MoE of mixtral-8x22b (capacity factor ``MOE_DROP_CF``)
    and arctic-480b at full width on each rank's positions of a simulated
    (1, ``MOE_RANKS``) mesh (``_SimulatedRank``: each rank's claims
    gathered as a real mesh gathers them), on the card, against the
    one-device MoE's rows of those positions, bitwise; then the float32
    head's product on mixtral's vocabulary blocks against the whole
    table's columns (logged: cuBLAS may take another kernel for a block's
    width, which the mesh prefill's vocabulary blocks inherit)."""
    import dataclasses as dc
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import sharding
    from repro_torch.models.lm import build_model
    tag = tag[:-1] + " moe ranks]"
    m, (b, seq) = MOE_RANKS, MOE_MESH_PREFILL[1:]
    blk_n = seq // m
    for arch, cf in (("mixtral-8x22b", MOE_DROP_CF), ("arctic-480b", 0)):
        cfg = get_config(arch).truncated(1)
        if cf:
            cfg = cfg.with_(moe=dc.replace(cfg.moe, capacity_factor=cf))
        moe = build_model(cfg)._block()._ffn()
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        params = moe.init_deploy(gen, "cuda")
        x = torch.randn(b, seq, cfg.d_model, generator=gen,
                        device="cuda").bfloat16()
        with torch.inference_mode():
            want = moe.apply_deploy(params, x)
            _, idx = torch.sort(moe._probs(params, x.reshape(
                -1, cfg.d_model)), dim=-1, descending=True, stable=True)
            idx = idx[:, :moe.top_k].reshape(b, seq, moe.top_k)
            mine = [idx[:, r * blk_n:(r + 1) * blk_n] for r in range(m)]
            counts = [torch.nn.functional.one_hot(t, moe.num_experts).sum(
                (1, 2)).to(torch.int32) for t in mine]
            ids = [t.reshape(1, -1).to(torch.int32) for t in mine]
            sent = ids if ids[0].numel() < counts[0].numel() else counts
            same = []
            for r in range(m):
                split = sharding.Split(r, m, _SimulatedRank(m, r, sent),
                                       True)
                got = moe.apply_deploy(params, x[:, r * blk_n:(r + 1) *
                                                  blk_n].contiguous(), split)
                same.append(torch.equal(got, want[:, r * blk_n:(r + 1) *
                                                  blk_n]))
        log(f"{tag} {arch}, one block at full width{moe_text(cfg)}; B={b} x"
            f" {seq} on {m} simulated ranks of {blk_n} positions: each "
            f"rank's MoE rows bitwise equal to one device's {same}")
        if not all(same):
            raise AssertionError(f"{tag} {arch}: a rank's MoE rows differ "
                                 f"from one device's")
        del params, x, want
    d, v = 6144, 32768
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    x = torch.randn(b, seq, d, generator=gen, device="cuda").bfloat16().float()
    w = torch.randn(d, v, generator=gen, device="cuda") / d ** 0.5
    full = torch.matmul(x, w)
    blk = v // m
    same = [torch.equal(full[..., r * blk:(r + 1) * blk], torch.matmul(
        x, w[:, r * blk:(r + 1) * blk].contiguous())) for r in range(m)]
    log(f"{tag} the float32 head's product (B={b} x {seq}, d={d}) on "
        f"{m} vocabulary blocks of {blk} columns bitwise equal to the whole "
        f"table's columns: {same} (not asserted: what the mesh prefill's "
        f"vocabulary blocks inherit)")


def dryrun_moe_mesh(tag: str, mesh) -> dict:
    """mixtral-8x22b at full width on the one-rank NCCL (1, 1) mesh
    against one device: the mesh trainer's gradient of one block
    (``MOE_MESH_TRAIN``: the MoE's routing of the rank's positions, its
    expert stack's leaves gathered as sign bits) and the mesh
    ``prefill_logits`` of two blocks (``MOE_MESH_PREFILL``: the split
    route, the MoE on the rank's positions, its experts in groups), each
    bitwise equal to the one-device one.  Returns the counted launches
    of the mesh runs."""
    import gc
    import torch
    from repro_torch import kernels, tree
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import SyntheticStream
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models.lm import build_model
    from repro_torch.train.trainer import Trainer, TrainerConfig
    tag = tag[:-1] + " moe mesh]"
    layers, b, seq = MOE_MESH_TRAIN
    cfg = get_config("mixtral-8x22b").truncated(layers)
    cfg = cfg.with_(moe=dataclasses.replace(cfg.moe,
                                            capacity_factor=MOE_DROP_CF))
    model = build_model(cfg)
    stream = SyntheticStream(cfg, seq, b, seed=SEED)
    opt = _optimizer(cfg, 1)
    one = Trainer(model, opt, TrainerConfig(seed=SEED), graph=False)
    meshed = Trainer(model, opt, TrainerConfig(seed=SEED), mesh=mesh)
    params = model.init(torch.Generator(device="cuda").manual_seed(SEED))
    for path, t in tree.leaves_with_paths(params):
        meshed.placement(path, t.shape)
    batch = one.batch_on_device(stream.batch_at(0))
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with DropCounter() as drops:
            drops.label = "one device"
            loss1, m1, g1 = one.loss_and_grads(params, batch)
            drops.label = "the mesh"
            kernels.reset_launch_counts()
            loss2, m2, g2 = meshed.loss_and_grads(params, batch)
            torch.cuda.synchronize()
            launches = kernels.launch_counts()
    finally:
        torch.use_deterministic_algorithms(False)
    train_equal = (torch.equal(loss1, loss2) and
                   torch.equal(m1["moe_aux"], m2["moe_aux"]) and
                   all(torch.equal(a, c) for a, c in zip(tree.leaves(g1),
                                                         tree.leaves(g2))))
    log(f"{tag} mixtral-8x22b at full width, {layers} block"
        f"{moe_text(cfg)}; B={b} x {seq}: the mesh trainer's loss "
        f"{float(loss2):.6f}, load-balance loss {float(m2['moe_aux']):.6f} "
        f"and every gradient bitwise equal to one device's {train_equal}")
    drops.log(tag)
    if not train_equal:
        raise AssertionError(f"{tag} the mesh train step differs from one "
                             f"device's")
    del params, g1, g2, one, meshed
    gc.collect()
    torch.cuda.empty_cache()
    layers, b, seq = MOE_MESH_PREFILL
    cfg = get_config("mixtral-8x22b").truncated(layers)
    cfg = cfg.with_(moe=dataclasses.replace(cfg.moe,
                                            capacity_factor=MOE_DROP_CF))
    model = build_model(cfg)
    dparams = model.init_deploy(torch.Generator(device="cuda").manual_seed(
        SEED))
    toks = torch.as_tensor(np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (b, seq)).astype(np.int32), device="cuda")
    placed = mesh_lib.shard_tree(mesh, model.deploy_specs(), dparams)
    with torch.inference_mode():
        want = model.prefill_logits(dparams, toks)
        kernels.reset_launch_counts()
        pl = mesh_lib.Placement(mesh, mesh_lib.P(mesh_lib.data_axes(mesh),
                                                 None), toks.shape)
        got = model.prefill_logits(placed, mesh_lib.place(toks.clone(), pl),
                                   mesh=mesh)
        torch.cuda.synchronize()
        for k, v in kernels.launch_counts().items():
            launches[k] = launches.get(k, 0) + v
        got = mesh_lib.placement_of(got).whole(got)[..., :want.shape[-1]]
        prefill_equal = torch.equal(got, want)
        finite = bool(torch.isfinite(want).all())
    log(f"{tag} mixtral-8x22b at full width, {layers} blocks"
        f"{moe_text(cfg)}; prefill B={b} x {seq}: the mesh prefill_logits "
        f"(split route) bitwise equal to "
        f"the one-device one {prefill_equal}, finite {finite}")
    if not (prefill_equal and finite):
        raise AssertionError(f"{tag} the mesh prefill differs from one "
                             f"device's")
    del dparams, placed, want, got
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def dryrun_split_kernels(tag: str) -> None:
    """``sps_attention`` on the operands a split prefill hands it, on the
    card against its plain version on the same inputs, bitwise: each
    rank's query heads of smollm's 9 over 3 KV heads at widths 2, 4 and
    16 of "model" (spans cut by KV group, one starting inside a group,
    empty ranks), with the (H, 512) row table sliced to them, causal and
    a window, B = 2 x 512 positions (``SPSAttention._attend_span``)."""
    import torch
    from repro_torch.kernels.sps_attn import ops as sps_ops
    from repro_torch.models import sharding
    from repro_torch.models.attention import SPSAttention
    tag = tag[:-1] + " prefill kernels]"
    gen = torch.Generator().manual_seed(SEED)
    b, length, dh, h, hkv = 2, 512, 64, 9, 3
    attn = SPSAttention(d_model=576, num_heads=h, num_kv_heads=hkv,
                        head_dim=dh, sps_granularity="row")

    def words(*shape):
        return torch.randint(-2**31, 2**31 - 1, shape, generator=gen,
                             dtype=torch.int32)
    q, k = words(b, h, length, 2), words(b, hkv, length, 2)
    vt = words(b, hkv, dh, length // 32)
    theta = torch.randint(-8, 9, (h, 512), generator=gen, dtype=torch.int32)
    calls = spans = 0
    for m in (2, 4, 16):
        qs, kvs = attn.head_ranges(sharding.Split(0, m))
        for (h0, h1), (k0, k1) in zip(qs, kvs):
            if h1 == h0:
                continue
            args = (q[:, h0:h1], k[:, k0:k1], vt[:, k0:k1], theta[h0:h1])
            for window in (0, 100):
                before = sps_ops.sps_attention_gqa.launches
                got = attn._attend_span(
                    *(t.cuda().contiguous() for t in args), (h0, h1), k0,
                    causal=True, window=window).cpu()
                calls += sps_ops.sps_attention_gqa.launches - before
                want = attn._attend_span(*(t.contiguous() for t in args),
                                         (h0, h1), k0, causal=True,
                                         window=window)
                if not torch.equal(got, want):
                    raise AssertionError(f"{tag} heads [{h0}, {h1}) of "
                                         f"{m} ranks, window {window}: the "
                                         f"kernel differs from its plain "
                                         f"version")
                spans += 1
    log(f"{tag} sps_attention on {spans} rank spans (with windows 0 and "
        f"100) of 9 heads over 3 KV heads at widths 2, 4, 16 (row table "
        f"sliced; B=2 x L=512, d_h=64): {calls} launches, each bitwise "
        f"equal to its plain version")


def phase_dryrun(phase4_tokens) -> dict:
    """Phase 25 (see the module docstring); returns the counted runs'
    launch counts."""
    import torch.distributed as dist
    from repro_torch.launch import mesh as mesh_lib
    tag = "[dryrun]"
    t0 = time.perf_counter()
    log(f"{tag} {phase_device_line()}")
    # the sweep's CPU workers run beside this phase's card checks, whose
    # numbers are counts, bytes, bitwise equalities and device times
    sweep = dryrun_start()
    model, dparams, _ = load_model(DRY_ARCH, tag)
    prompts = np.random.default_rng(SEED).integers(
        0, model.cfg.vocab_size, (SERVE_B, SERVE_S)).astype(np.int32)
    counted = dryrun_census(tag, model, dparams, prompts)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = mesh_lib.make_host_mesh(1, "cuda")
        deploy = dryrun_mesh_deploy(tag, model, dparams, prompts, mesh,
                                    phase4_tokens)
        dryrun_split_kernels(tag)
        del model, dparams
        free_card()
        dryrun_train(tag, mesh)
        free_card()
        moe = dryrun_moe_mesh(tag, mesh)
        dryrun_moe_ranks(tag)
        dryrun_moe_kernels(tag)
    finally:
        dist.destroy_process_group()
    dryrun_sweep(tag, sweep)
    log(f"{tag} phase 25 took {time.perf_counter() - t0:.1f} s")
    return {k: counted[k] + deploy[k] + moe.get(k, 0) for k in counted}


_START = time.perf_counter()


def lap(name: str) -> None:
    """The script's seconds so far, after a phase (where its time goes,
    against the 1,200 s the script has)."""
    log(f"[time] {name} done at {time.perf_counter() - _START:.1f} s")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_device()
    phase_build()
    lap("build")
    rows, moe = phase_kernels()
    lap("kernels")
    model, dparams, _ = load_model("smollm-135m", "[serve]")
    served = {}
    static, _ = serve_static(model, dparams, "[serve]", stats=served)
    paged, plain = phase_continuous(model, dparams)
    spec = phase_speculative(model, dparams, plain)
    for name in rows:
        rows[name]["launches"] = static[name] + paged[name] + spec[name]
    phase_crosscheck(dparams)
    lap("serve, continuous, speculative, crosscheck")
    del model, dparams
    encode = phase_encode()
    lap("encode")
    granite = phase_dense_arch("granite-3-2b", "[granite]")
    lap("granite")
    qwen = phase_dense_arch("qwen1.5-32b", "[qwen]", QWEN_LAYERS)
    lap("qwen")
    phase_crosscheck_qwen()
    lap("qwen card==cpu")
    gemma = phase_gemma()
    lap("gemma")
    phase_crosscheck_narrow("[gemma card==cpu]", "gemma3-27b", NARROW_GEMMA,
                            150, (64, (40, 100), (150, 190), 7, 8, 32))
    phase_crosscheck_narrow("[row card==cpu]", "smollm-135m", NARROW_ROW,
                            520, (64, (451, 460), (520, 530), 17, 20, 128),
                            row=True)
    lap("narrow crosschecks")
    mixtral = phase_mixtral(moe)
    lap("mixtral")
    arctic = phase_arctic(moe)
    lap("arctic")
    phase_crosscheck_moe()
    lap("moe card==cpu")
    hymba = phase_hymba()
    lap("hymba")
    xlstm = phase_xlstm()
    lap("xlstm")
    phase_crosscheck_recurrent()
    lap("recurrent card==cpu")
    seamless = phase_frontend("seamless-m4t-large-v2", "[seamless]",
                              ENCDEC_PATH)
    lap("seamless")
    internvl2 = phase_frontend("internvl2-76b", "[internvl2]", STATIC_PATH,
                               full_depth=True)
    lap("internvl2")
    phase_crosscheck_frontend()
    lap("frontend card==cpu")
    train = phase_train()
    lap("train")
    families = phase_train_families()
    lap("train families")
    meshed = phase_train_mesh()
    lap("train mesh")
    dry = phase_dryrun(served["tokens"])
    lap("dryrun")
    for name in rows:
        rows[name]["launches"] += (encode[name] + granite[name] +
                                   qwen[name] + gemma[name] + mixtral[name] +
                                   arctic[name] + hymba[name] + xlstm[name] +
                                   seamless[name] + internvl2[name] +
                                   train[name] + families.get(name, 0) +
                                   meshed[name] + dry.get(name, 0))
    log(json.dumps({"kernels": list(rows.values())}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
