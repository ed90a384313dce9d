#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure is an uncaught exception and a non-zero exit:

  1. device     the card's name and power limit (nvidia-smi)
  2. build      nvcc builds every kernel of ``src/repro_torch/csrc``
  3. kernels    each kernel against its plain PyTorch version on the card,
                at the main-path shapes and at ragged shapes; integer and
                float32 outputs must be bitwise equal; CUDA-event timings of
                kernel, plain version and (where one exists) the one
                PyTorch call computing the same function
  4. serve      full-width smollm-135m (random weights from a seed) serves
                8 prompts of 128 tokens, 32 greedy tokens each, through
                ``ServeEngine.generate``; every kernel's launch count must
                move during that run
  5. crosscheck the same model in float32 at B=2, S=32, 4 tokens on the
                card and on the CPU (plain versions): equal greedy tokens,
                logits within a stated tolerance

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.  Without a CUDA card the
script exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM peaks (NVIDIA data sheet; dense, 700 W)
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
SCALAR32_OPS = 67e12   # 32-bit operations outside the tensor cores

SEED = 0


def log(msg: str) -> None:
    print(msg, flush=True)


# -- timing and bounds --------------------------------------------------------


def eager_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Milliseconds per call from CUDA events around a loop of calls: the
    wrapper's host work included, which is what a caller waits."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_profile(fn, iters: int):
    """Run fn ``iters`` times under torch.profiler (after one warm call);
    returns (device ms per call summed over every CUDA kernel, kernel
    launches per call, {kernel name: device ms per call})."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    by_name = {e.key: e.self_device_time_total / iters / 1e3
               for e in kernels}
    return (sum(by_name.values()), sum(e.count for e in kernels) / iters,
            by_name)


def device_ms(fn, iters: int = 20) -> float:
    """Device milliseconds per call: the sum of its CUDA kernels' times,
    host overhead excluded."""
    return device_profile(fn, iters)[0]


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(moved_bytes: float, ops: float, op_rate: float):
    t_bytes = moved_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / op_rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# -- phase 1 and 2 ------------------------------------------------------------


def phase_device() -> str:
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        check=True).stdout.strip()
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
    """Random packed words for k true values per row (zero pad bits)."""
    import torch
    w = rng.integers(0, 2**32, shape, dtype=np.uint64).astype(np.uint32)
    pad = w.shape[-1] * 32 - k
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
    a, b = _words(rng, (13, 4), 100), _words(rng, (70, 4), 100)
    dc = torch.randint(0, 100, (13,), device="cuda", dtype=torch.int32)
    ab, bb = _words(rng, (2, 3, 5, 2), 48), _words(rng, (2, 3, 67, 2), 48)
    cases = {
        "ragged K=100 xnor": (a, b, 100, "xnor", None),
        "ragged K=100 and_dc, dc derived": (a, b, 100, "and_dc", None),
        "ragged K=100 and_dc, dc given": (a, b, 100, "and_dc", dc),
        "batched d_h=48 xnor": (ab, bb, 48, "xnor", None),
        "batched d_h=48 and_dc": (ab, bb, 48, "and_dc", None),
    }
    for case, (x, y, k, scheme, d) in cases.items():
        _same("rbmm_int", case, ops.rbmm_int(x, y, k, scheme=scheme, dc=d),
              ref.rbmm_int(x, y, k, scheme=scheme, dc=d))
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
    }
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

    for case, (b, h, hkv, length, dh) in {
            "ragged L=77 d_h=48 GQA 3:1": (2, 3, 1, 77, 48),
            "L=40 d_h=64 MHA": (1, 2, 2, 40, 64)}.items():
        q, k, vt, th = gqa(b, h, hkv, length, dh)
        for causal in (True, False):
            _same("sps_attention", f"{case} causal={causal}",
                  ops.sps_attention_gqa(q, k, vt, th, d_h=dh, causal=causal),
                  ref.sps_attention_gqa(q, k, vt, th, d_h=dh, causal=causal))
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
    pairs = 8 * 9 * 128 * 129 // 2
    ops_count = 3 * pairs * 2 + 3 * (pairs // 32) * 64
    b, by = bound(nbytes(q, k, vt, th, out), ops_count, SCALAR32_OPS)
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
    "rbmm_mxu": (check_rbmm_mxu, "src/repro_torch/csrc/rbmm_mxu.cu",
                 "src/repro/kernels/rbmm_mxu/kernel.py:89"),
    "sps_attention": (check_sps_attention,
                      "src/repro_torch/csrc/sps_attn.cu",
                      "src/repro/kernels/sps_attn/kernel.py:159"),
}


def phase_kernels():
    """Each kernel against its plain version; its row of the kernels line
    (``ms``, ``plain_ms`` and ``library_ms`` are device times from the
    profiler, the ``*eager_ms`` keys CUDA-event times per call with the
    host work included)."""
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
    return rows


# -- phase 4: serve -----------------------------------------------------------

SERVE_B, SERVE_S, SERVE_NEW = 8, 128, 32


def phase_serve():
    """Full-width smollm-135m through ``ServeEngine.generate``; returns
    (launch counts of the run, the params on the card)."""
    import torch
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.models.lm import build_model
    from repro_torch.serve.engine import (CacheConfig, ServeConfig,
                                          ServeEngine)
    cfg = get_config("smollm-135m")
    model = build_model(cfg)
    t0 = time.perf_counter()
    with torch.inference_mode():
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        dparams = model.convert(model.init(gen))
    torch.cuda.synchronize()
    log(f"[serve] {cfg.name}: {cfg.num_layers} layers, d={cfg.d_model}, "
        f"{cfg.num_heads}/{cfg.num_kv_heads} heads, d_ff={cfg.d_ff}, vocab "
        f"{cfg.vocab_size}, {cfg.compute_dtype}; init+convert "
        f"{time.perf_counter() - t0:.1f} s")
    prompts = np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (SERVE_B, SERVE_S)).astype(np.int32)
    eng = ServeEngine(model, dparams, ServeConfig(
        cache=CacheConfig(max_len=SERVE_S + SERVE_NEW)))
    eng.generate(prompts, max_new_tokens=2)            # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    marks = []

    def on_token(step, tokens):
        # generate copied the tokens to the host: the card is idle here
        marks.append((time.perf_counter(), kernels.launch_counts()))

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    toks, report = eng.generate(prompts, max_new_tokens=SERVE_NEW,
                                stream_cb=on_token)
    total = time.perf_counter() - t0
    launches = kernels.launch_counts()
    if toks.shape != (SERVE_B, SERVE_NEW) or toks.min() < 0 or \
            toks.max() >= cfg.vocab_size:
        raise AssertionError(f"serve: bad tokens {toks.shape} "
                             f"[{toks.min()}, {toks.max()}]")
    idle = [n for n, c in launches.items() if c == 0]
    if idle:
        raise AssertionError(f"serve: kernels {idle} never launched on the "
                             f"main path: {launches}")
    (t_pre, c_pre), (t_end, c_end) = marks[0], marks[-1]
    steps = SERVE_NEW - 1
    per_step = {n: (c_end[n] - c_pre[n]) / steps for n in launches}
    log(f"[serve] launches per prefill {json.dumps(c_pre)}")
    log(f"[serve] launches per decode step {json.dumps(per_step)}")
    log(f"[serve] B={SERVE_B} prompts of {SERVE_S} tokens, {SERVE_NEW} "
        f"greedy tokens: prefill {1e3 * (t_pre - t0):.1f} ms, decode "
        f"{1e3 * (t_end - t_pre) / steps:.2f} ms/step, total {total:.3f} s,"
        f" {SERVE_B * SERVE_NEW / total:.1f} tok/s, decode "
        f"{SERVE_B * steps / (t_end - t_pre):.1f} tok/s; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB; KV cache "
        f"{report['total_bytes'] / 2**20:.2f} MiB "
        f"({report['compression_vs_bf16']:.1f}x below bf16)")
    log(f"[serve] sample tokens {toks[0, :8].tolist()}")
    profile_decode(model, dparams, prompts,
                   1e3 * (t_end - t_pre) / steps)
    return launches, dparams


def profile_decode(model, dparams, prompts, step_ms: float) -> None:
    """Where a decode step's time goes: device busy time per step (sum of
    kernel times under torch.profiler) against the step's wall time from
    the serve run; the rest is the card waiting for the host."""
    import torch
    with torch.inference_mode():
        logits, caches = model.prefill_with_cache(
            dparams, torch.as_tensor(prompts, device="cuda"),
            max_len=SERVE_S + SERVE_NEW)
        state = {"token": logits.argmax(-1), "caches": caches}

        def step():
            lg, state["caches"] = model.decode_step(
                dparams, state["token"], state["caches"])
            state["token"] = lg.argmax(-1)

        busy, launches, by_name = device_profile(step, iters=3)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    log(f"[serve] decode step profile: device busy {busy:.3f} ms of "
        f"{step_ms:.2f} ms wall (idle share {1 - busy / step_ms:.3f}), "
        f"{launches:.0f} CUDA kernels per step")
    for name, ms in top:
        log(f"[serve]   {ms:.4f} ms/step  {name[:90]}")


# -- phase 5: card vs CPU -----------------------------------------------------

CROSS_B, CROSS_S, CROSS_NEW = 2, 32, 4
CROSS_ATOL = 2e-3   # float32 logits; sums differ in order between devices


def _greedy_run(model, dparams, prompts, device):
    """prefill + greedy decode; returns (tokens (B, NEW), logits list)."""
    import torch
    toks = torch.as_tensor(prompts, device=device)
    logits, caches = model.prefill_with_cache(
        dparams, toks, max_len=CROSS_S + CROSS_NEW)
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


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_device()
    phase_build()
    rows = phase_kernels()
    launches, dparams = phase_serve()
    for name, n in launches.items():
        rows[name]["launches"] = n
    phase_crosscheck(dparams)
    log(json.dumps({"kernels": list(rows.values())}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
