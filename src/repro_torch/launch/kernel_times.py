"""Times of the port's RBMM kernels at the shapes the main paths give them,
on one CUDA card.

    PYTHONPATH=src python -m repro_torch.launch.kernel_times

For each shape it prints one JSON object: the device time of one call
(``ms``: every CUDA kernel the call launches, under torch.profiler), the
time per call with the wrapper's host work (``eager_ms``: CUDA events
around a loop of calls), the least time the card could take (``bound_ms``:
the larger of the bytes moved, each input read once and each output
written once, at 3.35 TB/s and the operations at the data-sheet rate of
the fastest unit that can do them) and the time of one PyTorch call that
computes the same product (``library_ms``: bf16 ``torch.matmul`` of the
unpacked operands).  It calls only the wrappers' public signatures, so run
by path under another checkout's ``src`` it times that checkout's kernels
in the same process layout, which is how two versions are compared inside
one call on one card.
"""
from __future__ import annotations

import json
from typing import Callable, Dict, List

import torch

# H100 SXM peaks (NVIDIA data sheet; dense, 700 W)
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
INT8_OPS = 1979e12
SCALAR32_OPS = 67e12     # 32-bit operations outside the tensor cores

M_ENC, D_ENC = 4096, 768   # bert-base-cobra, B = 8 x 512 tokens


def device_ms(fn: Callable, iters: int = 20) -> float:
    """Device milliseconds per call: the summed time of the CUDA kernels
    it launches (torch.profiler, after one warm call), host work
    excluded."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / iters / 1e3


def eager_ms(fn: Callable, iters: int = 50, warmup: int = 5) -> float:
    """Milliseconds per call from CUDA events around a loop of calls: the
    wrapper's host work included, which is what a caller waits."""
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


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(moved_bytes: float, ops: float, op_rate: float):
    """(ms, "bytes" or "operations"): the larger of the bytes at the memory
    rate and the operations at ``op_rate``."""
    t_bytes = moved_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / op_rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def shapes(seed: int = 0) -> Dict[str, Dict]:
    """Each shape: the kernel's call, the library call and the bound."""
    from repro_torch.core import packing
    from repro_torch.kernels.rbmm import ops as rbmm
    from repro_torch.kernels.rbmm_mxu import ops as mxu
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def words(rows, k):          # every shape here has k % 32 == 0
        return torch.randint(-2**31, 2**31, (rows, k // 32), generator=gen,
                             device="cuda", dtype=torch.int64).to(
                                 torch.int32)

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
            bound=bound(nbytes(a, w, res), 2 * m * k * p, BF16_FLOPS))
    m, k, p = M_ENC, D_ENC, D_ENC
    kp = packing.packed_len(k)
    a, w = words(m, k), words(p, k)
    av = packing.unpack_signs(a, k, torch.bfloat16)
    wv = packing.unpack_signs(w, k, torch.bfloat16)
    theta = torch.randint(-40, 40, (p,), generator=gen, device="cuda",
                          dtype=torch.int32)
    bits, dc_ret = rbmm.rbmm_binary(a, w, k, theta, pack_output=True)
    def word_or_mac(*tensors):
        """The faster of two ways to do the work: popcount words (3 ops a
        word pair) on the ALUs, or the MACs of the unpacked values on the
        int8 tensor cores."""
        moved = nbytes(*tensors)
        return min(bound(moved, 3 * m * p * kp, SCALAR32_OPS),
                   bound(moved, 2 * m * p * k, INT8_OPS))

    out["rbmm_binary F1 (4096x768)x(768x768) xnor, packed, theta (768,)"] = \
        dict(kernel=lambda: rbmm.rbmm_binary(a, w, k, theta,
                                             pack_output=True),
             library=lambda: torch.matmul(av, wv.T),
             bound=word_or_mac(a, w, theta, bits, dc_ret))
    dc = torch.randint(0, k, (m,), generator=gen, device="cuda",
                       dtype=torch.int32)
    res = rbmm.rbmm_int(a, w, k, scheme="and_dc", dc=dc)
    out["rbmm_int F2 (4096x768)x(768x768) and_dc, dc given"] = dict(
        kernel=lambda: rbmm.rbmm_int(a, w, k, scheme="and_dc", dc=dc),
        library=lambda: torch.matmul(av, wv.T),
        bound=word_or_mac(a, w, dc, res))
    return out


def time_all(seed: int = 0) -> List[Dict]:
    rows = []
    for name, s in shapes(seed).items():
        b_ms, by = s["bound"]
        rows.append({"shape": name, "ms": device_ms(s["kernel"]),
                     "eager_ms": eager_ms(s["kernel"]),
                     "bound_ms": b_ms, "bound_by": by,
                     "library_ms": device_ms(s["library"]),
                     "library_eager_ms": eager_ms(s["library"])})
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("kernel_times: needs a CUDA card")
    for row in time_all():
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
