"""Hand-written Hopper kernels of the port, their build and their dispatch.

Each kernel keeps the JAX package's three-part contract:
  csrc/<name>.cu       the CUDA C++ kernel for sm_90a, behind a plain C entry
  kernels/<name>/ops.py the public wrapper: checks, dispatch, launch count
  kernels/<name>/ref.py the plain PyTorch version of the same function

  pack/      threshold-binarize + bit-pack           (csrc/pack.cu)
  rbmm/      Eq. 7 integer RBMM, xnor and and_dc, and (csrc/rbmm.cu)
             its Eq. 10 threshold-fused variant
  rbmm_mxu/  binary values x packed ±1 weights, MMA  (csrc/rbmm_mxu.cu)
  sps_attn/  fused SPS attention, GQA-aware          (csrc/sps_attn.cu)
  paged_attn/ decode attention over the page arena    (csrc/paged_attn.cu)

Dispatch goes by the device of the operands, never by a switch: CUDA
tensors launch the kernel (or the wrapper raises), CPU tensors take the
plain version, and meta tensors (the dry run, ``launch/dryrun.py``) take a
shape-only route that returns empty outputs and counts the call's work
(``work.py``) in the census.  Nothing falls back from one to another.

Build: the first launch compiles every ``csrc/*.cu`` with ``nvcc`` for
``sm_90a`` (one compiler process per source, all started together), links
them into one shared library under ``build/`` at the repository root, keyed
by a hash of the sources (headers ``csrc/*.cuh`` included), and loads it
with ``ctypes``.  The library links the driver library ``libcuda``
(``-lcuda``) for ``cuTensorMapEncodeTiled``, which encodes the TMA tensor
maps of the tensor-core kernels on the host.  A failed build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Optional, Sequence

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
LIB_NAME = "libcobra_kernels.so"
LINK_FLAGS = ("-lcuda",)

# kernel name -> (ops module, name of the wrapper that launches and counts)
KERNELS = {
    "pack_threshold": ("pack", "pack_threshold"),
    "rbmm_int": ("rbmm", "rbmm_int"),
    "rbmm_binary": ("rbmm", "rbmm_binary"),
    "rbmm_mxu": ("rbmm_mxu", "rbmm_mxu"),
    "sps_attention": ("sps_attn", "sps_attention_gqa"),
    "paged_gather_decode": ("paged_attn", "paged_gather_decode"),
}

_lib: Optional[ctypes.CDLL] = None
_entries: Dict[str, ctypes._CFuncPtr] = {}


def use_kernel(*tensors: Optional[torch.Tensor]) -> str:
    """The dispatch rule, by the one device type of the operands: "cuda"
    (launch the kernel), "cpu" (the plain version) or "meta" (the
    shape-only route of the dry run: empty outputs of the kernel's shapes
    and dtypes, and one call's ``work`` added to the census in force; no
    launch is counted).  Mixed or other devices raise."""
    kinds = {t.device.type for t in tensors if t is not None}
    if len(kinds) == 1 and kinds <= {"cuda", "cpu", "meta"}:
        return kinds.pop()
    raise ValueError(f"operands lie on {sorted(kinds)}: a kernel takes "
                     f"CUDA tensors, its plain version CPU tensors and "
                     f"its shape-only route meta tensors")


def require_contiguous(name: str, *tensors: Optional[torch.Tensor]) -> None:
    for t in tensors:
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name}: the kernel takes contiguous "
                             f"operands, got strides {t.stride()} for "
                             f"shape {tuple(t.shape)}")


# -- build -------------------------------------------------------------------


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([str(Path(home) / "bin" / "nvcc")] if home else []) + [
            shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]:
        if cand and Path(cand).is_file():
            return cand
    raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, PATH and "
                       "/usr/local/cuda/bin): the CUDA kernels cannot be "
                       "built")


def sources() -> Sequence[Path]:
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256()
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(ARCH_FLAGS + LINK_FLAGS).encode())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile and link the kernel library if it is not built yet; return
    its path.  ptxas' register and shared-memory report lands in
    ``build.log`` beside it."""
    final = BUILD_ROOT / f"kernels-{source_hash()}"
    lib = final / LIB_NAME
    if lib.is_file():
        return lib
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tmp = Path(tempfile.mkdtemp(prefix="kernels-", dir=BUILD_ROOT))
    try:
        procs = []
        for src in sources():
            obj = tmp / (src.stem + ".o")
            cmd = [nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", "-Xptxas", "-v",
                   "-Xcompiler", "-fPIC", "-c", str(src), "-o", str(obj)]
            procs.append((src, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        log, failed = [], []
        for src, proc in procs:
            out, _ = proc.communicate()
            log.append(f"== {src.name}\n{out}")
            if proc.returncode:
                failed.append(src.name)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
        link = subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp / LIB_NAME),
             *[str(tmp / (s.stem + ".o")) for s in sources()], *LINK_FLAGS],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        log.append(f"== link\n{link.stdout}")
        (tmp / "build.log").write_text("\n".join(log))
        if link.returncode:
            raise RuntimeError("linking the kernel library failed:\n" +
                               link.stdout)
        try:
            tmp.rename(final)
        except OSError:
            # another process finished the same build first
            if not lib.is_file():
                raise
    finally:
        if tmp.exists():
            shutil.rmtree(tmp, ignore_errors=True)
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library (built at first use)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        lib.cobra_error_string.argtypes = [ctypes.c_int]
        lib.cobra_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


# -- launch -------------------------------------------------------------------

PTR = ctypes.c_void_p
I64 = ctypes.c_longlong
INT = ctypes.c_int


def ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def launch(entry: str, argtypes: Sequence, device: torch.device,
           *args) -> None:
    """Call a C entry on ``device``'s current stream; raise if the runtime
    refused the launch.  The stream is appended as the last argument."""
    fn = _entries.get(entry)
    if fn is None:
        fn = getattr(library(), entry)
        fn.argtypes = [*argtypes, PTR]
        fn.restype = ctypes.c_int
        _entries[entry] = fn
    # the raw stream handle and the current device without building Python
    # stream or device objects: each of those costs microseconds of host
    # time per launch, and the serving paths are host-bound
    idx = device.index if device.index is not None else \
        torch._C._cuda_getDevice()
    stream = torch._C._cuda_getCurrentRawStream(idx)
    if idx == torch._C._cuda_getDevice():
        status = fn(*args, stream)
    else:
        with torch.cuda.device(idx):
            status = fn(*args, stream)
    if status:
        msg = library().cobra_error_string(status).decode()
        raise RuntimeError(f"{entry}: CUDA launch failed with status "
                           f"{status} ({msg})")


# -- launch counters ----------------------------------------------------------


def _wrappers() -> Dict[str, object]:
    import importlib
    return {name: getattr(importlib.import_module(
                f"repro_torch.kernels.{mod}.ops"), fn)
            for name, (mod, fn) in KERNELS.items()}


def launch_counts() -> Dict[str, int]:
    """Kernel launches executed since the last reset, by kernel name: the
    wrappers' own launches, plus those that replays of captured CUDA
    graphs credit (``credit_launches``)."""
    return {name: w.launches for name, w in _wrappers().items()}


def reset_launch_counts() -> None:
    for w in _wrappers().values():
        w.launches = 0


def credit_launches(deltas: Dict[str, int]) -> None:
    """Add ``deltas`` ({kernel name: launches}) to the counters.  A graph
    replay runs no Python wrapper, so the capture records each wrapper's
    count delta and every replay credits it here (a capture itself
    executes nothing and takes its delta back)."""
    wrappers = _wrappers()
    for name, n in deltas.items():
        wrappers[name].launches += n
