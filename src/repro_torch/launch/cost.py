"""The cost of a step traced on the meta device (the port's counterpart of
``repro.launch.hlo_cost``, which reads XLA's compiled HLO; the port has no
HLO, so it counts what its eager step dispatches).

``measure(fn, args)`` runs ``fn(*args)`` once, on meta tensors, under a
``Census``: a ``TorchDispatchMode`` that sees every aten op, and the
hooks the port's kernels and meshes call (``repro_torch.census``).  It
tallies, for the one rank that runs it:
  * dense FLOPs: 2 * |out| * K of every mm / addmm / bmm / baddbmm (the
    JAX package's dot rule; ``torch.utils.flop_counter`` counts the same);
  * bytes: the inputs and outputs of every aten op but views and
    allocations (``_NO_TRAFFIC``): eager PyTorch writes every op's result
    to memory and reads it back, which is the JAX package's model of
    traffic across fusion boundaries; plus each hand-written kernel's own
    bytes;
  * the kernels' census: launches and work of each hand-written kernel,
    from its wrapper's shape-only route (``repro_torch.kernels.work``);
  * collectives: bytes by kind (a reduce-scatter's input, any other's
    result), from the meshes (``launch/mesh.py``), and by kind and site:
    the model code that asked for each (``_site``: its innermost two
    frames under ``models/`` outside ``sharding.py``);
  * argument bytes: the storages of ``args`` (the rank's shards);
  * temp: the peak of the live bytes of storages allocated during the
    step (each freed when its storage dies), outputs included;
  * output bytes: the storages of the result that are not arguments';
  * ops: the aten ops dispatched (the JAX package's ``hlo_ops``).
Ops on host tensors alone (a learning rate, a scale) are not the
device's and are not counted.

Trip-count scaling (the counterpart of ``hlo_cost``'s
``known_trip_count``).  The recurrences of ``models/ssm.py`` loop over
positions in Python; unrolled on meta at 32,768 positions they would not
finish.  Each loop runs the steps ``census.steps(n)`` gives and pads its
outputs to n steps with ``census.pad_steps`` (the last step's output
again, detached), so every tensor after the loop has its full shape.
Every count of the trace is then affine in the steps k a loop runs
(each step does the same ops on the same shapes; the padding adds n - k
steps' worth of the stack's inputs and no gradient), and at k = n it is
the unrolled trace's (the padding's one ``detach`` aside, which moves no
byte).
``measure`` traces at k = 2 and k = 3 and extrapolates every count to
k = n exactly; the peak from the live bytes after each op (``_peak``),
exact where each step past the first adds the same live bytes (tested
against the unrolled trace on short sequences).
"""
from __future__ import annotations

import contextlib
import os
import sys
import weakref
from typing import (Any, Callable, Dict, Iterator, List, Optional,
                    Sequence, Tuple)

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import census as hooks
from repro_torch.kernels.work import UNITS

COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter",
                    "all-to-all", "collective-permute")

# ops that move no bytes: allocations without a write, and host reads
_NO_TRAFFIC = {"empty", "empty_strided", "empty_like", "new_empty",
               "new_empty_strided", "lift_fresh", "_local_scalar_dense"}


def _tensors(tree: Any, out: Optional[List[torch.Tensor]] = None
             ) -> List[torch.Tensor]:
    """The tensors of nested tuples, lists and dicts, in order (an op's
    arguments, a step's state; ``tree_flatten`` costs a trace of 10^5
    ops more than the ops themselves)."""
    out = [] if out is None else out
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (tuple, list)):
        for x in tree:
            _tensors(x, out)
    elif isinstance(tree, dict):
        for x in tree.values():
            _tensors(x, out)
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


_MODELS = os.path.join("repro_torch", "models") + os.sep


def _site() -> str:
    """Where the step asked for a collective: "caller > callee", the
    innermost frame of the port's model code (``models/`` but
    ``sharding.py``, whose helpers only carry it out) and the innermost
    one of another module calling it; "-" outside the models."""
    names, mods, f = [], [], sys._getframe(2)
    while f is not None and len(names) < 2:
        path = f.f_code.co_filename
        mod = os.path.basename(path)[:-3]
        if _MODELS in path and mod != "sharding" and mod not in mods:
            names.append(f"{mod}.{f.f_code.co_name}")
            mods.append(mod)
        f = f.f_back
    return " > ".join(reversed(names)) or "-"


def mm_flops(func, args, out) -> int:
    """2 * |out| * K of a dense product (0 for any other op)."""
    name = func.overloadpacket.__name__
    if name in ("mm", "bmm"):
        a = args[0]
    elif name in ("addmm", "baddbmm"):
        a = args[1]
    else:
        return 0
    return 2 * out.numel() * a.shape[-1]


class Census:
    """The tallies of one traced step (see the module docstring)."""

    def __init__(self):
        self.flops = 0
        self.bytes = 0
        self.ops = 0
        self.kernels: Dict[str, Dict[str, Any]] = {}
        self.collectives = {k: 0 for k in COLLECTIVE_KINDS}
        self.sites: Dict[str, int] = {}     # "kind site" -> bytes
        self.arguments = 0
        self.outputs = 0
        self.temp = 0
        self.live = 0
        # loops run short: the steps a loop may run (None: all), and the
        # trip count of the loops that ran short
        self.trip: Optional[int] = None
        self.loop_len: Optional[int] = None
        # with ``trip``: the live bytes after each op, keyed by where the
        # op ran: ("o", segment, i) the i-th op of the segment between two
        # loop bounds, (loop, step, i) the i-th op of a loop's step
        self.series: Dict[Tuple, int] = {}
        self.where: Optional[Tuple] = None
        self.loops = 0
        self.segment = 0
        self._count: Dict[Any, int] = {}

    def mark(self) -> None:
        """Record the live bytes after an op (``series``)."""
        at = ("o", self.segment) if self.where is None else self.where
        i = self._count.get(at, 0)
        self._count[at] = i + 1
        self.series[at + (i,)] = self.live

    # -- hooks ---------------------------------------------------------------

    def add_kernel(self, name: str, work) -> None:
        k = self.kernels.setdefault(
            name, {"launches": 0, "bytes": 0, "ops": {u: 0 for u in UNITS}})
        k["launches"] += 1
        k["bytes"] += work.bytes
        k["ops"][work.unit] += work.ops
        self.bytes += work.bytes

    def add_collective(self, kind: str, nbytes: int) -> None:
        self.collectives[kind] += nbytes
        key = f"{kind} {_site()}"
        self.sites[key] = self.sites.get(key, 0) + nbytes

    def launches(self) -> Dict[str, int]:
        return {name: k["launches"] for name, k in self.kernels.items()}

    def unit_ops(self) -> Dict[str, int]:
        """Operations of the hand-written kernels by unit."""
        return {u: sum(k["ops"][u] for k in self.kernels.values())
                for u in UNITS}

    # -- extrapolation -------------------------------------------------------

    def _numbers(self) -> Dict[str, Any]:
        return {"flops": self.flops, "bytes": self.bytes, "ops": self.ops,
                "temp": self.temp, "outputs": self.outputs,
                "collectives": dict(self.collectives),
                "sites": dict(self.sites),
                "kernels": {n: {"launches": k["launches"],
                                "bytes": k["bytes"], "ops": dict(k["ops"])}
                            for n, k in self.kernels.items()}}

    def extrapolated(self, more: "Census", n: int) -> "Census":
        """This census (loops at two steps) and ``more`` (at three)
        carried to loops of ``n`` steps: this + (n - 2) * (more - this);
        the peak from the live bytes after each op (``_peak``)."""
        def ext(a, b):
            if isinstance(a, dict) or isinstance(b, dict):
                a, b = a or {}, b or {}
                return {key: ext(a.get(key), b.get(key))
                        for key in {*a, *b}}
            a, b = a or 0, b or 0
            return a + (n - 2) * (b - a)

        num = ext(self._numbers(), more._numbers())
        out = Census()
        out.flops, out.bytes, out.ops = num["flops"], num["bytes"], num["ops"]
        out.temp, out.outputs = _peak(self, more, n), num["outputs"]
        out.collectives = {k: num["collectives"].get(k, 0)
                           for k in COLLECTIVE_KINDS}
        out.sites = dict(sorted(num["sites"].items()))
        out.kernels = {name: {"launches": k["launches"], "bytes": k["bytes"],
                              "ops": {u: k["ops"].get(u, 0) for u in UNITS}}
                       for name, k in sorted(num["kernels"].items())}
        out.arguments = self.arguments
        out.loop_len = n
        return out

    def record(self) -> Dict[str, Any]:
        """The dry-run record's keys (the JAX package's where the meaning
        is the same)."""
        return {"flops": float(self.flops),
                "bytes_accessed": float(self.bytes),
                "collectives": {k: float(v)
                                for k, v in self.collectives.items()},
                "collective_sites": {k: float(v) for k, v in
                                     sorted(self.sites.items())},
                "argument_size_in_bytes": int(self.arguments),
                "output_size_in_bytes": int(self.outputs),
                "temp_size_in_bytes": int(self.temp),
                "kernels": {n: dict(k, ops=dict(k["ops"]))
                            for n, k in sorted(self.kernels.items())},
                "unit_ops": self.unit_ops(),
                "ops": int(self.ops),
                "loop_len": self.loop_len}


def _peak(c2: Census, c3: Census, n: int) -> int:
    """The peak live bytes of loops of ``n`` steps from traces at two
    (``c2``) and three (``c3``) steps a loop.  An op of a loop's step j
    holds what it holds at step 1, plus the growth per step of the loop's
    trip (l3 - l2 over the two traces) and per step before it (c, from
    steps 1 and 2 of ``c3``): at j = n - 1, l2 + (n - 2) * (l3 - l2 +
    max(c, 0)); step 0 holds l2 + (n - 2) * (l3 - l2).  Ops between loop
    bounds (a segment) are taken op by op the same way where both traces
    run as many of them, else by the segment's largest value, l2 + (n -
    2) * (l3 - l2): such a segment runs the backward of a loop's steps,
    whose ops autograd runs outside the loop."""
    def segs(c):
        out: Dict[Tuple, List[int]] = {}
        for key, live in c.series.items():
            if key[0] == "o":
                out.setdefault(key[:2], []).append(live)
        return out

    s2, s3 = segs(c2), segs(c3)
    best = 0
    for seg, l3s in s3.items():
        l2s = s2.get(seg, [0])
        if len(l2s) == len(l3s):
            best = max([best] + [a + (n - 2) * (b - a)
                                 for a, b in zip(l2s, l3s)])
        else:
            best = max(best, max(l2s) + (n - 2) * (max(l3s) - max(l2s)))
    for key, l3 in c3.series.items():
        if key[0] == "o" or key[1] > 1:
            continue
        l2 = c2.series[key]
        grow = 0
        if key[1] == 1:
            grow = max(c3.series[(key[0], 2, key[2])] - l3, 0)
        best = max(best, l2 + (n - 2) * (l3 - l2 + grow))
    return best


@contextlib.contextmanager
def counting(census: Optional[Census] = None) -> Iterator[Census]:
    """Put ``census`` (a new one by default) in force for the kernels' and
    meshes' hooks (``repro_torch.census``), without tracing aten ops."""
    with hooks.in_force(census or Census()) as c:
        yield c


class _Trace(TorchDispatchMode):
    """The aten tallies of a census (see the module docstring)."""

    def __init__(self, census: Census):
        super().__init__()
        self.census = census
        self.seen: Dict[int, int] = {}      # storage -> bytes counted

    def known(self, tensors: Sequence[torch.Tensor]) -> int:
        """Mark the storages of ``tensors`` as there before the step (not
        temp); returns their bytes, each storage once."""
        total = 0
        for t in tensors:
            st = t.untyped_storage()
            if st._cdata not in self.seen:
                self.seen[st._cdata] = 0
                total += st.nbytes()
        return total

    def _alloc(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self.seen:
            return
        nb = st.nbytes()
        self.seen[key] = nb
        c = self.census
        c.live += nb
        c.temp = max(c.temp, c.live)
        weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self.census.live -= self.seen.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        # an op with no kernel of its own (``matmul`` under inference
        # mode, which skips the autograd key that decomposes it
        # otherwise) is counted by its parts, as it runs
        if not torch._C._dispatch_has_kernel_for_dispatch_key(
                func.name(), "Meta"):
            with self:
                parts = func.decompose(*args, **kwargs)
            if parts is not NotImplemented:
                return parts
        out = func(*args, **kwargs)
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        if all(t.device.type == "cpu" for t in ins + outs):
            return out          # host scalars (a learning rate, sqrt(d))
        c = self.census
        c.ops += 1
        name = func.overloadpacket.__name__
        if isinstance(out, torch.Tensor):
            c.flops += mm_flops(func, args, out)
        if func.is_view or name in _NO_TRAFFIC:
            if not func.is_view:
                for t in outs:
                    self._alloc(t)
            if c.trip is not None:
                c.mark()
            return out
        c.bytes += sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        for t in outs:
            self._alloc(t)
        if c.trip is not None:
            c.mark()
        return out


def _run(fn: Callable, args: Sequence[Any], trip: Optional[int]
         ) -> Tuple[Census, Any]:
    census = Census()
    census.trip = trip
    mode = _Trace(census)
    census.arguments = mode.known(_tensors(args))
    with hooks.in_force(census), mode:
        out = fn(*args)
    given = {t.untyped_storage()._cdata for t in _tensors(args)}
    seen = set()
    for t in _tensors(out):
        key = t.untyped_storage()._cdata
        if key not in given and key not in seen:
            seen.add(key)
            census.outputs += t.untyped_storage().nbytes()
    return census, out


def measure(fn: Callable, args: Sequence[Any]) -> Tuple[Census, Any]:
    """(census, result) of ``fn(*args)`` traced once, its position loops
    at full length; a trace whose loops ``steps`` cut is taken at two and
    three steps a loop and extrapolated (see the module docstring)."""
    two, out = _run(fn, args, trip=2)
    if two.loop_len is None:
        return two, out
    three, out = _run(fn, args, trip=3)
    if three.loop_len is None:
        return three, out
    return two.extrapolated(three, two.loop_len), out
