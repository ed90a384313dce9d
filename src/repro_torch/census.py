"""The hooks through which the kernels, the meshes and the position loops
report to a dry run's census (``repro_torch.launch.cost``).

Outside a census each hook does nothing (``steps`` runs every step), so
the serving and training paths pay one list lookup a call.  The census in
force is an object with ``add_kernel(name, work)``,
``add_collective(kind, nbytes)`` and the loop fields ``steps`` keeps (``trip``,
``loop_len``, ``loops``, ``segment``, ``where``); ``launch.cost.Census``
is the one the port has.  This module depends on torch alone, so the
lowest layers import it and nothing of ``launch``.
"""
from __future__ import annotations

import contextlib
from typing import Any, Iterator, List, Optional, Sequence

# the census in force (innermost last)
_ACTIVE: List[Any] = []


def active() -> Optional[Any]:
    return _ACTIVE[-1] if _ACTIVE else None


@contextlib.contextmanager
def in_force(census) -> Iterator[Any]:
    """Put ``census`` in force for the hooks inside."""
    _ACTIVE.append(census)
    try:
        yield census
    finally:
        _ACTIVE.remove(census)


@contextlib.contextmanager
def suspended() -> Iterator[None]:
    """Count nothing inside (neither the hooks nor the aten ops): the
    set-up a traced step does not do, such as drawing the shapes of its
    params."""
    from torch.utils._python_dispatch import _disable_current_modes
    saved = list(_ACTIVE)
    _ACTIVE.clear()
    try:
        with _disable_current_modes():
            yield
    finally:
        _ACTIVE[:] = saved


def kernel(name: str, work) -> None:
    """One call of hand-written kernel ``name`` doing ``work`` (a
    ``kernels.work.Work``), counted in the census in force."""
    c = active()
    if c is not None:
        c.add_kernel(name, work)


def collective(kind: str, nbytes: int) -> None:
    """A collective of ``kind`` whose whole-sized side (a reduce-scatter's
    input, any other's result) holds ``nbytes`` on this rank, counted in
    the census in force."""
    c = active()
    if c is not None:
        c.add_collective(kind, int(nbytes))


def steps(n: int) -> Iterator[int]:
    """The steps a loop over ``n`` positions runs: all n, or fewer under a
    census that scales loops (``launch.cost.measure``), which then keys
    the ops of each step by (loop, step) for the peak."""
    c = active()
    if c is None or c.trip is None:
        yield from range(n)
        return
    k = n
    if n > c.trip:
        if c.loop_len not in (None, n):
            raise ValueError(f"loops of {c.loop_len} and {n} steps in one"
                             f" trace: the trip-count scaling takes one "
                             f"length")
        c.loop_len, k = n, c.trip
    c.loops += 1
    c.segment += 1
    outer = c.where
    for t in range(k):
        c.where = (c.loops, t)
        yield t
    c.where = outer
    c.segment += 1


def pad_steps(outs: Sequence[Any], n: int) -> List[Any]:
    """A loop's per-step outputs padded to ``n`` steps (a loop that
    ``steps`` cut short gives its full-length outputs): the last one
    again, detached, so no gradient flows into the padding."""
    outs = list(outs)
    if len(outs) < n:
        outs += [outs[-1].detach()] * (n - len(outs))
    return outs
