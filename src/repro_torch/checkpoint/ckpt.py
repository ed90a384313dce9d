"""Integrity-hashed, asynchronous checkpoints (port of
``repro.checkpoint.ckpt``).

Layout (one directory per step):
    <dir>/step_000123/
        manifest.json     leaf paths, shapes, dtypes, per-leaf sha256
        leaf_00000.npy ...
        _COMMITTED        written last: a directory without it is ignored

  * Leaves are plain numpy arrays keyed by their tree path
    (``repro_torch.tree``: "params/blocks/0/attn/wq/w_latent",
    "opt/step", ...; the port's own paths, its trees being lists of
    layers where the JAX package's are stacked).  bfloat16 leaves are
    stored as their uint16 bits with dtype "bfloat16".
  * sha256 per leaf: a corrupt or truncated file fails loudly at restore.
  * async: ``save`` copies every leaf to the host before it returns; the
    files and the commit are written on a background thread (``wait``
    joins it).
  * GC: ``keep_last_n`` prunes old committed steps, never the newest.
  * On a mesh (``layout=``, a trainer's ``StateLayout``) the format is
    the same, so it does not depend on the mesh: ``save`` gathers each
    leaf whole, rank 0 writes it, and rank 0 writes ``_COMMITTED`` after a
    barrier, with every rank waiting for the commit (no thread);
    ``restore`` reads whole leaves on every rank and keeps this rank's
    blocks, whatever mesh saved them.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import shutil
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import tree

Params = Any

_COMMIT = "_COMMITTED"


def _sha(arr: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(arr)).hexdigest()


def _to_host(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    """A host copy of ``t`` as numpy, and its dtype's name."""
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    return t.numpy(), str(t.dtype).replace("torch.", "")


def _from_host(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


@dataclasses.dataclass
class Checkpointer:
    directory: str
    keep_last_n: int = 3

    def __post_init__(self):
        os.makedirs(self.directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None

    # -- save ------------------------------------------------------------------

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:08d}")

    def save(self, step: int, state: Params, *, blocking: bool = False,
             extra: Optional[Dict[str, Any]] = None, layout=None) -> None:
        """Device -> host now; the disk commit runs on a thread unless
        ``blocking`` or on a mesh (``layout``: every rank calls ``save``)."""
        self.wait()
        writer = layout is None or layout.mesh.rank == 0
        host = []
        for name, leaf in tree.leaves_with_paths(state):
            place = layout and layout.placement(name)
            if place is not None:
                leaf = place.whole(leaf)
            if writer:
                host.append((name,) + _to_host(leaf))
        d = self._step_dir(step)
        tmp = d + ".tmp"

        def write():
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
            manifest = {"step": step, "extra": extra or {}, "leaves": []}
            for i, (name, arr, dtype) in enumerate(host):
                fn = f"leaf_{i:05d}.npy"
                np.save(os.path.join(tmp, fn), arr)
                manifest["leaves"].append({
                    "name": name, "file": fn, "shape": list(arr.shape),
                    "dtype": dtype, "sha256": _sha(arr)})
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)

        def commit():
            with open(os.path.join(tmp, _COMMIT), "w") as f:
                f.write("ok")
            if os.path.exists(d):
                shutil.rmtree(d)
            os.rename(tmp, d)
            self._gc()

        if layout is not None:
            if writer:
                write()
            layout.mesh.barrier()
            if writer:
                commit()
            layout.mesh.barrier()
        elif blocking:
            write()
            commit()
        else:
            self._thread = threading.Thread(
                target=lambda: (write(), commit()), daemon=True)
            self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self) -> None:
        for s in self.all_steps()[:-self.keep_last_n]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    # -- restore ----------------------------------------------------------------

    def all_steps(self) -> List[int]:
        out = []
        for name in sorted(os.listdir(self.directory)):
            d = os.path.join(self.directory, name)
            if name.startswith("step_") and not name.endswith(".tmp") and \
                    os.path.exists(os.path.join(d, _COMMIT)):
                out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def manifest(self, step: int) -> Dict[str, Any]:
        with open(os.path.join(self._step_dir(step), "manifest.json")) as f:
            return json.load(f)

    def restore(self, step: int, like: Params, *,
                check_integrity: bool = True,
                layout=None) -> Tuple[Params, Dict]:
        """Restore into the structure of ``like``: each leaf on the device
        and in the dtype of ``like``'s leaf at the same path; on a mesh
        (``layout``) this rank's block of it."""
        d = self._step_dir(step)
        manifest = self.manifest(step)
        by_name = {leaf["name"]: leaf for leaf in manifest["leaves"]}
        leaves = []
        for name, leaf in tree.leaves_with_paths(like):
            meta = by_name.get(name)
            if meta is None:
                raise KeyError(f"checkpoint missing leaf {name}")
            arr = np.load(os.path.join(d, meta["file"]))
            if check_integrity and _sha(arr) != meta["sha256"]:
                raise IOError(f"integrity check failed for {name}")
            whole = _from_host(arr, meta["dtype"])
            place = layout and layout.placement(name)
            shape = leaf.shape if place is None else place.shape
            if list(arr.shape) != list(shape):
                raise ValueError(f"shape mismatch for {name}: "
                                 f"{arr.shape} vs {tuple(shape)}")
            if place is not None:
                whole = place.shard(whole)
            leaves.append(whole.to(device=leaf.device, dtype=leaf.dtype))
        return tree.unflatten(like, leaves), manifest.get("extra", {})

    def verify(self, step: int, state: Params, layout=None) -> int:
        """Check that every leaf of ``state`` (on any device; on a mesh,
        ``layout``'s blocks gathered whole) hashes to its entry in step's
        manifest: the state holds the saved bits.  Returns the number of
        leaves checked; raises on a mismatch."""
        by_name = {leaf["name"]: leaf["sha256"]
                   for leaf in self.manifest(step)["leaves"]}
        pairs = tree.leaves_with_paths(state)
        for name, leaf in pairs:
            place = layout and layout.placement(name)
            if place is not None:
                leaf = place.whole(leaf)
            if _sha(_to_host(leaf)[0]) != by_name.get(name):
                raise IOError(f"{name} differs from step {step}'s "
                              f"checkpoint")
        return len(pairs)
