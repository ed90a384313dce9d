"""Roofline terms of the dry run's records (port of
``repro.launch.roofline``), with H100 constants.

Three terms, in seconds, per (arch x shape x mesh) and per rank (each
record counts one rank's step):

  compute    = the largest of dense FLOPs / bf16 peak, the kernels' int8
               tensor-core operations / int8 peak and their 32-bit word
               operations / the ALU rate
  memory     = bytes / HBM bandwidth
  collective = collective bytes (a reduce-scatter's input, any other's
               result) / the per-GPU network bandwidth

Constants, H100 SXM5 (NVIDIA H100 Tensor Core GPU data sheet, SXM5,
dense, 700 W; ``repro_torch.kernels.work``, which ``kernel_times`` uses
for every kernel's bound): bf16 989 TFLOP/s, int8 1,979 TOP/s, HBM3 3.35
TB/s, and 67 TOP/s of 32-bit operations outside the tensor cores (the
rate of ``PERF.md``'s kernel bounds).  Collectives: a DGX/HGX H100 node
holds 8 GPUs on NVLink 4 (450 GB/s per direction per GPU) and gives each
GPU one 400 Gb/s (50 GB/s) InfiniBand NDR NIC.  On the production mesh
both axes leave a node ("model" = 16 spans two nodes, "data" strides
across nodes), so every collective is charged at the network's 50 GB/s
(``NET_BW``); NVLink's rate would apply only to an axis of at most 8
ranks within a node, which these meshes do not have.

``parse_collectives`` (the JAX module's regex walk over HLO text) has no
counterpart: the port's collectives are counted where the mesh runs them
(``launch/cost.py``).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict

from repro_torch.kernels.work import (BF16_FLOPS, HBM_BYTES_PER_S, INT8_OPS,
                                      SCALAR32_OPS)

NET_BW = 50e9       # collective B/s per GPU: one 400 Gb/s NIC


@dataclasses.dataclass
class RooflineTerms:
    compute_s: float             # max(dense, int8, word) seconds
    memory_s: float
    collective_s: float
    flops: float                 # dense FLOPs
    int8_s: float                # the kernels' int8 tensor-core seconds
    word_s: float                # the kernels' 32-bit ALU seconds
    bytes_accessed: float
    collective_bytes: float
    model_flops: float
    useful_ratio: float          # MODEL_FLOPS / (ranks * FLOPs)

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """Lower bound assuming perfect overlap: max of the three terms."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["dominant"] = self.dominant
        d["step_time_s"] = self.step_time_s
        return d


def model_flops(cfg, shape, face: str) -> float:
    """Analytic MODEL_FLOPS: 6*N*D train, 2*N*D prefill, 2*N per decode
    token, with N = active params (MoE: top-k only)."""
    n_active = cfg.active_param_count()
    if face == "train":
        return 6.0 * n_active * shape.global_batch * shape.seq_len
    if face == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq_len
    return 2.0 * n_active * shape.global_batch


def terms_from_artifact(art: Dict[str, Any], cfg=None, shape=None,
                        face: str = "train", chips: int = 1
                        ) -> RooflineTerms:
    """The terms of one record (``launch.dryrun.run_cell``'s keys)."""
    flops = float(art.get("flops", 0.0))
    nbytes = float(art.get("bytes_accessed", 0.0))
    cbytes = float(sum(art.get("collectives", {}).values()))
    unit = art.get("unit_ops", {})
    int8_s = float(unit.get("int8", 0)) / INT8_OPS
    word_s = float(unit.get("word", 0)) / SCALAR32_OPS
    dense_s = (flops + float(unit.get("bf16", 0))) / BF16_FLOPS
    mf = model_flops(cfg, shape, face) if cfg is not None else 0.0
    return RooflineTerms(
        compute_s=max(dense_s, int8_s, word_s),
        memory_s=nbytes / HBM_BYTES_PER_S,
        collective_s=cbytes / NET_BW,
        flops=flops, int8_s=int8_s, word_s=word_s, bytes_accessed=nbytes,
        collective_bytes=cbytes, model_flops=mf,
        useful_ratio=mf / max(chips * flops, 1.0))


def load_artifact(path: str) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)
