"""BiT-style two-stage distillation and the SPS threshold search driver
(port of ``repro.optim.distill``).

The paper's pipeline (§III-A3):
  1. fp teacher -> BiT student (softmax + elastic binarization attention),
     trained with logit and hidden distillation;
  2. per-head SPS thresholds lambda* minimizing the CDR between the BiT
     student's attention probabilities and SPS's on a calibration set
     (``repro_torch.data.calib``);
  3. lambda frozen, attention switched to SPS, the weights fine-tuned.

The losses are float32 functions of logits and hidden states;
``search_model_thresholds`` pools each layer's calibration scores and
runs ``core.sps.search_thresholds`` on them; ``install_thresholds``
writes each layer's lambda* into its own attention params (the port's
layers are a list, where the JAX package writes one stacked leaf).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import sps as sps_lib

Params = Any


def kd_loss(student_logits: torch.Tensor, teacher_logits: torch.Tensor,
            temperature: float = 2.0) -> torch.Tensor:
    """Soft-label cross-entropy at ``temperature``, times its square."""
    t = temperature
    sp = F.log_softmax(student_logits / t, dim=-1)
    tp = torch.softmax(teacher_logits / t, dim=-1)
    return -(tp * sp).sum(-1).mean() * t * t


def hidden_distill_loss(student_h: torch.Tensor,
                        teacher_h: torch.Tensor) -> torch.Tensor:
    """Mean squared error of (projected) hidden states."""
    return torch.mean((student_h - teacher_h) ** 2)


def distill_loss(student_logits: torch.Tensor, teacher_logits: torch.Tensor,
                 labels: torch.Tensor, *, alpha: float = 0.9,
                 temperature: float = 2.0) -> torch.Tensor:
    """alpha * KD + (1 - alpha) * the cross-entropy over valid labels
    (>= 0): BiT's logit distillation mix."""
    kd = kd_loss(student_logits, teacher_logits, temperature)
    labels = torch.as_tensor(labels, device=student_logits.device)
    valid = labels >= 0
    lab = torch.where(valid, labels, 0).long()
    logp = F.log_softmax(student_logits, dim=-1)
    nll = -torch.gather(logp, -1, lab[..., None])[..., 0]
    ce = torch.where(valid, nll, 0.0).sum() / valid.sum().clamp_min(1)
    return alpha * kd + (1 - alpha) * ce


# ---------------------------------------------------------------------------
# SPS threshold search over a model (stage 2)
# ---------------------------------------------------------------------------


def search_model_thresholds(
        collect_scores: Callable[[Params, Dict[str, Any]],
                                 List[Tuple[torch.Tensor, torch.Tensor]]],
        params: Params, calib_batches: Sequence[Dict[str, Any]], *,
        granularity: str = "head") -> List[sps_lib.SPSCalibration]:
    """``collect_scores(params, batch)`` -> per layer [(z, bit_probs)]
    from the BiT-mode forward.  Pools each layer's batches (along the
    batch axis) and searches its lambda* (Eq. 6)."""
    per_layer: List[Tuple[List[torch.Tensor], List[torch.Tensor]]] = []
    for batch in calib_batches:
        layers = collect_scores(params, batch)
        if not per_layer:
            per_layer = [([], []) for _ in layers]
        for (zs, ps), (z, p) in zip(per_layer, layers):
            zs.append(z)
            ps.append(p)
    out = []
    for zs, ps in per_layer:
        lam, c = sps_lib.search_thresholds(torch.cat(zs, 0),
                                           torch.cat(ps, 0),
                                           granularity=granularity)
        out.append(sps_lib.SPSCalibration(lam=lam, cdr=c,
                                          granularity=granularity))
    return out


def install_thresholds(params: Params,
                       calibs: Sequence[sps_lib.SPSCalibration], *,
                       path: Tuple[str, str, str] = ("blocks", "attn",
                                                     "sps_lambda")
                       ) -> Params:
    """A copy of ``params`` whose layer i under ``path[0]`` holds
    ``calibs[i].lam`` at ``path[1:]``, in that leaf's shape, dtype and
    device; every other leaf is shared with ``params``."""
    layers_key, attn_key, lam_key = path
    layers = params[layers_key]
    if len(calibs) != len(layers):
        raise ValueError(f"{len(calibs)} calibrations for {len(layers)} "
                         f"layers")
    new_layers = []
    for lp, cal in zip(layers, calibs):
        cur = lp[attn_key][lam_key]
        attn = dict(lp[attn_key])
        attn[lam_key] = cal.lam.reshape(cur.shape).to(cur.dtype).to(
            cur.device)
        new_layers.append({**lp, attn_key: attn})
    return {**params, layers_key: new_layers}
