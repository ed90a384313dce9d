"""Static-batch serve engine (port of ``repro.serve.engine``, static path).

``ServeEngine.generate`` with an equal-length ``(B, S)`` prompt batch runs
one ``prefill_with_cache`` over contiguous binary ring caches, then one
``decode_step`` per new token, eagerly.  Continuous batching (a list of
prompts), paging, chunked prefill and speculative decode are not ported
yet.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.serve import kvcache, sampler as sampler_lib

__all__ = ["CacheConfig", "ServeConfig", "ServeEngine"]


@dataclasses.dataclass
class CacheConfig:
    """KV-cache layout.  max_len: contiguous ring size (>= prompt + new
    tokens for full attention).  The paged layout serves through the
    continuous path, which is not ported yet."""
    max_len: int = 2048


@dataclasses.dataclass
class ServeConfig:
    """Engine-level serving knobs read by the static path.  sampler is one
    of greedy | temperature | top_k; seed seeds the sampling generator."""
    sampler: str = "greedy"
    temperature: float = 1.0
    top_k: int = 40
    seed: int = 0
    cache: CacheConfig = dataclasses.field(default_factory=CacheConfig)

    @property
    def max_len(self) -> int:
        return self.cache.max_len


class ServeEngine:
    def __init__(self, model, dparams, cfg: ServeConfig, *,
                 device="cuda"):
        """``dparams`` must already lie on ``device`` (CUDA by default;
        asking for CUDA without a card raises)."""
        self.model = model
        self.dparams = dparams
        self.cfg = cfg
        self.device = resolve_device(device)
        self._sample = {
            "greedy": lambda lg, g: sampler_lib.greedy(lg),
            "temperature": lambda lg, g: sampler_lib.temperature(
                lg, g, cfg.temperature),
            "top_k": lambda lg, g: sampler_lib.top_k(
                lg, g, cfg.top_k, cfg.temperature),
        }[cfg.sampler]

    def generate(self, prompts, *, max_new_tokens: int,
                 stream_cb: Optional[Callable] = None):
        """A (B, S) array of prompts -> (tokens (B, max_new_tokens) int32
        numpy, EngineReport).  ``stream_cb(step, tokens)`` is called after
        the prefill (step 0) and after every decode step."""
        ndim = getattr(prompts, "ndim", None)
        if ndim == 2:
            return self._generate_static(np.asarray(prompts),
                                         max_new_tokens, stream_cb)
        if ndim is None:
            raise NotImplementedError(
                "continuous batching (a list of prompts) is not ported "
                "yet: pass an equal-length (B, S) prompt array")
        raise ValueError(f"prompts array must be (B, S), got {ndim}-D")

    @torch.inference_mode()
    def _generate_static(self, prompts: np.ndarray, max_new_tokens: int,
                         stream_cb) -> Tuple[np.ndarray,
                                             kvcache.EngineReport]:
        b, s = prompts.shape
        gen = torch.Generator(device=self.device).manual_seed(self.cfg.seed)
        toks = torch.as_tensor(prompts.astype(np.int64), device=self.device)
        logits, caches = self.model.prefill_with_cache(
            self.dparams, toks, max_len=self.cfg.max_len)
        token = self._sample(logits, gen)
        out = [token.cpu().numpy()]
        if stream_cb:
            stream_cb(0, out[-1])
        for t in range(1, max_new_tokens):
            logits, caches = self.model.decode_step(self.dparams, token,
                                                    caches)
            token = self._sample(logits[:, -1:], gen)
            out.append(token.cpu().numpy())
            if stream_cb:
                stream_cb(t, out[-1])
        report = kvcache.cache_report(caches, seq_len=s + max_new_tokens,
                                      batch=b)
        return np.concatenate(out, axis=1), report
