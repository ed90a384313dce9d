"""Deterministic synthetic LM data stream (port of
``repro.data.synthetic``; the same numpy generators, so its batches are
byte-equal to the JAX package's).

A fixed random bigram transition table (seeded) generates token streams
with real learnable structure, so training shows a decreasing loss.
Batches are a pure function of (seed, step): a restart resumes bit for
bit from the step counter alone.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np

from repro_torch.configs.base import ModelConfig, ShapeConfig


@dataclasses.dataclass
class SyntheticStream:
    cfg: ModelConfig
    seq_len: int
    global_batch: int
    seed: int = 0
    branching: int = 8          # bigram successors per token
    step: int = 0               # checkpointable cursor

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        v = self.cfg.vocab_size
        self._succ = rng.integers(0, v, size=(v, self.branching),
                                  dtype=np.int64)

    @property
    def successors(self) -> np.ndarray:
        """(vocab, branching): the tokens that may follow each token."""
        return self._succ

    def _gen_tokens(self, step: int) -> np.ndarray:
        rng = np.random.default_rng((self.seed, step, 0xC0B7A))
        b, s = self.global_batch, self.seq_len
        choices = rng.integers(0, self.branching, size=(b, s))
        toks = np.empty((b, s), np.int64)
        toks[:, 0] = rng.integers(0, self.cfg.vocab_size, size=b)
        for t in range(1, s):
            toks[:, t] = self._succ[toks[:, t - 1], choices[:, t]]
        return toks

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """Pure function of step; labels are next-token (last = -1,
        ignored)."""
        cfg = self.cfg
        s_text = self.seq_len - cfg.frontend_tokens \
            if cfg.frontend_tokens and cfg.family != "audio" else self.seq_len
        toks = self._gen_tokens(step)[:, :s_text]
        labels = np.concatenate(
            [toks[:, 1:], np.full((toks.shape[0], 1), -1, np.int64)], axis=1)
        out = {"tokens": toks.astype(np.int32),
               "labels": labels.astype(np.int32)}
        if cfg.frontend_tokens:
            rng = np.random.default_rng((self.seed, step, 0xF207))
            d_f = min(cfg.d_model, 1024)
            out["frontend_embeds"] = rng.standard_normal(
                (self.global_batch, cfg.frontend_tokens, d_f),
                dtype=np.float32)
        return out

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self.batch_at(self.step)
            self.step += 1

    def state_dict(self) -> Dict[str, int]:
        return {"step": self.step, "seed": self.seed}

    def load_state_dict(self, d: Dict[str, int]) -> None:
        if d["seed"] != self.seed:
            raise ValueError("stream seed mismatch")
        self.step = int(d["step"])


def make_stream(cfg: ModelConfig, shape: ShapeConfig,
                seed: int = 0) -> SyntheticStream:
    return SyntheticStream(cfg, shape.seq_len, shape.global_batch, seed=seed)
