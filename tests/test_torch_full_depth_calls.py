"""``kernel_times.encdec_calls`` on the decoder-only archs that the card
serves at full depth (qwen1.5-32b, gemma3-27b's windowed layers,
mixtral-8x22b's and arctic-480b's expert stacks), at smoke size on the
CPU: each path's calls and launches per step equal the kernel wrappers'
calls in a static prefill and a static decode step.  The card run checks
the full-depth serves' launches against the same function at full width
and depth."""
import test_torch_threads  # noqa: F401  (first: one torch thread)
import collections

import numpy as np
import pytest
import torch

from repro_torch.configs import base
from repro_torch.launch import kernel_times
from repro_torch.models.lm import build_model

from test_torch_encdec import _trace_calls

ARCHS = ("qwen1.5-32b", "gemma3-27b", "mixtral-8x22b", "arctic-480b")


@pytest.mark.parametrize("arch", ARCHS)
def test_static_calls_match_the_traced_path(arch, monkeypatch):
    cfg = base.get_smoke_config(arch)
    model = build_model(cfg)
    dparams = model.init_deploy(torch.Generator().manual_seed(1))
    # prompts past the smoke windows, so windowed rings wrap
    b, s, new = 3, 40, 4
    table = kernel_times.encdec_calls(cfg, (b, s, new))
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (b, s))
    seen = _trace_calls(monkeypatch)
    runs = {}
    with torch.inference_mode():
        seen.clear()
        lg, caches = model.prefill_with_cache(
            dparams, torch.from_numpy(toks), max_len=s + new)
        runs["prefill"] = dict(seen)
        seen.clear()
        model.decode_step(dparams, lg[:, -1:].argmax(-1), caches)
        runs["decode"] = dict(seen)
    short = arch.split("-")[0]
    for path, calls in runs.items():
        want = collections.Counter()
        for name, (kernel, spec, n) in table.items():
            if name.startswith(f"{kernel} {short} {path} "):
                want[(kernel, spec)] += n
        assert dict(want) == calls, path
