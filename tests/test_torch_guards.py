"""Guards of the PyTorch port: import isolation from the JAX package,
device handling of the entry points, dispatch and launch counting,
sampler invariants, the bridge's word format and the "not ported yet"
boundaries."""
import ast
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch import bridge, kernels
from repro_torch.configs import base
from repro_torch.kernels.pack import ops as pack_ops
from repro_torch.launch import serve as serve_cli
from repro_torch.models.attention import SPSAttention
from repro_torch.models.lm import build_model
from repro_torch.serve import engine, sampler

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and \
                not node.level:
            yield node.module


def test_port_imports_neither_jax_nor_the_jax_package():
    assert len(PORT_FILES) > 20
    bad = [(str(path.relative_to(ROOT)), mod) for path in PORT_FILES
           for mod in _imported_modules(path)
           if mod.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, bad


def test_cuda_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        repro_torch.resolve_device("cuda")
    model = build_model(base.get_smoke_config("smollm-135m"))
    with pytest.raises(RuntimeError, match="CUDA card"):
        engine.ServeEngine(model, {}, engine.ServeConfig())
    with pytest.raises(RuntimeError, match="CUDA card"):
        bridge.from_jax_params({"x": np.zeros(2)})
    with pytest.raises(SystemExit, match="CUDA card"):
        serve_cli.main(["--device", "cuda", "--batch", "1"])
    assert repro_torch.resolve_device("cpu") == torch.device("cpu")


def test_cli_runs_on_cpu_when_asked(capsys):
    serve_cli.main(["--device", "cpu", "--batch", "2", "--prompt-len", "5",
                    "--new-tokens", "3"])
    out = capsys.readouterr().out
    assert "generated (2, 3)" in out and "on cpu" in out


def test_dispatch_goes_by_device_and_cpu_never_counts_a_launch():
    kernels.reset_launch_counts()
    x = torch.randn(4, 40)
    assert not kernels.use_kernel(x, None)
    pack_ops.pack_threshold(x, torch.zeros(()))
    assert kernels.launch_counts() == {name: 0 for name in kernels.KERNELS}
    with pytest.raises(ValueError, match="meta"):
        kernels.use_kernel(torch.empty(2, device="meta"))


def test_every_kernel_source_names_what_it_replaces_and_its_bound():
    for mod, _ in kernels.KERNELS.values():
        src = (kernels.CSRC / f"{mod}.cu").read_text()
        assert f"src/repro/kernels/{mod}/kernel.py" in src, mod
        assert "Bound on the H100" in src, mod
        assert "__global__" in src and "COBRA_API" in src, mod
    assert len(kernels.source_hash()) == 16


def test_samplers_hold_their_invariants():
    gen = torch.Generator().manual_seed(0)
    logits = torch.randn(64, 1, 50, generator=gen)
    greedy = sampler.greedy(logits)
    assert greedy.dtype == torch.int32 and greedy.shape == (64, 1)
    tied = torch.zeros(1, 1, 5)
    assert sampler.greedy(tied).item() == 0          # lowest index wins
    np.testing.assert_array_equal(
        sampler.temperature(logits, gen, 1e-6).numpy(), greedy.numpy())
    top5 = torch.topk(logits, 5, dim=-1).indices
    for _ in range(5):
        pick = sampler.top_k(logits, gen, 5, temp=2.0)
        assert pick.dtype == torch.int32 and pick.shape == (64, 1)
        assert (top5 == pick.unsqueeze(-1).long()).any(-1).all()
    draws = sampler.temperature(logits.expand(64, 400, 50), gen, 1.0)
    assert len(torch.unique(draws)) > 5               # it does sample


def test_bridge_keeps_word_bits_and_splits_stacked_blocks():
    words = np.array([[0xFFFFFFFF, 0x80000000], [1, 0x7FFFFFFF]],
                     dtype=np.uint32)
    tree = {"embed": {"embedding": np.ones((3, 2), np.float32)},
            "blocks": {"w": {"w_packed": np.stack([words, words ^ 1])},
                       "s": np.arange(2, dtype=np.float32)}}
    out = bridge.from_jax_params(tree, device="cpu")
    assert len(out["blocks"]) == 2
    w0 = out["blocks"][0]["w"]["w_packed"]
    assert w0.dtype == torch.int32
    np.testing.assert_array_equal(w0.numpy().view(np.uint32), words)
    np.testing.assert_array_equal(
        out["blocks"][1]["w"]["w_packed"].numpy().view(np.uint32),
        words ^ 1)
    assert out["blocks"][1]["s"].shape == ()


def test_not_ported_yet_boundaries():
    with pytest.raises(NotImplementedError, match="not ported yet"):
        base.get_config("mixtral-8x22b")
    with pytest.raises(KeyError):
        base.get_config("gpt-2")
    cfg = base.get_config("smollm-135m")
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.resolved_head_dim, cfg.d_ff, cfg.vocab_size,
            cfg.compute_dtype) == (30, 576, 9, 3, 64, 1536, 49152,
                                   "bfloat16")
    with pytest.raises(NotImplementedError, match="row"):
        SPSAttention(96, 3, 1, 32, sps_granularity="row")
    model = build_model(base.get_smoke_config("smollm-135m"))
    eng = engine.ServeEngine(model, {}, engine.ServeConfig(), device="cpu")
    with pytest.raises(NotImplementedError, match="continuous batching"):
        eng.generate([np.arange(3)], max_new_tokens=2)
    with pytest.raises(NotImplementedError, match="not ported yet"):
        build_model(base.get_smoke_config("smollm-135m").with_(
            window_size=16))
