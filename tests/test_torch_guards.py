"""Guards of the PyTorch port: import isolation from the JAX package,
device handling of the entry points, dispatch and launch counting,
sampler invariants, the bridge's word format and the "not ported yet"
boundaries."""
import test_torch_threads  # noqa: F401  (first: one torch thread)
import ast
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch import bridge, kernels
from repro_torch.checkpoint.ckpt import Checkpointer
from repro_torch.configs import base
from repro_torch.kernels.pack import ops as pack_ops
from repro_torch.kernels.rbmm_mxu import ops as mxu_ops, ref as mxu_ref
from repro_torch.launch import serve as serve_cli, train as train_cli
from repro_torch.models.attention import SPSAttention
from repro_torch.models.blocks import Block
from repro_torch.models.ffn import BinaryFFN
from repro_torch.models.lm import build_model
from repro_torch.optim.adamw import AdamW
from repro_torch.serve import engine, sampler
from repro_torch.train import ft
from repro_torch.train.trainer import Trainer

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
    launch = ROOT / "src" / "repro_torch" / "launch"
    assert {launch / f"{name}.py" for name in (
        "specs", "cost", "roofline", "dryrun", "mesh")} <= set(PORT_FILES)
    bad = [(str(path.relative_to(ROOT)), mod) for path in PORT_FILES
           for mod in _imported_modules(path)
           if mod.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, bad


def test_kernels_and_models_import_nothing_of_launch():
    """The layers run bottom up: the kernel wrappers, the models and the
    census hooks import nothing of ``repro_torch.launch`` (the CLIs and
    the dry run's entry points)."""
    src = ROOT / "src" / "repro_torch"
    low = [p for p in PORT_FILES if p.parent == src or
           src / "kernels" in p.parents or src / "models" in p.parents or
           src / "core" in p.parents]
    assert src / "census.py" in low and src / "models" / "lm.py" in low
    bad = [(str(path.relative_to(ROOT)), mod) for path in low
           for mod in _imported_modules(path)
           if mod.startswith("repro_torch.launch")]
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
    encoder = build_model(base.get_smoke_config("bert-base-cobra"))
    with pytest.raises(RuntimeError, match="CUDA card"):
        encoder.prefill_logits({}, np.zeros((1, 4), np.int32))
    on_cpu = {"embed": {"embedding": torch.zeros(2)}}
    with pytest.raises(ValueError, match="params lie on cpu"):
        encoder.prefill_logits(on_cpu, np.zeros((1, 4), np.int32),
                               device="meta")
    assert repro_torch.resolve_device("cpu") == torch.device("cpu")


def test_training_entry_points_raise_without_a_card(monkeypatch, tmp_path):
    """The trainer (and so ``ft.run``, which runs on a trainer's device)
    and the training CLI default to CUDA and raise without a card; the
    new modules fall under the import guard above.  Without torchrun's
    environment the world is one rank, which a model axis of 2 does not
    divide; an elastic restore needs a committed step, as in JAX."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    names = {p.relative_to(ROOT / "src" / "repro_torch").as_posix()
             for p in PORT_FILES if "src" in p.parts}
    assert {"core/sps.py", "optim/adamw.py", "optim/compress.py",
            "optim/schedules.py", "train/trainer.py", "train/ft.py",
            "checkpoint/ckpt.py", "data/synthetic.py", "launch/train.py",
            "tree.py"} <= names
    model = build_model(base.get_smoke_config("smollm-135m"))
    with pytest.raises(RuntimeError, match="CUDA card"):
        Trainer(model, AdamW())
    with pytest.raises(SystemExit, match="CUDA card"):
        train_cli.main(["--steps", "1", "--ckpt-dir", str(tmp_path)])
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(SystemExit, match=r"world size \(1\) is not "
                       r"divisible by the model axis \(2\)"):
        train_cli.main(["--device", "cpu", "--model-parallel", "2",
                        "--ckpt-dir", str(tmp_path)])
    with pytest.raises(FileNotFoundError, match="no committed checkpoint"):
        ft.elastic_restore(Checkpointer(str(tmp_path / "empty")), None)
    assert Trainer(model, AdamW(), device="cpu").graph is False


def test_cli_runs_on_cpu_when_asked(capsys):
    serve_cli.main(["--device", "cpu", "--batch", "2", "--prompt-len", "5",
                    "--new-tokens", "3"])
    out = capsys.readouterr().out
    assert "generated (2, 3)" in out and "on cpu" in out


def test_dispatch_goes_by_device_and_cpu_never_counts_a_launch():
    """CPU operands take the plain version and meta operands the
    shape-only route; neither counts a launch, and a mix of meta with
    CPU (or CUDA) operands raises."""
    kernels.reset_launch_counts()
    x = torch.randn(4, 40)
    assert kernels.use_kernel(x, None) == "cpu"
    pack_ops.pack_threshold(x, torch.zeros(()))
    meta = torch.empty(4, 40, device="meta")
    assert kernels.use_kernel(meta, None) == "meta"
    out = pack_ops.pack_threshold(meta, torch.zeros((), device="meta"))
    assert out.device.type == "meta" and out.shape == (4, 2)
    assert out.dtype == torch.int32
    assert kernels.launch_counts() == {name: 0 for name in kernels.KERNELS}
    with pytest.raises(ValueError, match="meta"):
        kernels.use_kernel(meta, x)
    with pytest.raises(ValueError, match="meta"):
        pack_ops.pack_threshold(meta, torch.zeros(()))
    cuda = types.SimpleNamespace(device=torch.device("cuda", 0))
    with pytest.raises(ValueError, match="cuda"):
        kernels.use_kernel(meta, cuda)


def test_every_kernel_source_names_what_it_replaces_and_its_bound():
    for mod, _ in kernels.KERNELS.values():
        src = (kernels.CSRC / f"{mod}.cu").read_text()
        assert f"src/repro/kernels/{mod}/kernel.py" in src, mod
        assert "Bound on the H100" in src, mod
        assert "__global__" in src and "COBRA_API" in src, mod
    assert len(kernels.source_hash()) == 16


def test_rbmm_mxu_tile_rule():
    """The largest compiled tile whose grid fills the 132 SMs: 128 x 64 at
    the prefill w1 shape (128 x 128 gives only 96 blocks), 128 x 128 at the
    encoder's Q/K/V/O shape (192 blocks), the smallest at the ragged and
    tile-edge shapes that no tile fills."""
    rule = mxu_ops.tile_for
    assert mxu_ops.TILES == ((128, 128), (128, 64), (64, 64))
    assert rule(1, 1024, 1536) == (128, 64)
    assert rule(1, 4096, 768) == (128, 128)
    for batch, m, p in ((1, 70, 45), (2, 33, 65), (1, 129, 127),
                        (3, 128, 129), (1, 65, 63)):
        assert rule(batch, m, p) == (64, 64)
    assert rule(1, 1024, 768) == (64, 64)       # 96 blocks at 128 x 64
    assert rule(2, 1024, 768) == (128, 64)      # the batch counts too
    assert rule(1, 1024, 1536, sms=96) == (128, 128)


@pytest.mark.parametrize("k", [48, 100, 1100])
def test_rbmm_mxu_k_pad_equals_unpadded_plain(k):
    """For K % 8 != 0 (or a base not 16-byte aligned) the wrapper hands the
    kernel A zero-padded to ceil8(K) <= 32 * Kw; the plain product of the
    padded A equals the unpadded one even where the words' pad bits are
    set.  K % 8 == 0 on an aligned base is passed through as it is."""
    rng = np.random.default_rng(k)
    kw = (k + 31) // 32
    a = torch.from_numpy((2 * rng.integers(0, 2, (37, k)) - 1).astype(
        np.float32)).to(torch.bfloat16)
    w = torch.from_numpy(rng.integers(0, 2**32, (29, kw), dtype=np.uint64)
                         .astype(np.uint32).view(np.int32))   # pad bits set
    padded = mxu_ops.pad_k(a)
    k8 = -(-k // 8) * 8
    assert padded.shape == (37, k8) and padded.is_contiguous()
    assert padded.data_ptr() % 16 == 0
    assert torch.equal(padded[:, :k], a) and not padded[:, k:].any()
    assert (padded is a) == (k8 == k)
    assert torch.equal(mxu_ref.rbmm_mxu(padded, w), mxu_ref.rbmm_mxu(a, w))
    buf = torch.zeros(1 + 37 * k8, dtype=torch.bfloat16)
    shifted = buf[1:].view(37, k8)          # contiguous, 2 bytes off
    assert shifted.data_ptr() % 16 and mxu_ops.pad_k(shifted).data_ptr() \
        % 16 == 0


def test_encoder_config_kernel_registry_and_cli_exit():
    """bert-base-cobra at its published widths, six kernels counted, and
    the serving CLI refusing an encoder as the JAX CLI does."""
    assert set(kernels.launch_counts()) == {
        "pack_threshold", "rbmm_int", "rbmm_binary", "rbmm_mxu",
        "sps_attention", "paged_gather_decode"}
    cfg = base.get_config("bert-base-cobra")
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.d_ff, cfg.vocab_size, cfg.norm, cfg.act, cfg.glu,
            cfg.causal, cfg.rope_theta, cfg.tie_embeddings,
            cfg.binary.ffn_block_r, cfg.skip_decode) == (
        12, 768, 12, 12, 3072, 30522, "layernorm", "relu", False, False,
        0.0, False, 4, True)
    with pytest.raises(SystemExit, match="encoder-only"):
        serve_cli.main(["--arch", "bert-base-cobra", "--device", "cpu"])


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


def test_not_ported_yet_boundaries(tmp_path):
    with pytest.raises(KeyError):
        base.get_config("gpt-2")
    cfg = base.get_config("smollm-135m")
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.resolved_head_dim, cfg.d_ff, cfg.vocab_size,
            cfg.compute_dtype) == (30, 576, 9, 3, 64, 1536, 49152,
                                   "bfloat16")
    # windows, the GELU GLU, the row granularity, the MoE, recurrent and
    # encoder-decoder families and the frontend stub are ported, and every
    # arch resolves; frontend models serve statically only, as in the JAX
    # package
    for arch in base.ARCH_IDS:
        assert base.get_config(arch).name == arch
    assert SPSAttention(96, 3, 1, 32, sps_granularity="row").init(
        torch.Generator(), "cpu")["sps_lambda"].shape == (3, 512)
    # every family's QAT face runs: the MoE (and its expert-stacked
    # GLU), the recurrent cells, cross-attention, the hybrid and decoder
    # blocks and the encoder-decoder's loss
    gen = torch.Generator().manual_seed(0)
    moe_ffn = build_model(base.get_smoke_config("granite-3-2b").with_(
        family="moe", moe=base.MoEConfig(num_experts=4), window_size=16)
    )._block()._ffn()
    d = moe_ffn.d_model
    y, aux = moe_ffn.apply(moe_ffn.init(gen, "cpu"), torch.ones(2, d))
    assert y.shape == (2, d) and aux["moe_aux_loss"].shape == ()
    experts = moe_ffn._experts()
    assert experts.apply(experts.init(gen, "cpu"),
                         torch.ones(4, 2, d)).shape == (4, 2, d)
    ssm = build_model(base.get_smoke_config("xlstm-350m"))
    cell = ssm._block("mlstm")._parts()["cell"]
    assert cell.apply(cell.init(gen, "cpu"),
                      torch.ones(1, 2, 128)).shape == (1, 2, 128)
    smoke = base.get_smoke_config("smollm-135m")
    cross = Block(smoke, kind="dec")._parts()["cross"]
    out, _ = cross.qat(cross.init(gen, "cpu"), torch.ones(1, 2, 96),
                       memory=torch.ones(1, 3, 96))
    assert out.shape == (1, 2, 96)
    for kind in ("dec", "hybrid"):
        cfg = base.get_smoke_config("hymba-1.5b") if kind == "hybrid" \
            else smoke
        blk = Block(cfg, kind=kind)
        x, _ = blk.qat(blk.init(gen, "cpu"), torch.ones(1, 2, cfg.d_model),
                       memory=torch.ones(1, 3, cfg.d_model))
        assert x.shape == (1, 2, cfg.d_model)
    encdec = build_model(base.get_smoke_config("seamless-m4t-large-v2"))
    loss, metrics = encdec.train_loss(encdec.init(gen), {
        "frontend_embeds": torch.ones(1, 8, 128),
        "tokens": torch.zeros(1, 4, dtype=torch.int32),
        "labels": torch.zeros(1, 4, dtype=torch.int32)})
    assert bool(torch.isfinite(loss)) and int(metrics["tokens"]) == 4
    # still not ported: the expert-stacked ReLU FFN (no config uses it);
    # the mesh work is ported: a model axis the one-rank world does not
    # divide exits saying so, an elastic restore without a committed step
    # raises as JAX's does
    with pytest.raises(NotImplementedError, match="not ported yet"):
        BinaryFFN(64, 128, act="relu", glu=False, num_experts=4)
    with pytest.raises(SystemExit, match=r"world size \(1\)"):
        train_cli.main(["--device", "cpu", "--model-parallel", "2"])
    with pytest.raises(FileNotFoundError, match="no committed checkpoint"):
        ft.elastic_restore(Checkpointer(str(tmp_path)), None)
    with pytest.raises(ValueError, match="unknown block kind"):
        Block(base.get_smoke_config("smollm-135m"), kind="cross")
    assert Block(base.get_smoke_config("smollm-135m"), kind="dec"
                 )._parts()["cross"].cross
    vlm = build_model(base.get_smoke_config("internvl2-76b"))
    eng = engine.ServeEngine(vlm, vlm.convert(vlm.init(torch.Generator())),
                             engine.ServeConfig(), device="cpu")
    with pytest.raises(ValueError, match="decoder-only token models"):
        eng.generate([np.arange(4)], max_new_tokens=2)
    encdec = build_model(base.get_smoke_config("smollm-135m").with_(
        family="encdec", num_encoder_layers=2))
    assert type(encdec).__name__ == "EncDecModel"
