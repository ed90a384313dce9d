"""The dry run's census (``repro_torch.launch.cost``) against what the
port's steps really do, on the CPU.

* smollm-135m's smoke decode and prefill steps traced on meta call the
  hand-written kernels in the order, the number and at the shapes that
  the plain versions receive on the CPU (recorded by wrapping ``ref.*``),
  and each call's census work is ``kernels.work``'s bound arithmetic of
  those operands (the arithmetic ``launch/kernel_times.py`` bounds each
  timed call with).  The dense FLOPs equal ``FlopCounterMode``'s.
* The recurrences' trip-count scaling: the scaled census of hymba's and
  xlstm's smoke prefill and train steps equals the unrolled trace's at 8
  and 16 positions, FLOPs, bytes and launches exactly (and collective
  bytes); the peak (temp) too, exactly, for these steps."""
import test_torch_threads  # noqa: F401  (first: one torch thread)
import functools
import math

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import census as hooks, tree
from repro_torch.configs import base
from repro_torch.kernels import work
from repro_torch.kernels.pack import ref as pack_ref
from repro_torch.kernels.rbmm import ref as rbmm_ref
from repro_torch.kernels.rbmm_mxu import ref as mxu_ref
from repro_torch.kernels.sps_attn import ref as sps_ref
from repro_torch.launch import cost, mesh as mesh_lib, specs
from repro_torch.models.lm import build_model
from repro_torch.optim.adamw import AdamW
from repro_torch.train.trainer import Trainer, TrainerConfig

META = torch.device("meta")
B, PROMPT = 2, 24


def _work_of(name, args, kwargs, out):
    """``kernels.work`` of one call from the operands its plain version
    received and the output it gave."""
    if name == "pack_threshold":
        return work.pack(args[0], args[1], out)
    if name == "rbmm_int":
        a, b, k = args[:3]
        return work.rbmm(math.prod(a.shape[:-1]), b.shape[-2], k, a, b,
                         kwargs.get("dc"), out)
    if name == "rbmm_mxu":
        a, w = args
        return work.mxu(math.prod(a.shape[:-2]), a.shape[-2], a.shape[-1],
                        w.shape[-2], a, w, out)
    q, k, vt, theta = args
    return work.sps(q, k, vt, theta, out, kwargs["causal"],
                    kwargs["window"], kwargs["lens"])


def _record_plain(monkeypatch):
    calls = []
    for mod, fn, name in ((pack_ref, "pack_threshold", "pack_threshold"),
                          (rbmm_ref, "rbmm_int", "rbmm_int"),
                          (mxu_ref, "rbmm_mxu", "rbmm_mxu"),
                          (sps_ref, "sps_attention_gqa", "sps_attention"),
                          (rbmm_ref, "rbmm_binary", "rbmm_binary")):
        orig = getattr(mod, fn)

        def wrapped(*args, _orig=orig, _name=name, **kwargs):
            out = _orig(*args, **kwargs)
            calls.append((_name, _work_of(_name, args, kwargs, out)))
            return out
        monkeypatch.setattr(mod, fn, wrapped)
    return calls


def _record_census(monkeypatch):
    calls = []
    orig = hooks.kernel

    def wrapped(name, w):
        calls.append((name, w))
        orig(name, w)
    monkeypatch.setattr(hooks, "kernel", wrapped)
    return calls


@functools.lru_cache(maxsize=None)
def _smollm():
    cfg = base.get_smoke_config("smollm-135m")
    model = build_model(cfg)
    dparams = model.init_deploy(torch.Generator().manual_seed(0),
                                device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (B, PROMPT + 1),
                           generator=torch.Generator().manual_seed(1))
    return cfg, model, dparams, tokens


def _steps(model, dparams, tokens, device):
    """(prefill, decode) on ``device``: whole-prompt logits, then one decode
    step against a cache that the prompt filled."""
    dp = tree.map(lambda t: t.to(device), dparams)
    tok = tokens.to(device)

    def prefill():
        return model.prefill_logits(dp, tok[:, :PROMPT], device=device)

    caches = model.init_caches(B, PROMPT + 8, device)

    def decode():
        return model.decode_step(dp, tok[:, PROMPT:], caches)
    return prefill, decode


@pytest.mark.parametrize("face", ["prefill", "decode"])
def test_census_calls_are_the_plain_versions_calls(face, monkeypatch):
    _, model, dparams, tokens = _smollm()
    plain = _record_plain(monkeypatch)
    cpu_step = dict(zip(("prefill", "decode"),
                        _steps(model, dparams, tokens, "cpu")))[face]
    cpu_step()
    traced = _record_census(monkeypatch)
    meta_step = dict(zip(("prefill", "decode"),
                         _steps(model, dparams, tokens, META)))[face]
    census, _ = cost.measure(meta_step, ())
    assert [n for n, _ in traced] == [n for n, _ in plain]
    assert [w for _, w in traced] == [w for _, w in plain]
    assert census.launches() == {
        n: sum(1 for m, _ in plain if m == n) for n, _ in plain}
    if face == "decode":       # 30 layers' worth at smoke depth
        layers = model.cfg.num_layers
        assert census.launches() == {"pack_threshold": 6 * layers,
                                     "rbmm_int": 9 * layers}
    for name, k in census.kernels.items():
        ws = [w for n, w in traced if n == name]
        assert k["bytes"] == sum(w.bytes for w in ws)
        assert sum(k["ops"].values()) == sum(w.ops for w in ws)
    with FlopCounterMode(display=False) as fc:
        meta_step()
    assert census.flops == fc.get_total_flops() > 0


def test_bytes_skip_views_and_count_each_operand():
    a = torch.empty(8, 16, device=META)
    b = torch.empty(16, 4, device=META)

    def step(a, b):
        return (a @ b).t().contiguous()
    census, out = cost.measure(step, (a, b))
    assert census.flops == 2 * 8 * 4 * 16
    # mm reads a and b and writes (8, 4); the transpose is a view; the
    # copy reads and writes (4, 8)
    assert census.bytes == 4 * (8 * 16 + 16 * 4 + 8 * 4) + 4 * 2 * 32
    assert census.arguments == 4 * (8 * 16 + 16 * 4)
    assert census.outputs == 4 * 32 and census.temp == 2 * 4 * 32


RECURRENT = ["hymba-1.5b", "xlstm-350m"]


def _recurrent(arch, face, length):
    """(step, args) of ``arch``'s smoke ``face`` on meta at ``length``
    positions: the deploy prefill, or the train step on a (1, 1) mesh."""
    cfg = base.get_smoke_config(arch)
    model = build_model(cfg)
    mesh = mesh_lib.AbstractMesh((1, 1), ("data", "model"))
    tokens = torch.zeros((B, length), dtype=torch.int32, device=META)
    if face == "prefill":
        dparams = specs.deploy_param_specs(model, mesh)

        def prefill(dp, tok):
            return model.prefill_logits(dp, tok, mesh=mesh)
        return prefill, (dparams, tokens)
    trainer = Trainer(model, AdamW(lr=1e-3), TrainerConfig(), device=META,
                      mesh=mesh)
    state = specs.train_state_specs(trainer)
    batch = {"tokens": tokens, "labels": tokens.clone()}
    return (lambda st, bt: trainer.train_step(st, bt)), (state, batch)


@pytest.mark.parametrize("length", [8, 16])
@pytest.mark.parametrize("face", ["prefill", "train"])
@pytest.mark.parametrize("arch", RECURRENT)
def test_trip_count_scaling_equals_the_unrolled_trace(arch, face, length):
    step, args = _recurrent(arch, face, length)
    unrolled, _ = cost._run(step, args, trip=None)
    assert unrolled.loop_len is None
    scaled, _ = cost.measure(step, args)
    assert scaled.loop_len == length
    assert scaled.flops == unrolled.flops
    assert scaled.bytes == unrolled.bytes
    assert scaled.launches() == unrolled.launches()
    assert scaled.kernels == unrolled.kernels
    assert scaled.collectives == unrolled.collectives
    assert scaled.temp == unrolled.temp


def test_scaled_peak_of_a_long_recurrent_backward_is_bounded():
    """Where the peak falls in the backward of a loop's steps, which
    autograd runs outside the loop, the scaled peak is extrapolated from
    that stretch's largest value: xlstm's train step at 64 positions
    holds 48,485,056 bytes at its peak unrolled, 47,373,860 scaled
    (-2.3%); every other count is exact."""
    step, args = _recurrent("xlstm-350m", "train", 64)
    unrolled, _ = cost._run(step, args, trip=None)
    scaled, _ = cost.measure(step, args)
    assert (scaled.flops, scaled.bytes, scaled.kernels) == (
        unrolled.flops, unrolled.bytes, unrolled.kernels)
    assert unrolled.temp == 48_485_056
    assert abs(scaled.temp - unrolled.temp) <= 0.03 * unrolled.temp
