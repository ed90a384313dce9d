"""The port's training loop against the JAX package on the CPU: AdamW (a
schedule, the global-norm clip, float32 and bfloat16 moments, the weight
decay rule read on JAX's stacked tree), the schedules, 1-bit gradient
compression, the synthetic stream (byte-equal batches) and ``Trainer``'s
step with gradient accumulation and compression, held step by step to
the composition the JAX ``Trainer`` jits (``value_and_grad`` of
``train_loss``, micro-batches summed in order, ``compress_tree``,
``AdamW.update``) without its mesh, which fails on the CPU (ROADMAP
§3).  Then the port's own: the ``Checkpointer`` (round trip, a corrupted
leaf, GC, the asynchronous commit), ``ft.run``'s restart equal to an
uninterrupted run bitwise, the straggler watchdog, the CLI with a resume,
and the bridge of a JAX train state.

Tolerances: the stream bitwise; float32 values within 1e-6 relative
(reductions in another order: the global norm, a mean |g|; the
schedule's cos); AdamW's params on equal gradients within 1e-5; params
after training steps as ``_close_params`` states (Adam's m / sqrt(v)
amplifies the last bits of a gradient near zero); bfloat16 moments
within one bfloat16 rounding."""
import test_torch_threads  # noqa: F401  (first: one torch thread)
import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.data import synthetic as jsyn
from repro.models.lm import build_model as jbuild
from repro.optim import compress as jcomp, schedules as jsched
from repro.optim.adamw import AdamW as JAdamW
from repro.train.trainer import TrainState as JState
from repro_torch import bridge, tree
from repro_torch.checkpoint.ckpt import Checkpointer
from repro_torch.configs import base as tbase
from repro_torch.data import synthetic as tsyn
from repro_torch.launch import train as train_cli
from repro_torch.models.lm import build_model as tbuild
from repro_torch.optim import compress as tcomp, schedules as tsched
from repro_torch.optim.adamw import AdamW as TAdamW, decayed
from repro_torch.train import ft
from repro_torch.train.trainer import Trainer, TrainerConfig, TrainState

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "smollm-135m"
F32_RTOL, PARAM_ATOL, BF16_RTOL = 1e-6, 1e-5, 2.0 ** -7
LR = 3e-3


@functools.lru_cache(maxsize=None)
def _jax_model():
    jm = jbuild(jbase.get_smoke_config(ARCH))
    return jm, jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))


def _jax_opt(moment="float32"):
    return JAdamW(lr=LR, schedule=jsched.warmup_cosine(2, 10),
                  moment_dtype=jnp.dtype(moment))


def _port_opt(moment="float32"):
    return TAdamW(lr=LR, schedule=tsched.warmup_cosine(2, 10),
                  moment_dtype=getattr(torch, moment))


@functools.lru_cache(maxsize=None)
def _jax_update(moment):
    return jax.jit(_jax_opt(moment).update)


def _grads(params, seed, scale=0.05):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda p: (scale * rng.standard_normal(p.shape))
                        .astype(np.float32), params)


def _close_tree(got, want_np, atol=0.0, rtol=0.0, what="", of_max=0.0):
    """Leaf by leaf; ``of_max`` adds that share of the leaf's largest
    |value| to ``atol``."""
    want = bridge.from_jax_params(want_np, device="cpu")
    gl, wl = tree.leaves_with_paths(got), tree.leaves(want)
    assert len(gl) == len(wl)
    for (name, g), w in zip(gl, wl):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        w = w.float()
        np.testing.assert_allclose(
            g.float().numpy(), w.numpy(), rtol=rtol,
            atol=atol + of_max * float(w.abs().max()),
            err_msg=f"{what} {name}")


def _close_params(got, want_np, steps):
    """Params after training steps on gradients that agree to float32
    rounding: Adam's m / sqrt(v) turns a last-bit difference of a
    gradient near zero into a step of up to lr, so an element may differ
    by up to 2 lr per step; all but 1 in 1,000 agree to 1e-6."""
    want = bridge.from_jax_params(want_np, device="cpu")
    diffs = torch.cat([(g - w).abs().reshape(-1) for g, w in zip(
        tree.leaves(got), tree.leaves(want))])
    assert float(diffs.max()) <= 2 * LR * steps
    assert float((diffs > 1e-6).double().mean()) <= 1e-3


@pytest.mark.parametrize("moment", ["float32", "bfloat16"])
def test_adamw_update_matches_jax(moment):
    """Three steps of ``update`` on the same gradients (large enough that
    the clip scales them), the warmup-cosine schedule, decay on JAX's
    stacked leaves: params, both moments, the grad norm and lr."""
    _, params = _jax_model()
    jopt, topt = _jax_opt(moment), _port_opt(moment)
    jp, js = jax.tree.map(jnp.asarray, params), None
    js = jopt.init(jp)
    tp = bridge.from_jax_params(params, device="cpu")
    ts = topt.init(tp)
    for step in range(3):
        g = _grads(params, step)
        jp, js, jm = _jax_update(moment)(jax.tree.map(jnp.asarray, g), js,
                                         jp)
        tp, ts, tm = topt.update(bridge.from_jax_params(g, device="cpu"),
                                 ts, tp)
        assert float(jm["grad_norm"]) > 1.0          # the clip acts
        assert float(tm["grad_norm"]) == pytest.approx(
            float(jm["grad_norm"]), rel=F32_RTOL)
        # the schedule's cos may differ from XLA's in its last bit
        assert float(tm["lr"]) == pytest.approx(float(jm["lr"]),
                                                rel=F32_RTOL)
    assert int(ts.step) == int(js.step) == 3 and ts.step.device.type == "cpu"
    # bfloat16 moments: a last-bit difference of the clip's scale can
    # round a moment the other way, moving m / sqrt(v) by one bfloat16
    # rounding, so each step's update by up to lr * 2^-7
    patol = PARAM_ATOL if moment == "float32" else 3 * LR * BF16_RTOL
    _close_tree(tp, jax.tree.map(np.asarray, jp), atol=patol, what="params")
    # a moment rounded the other way once stays one bfloat16 rounding of
    # the leaf's scale apart (0.9 m + 0.1 g may cancel, so not relative)
    mrtol = F32_RTOL if moment == "float32" else 0.0
    of_max = 0.0 if moment == "float32" else BF16_RTOL
    _close_tree(ts.mu, jax.tree.map(np.asarray, js.mu), rtol=mrtol,
                atol=1e-8, what="mu", of_max=of_max)
    _close_tree(ts.nu, jax.tree.map(np.asarray, js.nu), rtol=mrtol,
                atol=1e-10, what="nu", of_max=of_max)


def test_weight_decay_follows_jax_stacked_tree():
    """Zero gradients leave only the decay: JAX moves exactly its leaves of
    ndim >= 2, stacked per-layer leaves included (norm scales, per-head
    scales and lambdas, alpha_w), and the port moves the same ones."""
    _, params = _jax_model()
    params = jax.tree.map(lambda p: p + np.float32(0.25), params)
    zero = jax.tree.map(np.zeros_like, params)
    jopt = JAdamW(lr=0.1, weight_decay=0.5)
    jp = jax.tree.map(jnp.asarray, params)
    jnew, _, _ = jax.jit(jopt.update)(jax.tree.map(jnp.asarray, zero),
                                      jopt.init(jp), jp)
    topt = TAdamW(lr=0.1, weight_decay=0.5)
    tp = bridge.from_jax_params(params, device="cpu")
    tnew, _, _ = topt.update(bridge.from_jax_params(zero, device="cpu"),
                             topt.init(tp), tp)
    jnew_t = bridge.from_jax_params(jax.tree.map(np.asarray, jnew),
                                    device="cpu")
    flags = decayed(tp)
    for (name, old), new, d in zip(tree.leaves_with_paths(tp),
                                   tree.leaves(jnew_t), flags):
        assert bool((old != new).any()) == d, name
    paths = dict(zip([n for n, _ in tree.leaves_with_paths(tp)], flags))
    assert paths["blocks/0/norm1/scale"] and paths["blocks/1/attn/q_alpha"]
    assert not paths["blocks/0/attn/act_alpha"]
    assert not paths["final_norm/scale"] and paths["embed/embedding"]
    _close_tree(tnew, jax.tree.map(np.asarray, jnew), rtol=F32_RTOL,
                what="decayed params")
    assert not any(decayed(tp, stacked=())[i] for i, (n, _) in enumerate(
        tree.leaves_with_paths(tp)) if n.endswith("act_alpha"))


def test_schedules_match_jax():
    steps = list(range(0, 42))
    for jf, tf in ((jsched.constant(), tsched.constant()),
                   (jsched.warmup_cosine(5, 30), tsched.warmup_cosine(5, 30)),
                   (jsched.warmup_cosine(0, 1), tsched.warmup_cosine(0, 1)),
                   (jsched.warmup_linear(5, 30, 0.1),
                    tsched.warmup_linear(5, 30, 0.1))):
        want = np.array([np.asarray(jf(jnp.asarray(s, jnp.int32)))
                         for s in steps], np.float32)
        got = np.array([tf(s).item() for s in steps], np.float32)
        assert tf(3).dtype == torch.float32
        np.testing.assert_allclose(got, want, rtol=F32_RTOL, atol=0)


def test_compression_matches_jax():
    _, params = _jax_model()
    g = _grads(params, 5)
    ef = _grads(params, 6, scale=0.01)
    gj, efj = jcomp.compress_tree(jax.tree.map(jnp.asarray, g),
                                  jax.tree.map(jnp.asarray, ef))
    gt, eft = tcomp.compress_tree(bridge.from_jax_params(g, device="cpu"),
                                  bridge.from_jax_params(ef, device="cpu"))
    _close_tree(gt, jax.tree.map(np.asarray, gj), rtol=F32_RTOL, what="g")
    _close_tree(eft, jax.tree.map(np.asarray, efj), rtol=1e-5, atol=1e-7,
                what="ef")
    z = tcomp.init_error_feedback(bridge.from_jax_params(params,
                                                         device="cpu"))
    assert all(t.dtype == torch.float32 and not t.any()
               for t in tree.leaves(z))
    # a stacked leaf's layers share one scale, as JAX's one (L, ...) leaf
    groups = tcomp.stacked_groups(gt)
    assert max(len(g) for g in groups) == 2 and len(groups) == len(
        jax.tree.leaves(params))
    x, e = torch.tensor([0.0, -2.0, 1.0]), torch.zeros(3)
    g_hat, e2 = tcomp.compress(x, e)
    assert g_hat.tolist() == [1.0, -1.0, 1.0] and torch.equal(x - g_hat, e2)


def test_synthetic_stream_is_byte_equal_to_jax():
    for arch in (ARCH, "internvl2-76b", "seamless-m4t-large-v2"):
        jcfg, tcfg = jbase.get_smoke_config(arch), tbase.get_smoke_config(
            arch)
        js, ts = (jsyn.SyntheticStream(jcfg, 24, 3, seed=4),
                  tsyn.SyntheticStream(tcfg, 24, 3, seed=4))
        np.testing.assert_array_equal(ts.successors, js._succ)
        for step in (0, 7):
            a, b = ts.batch_at(step), js.batch_at(step)
            assert a.keys() == b.keys(), arch
            for k in a:
                assert a[k].dtype == b[k].dtype and a[k].tobytes() == \
                    b[k].tobytes(), (arch, k)
    for name, shape in jbase.SHAPES.items():
        assert tbase.SHAPES[name].__dict__ == shape.__dict__
    ms = tsyn.make_stream(tbase.get_smoke_config(ARCH),
                          tbase.ShapeConfig("t", 8, 2, "train"), seed=1)
    assert next(iter(ms))["tokens"].shape == (2, 8) and ms.step == 0
    ms.load_state_dict({"step": 5, "seed": 1})
    assert ms.state_dict() == {"step": 5, "seed": 1}
    with pytest.raises(ValueError, match="seed"):
        ms.load_state_dict({"step": 5, "seed": 2})


@functools.lru_cache(maxsize=None)
def _jax_step(accum, compress_grads):
    """``repro.train.trainer.Trainer._build_train_step``'s ``step``,
    without the mesh."""
    jm, _ = _jax_model()
    opt = _jax_opt()
    grad_fn = jax.value_and_grad(jm.train_loss, has_aux=True)

    def step(state, batch):
        if accum > 1:
            def micro(c, mb):
                (l, m), g = grad_fn(state.params, mb)
                gsum, lsum = c
                return (jax.tree.map(jnp.add, gsum, g), lsum + l), m

            mbs = jax.tree.map(lambda x: x.reshape(
                (accum, x.shape[0] // accum) + x.shape[1:]), batch)
            g0 = jax.tree.map(lambda p: jnp.zeros(p.shape, jnp.float32),
                              state.params)
            (gsum, lsum), ms = jax.lax.scan(micro, (g0, 0.0), mbs)
            grads = jax.tree.map(lambda g: g / accum, gsum)
            metrics = jax.tree.map(lambda m: m[-1], ms)
            metrics["loss_total"] = lsum / accum
        else:
            (loss, metrics), grads = grad_fn(state.params, batch)
            metrics["loss_total"] = loss
        ef = state.ef
        if compress_grads:
            grads, ef = jcomp.compress_tree(grads, ef)
        params, o, om = opt.update(grads, state.opt, state.params)
        metrics.update(om)
        return JState(params, o, ef), metrics

    return jax.jit(step)


@pytest.mark.parametrize("accum,compress_grads", [(1, False), (2, False),
                                                  (1, True)])
def test_train_step_matches_jax_composition(accum, compress_grads):
    """Two steps from one state on the stream's batches (B = 4 x 16):
    loss_total, loss, grad norm, then params, moments and error feedback
    leaf by leaf."""
    jm, params = _jax_model()
    opt = _jax_opt()
    jp = jax.tree.map(jnp.asarray, params)
    js = JState(jp, opt.init(jp),
                jcomp.init_error_feedback(jp) if compress_grads else None)
    ts = bridge.from_jax_train_state(jax.tree.map(np.asarray, js),
                                     device="cpu")
    trainer = Trainer(tbuild(tbase.get_smoke_config(ARCH)), _port_opt(),
                      TrainerConfig(grad_accum=accum,
                                    compress_grads=compress_grads),
                      device="cpu")
    stream = tsyn.SyntheticStream(tbase.get_smoke_config(ARCH), 16, 4)
    for step in range(2):
        batch = stream.batch_at(step)
        js, jmet = _jax_step(accum, compress_grads)(
            js, jax.tree.map(jnp.asarray, batch))
        ts, tmet = trainer.train_step(ts, batch)
        for k in ("loss_total", "loss", "grad_norm"):
            assert float(tmet[k]) == pytest.approx(float(jmet[k]),
                                                   rel=1e-5), (step, k)
        assert int(tmet["tokens"]) == int(jmet["tokens"])
    _close_params(ts.params, jax.tree.map(np.asarray, js.params), steps=2)
    _close_tree(ts.opt.mu, jax.tree.map(np.asarray, js.opt.mu), rtol=1e-3,
                atol=1e-6, what="mu")
    if compress_grads:
        _close_tree(ts.ef, jax.tree.map(np.asarray, js.ef), rtol=1e-3,
                    atol=1e-6, what="ef")
    else:
        assert ts.ef is None


def _state(seed=0):
    gen = torch.Generator().manual_seed(seed)
    params = {"w": torch.randn(3, 4, generator=gen),
              "blocks": [{"s": torch.randn(5, generator=gen)}],
              "h": torch.randn(6, generator=gen).to(torch.bfloat16)}
    opt = TAdamW().init(params)
    return TrainState(params, opt, None)


def test_checkpoint_round_trip_and_async_commit(tmp_path):
    ck = Checkpointer(str(tmp_path))
    st = _state()
    ck.save(7, st, extra={"data_step": 9})        # committed on a thread
    st.params["w"].add_(1.0)                      # the host copy was taken
    ck.wait()
    assert ck.latest_step() == 7
    assert (tmp_path / "step_00000007" / "_COMMITTED").exists()
    like = _state(1)
    got, extra = ck.restore(7, like)
    assert extra == {"data_step": 9} and isinstance(got, TrainState)
    want = _state()
    for (name, a), b in zip(tree.leaves_with_paths(got), tree.leaves(want)):
        assert a.dtype == b.dtype and torch.equal(a, b), name
    assert ck.verify(7, got) == len(tree.leaves(want))
    names = [m["name"] for m in ck.manifest(7)["leaves"]]
    assert "params/blocks/0/s" in names and "opt/step" in names
    assert {m["dtype"] for m in ck.manifest(7)["leaves"]} >= {
        "bfloat16", "float32", "int32"}
    with pytest.raises(IOError, match="differs"):
        ck.verify(7, _state(2))


def test_checkpoint_corrupted_leaf_fails_loudly(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, _state(), blocking=True)
    leaf = ck.manifest(1)["leaves"][0]
    path = tmp_path / "step_00000001" / leaf["file"]
    arr = np.load(path)
    arr.reshape(-1)[0] += 1
    np.save(path, arr)
    with pytest.raises(IOError, match="integrity"):
        ck.restore(1, _state())
    ck.restore(1, _state(), check_integrity=False)
    bad = _state()
    with pytest.raises(KeyError, match="missing"):
        ck.restore(1, bad._replace(params={**bad.params, "x": torch.ones(1)}),
                   check_integrity=False)
    with pytest.raises(ValueError, match="shape"):
        ck.restore(1, bad._replace(params={**bad.params,
                                           "w": torch.ones(2, 2)}),
                   check_integrity=False)


def test_checkpoint_gc_keeps_the_last_n(tmp_path):
    ck = Checkpointer(str(tmp_path), keep_last_n=2)
    for step in range(1, 6):
        ck.save(step, _state(step))
    ck.wait()
    (tmp_path / "step_00000009").mkdir()          # never committed
    (tmp_path / "step_00000010.tmp").mkdir()
    assert ck.all_steps() == [4, 5] and ck.latest_step() == 5
    assert Checkpointer(str(tmp_path / "empty")).latest_step() is None


def _smoke_trainer():
    cfg = tbase.get_smoke_config(ARCH)
    return (Trainer(tbuild(cfg), TAdamW(lr=LR, schedule=tsched.warmup_cosine(
        1, 4)), device="cpu"), tsyn.SyntheticStream(cfg, 16, 4, seed=3))


def test_restart_equals_uninterrupted_run_bitwise(tmp_path):
    """Four steps straight against two steps, a new trainer restored from
    the step-2 checkpoint and two more: every loss and every final leaf
    bitwise (the stream resumes from the checkpoint's data step)."""
    logs, seen = [], {}

    def rec(tag):
        return lambda step, m, dt: seen.setdefault(tag, {}).update(
            {step: float(m["loss_total"])})

    tr, stream = _smoke_trainer()
    a = ft.run(tr, stream, Checkpointer(str(tmp_path / "a")), steps=4,
               ckpt_every=2, log_fn=logs.append, on_step=rec("a"))
    ck = Checkpointer(str(tmp_path / "b"))
    tr, stream = _smoke_trainer()
    ft.run(tr, stream, ck, steps=2, ckpt_every=2, log_fn=logs.append,
           on_step=rec("b"))
    tr, stream = _smoke_trainer()
    b = ft.run(tr, stream, ck, steps=4, ckpt_every=2, log_fn=logs.append,
               on_step=rec("b"))
    assert seen["a"] == seen["b"] and sorted(seen["b"]) == [0, 1, 2, 3]
    for x, y in zip(tree.leaves(a), tree.leaves(b)):
        assert torch.equal(x, y)
    assert ck.all_steps() == [2, 4] and stream.step == 4
    assert any(line.startswith("step 3 loss") for line in logs)
    state, data_step, extra = ft.restore_or_init(tr, ck)
    assert int(state.opt.step) == 4 and data_step == 4


def test_straggler_watchdog():
    events = []
    wd = ft.StragglerWatchdog(flag_factor=2.0, warmup_steps=3,
                              on_straggler=lambda s, dt, e: events.append(s))
    times = [1.0, 1.0, 1.0, 1.0, 5.0, 1.0, 1.9, 3.0]
    flags = [wd.observe(i, t) for i, t in enumerate(times)]
    assert flags == [False, False, False, False, True, False, False, True]
    assert events == [4, 7] and wd.flags == 2 and wd.history == times
    assert wd.ewma == pytest.approx(0.9 * 1.0 + 0.1 * 1.9)  # 5.0 left out


def test_cli_trains_on_the_cpu_then_resumes(tmp_path, capsys):
    """``python -m repro_torch.launch.train --device cpu`` for 2 smoke
    steps, then a rerun with the same ``--ckpt-dir`` that resumes at step
    2 (in process, to read its state)."""
    args = ["--device", "cpu", "--batch", "4", "--seq-len", "16",
            "--ckpt-dir", str(tmp_path), "--ckpt-every", "1"]
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    run = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                          "--steps", "2", *args], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert run.returncode == 0, run.stderr
    assert "device=cpu" in run.stdout and "step 1 loss" in run.stdout
    assert Checkpointer(str(tmp_path)).latest_step() == 2
    state = train_cli.main(["--steps", "3", *args])
    out = capsys.readouterr().out
    assert "step 2 loss" in out and "step 0 loss" not in out
    assert int(state.opt.step) == 3
    assert Checkpointer(str(tmp_path)).manifest(3)["extra"] == {
        "data_step": 3}


def test_bridge_carries_a_jax_train_state():
    """A JAX state after one update, through ``from_jax_train_state``: the
    port's structure (per-layer lists), the step on the host, values."""
    _, params = _jax_model()
    jopt = _jax_opt()
    jp = jax.tree.map(jnp.asarray, params)
    g = jax.tree.map(jnp.asarray, _grads(params, 9))
    jp2, js, _ = _jax_update("float32")(g, jopt.init(jp), jp)
    state = JState(jp2, js, jcomp.init_error_feedback(jp2))
    ts = bridge.from_jax_train_state(jax.tree.map(np.asarray, state),
                                     device="cpu")
    like = Trainer(tbuild(tbase.get_smoke_config(ARCH)), _port_opt(),
                   TrainerConfig(compress_grads=True),
                   device="cpu").init_state()
    assert [n for n, _ in tree.leaves_with_paths(ts)] == \
        [n for n, _ in tree.leaves_with_paths(like)]
    assert ts.opt.step.dtype == torch.int32 and int(ts.opt.step) == 1
    assert ts.opt.step.device.type == "cpu"
    _close_tree(ts.opt.nu, jax.tree.map(np.asarray, js.nu))
