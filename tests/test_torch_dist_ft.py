"""Fault tolerance and the explicit collective of the port on gloo worlds
of CPU ranks: a checkpoint saved on one mesh restored onto another
(``ft.elastic_restore``), ``allreduce_1bit`` against the JAX package's
(its formula, and JAX's own ``allreduce_1bit`` under ``shard_map`` in a
subprocess with 4 host devices, as ``test_distributed.py`` runs it), and
the training CLI under torchrun.

Tolerances: restored params bitwise (the checkpoint holds whole leaves);
the step after a restore as ``test_torch_dist_train.py`` holds a mesh
step (loss within 1e-6 relative, params within 2 lr with all but 1 in
1,000 within 1e-5); ``allreduce_1bit`` within 1e-5 relative of the
formula (plus 4 float32 roundings of the largest term where the ranks'
terms cancel), 1e-6 of JAX's (float32 means of |g| summed in another
order, and the same cancellation)."""
import test_torch_threads  # noqa: F401  (first: one torch thread)
import functools
import os
import subprocess
import sys
import textwrap

import numpy as np
import torch

import test_torch_dist_worlds as worlds
from conftest import subprocess_env
from repro_torch import tree
from repro_torch.checkpoint.ckpt import Checkpointer
from repro_torch.train import ft

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "smollm-135m"
LOSS_RTOL, PARAM_ATOL, PARAM_SHARE = 1e-6, 1e-5, 1e-3


def test_elastic_restore_from_2x2_onto_2x1(tmp_path):
    """Two steps and a checkpoint on a (2, 2) mesh of 4 ranks; a (2, 1)
    mesh of 2 ranks restores it: the whole params are the saved ones bit
    for bit (the manifest's sha256 of every leaf too), the data step is
    the saved one, and the next step equals the one-device trainer's next
    step from the same checkpoint."""
    d = str(tmp_path / "ckpt")
    saved = worlds.run_world(4, worlds.elastic_save_job, ARCH, 2, d, 2)[0]
    ranks = worlds.run_world(2, worlds.elastic_restore_job, ARCH, 1, d)
    restored, data_step, verified, loss, after = ranks[0]
    assert all(torch.equal(a, b) for a, b in zip(restored, saved))
    assert data_step == 2
    assert verified == len(Checkpointer(d).manifest(2)["leaves"])
    assert all(r[3] == loss for r in ranks)
    tr, stream = worlds.trainer(ARCH, {})
    state, step, _ = ft.restore_or_init(tr, Checkpointer(d))
    assert step == 2
    assert all(torch.equal(a, b)
               for a, b in zip(tree.leaves(state.params), saved))
    state, losses, _, _ = worlds.steps(tr, stream, state, 1, step)
    assert abs(loss - losses[0]) <= LOSS_RTOL * abs(losses[0])
    diffs = torch.cat([(a - b).abs().reshape(-1) for a, b in zip(
        after, tree.leaves(state.params))])
    assert float(diffs.max()) <= 2 * worlds.LR
    assert float((diffs > PARAM_ATOL).double().mean()) <= PARAM_SHARE


@functools.lru_cache(maxsize=None)
def _gradients():
    """Each of 4 ranks' local gradient: 64 values (JAX's test's draw) and
    99 (a last word of 3 bits)."""
    rng = np.random.default_rng(0)
    return (rng.normal(size=(4, 64)).astype(np.float32),
            rng.normal(size=(4, 3, 33)).astype(np.float32))


@functools.lru_cache(maxsize=None)
def _port_1bit():
    return [worlds.run_world(4, worlds.allreduce_1bit_job, g)
            for g in _gradients()]


def test_allreduce_1bit_matches_the_jax_formula():
    """Every rank gets the mean over ranks of sign(g_i) * mean |g_i|
    (sign(0) = +1), JAX's ``test_allreduce_1bit_shard_map`` formula; the
    sign bits went through the pack kernel's plain version."""
    for g, ranks in zip(_gradients(), _port_1bit()):
        terms = [np.where(g[i] >= 0, 1.0, -1.0) * np.abs(g[i]).mean()
                 for i in range(4)]
        want = np.mean(terms, axis=0)
        # where the 4 terms cancel, their float32 sum rounds at the terms'
        # scale, not the result's
        atol = 4 * np.finfo(np.float32).eps * np.abs(terms).max()
        for got in ranks:
            assert got.shape == g.shape[1:]
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=atol)
            np.testing.assert_array_equal(got, ranks[0])


def test_allreduce_1bit_matches_jax_under_shard_map(tmp_path):
    """JAX's ``allreduce_1bit`` under ``shard_map`` on 4 host devices (a
    subprocess) and the port's on 4 gloo ranks give the same averages."""
    for j, g in enumerate(_gradients()):
        np.save(tmp_path / f"g{j}.npy", g)
    script = textwrap.dedent(f"""
        import os
        os.environ['XLA_FLAGS'] = os.environ.get('XLA_FLAGS', '') + \\
            ' --xla_force_host_platform_device_count=4'
        from functools import partial
        import jax, jax.numpy as jnp, numpy as np
        from jax.sharding import PartitionSpec as P
        from repro.optim.compress import allreduce_1bit
        try:
            from jax import shard_map
        except ImportError:
            from jax.experimental.shard_map import shard_map
        # Auto axes: under the default Explicit ones JAX's packing of a
        # ragged last word fails to trace
        mesh = jax.make_mesh((4,), ('data',),
                             axis_types=(jax.sharding.AxisType.Auto,))
        for j in range(2):
            g = np.load({str(tmp_path)!r} + f'/g{{j}}.npy')
            spec = P('data', *([None] * (g.ndim - 1)))

            @partial(shard_map, mesh=mesh, in_specs=spec, out_specs=spec)
            def reduce(local):
                return allreduce_1bit(local[0], 'data')[None]

            np.save({str(tmp_path)!r} + f'/jax{{j}}.npy',
                    np.asarray(reduce(jnp.asarray(g))))
    """)
    out = subprocess.run([sys.executable, "-c", script],
                         env=subprocess_env(4), capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    for j, ranks in enumerate(_port_1bit()):
        got = np.load(tmp_path / f"jax{j}.npy")
        atol = 4 * np.finfo(np.float32).eps * np.abs(got).max()
        for i, port in enumerate(ranks):
            np.testing.assert_allclose(port, got[i], rtol=1e-6, atol=atol)


def test_torchrun_trains_on_a_mesh_and_checkpoints(tmp_path):
    """``torch.distributed.run`` with 2 ranks and ``--model-parallel 2``:
    a (1, 2) gloo mesh trains 2 steps, rank 0 alone logs, and the
    checkpoint holds whole leaves that a one-device trainer restores."""
    d = tmp_path / "ckpt"
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    env.pop("WORLD_SIZE", None)
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.train",
         "--device", "cpu", "--model-parallel", "2", "--steps", "2",
         "--batch", "4", "--seq-len", "16", "--ckpt-dir", str(d),
         "--ckpt-every", "1"],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "'data': 1, 'model': 2" in out.stdout
    assert out.stdout.count("step 1 loss") == 1, out.stdout
    ckpt = Checkpointer(str(d))
    assert ckpt.all_steps() == [1, 2]
    manifest = ckpt.manifest(2)
    assert manifest["extra"] == {"data_step": 2}
    tr, _ = worlds.trainer(ARCH, {})
    like = tr.init_state()
    shapes = {n: list(t.shape) for n, t in tree.leaves_with_paths(like)}
    assert {m["name"]: m["shape"] for m in manifest["leaves"]} == shapes
    state, step, _ = ft.restore_or_init(tr, ckpt)
    assert step == 2 and int(state.opt.step) == 2
