"""The dry run's mesh against real meshes, on gloo worlds of CPU ranks
(``test_torch_dist_worlds.run_world``; smollm-135m's smoke config).

* The mesh trainer's step on a (2, 2) world makes the collectives, by
  kind and result bytes, that its trace on a (2, 2) ``AbstractMesh``
  counts (rank 0's).
* The mesh ``prefill_logits`` and ``decode_step`` at (2, 1), (1, 2) and
  (2, 2) give the one-device forward's logits for each rank's rows,
  bitwise, and leave each rank's blocks of the caches equal to the
  one-device step's; a batch of one row at (2, 1) splits the ring over
  the data axis (sequence parallelism) and gives the same.
* A dim split over ("pod", "data") takes its block by the row-major index
  over both and gathers back whole, and the gather's backward sums the
  gradient over both data axes; a collective over both counts once, by
  its result's bytes, as on the ``AbstractMesh``.
* ``run_cell`` writes an OK record for smollm decode_32k and a SKIP for
  long_500k on a full-attention arch; the CLI's ``--jobs`` workers write
  one record a cell, and a dry-run process ends with the process that
  started it.
Everything here is exact."""
import test_torch_threads  # noqa: F401  (first: one torch thread)
import functools
import json
import os
import subprocess
import sys
import time

import torch

import test_torch_dist_worlds as worlds
from repro_torch import tree
from repro_torch.configs import base
from repro_torch.launch import cost, dryrun, mesh as mesh_lib, specs
from repro_torch.launch.mesh import P
from repro_torch.models.lm import build_model
from repro_torch.optim.adamw import AdamW
from repro_torch.train.trainer import Trainer, TrainerConfig

ARCH = "smollm-135m"
B, S, EXTRA = 4, 12, 4
META = torch.device("meta")


def _placed_rows(mesh, t):
    """This rank's placed rows of ``t`` (whole where they do not split)."""
    pl = mesh_lib.Placement(mesh, specs._batch_spec(mesh, tuple(t.shape),
                                                    t.shape[0]), t.shape)
    return mesh_lib.place(pl.shard(t), pl), pl


def _deploy_case(mesh, batch: int):
    """(logits equal, decode logits equal, caches equal, any cache leaf
    split) of the mesh faces against the one-device ones."""
    model = build_model(base.get_smoke_config(ARCH))
    dparams = model.init_deploy(torch.Generator().manual_seed(0),
                                device="cpu")
    tokens = torch.randint(0, model.cfg.vocab_size, (batch, S + 1),
                           generator=torch.Generator().manual_seed(1))
    want = model.prefill_logits(dparams, tokens[:, :S], device="cpu")
    _, caches = model.prefill_with_cache(dparams, tokens[:, :S],
                                         max_len=S + EXTRA)
    mine = tree.map(lambda t: t.clone(), caches)
    want_dec, _ = model.decode_step(dparams, tokens[:, S:], caches)

    local = mesh_lib.shard_tree(mesh, model.deploy_specs(), dparams)
    tok, pl = _placed_rows(mesh, tokens[:, :S])
    rows = pl.block(torch.arange(batch))
    got = model.prefill_logits(local, tok, mesh=mesh)
    shards = tree.map(lambda t: mesh_lib.place(*(lambda p: (p.shard(t), p))(
        mesh_lib.Placement(mesh, specs.cache_spec(
            mesh, tuple(t.shape), batch=batch), t.shape))), mine)
    tok1, _ = _placed_rows(mesh, tokens[:, S:])
    got_dec, _ = model.decode_step(local, tok1, shards, mesh=mesh)
    caches_equal = all(
        torch.equal(s, mesh_lib.placement_of(s).block(w))
        for s, w in zip(tree.leaves(shards), tree.leaves(caches)))
    split = any(mesh_lib.placement_of(s).splits
                for s in tree.leaves(shards))
    return (torch.equal(got, want[rows]), torch.equal(got_dec,
                                                      want_dec[rows]),
            caches_equal, split)


def deploy_job(model_axis: int, batches):
    mesh = mesh_lib.make_host_mesh(model_axis, "cpu")
    return [_deploy_case(mesh, b) for b in batches]


def _train_collectives_abstract(shape):
    """The collectives a (data, model) ``AbstractMesh`` counts in one step
    of the smoke trainer (rank 0)."""
    cfg = worlds.config(ARCH, "block")
    mesh = mesh_lib.AbstractMesh(shape, ("data", "model"))
    tr = Trainer(build_model(cfg), AdamW(lr=worlds.LR), TrainerConfig(),
                 device=META, mesh=mesh)
    state = specs.train_state_specs(tr)
    batch = {k: torch.empty(v.shape, dtype=torch.as_tensor(v).dtype,
                            device=META)
             for k, v in worlds.SyntheticStream(
                 cfg, worlds.SEQ, worlds.BATCH, seed=0).batch_at(0).items()}
    census, _ = cost.measure(lambda st: tr.train_step(st, batch), (state,))
    return census.collectives


def world4_job():
    """On 4 ranks: the (2, 2) deploy case; the trainer's collectives of one
    step at (2, 2); a (pod, data) placement's round trip."""
    deploy = deploy_job(2, [B])
    mesh = mesh_lib.make_host_mesh(2, "cpu")
    tr, stream = worlds.trainer(ARCH, {}, mesh, "block")
    state = tr.init_state()
    with cost.counting() as census:
        tr.train_step(state, stream.batch_at(0))
    from torch.distributed.device_mesh import init_device_mesh
    pod = mesh_lib.Mesh(init_device_mesh("cpu", (2, 2, 1), mesh_dim_names=(
        "pod", "data", "model")), torch.device("cpu"))
    full = torch.arange(8 * 3, dtype=torch.float32).reshape(8, 3)
    pl = mesh_lib.Placement(pod, P(("pod", "data"), None), full.shape)
    local = pl.shard(full)
    x = local.clone().requires_grad_(True)
    w = torch.arange(24, dtype=torch.float32).reshape(8, 3) / 7
    (pl.gather(x) * w).sum().backward()
    index = mesh_lib.block_index(pod, ("pod", "data"))
    return dict(deploy=deploy, collectives=census.collectives,
                pod_collectives=_pod_collectives(pod, local),
                pod=(pl.local_shape, index, pod.data_index,
                     torch.equal(local, full[2 * index:2 * index + 2]),
                     torch.equal(pl.whole(local), full),
                     torch.equal(x.grad, 4 * w[2 * index:2 * index + 2])))


def _pod_collectives(mesh, local):
    """(census bytes by kind, ``mesh.collectives``) of an all-gather and
    an all-reduce of ``local`` over ("pod", "data")."""
    before = mesh.collectives
    with cost.counting() as census:
        mesh.all_gather(local, ("pod", "data"), 0)
        mesh.all_reduce(local.clone(), ("pod", "data"))
    return census.collectives, mesh.collectives - before


def worlds_2_job():
    """On 2 ranks: (2, 1) at B and at one row (the ring split over
    "data"), and (1, 2) at B, each in its own process group's mesh."""
    out = {"2x1": deploy_job(1, [B, 1])}
    out["1x2"] = deploy_job(2, [B])
    return out


@functools.lru_cache(maxsize=None)
def _world(size: int):
    return worlds.run_world(size, world4_job if size == 4 else worlds_2_job)


def test_mesh_deploy_faces_equal_one_device_at_2x1_and_1x2():
    for rank in _world(2):
        assert rank["2x1"][0][:3] == (True, True, True)
        assert rank["2x1"][1][:3] == (True, True, True)
        assert rank["2x1"][1][3], "the ring of a one-row batch is split"
        assert rank["1x2"][0][:3] == (True, True, True)


def test_mesh_deploy_faces_equal_one_device_at_2x2():
    for rank in _world(4):
        assert rank["deploy"][0][:3] == (True, True, True)


def test_trainer_collectives_equal_the_abstract_mesh_census():
    res = _world(4)
    want = _train_collectives_abstract((2, 2))
    assert res[0]["collectives"] == want
    assert want["all-gather"] > 0 and want["all-reduce"] > 0
    for rank in res:      # every rank runs the same collectives
        assert rank["collectives"] == want


def test_pod_data_placement_round_trips():
    seen = set()
    for r, rank in enumerate(_world(4)):
        shape, index, data_index, cut, whole, grad = rank["pod"]
        assert shape == (2, 3) and index == data_index == r
        assert cut and whole and grad
        seen.add(index)
    assert seen == {0, 1, 2, 3}


def test_pod_data_collectives_count_as_the_abstract_mesh():
    """A collective over two data axes runs one per axis on the real mesh
    and counts once, by its result's bytes, as the dry run's mesh does."""
    abstract = mesh_lib.AbstractMesh((2, 2, 1), ("pod", "data", "model"))
    want = _pod_collectives(abstract, torch.empty(2, 3, device="meta"))
    assert want[0]["all-gather"] == 8 * 3 * 4
    assert want[0]["all-reduce"] == 2 * 3 * 4 and want[1] == 2
    for rank in _world(4):
        assert rank["pod_collectives"] == want


def test_run_cell_records_ok_and_skip(tmp_path):
    rec = dryrun.run_cell("smollm-135m", "decode_32k", "single",
                          out_dir=str(tmp_path), verbose=False)
    assert rec["status"] == "OK", rec.get("traceback")
    saved = json.loads((tmp_path / "smollm-135m__decode_32k__single.json")
                       .read_text())
    assert saved["status"] == "OK" and saved["face"] == "decode"
    assert saved["kernels"]["pack_threshold"]["launches"] == 6 * 30
    assert saved["kernels"]["rbmm_int"]["launches"] == 9 * 30
    assert saved["roofline"]["step_time_s"] > 0
    assert round(saved["argument_size_in_bytes"] / 2 ** 30, 2) == 0.36
    skip = dryrun.run_cell("qwen1.5-32b", "long_500k", "multi",
                           out_dir=str(tmp_path), verbose=False)
    assert skip["status"] == "SKIP"
    assert skip["reason"] == "needs sub-quadratic attention"
    assert (tmp_path / "qwen1.5-32b__long_500k__multi.json").is_file()


def test_cli_jobs_write_a_record_a_cell(tmp_path, capsys):
    """``--jobs`` traces the cells in worker processes: one record a cell,
    as one process writes them."""
    dryrun.main(["--arch", "qwen1.5-32b", "--shape", "long_500k", "--mesh",
                 "both", "--jobs", "2", "--out", str(tmp_path)])
    recs = [json.loads(p.read_text()) for p in sorted(tmp_path.iterdir())]
    assert [(r["mesh"], r["status"]) for r in recs] == [
        ("multi", "SKIP"), ("single", "SKIP")]
    assert "2 cells" in capsys.readouterr().out


def _running(pid: int) -> bool:
    """Is ``pid`` a live process (neither gone nor a zombie)?"""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except FileNotFoundError:
        return False


def test_cli_ends_with_its_parent():
    """A dry-run process (the CLI run as a program, and each ``--jobs``
    worker) is killed when the process that started it ends, so a sweep
    killed from above leaves no process behind."""
    child = ("from repro_torch.launch import dryrun\n"
             "dryrun._end_with_parent()\n"
             "print('armed', flush=True)\n"
             "import time; time.sleep(300)\n")
    parent = ("import subprocess, sys\n"
              f"p = subprocess.Popen([sys.executable, '-c', {child!r}], "
              "stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, "
              "text=True)\n"
              "assert p.stdout.readline() == 'armed\\n'\n"
              "print(p.pid)\n")
    out = subprocess.run([sys.executable, "-c", parent], env=dict(os.environ),
                         capture_output=True, text=True, timeout=240,
                         check=True)
    pid = int(out.stdout)
    deadline = time.monotonic() + 30
    while _running(pid) and time.monotonic() < deadline:
        time.sleep(0.05)
    assert not _running(pid)
