"""Serving mixtral-8x22b's and arctic-480b's smoke configs in the port
against the JAX package on the CPU (2 layers, d = 128, float32; mixtral 4
experts and a window of 16 on every layer, arctic 8 experts, the dense
residual and full attention; both top-2, dropless).

Held: continuous paged serving by rid (mixtral's ring group of 16 tokens:
one page a slot, fully provisioned, so neither preemption nor prefix
sharing; arctic's of the
capacity on a short arena: preemptions and prefix hits) and speculative
serving with a one-layer draft, tokens by rid and reports equal; one
pooled unified iteration under a dropping ``capacity_factor`` of 0.5 whose
idle and padded rows route and take capacity, as in JAX: its next tokens
and caches equal the JAX engine's step; colliding paged writes resolve
by row and leave the trash page zero.  Params are the JAX package's,
scales and thresholds moved off their init values, bridged through
numpy.  The static engine is held in ``test_torch_moe_lm.py`` (its tokens
against JAX's jitted greedy decode, its report against JAX's
``cache_report``): the JAX engine's static path prefills op by op, ~20 s
on a CPU for these stacks."""
import test_torch_threads  # noqa: F401  (first: one torch thread)
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.models.lm import build_model as jbuild
from repro.serve import engine as jengine
from repro.serve import trace as jtrace
from repro_torch import bridge
from repro_torch.configs import base as tbase
from repro_torch.models.attention import SPSAttention
from repro_torch.models.lm import build_model as tbuild
from repro_torch.serve import engine as tengine
from repro_torch.serve import trace as ttrace

ARCHS = ("mixtral-8x22b", "arctic-480b")
TIMING = ("elapsed_s", "goodput_under_slo", "ttft_p50_s", "ttft_p99_s",
          "tenants")


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def _perturb(tree, rng, name=""):
    if isinstance(tree, dict):
        return {k: _perturb(v, rng, k) for k, v in tree.items()}
    a = np.array(tree)
    if name.endswith("_alpha"):
        return (a * rng.uniform(0.5, 1.5, a.shape)).astype(np.float32)
    if name.endswith("_beta"):
        return (a + 0.1 * rng.standard_normal(a.shape)).astype(np.float32)
    if name == "sps_lambda":
        return (a + 0.3 * rng.standard_normal(a.shape)).astype(np.float32)
    return a


@functools.lru_cache(maxsize=None)
def _models(arch):
    jm = jbuild(jbase.get_smoke_config(arch))
    qat = _perturb(jax.tree.map(np.asarray, jax.jit(jm.init)(
        jax.random.PRNGKey(0))), np.random.default_rng(0))
    dp = jax.tree.map(np.asarray, jax.jit(jm.convert)(qat))
    return dict(jm=jm, jdp=jax.tree.map(jnp.asarray, dp),
                tm=tbuild(tbase.get_smoke_config(arch)),
                tdp=bridge.from_jax_params(dp, device="cpu"))


def _engines(arch, cfgs, cf=None):
    """The JAX and port engines of ``cfgs`` = (JAX ServeConfig, port
    ServeConfig) on the arch's smoke params; ``cf`` replaces the
    capacity factor (the params do not depend on it)."""
    m = _models(arch)
    jm, tm = m["jm"], m["tm"]
    if cf is not None:
        jcfg, tcfg = jbase.get_smoke_config(arch), \
            tbase.get_smoke_config(arch)
        jm = jbuild(jcfg.with_(moe=jbase.MoEConfig(**dict(
            vars(jcfg.moe), capacity_factor=cf))))
        tm = tbuild(tcfg.with_(moe=tbase.MoEConfig(**dict(
            vars(tcfg.moe), capacity_factor=cf))))
    return (jengine.ServeEngine(jm, m["jdp"], cfgs[0]),
            tengine.ServeEngine(tm, m["tdp"], cfgs[1], device="cpu"))


TRACE = dict(n_requests=8, mean_prompt=24, max_prompt=60, mean_new=6,
             max_new=10, vocab=256, seed=0)


def _serve_both(arch, spec_k=None):
    """The trace on 4 slots with a shared 32-token system prompt, chunks
    of 32, paged (5 pages of 3 blocks for a full-attention layer, so
    preemptions occur), on the JAX engine and the port's."""
    out = []
    cfgs = [mod.ServeConfig(num_slots=4, cache=mod.CacheConfig(
        max_len=96, paged=True, page_size=32, max_blocks=3, num_pages=5),
        policy=mod.PolicyConfig(prefill_chunk=32),
        spec=mod.SpecConfig(k=spec_k, draft_layers=1))
        for mod in (jengine, tengine)]
    for eng, tr in zip(_engines(arch, cfgs), (jtrace, ttrace)):
        reqs = tr.as_requests(tr.generate_trace(tr.TraceConfig(
            tenants=(tr.TenantSpec("default", system_prompt_len=32),),
            **TRACE)))
        for r in reqs:
            r.arrival_s = 0.0
        out.append(eng.serve(reqs))
    (jres, jrep), (tres, trep) = out
    assert sorted(tres) == sorted(jres) == list(range(TRACE["n_requests"]))
    for rid in jres:
        np.testing.assert_array_equal(tres[rid], np.asarray(jres[rid]),
                                      err_msg=f"rid {rid}")
    keys = [k for k in jrep.keys() if k not in TIMING]
    assert sorted(k for k in trep.keys() if k not in TIMING) == sorted(keys)
    for k in keys:
        assert trep[k] == pytest.approx(jrep[k]), k
    return trep


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_paged_equals_jax(arch):
    rep = _serve_both(arch)
    if arch == "arctic-480b":
        assert rep.preemptions >= 1 and rep.prefix_hits >= 1
    else:
        # one page of 32 a slot holds the ring of 16: nothing to share
        assert rep.preemptions == 0 and rep.prefix_hits == 0
        assert rep.pages_total == 4


@pytest.mark.parametrize("arch", ARCHS)
def test_speculative_serve_equals_jax(arch):
    rep = _serve_both(arch, spec_k=4)
    assert rep.spec_steps >= 1 and rep.spec_accepted >= 1


@pytest.mark.parametrize("arch", ARCHS)
def test_unified_iteration_dropping_matches_jax(arch):
    """Two pooled unified iterations of width 8 on 4 contiguous slots at
    capacity_factor 0.5: first rows 0, 1, 3 prefill (8, 5 and 8 tokens)
    while row 2 is idle; then row 0 continues its prompt, row 1 decodes,
    row 2 stays idle and row 3 decodes.  All 32 rows route (idle and
    padded rows with token 0), so claims are dropped; next tokens of the
    live rows and every cache equal the JAX engine's step."""
    b, width = 4, 8
    cfgs = [mod.ServeConfig(num_slots=b, cache=mod.CacheConfig(max_len=32))
            for mod in (jengine, tengine)]
    jeng, teng = _engines(arch, cfgs, cf=0.5)
    moe = teng.model._block()._ffn()
    assert moe.capacity(b * width) < b * width * moe.top_k / \
        moe.num_experts
    jeng._build_unified(False)
    key, tcaches = teng._pool_caches(b, None)
    jcaches = jeng.model.init_caches(b, 32)
    rng = np.random.default_rng(11)
    prompts = rng.integers(0, 256, (b, 16)).astype(np.int32)
    steps = (([0, 0, 0, 0], [8, 5, 0, 8]), ([8, 5, 0, 8], [8, 1, 0, 1]))
    jkey = jax.random.PRNGKey(0)
    for start, valid in steps:
        start, valid = np.array(start, np.int32), np.array(valid, np.int32)
        toks = np.zeros((b, width), np.int32)
        for r in range(b):
            toks[r, :valid[r]] = prompts[r, start[r]:start[r] + valid[r]]
        fresh = (start == 0) & (valid > 0)
        jnxt, jcaches, jkey = jeng._unified_jit(
            jeng.dparams, jnp.asarray(toks), jcaches, jnp.asarray(start),
            jnp.asarray(valid), jnp.asarray(fresh), jkey)
        t = lambda a: torch.from_numpy(np.asarray(a, np.int64))
        logits = teng._unified_graph(key, tcaches, width)(
            tokens=t(toks), start=t(start), valid=t(valid), fresh=t(fresh))
        live = valid > 0
        np.testing.assert_array_equal(
            logits[:, -1].argmax(-1).numpy()[live],
            np.asarray(jnxt).reshape(b)[live])
        for jc, tc in zip(jcaches, tcaches):
            np.testing.assert_array_equal(_u32(tc["attn"].k_bits),
                                          np.asarray(jc["attn"].k_bits))
            np.testing.assert_array_equal(_u32(tc["attn"].vt_bits),
                                          np.asarray(jc["attn"].vt_bits))
            np.testing.assert_array_equal(tc["attn"].length.numpy(),
                                          np.asarray(jc["attn"].length))


def test_colliding_paged_writes_take_the_last_row():
    """Why a MoE's paged serving is the same on every run.  Capacity
    couples a batch's rows, so rows that prefill a shared prefix page in
    one chunk may compute different bits for it, and free rows, which
    route too, read the trash page.  A chunk where rows 0 and 2 write the
    same page with different bits and row 1 is free, then a decode step
    where row 1 is free: the page holds row 2's bits (the last row, as
    XLA's CPU scatter leaves it), and the trash page stays all zero
    (before, unwritten positions and free rows wrote their bits there, in
    an order no run fixed)."""
    attn = SPSAttention(d_model=64, num_heads=2, num_kv_heads=1,
                        head_dim=32)
    params = attn.convert(attn.init(torch.Generator().manual_seed(2),
                                    "cpu"))
    x = torch.randn(3, 8, 64, generator=torch.Generator().manual_seed(3))

    def chunk(table, valid):
        cache = attn.init_paged_cache(3, ring_len=64, page_size=32,
                                      num_blocks=2, num_pages=4,
                                      device="cpu")
        cache.block_table.copy_(torch.tensor(table, dtype=torch.int32))
        attn.deploy_prefill_chunk(params, x, cache,
                                  start=torch.zeros(3, dtype=torch.int64),
                                  valid_len=torch.tensor(valid))
        return cache

    both = chunk([[1, 2], [0, 0], [1, 3]], [8, 0, 8])
    last = chunk([[0, 0], [0, 0], [1, 3]], [0, 0, 8])
    first = chunk([[1, 2], [0, 0], [0, 0]], [8, 0, 0])
    assert not torch.equal(first.k_pages[1], last.k_pages[1])
    assert torch.equal(both.k_pages[1], last.k_pages[1])
    assert torch.equal(both.vt_pages[1], last.vt_pages[1])
    attn.deploy_decode(params, x[:, :1], both)
    assert both.k_pages[1:].any()
    assert not both.k_pages[0].any() and not both.vt_pages[0].any()
