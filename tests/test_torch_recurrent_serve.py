"""Serving hymba-1.5b's and xlstm-350m's smoke configs in the port against
the JAX package on the CPU, float32.

Held: the static engine (``generate`` of a (B, S) batch) to JAX's jitted
greedy prefill and decode (the JAX engine's static path prefills op by op)
and its ``cache_report`` to JAX's on JAX's caches; continuous serving by
rid on the paged pool (hymba: the attention's ring group of its window,
16 tokens, a page a slot; xlstm: no attention, so no arena), reports
equal, against the JAX engine's; the same trace with ``spec_decode=4``
requested, which both engines decode plainly (the verify cannot leave
recurrent carries unwritten); xlstm on a contiguous pool (its tokens the
paged pool's: it has no attention to page); a second serve on one engine
(the carries go back to their init values at each serve); the admission
guard (no full-attention layer, so no request is capped by the cache) and
the engine's ring groups (none for a layer without attention).  Params
are the JAX package's, scales and thresholds moved off their init values,
bridged through numpy."""
import test_torch_threads  # noqa: F401  (first: one torch thread)
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import base as jbase
from repro.models.attention import PageSpec as JPageSpec
from repro.models.lm import build_model as jbuild
from repro.serve import engine as jengine
from repro.serve import kvcache as jkv
from repro.serve import trace as jtrace
from repro_torch import bridge
from repro_torch.configs import base as tbase
from repro_torch.models.attention import PageSpec as TPageSpec
from repro_torch.models.lm import build_model as tbuild
from repro_torch.serve import engine as tengine
from repro_torch.serve import trace as ttrace

TIMING = ("elapsed_s", "goodput_under_slo", "ttft_p50_s", "ttft_p99_s",
          "tenants")
ARCHS = ("hymba-1.5b", "xlstm-350m")
B, S, NEW = 2, 20, 5
TRACE = dict(n_requests=6, mean_prompt=24, max_prompt=60, mean_new=5,
             max_new=8, vocab=256, seed=0)


def _perturb(tree, rng, name=""):
    if isinstance(tree, dict):
        return {k: _perturb(v, rng, k) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_perturb(v, rng, name) for v in tree]
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
        jax.random.PRNGKey(1))), np.random.default_rng(1))
    dp = jax.tree.map(np.asarray, jax.jit(jm.convert)(qat))
    return dict(jm=jm, jdp=jax.tree.map(jnp.asarray, dp),
                tm=tbuild(tbase.get_smoke_config(arch)),
                tdp=bridge.from_jax_params(dp, device="cpu"))


def _requests(mod, tr):
    reqs = tr.as_requests(tr.generate_trace(tr.TraceConfig(
        tenants=(tr.TenantSpec("default", system_prompt_len=32),),
        **TRACE)))
    for r in reqs:
        r.arrival_s = 0.0
    return reqs


def _config(mod, paged: bool, spec_k=None):
    """3 slots, chunks of 32, a paged pool of 3 blocks over 5 pages (or
    contiguous rings of 96)."""
    return mod.ServeConfig(num_slots=3, cache=mod.CacheConfig(
        max_len=96, paged=paged, page_size=32, max_blocks=3, num_pages=5),
        policy=mod.PolicyConfig(prefill_chunk=32),
        spec=mod.SpecConfig(k=spec_k, draft_layers=1))


@functools.lru_cache(maxsize=None)
def _jax_serve(arch, paged):
    m = _models(arch)
    return jengine.ServeEngine(m["jm"], m["jdp"], _config(
        jengine, paged)).serve(_requests(jengine, jtrace))


def _port_serve(arch, paged, spec_k=None, engine=None):
    m = _models(arch)
    eng = engine or tengine.ServeEngine(m["tm"], m["tdp"], _config(
        tengine, paged, spec_k), device="cpu")
    return eng.serve(_requests(tengine, ttrace))


def _assert_same(got, want):
    (tres, trep), (jres, jrep) = got, want
    assert sorted(tres) == sorted(jres) == list(range(TRACE["n_requests"]))
    for rid in jres:
        np.testing.assert_array_equal(tres[rid], np.asarray(jres[rid]),
                                      err_msg=f"rid {rid}")
    keys = [k for k in jrep.keys() if k not in TIMING]
    assert sorted(k for k in trep.keys() if k not in TIMING) == sorted(keys)
    for k in keys:
        assert trep[k] == pytest.approx(jrep[k]), k


@pytest.mark.parametrize("arch", ARCHS)
def test_static_generate_matches_jax_greedy(arch):
    """The port's static engine (its decode step the captured-step object
    run on the CPU) gives JAX's jitted greedy ids; its report is JAX's
    ``cache_report`` of the caches after the last decode step."""
    m = _models(arch)
    toks = np.random.default_rng(3).integers(0, 256, (B, S)).astype(
        np.int32)
    prefill = jax.jit(functools.partial(m["jm"].prefill_with_cache,
                                        max_len=S + NEW))
    decode = jax.jit(m["jm"].decode_step)
    lg, caches = prefill(m["jdp"], jnp.asarray(toks))
    want = []
    for step in range(NEW):
        tok = jnp.argmax(lg[:, -1], -1).astype(jnp.int32)[:, None]
        want.append(np.asarray(tok))
        if step < NEW - 1:
            lg, caches = decode(m["jdp"], tok, caches)
    eng = tengine.ServeEngine(m["tm"], m["tdp"], tengine.ServeConfig(
        cache=tengine.CacheConfig(max_len=S + NEW)), device="cpu")
    got, rep = eng.generate(toks, max_new_tokens=NEW)
    np.testing.assert_array_equal(got, np.concatenate(want, 1))
    jrep = jkv.cache_report(caches, seq_len=S + NEW, batch=B)
    assert sorted(rep.keys()) == sorted(jrep.keys())
    for k in jrep.keys():
        assert rep[k] == pytest.approx(jrep[k]), k


@pytest.mark.parametrize("arch", ARCHS)
def test_continuous_paged_serve_matches_jax(arch):
    rep = _port_serve(arch, True)[1]
    _assert_same(_port_serve(arch, True), _jax_serve(arch, True))
    if arch == "hymba-1.5b":
        assert rep.pages_total == 3           # a page a slot
    else:
        assert rep.pages_total is None        # no attention, no arena


@pytest.mark.parametrize("arch", ARCHS)
def test_spec_requested_decodes_plainly(arch):
    """``spec_decode=4`` on a recurrent stack: the plain serve's tokens and
    report (no speculative iteration), as the JAX engine gives."""
    got = _port_serve(arch, True, spec_k=4)
    assert got[1].spec_steps == 0 and got[1].spec_drafted is None
    _assert_same(got, _jax_serve(arch, True))


def test_xlstm_contiguous_pool_gives_the_paged_tokens():
    """xlstm has no attention: a contiguous pool serves the paged pool's
    tokens, with the same engine counters."""
    cont, paged = _port_serve("xlstm-350m", False), _port_serve(
        "xlstm-350m", True)
    for rid in paged[0]:
        np.testing.assert_array_equal(cont[0][rid], paged[0][rid])
    for k in ("iterations", "prefill_chunks", "prefill_batches",
              "preemptions", "unified_compiles", "engine_compiles"):
        assert cont[1][k] == paged[1][k], k


@pytest.mark.parametrize("arch", ARCHS)
def test_second_serve_on_one_engine_is_the_first(arch):
    """The engine keeps its pool between serves; each serve puts the
    carries back to their init values (the JAX engine builds fresh
    caches), so a second serve gives the first's tokens and report."""
    m = _models(arch)
    eng = tengine.ServeEngine(m["tm"], m["tdp"], _config(tengine, True),
                              device="cpu")
    first = _port_serve(arch, True, engine=eng)
    pool = next(iter(eng._pools.values()))
    for layer, init in zip(pool, m["tm"].init_caches(3, 96, "cpu")):
        for name in set(layer) & {"mamba", "cell"}:
            assert any(not (a == z).all()
                       for a, z in zip(layer[name], init[name]))
    second = _port_serve(arch, True, engine=eng)
    _assert_same(second, first)
    assert eng._graphs.captures == {"unified": 1, "decode": 1, "spec": 0}


def test_admission_and_ring_groups_match_jax():
    """Neither arch has a full-attention layer, so a request longer than
    the cache is admitted (hymba's windows wrap; xlstm has no cache
    length); the ring groups are JAX's: the window for hymba's layers,
    none for xlstm's."""
    spec = dict(page_size=32, max_blocks=3, num_pages=5)
    for arch in ARCHS:
        m = _models(arch)
        jeng = jengine.ServeEngine(m["jm"], m["jdp"], _config(jengine, True))
        teng = tengine.ServeEngine(m["tm"], m["tdp"], _config(tengine, True),
                                   device="cpu")
        assert teng._layer_rings(TPageSpec(**spec)) == \
            jeng._layer_rings(JPageSpec(**spec))
        long = tengine.Request(rid=0, tokens=np.arange(100, dtype=np.int32)
                               % 256, max_new_tokens=2)
        res, _ = teng.serve([long])
        assert len(res[0]) == 2
    assert teng._layer_rings(TPageSpec(**spec)) == [None] * 4
