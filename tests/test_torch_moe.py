"""The port's ``BinaryMoE`` deploy face and expert-stacked ``BinaryFFN``
against the JAX package on the CPU, module by module.

Held: the routing (expert ids, slots, keep masks and capacity equal; gates
within 1e-6); ``apply_deploy`` dropless and dropping (repeated rows claim
the same experts, so some claims overflow), with fp rows and with packed
bits dispatched (rows whose words have bit 31 set, which a max over int32
words would lose), with and without the dense residual, in float32 and
bf16; the expert-by-expert ``convert`` (packed words bitwise); router ties
(the lowest expert index ranks first, as ``lax.top_k``); the refusal of
ReLU experts; the bridge's (L, E, ...) expert leaves.  Params
are the JAX package's, scales and thresholds moved off their init values,
bridged through numpy."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.ffn import BinaryFFN as JFFN
from repro.models.ffn import BinaryMoE as JMoE
from repro.models.linear import act_bits_packed as jbits
from repro_torch import bridge
from repro_torch.models.ffn import BinaryFFN as TFFN
from repro_torch.models.ffn import BinaryMoE as TMoE

D, FF, E = 64, 128, 4
GATE_ATOL = 1e-6
ATOL = 1e-4


def _perturb(tree, rng, name=""):
    if isinstance(tree, dict):
        return {k: _perturb(v, rng, k) for k, v in tree.items()}
    a = np.array(tree)
    if name.endswith("_alpha"):
        return (a * rng.uniform(0.5, 1.5, a.shape)).astype(np.float32)
    if name.endswith("_beta"):
        return (a + 0.1 * rng.standard_normal(a.shape)).astype(np.float32)
    return a


@pytest.fixture(scope="module")
def params():
    """One deploy tree per (dense_residual): the JAX init, perturbed,
    converted; the JAX and port copies."""
    out = {}
    for dr in (False, True):
        jm = JMoE(D, FF, E, dense_residual=dr)
        p = _perturb(jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(3))),
                     np.random.default_rng(3))
        dp = jax.tree.map(np.asarray, jm.convert(p))
        out[dr] = (jax.tree.map(jnp.asarray, dp),
                   bridge.from_jax_params(dp, device="cpu"))
    return out


def _rows(n, repeat=1, seed=5):
    """(n, D) float32 rows; ``repeat`` > 1 tiles n // repeat distinct rows,
    so equal rows claim equal experts and overflow their capacity."""
    x = np.random.default_rng(seed).standard_normal(
        (n // repeat, D)).astype(np.float32)
    return np.tile(x, (repeat, 1))


def _pair(cf, dr=False, bits=False, dtype="float32"):
    kw = dict(top_k=2, capacity_factor=cf, dense_residual=dr,
              dispatch_bits=bits)
    return (JMoE(D, FF, E, dtype=getattr(jnp, dtype), **kw),
            TMoE(D, FF, E, dtype=getattr(torch, dtype), **kw))


@pytest.mark.parametrize("cf,repeat", [(2.0, 1), (0.5, 8)],
                         ids=["dropless", "dropping"])
def test_route_matches_jax(params, cf, repeat):
    jp, tp = params[False]
    jm, tm = _pair(cf)
    x = _rows(48, repeat)
    jg, ji, js, jk, jcap = jm._route(jp, jnp.asarray(x))
    tg, ti, ts, tk, tcap = tm._route(tp, torch.from_numpy(x))
    assert tcap == jcap == tm.capacity(48)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=GATE_ATOL,
                               rtol=0)
    assert tk.all() if cf == 2.0 else (~tk).sum() > 0


@pytest.mark.parametrize("dr", [False, True], ids=["moe", "residual"])
@pytest.mark.parametrize("bits", [False, True], ids=["fp", "bits"])
@pytest.mark.parametrize("cf,repeat", [(2.0, 1), (0.5, 4)],
                         ids=["dropless", "dropping"])
def test_apply_deploy_matches_jax(params, dr, bits, cf, repeat):
    """(2, 16, D) rows; in the dropping case 4 copies of 8 distinct rows
    under a capacity of 8 slots for 64 claims."""
    jp, tp = params[dr]
    jm, tm = _pair(cf, dr, bits)
    x = _rows(32, repeat).reshape(2, 16, D)
    words = jbits(jnp.asarray(x.reshape(-1, D)), jp["experts"]["act_beta"])
    assert (np.asarray(words) >> 31).any()      # bit 31 set in some words
    _, idx, slot, keep, cap = tm._route(tp,
                                        torch.from_numpy(x.reshape(-1, D)))
    assert keep.all() == (cf == 2.0)
    if bits:
        # the dispatched words keep bit 31 (int32 words below zero)
        tw = torch.from_numpy(np.array(words).view(np.int32))
        buf = tm._dispatch(tw, idx, slot, keep, cap)
        assert buf.shape == (E, cap, 2) and (buf < 0).any()
    jy = jm.apply_deploy(jp, jnp.asarray(x))
    ty = tm.apply_deploy(tp, torch.from_numpy(x))
    assert ty.shape == x.shape and ty.dtype == torch.float32
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=ATOL, rtol=0)


def test_apply_deploy_bf16_matches_jax(params):
    """bf16 rows, experts and residual (the full-width configs' dtype),
    dropping, bits dispatched: the expert outputs are rounded to bf16
    before the float32 combine in both packages; held to op-by-op JAX
    within one bf16 ulp of the outputs."""
    jp, tp = params[True]
    jm, tm = _pair(0.5, True, True, "bfloat16")
    x = _rows(32, 4).reshape(2, 16, D)
    jy = np.asarray(jm.apply_deploy(jp, jnp.asarray(x, jnp.bfloat16)),
                    np.float32)
    ty = tm.apply_deploy(tp, torch.from_numpy(x).to(torch.bfloat16))
    assert ty.dtype == torch.bfloat16
    np.testing.assert_allclose(ty.float().numpy(), jy,
                               atol=np.abs(jy).max() * 2 ** -7, rtol=0)
    assert (ty.float().numpy() == jy).mean() > 0.95


def test_expert_convert_matches_jax():
    """The expert-by-expert convert of the port against JAX's vmapped
    convert: packed words bitwise, scales equal, activation scales shared
    (scalars); the port's own init draws E experts on a leading axis."""
    jf = JFFN(D, FF, num_experts=E)
    tf = TFFN(D, FF, num_experts=E)
    p = jax.tree.map(np.asarray, jf.init(jax.random.PRNGKey(4)))
    jd = jax.tree.map(np.asarray, jf.convert(p))
    td = tf.convert(bridge.from_jax_params(p, device="cpu"))
    for name in ("w1", "w2", "w3"):
        np.testing.assert_array_equal(
            td[name]["w_packed"].numpy().view(np.uint32),
            jd[name]["w_packed"])
        np.testing.assert_array_equal(td[name]["alpha_w"].numpy(),
                                      jd[name]["alpha_w"])
    assert td["w1"]["w_packed"].shape == (E, FF, D // 32)
    assert td["w2"]["w_packed"].shape == (E, D, FF // 32)
    own = tf.init(torch.Generator().manual_seed(0), "cpu")
    assert own["w1"]["w_latent"].shape == (E, D, FF)
    assert own["w2"]["alpha_w"].shape == (E, D)
    assert own["act_alpha"].shape == ()
    assert not torch.equal(own["w1"]["w_latent"][0], own["w1"]["w_latent"][1])


def test_router_ties_take_the_lowest_index(params):
    """A router whose columns repeat: experts {0, 2} and {1, 3} score the
    same for every row, so the top-2 of each row is a tie broken by
    index.  JAX's ``lax.top_k`` keeps the lower index; so does the
    port."""
    jp, tp = params[False]
    kern = np.asarray(jp["router"]["kernel"]).copy()
    kern[:, 2] = kern[:, 0]
    kern[:, 3] = kern[:, 1]
    jp = dict(jp, router={"kernel": jnp.asarray(kern)})
    tp = dict(tp, router={"kernel": torch.from_numpy(kern)})
    jm, tm = _pair(2.0)
    x = _rows(16)
    _, ji, _, _, _ = jm._route(jp, jnp.asarray(x))
    _, ti, _, _, _ = tm._route(tp, torch.from_numpy(x))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    best = np.where(x @ kern[:, 0] >= x @ kern[:, 1], 0, 1)
    np.testing.assert_array_equal(ti[:, 0].numpy(), best)
    np.testing.assert_array_equal(ti[:, 1].numpy(), best + 2)


def test_expert_stacked_relu_ffn_is_not_ported():
    """No config runs ReLU experts: the port refuses an expert-stacked
    ReLU FFN (and a MoE of them) by name, and keeps its plain ReLU FFN."""
    for build in (lambda: TFFN(D, FF, act="relu", glu=False, num_experts=E),
                  lambda: TMoE(D, FF, E, act="relu", glu=False)._experts()):
        with pytest.raises(NotImplementedError, match="not ported yet"):
            build()
    assert TFFN(D, FF, act="relu", glu=False).num_experts == 0


def test_bridge_splits_expert_leaves_by_layer():
    """A model tree's ``blocks`` hold expert leaves as (L, E, ...): the
    bridge gives each layer its (E, ...) stack, words as int32 with
    their bits."""
    w = np.arange(2 * E * 3 * 2, dtype=np.uint32).reshape(2, E, 3, 2)
    w[1, 2, 0, 1] = 0x80000001
    tree = {"blocks": {"ffn": {
        "router": {"kernel": np.ones((2, D, E), np.float32)},
        "experts": {"w1": {"w_packed": w,
                           "alpha_w": np.ones((2, E, 3), np.float32)},
                    "act_alpha": np.ones((2,), np.float32)}}}}
    out = bridge.from_jax_params(tree, device="cpu")["blocks"]
    assert len(out) == 2
    for i, layer in enumerate(out):
        ex = layer["ffn"]["experts"]
        assert ex["w1"]["w_packed"].shape == (E, 3, 2)
        assert ex["w1"]["w_packed"].dtype == torch.int32
        np.testing.assert_array_equal(
            ex["w1"]["w_packed"].numpy().view(np.uint32), w[i])
        assert ex["act_alpha"].shape == ()
        assert layer["ffn"]["router"]["kernel"].shape == (D, E)
