"""The recurrent blocks of the port (``repro_torch.models.ssm``) against the
JAX package's on the CPU: ``MambaBlock`` (d = 64, state 4, conv 4, expand
2), ``MLSTMBlock`` (2 heads of 64) and ``SLSTMBlock`` (d_inner 128), float32.

Held, for each block: the whole-sequence deploy face (``apply`` with
``return_state``), a ragged right-padded batch (``seq_lens``), a resumed
chunk (``state=``, a row of length 0 among them) and ``decode_step``
from a carry; the ``init_cache`` carries bitwise; and, at ``Block``
level, that a chunk updates the caches' carry tensors in place and leaves
an inactive row's (valid length 0) bit for bit.  Outputs are the binary
out projections' (integer scores times the scales), carries fp: both
within ATOL + RTOL * |JAX| (the frameworks sum the conv taps, the state
contraction and the cell updates in other orders, and XLA may fuse a
multiply-add).  Params are the JAX package's, the activation scales moved
off their init values, bridged through numpy."""
import test_torch_threads  # noqa: F401  (first: one torch thread)
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.models import ssm as jssm
from repro.models.blocks import Block as JBlock
from repro_torch import bridge
from repro_torch.configs import base as tbase
from repro_torch.models import ssm as tssm
from repro_torch.models.blocks import Block as TBlock

ATOL, RTOL = 1e-4, 1e-5
D, B, L = 64, 3, 9
KINDS = ("mamba", "mlstm", "slstm")


def _perturb(tree, rng, name=""):
    if isinstance(tree, dict):
        return {k: _perturb(v, rng, k) for k, v in tree.items()}
    a = np.array(tree)
    if name.endswith("_alpha"):
        return (a * rng.uniform(0.5, 1.5, a.shape)).astype(np.float32)
    if name.endswith("_beta"):
        return (a + 0.1 * rng.standard_normal(a.shape)).astype(np.float32)
    return a


@functools.lru_cache(maxsize=None)
def _blocks(kind):
    """(JAX block, its deploy params, port block, the port's params)."""
    jb, tb = {
        "mamba": (jssm.MambaBlock(D, state_size=4),
                  tssm.MambaBlock(D, state_size=4)),
        "mlstm": (jssm.MLSTMBlock(D, 2), tssm.MLSTMBlock(D, 2)),
        "slstm": (jssm.SLSTMBlock(D), tssm.SLSTMBlock(D)),
    }[kind]
    qat = _perturb(jax.tree.map(np.asarray, jax.jit(jb.init)(
        jax.random.PRNGKey(3))), np.random.default_rng(3))
    dp = jax.tree.map(np.asarray, jax.jit(jb.convert)(qat))
    return jb, jax.tree.map(jnp.asarray, dp), tb, \
        bridge.from_jax_params(dp, device="cpu")


@functools.lru_cache(maxsize=None)
def _jit(kind, face, **static):
    """The JAX block's face, jitted once for the file (``static`` bound)."""
    return jax.jit(functools.partial(getattr(_blocks(kind)[0], face),
                                     **static))


def _x(seed, length=L, batch=B):
    return np.random.default_rng(seed).standard_normal(
        (batch, length, D)).astype(np.float32)


def _close(t, j, what):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=ATOL,
                               rtol=RTOL, err_msg=what)


def _close_carry(tc, jc, what):
    assert type(tc).__name__ == type(jc).__name__
    for name, t, j in zip(tc._fields, tc, jc):
        assert t.shape == tuple(j.shape) and t.dtype == torch.float32
        _close(t, j, f"{what} {name}")


def _state(kind, seed):
    """A carry after a first chunk of 5 tokens, from the JAX block (both
    sides resume from the same numbers)."""
    jdp = _blocks(kind)[1]
    _, jc = _jit(kind, "apply", deploy=True, return_state=True)(
        jdp, jnp.asarray(_x(seed, 5)))
    return jc, type(_blocks(kind)[2].init_cache(1, "cpu"))(
        *[torch.from_numpy(np.array(a)) for a in jc])


@pytest.mark.parametrize("kind", KINDS)
def test_apply_whole_matches_jax(kind):
    _, jdp, tb, tdp = _blocks(kind)
    x = _x(1)
    jo, jc = _jit(kind, "apply", deploy=True, return_state=True)(
        jdp, jnp.asarray(x))
    with torch.inference_mode():
        to, tc = tb.apply(tdp, torch.from_numpy(x), deploy=True,
                          return_state=True)
    _close(to, jo, f"{kind} out")
    _close_carry(tc, jc, kind)


@pytest.mark.parametrize("kind", KINDS)
def test_apply_ragged_matches_jax(kind):
    """Right-padded rows of 9, 4 and 1 tokens: each carry freezes at its
    row's length (the conv tail read there)."""
    _, jdp, tb, tdp = _blocks(kind)
    x, lens = _x(2), np.array([L, 4, 1], np.int32)
    jo, jc = _jit(kind, "apply", deploy=True, return_state=True)(
        jdp, jnp.asarray(x), seq_lens=jnp.asarray(lens))
    with torch.inference_mode():
        to, tc = tb.apply(tdp, torch.from_numpy(x), deploy=True,
                          return_state=True, seq_lens=torch.from_numpy(lens))
    live = np.arange(L)[None, :] < lens[:, None]
    np.testing.assert_allclose(to.numpy()[live], np.asarray(jo)[live],
                               atol=ATOL, rtol=RTOL)
    _close_carry(tc, jc, kind)


@pytest.mark.parametrize("kind", KINDS)
def test_apply_resumed_matches_jax(kind):
    """A second chunk resumes the carry of a first (``state=``); row 1 is
    inactive (length 0) and keeps its carry bit for bit."""
    _, jdp, tb, tdp = _blocks(kind)
    jst, tst = _state(kind, 4)
    x, lens = _x(5, 6), np.array([6, 0, 3], np.int32)
    jo, jc = _jit(kind, "apply", deploy=True, return_state=True)(
        jdp, jnp.asarray(x), seq_lens=jnp.asarray(lens), state=jst)
    with torch.inference_mode():
        to, tc = tb.apply(tdp, torch.from_numpy(x), deploy=True,
                          return_state=True, seq_lens=torch.from_numpy(lens),
                          state=tst)
    live = np.arange(6)[None, :] < lens[:, None]
    np.testing.assert_allclose(to.numpy()[live], np.asarray(jo)[live],
                               atol=ATOL, rtol=RTOL)
    _close_carry(tc, jc, kind)
    for t, t0 in zip(tc, tst):
        assert torch.equal(t[1], t0[1])


@pytest.mark.parametrize("kind", KINDS)
def test_decode_step_matches_jax(kind):
    _, jdp, tb, tdp = _blocks(kind)
    jst, tst = _state(kind, 6)
    x = _x(7, 1)
    jo, jc = _jit(kind, "decode_step")(jdp, jnp.asarray(x), jst)
    with torch.inference_mode():
        to, tc = tb.decode_step(tdp, torch.from_numpy(x), tst)
    assert to.shape == (B, 1, D)
    _close(to, jo, f"{kind} out")
    _close_carry(tc, jc, kind)


def test_init_cache_values_match_jax():
    """Not zeros everywhere: the stabilizers start at -1e9 and sLSTM's
    normalizer at 1e-6, bitwise as JAX's; ``init_values`` says so."""
    for kind in KINDS:
        jb, _, tb, _ = _blocks(kind)
        jc, tc = jb.init_cache(2), tb.init_cache(2, "cpu")
        for t, j, v in zip(tc, jc, tb.init_values()):
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))
            assert (t == v).all()


@pytest.mark.parametrize("arch,kind", [("hymba-1.5b", "hybrid"),
                                       ("xlstm-350m", "mlstm"),
                                       ("xlstm-350m", "slstm")])
def test_block_chunk_updates_carries_in_place(arch, kind):
    """``Block.deploy_prefill_chunk`` copies the new carries into the
    cache's own tensors (same storage) and returns the cache given; a row
    of valid length 0 keeps every carry bit for bit; the live rows'
    carries equal the JAX block's chunk face."""
    jcfg, tcfg = jbase.get_smoke_config(arch), tbase.get_smoke_config(arch)
    jblk, tblk = JBlock(jcfg, kind=kind), TBlock(tcfg, kind=kind)
    qat = _perturb(jax.tree.map(np.asarray, jax.jit(jblk.init)(
        jax.random.PRNGKey(8))), np.random.default_rng(8))
    dp = jax.tree.map(np.asarray, jax.jit(jblk.convert)(qat))
    tdp = bridge.from_jax_params(dp, device="cpu")
    name = "mamba" if kind == "hybrid" else "cell"
    x = np.random.default_rng(9).standard_normal(
        (B, 5, tcfg.d_model)).astype(np.float32)
    start, lens = np.zeros(B, np.int32), np.array([5, 0, 2], np.int32)
    jcache = jblk.init_cache(B, 16)
    jx, jnew = jax.jit(jblk.deploy_prefill_chunk)(
        jax.tree.map(jnp.asarray, dp), jnp.asarray(x), jcache,
        start=jnp.asarray(start), valid_len=jnp.asarray(lens))
    with torch.inference_mode():
        cache = tblk.init_cache(B, 16, "cpu")
        before = [t.clone() for t in cache[name]]
        ptrs = [t.data_ptr() for t in cache[name]]
        tx, out = tblk.deploy_prefill_chunk(
            tdp, torch.from_numpy(x), cache, start=torch.from_numpy(start),
            valid_len=torch.from_numpy(lens))
    assert out is cache
    assert [t.data_ptr() for t in cache[name]] == ptrs
    for t, t0 in zip(cache[name], before):
        assert torch.equal(t[1], t0[1])
    _close_carry(cache[name], jnew[name], f"{arch} {kind}")
    live = np.arange(5)[None, :] < lens[:, None]
    np.testing.assert_allclose(tx.numpy()[live], np.asarray(jx)[live],
                               atol=ATOL, rtol=RTOL)
