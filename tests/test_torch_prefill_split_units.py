"""Units of the mesh prefill split along "model", in one process: the
plain versions on the CPU, or the dry run's ``AbstractMesh`` on the meta
device.

* ``rbmm_int_dense``, the integer product of unpacked values the RBMM
  kernels are held to, equals the JAX package's on seeded +-1 and {0, 1}
  values, and ``rbmm_int`` of their packed words.
* The split rule (``sharding.prefill_split``): blocks of whole 32-bit
  words, any length on an axis of one; the blocks a mesh prefill splits
  (``Block.splits_prefill``) and the stacks it leaves whole.
* ``SPSAttention._attend_span`` on every rank's query heads (a span
  starting or ending inside a KV group, an empty one; the ``row`` table
  sliced to the rank's heads, a window, bidirectional) equals those heads
  of the one-device ``sps_attention_gqa`` call, bitwise.
* At full width on the single-pod mesh the embedding and the head take
  vocabulary blocks for qwen, gemma, internvl2 and seamless, whole tables
  for smollm and granite; the logits' placement names the block.
* The census of granite's smoke prefill at (1, 4): a quarter of (1, 1)'s
  ``rbmm_mxu`` and ``sps_attention`` work, the all-to-alls named by their
  sites, the kernels' operands contiguous (the meta route checks it).
* What a split cannot run raises; on one rank the exchanges give their
  input back."""
import test_torch_threads  # noqa: F401  (first: one torch thread)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rbmm import ref as jref
from repro_torch.configs import base
from repro_torch.core import packing, rbmm
from repro_torch.kernels.rbmm import ref
from repro_torch.kernels.sps_attn import ops as sps_ops
from repro_torch.launch import cost, mesh as mesh_lib, specs
from repro_torch.models import sharding
from repro_torch.models.attention import SPSAttention
from repro_torch.models.blocks import Block
from repro_torch.models.lm import EncDecModel, _OnMesh, build_model

META = torch.device("meta")


@pytest.mark.parametrize("signed", [True, False], ids=["pm1", "01"])
def test_rbmm_int_dense_equals_jax_and_rbmm_int(signed):
    rng = np.random.default_rng(0)
    a = rng.integers(0, 2, (7, 97)).astype(np.float32)
    b = rng.integers(0, 2, (5, 97)).astype(np.float32)
    if signed:
        a, b = 2 * a - 1, 2 * b - 1
    got = ref.rbmm_int_dense(torch.from_numpy(a), torch.from_numpy(b))
    want = np.asarray(jref.rbmm_int_dense(jnp.asarray(a), jnp.asarray(b)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    if signed:      # the xnor product of the packed signs
        wa, wb = (packing.pack_bits(torch.from_numpy(t) > 0) for t in (a, b))
        assert torch.equal(rbmm.rbmm_int(wa, wb, 97, scheme="xnor"), got)


def test_the_split_rule_takes_whole_word_blocks():
    for shape, n, split in (((1, 1), 100, True), ((2, 4), 128, True),
                            ((2, 4), 64, False), ((1, 4), 100, False),
                            ((16, 16), 32768, True), ((1, 16), 768, False)):
        mesh = mesh_lib.AbstractMesh(shape, ("data", "model"))
        got = sharding.prefill_split(mesh, n)
        assert (got is not None) == split, (shape, n)
        if got is not None:
            assert got.seq and got.width == shape[1]
            assert sharding.held(n, got) == (0, n // shape[1])


def test_the_blocks_a_prefill_splits():
    for arch, split in (("smollm-135m", True), ("gemma3-27b", True),
                        ("bert-base-cobra", True), ("mixtral-8x22b", True),
                        ("arctic-480b", True), ("hymba-1.5b", False),
                        ("xlstm-350m", False)):
        cfg = base.get_smoke_config(arch)
        model = build_model(cfg)
        mesh = mesh_lib.AbstractMesh((1, 4), ("data", "model"))
        on = _OnMesh(mesh, torch.empty((2, 128), device=META))
        blocks = model._blocks() if not isinstance(model, EncDecModel) \
            else [model._enc_block(), model._dec_block()]
        assert (on.prefill_split([128], blocks) is not None) == split, arch
    dec = build_model(base.get_smoke_config("seamless-m4t-large-v2"))
    on = _OnMesh(mesh_lib.AbstractMesh((1, 4), ("data", "model")),
                 torch.empty((2, 128), device=META))
    blocks = [dec._enc_block(), dec._dec_block()]
    assert on.prefill_split([128, 128], blocks) is not None
    assert on.prefill_split([100, 128], blocks) is None


def _attention_case(h, hkv, granularity, gen):
    dh, b, length = 64, 2, 64
    attn = SPSAttention(d_model=64, num_heads=h, num_kv_heads=hkv,
                        head_dim=dh, sps_granularity=granularity)
    w = packing.packed_len(dh)
    q = torch.randint(-2**31, 2**31 - 1, (b, h, length, w), generator=gen,
                      dtype=torch.int32)
    k = torch.randint(-2**31, 2**31 - 1, (b, hkv, length, w), generator=gen,
                      dtype=torch.int32)
    vt = torch.randint(-2**31, 2**31 - 1, (b, hkv, dh, length // 32),
                       generator=gen, dtype=torch.int32)
    cols = (h, 512) if granularity == "row" else (h,)
    theta = torch.randint(-8, 9, cols, generator=gen, dtype=torch.int32)
    return attn, q, k, vt, theta


@pytest.mark.parametrize("h,hkv,m,granularity,causal,window", [
    (9, 3, 2, "head", True, 0),      # a span ending inside a KV group
    (9, 3, 4, "row", True, 0),       # spans inside groups, the row table
    (9, 3, 16, "head", True, 24),    # one head a rank, 7 empty; a window
    (8, 2, 4, "row", False, 0),      # whole groups, bidirectional
    (6, 6, 4, "head", True, 0),      # MHA, uneven spans
])
def test_attend_span_equals_the_whole_call(h, hkv, m, granularity, causal,
                                           window):
    attn, q, k, vt, theta = _attention_case(h, hkv, granularity,
                                            torch.Generator().manual_seed(h))
    whole = sps_ops.sps_attention_gqa(q, k, vt, theta, d_h=64,
                                      causal=causal, window=window)
    qs, kvs = attn.head_ranges(sharding.Split(0, m))
    for (h0, h1), (k0, k1) in zip(qs, kvs):
        got = attn._attend_span(q[:, h0:h1], k[:, k0:k1], vt[:, k0:k1],
                                theta[h0:h1], (h0, h1), k0, causal=causal,
                                window=window)
        assert torch.equal(got, whole[:, h0:h1]), (h0, h1)


def test_vocabulary_blocks_at_full_width():
    """prefill_32k on the single-pod mesh, a rank's 2 rows: the tables
    gathered whole (embedding, and an untied head) against the lookup
    reduce-scattered and the final stream all-gathered in bf16."""
    mesh = mesh_lib.make_production_mesh()
    on = _OnMesh(mesh, torch.empty((2, 32768), device=META))
    for arch, blocks in (("qwen1.5-32b", True), ("gemma3-27b", True),
                         ("internvl2-76b", True),
                         ("seamless-m4t-large-v2", True),
                         ("smollm-135m", False), ("granite-3-2b", False)):
        cfg = base.get_config(arch)
        dp = specs.deploy_param_specs(build_model(cfg), mesh)
        assert on.vocab_blocks(dp, 2, 32768, cfg.d_model,
                               torch.bfloat16) == blocks, arch


def _prefill_trace(arch, shape, n=128, batch=4, **over):
    """(census, logits) of ``arch``'s smoke ``prefill_logits`` at ``n``
    positions traced on an ``AbstractMesh`` of ``shape``."""
    cfg = base.get_smoke_config(arch).with_(**over)
    model = build_model(cfg)
    mesh = mesh_lib.AbstractMesh(shape, ("data", "model"))
    dp = specs.deploy_param_specs(model, mesh)
    f = cfg.frontend_tokens
    batch_pl = specs._shard_batch_dim(mesh, {
        "t": torch.empty((batch, n - f), dtype=torch.int32, device=META),
        "f": torch.empty((batch, f or 1, model.frontend_dim), device=META)},
        batch)

    def step(d, t, fe):
        kw = {"frontend_embeds": fe} if f else {}
        return model.prefill_logits(d, t, mesh=mesh, **kw)
    return cost.measure(step, (dp, batch_pl["t"], batch_pl["f"]))


def _ops(census, name):
    return sum(census.kernels[name]["ops"].values())


def test_granite_census_splits_the_work():
    split, _ = _prefill_trace("granite-3-2b", (1, 4))
    one, _ = _prefill_trace("granite-3-2b", (1, 1))
    for name in ("rbmm_mxu", "sps_attention"):
        assert 4 * _ops(split, name) == _ops(one, name), name
    sites = {k.split(" ", 1)[1] for k in split.sites}
    assert "blocks._prefill_split > attention._prefill_heads" in sites
    assert "blocks._prefill_split > attention._prefill_output" in sites
    assert one.collectives == {k: 0 for k in one.collectives}
    # per layer: the heads in, the context out
    layers = base.get_smoke_config("granite-3-2b").num_layers
    assert sum(k.startswith("all-to-all") for k in split.sites) == 2
    assert split.launches()["sps_attention"] == layers


def test_the_logits_carry_their_block():
    """On (2, 4): rows over "data", and the positions (whole tables) or
    the padded vocabulary (blocks) over "model"; the whole route's rows
    alone.  internvl2's frontend patches count among the 128 positions."""
    for arch, over, dim, vocab in (
            ("smollm-135m", {}, 1, 256),
            ("qwen1.5-32b", {"vocab_size": 4096}, 2, 4096),
            ("internvl2-76b", {}, 1, 256), ("mixtral-8x22b", {}, 1, 256),
            ("hymba-1.5b", {}, None, 256)):
        _, lg = _prefill_trace(arch, (2, 4), **over)
        pl = mesh_lib.placement_of(lg)
        assert pl.dims.get("data") == 0 and pl.dims.get("model") == dim
        assert pl.shape == (4, 128, vocab), arch


def _raises_hybrid():
    blk = Block(base.get_smoke_config("hymba-1.5b"), kind="hybrid")
    blk.deploy_prefill({}, torch.zeros(1, 32, 128),
                       split=sharding.Split(0, 1, None, True))


def _raises_cache():
    blk = Block(base.get_smoke_config("smollm-135m"))
    blk.deploy_prefill({}, torch.zeros(1, 32, 96), cache_size=32,
                       split=sharding.Split(0, 1, None, True))


def _raises_half_words():
    attn = SPSAttention(d_model=96, num_heads=2, num_kv_heads=2,
                        head_dim=48)
    attn._split_heads(sharding.Split(0, 2, None, True))


@pytest.mark.parametrize("case", [_raises_hybrid, _raises_cache,
                                  _raises_half_words],
                         ids=lambda f: f.__name__[8:])
def test_what_a_split_cannot_run_raises(case):
    with pytest.raises(ValueError, match="split prefill"):
        case()


def test_one_rank_exchanges_give_their_input_back():
    one = sharding.Split(0, 1, None, True)
    q = torch.arange(2 * 3 * 32 * 2, dtype=torch.int32).reshape(2, 3, 32, 2)
    got, = sharding.to_heads([(q, [(0, 3)], 2)], one)
    assert got is q
    words = torch.arange(2 * 32 * 6, dtype=torch.int32).reshape(2, 32, 6)
    assert sharding.heads_to_rows(words, one, [(0, 6)]) is words
