"""The MoE on a mesh piece by piece, in one process: the slots from
per-segment counts (``BinaryMoE._slots``, ``sharding.claim_offsets``)
against the global batch's one-hot cumsum, on simulated meshes (each
rank's call made in turn, its all-gather answered with every rank's
counts); the rank's buffer; the expert groups of the deploy face against
the whole buffer; the router's fixed row blocks; the routes the QAT face
and the prefill take, and their census on the dry run's ``AbstractMesh``.

Everything here is exact: slots, keeps and the grouped outputs bitwise."""
import test_torch_threads  # noqa: F401  (first: one torch thread)
import dataclasses

import pytest
import torch

from repro_torch.configs import base
from repro_torch.launch import cost, mesh as mesh_lib, specs
from repro_torch.models import ffn, sharding
from repro_torch.models.ffn import BinaryFFN, BinaryMoE
from repro_torch.models.lm import _OnMesh, build_model
from repro_torch.optim.adamw import AdamW
from repro_torch.train.trainer import Trainer, TrainerConfig

META = torch.device("meta")
# (experts, top-k) of the slot cases; each runs B_r in {1, 3}, 1 to 4
# blocks of the sequence, 1 or 2 data indices, and a dropping and a
# dropless capacity factor
SLOTS = [(4, 1), (4, 2), (16, 1), (16, 2)]
S = 12


class _Rank:
    """Rank (i, r) of a simulated (d, m) ("data", "model") mesh: its
    all-gather gives every rank's claims (``every[(i, r)]``: its per-segment
    counts and its claims' experts) over the axes asked, in their
    row-major order: the counts, or the experts where those are fewer
    numbers (as ``sharding.claim_offsets`` sends them)."""

    def __init__(self, d: int, m: int, i: int, r: int, every: dict):
        self.shape = {"data": d, "model": m}
        self.axis_names = ("data", "model")
        self.data_size, self.data_index, self._r = d, i, r
        self.every = every

    def index(self, axis: str) -> int:
        return self._r if axis == "model" else self.data_index

    def all_gather(self, x, axes, dim):
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        ii = range(self.shape["data"]) if "data" in axes else \
            [self.data_index]
        rr = range(self.shape["model"]) if "model" in axes else [self._r]
        counts, ids = self.every[(self.data_index, self._r)]
        pick = int(ids.numel() < counts.numel())
        assert x.shape == (counts, ids)[pick].shape
        return torch.cat([self.every[(i, r)][pick] for i in ii for r in rr],
                         dim)

    def all_reduce(self, x, axes):
        raise AssertionError("the slots need no sum")


def _global(moe: BinaryMoE, idx: torch.Tensor):
    """The one-device slots and keeps of ``idx`` (B, S, k)."""
    slot, keep, cap = moe._slots(idx.reshape(-1, moe.top_k))
    return slot.reshape(idx.shape), keep.reshape(idx.shape), cap


def _rank_idx(idx, d, m, i, r):
    b_r = idx.shape[0] // d
    blk = idx.shape[1] // m
    return idx[i * b_r:(i + 1) * b_r, r * blk:(r + 1) * blk]


@pytest.mark.parametrize("e,k", SLOTS, ids=lambda v: str(v))
def test_slots_from_counts_equal_the_global_cumsum(e, k):
    """Random claims (distinct experts a token) of a global batch of
    B_r x d rows, split over d data indices and m blocks of the sequence:
    each rank's global slots (its place among its claims plus its
    segment's offset) and keeps equal the one-device cumsum's at its
    claims; its buffer rows (its place among its own claims) hold every
    kept claim once, below min(n, C)."""
    gen = torch.Generator().manual_seed(e * 10 + k)
    for b_r in (1, 3):
        for d in (1, 2):
            for m in (1, 2, 3, 4):
                for cf in (0.3, 2.0 * e / k):
                    moe = BinaryMoE(d_model=8, d_ff=8, num_experts=e,
                                    top_k=k, capacity_factor=cf)
                    idx = torch.stack([torch.randperm(e, generator=gen)[:k]
                                       for _ in range(d * b_r * S)])
                    idx = idx.reshape(d * b_r, S, k)
                    want, want_keep, cap = _global(moe, idx)
                    assert bool(want_keep.all()) == (cf > 1)
                    counts = {}
                    for i in range(d):
                        for r in range(m):
                            mine = _rank_idx(idx, d, m, i, r)
                            oh = torch.nn.functional.one_hot(mine, e)
                            counts[(i, r)] = (oh.sum((1, 2)).to(torch.int32),
                                              mine.reshape(1, -1).to(
                                                  torch.int32))
                    for i in range(d):
                        for r in range(m):
                            mesh = _Rank(d, m, i, r, counts)
                            split = sharding.Split(r, m, mesh, True) \
                                if m > 1 else sharding.WHOLE
                            mine = _rank_idx(idx, d, m, i, r)
                            flat = mine.reshape(-1, k)
                            with sharding.activation_sharding(mesh,
                                                              ("data",)):
                                slot, keep, rows = moe._slots(flat, split,
                                                              b_r)
                                off = sharding.claim_offsets(
                                    counts[(i, r)][0], split, flat)
                            case = (b_r, d, m, cf, i, r)
                            if d * m == 1:
                                assert off is None and rows == cap, case
                                off = torch.zeros(b_r, e, dtype=torch.int32)
                            else:
                                assert rows == min(flat.shape[0], cap), case
                            first = torch.gather(off, 1, mine.reshape(
                                b_r, -1)).reshape(slot.shape)
                            assert torch.equal(
                                slot + first,
                                _rank_idx(want, d, m, i, r).reshape(-1, k)
                            ), case
                            assert torch.equal(keep, _rank_idx(
                                want_keep, d, m, i, r).reshape(-1, k)), case
                            rows_kept = (flat * rows + slot)[keep]
                            assert bool((slot[keep] < rows).all()), case
                            assert rows_kept.unique().numel() == \
                                rows_kept.numel(), case


def test_straddling_segments_and_idle_experts():
    """Two ranks whose claims all land on expert 0, with C inside the
    second rank's range: rank 0 keeps all, rank 1 the first C - n; the
    experts no claim names get none on either."""
    moe = BinaryMoE(d_model=8, d_ff=8, num_experts=4, top_k=1,
                    capacity_factor=0.5)
    idx = torch.zeros(1, 16, 1, dtype=torch.long)     # n = 8 a rank
    cap = moe.capacity(16)                              # 2: ceil(16/4/2)
    counts = {(0, r): (torch.tensor([[8, 0, 0, 0]], dtype=torch.int32),
                       torch.zeros(1, 8, dtype=torch.int32))
              for r in range(2)}
    keeps = []
    for r in range(2):
        mesh = _Rank(1, 2, 0, r, counts)
        slot, keep, rows = moe._slots(idx[:, 8 * r:8 * r + 8].reshape(-1, 1),
                                      sharding.Split(r, 2, mesh, True), 1)
        assert rows == min(8, cap)
        keeps.append(int(keep.sum()))
    assert keeps == [cap, 0]
    moe = dataclasses.replace(moe, capacity_factor=4.0)   # C = 16
    cap = moe.capacity(16)
    keeps = []
    for r in range(2):
        mesh = _Rank(1, 2, 0, r, counts)
        _, keep, rows = moe._slots(idx[:, 8 * r:8 * r + 8].reshape(-1, 1),
                                   sharding.Split(r, 2, mesh, True), 1)
        assert rows == 8
        keeps.append(int(keep.sum()))
    assert keeps == [8, 8] and cap == 16


@pytest.mark.parametrize("arch", ["mixtral-8x22b", "arctic-480b"])
def test_expert_groups_equal_the_whole_buffer(arch, monkeypatch):
    """The deploy face with a budget that holds 3 experts a group (the
    last group ragged) against one group: the same outputs, bitwise, at a
    capacity that drops claims."""
    cfg = base.get_smoke_config(arch)
    blk = build_model(cfg.with_(moe=dataclasses.replace(
        cfg.moe, capacity_factor=0.5)))._block()
    moe = blk._ffn()
    params = moe.init_deploy(torch.Generator().manual_seed(0), "cpu")
    x = torch.randn(2, 24, cfg.d_model, generator=torch.Generator()
                    .manual_seed(1))
    whole = moe.apply_deploy(params, x)
    cap = moe.capacity(48)
    assert moe.group(cap) == moe.num_experts
    monkeypatch.setattr(ffn, "GROUP_BYTES",
                        3 * cap * max(moe.d_ff, moe.d_model) * 4)
    assert moe.group(cap) == 3
    assert torch.equal(moe.apply_deploy(params, x), whole)


def test_groups_from_the_shapes_at_full_width():
    """A rank's prefill_32k buffers (4,096 rows an expert): mixtral's 8
    experts in one group (int32 products of (8, 4,096, 16,384): 2.1e9
    bytes), arctic's 128 in groups of 18 (its down projection's (18,
    4,096, 7,168): 2.1e9 bytes), each within ``GROUP_BYTES``."""
    for arch, want in (("mixtral-8x22b", 8), ("arctic-480b", 18)):
        moe = build_model(base.get_config(arch))._block()._ffn()
        g = moe.group(4096)
        assert g == want, arch
        assert g * 4096 * max(moe.d_ff, moe.d_model) * 4 <= ffn.GROUP_BYTES


def test_router_rows_run_in_fixed_blocks():
    """Above ``ROUTER_ROWS`` rows the router's product runs on blocks of
    exactly that many: every block's probabilities equal those of its rows
    routed alone (the same product's shape), bitwise, the last block
    padded."""
    moe = BinaryMoE(d_model=64, d_ff=64, num_experts=8)
    gen = torch.Generator().manual_seed(2)
    params = {"router": {"kernel": torch.randn(64, 8, generator=gen)}}
    n = 2 * ffn.ROUTER_ROWS + 300
    x = torch.randn(n, 64, generator=gen)
    probs = moe._probs(params, x)
    for lo in range(0, n, ffn.ROUTER_ROWS):
        rows = x[lo:lo + ffn.ROUTER_ROWS]
        if rows.shape[0] < ffn.ROUTER_ROWS:
            rows = torch.cat([rows, rows.new_zeros(
                (ffn.ROUTER_ROWS - rows.shape[0], 64))])
        alone = moe._probs(params, rows)[:n - lo]
        assert torch.equal(probs[lo:lo + ffn.ROUTER_ROWS], alone)


def test_an_expert_stack_splits_only_by_expert():
    """``BinaryFFN.apply`` of an expert stack raises on a column split (a
    stack splits by expert, ``apply_experts``), and the whole route runs
    where the stack's leaves are whole."""
    stack = BinaryFFN(32, 64, num_experts=4)
    params = stack.init(torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError, match="splits by expert"):
        stack.apply(params, torch.zeros(4, 2, 32),
                    split=sharding.Split(0, 2, None, True))
    moe = BinaryMoE(d_model=32, d_ff=64, num_experts=16)
    assert not moe._exchanged({"w1": {"w_latent": params["w1"][
        "w_latent"]}}, sharding.Split(0, 2, None, True))


def test_the_prefill_splits_a_moe_stack():
    """On (1, 4) mixtral's and arctic's stacks take the sequence split
    (``Block.splits_prefill``); a length whose blocks are not whole words
    stays whole."""
    mesh = mesh_lib.AbstractMesh((1, 4), ("data", "model"))
    for arch in ("mixtral-8x22b", "arctic-480b"):
        model = build_model(base.get_smoke_config(arch))
        on = _OnMesh(mesh, torch.empty((2, 128), device=META))
        assert on.prefill_split([128], model._blocks()) is not None
        assert on.prefill_split([100], model._blocks()) is None


def _train_census(arch: str, experts: int = 0):
    cfg = base.get_smoke_config(arch)
    if experts:
        cfg = cfg.with_(moe=dataclasses.replace(cfg.moe,
                                                num_experts=experts))
    mesh = mesh_lib.AbstractMesh((2, 4), ("data", "model"))
    tr = Trainer(build_model(cfg), AdamW(lr=1e-3), TrainerConfig(),
                 device=META, mesh=mesh)
    state = specs.train_state_specs(tr)
    batch = {k: torch.empty(mesh_lib.placement_of(v).shape, dtype=v.dtype,
                            device=META)
             for k, v in specs.batch_specs(cfg, base.ShapeConfig(
                 "t", 64, 8, "train"), mesh).items()}
    census, _ = cost.measure(lambda st: tr.train_step(st, batch), (state,))
    return census.record()["collective_sites"]


@pytest.mark.parametrize("arch,experts,exchange", [
    ("mixtral-8x22b", 0, False), ("arctic-480b", 16, True)])
def test_the_train_census_names_the_new_exchanges(arch, experts, exchange):
    """A (2, 4) train step on meta: the counts' all-gather at
    ``ffn._slots``; no whole rows gathered for the MoE; the claims'
    all-to-alls at ``ffn._expert_parallel`` for an expert-parallel stack
    (arctic at 16 experts), none for mixtral's."""
    sites = _train_census(arch, experts)
    assert any(k.startswith("all-gather") and k.endswith("ffn._slots")
               for k in sites), sites
    assert not any("whole_rows" in k or "ffn._route" in k for k in sites)
    assert any(k.endswith("ffn._expert_parallel") for k in sites) == \
        exchange, sites
