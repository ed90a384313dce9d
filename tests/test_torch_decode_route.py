"""``rbmm_int``'s decode route (M <= 16) on the CPU: its tile rule pinned
at every decode call of smollm-135m and checked over a sweep of shapes,
its arithmetic (lane groups splitting each column's words, the
reduce-scatter of their partials, ``k - 2 X`` and ``popc(b) - X``) emulated
word by word and held to the plain version, and the plain version held
bitwise to the JAX package (its oracle, and its Pallas kernel in
interpret mode) at the decode calls' word shapes with pad bits set."""
import test_torch_threads  # noqa: F401  (first: one torch thread)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rbmm import ops as jrbmm_ops
from repro.kernels.rbmm import ref as jrbmm_ref
from repro_torch.kernels.rbmm import ops as trbmm_ops
from repro_torch.kernels.rbmm import ref as trbmm_ref
from repro_torch.launch.kernel_times import DECODE_CALLS, decode_calls

# the rule's (rows, lanes, warps, words per load) at M (or batch) 8 and 16
PINNED = {
    "wq/wo": ((4, 16, 8, 2), (4, 16, 8, 2)),
    "wk/wv": ((4, 16, 2, 2), (4, 16, 4, 2)),
    "w1/w3": ((4, 16, 8, 2), (4, 16, 8, 2)),
    "w2": ((2, 16, 8, 4), (2, 16, 8, 4)),
    "ring score": ((4, 1, 2, 2), (4, 1, 4, 2)),
    "ring context": ((4, 8, 4, 1), (4, 8, 8, 1)),
}


def _calls(call):
    """(lead, M, P, K, scheme) of ``call`` at batch 8 and 16."""
    return [v for n, v in decode_calls(crossover=()).items()
            if n.startswith(f"rbmm_int decode {call} ")]


def _words(rng, shape):
    """uint32 words with every bit random, pad bits included."""
    return rng.integers(0, 2**32, shape, dtype=np.uint64).astype(np.uint32)


def _popc(x):
    return np.bitwise_count(x).astype(np.int64)


def emulate(a, b, k, scheme, dc, rows_per_block, lanes, vec):
    """The decode kernel's arithmetic on one (M, Kp) x (P, Kp) product of
    uint32 words, lane by lane as ``rbmm_int_dec_kernel`` does it: rows in
    blocks of ``rows_per_block``, lane j of a column's group taking the
    ``vec``-word vectors j, j + lanes, ..., one popcount
    per word and row, partials folded to ``-2 X``, ``2 popc(a & b)`` or
    ``popc(b) - X``, then the shuffle reduce-scatter and each lane's
    stores.  Every output must be stored exactly once."""
    m, kp = a.shape
    p = b.shape[0]
    mt = rows_per_block
    owner = (np.arange(kp) // vec) % lanes
    out = np.full((m, p), np.iinfo(np.int64).min)
    for row0 in range(0, m, mt):
        rows = min(mt, m - row0)
        ar = np.zeros((mt, kp), np.uint32)
        ar[:rows] = a[row0:row0 + rows]
        op = (lambda x, y: x & y) if dc is not None else (lambda x, y: x ^ y)
        x = _popc(op(ar[:, None, :], b[None, :, :]))      # (mt, P, Kp)
        ones_b = _popc(b)                                  # (P, Kp)
        # v[lane][r] over the group's lanes, per column
        v = np.zeros((lanes, mt, p), np.int64)
        for j in range(lanes):
            mine = owner == j
            xs = x[:, :, mine].sum(-1)
            if scheme == "xnor":
                v[j] = -2 * xs
            elif dc is not None:
                v[j] = 2 * xs
            else:
                v[j] = ones_b[:, mine].sum(-1)[None, :] - xs
        held = [list(range(mt)) for _ in range(lanes)]
        vals = [list(v[j]) for j in range(lanes)]
        s, h = lanes // 2, mt
        while s >= 1:
            new = []
            for j in range(lanes):
                up, q = bool(j & s), j ^ s
                if h > 1:
                    half = h // 2
                    keep = vals[j][half:] if up else vals[j][:half]
                    recv = vals[q][half:] if up else vals[q][:half]
                    new.append([kk + rr for kk, rr in zip(keep, recv)])
                else:
                    new.append([vals[j][0] + vals[q][0]])
            for j in range(lanes):
                if h > 1:
                    half = h // 2
                    held[j] = held[j][half:] if j & s else held[j][:half]
            vals = new
            h = max(h // 2, 1)
            s //= 2
        for j in range(lanes):
            if lanes > mt and j & (lanes // mt - 1):
                continue                     # a twin lane stores this row
            for r, val in zip(held[j], vals[j]):
                if r >= rows:
                    continue
                bias = (k if scheme == "xnor" else
                        int(dc[row0 + r]) - k if dc is not None else 0)
                assert (out[row0 + r] == np.iinfo(np.int64).min).all()
                out[row0 + r] = val + bias
    assert (out != np.iinfo(np.int64).min).all()
    return out.astype(np.int32)


def _jax_rbmm_int(a, b, k, scheme, dc):
    """The JAX oracle on (..., M, Kp) x (..., P, Kp), item by item."""
    lead = a.shape[:-2]
    a2 = a.reshape((-1,) + a.shape[-2:])
    b2 = b.reshape((-1,) + b.shape[-2:])
    d2 = None if dc is None else dc.reshape(-1, dc.shape[-1])
    return np.stack([np.asarray(jrbmm_ref.rbmm_int(
        jnp.asarray(x), jnp.asarray(y), k, scheme=scheme,
        dc=None if d2 is None else jnp.asarray(d2[i])))
        for i, (x, y) in enumerate(zip(a2, b2))]).reshape(
            lead + (a.shape[-2], b.shape[-2]))


@pytest.mark.parametrize("call", list(DECODE_CALLS))
def test_decode_tile_at_decode_calls(call):
    """The rule's tile at each decode call, M (or batch) 8 and 16: it takes
    the route "scalar", one load a lane and at most ``DECODE_LANE_WORDS``
    popcounts a lane per column."""
    got = []
    for lead, m, p, k, _ in _calls(call):
        kp = (k + 31) // 32
        batch = int(np.prod(lead, dtype=np.int64))
        assert trbmm_ops.route(m, p, kp) == "scalar"
        rows, lanes, warps, vec = tile = trbmm_ops.decode_tile(batch, m, p,
                                                               kp)
        assert lanes * vec >= kp                    # one load a lane
        assert rows * vec <= trbmm_ops.DECODE_LANE_WORDS
        got.append(tile)
    assert tuple(got) == PINNED[call]


def test_decode_tile_sweep():
    """Over M <= 16, P and Kp (and batches): a row block of at most M's,
    lanes a power of two dividing 32, warps 1 to 8 (blocks of at most 256
    threads), the load width a divisor of Kp, one load a lane where 32
    lanes allow it, a lane's popcounts per column within their bound,
    larger blocks only while the grid keeps its least number of blocks,
    and a grid that covers P without an empty column tile."""
    for batch in (1, 3, 24):
        for m in range(1, 17):
            for p in (1, 2, 31, 64, 77, 160, 192, 576, 1536, 5000):
                for kp in (1, 2, 3, 5, 17, 18, 19, 48, 49, 64, 100, 256):
                    rows, lanes, warps, vec = trbmm_ops.decode_tile(
                        batch, m, p, kp)
                    assert rows in trbmm_ops.DECODE_ROWS
                    assert rows <= trbmm_ops.decode_rows(m)
                    assert lanes in (1, 2, 4, 8, 16, 32)
                    assert warps in (1, 2, 4, 8) and vec in (1, 2, 4)
                    assert kp % vec == 0
                    assert lanes * vec >= kp or lanes == 32
                    words = -(-kp // (lanes * vec)) * vec
                    assert rows * words <= trbmm_ops.DECODE_LANE_WORDS or \
                        rows == 1
                    cols = 32 * warps // lanes
                    blocks = trbmm_ops.decode_grid(batch, m, p, rows, lanes,
                                                   warps)
                    tiles = -(-p // cols)
                    assert tiles * cols >= p > (tiles - 1) * cols
                    assert blocks == tiles * -(-m // rows) * batch >= 1
                    if warps > 1:
                        assert blocks >= trbmm_ops.DECODE_MIN_BLOCKS


def test_decode_rows_and_grid_past_the_row_block():
    """``launch_int("scalar")`` takes any M: the smallest row block that
    holds M, blocks of 8 rows above 8."""
    assert [trbmm_ops.decode_rows(m) for m in (1, 2, 3, 4, 5, 8, 9, 16, 17,
                                               4096)] == \
        [1, 2, 4, 4, 8, 8, 8, 8, 8, 8]
    assert trbmm_ops.decode_grid(1, 4096, 768, 8, 8, 4) == 48 * 512
    assert trbmm_ops.decode_grid(2, 17, 65, 8, 32, 1) == 65 * 3 * 2
    assert trbmm_ops.decode_grid(1, 16, 576, 4, 16, 2) == 144 * 4


@pytest.mark.parametrize("call", list(DECODE_CALLS))
def test_decode_plain_matches_jax_with_pad_bits_set(call):
    """The plain version against the JAX oracle at the call's word shapes,
    M (or batch) 8 and 16, every bit random: at the call's K (no pad bits)
    and at K 5 values short of the words (pad bits set); and_dc with dc
    derived and given."""
    rng = np.random.default_rng(len(call))
    for lead, m, p, k, scheme in _calls(call):
        kp = (k + 31) // 32
        a, b = _words(rng, lead + (m, kp)), _words(rng, lead + (p, kp))
        for kk in (k, 32 * kp - 5):
            dcs = [None] + ([rng.integers(0, kk, lead + (m,)).astype(
                np.int32)] if scheme == "and_dc" else [])
            for dc in dcs:
                got = trbmm_ref.rbmm_int(
                    torch.from_numpy(a.view(np.int32)),
                    torch.from_numpy(b.view(np.int32)), kk, scheme=scheme,
                    dc=None if dc is None else torch.from_numpy(dc)).numpy()
                np.testing.assert_array_equal(
                    got, _jax_rbmm_int(a, b, kk, scheme, dc))


def test_decode_plain_matches_the_jax_kernel_in_interpret_mode():
    """wk/wv at M = 8 ((8, 18) x (192, 18) words, K = 570: pad bits set)
    through the JAX package's Pallas kernel, run as its CPU tests run it."""
    rng = np.random.default_rng(3)
    a, b = _words(rng, (8, 18)), _words(rng, (192, 18))
    for scheme in ("xnor", "and_dc"):
        got = trbmm_ref.rbmm_int(torch.from_numpy(a.view(np.int32)),
                                 torch.from_numpy(b.view(np.int32)), 570,
                                 scheme=scheme).numpy()
        np.testing.assert_array_equal(got, np.asarray(jrbmm_ops.rbmm_int(
            jnp.asarray(a), jnp.asarray(b), 570, scheme=scheme)))


@pytest.mark.parametrize("scheme,with_dc", [("xnor", False),
                                            ("and_dc", False),
                                            ("and_dc", True)])
def test_decode_kernel_arithmetic_emulated(scheme, with_dc):
    """The kernel's arithmetic at the rule's tiles and at every lane count
    against the plain version: M of 1 to 16 (and 17, two row blocks), Kp
    of 1 to 49 with pad bits set, P off any column tile."""
    rng = np.random.default_rng(7 + with_dc + len(scheme))
    for m, p, k in ((1, 7, 20), (3, 5, 64), (4, 9, 150), (8, 6, 575),
                    (9, 3, 600), (16, 5, 1530), (17, 3, 1560),
                    (16, 2, 8190)):
        kp = (k + 31) // 32
        a, b = _words(rng, (m, kp)), _words(rng, (p, kp))
        dc = rng.integers(0, k, (m,)).astype(np.int32) if with_dc else None
        want = trbmm_ref.rbmm_int(
            torch.from_numpy(a.view(np.int32)),
            torch.from_numpy(b.view(np.int32)), k, scheme=scheme,
            dc=None if dc is None else torch.from_numpy(dc)).numpy()
        rows, lanes, _, vec = trbmm_ops.decode_tile(1, m, p, kp)
        tiles = {(rows, lanes, vec), (max(1, rows // 2), lanes, vec)} | {
            (rows, g, 1) for g in (1, 2, 4, 8, 16, 32)}
        for tile in sorted(tiles):
            np.testing.assert_array_equal(
                emulate(a, b, k, scheme, dc, *tile), want,
                err_msg=f"M={m} P={p} K={k} (rows, lanes, vec)={tile}")
