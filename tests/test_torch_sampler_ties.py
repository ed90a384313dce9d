"""The port's ``top_k`` sampler under ties, against the JAX package.

JAX's ``top_k`` keeps ``lax.top_k``'s candidates, which are the lowest
indices among equal logits.  When the k-th logit ties with logits past the
k-th place, the port must draw from exactly that set: the support of many
draws equals ``lax.top_k``'s indices (and the support of the port's own
``sampling_probs``, which the speculative path draws from).  float32
logits on the CPU; the card's twin is in ``test_torch_gpu_dense.py``."""
import test_torch_threads  # noqa: F401  (first: one torch thread)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.serve import sampler

DRAWS = 512


def _tied(case: str) -> tuple:
    """(logits (V,), k) with the k-th logit tied past the k-th place."""
    v = np.zeros(64, np.float32)
    if case == "all equal":
        return v, 5
    if case == "leader and a tie group":
        v[:] = -1.0
        v[10] = 2.0
        v[[3, 7, 20, 33, 40, 50]] = 1.0
        return v, 3
    # two tie groups, the second straddling the k-th place
    v[:] = -3.0
    v[[5, 60]] = 1.5
    v[[2, 9, 17, 31, 44, 58, 63]] = 0.5
    return v, 6


@pytest.mark.parametrize("case", ["all equal", "leader and a tie group",
                                  "two tie groups"])
def test_top_k_draws_from_lax_top_k_candidates(case):
    logits, k = _tied(case)
    want = set(np.asarray(jax.lax.top_k(jnp.asarray(logits), k)[1]).tolist())
    assert len(want) == k
    rows = torch.from_numpy(np.broadcast_to(logits, (DRAWS, 1, 64)).copy())
    gen = torch.Generator().manual_seed(0)
    got = sampler.top_k(rows, gen, k=k, temp=0.7)
    assert got.shape == (DRAWS, 1) and got.dtype == torch.int32
    assert set(got.flatten().tolist()) == want
    probs = sampler.sampling_probs(torch.from_numpy(logits), "top_k",
                                   temp=0.7, k=k)
    assert set(torch.nonzero(probs).flatten().tolist()) == want
