"""``init_deploy`` on a CUDA card: the card twin of
``test_torch_init_deploy.py``.

``init_deploy`` equals ``convert(init)`` bitwise on the card (the card's
generator, its Philox offsets) for every arch's smoke config and for
mixtral-8x22b cut to one layer at full width (~10 GB of float32 masters
for ``convert(init)``); and at full width and depth the first two blocks
of qwen1.5-32b's deploy params equal those of its 2-layer config.

Marked ``gpu``: without a card every test skips.  On a card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu_full_depth.py

This file imports no JAX."""
import test_torch_threads  # noqa: F401  (first: one torch thread)
import pytest
import torch

from repro_torch.configs import base
from repro_torch.models.lm import build_model

from test_torch_init_deploy import assert_same_tree

pytestmark = pytest.mark.gpu

SEED = 5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: draws with the card's generator")
    return torch.device("cuda")


def _gen():
    return torch.Generator(device="cuda").manual_seed(SEED)


@pytest.mark.parametrize("arch", base.ARCH_IDS)
def test_init_deploy_equals_convert_of_init_on_the_card(cuda, arch):
    model = build_model(base.get_smoke_config(arch))
    with torch.inference_mode():
        assert_same_tree(model.init_deploy(_gen()),
                         model.convert(model.init(_gen())))


def test_mixtral_one_layer_at_full_width(cuda):
    model = build_model(base.get_config("mixtral-8x22b").truncated(1))
    with torch.inference_mode():
        want = model.convert(model.init(_gen()))
        torch.cuda.empty_cache()
        assert_same_tree(model.init_deploy(_gen()), want)
    del want
    torch.cuda.empty_cache()


def test_full_depth_prefix_at_full_width(cuda):
    cfg = base.get_config("qwen1.5-32b")
    with torch.inference_mode():
        full = build_model(cfg).init_deploy(_gen())
        cut = build_model(cfg.truncated(2)).init_deploy(_gen())
        assert_same_tree(cut, dict(full, blocks=full["blocks"][:2]))
    del full, cut
    torch.cuda.empty_cache()
