"""The port's configs against the JAX package's: the registered archs'
full and smoke configs field for field, and ``param_count`` /
``active_param_count`` for every arch (an unregistered arch's JAX config is
rebuilt from its fields in the port's dataclasses, so the MoE, hybrid and
SSM branches of the count are held too)."""
import test_torch_threads  # noqa: F401  (first: one torch thread)
import dataclasses

import pytest

from repro.configs import base as jbase
from repro_torch.configs import base as tbase


def _port_config(jcfg) -> tbase.ModelConfig:
    """The port's ModelConfig with the JAX config's field values."""
    kw = {f.name: getattr(jcfg, f.name)
          for f in dataclasses.fields(jbase.ModelConfig)}
    kw["moe"] = tbase.MoEConfig(**dataclasses.asdict(jcfg.moe))
    kw["binary"] = tbase.BinaryConfig(**dataclasses.asdict(jcfg.binary))
    if jcfg.ssm is not None:
        kw["ssm"] = tbase.SSMConfig(**dataclasses.asdict(jcfg.ssm))
    return tbase.ModelConfig(**kw)


@pytest.mark.parametrize("arch", list(jbase.ARCH_IDS))
def test_param_counts_match_jax(arch):
    jcfg = jbase.get_config(arch)
    tcfg = _port_config(jcfg)
    assert tcfg.param_count() == jcfg.param_count()
    assert tcfg.active_param_count() == jcfg.active_param_count()
    smoke = jbase.get_smoke_config(arch)
    assert _port_config(smoke).param_count() == smoke.param_count()


@pytest.mark.parametrize("arch", ["granite-3-2b", "qwen1.5-32b"])
def test_dense_arch_configs_equal_jax(arch):
    for get in ("get_config", "get_smoke_config"):
        tcfg = getattr(tbase, get)(arch)
        assert dataclasses.asdict(tcfg) == dataclasses.asdict(
            getattr(jbase, get)(arch))
        assert tcfg.family == "dense" and tcfg.glu and tcfg.act == "silu"
    full = tbase.get_config(arch)
    if arch == "qwen1.5-32b":
        assert (full.resolved_head_dim, full.num_heads, full.num_kv_heads,
                full.attn_bias, full.tie_embeddings) == (128, 40, 40, True,
                                                         False)
        assert full.param_count() == 35_196_108_800
    else:
        assert (full.resolved_head_dim, full.num_heads // full.num_kv_heads,
                full.num_layers) == (64, 4, 40)
