"""hymba-1.5b [hybrid]: 32L d=1600 25H (GQA kv=5) d_ff=5504 vocab=32001,
ssm_state=16: parallel attention + mamba heads.  [arXiv:2411.13676]

COBRA applicability: the attention heads get SPS + RBMM; the mamba branch
has no softmax, so SPS does not apply there: its in/out projections are
binary (RBMM), the selective-scan recurrence stays fp.
"""
from repro_torch.configs.base import BinaryConfig, ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    num_layers=32,
    d_model=1600,
    num_heads=25,
    num_kv_heads=5,
    d_ff=5504,
    vocab_size=32001,
    window_size=1024,
    subquadratic=True,
    rope_theta=10_000.0,
    act="silu",
    glu=True,
    ssm=SSMConfig(state_size=16, conv_width=4, expand=2),
    binary=BinaryConfig(),
)


def smoke_config() -> ModelConfig:
    return CONFIG.with_(num_layers=2, d_model=128, num_heads=4,
                        num_kv_heads=2, d_ff=256, vocab_size=256,
                        window_size=16, ssm=SSMConfig(state_size=4,
                                                      conv_width=4, expand=2),
                        remat="none", compute_dtype="float32")
