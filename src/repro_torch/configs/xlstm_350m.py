"""xlstm-350m [ssm]: 24L d=1024 4H d_ff=0 vocab=50304: sLSTM + mLSTM
blocks.  [arXiv:2405.04517]

COBRA applicability: no softmax attention anywhere, so SPS does not apply.
RBMM applies to the q/k/v-like and in/out projections of every block (the
dominant FLOPs); the exponential-gate recurrences stay fp.  Every 6th block
is sLSTM, the rest mLSTM.
"""
from repro_torch.configs.base import BinaryConfig, ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="xlstm-350m",
    family="ssm",
    num_layers=24,
    d_model=1024,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    rope_theta=0.0,
    subquadratic=True,
    ssm=SSMConfig(state_size=16, expand=2, slstm_every=6),
    binary=BinaryConfig(),
)


def smoke_config() -> ModelConfig:
    return CONFIG.with_(num_layers=4, d_model=128, num_heads=2,
                        num_kv_heads=2, vocab_size=256,
                        ssm=SSMConfig(state_size=4, expand=2, slstm_every=2),
                        remat="none", compute_dtype="float32")
