"""qwen1.5-32b [dense]: 64L d=5120 40H (MHA kv=40) d_ff=27392 vocab=152064,
QKV bias.  [hf:Qwen/Qwen1.5-0.5B family]

COBRA applicability: full.  The QKV bias folds into the RBMM theta vector —
Eq. 10's bias absorption is exactly the paper's fusion.  Full attention =>
``long_500k`` SKIP.
"""
from repro_torch.configs.base import BinaryConfig, ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-32b",
    family="dense",
    num_layers=64,
    d_model=5120,
    num_heads=40,
    num_kv_heads=40,
    d_ff=27392,
    vocab_size=152064,
    attn_bias=True,
    rope_theta=1_000_000.0,
    act="silu",
    glu=True,
    binary=BinaryConfig(),
)


def smoke_config() -> ModelConfig:
    return CONFIG.with_(num_layers=2, d_model=128, num_heads=4,
                        num_kv_heads=4, d_ff=256, vocab_size=256,
                        remat="none", compute_dtype="float32")
