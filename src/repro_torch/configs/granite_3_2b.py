"""granite-3-2b [dense]: 40L d=2048 32H (GQA kv=8) d_ff=8192 vocab=49155.
[hf:ibm-granite/granite-3.0-2b-base]

COBRA applicability: full.  Full attention => ``long_500k`` SKIP.
"""
from repro_torch.configs.base import BinaryConfig, ModelConfig

CONFIG = ModelConfig(
    name="granite-3-2b",
    family="dense",
    num_layers=40,
    d_model=2048,
    num_heads=32,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=49155,
    rope_theta=10_000.0,
    act="silu",
    glu=True,
    tie_embeddings=True,
    binary=BinaryConfig(),
)


def smoke_config() -> ModelConfig:
    return CONFIG.with_(num_layers=2, d_model=128, num_heads=4,
                        num_kv_heads=2, d_ff=256, vocab_size=256,
                        remat="none", compute_dtype="float32")
