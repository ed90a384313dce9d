"""gemma3-27b [dense]: 62L d=5376 32H (GQA kv=16) d_ff=21504 vocab=262144,
5:1 local:global attention interleave (local layers: a sliding window of
1,024 tokens), GELU GLU, tied embeddings.
[hf:google/gemma-3-1b-pt family; head_dim=128 per the public gemma3 configs]

COBRA applicability: full (SPS per-head lambda; local layers keep a
rolling binary KV ring of the window).
"""
from repro_torch.configs.base import BinaryConfig, ModelConfig

CONFIG = ModelConfig(
    name="gemma3-27b",
    family="dense",
    num_layers=62,
    d_model=5376,
    num_heads=32,
    num_kv_heads=16,
    head_dim=128,
    d_ff=21504,
    vocab_size=262144,
    window_size=1024,
    local_global_ratio=5,        # 5 local : 1 global
    rope_theta=1_000_000.0,
    act="gelu",
    glu=True,
    tie_embeddings=True,
    subquadratic=True,
    binary=BinaryConfig(),
)


def smoke_config() -> ModelConfig:
    return CONFIG.with_(num_layers=6, d_model=128, num_heads=4,
                        num_kv_heads=2, head_dim=32, d_ff=256,
                        vocab_size=256, window_size=8, remat="none",
                        compute_dtype="float32")
