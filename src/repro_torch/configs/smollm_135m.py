"""smollm-135m [dense]: 30L d=576 9H (GQA kv=3) d_ff=1536 vocab=49152 —
llama-arch small.  [hf:HuggingFaceTB/SmolLM-135M]"""
from repro_torch.configs.base import BinaryConfig, ModelConfig

CONFIG = ModelConfig(
    name="smollm-135m",
    family="dense",
    num_layers=30,
    d_model=576,
    num_heads=9,
    num_kv_heads=3,
    d_ff=1536,
    vocab_size=49152,
    rope_theta=10_000.0,
    act="silu",
    glu=True,
    tie_embeddings=True,
    binary=BinaryConfig(),
)


def smoke_config() -> ModelConfig:
    return CONFIG.with_(num_layers=2, d_model=96, num_heads=3,
                        num_kv_heads=1, d_ff=192, vocab_size=256,
                        remat="none", compute_dtype="float32")
