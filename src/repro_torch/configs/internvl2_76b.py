"""internvl2-76b [vlm]: 80L d=8192 64H (GQA kv=8) d_ff=28672 vocab=128256 —
InternViT + InternLM2/llama3-70b-class backbone.  [arXiv:2404.16821]

Backbone only: the InternViT frontend is a STUB — ``input_specs()`` provides
1024 precomputed patch embeddings per image, projected by one fp layer and
prepended to the token embeddings.  COBRA applicability: full on the LLM
backbone.  Full attention => ``long_500k`` SKIP.
"""
from repro_torch.configs.base import BinaryConfig, ModelConfig

CONFIG = ModelConfig(
    name="internvl2-76b",
    family="vlm",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=28672,
    vocab_size=128256,
    frontend_tokens=1024,
    rope_theta=500_000.0,
    act="silu",
    glu=True,
    binary=BinaryConfig(),
)


def smoke_config() -> ModelConfig:
    return CONFIG.with_(num_layers=2, d_model=128, num_heads=4,
                        num_kv_heads=2, d_ff=256, vocab_size=256,
                        frontend_tokens=8, remat="none", compute_dtype="float32")
