"""seamless-m4t-large-v2 [audio]: enc-dec, 24L(+24L enc) d=1024 16H (kv=16)
d_ff=8192 vocab=256206.  [arXiv:2308.11596]

Backbone only, per the assignment: the audio frontend is a STUB —
``input_specs()`` provides precomputed frame embeddings (B, 1024, 1024) that
a single fp projection maps into the encoder.  COBRA applicability:
encoder+decoder linears and self-attentions binarized; *cross-attention uses
SPS too* (scores in {0,1} against the static binary memory cache).  ReLU FFN
=> the paper's F1/F2 fused path applies verbatim.  Enc-dec => decode shapes
run the decoder with self-KV ring + static cross memory; ``long_500k`` SKIP.
"""
from repro_torch.configs.base import BinaryConfig, ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="audio",
    num_layers=24,
    num_encoder_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=8192,
    vocab_size=256206,
    frontend_tokens=1024,
    norm="layernorm",
    act="relu",
    glu=False,
    rope_theta=10_000.0,
    binary=BinaryConfig(),
)


def smoke_config() -> ModelConfig:
    return CONFIG.with_(num_layers=2, num_encoder_layers=2, d_model=128,
                        num_heads=4, num_kv_heads=4, d_ff=256,
                        vocab_size=256, frontend_tokens=8, remat="none", compute_dtype="float32")
