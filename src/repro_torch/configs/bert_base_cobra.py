"""bert-base-cobra: the paper's own evaluation model — BERT-base binarized
the COBRA way.  l=512, d=768, 12H, FF=4d=3072, 12 layers (paper §IV-A).

The one arch where every paper feature applies verbatim:
  * no RoPE -> the fused M1 binary-out path (no fp between RBMM and repack),
  * ReLU FFN -> fused F1 theta + Eq. 11 blocked execution (R = FF/d = 4),
  * bidirectional attention (encoder) -> no decode shapes.
"""
from repro_torch.configs.base import BinaryConfig, ModelConfig

CONFIG = ModelConfig(
    name="bert-base-cobra",
    family="dense",
    num_layers=12,
    d_model=768,
    num_heads=12,
    num_kv_heads=12,
    d_ff=3072,
    vocab_size=30522,
    norm="layernorm",
    act="relu",
    glu=False,
    rope_theta=0.0,             # learned/absolute positions; fused M1 path
    causal=False,               # encoder (bidirectional)
    skip_decode=True,           # encoder-only: no decode shapes
    binary=BinaryConfig(ffn_block_r=4),
)


def smoke_config() -> ModelConfig:
    return CONFIG.with_(num_layers=2, d_model=128, num_heads=4,
                        num_kv_heads=4, d_ff=512, vocab_size=256,
                        binary=BinaryConfig(ffn_block_r=4), remat="none",
                        compute_dtype="float32")
