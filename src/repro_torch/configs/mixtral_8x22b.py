"""mixtral-8x22b [moe]: 56L d=6144 48H (GQA kv=8) d_ff=16384 vocab=32768,
MoE 8 experts top-2, sliding-window attention.  [arXiv:2401.04088; hf]

COBRA applicability: full — expert FFNs binarized (per-expert alpha/theta),
SPS attention.  Router stays fp (tiny).  SWA => rolling binary KV ring.
"""
from repro_torch.configs.base import BinaryConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    num_layers=56,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=16384,
    vocab_size=32768,
    window_size=4096,
    subquadratic=True,          # SWA bounds attention + KV
    rope_theta=1_000_000.0,
    act="silu",
    glu=True,
    moe=MoEConfig(num_experts=8, top_k=2),
    binary=BinaryConfig(),
)


def smoke_config() -> ModelConfig:
    return CONFIG.with_(
        num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
        d_ff=256, vocab_size=256, window_size=16,
        # dropless capacity (cf >= E/k) so decode == prefill exactly
        moe=MoEConfig(num_experts=4, top_k=2, capacity_factor=2.0),
        remat="none", compute_dtype="float32")
