"""arctic-480b [moe]: 35L d=7168 56H (GQA kv=8) d_ff=4864 vocab=32000,
MoE 128 experts top-2 + dense residual.  [hf:Snowflake/snowflake-arctic-base]

COBRA applicability: full — dense-residual FFN and all 128 experts are RBMM
stacks.  Full attention.  Adam moments are bf16 (kept for equality with the
JAX config; the port has no training face yet).
"""
from repro_torch.configs.base import BinaryConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    family="moe",
    num_layers=35,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    d_ff=4864,
    vocab_size=32000,
    rope_theta=10_000.0,
    act="silu",
    glu=True,
    moe=MoEConfig(num_experts=128, top_k=2, dense_residual=True),
    optim_moment_dtype="bfloat16",
    binary=BinaryConfig(),
)


def smoke_config() -> ModelConfig:
    return CONFIG.with_(
        num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
        d_ff=128, vocab_size=256,
        # dropless capacity (cf >= E/k) so decode == prefill exactly
        moe=MoEConfig(num_experts=8, top_k=2, dense_residual=True,
                      capacity_factor=4.0),
        remat="none", compute_dtype="float32")
