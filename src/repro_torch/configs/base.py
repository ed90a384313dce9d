"""Config dataclasses and the arch registry of the PyTorch port.

A copy of the JAX package's ``repro.configs.base`` dataclasses: the port
imports nothing of that package, so both are held on the same shapes by the
parity tests, not by a shared module.  Only the architectures the port can
run are registered; any other known arch raises "not ported yet".
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, Optional, Sequence


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 0            # 0 => dense FFN
    top_k: int = 2
    dense_residual: bool = False
    router_dtype: str = "float32"
    capacity_factor: float = 2.0


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    state_size: int = 16
    conv_width: int = 4
    expand: int = 2
    slstm_every: int = 0


@dataclasses.dataclass(frozen=True)
class BinaryConfig:
    """COBRA binarization knobs (same fields and defaults as the JAX
    package, so a config reads the same in both)."""
    enabled: bool = True
    # binary matmul route: popcount | mxu | dense | auto (M <= 16 popcount)
    impl: str = "auto"
    # deploy attention-score route: auto (= popcount) | popcount | mxu | dense
    score_impl: str = "auto"
    # SPS threshold granularity: layer | head | row
    sps_granularity: str = "head"
    attn_mode: str = "sps"
    gather_bits_collectives: bool = False
    moe_dispatch_bits: bool = False
    # kept for equality with the JAX config; the port does not read it:
    # its paged decode always runs the paged_gather_decode kernel (the
    # JAX package's two branches give the same integers)
    paged_kernel: bool = False
    binarize_embeddings: bool = False
    ffn_block_r: int = 0
    latent_dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str         # dense | moe | encdec | hybrid | ssm | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0               # 0 => d_model // num_heads
    attn_bias: bool = False
    rope_theta: float = 10_000.0
    window_size: int = 0
    local_global_ratio: int = 0
    causal: bool = True
    num_encoder_layers: int = 0
    frontend_tokens: int = 0
    norm: str = "rmsnorm"
    act: str = "silu"
    glu: bool = True
    tie_embeddings: bool = False
    moe: MoEConfig = dataclasses.field(default_factory=MoEConfig)
    ssm: Optional[SSMConfig] = None
    binary: BinaryConfig = dataclasses.field(default_factory=BinaryConfig)
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    optim_moment_dtype: str = "float32"
    act_shard: str = "seq"
    decode_grouped_gqa: bool = False
    window_chunking: bool = True
    fsdp: bool = True
    remat: str = "block"
    subquadratic: bool = False
    skip_decode: bool = False

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.resolved_head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.resolved_head_dim

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def truncated(self, num_layers: int) -> "ModelConfig":
        """The first ``num_layers`` layers of this config: the shape of a
        layer-truncated self-speculative draft, whose layers are exactly
        the prefix of the full stack's and share its packed weights."""
        if not 1 <= num_layers <= self.num_layers:
            raise ValueError(
                f"truncated({num_layers}) outside [1, {self.num_layers}]")
        return self.with_(num_layers=num_layers)

    def param_count(self) -> int:
        """Analytic parameter count (embeddings included once), as the
        JAX package counts it."""
        d, ff = self.d_model, self.d_ff
        attn = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
        ffn_dense = (3 if self.glu and ff else 2) * d * ff
        ffn = ffn_dense
        if self.moe.num_experts:
            ffn = self.moe.num_experts * ffn_dense + d * self.moe.num_experts
            if self.moe.dense_residual:
                ffn += ffn_dense
        if self.ssm is not None and self.family == "ssm":
            # xlstm: no FFN; the in and out projections of the expanded dim
            ffn = 2 * d * (self.ssm.expand * d)
        block = attn + ffn + 2 * d
        if self.family == "hybrid":
            e = self.ssm.expand if self.ssm else 2
            block += 2 * d * (e * d)   # the parallel mamba branch
        layers = self.num_layers + self.num_encoder_layers
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        return layers * block + emb

    def active_param_count(self) -> int:
        """Params touched per token (MoE: the top_k experts only)."""
        if not self.moe.num_experts:
            return self.param_count()
        dense_expert = (3 if self.glu else 2) * self.d_model * self.d_ff
        inactive = (self.moe.num_experts - self.moe.top_k) * dense_expert
        return self.param_count() - self.num_layers * inactive


ARCH_IDS: Sequence[str] = (
    "mixtral-8x22b",
    "arctic-480b",
    "qwen1.5-32b",
    "gemma3-27b",
    "smollm-135m",
    "granite-3-2b",
    "seamless-m4t-large-v2",
    "hymba-1.5b",
    "xlstm-350m",
    "internvl2-76b",
    "bert-base-cobra",
)

# archs the port runs; the rest of ARCH_IDS raise "not ported yet"
_MODULE_FOR: Dict[str, str] = {
    "smollm-135m": "smollm_135m",
    "granite-3-2b": "granite_3_2b",
    "qwen1.5-32b": "qwen15_32b",
    "gemma3-27b": "gemma3_27b",
    "mixtral-8x22b": "mixtral_8x22b",
    "arctic-480b": "arctic_480b",
    "bert-base-cobra": "bert_base_cobra",
}


def _module(arch_id: str):
    if arch_id not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {list(ARCH_IDS)}")
    if arch_id not in _MODULE_FOR:
        raise NotImplementedError(
            f"arch {arch_id!r} is not ported yet; the PyTorch port runs "
            f"{sorted(_MODULE_FOR)}")
    return importlib.import_module(
        f"repro_torch.configs.{_MODULE_FOR[arch_id]}")


def get_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).CONFIG


def get_smoke_config(arch_id: str) -> ModelConfig:
    """Reduced same-family config for CPU tests."""
    return _module(arch_id).smoke_config()
