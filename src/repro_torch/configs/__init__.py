"""Config registry: ``get_config(arch_id)`` / ``get_smoke_config(arch_id)``."""
from repro_torch.configs.base import (ARCH_IDS, BinaryConfig, ModelConfig,
                                      MoEConfig, SSMConfig, get_config,
                                      get_smoke_config)

__all__ = ["ARCH_IDS", "BinaryConfig", "ModelConfig", "MoEConfig",
           "SSMConfig", "get_config", "get_smoke_config"]
