"""Config registry: ``get_config(arch_id)`` / ``get_smoke_config(arch_id)``."""
from repro_torch.configs.base import (ARCH_IDS, SHAPES, BinaryConfig,
                                      ModelConfig, MoEConfig, ShapeConfig,
                                      SSMConfig, all_configs, get_config,
                                      get_smoke_config, valid_shapes)

__all__ = ["ARCH_IDS", "SHAPES", "BinaryConfig", "ModelConfig", "MoEConfig",
           "ShapeConfig", "SSMConfig", "all_configs", "get_config",
           "get_smoke_config", "valid_shapes"]
