from repro_torch.configs.base import (ARCH_IDS, SHAPES, ModelConfig,
                                     ShapeCfg, get_config, get_reduced,
                                     registry)

__all__ = ["ARCH_IDS", "SHAPES", "ModelConfig", "ShapeCfg", "get_config",
           "get_reduced", "registry"]
