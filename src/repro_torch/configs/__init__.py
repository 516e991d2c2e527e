from repro_torch.configs.base import (
    ARCH_IDS, LONG_CONTEXT_ARCHS, SHAPES, VOCAB_ALIGN, ModelConfig,
    ShapeConfig, cells, get_config,
)

__all__ = ["ARCH_IDS", "LONG_CONTEXT_ARCHS", "SHAPES", "VOCAB_ALIGN",
           "ModelConfig", "ShapeConfig", "cells", "get_config"]
