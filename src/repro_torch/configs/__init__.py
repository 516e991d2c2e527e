from repro_torch.configs.base import (
    ARCH_IDS, VOCAB_ALIGN, ModelConfig, get_config,
)

__all__ = ["ARCH_IDS", "VOCAB_ALIGN", "ModelConfig", "get_config"]
