"""Grok-1-314B: MoE, 8 experts top-2 [hf:xai-org/grok-1; unverified]

CONFIG is the published configuration; TINY is the reduced same-family
variant for CPU tests (tp=1). Copied from the JAX package's config.
CONFIG (317 B parameters) does not fit one card: the port runs TINY.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="grok-1-314b", family="moe", n_layers=64, d_model=6144,
    n_heads=48, n_kv_heads=8, d_ff=32768, vocab_size=131072, head_dim=128,
    n_experts=8, experts_per_token=2, remat_group=8)

TINY = ModelConfig(
    name="grok1-tiny", family="moe", n_layers=2, d_model=128,
    n_heads=4, n_kv_heads=2, d_ff=256, vocab_size=512, tp=1,
    n_experts=4, experts_per_token=2)
