"""Qwen3-30B-A3B: MoE, 128 experts top-8, per-expert ff 768 [hf:Qwen/Qwen3-30B-A3B; hf]

CONFIG is the published configuration; TINY is the reduced same-family
variant for CPU tests (tp=1). Copied from the JAX package's config.

CONFIG's head plan (tp=16) serves its 32 q heads over the 4 KV heads
duplicated to 16, group 2, head_dim 128: 30.83 B parameters, ~61.7 GB in
bf16, served whole on one 80 GB card.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b", family="moe", n_layers=48, d_model=2048,
    n_heads=32, n_kv_heads=4, d_ff=768, vocab_size=151936, head_dim=128,
    n_experts=128, experts_per_token=8)

TINY = ModelConfig(
    name="qwen3-moe-tiny", family="moe", n_layers=2, d_model=128,
    n_heads=4, n_kv_heads=2, d_ff=64, vocab_size=512, tp=1,
    n_experts=8, experts_per_token=2)
