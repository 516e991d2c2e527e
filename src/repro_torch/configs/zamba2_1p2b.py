"""Zamba2-1.2B: Mamba2 backbone + shared attention block [arXiv:2411.15242; hf]

CONFIG is the published configuration; TINY is the reduced same-family
variant for CPU tests (tp=1). Copied from the JAX package's config.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b", family="hybrid", n_layers=38, d_model=2048,
    n_heads=32, n_kv_heads=32, d_ff=8192, vocab_size=32000, ssm_state=64,
    attn_every=6, sliding_window=4096, remat_group=2)

TINY = ModelConfig(
    name="zamba2-tiny", family="hybrid", n_layers=4, d_model=128,
    n_heads=4, n_kv_heads=4, d_ff=256, vocab_size=512, ssm_state=16,
    attn_every=2, sliding_window=64, tp=1, head_dim=32)
