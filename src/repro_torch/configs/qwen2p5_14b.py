"""Qwen2.5-14B: GQA with QKV bias [hf:Qwen/Qwen2.5; hf]

CONFIG is the published configuration; TINY is the reduced same-family
variant for CPU tests (tp=1). Copied from the JAX package's config.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-14b", family="dense", n_layers=48, d_model=5120,
    n_heads=40, n_kv_heads=8, d_ff=13824, vocab_size=152064, head_dim=128,
    qkv_bias=True, rope_theta=1e6)

TINY = ModelConfig(
    name="qwen2.5-tiny", family="dense", n_layers=2, d_model=128,
    n_heads=4, n_kv_heads=2, d_ff=320, vocab_size=512, tp=1,
    qkv_bias=True)
