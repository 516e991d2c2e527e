"""RWKV6-7B 'Finch': attention-free, data-dependent decay [arXiv:2404.05892; hf]

CONFIG is the published configuration; TINY is the reduced same-family
variant for CPU tests (tp=1). Copied from the JAX package's config.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-7b", family="ssm", n_layers=32, d_model=4096,
    n_heads=64, n_kv_heads=64, d_ff=14336, vocab_size=65536)

TINY = ModelConfig(
    name="rwkv6-tiny", family="ssm", n_layers=2, d_model=128,
    n_heads=2, n_kv_heads=2, d_ff=256, vocab_size=512, tp=1)
