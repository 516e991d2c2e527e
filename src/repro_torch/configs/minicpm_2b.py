"""MiniCPM-2B: dense llama-like, trained with the WSD schedule [arXiv:2404.06395; hf]

CONFIG is the published configuration; TINY is the reduced same-family
variant for CPU tests (tp=1). Copied from the JAX package's config.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="minicpm-2b", family="dense", n_layers=40, d_model=2304,
    n_heads=36, n_kv_heads=36, d_ff=5760, vocab_size=122753)

TINY = ModelConfig(
    name="minicpm-tiny", family="dense", n_layers=2, d_model=128,
    n_heads=4, n_kv_heads=4, d_ff=320, vocab_size=512, tp=1)
