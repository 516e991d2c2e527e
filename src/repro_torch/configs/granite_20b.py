"""Granite-20B (code): llama-arch with MQA (kv=1) [arXiv:2405.04324; hf]

CONFIG is the published configuration; TINY is the reduced same-family
variant for CPU tests (tp=1). Copied from the JAX package's config.

CONFIG's head plan (tp=16) serves its one KV head as 16 duplicated heads,
group 3, head_dim 128: 29.39 B parameters, ~58.8 GB in bf16. TINY keeps
the one KV head under 4 q heads (group 4, head_dim 32).
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-20b", family="dense", n_layers=52, d_model=6144,
    n_heads=48, n_kv_heads=1, d_ff=24576, vocab_size=49152)

TINY = ModelConfig(
    name="granite-tiny", family="dense", n_layers=2, d_model=128,
    n_heads=4, n_kv_heads=1, d_ff=512, vocab_size=512, tp=1)
