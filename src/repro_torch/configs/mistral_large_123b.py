"""Mistral-Large-123B [hf:mistralai/Mistral-Large-Instruct-2407; unverified]

CONFIG is the published configuration; TINY is the reduced same-family
variant for CPU tests (tp=1). Copied from the JAX package's config.
CONFIG (125 B parameters) does not fit one card: the port runs TINY, and
trains it under the two-level group remat (`remat="group"`) that CONFIG's
`remat_group=8` is sized for.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mistral-large-123b", family="dense", n_layers=88, d_model=12288,
    n_heads=96, n_kv_heads=8, d_ff=28672, vocab_size=32768, head_dim=128,
    rope_theta=1e6, remat_group=8)

TINY = ModelConfig(
    name="mistral-tiny", family="dense", n_layers=2, d_model=128,
    n_heads=8, n_kv_heads=2, d_ff=384, vocab_size=512, tp=1, head_dim=16)
