"""InternVL2-2B: InternViT (stub frontend) + InternLM2 backbone [arXiv:2404.16821; hf]

CONFIG is the published configuration; TINY is the reduced same-family
variant for CPU tests (tp=1). Copied from the JAX package's config.

The vision tower is a stub: `data.pipeline.stub_frontend_inputs` supplies
`n_img_tokens` patch embeddings a row, which `img_proj` maps ahead of the
token embeddings in training. Prefill and decode read tokens only.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b", family="vlm", n_layers=24, d_model=2048,
    n_heads=16, n_kv_heads=8, d_ff=8192, vocab_size=92553,
    n_img_tokens=256)

TINY = ModelConfig(
    name="internvl2-tiny", family="vlm", n_layers=2, d_model=128,
    n_heads=4, n_kv_heads=2, d_ff=256, vocab_size=512, tp=1,
    n_img_tokens=16)
