"""Whisper-base: enc-dec audio, conv frontend stubbed [arXiv:2212.04356; unverified]

CONFIG is the published configuration; TINY is the reduced same-family
variant for CPU tests (tp=1). Copied from the JAX package's config.

The conv frontend is a stub: `data.pipeline.stub_frontend_inputs`
supplies `enc_seq_len` frame embeddings a row. CONFIG's head plan (tp=16)
zero-pads the 8 heads x 64 to 16 q and 16 kv slots, group 1.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base", family="encdec", n_layers=6, n_enc_layers=6,
    d_model=512, n_heads=8, n_kv_heads=8, d_ff=2048, vocab_size=51865,
    qkv_bias=True, enc_seq_len=1500)

TINY = ModelConfig(
    name="whisper-tiny", family="encdec", n_layers=2, n_enc_layers=2,
    d_model=128, n_heads=4, n_kv_heads=4, d_ff=256, vocab_size=512, tp=1,
    qkv_bias=True, enc_seq_len=64)
