"""Analytic HBM-traffic model for the roofline memory term (copied from
`repro/roofline/analytic.py`; it imports only `configs.base`). Its numbers
are the reference's simulated TPU v5e production mesh (`hwspec.V5E`), not
the H100's.

The reference's HLO producer/consumer byte walk (hlo_costs.py; the port's
`op_costs.py` walks aten ops instead) is a faithful count of
*CPU*-HLO boundaries, but XLA:TPU fuses elementwise chains into VMEM, so it
overstates TPU HBM traffic ~5-10x. For the memory term we therefore use a
explicit traffic model of what a TPU execution actually moves per step
(documented in EXPERIMENTS.md §Roofline):

train (per device):
    2*(W + G + O)            weights/grads/optimizer, read+write once
  + M * L * A * C_ACT        residual-stream traffic per microbatch-layer:
                             fwd write + bwd read + remat re-write + the
                             attn/mlp internals that spill (C_ACT ~ 6)
prefill: W + L * A_pf * C_PF  (C_PF ~ 4; no grads/opt)
decode:  2N/devices + cache read+write (the classic decode bound)

W = 2N/devices (bf16), G = 4N/devices (f32 accum), O = 8N/devices f32
moments (2.1 for int8), A = tokens_local*d_model*2.
"""

from __future__ import annotations

from repro_torch.configs.base import ModelConfig, ShapeConfig

C_ACT_TRAIN = 6.0
C_ACT_PREFILL = 4.0


def hbm_bytes_per_device(cfg: ModelConfig, shape: ShapeConfig, devices: int,
                         *, microbatches: int = 1, int8_opt: bool = False,
                         tp: int | None = None) -> float:
    N = cfg.param_count()
    L = max(cfg.n_layers + (cfg.n_enc_layers or 0), 1)
    D = cfg.d_model
    tp = cfg.tp if tp is None else tp
    if shape.kind == "train":
        W = 2.0 * N / devices
        G = 4.0 * N / devices
        O = (2.1 if int8_opt else 8.0) * N / devices
        tokens_local = shape.tokens / max(devices // tp, 1) / microbatches
        A = tokens_local * D * 2.0
        return 2.0 * (W + G + O) + microbatches * L * A * C_ACT_TRAIN
    if shape.kind == "prefill":
        W = 2.0 * N / devices
        tokens_local = shape.tokens / max(devices // tp, 1)
        A = tokens_local * D * 2.0
        return W + L * A * C_ACT_PREFILL
    # decode: every parameter is read once per token + cache traffic
    W = 2.0 * cfg.active_param_count() / devices
    cache = cache_bytes_per_device(cfg, shape, devices)
    return W + 2.0 * cache / max(shape.seq_len, 1) + cache_read_per_token(
        cfg, shape, devices)


def cache_bytes_per_device(cfg: ModelConfig, shape: ShapeConfig,
                           devices: int) -> float:
    plan = cfg.head_plan()
    B_local = max(shape.global_batch / max(devices // cfg.tp, 1), 1)
    if cfg.family in ("dense", "vlm", "moe", "encdec"):
        S = min(shape.seq_len, 10**9)
        kv = cfg.n_layers * B_local * S * (plan.n_kv_pad / cfg.tp) \
            * cfg.head_dim_ * 2 * 2
        return kv
    if cfg.family == "hybrid":
        window = cfg.sliding_window or shape.seq_len
        n_occ = cfg.n_layers // max(cfg.attn_every, 1)
        kv = n_occ * B_local * min(window, shape.seq_len) \
            * (plan.n_kv_pad / cfg.tp) * cfg.head_dim_ * 2 * 2
        ssm = cfg.n_layers * B_local * (2 * cfg.d_model / 64 / cfg.tp) \
            * cfg.ssm_state * 64 * 4
        return kv + ssm
    # ssm (rwkv6): [H, Dh, Dh] f32 per layer
    H = cfg.d_model // 64
    return cfg.n_layers * B_local * (H / cfg.tp) * 64 * 64 * 4


def cache_read_per_token(cfg: ModelConfig, shape: ShapeConfig,
                         devices: int) -> float:
    """Decode reads the whole (local) cache once per generated token."""
    return cache_bytes_per_device(cfg, shape, devices)
