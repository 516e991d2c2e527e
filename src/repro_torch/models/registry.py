"""Model API over the two assembly families, the decoder-only LM (`lm`:
dense, moe, vlm, ssm, hybrid) and the encoder-decoder (`encdec`) (port of
`repro/models/registry.py`), plus `params_from_jax`, which carries a
reference parameter tree (as numpy arrays) over into the port."""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import common, encdec, lm


@dataclasses.dataclass(frozen=True)
class ModelApi:
    cfg: ModelConfig
    init: Callable[..., Any]               # (generator) -> params
    loss_fn: Callable[..., Any]            # (params, batch) -> (loss, metrics)
    init_decode_cache: Callable[..., Any]  # (batch, max_len, device) -> cache
    decode_fn: Callable[..., Any]          # (params, cache, batch) -> (logits, cache)
    prefill_fn: Callable[..., Any] | None  # (params, tokens, max_len)


def build(cfg: ModelConfig, *, remat: str = "full") -> ModelApi:
    if cfg.family == "encdec":
        def enc_loss_fn(params, batch):
            return encdec.forward_train(params, batch, cfg, remat=remat)

        def enc_decode_fn(params, cache, batch):
            # batch: tokens [B,1], cur_index, the stacked cross K/V
            return encdec.decode_step(params, cache, batch["cross_kv"],
                                      batch["tokens"], batch["cur_index"],
                                      cfg)

        return ModelApi(
            cfg=cfg,
            init=lambda gen: encdec.init_encdec(gen, cfg),
            loss_fn=enc_loss_fn,
            init_decode_cache=lambda b, s, device="cuda":
                encdec.init_decode_cache(cfg, b, s, device),
            decode_fn=enc_decode_fn,
            prefill_fn=None,
        )
    lm._check_family(cfg)

    def loss_fn(params, batch):
        return lm.forward_train(params, batch, cfg, remat=remat)

    def decode_fn(params, cache, batch):
        return lm.decode_step(params, cache, batch["tokens"],
                              batch["cur_index"], cfg)

    def prefill_fn(params, tokens, max_len):
        return lm.prefill(params, tokens, cfg, max_len)

    return ModelApi(
        cfg=cfg,
        init=lambda gen: lm.init_lm(gen, cfg),
        loss_fn=loss_fn,
        init_decode_cache=lambda b, s, device="cuda": lm.init_decode_cache(
            cfg, b, s, device),
        decode_fn=decode_fn,
        prefill_fn=prefill_fn,
    )


def params_from_jax(cfg: ModelConfig, np_tree, device="cuda"):
    """The reference's parameter tree, given as numpy arrays (f32, since
    numpy has no bf16), as the port's parameters on `device`, each leaf in
    the reference's dtype (`param_dtypes` of `lm` or `encdec`: `cfg.dtype`,
    and f32 where the reference keeps f32 leaves in any model dtype, as the
    MoE router). The layout is kept as is: padded head slots (zero q
    slots, duplicated kv heads), padded vocab, the stacked layer axes."""
    device = common.resolve_device(device)

    def convert(shape, dtype, a):
        a = np.array(a, dtype=np.float32)   # a writable copy
        if a.shape != shape:
            raise ValueError(f"parameter shape {a.shape} != expected {shape}")
        return torch.from_numpy(a).to(device, dtype)

    family = encdec if cfg.family == "encdec" else lm
    shapes = family.param_shapes(cfg)

    def check_keys(s, t, path="params"):
        if isinstance(s, dict):
            if not isinstance(t, dict) or set(s) != set(t):
                raise ValueError(f"{path}: keys {sorted(t)} != expected "
                                 f"{sorted(s)}")
            for k in s:
                check_keys(s[k], t[k], f"{path}.{k}")

    check_keys(shapes, np_tree)
    return lm.tree_map(convert, shapes, family.param_dtypes(cfg), np_tree)

