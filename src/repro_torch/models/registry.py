"""Model API over the dense decoder-only LM (port of
`repro/models/registry.py`), plus `params_from_jax`, which carries a
reference parameter tree (as numpy arrays) over into the port."""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import common, lm


@dataclasses.dataclass(frozen=True)
class ModelApi:
    cfg: ModelConfig
    init: Callable[..., Any]               # (generator) -> params
    init_decode_cache: Callable[..., Any]  # (batch, max_len, device) -> cache
    decode_fn: Callable[..., Any]          # (params, cache, batch) -> (logits, cache)
    prefill_fn: Callable[..., Any] | None  # (params, tokens, max_len)


def build(cfg: ModelConfig) -> ModelApi:
    lm._check_family(cfg)

    def decode_fn(params, cache, batch):
        return lm.decode_step(params, cache, batch["tokens"],
                              batch["cur_index"], cfg)

    def prefill_fn(params, tokens, max_len):
        return lm.prefill(params, tokens, cfg, max_len)

    return ModelApi(
        cfg=cfg,
        init=lambda gen: lm.init_lm(gen, cfg),
        init_decode_cache=lambda b, s, device="cuda": lm.init_decode_cache(
            cfg, b, s, device),
        decode_fn=decode_fn,
        prefill_fn=prefill_fn,
    )


def params_from_jax(cfg: ModelConfig, np_tree, device="cuda"):
    """The reference's parameter tree, given as numpy arrays (f32, since
    numpy has no bf16), as the port's parameters on `device` in
    `cfg.dtype`. The layout is kept as is: padded head slots (zero q slots,
    duplicated kv heads), padded vocab, the stacked `blocks` axis."""
    device = common.resolve_device(device)
    dtype = common.default_dtype(cfg.dtype)

    def convert(shape, a):
        a = np.array(a, dtype=np.float32)   # a writable copy
        if a.shape != shape:
            raise ValueError(f"parameter shape {a.shape} != expected {shape}")
        return torch.from_numpy(a).to(device, dtype)

    shapes = lm.param_shapes(cfg)

    def check_keys(s, t, path="params"):
        if isinstance(s, dict):
            if not isinstance(t, dict) or set(s) != set(t):
                raise ValueError(f"{path}: keys {sorted(t)} != expected "
                                 f"{sorted(s)}")
            for k in s:
                check_keys(s[k], t[k], f"{path}.{k}")

    check_keys(shapes, np_tree)
    return lm.tree_map(convert, shapes, np_tree)
