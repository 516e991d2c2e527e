"""Model API over the two assembly families, the decoder-only LM (`lm`:
dense, moe, vlm, ssm, hybrid) and the encoder-decoder (`encdec`) (port of
`repro/models/registry.py`), plus `params_from_jax`, which carries a
reference parameter tree (as numpy arrays) over into the port.

`abstract_params`, `input_specs` and `abstract_decode_cache` are the
reference's shape-only stand-ins (`jax.eval_shape`, `ShapeDtypeStruct`):
here tensors on `torch.device("meta")`, which carry shape and dtype and
allocate nothing, so Grok-1's full-size tree builds in milliseconds."""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
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


def abstract_params(cfg: ModelConfig):
    """The parameter tree as meta tensors of its shapes and dtypes."""
    family = encdec if cfg.family == "encdec" else lm
    return lm.tree_map(
        lambda shape, dtype: torch.empty(shape, dtype=dtype, device="meta"),
        family.param_shapes(cfg), family.param_dtypes(cfg))


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict[str, Any]:
    """Meta-tensor stand-ins for every step input of this cell.

    train/prefill: token batch (+ stub modality frontends).
    decode: one new token + cur_index; the KV cache is a separate argument
    (`abstract_decode_cache`) sized to shape.seq_len."""
    B, T = shape.global_batch, shape.seq_len

    def sds(shp, dtype):
        return torch.empty(shp, dtype=dtype, device="meta")

    i32, f32 = torch.int32, torch.float32
    if shape.kind in ("train", "prefill"):
        batch: dict[str, Any] = {"tokens": sds((B, T), i32),
                                 "labels": sds((B, T), i32)}
        if cfg.family == "vlm":
            batch["tokens"] = sds((B, T - cfg.n_img_tokens), i32)
            batch["labels"] = sds((B, T - cfg.n_img_tokens), i32)
            batch["img_embeds"] = sds((B, cfg.n_img_tokens, cfg.d_model),
                                      f32)
        if cfg.family == "encdec":
            batch["frames"] = sds((B, cfg.enc_seq_len, cfg.d_model), f32)
        return batch
    batch = {"tokens": sds((B, 1), i32), "cur_index": sds((), i32)}
    if cfg.family == "encdec":
        kv = (cfg.n_layers, B, cfg.enc_seq_len, cfg.head_plan().n_kv_pad,
              cfg.head_dim_)
        batch["cross_kv"] = {"k": sds(kv, torch.bfloat16),
                             "v": sds(kv, torch.bfloat16)}
    return batch


def abstract_decode_cache(cfg: ModelConfig, shape: ShapeConfig):
    """The decode cache of this cell as meta tensors."""
    return build(cfg).init_decode_cache(shape.global_batch, shape.seq_len,
                                        "meta")


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

