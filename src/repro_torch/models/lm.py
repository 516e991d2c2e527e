"""Decoder-only LM assembly for the dense family (port of the dense branch
of `repro/models/lm.py`).

Parameters are a nested dict of tensors with the per-layer weights stacked
on a leading `[n_layers]` axis (`params["blocks"]`), exactly the reference
layout, so weights carry over one to one. The reference's `lax.scan` over
layers is a Python loop over that axis; its sharding constraints have no
counterpart on one card. Decode caches are stacked `[n_layers, B, S, nkv,
Dh]` tensors that `decode_step` updates in place.

`forward_train` checkpoints each layer (`remat="full"`) with
`torch.utils.checkpoint`; the reference's two-level group remat
(`remat="group"`) is not ported yet.
"""

from __future__ import annotations

from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import common, mlp
from repro_torch.models.attention import AttnSpec

MOE_AUX_COEF = 0.01
REMAT_MODES = ("none", "full")


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} is not yet ported (dense only)")


def tree_map(fn, tree, *rest):
    """Map `fn` over the leaves of nested dicts (the parameter trees)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree):
    """The leaves of nested dicts, in insertion order."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from tree_leaves(v)
    else:
        yield tree


def attn_spec(cfg: ModelConfig) -> AttnSpec:
    return AttnSpec(
        d_model=cfg.d_model, head_dim=cfg.head_dim_, plan=cfg.head_plan(),
        qkv_bias=cfg.qkv_bias, rope_theta=cfg.rope_theta, causal=True,
        sliding_window=0)


def param_shapes(cfg: ModelConfig) -> dict[str, Any]:
    """The parameter tree's shapes: padded heads, padded vocab, stacked
    blocks."""
    _check_family(cfg)
    plan = cfg.head_plan()
    D, Dh, F, L = cfg.d_model, cfg.head_dim_, cfg.d_ff, cfg.n_layers
    nq, nkv = plan.n_q_pad, plan.n_kv_pad
    a = {"wq": (D, nq, Dh), "wk": (D, nkv, Dh), "wv": (D, nkv, Dh),
         "wo": (nq, Dh, D)}
    if cfg.qkv_bias:
        a.update(bq=(nq, Dh), bk=(nkv, Dh), bv=(nkv, Dh))
    block = {"ln1_w": (D,), "attn": a, "ln2_w": (D,),
             "mlp": {"w_gate": (D, F), "w_in": (D, F), "w_out": (F, D)}}
    return {"embed": (cfg.vocab_padded, D), "final_norm_w": (D,),
            "lm_head": (D, cfg.vocab_padded),
            "blocks": tree_map(lambda s: (L,) + s, block)}


def _init_block(gen: torch.Generator, cfg: ModelConfig, dtype):
    dev = gen.device
    return {"ln1_w": torch.ones(cfg.d_model, dtype=dtype, device=dev),
            "attn": attn.init_attention(gen, attn_spec(cfg), dtype),
            "ln2_w": torch.ones(cfg.d_model, dtype=dtype, device=dev),
            "mlp": mlp.init_swiglu(gen, cfg.d_model, cfg.d_ff, dtype)}


def init_lm(gen: torch.Generator, cfg: ModelConfig):
    """Random weights drawn from `gen` on the generator's device, with the
    reference's distributions. Layers are drawn one at a time into the
    stacked buffers, so the f32 scratch is one layer, not the model."""
    _check_family(cfg)
    dtype = common.default_dtype(cfg.dtype)
    dev = gen.device
    Vp, D = cfg.vocab_padded, cfg.d_model
    params: dict[str, Any] = {
        "embed": common.embed_init(gen, (Vp, D), dtype),
        "final_norm_w": torch.ones(D, dtype=dtype, device=dev),
        "lm_head": common.dense_init(gen, (D, Vp), D, dtype),
    }
    blocks = tree_map(lambda s: torch.empty(s, dtype=dtype, device=dev),
                      param_shapes(cfg)["blocks"])
    for i in range(cfg.n_layers):
        tree_map(lambda dst, src: dst[i].copy_(src), blocks,
                 _init_block(gen, cfg, dtype))
    params["blocks"] = blocks
    return params


def _layer(params, i: int):
    return tree_map(lambda a: a[i], params["blocks"])


def _layers(params, n_layers: int):
    """Per-layer views of the stacked blocks for a differentiated pass:
    one `unbind` per stacked leaf, whose backward is one stack. (Indexing
    `a[i]` per layer, as `_layer` does, would allocate a zero tensor of the
    whole stacked leaf in each select's backward.)"""
    split = tree_map(lambda a: torch.unbind(a, 0), params["blocks"])
    return [tree_map(lambda parts: parts[i], split) for i in range(n_layers)]


def _train_layer(p, x, positions, spec: AttnSpec, cfg: ModelConfig):
    h = common.rms_norm(x, p["ln1_w"], cfg.norm_eps)
    a, _ = attn.attention_full(p["attn"], h, spec, positions)
    return _block_tail(p, x + a, cfg)


def embed_tokens(params, tokens, cfg: ModelConfig):
    return params["embed"][tokens.long()]


def logits_from(params, x, cfg: ModelConfig):
    x = common.rms_norm(x, params["final_norm_w"], cfg.norm_eps)
    logits = x @ params["lm_head"]
    # mask padded vocab slots out of the softmax
    if cfg.vocab_padded != cfg.vocab_size:
        logits[..., cfg.vocab_size:] = -1e9
    return logits


def forward_train(params, batch, cfg: ModelConfig, *, remat: str = "full"):
    """batch: {'tokens': [B,T] int, 'labels': [B,T] int (-1 = masked)} ->
    (loss, metrics). `remat="full"` recomputes each layer's activations in
    the backward (non-reentrant `torch.utils.checkpoint` around the layer,
    the reference's per-layer `jax.checkpoint`); `"none"` keeps them."""
    _check_family(cfg)
    if remat not in REMAT_MODES:
        raise NotImplementedError(
            f"remat={remat!r} is not yet ported (have {REMAT_MODES}); the "
            f"two-level group remat stands in ROADMAP.md")
    x = embed_tokens(params, batch["tokens"], cfg)
    B, T = x.shape[0], x.shape[1]
    positions = torch.arange(T, dtype=torch.int32,
                             device=x.device)[None].expand(B, T)
    spec = attn_spec(cfg)
    for p in _layers(params, cfg.n_layers):
        if remat == "full":
            x = checkpoint(_train_layer, p, x, positions, spec, cfg,
                           use_reentrant=False)
        else:
            x = _train_layer(p, x, positions, spec, cfg)
    logits = logits_from(params, x, cfg)
    loss = common.softmax_cross_entropy(logits, batch["labels"])
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    total = loss + MOE_AUX_COEF * aux / max(cfg.n_layers, 1)
    return total, {"ce_loss": loss, "moe_aux": aux}


def init_decode_cache(cfg: ModelConfig, batch: int, max_len: int,
                      device="cuda"):
    """Stacked per-layer KV cache `{"k", "v"}: [n_layers, B, S, nkv, Dh]`."""
    _check_family(cfg)
    c = attn.init_kv_cache(batch, max_len, attn_spec(cfg),
                           common.default_dtype(cfg.dtype), device)
    L = cfg.n_layers
    return {k: v[None].expand((L,) + v.shape).contiguous()
            for k, v in c.items()}


def _block_tail(p, x, cfg: ModelConfig):
    h = common.rms_norm(x, p["ln2_w"], cfg.norm_eps)
    return x + mlp.swiglu(p["mlp"], h)


def decode_step(params, cache, tokens, cur_index: int, cfg: ModelConfig):
    """One serving step: tokens [B,1] -> (logits [B,1,V], cache), the cache
    written in place at slot `cur_index`."""
    _check_family(cfg)
    x = embed_tokens(params, tokens, cfg)
    spec = attn_spec(cfg)
    for i in range(cfg.n_layers):
        p = _layer(params, i)
        h = common.rms_norm(x, p["ln1_w"], cfg.norm_eps)
        a, _ = attn.attention_decode(
            p["attn"], h, {"k": cache["k"][i], "v": cache["v"][i]},
            cur_index, spec)
        x = _block_tail(p, x + a, cfg)
    return logits_from(params, x, cfg), cache


def prefill(params, tokens, cfg: ModelConfig, max_len: int):
    """Prefill pass: run the full prompt, return (last_logits, cache, T)."""
    _check_family(cfg)
    B, T = tokens.shape
    x = embed_tokens(params, tokens, cfg)
    positions = torch.arange(T, dtype=torch.int32,
                             device=x.device)[None].expand(B, T)
    spec = attn_spec(cfg)
    cache = init_decode_cache(cfg, B, max_len, x.device)
    for i in range(cfg.n_layers):
        p = _layer(params, i)
        h = common.rms_norm(x, p["ln1_w"], cfg.norm_eps)
        a, (k, v) = attn.attention_full(p["attn"], h, spec, positions)
        x = _block_tail(p, x + a, cfg)
        # write prompt K/V into the max_len cache buffer
        cache["k"][i, :, :T] = k
        cache["v"][i, :, :T] = v
    logits = logits_from(params, x[:, -1:], cfg)
    return logits, cache, T
