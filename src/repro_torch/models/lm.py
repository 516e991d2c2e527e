"""Decoder-only LM assembly for the dense family, the moe family (a MoE
layer in place of the MLP), the vlm family (dense, with an image prefix in
training), the ssm family (RWKV6) and the hybrid family (Zamba2: Mamba2
layers with one shared attention + MLP block), ported from
`repro/models/lm.py`.

Parameters are a nested dict of tensors with the per-layer weights stacked
on a leading `[n_layers]` axis (`params["blocks"]`), exactly the reference
layout, so weights carry over one to one; the hybrid family's shared block
(`params["shared"]`) and the vlm family's `img_proj` are not stacked. The
reference's `lax.scan` over layers is a Python loop over that axis. Its
sharding constraints are `parallel.sharding.constrain` at the same places
(after each layer's attention residual, at each layer's end, on the
embeddings and on the logits): the identity without an active mesh, and
under `mesh_context` a redistribution of a DTensor activation (the placed
train step's activations are plain tensors, each rank's own rows). Decode
caches, which `decode_step` updates in place:

- dense, moe, vlm: the KV cache `{"k", "v": [n_layers, B, S, nkv, Dh]}`;
- ssm: the recurrent state `{"wkv": [n_layers, B, H, Dh, Dh] f32,
  "tm_last", "cm_last": [n_layers, B, 1, D]}`;
- hybrid: `{"mamba": {"conv_x": [n_layers, B, W-1, d_inner], "conv_B",
  "conv_C": [n_layers, B, W-1, G*N], "ssm": [n_layers, B, H, N, P] f32},
  "shared_kv": {"k", "v": [n_occ, B, S, nkv, Dh]}}`, one KV cache per
  occurrence of the shared block (n_occ = n_layers // attn_every), S
  capped at the sliding window. The reference keeps the Mamba state as
  the tuple `((conv_x, conv_B, conv_C), ssm)`; the names above map onto
  it in that order.

The recurrent states (`wkv`, `ssm`) are written by the scans themselves:
`prefill` and `decode_step` hand K8 and K9 the cache's slice as their
output state (`state_out`), so no step copies a state into the cache; the
conv and token-shift states, which are small, are copied.

`forward_train` trains every family. `remat="full"` checkpoints each
layer with `torch.utils.checkpoint`; a hybrid layer and the shared block
that follows it sit under one checkpoint, as the reference's `lax.cond`
sits inside its rematted layer body. `remat="group"` is the reference's
two-level remat: one checkpoint a group of `cfg.remat_group_` layers and
none inside it, so the backward keeps one residual a group and
recomputes a group at a time. The training path hands the scans no state
buffer: K8 and K9 run as differentiable calls (`ops.mamba2_scan`,
`ops.rwkv6_scan`). A moe layer returns its load-balance loss beside x,
also under a checkpoint, and `forward_train` adds their sum to the loss.
"""

from __future__ import annotations

from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import common, mamba2, mlp, rwkv6
from repro_torch.models.attention import AttnSpec
from repro_torch.models.mamba2 import Mamba2Spec
from repro_torch.models.mlp import MoESpec
from repro_torch.models.rwkv6 import Rwkv6Spec
from repro_torch.parallel.sharding import constrain

MOE_AUX_COEF = 0.01
REMAT_MODES = ("none", "full", "group")
FAMILIES = ("dense", "moe", "vlm", "ssm", "hybrid")   # this module's
RWKV_CACHE_KEYS = ("wkv", "tm_last", "cm_last")   # the ssm decode cache
CONV_KEYS = ("conv_x", "conv_B", "conv_C")         # the hybrid's conv states


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} is not a decoder-only LM family (have "
            f"{FAMILIES}; the encdec family is `models/encdec.py`)")


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


def attn_spec(cfg: ModelConfig, *, sliding: bool = False) -> AttnSpec:
    return AttnSpec(
        d_model=cfg.d_model, head_dim=cfg.head_dim_, plan=cfg.head_plan(),
        qkv_bias=cfg.qkv_bias, rope_theta=cfg.rope_theta, causal=True,
        sliding_window=cfg.sliding_window if sliding else 0)


def moe_spec(cfg: ModelConfig) -> MoESpec:
    return MoESpec(d_model=cfg.d_model, d_ff=cfg.d_ff,
                   n_experts=cfg.n_experts, k=cfg.experts_per_token)


def mamba_spec(cfg: ModelConfig) -> Mamba2Spec:
    return Mamba2Spec(d_model=cfg.d_model, d_state=cfg.ssm_state)


def rwkv_spec(cfg: ModelConfig) -> Rwkv6Spec:
    return Rwkv6Spec(d_model=cfg.d_model, d_ff=cfg.d_ff)


def param_shapes(cfg: ModelConfig) -> dict[str, Any]:
    """The parameter tree's shapes: padded heads, padded vocab, stacked
    blocks."""
    _check_family(cfg)
    D, Dh, F, L = cfg.d_model, cfg.head_dim_, cfg.d_ff, cfg.n_layers
    plan = cfg.head_plan()
    nq, nkv = plan.n_q_pad, plan.n_kv_pad
    a = {"wq": (D, nq, Dh), "wk": (D, nkv, Dh), "wv": (D, nkv, Dh),
         "wo": (nq, Dh, D)}
    if cfg.qkv_bias:
        a.update(bq=(nq, Dh), bk=(nkv, Dh), bv=(nkv, Dh))
    attn_mlp = {"ln1_w": (D,), "attn": a, "ln2_w": (D,),
                "mlp": {"w_gate": (D, F), "w_in": (D, F), "w_out": (F, D)}}
    if cfg.family == "ssm":
        block = {"ln1_w": (D,), "ln1_b": (D,),
                 "rwkv_tm": rwkv6.param_shapes(rwkv_spec(cfg)),
                 "ln2_w": (D,), "ln2_b": (D,)}
    elif cfg.family == "hybrid":
        block = {"ln1_w": (D,),
                 "mamba": mamba2.param_shapes(mamba_spec(cfg))}
    elif cfg.family == "moe":
        block = {"ln1_w": (D,), "attn": a, "ln2_w": (D,),
                 "moe": mlp.param_shapes(moe_spec(cfg))}
    else:
        block = attn_mlp
    shapes = {"embed": (cfg.vocab_padded, D), "final_norm_w": (D,),
              "lm_head": (D, cfg.vocab_padded),
              "blocks": tree_map(lambda s: (L,) + s, block)}
    if cfg.family == "hybrid":
        shapes["shared"] = attn_mlp      # one block, reused: not stacked
    if cfg.family == "vlm":
        shapes["img_proj"] = (D, D)
    return shapes


def param_dtypes(cfg: ModelConfig) -> dict[str, Any]:
    """The parameter tree's dtypes: `cfg.dtype`, except the leaves the
    reference creates in f32 (the RWKV6 decay base and bonus; the Mamba2
    A_log, D and dt_bias; the MoE router)."""
    dtype = common.default_dtype(cfg.dtype)
    dtypes = tree_map(lambda s: dtype, param_shapes(cfg))
    f32 = {"ssm": ("rwkv_tm", rwkv6.F32_PARAMS),
           "hybrid": ("mamba", mamba2.F32_PARAMS),
           "moe": ("moe", mlp.F32_PARAMS)}.get(cfg.family)
    if f32 is not None:
        sub, names = f32
        for name in names:
            dtypes["blocks"][sub][name] = torch.float32
    return dtypes


def _init_block(gen: torch.Generator, cfg: ModelConfig, dtype):
    dev = gen.device

    def vec(value):
        return torch.full((cfg.d_model,), value, dtype=dtype, device=dev)

    if cfg.family == "ssm":
        return {"ln1_w": vec(1.0), "ln1_b": vec(0.0),
                "rwkv_tm": rwkv6.init_rwkv6(gen, rwkv_spec(cfg), dtype),
                "ln2_w": vec(1.0), "ln2_b": vec(0.0)}
    if cfg.family == "hybrid":
        return {"ln1_w": vec(1.0),
                "mamba": mamba2.init_mamba2(gen, mamba_spec(cfg), dtype)}
    if cfg.family == "moe":
        return {"ln1_w": vec(1.0),
                "attn": attn.init_attention(gen, attn_spec(cfg), dtype),
                "ln2_w": vec(1.0),
                "moe": mlp.init_moe(gen, moe_spec(cfg), dtype)}
    return _init_attn_mlp(gen, cfg, dtype, attn_spec(cfg))


def _init_attn_mlp(gen: torch.Generator, cfg: ModelConfig, dtype,
                   spec: AttnSpec):
    def vec(value):
        return torch.full((cfg.d_model,), value, dtype=dtype,
                          device=gen.device)

    return {"ln1_w": vec(1.0),
            "attn": attn.init_attention(gen, spec, dtype),
            "ln2_w": vec(1.0),
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
    params["blocks"] = draw_stacked(
        param_shapes(cfg)["blocks"], param_dtypes(cfg)["blocks"],
        cfg.n_layers, lambda: _init_block(gen, cfg, dtype), dev)
    if cfg.family == "hybrid":
        # zamba2: one *shared* attention + MLP block reused every
        # attn_every Mamba2 layers, with a sliding-window attention
        params["shared"] = _init_attn_mlp(gen, cfg, dtype,
                                          attn_spec(cfg, sliding=True))
    if cfg.family == "vlm":
        params["img_proj"] = common.dense_init(gen, (D, D), D, dtype)
    return params


def draw_stacked(shapes, dtypes, n: int, draw, device):
    """`n` layers, each drawn by `draw()` (a tree of tensors), into stacked
    buffers of the trees `shapes` and `dtypes` on `device`: the f32
    scratch of the draws is one layer, not the stack."""
    blocks = tree_map(lambda s, dt: torch.empty(s, dtype=dt, device=device),
                      shapes, dtypes)
    for i in range(n):
        tree_map(lambda dst, src: dst[i].copy_(src), blocks, draw())
    return blocks


def _layer(params, i: int):
    return tree_map(lambda a: a[i], params["blocks"])


def layer_views(blocks, n_layers: int):
    """Per-layer views of stacked blocks for a differentiated pass: one
    `unbind` per stacked leaf, whose backward is one stack. (Indexing
    `a[i]` per layer, as `_layer` does, would allocate a zero tensor of the
    whole stacked leaf in each select's backward.)"""
    split = tree_map(lambda a: torch.unbind(a, 0), blocks)
    return [tree_map(lambda parts: parts[i], split) for i in range(n_layers)]


def _train_layer(p, shared, x, positions, i: int, cfg: ModelConfig):
    """Layer i of a differentiated pass (the reference's `_apply_layer`):
    dense and vlm, attention + MLP; moe, attention + MoE; ssm, an RWKV6
    layer from zero state; hybrid, a Mamba2 layer and, after every
    attn_every-th, the shared block (params `shared`), whose attention
    writes no cache. Returns (x, the layer's MoE load-balance loss, or
    None outside the moe family)."""
    if cfg.family == "ssm":
        x, aux = _rwkv_layer(p, x, cfg)[0], None
    elif cfg.family == "hybrid":
        spec = attn_spec(cfg, sliding=True)
        x, _ = _mamba_layer(p, x, cfg)
        x, aux = _shared_block(
            shared, x, i, cfg,
            lambda pa, h, occ: attn.attention_full(pa, h, spec,
                                                   positions)[0]), None
    else:
        h = common.rms_norm(x, p["ln1_w"], cfg.norm_eps)
        a, _ = attn.attention_full(p["attn"], h, attn_spec(cfg), positions)
        x = constrain(x + a, "batch", "seq", "embed")
        x, aux = _ffn(p, x, cfg)
    return constrain(x, "batch", "seq", "embed"), aux


def _train_group(ps, shared, x, positions, i0: int, cfg: ModelConfig):
    """Layers i0, i0 + 1, ... (params `ps`, one dict a layer) in turn, as
    `_train_layer`: (x, the sum of their MoE losses, or None)."""
    aux = None
    for j, p in enumerate(ps):
        x, a = _train_layer(p, shared, x, positions, i0 + j, cfg)
        if a is not None:
            aux = a if aux is None else aux + a
    return x, aux


def embed_tokens(params, tokens, cfg: ModelConfig):
    return constrain(params["embed"][tokens.long()], "batch", "seq", "embed")


def logits_from(params, x, cfg: ModelConfig):
    x = common.rms_norm(x, params["final_norm_w"], cfg.norm_eps)
    logits = constrain(x @ params["lm_head"], "batch", "seq", "vocab")
    # mask padded vocab slots out of the softmax
    if cfg.vocab_padded != cfg.vocab_size:
        logits[..., cfg.vocab_size:] = -1e9
    return logits


def forward_train(params, batch, cfg: ModelConfig, *, remat: str = "full"):
    """batch: {'tokens': [B,T] int, 'labels': [B,T] int (-1 = masked),
    optional 'img_embeds': [B,Ti,D] (vlm)} -> (loss, metrics).

    `remat="full"` recomputes each layer's activations in the backward
    (non-reentrant `torch.utils.checkpoint` around the layer, the
    reference's per-layer `jax.checkpoint`); `"group"` checkpoints groups
    of `cfg.remat_group_` layers and nothing inside them (the reference's
    outer checkpoint alone); `"none"` keeps every activation. The vlm
    family puts `img_embeds @ img_proj` ahead of the token embeddings,
    their labels -1. The loss is the cross entropy plus MOE_AUX_COEF times
    the layers' mean MoE load-balance loss (`moe_aux`, their sum; zero
    outside the moe family)."""
    _check_family(cfg)
    if remat not in REMAT_MODES:
        raise NotImplementedError(
            f"remat={remat!r} is not a remat mode (have {REMAT_MODES})")
    x = embed_tokens(params, batch["tokens"], cfg)
    labels = batch["labels"]
    if cfg.family == "vlm" and "img_embeds" in batch:
        img = batch["img_embeds"].to(x.dtype) @ params["img_proj"]
        x = torch.cat([img, x], dim=1)
        labels = torch.cat([labels.new_full(img.shape[:2], -1), labels],
                           dim=1)
    B, T = x.shape[0], x.shape[1]
    positions = torch.arange(T, dtype=torch.int32,
                             device=x.device)[None].expand(B, T)
    shared = params.get("shared")
    layers = layer_views(params["blocks"], cfg.n_layers)
    G = cfg.remat_group_ if remat == "group" else 1
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i0 in range(0, cfg.n_layers, G):
        if remat == "none":
            x, a = _train_group(layers[i0:i0 + G], shared, x, positions, i0,
                                cfg)
        else:
            x, a = checkpoint(_train_group, layers[i0:i0 + G], shared, x,
                              positions, i0, cfg, use_reentrant=False)
        if a is not None:
            aux = aux + a
    logits = logits_from(params, x, cfg)
    loss = common.softmax_cross_entropy(logits, labels)
    total = loss + MOE_AUX_COEF * aux / max(cfg.n_layers, 1)
    return total, {"ce_loss": loss, "moe_aux": aux}


def init_decode_cache(cfg: ModelConfig, batch: int, max_len: int,
                      device="cuda"):
    """Stacked per-layer cache, laid out as the module docstring says (the
    ssm family's ignores `max_len`)."""
    _check_family(cfg)
    dtype = common.default_dtype(cfg.dtype)

    def stack(c, n):
        return {k: v[None].expand((n,) + v.shape).contiguous()
                for k, v in c.items()}

    if cfg.family == "hybrid":
        convs, ssm = mamba2.init_mamba2_state(batch, mamba_spec(cfg), dtype,
                                              device)
        kv = attn.init_kv_cache(batch, max_len, attn_spec(cfg, sliding=True),
                                dtype, device)
        return {"mamba": stack({**dict(zip(CONV_KEYS, convs)), "ssm": ssm},
                               cfg.n_layers),
                "shared_kv": stack(kv, cfg.n_layers // cfg.attn_every)}
    if cfg.family == "ssm":
        c = dict(zip(RWKV_CACHE_KEYS, rwkv6.init_rwkv6_state(
            batch, rwkv_spec(cfg), dtype, device)))
    else:
        c = attn.init_kv_cache(batch, max_len, attn_spec(cfg), dtype, device)
    return stack(c, cfg.n_layers)


def _ffn(p, x, cfg: ModelConfig):
    """x + the layer's feed-forward on rms_norm(x): the MoE where the layer
    has one, else the SwiGLU. Returns (x, the MoE's load-balance loss or
    None)."""
    h = common.rms_norm(x, p["ln2_w"], cfg.norm_eps)
    if "moe" in p:
        m, am = mlp.moe_apply(p["moe"], h, moe_spec(cfg))
        return x + m, am["moe_aux"]
    return x + mlp.swiglu(p["mlp"], h), None


def _block_tail(p, x, cfg: ModelConfig):
    return _ffn(p, x, cfg)[0]


def _mamba_layer(p, x, cfg: ModelConfig, state=None, ssm_out=None):
    """One hybrid layer: x + mamba2(rms_norm(x)), continuing from `state`
    ((conv_x, conv_B, conv_C), ssm) or from zeros, the new ssm state
    written into `ssm_out` when given. Returns (x, state)."""
    h = common.rms_norm(x, p["ln1_w"], cfg.norm_eps)
    m, state = mamba2.mamba2_forward(p["mamba"], h, mamba_spec(cfg),
                                     init_state=state, ssm_out=ssm_out)
    return x + m, state


def _mamba_state(cache, i: int):
    """Layer i's state in the hybrid cache, as views, in the reference's
    tuple layout."""
    return tuple(cache[k][i] for k in CONV_KEYS), cache["ssm"][i]


def _shared_block(shared, x, i: int, cfg: ModelConfig, attend):
    """The hybrid family's shared attention + MLP block (params `shared`),
    which follows every attn_every-th layer: after layer i, its occurrence
    occ (the index of its KV cache) runs on x, `attend(p, h, occ)` running
    the attention (params p) on the normed h and, when serving, writing
    occurrence occ's KV cache. After any other layer x is returned as it
    is."""
    if (i + 1) % cfg.attn_every:
        return x
    occ = (i + 1) // cfg.attn_every - 1
    h = common.rms_norm(x, shared["ln1_w"], cfg.norm_eps)
    return _block_tail(shared, x + attend(shared["attn"], h, occ), cfg)


def _store_convs(cache, i: int, state) -> None:
    """Layer i's conv states into the hybrid cache (its ssm state is
    already there: the scan wrote it in place)."""
    for key, value in zip(CONV_KEYS, state[0]):
        cache[key][i].copy_(value)


def _rwkv_layer(p, x, cfg: ModelConfig, state=None, wkv_out=None):
    """One RWKV6 layer; `state` is (wkv, tm_last, cm_last) to continue from,
    or None; the new wkv state is written into `wkv_out` when given.
    Returns (x, (wkv, tm_last, cm_last))."""
    wkv, tm_last, cm_last = state if state is not None else (None,) * 3
    h = common.layer_norm(x, p["ln1_w"], p["ln1_b"], cfg.norm_eps)
    a, (wkv, tm_last) = rwkv6.rwkv6_time_mix(
        p["rwkv_tm"], h, rwkv_spec(cfg), init_state=wkv, last_x=tm_last,
        state_out=wkv_out)
    x = x + a
    h = common.layer_norm(x, p["ln2_w"], p["ln2_b"], cfg.norm_eps)
    c, cm_last = rwkv6.rwkv6_channel_mix(p["rwkv_tm"], h, last_x=cm_last)
    return x + c, (wkv, tm_last, cm_last)


def decode_step(params, cache, tokens, cur_index: int, cfg: ModelConfig):
    """One serving step: tokens [B,1] -> (logits [B,1,V], cache), the cache
    written in place (dense: at slot `cur_index`; ssm: the recurrent state,
    `cur_index` unused; hybrid: each layer's Mamba2 state, and each shared
    occurrence's KV cache at slot `cur_index % S`). The scans read and
    write the wkv / ssm state in its cache slice."""
    _check_family(cfg)
    x = embed_tokens(params, tokens, cfg)
    if cfg.family == "ssm":
        for i in range(cfg.n_layers):
            x, state = _rwkv_layer(_layer(params, i), x, cfg,
                                   tuple(cache[k][i] for k in RWKV_CACHE_KEYS),
                                   wkv_out=cache["wkv"][i])
            for key, value in zip(RWKV_CACHE_KEYS[1:], state[1:]):
                cache[key][i].copy_(value)
        return logits_from(params, x, cfg), cache
    if cfg.family == "hybrid":
        spec, kv = attn_spec(cfg, sliding=True), cache["shared_kv"]

        def attend(p, h, occ):
            return attn.attention_decode(
                p, h, {"k": kv["k"][occ], "v": kv["v"][occ]}, cur_index,
                spec)[0]

        for i in range(cfg.n_layers):
            x, state = _mamba_layer(_layer(params, i), x, cfg,
                                    _mamba_state(cache["mamba"], i),
                                    ssm_out=cache["mamba"]["ssm"][i])
            _store_convs(cache["mamba"], i, state)
            x = _shared_block(params["shared"], x, i, cfg, attend)
        return logits_from(params, x, cfg), cache
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
    cache = init_decode_cache(cfg, B, max_len, x.device)
    if cfg.family == "ssm":
        for i in range(cfg.n_layers):
            x, state = _rwkv_layer(_layer(params, i), x, cfg,
                                   wkv_out=cache["wkv"][i])
            for key, value in zip(RWKV_CACHE_KEYS[1:], state[1:]):
                cache[key][i] = value
        return logits_from(params, x[:, -1:], cfg), cache, T
    positions = torch.arange(T, dtype=torch.int32,
                             device=x.device)[None].expand(B, T)
    if cfg.family == "hybrid":
        spec, kv = attn_spec(cfg, sliding=True), cache["shared_kv"]
        W = kv["k"].shape[2]

        def attend(p, h, occ):
            a, (k, v) = attn.attention_full(p, h, spec, positions)
            if T <= W:
                kv["k"][occ, :, :T] = k
                kv["v"][occ, :, :T] = v
            else:
                # rolling window: position p lives at slot p % W
                kv["k"][occ] = torch.roll(k[:, -W:], T % W, dims=1)
                kv["v"][occ] = torch.roll(v[:, -W:], T % W, dims=1)
            return a

        for i in range(cfg.n_layers):
            x, state = _mamba_layer(_layer(params, i), x, cfg,
                                    ssm_out=cache["mamba"]["ssm"][i])
            _store_convs(cache["mamba"], i, state)
            x = _shared_block(params["shared"], x, i, cfg, attend)
        return logits_from(params, x[:, -1:], cfg), cache, T
    spec = attn_spec(cfg)
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
