"""Whisper-style encoder-decoder backbone (the encdec family), ported from
`repro/models/encdec.py`.

The conv frontend is a stub: `data.pipeline.stub_frontend_inputs` supplies
precomputed frame embeddings [B, enc_seq, D] (what the two conv1d layers
would produce). Encoder: pre-LN non-causal MHA + GELU MLP with learned
positions. Decoder: causal self-attention + cross-attention + GELU MLP.

Parameters keep the reference's tree and leaf names, the per-layer weights
stacked on a leading layer axis (`enc_blocks`, `dec_blocks`). The
reference's `lax.scan` over layers is a Python loop over that axis, and
its sharding constraints (on the encoder's and the decoder's inputs and on
the logits) are `parallel.sharding.constrain` (`models/lm.py`). The
decode cache, the decoder's self-attention KV cache `{"k", "v": [n_layers,
B, S, nkv, Dh]}`, is written in place by `decode_step`; the cross K/V
(`cross_kv`, stacked the same way over the encoder's S positions) is read
only. The family has no prefill: a serve loop feeds the decoder a token at
a time from `cur_index` 0."""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import common, mlp
from repro_torch.models.attention import AttnSpec
from repro_torch.models.lm import draw_stacked, layer_views, tree_map
from repro_torch.parallel.sharding import constrain

DEC_POSITIONS = 4 * 32768       # the reference's learned decoder positions


def enc_attn_spec(cfg: ModelConfig) -> AttnSpec:
    return AttnSpec(d_model=cfg.d_model, head_dim=cfg.head_dim_,
                    plan=cfg.head_plan(), qkv_bias=True, causal=False,
                    use_rotary=False)


def dec_attn_spec(cfg: ModelConfig) -> AttnSpec:
    return AttnSpec(d_model=cfg.d_model, head_dim=cfg.head_dim_,
                    plan=cfg.head_plan(), qkv_bias=True, causal=True,
                    use_rotary=False)


def _ln(x, p, eps):
    return common.layer_norm(x, p["w"], p["b"], eps)


def param_shapes(cfg: ModelConfig) -> dict[str, Any]:
    """The parameter tree's shapes (the reference's `init_encdec` tree)."""
    D, Dh, F, Vp = cfg.d_model, cfg.head_dim_, cfg.d_ff, cfg.vocab_padded
    plan = cfg.head_plan()
    nq, nkv = plan.n_q_pad, plan.n_kv_pad
    a = {"wq": (D, nq, Dh), "wk": (D, nkv, Dh), "wv": (D, nkv, Dh),
         "wo": (nq, Dh, D), "bq": (nq, Dh), "bk": (nkv, Dh),
         "bv": (nkv, Dh)}
    ln = {"w": (D,), "b": (D,)}
    ffn = {"w_in": (D, F), "b_in": (F,), "w_out": (F, D), "b_out": (D,)}
    enc = {"ln1": ln, "attn": a, "ln2": ln, "mlp": ffn}
    dec = {"ln1": ln, "self_attn": a, "ln2": ln, "cross_attn": a,
           "ln3": ln, "mlp": ffn}
    ne = cfg.n_enc_layers or cfg.n_layers

    def stack(block, n):
        return tree_map(lambda s: (n,) + s, block)

    return {"enc_pos": (cfg.enc_seq_len, D), "enc_blocks": stack(enc, ne),
            "enc_ln": ln, "embed": (Vp, D), "dec_pos": (DEC_POSITIONS, D),
            "dec_blocks": stack(dec, cfg.n_layers), "dec_ln": ln,
            "lm_head": (D, Vp)}


def param_dtypes(cfg: ModelConfig) -> dict[str, Any]:
    """Every leaf in `cfg.dtype`, as the reference makes them."""
    dtype = common.default_dtype(cfg.dtype)
    return tree_map(lambda s: dtype, param_shapes(cfg))


def _init_ln(dtype, d, dev):
    return {"w": torch.ones((d,), dtype=dtype, device=dev),
            "b": torch.zeros((d,), dtype=dtype, device=dev)}


def _init_enc_block(gen: torch.Generator, cfg: ModelConfig, dtype):
    D, dev = cfg.d_model, gen.device
    return {"ln1": _init_ln(dtype, D, dev),
            "attn": attn.init_attention(gen, enc_attn_spec(cfg), dtype),
            "ln2": _init_ln(dtype, D, dev),
            "mlp": mlp.init_gelu_mlp(gen, D, cfg.d_ff, dtype)}


def _init_dec_block(gen: torch.Generator, cfg: ModelConfig, dtype):
    D, dev = cfg.d_model, gen.device
    return {"ln1": _init_ln(dtype, D, dev),
            "self_attn": attn.init_attention(gen, dec_attn_spec(cfg), dtype),
            "ln2": _init_ln(dtype, D, dev),
            "cross_attn": attn.init_attention(gen, enc_attn_spec(cfg),
                                              dtype),
            "ln3": _init_ln(dtype, D, dev),
            "mlp": mlp.init_gelu_mlp(gen, D, cfg.d_ff, dtype)}


def init_encdec(gen: torch.Generator, cfg: ModelConfig):
    """Random weights drawn from `gen` on the generator's device, with the
    reference's distributions and tree."""
    dtype = common.default_dtype(cfg.dtype)
    dev = gen.device
    D = cfg.d_model
    shapes, dtypes = param_shapes(cfg), param_dtypes(cfg)
    ne = cfg.n_enc_layers or cfg.n_layers
    return {
        "enc_pos": common.embed_init(gen, shapes["enc_pos"], dtype),
        "enc_blocks": draw_stacked(
            shapes["enc_blocks"], dtypes["enc_blocks"], ne,
            lambda: _init_enc_block(gen, cfg, dtype), dev),
        "enc_ln": _init_ln(dtype, D, dev),
        "embed": common.embed_init(gen, shapes["embed"], dtype),
        "dec_pos": common.embed_init(gen, shapes["dec_pos"], dtype),
        "dec_blocks": draw_stacked(
            shapes["dec_blocks"], dtypes["dec_blocks"], cfg.n_layers,
            lambda: _init_dec_block(gen, cfg, dtype), dev),
        "dec_ln": _init_ln(dtype, D, dev),
        "lm_head": common.dense_init(gen, shapes["lm_head"], D, dtype),
    }


def encode(params, frames, cfg: ModelConfig):
    """frames [B, enc_seq, D] (the stub frontend's output) -> encoder
    states [B, enc_seq, D]."""
    x = frames.to(common.default_dtype(cfg.dtype))
    x = constrain(x + params["enc_pos"][None, : x.shape[1]], "batch", "seq",
                  "embed")
    spec = enc_attn_spec(cfg)
    ne = cfg.n_enc_layers or cfg.n_layers
    for p in layer_views(params["enc_blocks"], ne):
        h = _ln(x, p["ln1"], cfg.norm_eps)
        a, _ = attn.attention_full(p["attn"], h, spec)
        x = x + a
        h = _ln(x, p["ln2"], cfg.norm_eps)
        x = x + mlp.gelu_mlp(p["mlp"], h)
    return _ln(x, params["enc_ln"], cfg.norm_eps)


def cross_kv(params, enc_states, cfg: ModelConfig):
    """Each decoder layer's cross-attention K/V from the encoder states:
    {"k", "v": [n_layers, B, S, nkv, Dh]}."""
    spec = enc_attn_spec(cfg)
    kv = [attn.encode_kv(p["cross_attn"], enc_states, spec)
          for p in layer_views(params["dec_blocks"], cfg.n_layers)]
    return {"k": torch.stack([k for k, _ in kv]),
            "v": torch.stack([v for _, v in kv])}


def _mask_vocab(logits, cfg: ModelConfig):
    if cfg.vocab_padded != cfg.vocab_size:
        logits[..., cfg.vocab_size:] = -1e9
    return logits


def decode_train(params, enc_states, tokens, cfg: ModelConfig):
    """Teacher-forced decoder pass -> logits [B,T,Vp], the padded vocab
    slots masked. Each layer computes its cross K/V from `enc_states`, so
    the pass differentiates through them."""
    B, T = tokens.shape
    x = constrain(params["embed"][tokens.long()] + params["dec_pos"][None, :T],
                  "batch", "seq", "embed")
    sspec, cspec = dec_attn_spec(cfg), enc_attn_spec(cfg)
    for p in layer_views(params["dec_blocks"], cfg.n_layers):
        h = _ln(x, p["ln1"], cfg.norm_eps)
        a, _ = attn.attention_full(p["self_attn"], h, sspec)
        x = x + a
        h = _ln(x, p["ln2"], cfg.norm_eps)
        ckv = attn.encode_kv(p["cross_attn"], enc_states, cspec)
        a, _ = attn.attention_full(p["cross_attn"], h, cspec, cross_kv=ckv)
        x = x + a
        h = _ln(x, p["ln3"], cfg.norm_eps)
        x = x + mlp.gelu_mlp(p["mlp"], h)
    x = _ln(x, params["dec_ln"], cfg.norm_eps)
    return constrain(_mask_vocab(x @ params["lm_head"], cfg), "batch", "seq",
                     "vocab")


def forward_train(params, batch, cfg: ModelConfig, *, remat: str = "full"):
    """batch: {'frames': [B,S,D], 'tokens': [B,T], 'labels': [B,T] (-1 =
    masked)} -> (loss, metrics). `remat` is taken and ignored, as the
    reference ignores it: the family keeps every activation."""
    enc = encode(params, batch["frames"], cfg)
    logits = decode_train(params, enc, batch["tokens"], cfg)
    loss = common.softmax_cross_entropy(logits, batch["labels"])
    return loss, {"ce_loss": loss,
                  "moe_aux": torch.zeros((), dtype=torch.float32,
                                         device=loss.device)}


def init_decode_cache(cfg: ModelConfig, batch: int, max_len: int,
                      device="cuda"):
    """The decoder's self-attention KV cache, stacked over its layers."""
    dtype = common.default_dtype(cfg.dtype)
    kv = attn.init_kv_cache(batch, max_len, dec_attn_spec(cfg), dtype,
                            device)
    return {k: v[None].expand((cfg.n_layers,) + v.shape).contiguous()
            for k, v in kv.items()}


def decode_step(params, cache, xkv, tokens, cur_index: int,
                cfg: ModelConfig):
    """One serving step: tokens [B,1] at position `cur_index` (a host int)
    -> (logits [B,1,Vp], cache), the self-attention cache written in place
    at slot `cur_index`; xkv: the stacked cross K/V from `cross_kv`. As in
    the reference, the padded vocab slots are not masked here."""
    x = params["embed"][tokens.long()] + params["dec_pos"][cur_index][None,
                                                                     None]
    sspec, cspec = dec_attn_spec(cfg), enc_attn_spec(cfg)
    for i in range(cfg.n_layers):
        p = tree_map(lambda a: a[i], params["dec_blocks"])
        h = _ln(x, p["ln1"], cfg.norm_eps)
        a, _ = attn.attention_decode(
            p["self_attn"], h, {"k": cache["k"][i], "v": cache["v"][i]},
            cur_index, sspec)
        x = x + a
        h = _ln(x, p["ln2"], cfg.norm_eps)
        a, _ = attn.attention_decode(p["cross_attn"], h, None, cur_index,
                                     cspec,
                                     cross_kv=(xkv["k"][i], xkv["v"][i]))
        x = x + a
        h = _ln(x, p["ln3"], cfg.norm_eps)
        x = x + mlp.gelu_mlp(p["mlp"], h)
    x = _ln(x, params["dec_ln"], cfg.norm_eps)
    return x @ params["lm_head"], cache
