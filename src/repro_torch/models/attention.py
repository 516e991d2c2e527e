"""GQA attention with TP head padding, rotary embeddings, causal masking,
prefill and single-token decode paths (port of `repro/models/attention.py`).

The O(T^2) core goes through `repro_torch.kernels.ops`: the flash-attention
forward kernel for prefill, the decode-attention kernel for each new token.
This module owns projections, rotary and KV-cache handling."""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels import ops as kops
from repro_torch.models import common
from repro_torch.models.common import HeadPlan


@dataclasses.dataclass(frozen=True)
class AttnSpec:
    d_model: int
    head_dim: int
    plan: HeadPlan
    qkv_bias: bool = False
    rope_theta: float = 1e4
    causal: bool = True
    sliding_window: int = 0      # 0 = full attention
    use_rotary: bool = True


def init_attention(gen: torch.Generator, spec: AttnSpec,
                   dtype=torch.float32):
    D, Dh = spec.d_model, spec.head_dim
    nq, nkv = spec.plan.n_q_pad, spec.plan.n_kv_pad
    p = {
        "wq": common.dense_init(gen, (D, nq, Dh), D, dtype),
        "wk": common.dense_init(gen, (D, nkv, Dh), D, dtype),
        "wv": common.dense_init(gen, (D, nkv, Dh), D, dtype),
        "wo": common.dense_init(gen, (nq, Dh, D), nq * Dh, dtype),
    }
    if spec.qkv_bias:
        for name, n in (("bq", nq), ("bk", nkv), ("bv", nkv)):
            p[name] = torch.zeros((n, Dh), dtype=dtype, device=gen.device)
    # zero the padded q slots so padding stays numerically exact
    pad = torch.from_numpy(~spec.plan.q_pad_mask).to(gen.device)
    p["wq"][:, pad] = 0
    p["wo"][pad] = 0
    return p


def _proj(x, w):
    """x [B,T,D] @ w [D,H,Dh] -> [B,T,H,Dh]."""
    D, H, Dh = w.shape
    return (x @ w.reshape(D, H * Dh)).reshape(*x.shape[:-1], H, Dh)


def _out_proj(o, w):
    """o [B,T,H,Dh] @ w [H,Dh,D] -> [B,T,D]."""
    H, Dh, D = w.shape
    return o.reshape(*o.shape[:-2], H * Dh) @ w.reshape(H * Dh, D)


def _project_qkv(params, x, spec: AttnSpec, positions):
    q = _proj(x, params["wq"])
    k = _proj(x, params["wk"])
    v = _proj(x, params["wv"])
    if spec.qkv_bias:
        q = q + params["bq"]
        k = k + params["bk"]
        v = v + params["bv"]
    if spec.use_rotary:
        sin, cos = common.rotary_angles(positions, spec.head_dim,
                                        spec.rope_theta)
        q = common.apply_rotary(q, sin, cos)
        k = common.apply_rotary(k, sin, cos)
    return q, k, v


def attention_full(params, x, spec: AttnSpec, positions=None):
    """Prefill attention. x [B,T,D]; returns ([B,T,D], (k, v))."""
    B, T, _ = x.shape
    if positions is None:
        positions = torch.arange(T, dtype=torch.int32, device=x.device)[None]
    q, k, v = _project_qkv(params, x, spec, positions)
    out = kops.flash_attention(q, k, v, causal=spec.causal,
                               group=spec.plan.group,
                               sliding_window=spec.sliding_window)
    return _out_proj(out, params["wo"]), (k, v)


def init_kv_cache(batch: int, max_len: int, spec: AttnSpec,
                  dtype=torch.bfloat16, device="cuda"):
    device = common.resolve_device(device)
    nkv, Dh = spec.plan.n_kv_pad, spec.head_dim
    size = min(max_len, spec.sliding_window or max_len)
    return {"k": torch.zeros((batch, size, nkv, Dh), dtype=dtype,
                             device=device),
            "v": torch.zeros((batch, size, nkv, Dh), dtype=dtype,
                             device=device)}


def attention_decode(params, x, cache, cur_index: int, spec: AttnSpec):
    """Single-token decode. x [B,1,D]; cache holds k/v [B,S,nkv,Dh];
    cur_index (a host int) — number of tokens already in the cache.

    Writes the new token's K/V into slot `cur_index % S` IN PLACE (the
    reference returns an updated copy; in place saves a cache copy per
    layer per token) and returns (y [B,1,D], cache)."""
    B = x.shape[0]
    positions = torch.full((B, 1), cur_index, dtype=torch.int32,
                           device=x.device)
    q, k, v = _project_qkv(params, x, spec, positions)
    S = cache["k"].shape[1]
    slot = cur_index % S
    cache["k"][:, slot] = k[:, 0].to(cache["k"].dtype)
    cache["v"][:, slot] = v[:, 0].to(cache["v"].dtype)
    # valid positions: < cur_index+1 (non-window) or everything once wrapped
    n_valid = min(cur_index + 1, S)
    lengths = torch.full((B,), n_valid, dtype=torch.int32, device=x.device)
    out = kops.decode_attention(q, cache["k"], cache["v"], lengths,
                                group=spec.plan.group)
    return _out_proj(out, params["wo"]), cache
