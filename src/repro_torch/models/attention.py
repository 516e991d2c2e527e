"""GQA attention with TP head padding, rotary embeddings, causal masking,
prefill and single-token decode paths, and the encoder-decoder's cross
attention (port of `repro/models/attention.py`).

The O(T^2) core goes through `repro_torch.kernels.ops`: the flash-attention
forward kernel for prefill (and training, where its backward runs the
flash backward kernels), the decode-attention kernel for each new token.
This module owns projections, rotary and KV-cache handling.

Tensor parallelism: where `wq` holds this rank's block of the padded q
heads (placed over 'model'), the layer runs on those heads: the input
enters the model region (`sharding.tp_local`), q (and k, v where `wk`/`wv`
hold the matching kv block) are the rank's heads, the kernels run on them
unchanged, and the out-projection's partial sum is reduced over the model
group. Where the kv heads do not divide over the ranks (a kv leaf left
replicated), k and v are computed whole (and cached whole) and the rank's
q heads attend the kv heads they map onto."""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels import ops as kops
from repro_torch.models import common
from repro_torch.models.common import HeadPlan
from repro_torch.parallel.sharding import tp_local


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


def _tp(params, spec: AttnSpec):
    """The model group when `wq` holds this rank's block of the q heads,
    else None."""
    return tp_local(params["wq"].shape[1], spec.plan.n_q_pad)


def _kv_tp(params, spec: AttnSpec, tp) -> bool:
    """Whether `wk`/`wv` hold this rank's block of the kv heads."""
    return tp is not None and tp_local(params["wk"].shape[1],
                                       spec.plan.n_kv_pad) is not None


def _kv_proj(params, x, xt, spec: AttnSpec, tp):
    """k and v of x as the cache holds them: the rank's kv heads from the
    region input `xt` where the kv leaves hold a block, else whole from
    x."""
    src = xt if _kv_tp(params, spec, tp) else x
    k = _proj(src, params["wk"])
    v = _proj(src, params["wv"])
    if spec.qkv_bias:
        k = k + params["bk"]
        v = v + params["bv"]
    return k, v


def _project_qkv(params, x, spec: AttnSpec, positions, tp=None):
    xt = x if tp is None else tp.copy(x)
    q = _proj(xt, params["wq"])
    k, v = _kv_proj(params, x, xt, spec, tp)
    if spec.qkv_bias:
        q = q + params["bq"]
    if spec.use_rotary:
        sin, cos = common.rotary_angles(positions, spec.head_dim,
                                        spec.rope_theta)
        q = common.apply_rotary(q, sin, cos)
        k = common.apply_rotary(k, sin, cos)
    return q, k, v


def _project_q(params, x, spec: AttnSpec, tp=None):
    """The query alone, without rotary (cross attention)."""
    q = _proj(x if tp is None else tp.copy(x), params["wq"])
    return q + params["bq"] if spec.qkv_bias else q


def _local_kv(tp, q, k, v, spec: AttnSpec):
    """(k, v, group) that this rank's q heads attend: k and v as they are
    where they hold the matching kv heads; where they are whole (the kv
    leaves replicated) the kv heads of the rank's q heads, entered into
    the model region."""
    G, Hl = spec.plan.group, q.shape[2]
    if tp is None or k.shape[2] * G == Hl:
        return k, v, G
    off = tp.rank * Hl
    lo, hi = off // G, (off + Hl - 1) // G + 1
    if Hl % (hi - lo):
        raise ValueError(f"{Hl} q heads a rank do not map onto whole kv "
                         f"heads (group {G})")
    return (tp.copy(k)[:, :, lo:hi].contiguous(),
            tp.copy(v)[:, :, lo:hi].contiguous(), Hl // (hi - lo))


def _out(params, o, tp):
    y = _out_proj(o, params["wo"])
    return y if tp is None else tp.reduce(y)


def attention_full(params, x, spec: AttnSpec, positions=None, *,
                   cross_kv=None):
    """Training / prefill attention. x [B,T,D]; returns ([B,T,D], (k, v)).

    cross_kv: precomputed (k, v) [B,S,nkv,Dh] for encoder-decoder cross
    attention (`encode_kv`): q alone is projected, no rotary on either
    side, and no causal mask."""
    B, T, _ = x.shape
    tp = _tp(params, spec)
    if cross_kv is None:
        if positions is None:
            positions = torch.arange(T, dtype=torch.int32,
                                     device=x.device)[None]
        q, k, v = _project_qkv(params, x, spec, positions, tp)
    else:
        q = _project_q(params, x, spec, tp)
        k, v = cross_kv
    ka, va, group = _local_kv(tp, q, k, v, spec)
    out = kops.flash_attention(q, ka, va,
                               causal=spec.causal and cross_kv is None,
                               group=group,
                               sliding_window=spec.sliding_window)
    return _out(params, out, tp), (k, v)


def encode_kv(params, x_enc, spec: AttnSpec):
    """Cross-attention K/V from the encoder's output x_enc [B,S,D] ->
    (k, v) [B,S,nkv,Dh] (the rank's kv heads where the leaves hold a
    block)."""
    tp = _tp(params, spec)
    xt = tp.copy(x_enc) if _kv_tp(params, spec, tp) else x_enc
    return _kv_proj(params, x_enc, xt, spec, tp)


def init_kv_cache(batch: int, max_len: int, spec: AttnSpec,
                  dtype=torch.bfloat16, device="cuda"):
    device = common.resolve_device(device)
    nkv, Dh = spec.plan.n_kv_pad, spec.head_dim
    size = min(max_len, spec.sliding_window or max_len)
    return {"k": torch.zeros((batch, size, nkv, Dh), dtype=dtype,
                             device=device),
            "v": torch.zeros((batch, size, nkv, Dh), dtype=dtype,
                             device=device)}


def attention_decode(params, x, cache, cur_index: int, spec: AttnSpec, *,
                     cross_kv=None):
    """Single-token decode. x [B,1,D]; cache holds k/v [B,S,nkv,Dh];
    cur_index (a host int) — number of tokens already in the cache.

    Writes the new token's K/V into slot `cur_index % S` IN PLACE (the
    reference returns an updated copy; in place saves a cache copy per
    layer per token) and returns (y [B,1,D], cache). With `cross_kv`
    ((k, v) [B,S,nkv,Dh] from `encode_kv`) the query attends to all S
    encoder positions, no cache is read or written, and `cache` is
    returned as given."""
    B = x.shape[0]
    tp = _tp(params, spec)
    if cross_kv is None:
        positions = torch.full((B, 1), cur_index, dtype=torch.int32,
                               device=x.device)
        q, k, v = _project_qkv(params, x, spec, positions, tp)
        S = cache["k"].shape[1]
        slot = cur_index % S
        cache["k"][:, slot] = k[:, 0].to(cache["k"].dtype)
        cache["v"][:, slot] = v[:, 0].to(cache["v"].dtype)
        kk, vv = cache["k"], cache["v"]
        # valid positions: < cur_index+1 (non-window) or all once wrapped
        n_valid = min(cur_index + 1, S)
    else:
        q = _project_q(params, x, spec, tp)
        kk, vv = cross_kv
        n_valid = kk.shape[1]
    kk, vv, group = _local_kv(tp, q, kk, vv, spec)
    lengths = torch.full((B,), n_valid, dtype=torch.int32, device=x.device)
    out = kops.decode_attention(q, kk, vv, lengths, group=group,
                                n_valid=n_valid)
    return _out(params, out, tp), cache
