"""Shared model building blocks: norms (RMS and layer norm), rotary embeddings, initializers,
the loss and the TP head-padding planner (`HeadPlan`, copied verbatim from
`repro/models/common.py`).

Parameters are plain dicts of tensors; the functions are plain functions on
tensors. Initializers draw from an explicit `torch.Generator` on the
generator's device."""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.parallel.sharding import tp_local


def default_dtype(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[name]


def resolve_device(device) -> torch.device:
    """`device` as a torch.device; a CUDA device must exist — there is no
    quiet fallback to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device={device!r} but no CUDA device is "
                           f"available; pass device='cpu' to run on the CPU")
    return dev


# ---------------------------------------------------------------------------
# Initializers (same distributions as the reference; torch draws its own
# numbers, so parity tests carry the reference's weights over instead)
# ---------------------------------------------------------------------------

def dense_init(gen: torch.Generator, shape, in_axis_size: int,
               dtype=torch.float32, scale: float = 1.0) -> torch.Tensor:
    """Truncated-normal fan-in init (LLM standard): N(0, 1) cut at +-2,
    times scale / sqrt(fan_in), drawn in f32 and cast."""
    std = scale / math.sqrt(max(1, in_axis_size))
    w = torch.empty(shape, dtype=torch.float32, device=gen.device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (w * std).to(dtype)


def embed_init(gen: torch.Generator, shape, dtype=torch.float32):
    w = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=gen.device)
    return (w * 0.02).to(dtype)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rms_norm(x, weight, eps: float = 1e-5):
    dt = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps)
    return (out * weight.float()).to(dt)


def layer_norm(x, weight, bias, eps: float = 1e-5):
    dt = x.dtype
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    out = (x - mu) * torch.rsqrt(var + eps)
    return (out * weight.float() + bias.float()).to(dt)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------

def rotary_angles(positions, head_dim: int, theta: float = 1e4):
    """positions [*, T] int -> (sin, cos) each [*, T, head_dim//2] f32."""
    half = head_dim // 2
    exponent = torch.arange(half, dtype=torch.float32,
                            device=positions.device) / half
    freq = 1.0 / (theta ** exponent)
    ang = positions.float()[..., None] * freq
    return torch.sin(ang), torch.cos(ang)


def apply_rotary(x, sin, cos):
    """x [..., T, H, Dh]; sin/cos [..., T, Dh//2] (broadcast over heads)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    sin = sin[..., None, :]
    cos = cos[..., None, :]
    x1f, x2f = x1.float(), x2.float()
    out = torch.cat([x1f * cos - x2f * sin, x2f * cos + x1f * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------

def softmax_cross_entropy(logits, labels, z_loss: float = 1e-4,
                          n_vocab: int | None = None):
    """Mean token cross-entropy with optional z-loss; logits [*, V] cast to
    f32. labels == -1 are masked out (padding). With `n_vocab` (the padded
    vocab) and logits holding this rank's block of it, the vocab-parallel
    form: the max, the sum of exponentials and the label's logit reduced
    over the model group."""
    tp = None if n_vocab is None else tp_local(logits.shape[-1], n_vocab)
    logits = logits.float()
    mask = labels >= 0
    safe = torch.where(mask, labels, 0).long()
    if tp is None:
        lse = torch.logsumexp(logits, dim=-1)
        ll = logits.gather(-1, safe[..., None])[..., 0]
    else:
        n = logits.shape[-1]
        m = tp.max(logits.amax(-1))
        lse = torch.log(tp.reduce(torch.exp(logits - m[..., None]).sum(-1))
                        ) + m
        local = safe - tp.rank * n
        mine = (local >= 0) & (local < n)
        ll = tp.reduce(torch.where(mine, logits.gather(
            -1, local.clamp(0, n - 1)[..., None])[..., 0], 0.0))
    nll = lse - ll
    if z_loss:
        nll = nll + z_loss * lse.square()
    denom = mask.sum().clamp(min=1)
    return torch.where(mask, nll, 0.0).sum() / denom


# ---------------------------------------------------------------------------
# Vocab-parallel embedding and logits
# ---------------------------------------------------------------------------

def embed_lookup(table, tokens, n_vocab: int):
    """table[tokens]; where `table` holds this rank's block of the
    `n_vocab` rows, a masked lookup of the rank's rows (zeros elsewhere)
    reduced over the model group."""
    tp = tp_local(table.shape[0], n_vocab)
    if tp is None:
        return table[tokens.long()]
    n = table.shape[0]
    local = tokens.long() - tp.rank * n
    mine = (local >= 0) & (local < n)
    rows = table[local.clamp(0, n - 1)]
    return tp.reduce(torch.where(mine[..., None], rows, 0))


def mask_padded_vocab(logits, vocab_size: int, n_vocab: int):
    """Sets the padded vocab slots (global index >= vocab_size) to -1e9 in
    place, on the whole vocab or on this rank's block of it."""
    tp = tp_local(logits.shape[-1], n_vocab)
    lo = 0 if tp is None else tp.rank * logits.shape[-1]
    start = max(vocab_size - lo, 0)
    if start < logits.shape[-1]:
        logits[..., start:] = -1e9
    return logits


def unembed(x, lm_head, n_vocab: int):
    """x @ lm_head, where `lm_head` [D, Vp] may hold this rank's vocab
    block: x then enters the model region, and the logits stay the rank's
    block (the reference's logits sharded over vocab)."""
    tp = tp_local(lm_head.shape[-1], n_vocab)
    return (x if tp is None else tp.copy(x)) @ lm_head


# ---------------------------------------------------------------------------
# Head-padding planner: make any (n_q, n_kv) GQA layout shard exactly on a
# tp-way model axis. Padded q heads have zeroed projections (their outputs
# are multiplied by zeroed W_o rows => numerically exact); kv heads are
# *duplicated* (gather of original rows => numerically exact).
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class HeadPlan:
    n_q: int                  # original query heads
    n_kv: int                 # original kv heads
    n_q_pad: int              # padded query heads (multiple of tp)
    n_kv_pad: int             # padded kv heads (multiple of tp)
    group: int                # n_q_pad // n_kv_pad
    kv_src: tuple[int, ...]   # len n_kv_pad: original kv head feeding each slot
    q_src: tuple[int, ...]    # len n_q_pad: original q head per slot, -1 = zero pad

    @property
    def q_pad_mask(self) -> np.ndarray:
        return np.asarray([s >= 0 for s in self.q_src])


def plan_head_padding(n_q: int, n_kv: int, tp: int) -> HeadPlan:
    """Construct an exact TP-shardable padded head layout.

    Invariants:
      * n_q_pad % tp == 0 and n_kv_pad % tp == 0
      * uniform group size G = n_q_pad / n_kv_pad (integer)
      * q slot i attends kv slot i // G, whose source equals the original
        kv head of the original q head in slot i (when not a pad slot).
    """
    if n_q % n_kv != 0:
        raise ValueError(f"GQA requires n_kv | n_q, got {n_q=}, {n_kv=}")
    g_orig = n_q // n_kv

    if n_q == n_kv and n_kv % tp != 0:
        # MHA: zero-pad both q and kv to the same padded count
        n_kv_pad = tp * math.ceil(n_q / tp)
        n_q_pad = n_kv_pad
        kv_src = [k if k < n_kv else -1 for k in range(n_kv_pad)]
        q_src = [k if k < n_q else -1 for k in range(n_q_pad)]
    else:
        # GQA/MQA (or already-divisible MHA): duplicate kv heads to the
        # smallest multiple of both n_kv and tp, split q groups across copies
        n_kv_pad = n_kv if n_kv % tp == 0 else math.lcm(n_kv, tp)
        dup = n_kv_pad // n_kv
        g = max(1, math.ceil(g_orig / dup))
        kv_src, q_src = [], []
        for k in range(n_kv):
            qs = list(range(k * g_orig, (k + 1) * g_orig))
            for c in range(dup):
                kv_src.append(k)
                chunk = qs[c * g:(c + 1) * g]
                chunk += [-1] * (g - len(chunk))
                q_src.extend(chunk)
        n_q_pad = len(q_src)

    if n_q_pad % tp != 0 or n_kv_pad % tp != 0 or n_q_pad % n_kv_pad != 0:
        raise AssertionError(
            f"planner failed: q={n_q}->{n_q_pad} kv={n_kv}->{n_kv_pad} tp={tp}")
    return HeadPlan(n_q, n_kv, n_q_pad, n_kv_pad, n_q_pad // n_kv_pad,
                    tuple(kv_src), tuple(q_src))
