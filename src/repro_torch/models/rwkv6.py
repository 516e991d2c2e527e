"""RWKV6 ("Finch") block, ported from `repro/models/rwkv6.py`:
data-dependent-decay linear attention (time-mix) plus squared-ReLU
channel-mix. Attention-free: the decode state is one `[H, Dh, Dh]` f32
matrix per layer, whatever the sequence length.

The casts sit where the reference has them: the data-dependent lerp's
low-rank branch goes through tanh in f32 and back to the model dtype, the
decay is computed in f32 (`w_log = -exp(decay_base + dec)`, with
`decay_base` and `bonus_u` f32 parameters in any model dtype), and the
silu, squared ReLU and sigmoid run in f32. The recurrence itself is
`ops.rwkv6_scan` (K9). Unlike the reference, whose functions are pure, a
caller may hand the scan an output buffer for the state (`state_out`): the
serve path passes its cache slice, so a decode step updates the state in
place. The training path (`lm.forward_train`) passes none: every op here
is differentiable and writes nothing in place, and under grad the scan is
differentiable (K9's forward, the plain version's gradient; it refuses an
output buffer)."""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models import common
from repro_torch.parallel.sharding import tp_local

# parameters the reference creates in f32 whatever the model's dtype
F32_PARAMS = ("decay_base", "bonus_u")


@dataclasses.dataclass(frozen=True)
class Rwkv6Spec:
    d_model: int
    d_ff: int
    head_dim: int = 64
    lora_rank: int = 32

    @property
    def n_heads(self) -> int:
        return self.d_model // self.head_dim


def param_shapes(spec: Rwkv6Spec) -> dict[str, tuple[int, ...]]:
    D, H, Dh, R = spec.d_model, spec.n_heads, spec.head_dim, spec.lora_rank
    return {
        # time-mix (5 interpolation targets: w,k,v,r,g) - data-dependent lerp
        "mix_base": (5, D), "mix_w1": (D, 5 * R), "mix_w2": (5, R, D),
        "w_r": (D, D), "w_k": (D, D), "w_v": (D, D), "w_g": (D, D),
        "w_o": (D, D),
        # decay: w = -exp(w0 + tanh(x W_a) W_b) (low-rank data dependence)
        "decay_base": (D,), "decay_w1": (D, R), "decay_w2": (R, D),
        "bonus_u": (H, Dh), "ln_x_w": (D,), "ln_x_b": (D,),
        # channel-mix
        "cmix_k": (D,), "cmix_r": (D,), "cm_wk": (D, spec.d_ff),
        "cm_wv": (spec.d_ff, D), "cm_wr": (D, D),
    }


def init_rwkv6(gen: torch.Generator, spec: Rwkv6Spec, dtype=torch.float32):
    """Random weights from `gen` with the reference's distributions."""
    D, H, Dh, R = spec.d_model, spec.n_heads, spec.head_dim, spec.lora_rank
    dev = gen.device

    def full(shape, value, dt=dtype):
        return torch.full(shape, value, dtype=dt, device=dev)

    def dense(shape, fan_in):
        return common.dense_init(gen, shape, fan_in, dtype)

    return {
        "mix_base": full((5, D), 0.0),
        "mix_w1": dense((D, 5 * R), D),
        "mix_w2": dense((5, R, D), R),
        "w_r": dense((D, D), D),
        "w_k": dense((D, D), D),
        "w_v": dense((D, D), D),
        "w_g": dense((D, D), D),
        "w_o": dense((D, D), D),
        "decay_base": full((D,), -2.0, torch.float32),
        "decay_w1": dense((D, R), D),
        "decay_w2": dense((R, D), R),
        "bonus_u": full((H, Dh), 0.5, torch.float32),
        "ln_x_w": full((D,), 1.0),
        "ln_x_b": full((D,), 0.0),
        "cmix_k": full((D,), 0.0),
        "cmix_r": full((D,), 0.0),
        "cm_wk": dense((D, spec.d_ff), D),
        "cm_wv": dense((spec.d_ff, D), spec.d_ff),
        "cm_wr": dense((D, D), D),
    }


def _token_shift(x, last=None):
    """Shift the sequence right by one: y[t] = x[t-1]; slot 0 takes `last`
    (decode continuation) or zeros."""
    if last is None:
        last = torch.zeros_like(x[:, :1])
    return torch.cat([last, x[:, :-1]], dim=1)


def rwkv6_time_mix(params, x, spec: Rwkv6Spec, *, init_state=None,
                   last_x=None, state_out=None):
    """x [B,T,D] -> (y, (wkv_state [B,H,Dh,Dh] f32, last token [B,1,D])).
    With `state_out` (f32 [B,H,Dh,Dh], e.g. the decode cache's slice, which
    may be `init_state`) the scan writes the new state there in place and
    that tensor is returned."""
    B, T, D = x.shape
    Dh, R = spec.head_dim, spec.lora_rank
    xs = _token_shift(x, last_x)
    dx = xs - x

    # data-dependent lerp (ddlerp): 5 mixed inputs
    lora = torch.tanh((x @ params["mix_w1"]).reshape(B, T, 5, R).float())
    dyn = torch.einsum("btfr,frd->btfd", lora.to(x.dtype), params["mix_w2"])
    mix = params["mix_base"] + dyn                               # [B,T,5,D]
    xw, xk, xv, xr, xg = (x + dx * mix[:, :, i] for i in range(5))
    dec_in = torch.tanh((xw @ params["decay_w1"]).float()).to(x.dtype)

    # tensor parallelism over the heads: r, k, v, g, the decay and the
    # bonus are the rank's; the mixed inputs (and the decay's low-rank
    # input) enter the model region
    tp = tp_local(params["w_r"].shape[1], D)
    if tp is not None:
        xk, xv, xr, xg, dec_in = (tp.copy(a) for a in (xk, xv, xr, xg,
                                                       dec_in))
    Dl = params["w_r"].shape[1]
    H = Dl // Dh
    r = (xr @ params["w_r"]).reshape(B, T, H, Dh)
    k = (xk @ params["w_k"]).reshape(B, T, H, Dh)
    v = (xv @ params["w_v"]).reshape(B, T, H, Dh)
    g = xg @ params["w_g"]

    dec = dec_in @ params["decay_w2"]
    w_log = -torch.exp(_slice(tp, params["decay_base"], Dl) + dec.float())
    w_log = w_log.reshape(B, T, H, Dh)

    y, state = ops.rwkv6_scan(r, k, v, w_log, params["bonus_u"],
                              init_state=init_state, state_out=state_out)
    y = y.reshape(B, T, Dl)
    if tp is None:
        y = common.layer_norm(y, params["ln_x_w"], params["ln_x_b"])
    else:
        # ln_x is over the whole D: its mean and variance are reduced over
        # the model group; its weight and bias are cut to the rank's slice
        yf = y.float()
        mu = tp.allsum(yf.sum(-1, keepdim=True)) / D
        var = tp.allsum((yf - mu).square().sum(-1, keepdim=True)) / D
        y = ((yf - mu) * torch.rsqrt(var + 1e-5)
             * _slice(tp, params["ln_x_w"], Dl).float()
             + _slice(tp, params["ln_x_b"], Dl).float()).to(y.dtype)
    y = y * F.silu(g.float()).to(y.dtype)
    out = y @ params["w_o"]
    return (out if tp is None else tp.reduce(out)), (state, x[:, -1:])


def _slice(tp, w, n: int):
    """`w` ([D], replicated over 'model') as this rank's block of `n`
    entries, through the model region, so its gradient is the sum of the
    ranks' blocks: whole on every rank."""
    if tp is None:
        return w
    return tp.copy(w)[tp.rank * n:(tp.rank + 1) * n]


def rwkv6_channel_mix(params, x, *, last_x=None):
    """x [B,T,D] -> (y, last token [B,1,D]). Tensor-parallel where the
    leaves hold this rank's blocks (`cm_wr` of its columns, `cm_wk` of the
    ff): cm_wk column-parallel, cm_wv row-parallel and reduced, and the
    receptance gate's columns (cm_wr, column-parallel) gathered from the
    ranks (an activation of [B, T, D], where gathering cm_wr whole would
    move [D, D] a layer)."""
    xs = _token_shift(x, last_x)
    dx = xs - x
    xk = x + dx * params["cmix_k"]
    xr = x + dx * params["cmix_r"]
    tp = tp_local(params["cm_wr"].shape[1], x.shape[-1])
    if tp is not None:
        xk, xr = tp.copy(xk), tp.copy(xr)
    k = torch.square(torch.relu((xk @ params["cm_wk"]).float())).to(x.dtype)
    r = torch.sigmoid((xr @ params["cm_wr"]).float()).to(x.dtype)
    kv = k @ params["cm_wv"]
    if tp is not None:
        kv, r = tp.reduce(kv), tp.gather(r, -1)
    return r * kv, x[:, -1:]


def init_rwkv6_state(batch: int, spec: Rwkv6Spec, dtype=torch.bfloat16,
                     device="cuda"):
    """Per-layer decode state: (wkv [B,H,Dh,Dh] f32, tm_last [B,1,D],
    cm_last [B,1,D])."""
    device = common.resolve_device(device)
    H, Dh, D = spec.n_heads, spec.head_dim, spec.d_model
    return (torch.zeros((batch, H, Dh, Dh), dtype=torch.float32,
                        device=device),
            torch.zeros((batch, 1, D), dtype=dtype, device=device),
            torch.zeros((batch, 1, D), dtype=dtype, device=device))
