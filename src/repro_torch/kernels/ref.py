"""Plain PyTorch versions of the kernels on the serve and training paths.

Torch copies of the oracles in `repro/kernels/ref.py`: the CPU path of every
kernel wrapper runs them, and the card checks hold each CUDA kernel against
them on the same inputs. The SOR stages keep the reference's f32 op order
term for term."""

from __future__ import annotations

import math

import numpy as np
import torch


# ---------------------------------------------------------------------------
# Attention (flash_attention / decode_attention oracle)
# ---------------------------------------------------------------------------

def mha_reference(q, k, v, *, causal: bool = True, group: int = 1,
                  sliding_window: int = 0, lengths=None):
    """q [B,T,Hq,Dh], k/v [B,S,Hkv,Dh] with Hq = group * Hkv.

    causal assumes aligned positions (self-attention). `lengths` [B] masks
    key slots >= length (decode against a partially-filled cache).
    Accumulates in f32, returns q.dtype."""
    scores = masked_scores(q, k, causal=causal, group=group,
                           sliding_window=sliding_window, lengths=lengths)
    return attend(scores, v, group=group, dtype=q.dtype)


def masked_scores(q, k, *, causal: bool, group: int, sliding_window: int = 0,
                  lengths=None):
    """The scaled f32 scores [B,Hq,T,S] of `mha_reference`, masked key slots
    set to -1e30."""
    B, T, Hq, Dh = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    if Hq != group * Hkv:
        raise ValueError(f"Hq={Hq} != group={group} x Hkv={Hkv}")
    qf = q.float() / math.sqrt(Dh)
    kf = k.float().repeat_interleave(group, dim=2)
    scores = torch.einsum("bthk,bshk->bhts", qf, kf)
    neg = -1e30
    if causal:
        i = torch.arange(T, device=q.device)[:, None]
        j = torch.arange(S, device=q.device)[None, :]
        mask = j <= i
        if sliding_window:
            mask = mask & (j > i - sliding_window)
        scores = torch.where(mask[None, None], scores, neg)
    if lengths is not None:
        valid = (torch.arange(S, device=q.device)[None, :]
                 < lengths.to(q.device)[:, None])
        scores = torch.where(valid[:, None, None, :], scores, neg)
    return scores


def attend(scores, v, *, group: int, dtype):
    """softmax(scores) @ v in f32 (v's kv heads repeated over the group),
    cast to `dtype`: [B,T,Hq,Dh]."""
    vf = v.float().repeat_interleave(group, dim=2)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhts,bshk->bthk", probs, vf).to(dtype)


# ---------------------------------------------------------------------------
# Blockwise int8 quantization oracle (ecollectives codec)
# ---------------------------------------------------------------------------

def quantize_int8_reference(x, block: int = 256):
    """x any shape -> (q [nblocks, block] int8, scale [nblocks, 1] f32): the
    tail zero-padded in x's dtype, then per block absmax (NaN propagates),
    scale = absmax / 127 or 1 where absmax is not > 0, q = clip(round half
    to even(x / scale), -127, 127). A NaN element's code is 0, as XLA
    converts NaN to an integer. Both divisions are tensor by tensor: on a
    CUDA tensor torch computes `a / python_scalar` as a * (1 / scalar),
    which misses the IEEE quotient by an ulp on some scales."""
    flat = x.reshape(-1)
    pad = (-flat.numel()) % block
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    blocks = flat.reshape(-1, block).to(torch.float32)
    absmax = blocks.abs().amax(dim=1, keepdim=True)
    scale = torch.where(absmax > 0,
                        absmax / torch.full_like(absmax, 127.0), 1.0)
    r = (blocks / scale).round_().clamp_(-127, 127).nan_to_num_(0.0)
    return r.to(torch.int8), scale


# ---------------------------------------------------------------------------
# Fleet telemetry reduction oracle (fleet control plane)
# ---------------------------------------------------------------------------

def fleet_reduce_reference(x):
    """x [n_chips, n_fields] -> (max, min, sum), each [n_fields] f32; NaN
    propagates through max and min."""
    xf = x.float()
    return xf.amax(0), xf.amin(0), xf.sum(0)


def fleet_percentile_reference(x, q: float):
    """x [n_chips] -> the q-th percentile, [] f32, interpolated linearly
    between the two nearest ranks (`jnp.percentile`'s default)."""
    return torch.quantile(x.float(), q / 100.0)


# ---------------------------------------------------------------------------
# SOR EWLS fit oracle (safe-operating-region fit hot path)
# ---------------------------------------------------------------------------

LOG10_ERR_FLOOR = -8.0   # zero-error samples clamp here (detection floor)
LOG10_ERR_CEIL = 2.0


def recency_weights(valid, cursor: int, decay: float):
    """`[capacity, ...]` exponential recency weights of a history ring whose
    next write slot is `cursor`: the newest valid sample weighs 1, each
    older slot `decay`x less, invalid lanes 0."""
    cap = valid.shape[0]
    slots = torch.arange(cap, device=valid.device)
    rank = (cursor - 1 - slots) % cap        # 0 == newest
    w = torch.full((cap,), decay, dtype=torch.float32,
                   device=valid.device) ** rank
    w = w.reshape((cap,) + (1,) * (valid.dim() - 1))
    return w * valid.float()


def sor_fit_inputs(v, obs, valid, age_s, *, cursor: int, decay: float,
                   age_halflife_s):
    """The (x, y, w) EWLS inputs of a history ring, each `[capacity,
    n_rails, *chip]` f32: masked voltages, clipped log10 observables,
    recency (x optional staleness) weights. v, obs, valid `[capacity,
    n_rails, *chip]`, age_s `[capacity, *chip]`."""
    w = recency_weights(valid, cursor, decay)
    if age_halflife_s is not None:
        w = w * 0.5 ** (age_s[:, None] / age_halflife_s)
    x = torch.where(valid, v, 0.0)
    y = torch.clamp(
        torch.log10(torch.clamp(obs, min=10.0 ** LOG10_ERR_FLOOR)),
        LOG10_ERR_FLOOR, LOG10_ERR_CEIL)
    y = torch.where(valid, y, 0.0)
    return x, y, w


def sor_accumulate_reference(x, y, w):
    """x/y/w [window, ...] -> the five EWLS sums (Σw, Σwx, Σwy, Σwx², Σwxy),
    each [...] f32. `Tensor.sum` takes the rows in order up to 16 of them
    on the CPU and blocks them past that (and on the card); K1 and K7 sum
    in row order, so their sums part from these in the last bits."""
    xf, yf, wf = (a.float() for a in (x, y, w))
    return (wf.sum(0), (wf * xf).sum(0), (wf * yf).sum(0),
            (wf * xf * xf).sum(0), (wf * xf * yf).sum(0))


def sor_estimate_reference(sums, log10_bound, *, min_slope: float,
                           min_spread_v: float, conf_samples: float):
    """The EWLS solve on the five accumulated sums, elementwise f32 in the
    reference's op order. Returns (intercept, slope, v_frontier, confidence,
    n_eff), each [n] f32: the split fit's second stage."""
    sw, sx, sy, sxx, sxy = sums
    eps = 1e-9
    denom = sw * sxx - sx * sx
    slope = (sw * sxy - sx * sy) / torch.clamp(denom, min=eps)
    intercept = (sy - slope * sx) / torch.clamp(sw, min=eps)
    var_x = torch.clamp(sxx / torch.clamp(sw, min=eps)
                        - (sx / torch.clamp(sw, min=eps)) ** 2, min=0.0)

    steep = slope < -min_slope
    spread = var_x > float(np.float32(min_spread_v) ** 2)
    usable = steep & spread & (denom > eps)

    bound = torch.as_tensor(log10_bound, dtype=torch.float32,
                            device=sw.device)
    v_frontier = torch.where(
        usable, (bound - intercept) / torch.where(usable, slope, -1.0), 0.0)
    v_frontier = torch.clamp(v_frontier, 0.0, 2.0)
    confidence = torch.where(
        usable, 1.0 - torch.exp(-sw / conf_samples), 0.0)
    return (torch.where(usable, intercept, 0.0).float(),
            torch.where(usable, slope, 0.0).float(),
            v_frontier.float(), confidence.float(), sw.float())


def sor_solve_reference(sums, log10_bound, guard, *, min_slope: float,
                        min_spread_v: float, conf_samples: float):
    """`sor_estimate_reference` plus the envelope floor `v_frontier +
    guard`. Returns (intercept, slope, v_frontier, confidence, n_eff,
    floor), each [n] f32."""
    est = sor_estimate_reference(sums, log10_bound, min_slope=min_slope,
                                 min_spread_v=min_spread_v,
                                 conf_samples=conf_samples)
    floor = est[2] + torch.as_tensor(guard, dtype=torch.float32,
                                     device=est[2].device)
    return (*est, floor.float())


def sor_fit_reference(x, y, w, log10_bound, guard, *, min_slope: float,
                      min_spread_v: float, conf_samples: float):
    """Fused EWLS fit: accumulate + solve + envelope floor in one call — the
    plain version of `fleet_telemetry.sor_fit`."""
    return sor_solve_reference(
        sor_accumulate_reference(x, y, w), log10_bound, guard,
        min_slope=min_slope, min_spread_v=min_spread_v,
        conf_samples=conf_samples)


def sor_blend_reference(old, fit, update_gain: float):
    """The online refresh's blend of a refit into the running estimate:
    old and fit are (intercept, slope, v_frontier, confidence, n_eff). A
    lane with a usable refit moves by `update_gain` (1 where it had no
    confidence) towards it; one without keeps its old value, or takes the
    refit's zeros while it has none."""
    gain = torch.where(old[3] > 0.0, float(np.float32(update_gain)), 1.0)
    new_ok, old_ok = fit[3] > 0.0, old[3] > 0.0
    return tuple(torch.where(new_ok, o + gain * (f - o),
                             torch.where(old_ok, o, f))
                 for o, f in zip(old, fit))


def sor_refit_reference(v, obs, valid, age_s, old, log10_bound, *,
                        cursor: int, decay: float, age_halflife_s,
                        update_gain: float, min_slope: float,
                        min_spread_v: float, conf_samples: float):
    """One refit on cadence from the history ring: `sor_fit_inputs`, the
    sums and the solve, then `sor_blend_reference` with the old estimate.
    v, obs, valid `[capacity, n_rails, n_chips]`, age_s `[capacity,
    n_chips]`, old five `[n_rails, n_chips]`, log10_bound `[n_rails]` ->
    the five new fields, each `[n_rails, n_chips]` f32."""
    fit = sor_estimate_reference(
        sor_accumulate_reference(*sor_fit_inputs(
            v, obs, valid, age_s, cursor=cursor, decay=decay,
            age_halflife_s=age_halflife_s)),
        log10_bound[:, None], min_slope=min_slope,
        min_spread_v=min_spread_v, conf_samples=conf_samples)
    return sor_blend_reference(old, fit, update_gain)


# ---------------------------------------------------------------------------
# Mamba2 SSD oracle (sequential scan over time)
# ---------------------------------------------------------------------------

def mamba2_scan_reference(x, dt, A, B, C, D, *, init_state=None):
    """Sequential state-space scan (the SSD recurrence, Mamba2 eq. form).

    x  [Bt, T, H, P]   input per head (P = head channel dim)
    dt [Bt, T, H]      softplus-activated step sizes (>0)
    A  [H]             negative scalar decay per head (A < 0)
    B  [Bt, T, G, N]   input->state projection (G groups, N = state dim)
    C  [Bt, T, G, N]   state->output projection
    D  [H]             skip connection
    Heads are split evenly over groups: head h uses group h // (H // G).

    state s_{t} = exp(dt_t * A) * s_{t-1} + dt_t * B_t x_t^T   (per head: [N,P])
    y_t = C_t . s_t + D * x_t
    Returns (y [Bt,T,H,P] in x.dtype, final_state [Bt,H,N,P] f32)."""
    Bt, T, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    hpg = H // G
    xf, dtf, Af, Df = x.float(), dt.float(), A.float(), D.float()
    Bh = B.float().repeat_interleave(hpg, dim=2)     # [Bt,T,H,N]
    Ch = C.float().repeat_interleave(hpg, dim=2)
    s = (torch.zeros((Bt, H, N, P), dtype=torch.float32, device=x.device)
         if init_state is None else init_state.float())
    y = torch.empty((Bt, T, H, P), dtype=torch.float32, device=x.device)
    for t in range(T):
        xt, dtt, bt, ct = xf[:, t], dtf[:, t], Bh[:, t], Ch[:, t]
        decay = torch.exp(dtt * Af)[..., None, None]             # [Bt,H,1,1]
        upd = dtt[..., None, None] * bt[..., :, None] * xt[..., None, :]
        s = s * decay + upd
        y[:, t] = torch.einsum("bhn,bhnp->bhp", ct, s)
    y = y + Df[None, None, :, None] * xf
    return y.to(x.dtype), s


# ---------------------------------------------------------------------------
# RWKV6 oracle (data-dependent decay linear attention)
# ---------------------------------------------------------------------------

def rwkv6_scan_reference(r, k, v, w, u, *, init_state=None):
    """RWKV6 ("Finch") recurrence, sequential oracle.

    r,k,v [B,T,H,Dh]; w [B,T,H,Dh] the per-step *log-decay* (w <= 0,
    decay = exp(w)); u [H,Dh] the bonus for the current token.

    state S [B,H,Dh,Dh] (key-major), kept in f32:
      y_t = r_t . (S_{t-1} + (u * k_t) v_t^T)
      S_t = diag(exp(w_t)) S_{t-1} + k_t v_t^T
    Returns (y [B,T,H,Dh] in r.dtype, final_state f32)."""
    B, T, H, Dh = r.shape
    rf, kf, vf, wf = (a.float() for a in (r, k, v, w))
    uf = u.float()
    s = (torch.zeros((B, H, Dh, Dh), dtype=torch.float32, device=r.device)
         if init_state is None else init_state.float())
    y = torch.empty((B, T, H, Dh), dtype=torch.float32, device=r.device)
    for t in range(T):
        rt, kt, vt, wt = rf[:, t], kf[:, t], vf[:, t], wf[:, t]  # [B,H,Dh]
        att = s + (uf * kt)[..., :, None] * vt[..., None, :]     # [B,H,Dk,Dv]
        y[:, t] = torch.einsum("bhk,bhkv->bhv", rt, att)
        s = s * torch.exp(wt)[..., :, None] + kt[..., :, None] * vt[..., None, :]
    return y.to(r.dtype), s


# ---------------------------------------------------------------------------
# The scans' backward: the gradient of the plain version (the reference's
# custom_vjps take `jax.vjp` of the oracle)
# ---------------------------------------------------------------------------

def plain_vjp(plain, ctx, grads):
    """The gradient of a scan's plain version at the inputs saved in `ctx`
    (the last of them the initial state or None) against the incoming
    `grads` (y's and the final state's, either None), for the inputs that
    need one. Autograd runs a Function's backward with grad mode off, so
    the plain version runs under `enable_grad`."""
    saved = ctx.saved_tensors
    want = [i for i, a in enumerate(saved)
            if a is not None and ctx.needs_input_grad[i]]
    out = [None] * len(saved)
    pairs = [(g, i) for i, g in enumerate(grads) if g is not None]
    if not want or not pairs:
        return tuple(out)
    with torch.enable_grad():
        ins = [None if a is None else a.detach().requires_grad_(i in want)
               for i, a in enumerate(saved)]
        res = plain(*ins[:-1], init_state=ins[-1])
        got = torch.autograd.grad([res[i] for _, i in pairs],
                                  [ins[i] for i in want],
                                  [g for g, _ in pairs], allow_unused=True)
    for i, g in zip(want, got):
        out[i] = g
    return tuple(out)
