"""Plain PyTorch versions of the kernels on the serve path.

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
# SOR EWLS fit oracle (safe-operating-region fit hot path)
# ---------------------------------------------------------------------------

def sor_accumulate_reference(x, y, w):
    """x/y/w [window, n] -> the five EWLS sums (Σw, Σwx, Σwy, Σwx², Σwxy),
    each [n] f32."""
    xf, yf, wf = (a.float() for a in (x, y, w))
    return (wf.sum(0), (wf * xf).sum(0), (wf * yf).sum(0),
            (wf * xf * xf).sum(0), (wf * xf * yf).sum(0))


def sor_solve_reference(sums, log10_bound, guard, *, min_slope: float,
                        min_spread_v: float, conf_samples: float):
    """The EWLS solve on the five accumulated sums, elementwise f32 in the
    reference's op order. Returns (intercept, slope, v_frontier, confidence,
    n_eff, floor), each [n] f32."""
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
    floor = v_frontier + torch.as_tensor(guard, dtype=torch.float32,
                                         device=sw.device)
    return (torch.where(usable, intercept, 0.0).float(),
            torch.where(usable, slope, 0.0).float(),
            v_frontier.float(), confidence.float(), sw.float(),
            floor.float())


def sor_fit_reference(x, y, w, log10_bound, guard, *, min_slope: float,
                      min_spread_v: float, conf_samples: float):
    """Fused EWLS fit: accumulate + solve + envelope floor in one call — the
    plain version of `fleet_telemetry.sor_fit`."""
    return sor_solve_reference(
        sor_accumulate_reference(x, y, w), log10_bound, guard,
        min_slope=min_slope, min_spread_v=min_spread_v,
        conf_samples=conf_samples)
