"""Public entry to the port's kernels, mirroring `repro/kernels/ops.py`.

Dispatch is by the device of the tensors: a CPU tensor runs the plain
PyTorch version, a CUDA tensor launches the hand-written CUDA kernel (built
at first use) or raises. There is no switch and no fallback.

Launch counts: each kernel wrapper carries a `launches` integer that it
increments where it launches its kernel and nowhere else;
`launch_counts()` reads them and `reset_launch_counts()` zeroes them."""

from __future__ import annotations

import torch

from repro_torch.kernels import decode_attention as _da
from repro_torch.kernels import fleet_telemetry as _ft
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import mamba2_ssd as _m2
from repro_torch.kernels import quant_codec as _qc
from repro_torch.kernels import ref
from repro_torch.kernels import rwkv6_scan as _r6

# name -> the wrapper carrying the launch count
KERNELS = {
    "sor_fit": _ft.sor_fit,
    "sor_accumulate": _ft.sor_accumulate,
    "sor_refit": _ft.sor_refit,
    "flash_attention_fwd": _fa.flash_attention,
    "decode_attention": _da.decode_attention,
    "flash_attention_bwd_dq": _fa.flash_attention_bwd_dq,
    "flash_attention_bwd_dkv": _fa.flash_attention_bwd_dkv,
    "fleet_reduce": _ft.fleet_reduce,
    "fleet_stats": _ft.fleet_stats,
    "rwkv6_scan": _r6.rwkv6_scan,
    "mamba2_ssd": _m2.mamba2_ssd,
    "quantize_int8": _qc.quantize_int8,
    "ef_sync_leaf": _qc.ef_sync_leaf,
}


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def flash_attention(q, k, v, *, causal: bool = True, group: int = 1,
                    sliding_window: int = 0):
    """q [B,T,Hq,Dh], k/v [B,S,Hkv,Dh] -> [B,T,Hq,Dh], differentiable: the
    forward is K2, the backward K4 + K5 (`flash_attention.FlashAttention`)."""
    return _fa.FlashAttention.apply(q, k, v, causal, group, sliding_window)


def decode_attention(q, k, v, lengths, *, group: int = 1):
    """q [B,1,Hq,Dh] against cache k/v [B,S,Hkv,Dh]; lengths [B] valid
    slots."""
    return _da.decode_attention(q, k, v, lengths, group=group)


def sor_fit(x, y, w, log10_bound, guard, *, min_slope: float,
            min_spread_v: float, conf_samples: float):
    """Fused safe-operating-region fit over the `[window, n]` window.
    Returns (intercept, slope, v_frontier, confidence, n_eff, floor), each
    [n] f32."""
    return _ft.sor_fit(x, y, w, log10_bound, guard, min_slope=min_slope,
                       min_spread_v=min_spread_v, conf_samples=conf_samples)


def sor_accumulate(x, y, w):
    """The five EWLS sums (Σw, Σwx, Σwy, Σwx², Σwxy) over the `[window, n]`
    window, each [n] f32 (K7): the split fit's first stage."""
    return _ft.sor_accumulate(x, y, w)


def sor_accumulate_ring(v, obs, valid, age_s, *, cursor: int, decay: float,
                        age_halflife_s):
    """K7 on the SOR history ring as it stands (v, obs, valid [capacity,
    n_rails, n_chips], age_s [capacity, n_chips], `cursor` the next write
    slot): the five EWLS sums of its window, each [n_rails, n_chips] f32."""
    return _ft.sor_accumulate_ring(v, obs, valid, age_s, cursor=cursor,
                                   decay=decay,
                                   age_halflife_s=age_halflife_s)


def sor_refit(v, obs, valid, age_s, old, log10_bound, *, cursor: int,
              decay: float, age_halflife_s, update_gain: float,
              min_slope: float, min_spread_v: float, conf_samples: float):
    """One refit on cadence in one pass (K1's refit): the ring's window
    inputs, the sums, the solve and the blend into the old estimate (five
    [n_rails, n_chips] fields) -> the five new fields."""
    return _ft.sor_refit(v, obs, valid, age_s, old, log10_bound,
                         cursor=cursor, decay=decay,
                         age_halflife_s=age_halflife_s,
                         update_gain=update_gain, min_slope=min_slope,
                         min_spread_v=min_spread_v,
                         conf_samples=conf_samples)


def fleet_reduce(x):
    """x [n_chips, n_fields] -> (max, min, sum) over chips, each
    [n_fields] f32 (K6)."""
    return _ft.fleet_reduce(x)


def fleet_stats(power_w, t_chip_s, grad_error, energy_step_j, v_io,
                straggle, conf=None):
    """The fleet train step's reduction tail in one launch (K6's fold):
    five [n] f32 fields, the [n] bool straggle mask and, optionally, the
    SOR confidence -> {`fleet/*` key: 0-d f32}: worst (v_io: min) and mean
    of each field, t_fleet_s, the p95s of t_chip_s and grad_error, the
    straggler fraction, and the confidence's mean and min."""
    return _ft.fleet_stats(power_w, t_chip_s, grad_error, energy_step_j,
                           v_io, straggle, conf)


def _differentiated(*tensors) -> bool:
    """Whether a scan call must be differentiable: grad mode is on and an
    input requires a gradient (the serve paths run under `no_grad`)."""
    return torch.is_grad_enabled() and any(
        a is not None and a.requires_grad for a in tensors)


def rwkv6_scan(r, k, v, w, u, *, init_state=None, state_out=None):
    """RWKV6 recurrence (K9): r, k, v [B,T,H,Dh], w [B,T,H,Dh] f32
    log-decay, u [H,Dh] f32, init_state [B,H,Dh,Dh] f32 or None -> (y
    [B,T,H,Dh], final state [B,H,Dh,Dh] f32). With `state_out` the final
    state is written there (it may be `init_state`: in place) and it is
    the state returned. Under grad, with an input that requires one, the
    call is differentiable (`rwkv6_scan.Rwkv6Scan`: K9 forward, the plain
    version's gradient) and refuses `state_out`."""
    if _differentiated(r, k, v, w, u, init_state):
        return _r6.Rwkv6Scan.apply(r, k, v, w, u, init_state, state_out)
    return _r6.rwkv6_scan(r, k, v, w, u, init_state=init_state,
                          state_out=state_out)


def mamba2_scan(x, dt, A, B, C, D, *, init_state=None, state_out=None):
    """Mamba2 SSD scan (K8): x [Bt,T,H,P], dt [Bt,T,H] f32, A, D [H] f32,
    B, C [Bt,T,G,N], init_state [Bt,H,N,P] f32 or None -> (y [Bt,T,H,P],
    final state [Bt,H,N,P] f32). With `state_out` the final state is
    written there (it may be `init_state`: in place) and it is the state
    returned. Under grad, with an input that requires one, the call is
    differentiable (`mamba2_ssd.Mamba2Scan`: K8 forward, the plain
    version's gradient) and refuses `state_out`."""
    if _differentiated(x, dt, A, B, C, D, init_state):
        return _m2.Mamba2Scan.apply(x, dt, A, B, C, D, init_state, state_out)
    return _m2.mamba2_ssd(x, dt, A, B, C, D, init_state=init_state,
                          state_out=state_out)


def quantize_int8(x, *, block: int = 256):
    """Blockwise symmetric int8 codec (K10): x any shape, f32 or bf16 ->
    (q [nblocks, block] int8, scale [nblocks, 1] f32), the tail block
    zero-padded."""
    return _qc.quantize_int8(x, block=block)


def ef_sync_leaf(g, r, thresholds=None):
    """One leaf of the error-feedback int8 sync in one pass (K10 fused):
    r (f32) becomes the new residual in place; returns (out f32, q int8,
    scale f32, num f32, den in g's dtype). `thresholds` [nblocks, 1] f32
    selects level 2 (top-k), None level 1."""
    return _qc.ef_sync_leaf(g, r, thresholds)


def fleet_percentile(x, q: float):
    """`[n_chips]` stat vector -> the q-th percentile, [] f32. Sort-bound,
    so the plain version runs on every device, as in the reference."""
    return ref.fleet_percentile_reference(x, q)
