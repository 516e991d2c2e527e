"""Public entry to the port's kernels, mirroring `repro/kernels/ops.py`.

Dispatch is by the device of the tensors: a CPU tensor runs the plain
PyTorch version, a CUDA tensor launches the hand-written CUDA kernel (built
at first use) or raises. There is no switch and no fallback.

Launch counts: each kernel wrapper carries a `launches` integer that it
increments where it launches its kernel and nowhere else;
`launch_counts()` reads them and `reset_launch_counts()` zeroes them."""

from __future__ import annotations

from repro_torch.kernels import decode_attention as _da
from repro_torch.kernels import fleet_telemetry as _ft
from repro_torch.kernels import flash_attention as _fa

# name -> the wrapper carrying the launch count
KERNELS = {
    "sor_fit": _ft.sor_fit,
    "flash_attention_fwd": _fa.flash_attention,
    "decode_attention": _da.decode_attention,
}


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def flash_attention(q, k, v, *, causal: bool = True, group: int = 1,
                    sliding_window: int = 0):
    """q [B,T,Hq,Dh], k/v [B,S,Hkv,Dh] -> [B,T,Hq,Dh]."""
    out, _lse = _fa.flash_attention(q, k, v, causal=causal, group=group,
                                    sliding_window=sliding_window)
    return out


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
