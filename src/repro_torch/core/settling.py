"""Settling-time detection (paper §V-D, Fig 9; port of
`repro/core/settling.py`).

Given a sampled voltage trace v[0..T] during a transition:
  (a) stable-voltage estimate v_avg = mean of the last N samples,
  (b) stability band v_avg +/- x%,
  (c) first index t_s such that N consecutive samples starting at t_s are
      inside the band,
  (d) settling time = t[t_s] - t[0].

`settling_time` is the host version (the trace in float32, as the
reference's `jnp.asarray(volts)` holds it; times in float64).
`settling_time_torch` is the tensor version of the reference's
`settling_time_jax`, computed on the tensors' device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class SettlingResult:
    settled: bool
    settling_time_s: float
    t_s_index: int
    v_avg: float
    band_v: float


def _stable_window_start_np(stable: np.ndarray, n: int) -> int:
    """First index i such that stable[i:i+n] are all True, else -1."""
    c = np.concatenate([np.zeros(1, np.int64),
                        np.cumsum(stable.astype(np.int64))])
    hit = (c[n:] - c[:-n]) == n
    return int(np.argmax(hit)) if hit.any() else -1


def settling_time(times, volts, *, n: int = 8,
                  band_pct: float = 1.0) -> SettlingResult:
    """Detect the settling time of a sampled transition (paper Fig 9).

    `n` is the window length N (both for the stable-voltage average and the
    consecutive-stability requirement); `band_pct` is x in the +/- x% band.
    """
    t = np.asarray(times, np.float64)
    v = np.asarray(volts, np.float32)
    if v.shape[0] < n + 1:
        raise ValueError(f"need more than n={n} samples, got {v.shape[0]}")
    v_avg = np.mean(v[-n:], dtype=np.float32)
    band = np.abs(v_avg) * np.float32(band_pct / 100.0)
    stable = np.abs(v - v_avg) <= band
    ts_idx = _stable_window_start_np(stable, n)
    settled = ts_idx >= 0
    st = float(t[ts_idx] - t[0]) if settled else float("nan")
    return SettlingResult(settled, st, ts_idx, float(v_avg), float(band))


def settling_time_torch(times: torch.Tensor, volts: torch.Tensor, *,
                        n: int = 8, band_pct: float = 1.0) -> torch.Tensor:
    """Tensor variant on the tensors' device: the settling time in seconds,
    or NaN when the trace never stabilizes. No host read."""
    v_avg = volts[-n:].mean()
    band = v_avg.abs() * (band_pct / 100.0)
    stable = ((volts - v_avg).abs() <= band).to(torch.int64)
    c = torch.cat([stable.new_zeros(1), torch.cumsum(stable, 0)])
    hit = (c[n:] - c[:-n]) == n
    idx = torch.argmax(hit.to(torch.int64))
    return torch.where(hit.any(), times[idx] - times[0],
                       torch.full_like(times[0], float("nan")))
