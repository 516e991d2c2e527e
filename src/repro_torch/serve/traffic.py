"""Seeded bursty serving-traffic traces (a copy of
`repro/serve/traffic.py`, which is numpy only: the port keeps its own so
that it imports nothing of the reference; the same seed and knobs give the
same trace, bit for bit, in both packages).

Routed serving is exercised against replayable open-loop arrival
processes: a two-state modulated Poisson source (quiet <-> burst) with
per-request prefill/decode token draws. Everything is derived from one
`numpy` generator seeded by the caller, so the same (seed, knobs) always
yields the same trace, and placement comparisons (headroom router against
round-robin) replay the identical workload.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Request:
    """One serving request of the open-loop trace. `t_arrival_s` is when the
    request enters the system (trace time, seconds); token counts model the
    prompt (prefill, compute-bound) and generation (decode, HBM-bound)
    phases the router weighs against per-rail headroom."""
    rid: int
    t_arrival_s: float
    prefill_tokens: int
    decode_tokens: int

    @property
    def total_tokens(self) -> int:
        return self.prefill_tokens + self.decode_tokens

    @property
    def decode_fraction(self) -> float:
        """Share of the request's work that is decode — the router's
        phase-mix weight (1.0 = pure decode, memory-bound)."""
        return self.decode_tokens / max(self.total_tokens, 1)


@dataclasses.dataclass(frozen=True)
class TrafficTrace:
    """An arrival-ordered tuple of `Request`s plus the knobs that produced
    it (for records/provenance). Deterministic by construction: rebuilding
    with the same metadata yields the identical trace."""
    requests: tuple
    seed: int
    metadata: dict

    def __len__(self) -> int:
        return len(self.requests)

    def __iter__(self):
        return iter(self.requests)

    @property
    def duration_s(self) -> float:
        return self.requests[-1].t_arrival_s if self.requests else 0.0

    @property
    def total_decode_tokens(self) -> int:
        return sum(r.decode_tokens for r in self.requests)


def steady_trace(
    n_requests: int,
    *,
    rate_hz: float = 10.0,
    t_start_s: float = 0.0,
    prefill_tokens: int = 8,
    decode_tokens: int = 48,
) -> TrafficTrace:
    """Deterministic evenly-spaced arrivals with FIXED token counts — no
    randomness at all. The forced-pin migration scenario and the
    fast-forward tests want full control of exactly when work lands and
    how big it is; a seeded bursty trace can only approximate that."""
    if n_requests < 1:
        raise ValueError(f"n_requests must be >= 1, got {n_requests}")
    if rate_hz <= 0:
        raise ValueError("rate_hz must be positive")
    requests = tuple(
        Request(rid=rid, t_arrival_s=float(t_start_s + rid / rate_hz),
                prefill_tokens=int(prefill_tokens),
                decode_tokens=int(decode_tokens))
        for rid in range(n_requests))
    metadata = {
        "kind": "steady", "n_requests": n_requests, "rate_hz": rate_hz,
        "t_start_s": t_start_s, "prefill_tokens": prefill_tokens,
        "decode_tokens": decode_tokens,
    }
    return TrafficTrace(requests=requests, seed=0, metadata=metadata)


def bursty_trace(
    n_requests: int,
    seed: int = 0,
    *,
    quiet_rate_hz: float = 4.0,
    burst_rate_hz: float = 40.0,
    mean_quiet_s: float = 2.0,
    mean_burst_s: float = 1.0,
    prefill_mean: float = 48.0,
    decode_mean: float = 40.0,
    token_sigma: float = 0.5,
) -> TrafficTrace:
    """Two-state modulated Poisson arrivals: exponential dwell times in a
    `quiet` state (rate `quiet_rate_hz`) and a `burst` state (rate
    `burst_rate_hz`), exponential inter-arrivals at the current state's
    rate. Token counts are lognormal around the given means (sigma in log
    space `token_sigma`), floored at 1. All randomness flows from ONE
    seeded `np.random.default_rng`, so the trace is a pure function of its
    arguments."""
    if n_requests < 1:
        raise ValueError(f"n_requests must be >= 1, got {n_requests}")
    if quiet_rate_hz <= 0 or burst_rate_hz <= 0:
        raise ValueError("arrival rates must be positive")
    rng = np.random.default_rng(seed)

    requests = []
    t = 0.0
    bursting = False
    state_end = rng.exponential(mean_quiet_s)
    for rid in range(n_requests):
        rate = burst_rate_hz if bursting else quiet_rate_hz
        t += rng.exponential(1.0 / rate)
        while t > state_end:
            bursting = not bursting
            state_end += rng.exponential(
                mean_burst_s if bursting else mean_quiet_s)
        # lognormal with the requested arithmetic mean: mu = ln(m) - s^2/2
        def draw(mean: float) -> int:
            mu = np.log(mean) - 0.5 * token_sigma**2
            return max(1, int(round(rng.lognormal(mu, token_sigma))))
        requests.append(Request(rid=rid, t_arrival_s=float(t),
                                prefill_tokens=draw(prefill_mean),
                                decode_tokens=draw(decode_mean)))
    metadata = {
        "kind": "bursty", "n_requests": n_requests, "seed": seed,
        "quiet_rate_hz": quiet_rate_hz, "burst_rate_hz": burst_rate_hz,
        "mean_quiet_s": mean_quiet_s, "mean_burst_s": mean_burst_s,
        "prefill_mean": prefill_mean, "decode_mean": decode_mean,
        "token_sigma": token_sigma,
    }
    return TrafficTrace(requests=tuple(requests), seed=seed,
                        metadata=metadata)
