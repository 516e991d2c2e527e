"""Learned per-chip, per-rail safe operating regions (port of
`repro/core/sor.py`):

    FrameHistory  ->  SorEstimate  ->  SafeEnvelope  ->  arbitration
    (telemetry)       (fitted frontiers)  (per-rail v_min)   (control_plane)

`fit_history` is always the fused path: the five EWLS sums, the per-lane
solve and the envelope floor come out of one `ops.sor_fit` pass (the CUDA
kernel on the card, its plain version on the CPU). `observe` keeps the
observation count `tick` as a host integer and decides the `refresh_every`
cadence on the host, so a control round never reads a device value back
to choose its branch.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.core import telemetry as _telemetry
from repro_torch.core.power_plane import as_f32
from repro_torch.core.telemetry import (DEFAULT_RAIL_OBSERVABLES,
                                        FrameHistory, RailObservable,
                                        TelemetryFrame)
from repro_torch.kernels import ops

LOG10_ERR_FLOOR = -8.0   # zero-error samples clamp here (detection floor)
LOG10_ERR_CEIL = 2.0


@dataclasses.dataclass(frozen=True)
class SorConfig:
    """Knobs of the safe-operating-region learner (see the reference for
    each field's meaning)."""
    capacity: int = 32
    refresh_every: int = 4
    error_bound: float = 5e-3
    guard_v: float = 0.010
    decay: float = 0.92
    update_gain: float = 1.0
    min_slope: float = 0.5
    min_spread_v: float = 2e-3
    conf_samples: float = 8.0
    age_halflife_s: "float | None" = None
    max_extension_v: float = 0.05
    ingest: str = "polled"
    rails: tuple = DEFAULT_RAIL_OBSERVABLES

    def __post_init__(self):
        if self.ingest not in ("polled", "frames"):
            raise ValueError(f"ingest must be 'polled' or 'frames', "
                             f"got {self.ingest!r}")
        if not 0.0 < self.decay <= 1.0:
            raise ValueError(f"decay must be in (0, 1], got {self.decay}")
        if self.refresh_every < 1:
            raise ValueError("refresh_every must be >= 1")
        object.__setattr__(self, "rails",
                           _telemetry.validate_rails(self.rails))

    @property
    def n_rails(self) -> int:
        return len(self.rails)


_FIELDS = ("intercept", "slope", "v_frontier", "confidence", "n_eff")


@dataclasses.dataclass(frozen=True)
class SorEstimate:
    """The fitted frontiers, `[n_rails]` or `[n_rails, n_chips]`:
    log10(observable)(v) ~= intercept + slope * v per (rail, chip);
    `v_frontier` meets the rail's bound; `confidence` in [0, 1] gates every
    consumer (zero == no opinion)."""
    intercept: torch.Tensor
    slope: torch.Tensor
    v_frontier: torch.Tensor
    confidence: torch.Tensor
    n_eff: torch.Tensor

    @staticmethod
    def init(n_chips: int | None = None, n_rails: int = 1,
             device="cuda") -> "SorEstimate":
        shape = (n_rails,) if n_chips is None else (n_rails, n_chips)
        return SorEstimate(*(torch.zeros(shape, dtype=torch.float32,
                                          device=device) for _ in _FIELDS))

    @property
    def n_rails(self) -> int:
        return self.confidence.shape[0]


def _rail_bounds(cfg: SorConfig) -> np.ndarray:
    """[n_rails] f32 log10 frontier bounds, per-rail overrides applied."""
    return np.log10([s.error_bound if s.error_bound is not None
                     else cfg.error_bound for s in cfg.rails]
                    ).astype(np.float32)


def _rail_guards(cfg: SorConfig) -> np.ndarray:
    """[n_rails] f32 guard bands, per-rail overrides applied."""
    return np.asarray([s.guard_v if s.guard_v is not None else cfg.guard_v
                       for s in cfg.rails], np.float32)


def _fit_inputs(history: FrameHistory, cfg: SorConfig):
    """The (x, y, w) EWLS inputs of the window: masked voltages, clipped
    log10 observables, recency (x optional staleness) weights."""
    w = history.recency_weights(cfg.decay)
    if cfg.age_halflife_s is not None:
        w = w * 0.5 ** (history.age_s[:, None] / cfg.age_halflife_s)
    x = torch.where(history.valid, history.v, 0.0)
    y = torch.clamp(
        torch.log10(torch.clamp(history.obs, min=10.0 ** LOG10_ERR_FLOOR)),
        LOG10_ERR_FLOOR, LOG10_ERR_CEIL)
    y = torch.where(history.valid, y, 0.0)
    return x, y, w


def fit_history(history: FrameHistory, cfg: SorConfig) -> SorEstimate:
    """Exponentially-weighted least squares of log10(observable) against
    the rail voltage over the window, per (rail, chip), in one fused
    `ops.sor_fit` pass. Confidence gates on effective samples, voltage
    spread and a steep-enough frontier of the right sign."""
    x, y, w = _fit_inputs(history, cfg)
    shape = x.shape[1:]                      # [n_rails, *chip]
    dev = x.device
    lanes = (cfg.n_rails,) + (1,) * len(history.chip_shape)

    def flat(a):
        return a.reshape(history.capacity, -1).contiguous()

    def full(a):
        return torch.from_numpy(a).to(dev).reshape(lanes).expand(
            shape).reshape(-1).contiguous()

    intercept, slope, v_frontier, confidence, n_eff, _floor = (
        s.reshape(shape) for s in ops.sor_fit(
            flat(x), flat(y), flat(w), full(_rail_bounds(cfg)),
            full(_rail_guards(cfg)), min_slope=cfg.min_slope,
            min_spread_v=cfg.min_spread_v, conf_samples=cfg.conf_samples))
    # the fused pass also emits the envelope floor (v_frontier + guard);
    # `rail_envelopes` re-derives the identical f32 add
    return SorEstimate(intercept=intercept, slope=slope,
                       v_frontier=v_frontier, confidence=confidence,
                       n_eff=n_eff)


def update_estimate(old: SorEstimate, history: FrameHistory,
                    cfg: SorConfig) -> SorEstimate:
    """Refit the window, then blend into the running estimate with
    `update_gain`. A lane without a usable fit keeps its previous value."""
    fit = fit_history(history, cfg)
    gain = torch.where(old.confidence > 0.0, float(np.float32(
        cfg.update_gain)), 1.0)
    new_ok, old_ok = fit.confidence > 0.0, old.confidence > 0.0

    def blend(o, f):
        return torch.where(new_ok, o + gain * (f - o),
                           torch.where(old_ok, o, f))

    return SorEstimate(*(blend(getattr(old, n), getattr(fit, n))
                         for n in _FIELDS))


# ---------------------------------------------------------------------------
# SafeEnvelope: the fit as per-chip operating limits per rail
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SafeEnvelope:
    """Per-chip learned operating limits for one rail, confidence-blended
    against the consumer's static limit: at zero confidence the blend is
    the static limit exactly; the learned floor reaches below the static
    one by at most `max_extension_v`."""
    v_min: Any
    v_max: Any = None
    confidence: Any = 0.0
    max_extension_v: float = 0.05
    rail: str = "VDD_IO"

    def _device(self):
        return self.v_min.device if isinstance(self.v_min, torch.Tensor) \
            else "cpu"

    def floor(self, static_v_min) -> torch.Tensor:
        dev = self._device()
        s = as_f32(static_v_min, dev)
        blended = s + as_f32(self.confidence, dev) \
            * (as_f32(self.v_min, dev) - s)
        return torch.maximum(blended, s - self.max_extension_v)

    def ceil(self, static_v_max) -> torch.Tensor:
        dev = self._device()
        s = as_f32(static_v_max, dev)
        if self.v_max is None:
            return s
        blended = s + as_f32(self.confidence, dev) \
            * (as_f32(self.v_max, dev) - s)
        return torch.minimum(blended, s + self.max_extension_v)


def rail_envelopes(est: SorEstimate, cfg: SorConfig
                   ) -> dict[str, SafeEnvelope]:
    """The estimate as {rail name: SafeEnvelope}: each rail's floor is its
    fitted frontier plus that rail's guard band."""
    out = {}
    for i, spec in enumerate(cfg.rails):
        guard = spec.guard_v if spec.guard_v is not None else cfg.guard_v
        out[spec.rail] = SafeEnvelope(
            v_min=est.v_frontier[i] + float(np.float32(guard)),
            v_max=None, confidence=est.confidence[i],
            max_extension_v=cfg.max_extension_v, rail=spec.rail)
    return out


def envelope_for(envelope, rail: str = "VDD_IO"):
    """A {rail: SafeEnvelope} dict yields that rail's envelope (None if
    unfitted); a bare SafeEnvelope applies only to the rail it names; None
    passes through."""
    if envelope is None:
        return None
    if isinstance(envelope, dict):
        return envelope.get(rail)
    return envelope if getattr(envelope, "rail", "VDD_IO") == rail else None


def as_envelopes(envelope) -> "dict[str, SafeEnvelope] | None":
    """Normalize to the {rail: SafeEnvelope} dict arbitration consumes."""
    if envelope is None or isinstance(envelope, dict):
        return envelope
    return {getattr(envelope, "rail", "VDD_IO"): envelope}


# ---------------------------------------------------------------------------
# SorState: the bundle a controller carries
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SorState:
    """(history, estimate, tick): what a controller threads through its
    loop; `tick` (observations seen) is a host integer."""
    history: FrameHistory
    estimate: SorEstimate
    tick: int


def init_state(cfg: SorConfig, n_chips: int | None = None,
               device="cuda") -> SorState:
    return SorState(
        history=FrameHistory.create(cfg.capacity, n_chips, rails=cfg.rails,
                                    device=device),
        estimate=SorEstimate.init(n_chips, n_rails=cfg.n_rails,
                                  device=device),
        tick=0)


def observe(state: SorState, frame: TelemetryFrame,
            cfg: SorConfig) -> SorState:
    """Push one observation and refit on every `refresh_every`-th one; the
    other rounds keep the prior estimate and launch no fit."""
    hist = state.history.push(frame)
    tick = state.tick + 1
    est = (update_estimate(state.estimate, hist, cfg)
           if tick % cfg.refresh_every == 0 else state.estimate)
    return SorState(history=hist, estimate=est, tick=tick)


def summary(est: SorEstimate, cfg: SorConfig) -> dict[str, float]:
    """Host-side telemetry view of an estimate (serve summaries).
    Single-rail configs keep flat keys; multi-rail configs add per-rail
    `<RAIL>/...` keys."""
    if est.n_rails != cfg.n_rails:
        raise ValueError(
            f"estimate carries {est.n_rails} rail(s) but the SorConfig "
            f"declares {cfg.n_rails} ({[s.rail for s in cfg.rails]}); "
            f"summarize with the config the state was learned under")
    conf, front, n_eff = (
        getattr(est, f).detach().cpu().numpy().astype(np.float64).reshape(
            cfg.n_rails, -1) for f in ("confidence", "v_frontier", "n_eff"))

    def rail_stats(i: int, spec: RailObservable) -> dict[str, float]:
        c, f, n = conf[i], front[i], n_eff[i]
        learned = c > 0.0
        guard = spec.guard_v if spec.guard_v is not None else cfg.guard_v
        floor = f + guard
        out = {
            "n_chips": int(c.size),
            "chips_learned": int(learned.sum()),
            "confidence_mean": float(c.mean()),
            "confidence_min": float(c.min()),
            "n_eff_mean": float(n.mean()),
        }
        if learned.any():
            out["floor_min_v"] = float(floor[learned].min())
            out["floor_max_v"] = float(floor[learned].max())
            out["floor_mean_v"] = float(floor[learned].mean())
        return out

    if cfg.n_rails == 1:
        return rail_stats(0, cfg.rails[0])
    out: dict[str, float] = {
        "n_chips": int(conf.shape[1]),
        "n_rails": cfg.n_rails,
        "chips_learned": int((conf > 0.0).any(axis=0).sum()),
        "confidence_mean": float(conf.mean()),
    }
    for i, spec in enumerate(cfg.rails):
        for k, v in rail_stats(i, spec).items():
            if k != "n_chips":
                out[f"{spec.rail}/{k}"] = v
    return out
