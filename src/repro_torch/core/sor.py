"""Learned per-chip, per-rail safe operating regions (port of
`repro/core/sor.py`):

    FrameHistory  ->  SorEstimate  ->  SafeEnvelope  ->  arbitration
    (telemetry)       (fitted frontiers)  (per-rail v_min)   (control_plane)

A refit on cadence (`update_estimate`) runs fused or split. Fused (the
default): one `ops.sor_refit` pass reads the history ring as it stands,
forms the window's inputs, sums, solves, gates and blends into the old
estimate (K1's refit on the card, one launch; its plain version, the
composed tensor sequence, on the CPU). Split (`fused=False`):
`ops.sor_accumulate_ring` (K7, reading the ring the same way) returns the
five sums and the solve and the blend run as tensor code in
`ref.sor_estimate_reference`'s op order. `fit_history` is the fit alone,
fused through `ops.sor_fit` (K1 on `_fit_inputs`) or split as above. The
reference resolves `fused=None` by context (fused under a JAX trace, split
on eager calls); the port has no trace, so each caller says which it runs:
the in-graph controller and the fleet train step fuse, the host controller
(`control_plane.HostRailController`) splits, as the reference's eager host
path does. `observe` keeps the observation count `tick` as a host integer
and decides the `refresh_every` cadence on the host, so a control round
never reads a device value back to choose its branch; the per-rail bounds
live on the device once per (config, device), so no refit copies from the
host either.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any

import numpy as np
import torch

from repro_torch.core import telemetry as _telemetry
from repro_torch.core.power_plane import as_f32
from repro_torch.core.telemetry import (DEFAULT_RAIL_OBSERVABLES,
                                        FrameHistory, RailObservable,
                                        TelemetryFrame)
from repro_torch.kernels import ops, ref

# the clip of the log10 observables a fit reads (zero-error samples clamp
# at the detection floor); spelled once, beside the oracle that applies it
LOG10_ERR_FLOOR = ref.LOG10_ERR_FLOOR
LOG10_ERR_CEIL = ref.LOG10_ERR_CEIL


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


@functools.lru_cache(maxsize=16)
def _rail_consts(cfg: SorConfig, device: torch.device):
    """(log10 bounds, guards), each [n_rails] f32 on `device`, copied from
    the host once per (config, device), so that no refit waits on a copy.
    Shared by every caller: read, never written."""
    return tuple(torch.from_numpy(a).to(device)
                 for a in (_rail_bounds(cfg), _rail_guards(cfg)))


def _ring(history: FrameHistory):
    """The ring's buffers as the kernels read them: v, obs, valid
    [capacity, n_rails, n_chips], age_s [capacity, n_chips] (a fleet's
    ring as it is; views of a one-chip ring: a view costs host time on
    every refit)."""
    if history.v.dim() == 3:
        return history.v, history.obs, history.valid, history.age_s
    cap, n_rails = history.capacity, len(history.rails)
    return (history.v.reshape(cap, n_rails, -1),
            history.obs.reshape(cap, n_rails, -1),
            history.valid.reshape(cap, n_rails, -1),
            history.age_s.reshape(cap, -1))


def _weighting(history: FrameHistory, cfg: SorConfig) -> dict:
    return dict(cursor=history.cursor, decay=cfg.decay,
                age_halflife_s=cfg.age_halflife_s)


def _gates(cfg: SorConfig) -> dict:
    return dict(min_slope=cfg.min_slope, min_spread_v=cfg.min_spread_v,
                conf_samples=cfg.conf_samples)


def _fit_inputs(history: FrameHistory, cfg: SorConfig):
    """The (x, y, w) EWLS inputs of the window: masked voltages, clipped
    log10 observables, recency (x optional staleness) weights."""
    return ref.sor_fit_inputs(history.v, history.obs, history.valid,
                              history.age_s, **_weighting(history, cfg))


def fit_history(history: FrameHistory, cfg: SorConfig,
                fused: bool = True) -> SorEstimate:
    """Exponentially-weighted least squares of log10(observable) against
    the rail voltage over the window, per (rail, chip): in one fused
    `ops.sor_fit` pass over `_fit_inputs`, or (`fused=False`) as
    `ops.sor_accumulate_ring` (K7 reading the ring itself) followed by the
    solve. Confidence gates on effective samples, voltage spread and a
    steep-enough frontier of the right sign."""
    shape = history.v.shape[1:]              # [n_rails, *chip]
    bound, guard = _rail_consts(cfg, history.v.device)
    if fused:
        x, y, w = (a.reshape(history.capacity, -1).contiguous()
                   for a in _fit_inputs(history, cfg))
        n_chips = x.shape[1] // cfg.n_rails

        def lanes(a):
            return a[:, None].expand(cfg.n_rails, n_chips).reshape(-1)

        # the fused pass also emits the envelope floor (v_frontier + guard);
        # `rail_envelopes` re-derives the identical f32 add
        est = ops.sor_fit(x, y, w, lanes(bound), lanes(guard),
                          **_gates(cfg))[:5]
    else:
        est = ref.sor_estimate_reference(
            ops.sor_accumulate_ring(*_ring(history),
                                    **_weighting(history, cfg)),
            bound[:, None], **_gates(cfg))
    return SorEstimate(*(a.reshape(shape) for a in est))


def update_estimate(old: SorEstimate, history: FrameHistory,
                    cfg: SorConfig, fused: bool = True) -> SorEstimate:
    """Refit the window, then blend into the running estimate with
    `update_gain`. A lane without a usable fit keeps its previous value.
    Fused: one `ops.sor_refit` pass reads the ring, fits and blends (K1's
    refit: one launch, no copy from the host). Split: `fit_history(fused=
    False)`, then the blend as tensor code."""
    shape = old.confidence.shape
    fields = [getattr(old, f) for f in _FIELDS]
    if fused:
        if len(shape) != 2:                # one chip: [n_rails] -> [n_rails, 1]
            fields = [a.reshape(cfg.n_rails, -1) for a in fields]
        new = ops.sor_refit(
            *_ring(history), fields, _rail_consts(cfg, history.v.device)[0],
            update_gain=cfg.update_gain, **_weighting(history, cfg),
            **_gates(cfg))
        if len(shape) != 2:
            new = [a.reshape(shape) for a in new]
    else:
        fit = fit_history(history, cfg, fused=False)
        new = ref.sor_blend_reference(fields,
                                      [getattr(fit, f) for f in _FIELDS],
                                      cfg.update_gain)
    return SorEstimate(*new)


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


def safe_envelope(est: SorEstimate, cfg: SorConfig) -> SafeEnvelope:
    """Back-compat single-envelope view: the VDD_IO rail's envelope (or the
    sole fitted rail's, for a 1-rail config on another rail)."""
    envs = rail_envelopes(est, cfg)
    if "VDD_IO" in envs:
        return envs["VDD_IO"]
    if len(envs) == 1:
        return next(iter(envs.values()))
    raise KeyError("safe_envelope needs a VDD_IO (or single) rail; "
                   "use rail_envelopes for multi-rail estimates")


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


def partition_specs(state: SorState, axis_name: str = "chips"):
    """The placement tree of a fleet `SorState` on a 1-D `axis_name` mesh:
    the history ring `[capacity, n_rails, n]` and the estimate `[n_rails,
    n]` shard their trailing chip axis (per-rank resident, never
    gathered), while `tick` replicates (it drives the refit cadence, which
    every rank decides alike on the host). Raises for non-fleet states:
    there is no chip axis to shard."""
    chip_shape = state.history.chip_shape
    if len(chip_shape) != 1:
        raise ValueError(
            "partition_specs needs a fleet SorState with a 1-D chip axis, "
            f"got chip_shape={chip_shape!r}")
    return ops.chip_specs(state, chip_shape[0], axis_name)


def observe(state: SorState, frame: TelemetryFrame,
            cfg: SorConfig, fused: bool = True) -> SorState:
    """Push one observation and refit (`fit_history(fused=...)`) on every
    `refresh_every`-th one; the other rounds keep the prior estimate and
    launch no fit."""
    hist = state.history.push(frame)
    tick = state.tick + 1
    est = (update_estimate(state.estimate, hist, cfg, fused=fused)
           if tick % cfg.refresh_every == 0 else state.estimate)
    return SorState(history=hist, estimate=est, tick=tick)


def merge_observables(sample: TelemetryFrame, src: TelemetryFrame,
                      cfg: SorConfig) -> TelemetryFrame:
    """Overlay the per-rail failure observables the fit needs (named by
    `cfg.rails`) from `src` (the frame the decision consumed) onto `sample`
    (e.g. a raw `poll_frame` sweep). A rail whose observable `src` does not
    carry records NaN: that rail's lane is invalid for this sample."""
    kw: dict[str, Any] = {}
    extras = dict(sample.extras)
    for spec in cfg.rails:
        v = src.get(spec.key)
        v = float("nan") if v is None else v
        if spec.key in TelemetryFrame.__dataclass_fields__:
            kw[spec.key] = v
        else:
            extras[spec.key] = v
    return dataclasses.replace(sample, extras=extras, **kw)


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
