"""Voltage/compression selection policies (port of the decide API of
`repro/core/policy.py`):

    decide(state, frame) -> RailRequest

A policy reads a typed `TelemetryFrame` and returns a declarative
`RailRequest` — the rail voltages / compression level it wants, per chip or
broadcast. It never mutates the plane; arbitration against the safety
envelopes lives in `control_plane.arbitrate`. Every decision is elementwise
on tensors, so one decide() serves a scalar plane and a `[n_chips]` fleet.

The pre-redesign API, `update_jax/update_host/update_fleet(state,
telemetry dict) -> state`, survives as thin deprecated shims over decide()
with the reference's names (warning: `ControlAPIDeprecationWarning`); no
module of the package calls them.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Any

import torch

from repro_torch.core import ecollectives
from repro_torch.core.hwspec import V5E, ChipSpec
from repro_torch.core.power_plane import PowerPlaneState, as_f32
from repro_torch.core.telemetry import (RAIL_OBSERVABLE_KEYS, TelemetryFrame,
                                        ndim)


class ControlAPIDeprecationWarning(DeprecationWarning):
    """Raised by the legacy `Policy.update_*` shims."""


def _warn_legacy(name: str) -> None:
    warnings.warn(
        f"Policy.{name}(state, telemetry_dict) is deprecated; implement/call "
        f"decide(state, frame) -> RailRequest and actuate through a "
        f"RailController (see docs/control_api.md)",
        ControlAPIDeprecationWarning, stacklevel=3)


@dataclasses.dataclass(frozen=True)
class RailRequest:
    """A declarative operating-point request. None fields mean 'leave this
    rail alone'. Values may be scalar (broadcast over a fleet) or
    `[n_chips]`. `reason` is a policy-assigned code for logs."""
    v_core: Any = None
    v_hbm: Any = None
    v_io: Any = None
    comp_level: Any = None
    reason: str = ""

    def is_empty(self) -> bool:
        return (self.v_core is None and self.v_hbm is None
                and self.v_io is None and self.comp_level is None)


def apply_request(state: PowerPlaneState, request: RailRequest
                  ) -> PowerPlaneState:
    """Raw merge of a request into a plane state — no envelope clamping
    (that is `control_plane.arbitrate`'s job). Scalar request fields
    broadcast over a `[n_chips]` state."""
    fleet_shape = state.v_core.shape if state.is_fleet else None

    def merge(cur, want, dtype):
        if want is None:
            return cur
        if isinstance(want, (int, float)):
            v = torch.full((), want, dtype=dtype, device=state.device)
        else:
            v = torch.as_tensor(want, device=state.device).to(dtype)
        if fleet_shape is not None and v.dim() == 0:
            v = v.expand(fleet_shape)
        return v

    return dataclasses.replace(
        state,
        v_core=merge(state.v_core, request.v_core, torch.float32),
        v_hbm=merge(state.v_hbm, request.v_hbm, torch.float32),
        v_io=merge(state.v_io, request.v_io, torch.float32),
        comp_level=merge(state.comp_level, request.comp_level, torch.int32),
    )


def _nom(anchor, fallback: float, state: PowerPlaneState) -> torch.Tensor:
    """Per-chip nominal voltage from the frame (fleet path) or the spec
    scalar (scalar path)."""
    return as_f32(fallback if anchor is None else anchor, state.device)


def _rail_env(envelope, rail: str):
    """One rail's envelope from either spelling (see sor.envelope_for)."""
    from repro_torch.core.sor import envelope_for
    return envelope_for(envelope, rail)


def _obs(observed, state_value):
    """A rail observation from the frame, falling back to the plane."""
    return state_value if observed is None else observed


class Policy:
    name = "base"
    # True on policies whose decide reduces *across* chips (a fleet-wide
    # worst-of gate): inside the sharded control round such a policy would
    # reduce over its rank's chips only, so the sharded paths reject it.
    # Elementwise per-chip policies keep the default False.
    cross_chip = False

    def decide(self, state: PowerPlaneState,
               frame: TelemetryFrame) -> RailRequest:
        raise NotImplementedError(
            f"{type(self).__name__} defines no decide(); implement it")

    def decide_env(self, state: PowerPlaneState, frame: TelemetryFrame,
                   envelope=None) -> RailRequest:
        """decide() under learned `sor.SafeEnvelope`s (a single VDD_IO
        envelope or a {rail: SafeEnvelope} dict); the base ignores them."""
        return self.decide(state, frame)

    # -- deprecated dict-interface shims: the raw merge of decide()'s
    # request, as the old state-mutating update_* methods did
    def _legacy_update(self, state: PowerPlaneState,
                       telemetry) -> PowerPlaneState:
        frame = TelemetryFrame.from_dict(telemetry, state=state)
        return apply_request(state, self.decide(state, frame))

    def update_jax(self, state: PowerPlaneState, telemetry) -> PowerPlaneState:
        _warn_legacy("update_jax")
        return self._legacy_update(state, telemetry)

    def update_host(self, state: PowerPlaneState,
                    telemetry) -> PowerPlaneState:
        _warn_legacy("update_host")
        return self._legacy_update(state, telemetry)

    def update_fleet(self, state: PowerPlaneState,
                     telemetry) -> PowerPlaneState:
        """Scalar entries broadcast to `[n_chips]` on the plane's device;
        the elementwise decide() then serves every chip at once."""
        _warn_legacy("update_fleet")
        n = state.v_core.shape[0]
        telem = {k: torch.as_tensor(v, device=state.device).expand(n)
                 if ndim(v) == 0 else v for k, v in telemetry.items()}
        return self._legacy_update(state, telem)


@dataclasses.dataclass
class StaticNominal(Policy):
    """Fixed worst-case margins — the baseline for energy comparisons."""
    spec: ChipSpec = V5E
    name: str = "static-nominal"

    def decide(self, state, frame):
        return RailRequest(
            v_core=_nom(frame.v_nom_core, self.spec.nominal_v_core, state),
            v_hbm=_nom(frame.v_nom_hbm, self.spec.nominal_v_hbm, state),
            v_io=_nom(frame.v_nom_io, self.spec.nominal_v_io, state),
            comp_level=ecollectives.LEVEL_LOSSLESS,
            reason="static-nominal-margins",
        )


@dataclasses.dataclass
class BERBounded(Policy):
    """The paper's case-study policy, gradient-domain: the most aggressive
    compression level whose measured error stays under `error_bound`, and
    VDD_IO undervolted with the wire-byte savings."""
    error_bound: float = 5e-3
    v_io_floor: float = 0.80
    spec: ChipSpec = V5E
    name: str = "ber-bounded"
    envelope: Any = None

    def decide(self, state, frame):
        return self.decide_env(state, frame, self.envelope)

    def decide_env(self, state, frame, envelope=None):
        envelope = _rail_env(envelope, "VDD_IO")
        err = as_f32(frame.grad_error, state.device)
        lvl = state.comp_level
        lvl = torch.where(err < 0.5 * self.error_bound,
                          torch.clamp(lvl + 1,
                                      max=ecollectives.LEVEL_INT8_TOPK), lvl)
        lvl = torch.where(err > self.error_bound,
                          torch.clamp(lvl - 1, min=0), lvl)
        v_nom_io = _nom(frame.v_nom_io, self.spec.nominal_v_io, state)
        base = v_nom_io * 0.9
        if envelope is None:
            v_low = torch.clamp(base, min=self.v_io_floor)
        else:
            floor_eff = envelope.floor(self.v_io_floor)
            c = as_f32(envelope.confidence, state.device)
            v_low = torch.maximum(floor_eff, base + c * (floor_eff - base))
        v_io = torch.where(lvl > 0, v_low, v_nom_io)
        return RailRequest(v_io=v_io, comp_level=lvl.to(torch.int32),
                           reason="ber-bounded-hysteresis")


@dataclasses.dataclass
class PhaseAware(Policy):
    """Whichever roofline term is not dominant has slack — undervolt its
    rail until the terms balance."""
    margin: float = 0.10
    spec: ChipSpec = V5E
    name: str = "phase-aware"

    def decide(self, state, frame):
        return self.decide_env(state, frame, None)

    def decide_env(self, state, frame, envelope=None):
        dev = state.device
        t_comp = as_f32(frame.t_comp_s, dev)
        t_mem = as_f32(frame.t_mem_s, dev)
        t_coll = as_f32(frame.t_coll_s, dev)
        t_dom = torch.maximum(t_comp, torch.maximum(t_mem, t_coll))
        target = t_dom * (1.0 - self.margin)

        def scaled(rail, v_nom, v_min, t_mine):
            env = _rail_env(envelope, rail)
            lo = as_f32(v_min, dev) if env is None else env.floor(v_min)
            s = torch.clamp(t_mine / target, 0.0, 1.0)
            return torch.maximum(v_nom * s, lo)

        from repro_torch.core.rails import TPU_V5E_RAIL_MAP as rm
        return RailRequest(
            v_core=scaled("VDD_CORE",
                          _nom(frame.v_nom_core, self.spec.nominal_v_core,
                               state),
                          rm.by_name("VDD_CORE").v_min, t_comp),
            v_hbm=scaled("VDD_HBM",
                         _nom(frame.v_nom_hbm, self.spec.nominal_v_hbm,
                              state),
                         rm.by_name("VDD_HBM").v_min, t_mem),
            v_io=scaled("VDD_IO",
                        _nom(frame.v_nom_io, self.spec.nominal_v_io, state),
                        rm.by_name("VDD_IO").v_min, t_coll),
            reason="phase-slack",
        )


@dataclasses.dataclass
class ClosedLoop(Policy):
    """AIMD feedback on telemetry: walk VDD_IO down while the measured error
    stays under the bound, back off multiplicatively on violation."""
    error_bound: float = 5e-3
    step_v: float = 0.005
    backoff: float = 1.05
    v_io_floor: float = 0.75
    spec: ChipSpec = V5E
    name: str = "closed-loop"
    envelope: Any = None

    def decide(self, state, frame):
        return self.decide_env(state, frame, self.envelope)

    def decide_env(self, state, frame, envelope=None):
        dev = state.device
        envelope = _rail_env(envelope, "VDD_IO")
        err = as_f32(frame.grad_error, dev)
        v_io_obs = as_f32(_obs(frame.v_io, state.v_io), dev)
        ok = err <= self.error_bound
        if envelope is None:
            v_down = torch.clamp(v_io_obs - self.step_v, min=self.v_io_floor)
        else:
            floor_eff = envelope.floor(self.v_io_floor)
            c = as_f32(envelope.confidence, dev)
            walk = v_io_obs - self.step_v
            v_down = torch.maximum(walk + c * (floor_eff - walk), floor_eff)
        v_up = torch.minimum(v_io_obs * self.backoff,
                             _nom(frame.v_nom_io, self.spec.nominal_v_io,
                                  state))
        v_io = torch.where(ok, v_down, v_up)
        lvl = torch.where(ok, torch.clamp(state.comp_level + 1,
                                          max=ecollectives.LEVEL_INT8),
                          ecollectives.LEVEL_LOSSLESS)
        return RailRequest(v_io=v_io, comp_level=lvl.to(torch.int32),
                           reason="aimd-feedback")


@dataclasses.dataclass
class MultiRailClosedLoop(Policy):
    """The AIMD walk on every rail, each on its own failure observable
    (`telemetry.RAIL_OBSERVABLE_KEYS`); a rail whose observable the frame
    does not carry — or carries as NaN — holds position."""
    error_bound: float = 5e-3
    step_v: float = 0.005
    backoff: float = 1.05
    spec: ChipSpec = V5E
    name: str = "multi-rail-closed-loop"
    floors: dict = dataclasses.field(default_factory=lambda: {
        "VDD_CORE": 0.65, "VDD_HBM": 0.95, "VDD_IO": 0.75})

    def decide(self, state, frame):
        return self.decide_env(state, frame, None)

    def decide_env(self, state, frame, envelope=None):
        dev = state.device
        rails = (
            ("VDD_CORE", "v_core",
             _nom(frame.v_nom_core, self.spec.nominal_v_core, state)),
            ("VDD_HBM", "v_hbm",
             _nom(frame.v_nom_hbm, self.spec.nominal_v_hbm, state)),
            ("VDD_IO", "v_io",
             _nom(frame.v_nom_io, self.spec.nominal_v_io, state)),
        )
        kw: dict[str, Any] = {}
        for rail, field, v_nom in rails:
            obs = frame.get(RAIL_OBSERVABLE_KEYS[rail])
            if obs is None or rail not in self.floors:
                continue
            err = as_f32(obs, dev)
            v_obs = as_f32(_obs(getattr(frame, field), getattr(state, field)),
                           dev)
            floor = self.floors[rail]
            env = _rail_env(envelope, rail)
            if env is None:
                v_down = torch.clamp(v_obs - self.step_v, min=floor)
            else:
                floor_eff = env.floor(floor)
                c = as_f32(env.confidence, dev)
                walk = v_obs - self.step_v
                v_down = torch.maximum(walk + c * (floor_eff - walk),
                                       floor_eff)
            v_up = torch.minimum(v_obs * self.backoff, v_nom)
            v = torch.where(err <= self.error_bound, v_down, v_up)
            # NaN observable == "not measured this round": hold, don't walk
            kw[field] = torch.where(torch.isnan(err), v_obs, v)
        io_err = as_f32(frame.grad_error, dev)
        lvl = torch.where(io_err <= self.error_bound,
                          torch.clamp(state.comp_level + 1,
                                      max=ecollectives.LEVEL_INT8),
                          ecollectives.LEVEL_LOSSLESS)
        lvl = torch.where(torch.isnan(io_err), state.comp_level, lvl)
        return RailRequest(comp_level=lvl.to(torch.int32),
                           reason="multi-rail-aimd", **kw)


@dataclasses.dataclass
class WorstChipGate(Policy):
    """Gate every chip's decision on the worst chip's error telemetry; each
    chip keeps its own learned floor."""
    cross_chip = True
    inner: Policy = dataclasses.field(default_factory=lambda: BERBounded())
    reduce_keys: tuple[str, ...] = ("grad_error", "straggle_rate",
                                    "hbm_error_rate")
    name: str = "worst-chip"
    envelope: Any = None

    def __post_init__(self):
        self.name = f"worst-chip[{self.inner.name}]"

    def decide(self, state, frame):
        return self.decide_env(state, frame, self.envelope)

    def decide_env(self, state, frame, envelope=None):
        if state.is_fleet:
            frame = frame.reduce_worst(self.reduce_keys)
        if envelope is None:
            return self.inner.decide(state, frame)
        return self.inner.decide_env(state, frame, envelope)

    def update_fleet(self, state, telemetry):
        # the legacy shim, override for override with the old API: reduce
        # the dict, then delegate to the inner policy's fleet shim
        _warn_legacy("update_fleet")
        telem = dict(telemetry)
        for k in self.reduce_keys:
            if k in telem and ndim(telem[k]) >= 1:
                v = torch.as_tensor(telem[k], device=state.device)
                telem[k] = v.max().expand(v.shape)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", ControlAPIDeprecationWarning)
            return self.inner.update_fleet(state, telem)


@dataclasses.dataclass
class StalenessGuard(Policy):
    """Widen the requested margin in proportion to how stale the
    observations are (beyond `grace_s`, capped at `max_widen_v`)."""
    inner: Policy = dataclasses.field(default_factory=lambda: ClosedLoop())
    grace_s: float = 0.050
    widen_v_per_s: float = 0.5
    max_widen_v: float = 0.05
    name: str = "staleness-guard"

    def __post_init__(self):
        self.name = f"staleness-guard[{self.inner.name}]"

    def decide(self, state, frame):
        return self.decide_env(state, frame, None)

    def decide_env(self, state, frame, envelope=None):
        req = (self.inner.decide_env(state, frame, envelope)
               if envelope is not None else self.inner.decide(state, frame))
        age = as_f32(frame.age_s, state.device)
        widen = torch.clamp((age - self.grace_s) * self.widen_v_per_s,
                            0.0, self.max_widen_v)
        # NaN age == staleness unknown: widen fully
        widen = torch.where(torch.isnan(age), self.max_widen_v, widen)

        def lift(v):
            return None if v is None else as_f32(v, state.device) + widen

        return dataclasses.replace(
            req, v_core=lift(req.v_core), v_hbm=lift(req.v_hbm),
            v_io=lift(req.v_io),
            reason=f"{req.reason}+staleness-guard" if req.reason
            else "staleness-guard")


POLICIES = {p.name: p for p in
            (StaticNominal(), BERBounded(), PhaseAware(), ClosedLoop(),
             MultiRailClosedLoop(), WorstChipGate(BERBounded()),
             StalenessGuard(ClosedLoop()))}
