"""The rail control plane, in-graph half (port of
`repro/core/control_plane.py`): `arbitrate` clamps a policy's `RailRequest`
into the plane under the per-rail safety envelopes, and
`InGraphRailController` runs observation -> decision -> arbitration as
plain tensor code on the plane's device.

With `sor=SorConfig(...)` the controller learns per-chip safe operating
regions: `control_step_sor` pushes the frame into the history, refits on
the configured cadence (one fused `sor_fit` kernel launch), derives the
per-rail envelopes and runs the envelope-warm-started decide plus the
envelope-clamped arbitration. The reference jits this round; here it runs
eagerly, op by op, with no device-to-host read.

The host (SW-path) controllers — PMBus actuation, polling, deadband — are
not ported yet.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.core import ecollectives
from repro_torch.core.policy import Policy, RailRequest, apply_request
from repro_torch.core.power_plane import PowerPlaneState, as_f32
from repro_torch.core.rails import TPU_V5E_RAIL_MAP, RailMap
from repro_torch.core.telemetry import TelemetryFrame, as_frame

# TPU logical rails in PowerPlaneState field order.
RAIL_LANES = {"VDD_CORE": 0, "VDD_HBM": 1, "VDD_IO": 2}
_LANE_FIELDS = {"VDD_CORE": "v_core", "VDD_HBM": "v_hbm", "VDD_IO": "v_io"}


def arbitrate(plane: PowerPlaneState, request: RailRequest,
              rail_map: RailMap = TPU_V5E_RAIL_MAP,
              envelopes: dict | None = None) -> PowerPlaneState:
    """Merge a `RailRequest` into the plane under the per-rail safety
    envelopes: None fields keep the current value, scalar fields broadcast
    over a fleet, voltages clamp into [v_min, v_max] of their rail (or into
    [env.floor(v_min), env.ceil(v_max)] of a learned envelope), compression
    levels clamp into the codec range."""
    def clamp(want, name):
        if want is None:
            return None
        r = rail_map.by_name(name)
        env = envelopes.get(name) if envelopes else None
        if env is None:
            lo, hi = float(np.float32(r.v_min)), float(np.float32(r.v_max))
        else:
            lo, hi = env.floor(r.v_min), env.ceil(r.v_max)
        return torch.clamp(as_f32(want, plane.device), lo, hi)

    comp = request.comp_level
    if comp is not None:
        comp = torch.clamp(torch.as_tensor(comp, device=plane.device).to(
            torch.int32), ecollectives.LEVEL_LOSSLESS,
            ecollectives.LEVEL_INT8_TOPK)

    clamped = RailRequest(v_core=clamp(request.v_core, "VDD_CORE"),
                          v_hbm=clamp(request.v_hbm, "VDD_HBM"),
                          v_io=clamp(request.v_io, "VDD_IO"),
                          comp_level=comp, reason=request.reason)
    return apply_request(plane, clamped)


def rail_floors(plane: PowerPlaneState, envelope: Any = None,
                rail_map: RailMap = TPU_V5E_RAIL_MAP) -> torch.Tensor:
    """`[n_rails, n_chips]` f32 arbitration floors in `RAIL_LANES` order:
    the confidence-blended learned floor where a rail carries a fitted
    envelope, the static `Rail.v_min` where it does not."""
    n = plane.n_chips
    return torch.stack([
        torch.atleast_1d(_rail_floor(plane, envelope, name, rail_map)
                         ).expand(n) for name in RAIL_LANES])


def _rail_floor(plane: PowerPlaneState, envelope: Any, name: str,
                rail_map: RailMap) -> torch.Tensor:
    """One rail's arbitration floor: the learned envelope's blended floor,
    else the static `Rail.v_min`."""
    from repro_torch.core.sor import envelope_for
    env = envelope_for(envelope, name)
    r = rail_map.by_name(name)
    return (env.floor(r.v_min) if env is not None
            else as_f32(r.v_min, plane.device))


def _pinned_lane(plane: PowerPlaneState, request: RailRequest | None,
                 name: str, envelope: Any, rail_map: RailMap, atol: float):
    """Pinned mask for one rail, or None when the request left it alone."""
    if request is None:
        return None
    want = getattr(request, _LANE_FIELDS[name])
    if want is None:
        return None
    floor = _rail_floor(plane, envelope, name, rail_map)
    wantv = as_f32(want, plane.device)
    held = as_f32(getattr(plane, _LANE_FIELDS[name]), plane.device)
    return (wantv <= floor + atol) & (held <= floor + atol)


def pinned_rails(plane: PowerPlaneState, request: RailRequest | None,
                 rail_map: RailMap = TPU_V5E_RAIL_MAP,
                 envelope: Any = None, atol: float = 1e-4
                 ) -> dict[str, np.ndarray]:
    """{rail name: [n_chips] bool} for every rail the request asked for: a
    chip is pinned when the decision wanted a voltage at/below the floor
    arbitration holds it to AND the plane is already held there. One
    device-to-host copy for all rails."""
    out: dict[str, np.ndarray] = {}
    if request is None:
        return out
    n = plane.n_chips
    names, lanes = [], []
    for name in _LANE_FIELDS:
        pinned = _pinned_lane(plane, request, name, envelope, rail_map,
                              atol)
        if pinned is None:
            continue
        names.append(name)
        lanes.append(torch.atleast_1d(pinned).expand(n))
    if not names:
        return out
    masks = torch.stack(lanes).cpu().numpy().astype(bool)
    return {name: masks[i].copy() for i, name in enumerate(names)}


def worst_chip_pinned(plane: PowerPlaneState, request: RailRequest | None,
                      rail_map: RailMap = TPU_V5E_RAIL_MAP,
                      envelope: Any = None, atol: float = 1e-4) -> bool:
    """Is any chip pinned at any requested rail's envelope floor?"""
    return any(bool(mask.any())
               for mask in pinned_rails(plane, request, rail_map, envelope,
                                        atol).values())


def _has_decide(policy: Any) -> bool:
    fn = getattr(type(policy), "decide", None)
    return fn is not None and fn is not Policy.decide


def require_decide_for_sor(policy: Any) -> None:
    """A controller with sor= runs decide_env + envelope-clamped
    arbitration; a policy without decide() would learn regions that are
    never consumed."""
    if policy is not None and not _has_decide(policy):
        raise ValueError(
            "sor= needs a decide(state, frame) policy; "
            f"{getattr(policy, 'name', type(policy).__name__)} has none")


def validate_in_graph_sor(cfg: Any) -> None:
    """The in-graph controller learns from the frames the decision
    consumes, so only `ingest="frames"` means anything here."""
    if cfg is not None and cfg.ingest != "frames":
        raise ValueError(
            "in-graph SOR learns from the frames the decision consumes; "
            "use SorConfig(ingest='frames') (ingest='polled' is the "
            "host controller's READ_VOUT path)")


def with_sor(controller: Any, sor_cfg: Any) -> Any:
    """Give an in-graph controller a SorConfig without mutating it: a
    controller without one is rebuilt with it, one carrying the same config
    passes through, a different config is a conflict."""
    validate_in_graph_sor(sor_cfg)
    if not hasattr(controller, "control_step_sor"):
        raise ValueError(
            "sor= needs an InGraphRailController (or a bare policy); got "
            f"{type(controller).__name__}")
    require_decide_for_sor(controller.policy)
    if controller.sor is not None:
        if controller.sor != sor_cfg:
            raise ValueError(
                "conflicting SorConfig: the controller already carries its "
                "own sor=; configure it in one place")
        return controller
    return InGraphRailController(controller.policy, name=controller.name,
                                 rail_map=controller.rail_map, sor=sor_cfg)


def _run_policy(policy: Any, plane: PowerPlaneState, frame: TelemetryFrame,
                rail_map: RailMap, *, envelope: Any = None
                ) -> tuple[PowerPlaneState, RailRequest]:
    """decide() + arbitrate(); with a learned envelope, decide_env() and the
    envelope-clamped arbitration. Returns (arbitrated plane, the
    pre-arbitration request)."""
    if not _has_decide(policy):
        raise ValueError(
            f"{getattr(policy, 'name', type(policy).__name__)} defines no "
            f"decide(); the legacy update_* policy API is not ported")
    if envelope is not None:
        from repro_torch.core.sor import as_envelopes
        request = policy.decide_env(plane, frame, envelope)
        arbitrated = arbitrate(plane, request, rail_map,
                               envelopes=as_envelopes(envelope))
    else:
        request = policy.decide(plane, frame)
        arbitrated = arbitrate(plane, request, rail_map)
    return arbitrated, request


def as_controller(policy_or_controller: Any):
    """An existing controller passes through; None stays None; a bare
    Policy is wrapped into an InGraphRailController (the host decision
    controller is not ported yet)."""
    if policy_or_controller is None:
        return None
    if hasattr(policy_or_controller, "control_step"):
        return policy_or_controller
    return InGraphRailController(policy_or_controller)


class InGraphRailController:
    """Controller whose decision and arbitration run as tensor code on the
    plane's device (the HW-path analogue): actuation is the identity, the
    arbitrated operating point applies to the next step."""

    def __init__(self, policy: Any, name: str | None = None,
                 rail_map: RailMap = TPU_V5E_RAIL_MAP,
                 sor: "Any | None" = None):
        if policy is None:
            raise ValueError("InGraphRailController needs a policy")
        validate_in_graph_sor(sor)
        if sor is not None:
            require_decide_for_sor(policy)
        self.policy = policy
        self.rail_map = rail_map
        self.sor = sor
        self.name = name or f"in-graph[{getattr(policy, 'name', 'policy')}]"
        self.last_request: RailRequest | None = None
        self.last_envelope: Any = None

    def control_step(self, plane: PowerPlaneState,
                     telemetry) -> PowerPlaneState:
        frame = as_frame(telemetry, state=plane)
        plane, request = _run_policy(self.policy, plane, frame,
                                     self.rail_map)
        self.last_request = request
        return plane

    def init_sor(self, n_chips: int | None = None, device="cuda"):
        """Fresh SOR state for a `control_step_sor` loop."""
        from repro_torch.core import sor as _sor
        if self.sor is None:
            raise ValueError("construct the controller with sor=SorConfig() "
                             "before init_sor()")
        return _sor.init_state(self.sor, n_chips, device=device)

    def control_round(self, plane: PowerPlaneState, frame: TelemetryFrame,
                      sor_state):
        """One SOR control round: ingest the frame, refit on cadence,
        derive the per-rail envelopes, decide + arbitrate. Returns (plane',
        sor_state', request, envelopes)."""
        from repro_torch.core import sor as _sor
        if self.sor is None:
            raise ValueError("control_step_sor needs sor=SorConfig()")
        sor_state = _sor.observe(sor_state, frame, self.sor)
        env = _sor.rail_envelopes(sor_state.estimate, self.sor)
        plane, request = _run_policy(self.policy, plane, frame,
                                     self.rail_map, envelope=env)
        return plane, sor_state, request, env

    def control_step_sor(self, plane: PowerPlaneState, telemetry,
                         sor_state):
        """One SOR-aware control round; returns (plane', sor_state')."""
        if self.sor is None:
            raise ValueError("control_step_sor needs sor=SorConfig()")
        frame = as_frame(telemetry, state=plane)
        plane, sor_state, request, env = self.control_round(
            plane, frame, sor_state)
        self.last_request = request
        self.last_envelope = env
        return plane, sor_state
