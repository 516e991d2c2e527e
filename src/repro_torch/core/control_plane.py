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

The host half (the SW-path analogue): `HostRailController` runs the same
decide + arbitrate between steps and pushes every actuation through the
simulated PMBus fleet (`fleet.FleetPowerManager`, one board per chip),
writing the achieved (clamped, LINEAR16-quantized, settled) voltages back
into the plane. With `decide_from="poll"` it decides from its own READ_VOUT
samples; with `sor=` it learns from them through the split fit
(`sor.observe(fused=False)`, K7 on the card). The plane and the SOR state
stay on the plane's device; the bus lives on the host, so each round reads
the plane back (one device-to-host copy per read point, counted in
`plane_reads`) and writes the achieved voltages with one host-to-device
copy.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Protocol, runtime_checkable

import numpy as np
import torch

from repro_torch.core import ecollectives
from repro_torch.core.fleet import FleetPowerManager
from repro_torch.core.hwspec import V5E, ChipSpec
from repro_torch.core.policy import Policy, RailRequest, apply_request
from repro_torch.core.power_manager import ControlPath
from repro_torch.core.power_plane import PowerPlaneState, as_f32
from repro_torch.core.rails import TPU_V5E_RAIL_MAP, RailMap
from repro_torch.core.telemetry import Provenance, TelemetryFrame, as_frame

# a controller accepts the typed observation or a metrics dict
Telemetry = TelemetryFrame | dict[str, Any]

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


def pinned_lane_masks(plane: PowerPlaneState, request: RailRequest | None,
                      rail_map: RailMap = TPU_V5E_RAIL_MAP,
                      envelope: Any = None, atol: float = 1e-4
                      ) -> torch.Tensor:
    """`[n_rails, n_chips]` bool tensor on the plane's device in
    `RAIL_LANES` order: the `pinned_rails` masks, with all-False rows for
    rails the request left alone (no request, no pinning claim). No host
    copy: the fused serve tick packs these rows into its one host bundle,
    and `.any(0)` is the in-graph `pinned_chip_mask`."""
    n = plane.n_chips
    rows = []
    for name in RAIL_LANES:
        pinned = _pinned_lane(plane, request, name, envelope, rail_map,
                              atol)
        rows.append(torch.zeros(n, dtype=torch.bool, device=plane.device)
                    if pinned is None
                    else torch.atleast_1d(pinned).expand(n))
    return torch.stack(rows)


def pinned_chip_mask(plane: PowerPlaneState, request: RailRequest | None,
                     rail_map: RailMap = TPU_V5E_RAIL_MAP,
                     envelope: Any = None, atol: float = 1e-4) -> np.ndarray:
    """[n_chips] bool on the host: chips pinned on any requested rail, the
    drain mask headroom routing keeps new work off (serve/router.py)."""
    out = np.zeros(plane.n_chips, bool)
    for mask in pinned_rails(plane, request, rail_map, envelope,
                             atol).values():
        out |= mask
    return out


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


@dataclasses.dataclass
class ControlPlaneStats:
    """What a control path cost, in the units the paper reports (§V-F):
    number of actuations and simulated control-path seconds."""
    decisions: int = 0
    actuations: int = 0              # rail writes that completed on a bus
    failed_actuations: int = 0       # rejected writes (e.g. outside envelope)
    actuation_seconds: float = 0.0   # fleet time spent actuating (max over
    #                                  segments)
    serialized_seconds: float = 0.0  # single-shared-bus equivalent (sum)
    polls: int = 0                   # periodic READ_VOUT rounds completed
    polls_deferred: int = 0          # poll rounds that slipped
    poll_decisions: int = 0          # decisions made from POLLED frames
    skipped_actuations: int = 0      # writes held back by the deadband
    relaxed_polls: int = 0           # poll rounds at a relaxed interval


@runtime_checkable
class RailController(Protocol):
    """The one actuation interface. `control_step` takes the current rail
    state and the latest observation (TelemetryFrame, or a metrics dict),
    runs the policy, arbitrates, actuates, and returns the achieved state;
    `stats` reports what the control path cost."""

    name: str

    def control_step(self, plane: PowerPlaneState,
                     telemetry: Telemetry) -> PowerPlaneState: ...

    def stats(self) -> ControlPlaneStats: ...


def as_controller(policy_or_controller: Any, *, host: bool = False):
    """An existing controller passes through; None stays None; a bare
    Policy is wrapped for the requesting path: `host=False` (in-graph
    slots) -> InGraphRailController, `host=True` (between-steps slots) ->
    HostDecisionController."""
    if policy_or_controller is None:
        return None
    if hasattr(policy_or_controller, "control_step"):
        return policy_or_controller
    if host:
        return HostDecisionController(policy_or_controller)
    return InGraphRailController(policy_or_controller)


def sor_summary_of(controller: Any) -> dict | None:
    """The safe-operating-region summary a host controller learned on its
    own `control_step` (`HostRailController(sor=...).sor_summary()`); None
    for a controller without one, or for None."""
    summarize = getattr(controller, "sor_summary", None)
    return summarize() if callable(summarize) else None


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

    def stats(self) -> ControlPlaneStats:
        # the decisions run on the device beside the step: no bus cost
        return ControlPlaneStats()


# ---------------------------------------------------------------------------
# SW-path analogue: host-side decisions, PMBus-actuated over the fleet bus
# ---------------------------------------------------------------------------

class HostDecisionController:
    """Decide-only host controller: runs the policy between steps with no
    bus actuation. Pair with HostRailController when actuation cost
    matters."""

    def __init__(self, policy: Any, rail_map: RailMap = TPU_V5E_RAIL_MAP):
        if policy is None:
            raise ValueError("HostDecisionController needs a policy")
        self.policy = policy
        self.rail_map = rail_map
        self.name = f"host-decide[{getattr(policy, 'name', 'policy')}]"
        self.decisions = 0
        self.last_request: RailRequest | None = None

    def control_step(self, plane: PowerPlaneState,
                     telemetry) -> PowerPlaneState:
        self.decisions += 1
        frame = as_frame(telemetry, state=plane)
        plane, request = _run_policy(self.policy, plane, frame,
                                     self.rail_map)
        self.last_request = request
        return plane

    def stats(self) -> ControlPlaneStats:
        return ControlPlaneStats(decisions=self.decisions)


class HostRailController:
    """Host controller driving 1..N boards through the event-scheduled
    multi-segment PMBus model (paper §III-C analogue at fleet scale).

    With `policy=None` it is pure actuation (push whatever the plane asks
    for); with a policy it is decide-then-actuate. A scalar plane drives
    board 0; an `[n_chips]` plane drives one board per chip concurrently in
    simulated time.

    `decide_from` selects the observation source: "telemetry" decides from
    the frame or metrics dict the caller passes (rail observations fall back
    to the plane); "poll" decides from this controller's own READ_VOUT
    polling (sampled voltages with their per-chip staleness `age_s`, merged
    over the caller's non-electrical measurements; needs
    `enable_polling()`; chips never sampled fall back to the plane value at
    age 0).

    `sor=SorConfig(...)` learns the safe operating regions from the polls
    (`ingest="polled"`) or from the decision's frames, with the split fit
    (`sor.observe(fused=False)`: K7, then the solve). `deadband_v` > 0
    skips the bus write of a lane whose target sits within a
    confidence-scaled deadband of its learned floor and whose regulator
    already holds it; `poll_relax` > 1 then relaxes the poll interval of a
    board whose every governed lane is so pinned."""

    def __init__(
        self,
        policy: Any = None,
        *,
        n_chips: int = 1,
        path: ControlPath | str = ControlPath.SOFTWARE,
        clock_hz: int = 400_000,
        spec: ChipSpec = V5E,
        settle_band_frac: float = 0.01,
        fleet: FleetPowerManager | None = None,
        seed: int = 0,
        decide_from: str = "telemetry",
        rail_map: RailMap = TPU_V5E_RAIL_MAP,
        sor: "Any | None" = None,
        deadband_v: float = 0.0,
        poll_relax: float = 0.0,
    ):
        if decide_from not in ("telemetry", "poll"):
            raise ValueError(f"decide_from must be 'telemetry' or 'poll', "
                             f"got {decide_from!r}")
        if (decide_from == "poll" and policy is not None
                and not _has_decide(policy)):
            raise ValueError(
                "decide_from='poll' needs a decide(state, frame) policy; "
                f"{getattr(policy, 'name', type(policy).__name__)} only "
                "implements the legacy update_* API")
        if sor is not None:
            if policy is None:
                raise ValueError("sor= needs a policy: an actuate-only "
                                 "HostRailController never decides, so "
                                 "nothing would ever feed the learner")
            require_decide_for_sor(policy)
        if poll_relax and poll_relax < 1.0:
            raise ValueError(f"poll_relax must be >= 1.0 (or 0 to disable), "
                             f"got {poll_relax}")
        self.policy = policy
        self.spec = spec
        self.settle_band_frac = settle_band_frac
        self.decide_from = decide_from
        self.rail_map = rail_map
        self.fleet = fleet if fleet is not None else FleetPowerManager(
            n_chips, rail_map, path=path, clock_hz=clock_hz, seed=seed)
        self.name = (f"host[{getattr(policy, 'name', 'actuate-only')}]"
                     f"x{self.fleet.n_boards}")
        self.decisions = 0
        self.poll_decisions = 0
        self.plane_reads = 0      # device-to-host reads of plane/envelopes
        self.last_report = None   # FleetActuationReport of the latest round
        self.last_frame: TelemetryFrame | None = None
        self.last_request: RailRequest | None = None
        self.last_envelope: Any = None
        self.sor = sor
        self.sor_state = None     # sized on the first decision
        self.deadband_v = deadband_v
        self.skipped_actuations = 0
        self.poll_relax = poll_relax

    def _read_rails(self, plane: PowerPlaneState) -> np.ndarray:
        """The plane's three rails as float64 `[3, n]` in `RAIL_LANES`
        order, read back in one device-to-host copy."""
        self.plane_reads += 1
        n = plane.n_chips
        return torch.stack([torch.atleast_1d(getattr(plane, f)).expand(n)
                            for f in _LANE_FIELDS.values()]).cpu().numpy(
                                ).astype(np.float64)

    # -- observe --------------------------------------------------------------
    def observed_frame(self, plane: PowerPlaneState, telemetry=None,
                       sampled: TelemetryFrame | None = None
                       ) -> TelemetryFrame:
        """POLLED TelemetryFrame on the plane's device: the rail voltages
        this controller's polling loop last sampled (LINEAR16-quantized
        READ_VOUT values, their fleet-clock staleness in `age_s`), merged
        over the caller's non-electrical measurements. Lanes never polled
        fall back to the plane value at age 0. `sampled` reuses a
        `poll_frame` the caller already took this round."""
        base = as_frame(telemetry if telemetry is not None else {})
        if sampled is None:
            sampled = self.fleet.poll_frame()
        held = self._read_rails(plane)
        rows = []
        for j, field in enumerate(_LANE_FIELDS.values()):
            want = np.asarray(getattr(sampled, field), np.float64)
            rows.append(np.where(np.isnan(want),
                                 np.broadcast_to(held[j], want.shape), want))
        age = np.asarray(sampled.age_s, np.float64)
        rows.append(np.where(np.isnan(age), 0.0, age))
        block = torch.from_numpy(np.stack(rows).astype(np.float32)).to(
            plane.device)
        if not plane.is_fleet:
            block = block[:, 0]
        return dataclasses.replace(
            base, v_core=block[0], v_hbm=block[1], v_io=block[2],
            age_s=block[3], provenance=Provenance.POLLED)

    # -- learn ----------------------------------------------------------------
    def _sor_observe(self, plane: PowerPlaneState, frame: TelemetryFrame,
                     sampled: TelemetryFrame | None = None) -> Any:
        """Feed the SOR learner one observation and return the per-rail
        envelopes ({rail: sor.SafeEnvelope}). With `ingest="polled"` the
        history takes the raw `poll_frame` samples (NaN where a lane was
        never sampled, so such chips record nothing and their envelopes
        stay static), with the failure observables overlaid from the
        decision frame (`sor.merge_observables`); `ingest="frames"` learns
        from the decision's frame. `sampled` reuses this round's sweep."""
        from repro_torch.core import sor as _sor
        batched = plane.is_fleet
        if self.sor_state is None:
            self.sor_state = _sor.init_state(
                self.sor, plane.n_chips if batched else None,
                device=plane.device)
        if self.sor.ingest == "polled":
            raw = sampled if sampled is not None else self.fleet.poll_frame()
            # the bus sample onto the plane's device in one copy
            on_dev = torch.stack([raw.v_core, raw.v_hbm, raw.v_io,
                                  raw.age_s]).to(plane.device)
            if not batched:
                on_dev = on_dev[:, 0]
            raw = dataclasses.replace(raw, v_core=on_dev[0],
                                      v_hbm=on_dev[1], v_io=on_dev[2],
                                      age_s=on_dev[3])
            sample = _sor.merge_observables(raw, frame, self.sor)
        else:
            sample = frame
        self.sor_state = _sor.observe(self.sor_state, sample, self.sor,
                                      fused=False)
        return _sor.rail_envelopes(self.sor_state.estimate, self.sor)

    def sor_summary(self) -> dict | None:
        """Host-side view of the learned safe operating regions (None until
        the first decision under sor=SorConfig)."""
        from repro_torch.core import sor as _sor
        if self.sor is None or self.sor_state is None:
            return None
        return _sor.summary(self.sor_state.estimate, self.sor)

    # -- decide ---------------------------------------------------------------
    def decide(self, plane: PowerPlaneState, telemetry) -> PowerPlaneState:
        """Run the policy (no actuation): observation -> request ->
        arbitration, returning the target plane the bus would be asked
        for."""
        if self.policy is None:
            return plane
        sampled = None
        if self.decide_from == "poll":
            sampled = self.fleet.poll_frame()   # one bus sweep per round
            frame = self.observed_frame(plane, telemetry, sampled=sampled)
            self.poll_decisions += 1
        else:
            frame = as_frame(telemetry, state=plane)
        self.last_frame = frame
        env = (self._sor_observe(plane, frame, sampled=sampled)
               if self.sor is not None else None)
        plane, request = _run_policy(self.policy, plane, frame,
                                     self.rail_map, envelope=env)
        self.last_request = request
        self.last_envelope = env
        return plane

    # -- actuate --------------------------------------------------------------
    def _deadband_skips(self, want: dict[str, np.ndarray], n: int
                        ) -> tuple[dict[str, np.ndarray],
                                   dict[str, np.ndarray]]:
        """(skips, governed): per-rail [n] bool masks. `skips` marks lanes
        held back from the bus this round: the target sits within
        `confidence * deadband_v` of the rail's learned floor and the
        regulator already holds it (within the same band). `governed` marks
        lanes with a learned envelope at nonzero confidence. Rails without a
        learned envelope never skip. The envelopes' confidences and floors
        are read back in one copy."""
        from repro_torch.core.sor import envelope_for
        skips = {name: np.zeros(n, bool) for name in RAIL_LANES}
        governed = {name: np.zeros(n, bool) for name in RAIL_LANES}
        if self.deadband_v <= 0.0 or self.last_envelope is None:
            return skips, governed
        envs = [(name, lane, env) for name, lane in RAIL_LANES.items()
                if (env := envelope_for(self.last_envelope, name))
                is not None]
        if not envs:
            return skips, governed
        parts = []
        for name, _, env in envs:
            floor = torch.atleast_1d(
                env.floor(self.rail_map.by_name(name).v_min))
            parts += [torch.atleast_1d(as_f32(env.confidence, floor.device)),
                      floor]
        self.plane_reads += 1
        got = torch.stack([p.expand(n) for p in parts]).cpu().numpy(
            ).astype(np.float64)
        for k, (name, lane, _) in enumerate(envs):
            conf, floor = got[2 * k], got[2 * k + 1]
            held = np.array([self.fleet.segments[i].rail_voltage(lane)
                             for i in range(n)], np.float64)
            band = conf * self.deadband_v
            governed[name] = conf > 0.0
            skips[name] = (governed[name]
                           & (np.abs(want[name] - floor) <= band)
                           & (np.abs(held - want[name]) <= band))
        return skips, governed

    def actuate(self, plane: PowerPlaneState) -> PowerPlaneState:
        """Push the plane's rail voltages through PMBus on every board;
        returns the plane with voltages replaced by what the regulators
        achieved (clamp + LINEAR16 quantization + settling). Lanes held back
        by the deadband read back as the voltage the regulator holds."""
        rails = self._read_rails(plane)
        want = {name: rails[j] for j, name in enumerate(RAIL_LANES)}
        n = rails.shape[1]
        if n != self.fleet.n_boards:
            raise ValueError(
                f"state has {n} chip(s) but the fleet bus has "
                f"{self.fleet.n_boards} board(s)")
        skips, governed = self._deadband_skips(want, n)
        self.skipped_actuations += int(sum(s.sum() for s in skips.values()))
        if self.poll_relax > 1.0:
            # a board whose every governed lane is pinned this round polls
            # at poll_relax x the requested interval; any lane leaving its
            # band restores the full rate on the board's next firing
            skp = np.stack([skips[name] for name in RAIL_LANES])
            gov = np.stack([governed[name] for name in RAIL_LANES])
            pinned_board = gov.any(axis=0) & (skp | ~gov).all(axis=0)
            lanes_pinned = skp.sum(axis=0)
            for i in range(n):
                self.fleet.set_poll_relax(
                    i, self.poll_relax if pinned_board[i] else 1.0,
                    lanes_pinned=int(lanes_pinned[i]))
        setpoints = [{RAIL_LANES[name]: float(want[name][i])
                      for name in RAIL_LANES if not skips[name][i]}
                     for i in range(n)]
        achieved, self.last_report = self.fleet.apply_setpoints(
            setpoints, settle_band_frac=self.settle_band_frac)
        got = np.array([[achieved[i].get(
                             lane, self.fleet.segments[i].rail_voltage(lane))
                         for i in range(n)]
                        for lane in RAIL_LANES.values()], dtype=np.float32)
        block = torch.from_numpy(got).to(plane.device)
        if not plane.is_fleet:
            block = block[:, 0]
        return dataclasses.replace(plane, v_core=block[0], v_hbm=block[1],
                                   v_io=block[2])

    # the single-board HostPowerController spelling
    apply = actuate

    def control_step(self, plane: PowerPlaneState,
                     telemetry) -> PowerPlaneState:
        self.decisions += 1
        return self.actuate(self.decide(plane, telemetry))

    # -- observability --------------------------------------------------------
    @property
    def pm(self):
        """Board 0's PowerManager."""
        return self.fleet.segments[0].pm

    @property
    def actuations(self) -> int:
        return self.fleet.lane_writes

    @property
    def actuation_seconds(self) -> float:
        return self.fleet.actuation_seconds

    def readback(self, board: int = 0) -> dict[str, float]:
        """PMBus-sampled (READ_VOUT) rail voltages of one board."""
        pm = self.fleet.segments[board].pm
        return {name: pm.get_voltage(lane)
                for name, lane in RAIL_LANES.items()}

    def enable_polling(self, interval_s: float | None = None,
                       lanes=None) -> None:
        """Start periodic READ_VOUT polling on every board's bus segment
        (paper Table VI intervals by default), interleaved with this
        controller's actuations on the fleet timeline. Polls fire as fleet
        time advances (actuations, `self.fleet.idle(dt)`)."""
        self.fleet.start_polling(interval_s, lanes)

    def stats(self) -> ControlPlaneStats:
        polls = self.fleet.poll_stats.values()
        return ControlPlaneStats(
            decisions=self.decisions,
            actuations=self.fleet.lane_writes,
            failed_actuations=self.fleet.failed_writes,
            actuation_seconds=self.fleet.actuation_seconds,
            serialized_seconds=self.fleet.serialized_seconds,
            polls=sum(st.polls for st in polls),
            polls_deferred=sum(st.deferred for st in polls),
            poll_decisions=self.poll_decisions,
            skipped_actuations=self.skipped_actuations,
            relaxed_polls=sum(st.relaxed_polls for st in polls))


class HostPowerController(HostRailController):
    """The single-board actuator (`apply(state)`): an actuate-only
    HostRailController on one board."""

    def __init__(self, path: ControlPath | str = ControlPath.SOFTWARE,
                 clock_hz: int = 400_000, spec: ChipSpec = V5E):
        super().__init__(None, n_chips=1, path=path, clock_hz=clock_hz,
                         spec=spec)
