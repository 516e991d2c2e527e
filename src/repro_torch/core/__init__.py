"""The VolTune control architecture on the simulated TPU fleet (port of
`repro/core/`): the KC705/UCD9248 simulation (codecs, pmbus, regulator,
power_manager, settling, transceiver, overhead) and its fleet adaptation
(power_plane, telemetry, learned safe operating regions, policies, the
control plane, ecollectives). Re-exports the reference's `__all__` one
for one. Importing it builds and loads no kernel: `kernels/_build.py`
builds at a kernel's first launch."""

from repro_torch.core.codecs import (
    linear11_decode, linear11_encode, linear16_decode, linear16_encode,
)
from repro_torch.core.control_plane import (
    HostDecisionController, HostPowerController, HostRailController,
    InGraphRailController, RailController, as_controller, pinned_chip_mask,
    pinned_rails, worst_chip_pinned,
)
from repro_torch.core.sor import (
    SafeEnvelope, SorConfig, SorEstimate, SorState, rail_envelopes,
    safe_envelope,
)
from repro_torch.core.telemetry import (
    ALL_RAIL_OBSERVABLES, FrameHistory, RailObservable, TelemetryFrame,
)
from repro_torch.core.fleet import FleetPowerManager, SegmentPollStats
from repro_torch.core.hwspec import V5E, ChipSpec, FleetSpec
from repro_torch.core.power_manager import (
    ControlPath, Opcode, PowerManager, Thresholds,
)
from repro_torch.core.power_plane import (
    PowerPlaneState, StepProfile, account_step, account_step_fleet,
    fleet_summary,
)
from repro_torch.core.rails import KC705_RAIL_MAP, TPU_V5E_RAIL_MAP, RailMap
from repro_torch.core.settling import settling_time
from repro_torch.core.transceiver import GtxLinkModel

__all__ = [
    "ALL_RAIL_OBSERVABLES", "ChipSpec", "ControlPath", "FleetPowerManager",
    "FleetSpec", "FrameHistory", "GtxLinkModel", "HostDecisionController",
    "HostPowerController", "HostRailController", "InGraphRailController",
    "KC705_RAIL_MAP", "Opcode", "PowerManager", "PowerPlaneState",
    "RailController", "RailMap", "RailObservable", "SafeEnvelope",
    "SegmentPollStats", "SorConfig", "SorEstimate", "SorState",
    "StepProfile", "TPU_V5E_RAIL_MAP", "TelemetryFrame", "Thresholds",
    "V5E", "account_step", "account_step_fleet", "as_controller",
    "fleet_summary", "linear11_decode", "linear11_encode",
    "linear16_decode", "linear16_encode", "pinned_chip_mask", "pinned_rails",
    "rail_envelopes", "safe_envelope", "settling_time", "worst_chip_pinned",
]
