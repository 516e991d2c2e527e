"""The TPU power plane of the simulated fleet (port of
`repro/core/power_plane.py`): rail state, the roofline step model under the
current rails, and per-chip energy accounting.

Three logical rails per chip — VDD_CORE, VDD_HBM, VDD_IO — are runtime
state threaded through the serving loop. Step time and energy derive from
the step's roofline terms (`StepProfile`) scaled by the rail voltages
(f ∝ v) and the collective compression level.

The reference vmaps the scalar accounting over a `[n_chips]` fleet; every
function here is elementwise on tensors, so a `[n_chips]` state is the
batch dimension written out and the same code serves the scalar plane.
Tensors live on the state's device; host-side constants enter as Python
numbers rounded to f32 exactly where the reference casts them.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import ecollectives
from repro_torch.core.hwspec import V5E, ChipSpec, FleetSpec


def as_f32(x, device) -> torch.Tensor:
    """A Python number, numpy array or tensor as a float32 tensor on
    `device` (a no-op for a float32 tensor already there). A number is
    filled on the device, so it costs no host-to-device copy or sync."""
    if isinstance(x, (int, float)):
        return torch.full((), x, dtype=torch.float32, device=device)
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _f32(x: float) -> float:
    """A host constant rounded to float32, as `jnp.float32(x)` does."""
    return float(np.float32(x))


@dataclasses.dataclass
class PowerPlaneState:
    """Rail state: scalar fields model one chip; `[n_chips]` fields model a
    fleet with per-chip operating points."""
    v_core: torch.Tensor      # f32 [] or [n_chips]
    v_hbm: torch.Tensor       # f32 [] or [n_chips]
    v_io: torch.Tensor        # f32 [] or [n_chips]
    comp_level: torch.Tensor  # i32 [] or [n_chips] — compression level
    energy_j: torch.Tensor    # f32 [] or [n_chips] — accumulated energy
    step: torch.Tensor        # i32 [] or [n_chips]

    @staticmethod
    def nominal(spec: ChipSpec = V5E, device="cuda") -> "PowerPlaneState":
        f = lambda v: torch.tensor(v, dtype=torch.float32, device=device)
        i = lambda v: torch.tensor(v, dtype=torch.int32, device=device)
        return PowerPlaneState(
            v_core=f(spec.nominal_v_core), v_hbm=f(spec.nominal_v_hbm),
            v_io=f(spec.nominal_v_io),
            comp_level=i(ecollectives.LEVEL_LOSSLESS), energy_j=f(0.0),
            step=i(0))

    @staticmethod
    def from_fleet(fleet: FleetSpec, device="cuda") -> "PowerPlaneState":
        """Fleet state with every chip at its own per-chip nominal point."""
        n = fleet.n_chips
        return PowerPlaneState(
            v_core=as_f32(fleet.v_core_nominal, device),
            v_hbm=as_f32(fleet.v_hbm_nominal, device),
            v_io=as_f32(fleet.v_io_nominal, device),
            comp_level=torch.full((n,), ecollectives.LEVEL_LOSSLESS,
                                  dtype=torch.int32, device=device),
            energy_j=torch.zeros(n, dtype=torch.float32, device=device),
            step=torch.zeros(n, dtype=torch.int32, device=device))

    @property
    def device(self) -> torch.device:
        return self.v_core.device

    @property
    def is_fleet(self) -> bool:
        return self.v_core.dim() >= 1

    @property
    def n_chips(self) -> int:
        return int(self.v_core.shape[0]) if self.is_fleet else 1


@dataclasses.dataclass(frozen=True)
class StepProfile:
    """Static per-(arch, shape, mesh) roofline terms of one step."""
    flops_per_chip: float
    hbm_bytes_per_chip: float
    ici_bytes_per_chip: float      # at lossless compression
    grad_bytes_per_chip: float = 0.0  # gradient-sync share of ici bytes


def _freq_scale(v, v_nom):
    return torch.clamp(v / v_nom, min=0.4)


def _nominals(spec: ChipSpec, variation: dict | None):
    """(v_core_nom, v_hbm_nom, v_io_nom, leak_scale) — spec scalars, or the
    per-chip tensors of a FleetSpec variation."""
    if variation is None:
        return (_f32(spec.nominal_v_core), _f32(spec.nominal_v_hbm),
                _f32(spec.nominal_v_io), 1.0)
    return (variation["v_core_nom"], variation["v_hbm_nom"],
            variation["v_io_nom"], variation["leak_scale"])


def _over(numerator: float, denom: torch.Tensor) -> torch.Tensor:
    """f32(numerator) / denom as one true f32 division."""
    return torch.full_like(denom, _f32(numerator)) / denom


def step_terms(profile: StepProfile, state: PowerPlaneState,
               spec: ChipSpec = V5E, k_fraction: float = 0.25,
               variation: dict | None = None):
    """Three roofline terms (seconds) under the current rail state."""
    v_core_nom, v_hbm_nom, v_io_nom, _ = _nominals(spec, variation)
    f_core = _freq_scale(state.v_core, v_core_nom)
    f_hbm = _freq_scale(state.v_hbm, v_hbm_nom)
    f_io = _freq_scale(state.v_io, v_io_nom)

    # compression rescales only the gradient-sync share of ICI traffic
    lossless = ecollectives.wire_cost(
        ecollectives.LEVEL_LOSSLESS).bytes_per_element
    r_int8 = _f32(ecollectives.wire_cost(
        ecollectives.LEVEL_INT8).bytes_per_element / lossless)
    r_topk = _f32(ecollectives.wire_cost(
        ecollectives.LEVEL_INT8_TOPK, k_fraction).bytes_per_element
        / lossless)
    # the reference's f32 table [1, r_int8, r_topk] indexed by the clipped
    # level, as selects (no host-to-device copy of a table per step)
    lvl = torch.clamp(state.comp_level, 0, 2)
    ratio = torch.where(lvl == 0, 1.0, torch.where(
        lvl == 1, torch.full(lvl.shape, r_int8, dtype=torch.float32,
                             device=state.device), r_topk))
    grad_b = np.float32(profile.grad_bytes_per_chip)
    other_b = np.float32(profile.ici_bytes_per_chip) - grad_b
    ici_bytes = float(other_b) + float(grad_b) * ratio

    t_comp = _over(profile.flops_per_chip, spec.peak_bf16_flops * f_core)
    t_mem = _over(profile.hbm_bytes_per_chip, spec.hbm_bandwidth * f_hbm)
    t_coll = ici_bytes / (spec.ici_link_bandwidth * spec.ici_links_per_chip
                          * f_io)
    return t_comp, t_mem, t_coll


def step_time_s(profile: StepProfile, state: PowerPlaneState,
                spec: ChipSpec = V5E, overlap: float = 1.0,
                variation: dict | None = None) -> torch.Tensor:
    """Step wall time: max of the three terms under perfect overlap
    (overlap=1.0), or their weighted blend toward the sum when overlap<1."""
    t_comp, t_mem, t_coll = step_terms(profile, state, spec,
                                       variation=variation)
    t_max = torch.maximum(t_comp, torch.maximum(t_mem, t_coll))
    t_sum = t_comp + t_mem + t_coll
    return overlap * t_max + (1.0 - overlap) * t_sum


def chip_power_w(state: PowerPlaneState, util_mxu, util_hbm, util_ici,
                 spec: ChipSpec = V5E,
                 variation: dict | None = None) -> torch.Tensor:
    """Rail-resolved chip power (the reference's `chip_power_w_jnp`)."""
    v_core_nom, v_hbm_nom, v_io_nom, leak = _nominals(spec, variation)
    sv_core = state.v_core / v_core_nom
    sv_hbm = state.v_hbm / v_hbm_nom
    sv_io = state.v_io / v_io_nom
    p_core = (spec.p_core_dynamic_w * util_mxu * sv_core ** 3
              + spec.p_core_static_w * leak * sv_core ** 2)
    p_hbm = spec.p_hbm_w * (0.3 + 0.7 * util_hbm) * sv_hbm ** 2
    p_ici = spec.p_ici_w * (0.15 + 0.85 * util_ici) * sv_io ** 2
    return p_core + p_hbm + p_ici + spec.p_other_w


def account_step(profile: StepProfile, state: PowerPlaneState,
                 spec: ChipSpec = V5E, overlap: float = 1.0,
                 variation: dict | None = None
                 ) -> tuple[PowerPlaneState, dict[str, torch.Tensor]]:
    """Advance the energy accumulator by one step; returns (state',
    metrics). `variation` carries per-chip nominal voltages and leakage
    (`fleet_variation`) when accounting a FleetSpec fleet."""
    t_comp, t_mem, t_coll = step_terms(profile, state, spec,
                                       variation=variation)
    t_step = step_time_s(profile, state, spec, overlap, variation=variation)
    util_mxu = t_comp / t_step
    util_hbm = t_mem / t_step
    util_ici = t_coll / t_step
    p = chip_power_w(state, util_mxu, util_hbm, util_ici, spec,
                     variation=variation)
    e = p * t_step
    new = dataclasses.replace(state, energy_j=state.energy_j + e,
                              step=state.step + 1)
    metrics = {
        "t_step_s": t_step, "t_comp_s": t_comp, "t_mem_s": t_mem,
        "t_coll_s": t_coll, "power_w": p, "energy_step_j": e,
        "util_mxu": util_mxu, "util_hbm": util_hbm, "util_ici": util_ici,
    }
    return new, metrics


def fleet_variation(fleet: FleetSpec, device) -> dict[str, torch.Tensor]:
    """`FleetSpec.variation()` as f32 tensors on `device`."""
    return {k: as_f32(v, device) for k, v in fleet.variation().items()}


def account_step_fleet(profile: StepProfile, state: PowerPlaneState,
                       spec: "ChipSpec | FleetSpec" = V5E,
                       overlap: float = 1.0):
    """`account_step` over a `[n_chips]` state; with a `FleetSpec` each chip
    is accounted at its own process-varied nominals."""
    if isinstance(spec, FleetSpec):
        if spec.n_chips != state.n_chips:
            raise ValueError(f"FleetSpec has {spec.n_chips} chips but the "
                             f"state has {state.n_chips}")
        return account_step(profile, state, spec.base, overlap,
                            variation=fleet_variation(spec, state.device))
    return account_step(profile, state, spec, overlap)


def account_and_observe(profile: StepProfile, state: PowerPlaneState,
                        spec: ChipSpec = V5E, overlap: float = 1.0,
                        variation: dict | None = None):
    """`account_step` plus the typed EXACT observation: returns (state',
    frame, metrics)."""
    from repro_torch.core.telemetry import TelemetryFrame
    new, metrics = account_step(profile, state, spec, overlap,
                                variation=variation)
    nominals = None
    if variation is not None:
        nominals = {"v_nom_core": variation["v_core_nom"],
                    "v_nom_hbm": variation["v_hbm_nom"],
                    "v_nom_io": variation["v_io_nom"]}
    frame = TelemetryFrame.from_account(new, metrics, nominals=nominals)
    return new, frame, metrics


def account_fleet_and_observe(profile: StepProfile, state: PowerPlaneState,
                              spec: "ChipSpec | FleetSpec" = V5E,
                              overlap: float = 1.0):
    """`account_step_fleet` returning (state', frame, metrics): the EXACT
    `[n_chips]` observation, anchored to each chip's process-varied nominal
    voltages when `spec` is a `FleetSpec`."""
    from repro_torch.core.telemetry import TelemetryFrame
    new, metrics = account_step_fleet(profile, state, spec, overlap)
    nominals = None
    if isinstance(spec, FleetSpec):
        dev = state.device
        nominals = {"v_nom_core": as_f32(spec.v_core_nominal, dev),
                    "v_nom_hbm": as_f32(spec.v_hbm_nominal, dev),
                    "v_nom_io": as_f32(spec.v_io_nominal, dev)}
    frame = TelemetryFrame.from_account(new, metrics, nominals=nominals)
    return new, frame, metrics
