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
    def fleet(n_chips: int, spec: "ChipSpec | FleetSpec" = V5E,
              device="cuda") -> "PowerPlaneState":
        """State of an `n_chips` fleet: with a plain `ChipSpec` every chip
        starts at the shared nominal point, with a `FleetSpec` at its own
        process-varied nominals."""
        if isinstance(spec, FleetSpec):
            if spec.n_chips != n_chips:
                raise ValueError(f"FleetSpec has {spec.n_chips} chips, "
                                 f"asked for {n_chips}")
            return PowerPlaneState.from_fleet(spec, device)
        # ones * nominal, as the reference spells it (an f32 multiply)
        ones = torch.ones(n_chips, dtype=torch.float32, device=device)
        return PowerPlaneState(
            v_core=ones * spec.nominal_v_core,
            v_hbm=ones * spec.nominal_v_hbm,
            v_io=ones * spec.nominal_v_io,
            comp_level=torch.full((n_chips,), ecollectives.LEVEL_LOSSLESS,
                                  dtype=torch.int32, device=device),
            energy_j=torch.zeros(n_chips, dtype=torch.float32,
                                 device=device),
            step=torch.zeros(n_chips, dtype=torch.int32, device=device))

    @staticmethod
    def from_fleet(fleet: FleetSpec, device="cuda") -> "PowerPlaneState":
        """Fleet state with every chip at its own per-chip nominal point.
        The rails are copies of the FleetSpec's arrays (a CPU tensor made
        from a numpy array would share its memory, and a restore writes
        the plane in place)."""
        n = fleet.n_chips
        f32 = lambda a: torch.tensor(a, dtype=torch.float32, device=device)
        return PowerPlaneState(
            v_core=f32(fleet.v_core_nominal),
            v_hbm=f32(fleet.v_hbm_nominal),
            v_io=f32(fleet.v_io_nominal),
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

    def chip(self, i: int) -> "PowerPlaneState":
        """Scalar view of chip `i` of a fleet state."""
        if not self.is_fleet:
            if i != 0:
                raise IndexError("scalar state has exactly one chip")
            return self
        return PowerPlaneState(**{f.name: getattr(self, f.name)[i]
                                  for f in dataclasses.fields(self)})


@dataclasses.dataclass(frozen=True)
class StepProfile:
    """Static per-(arch, shape, mesh) roofline terms of one step."""
    flops_per_chip: float
    hbm_bytes_per_chip: float
    ici_bytes_per_chip: float      # at lossless compression
    grad_bytes_per_chip: float = 0.0  # gradient-sync share of ici bytes


def _freq_scale(v, v_nom):
    return torch.clamp(v / v_nom, min=0.4)


def _nominals(spec: ChipSpec, variation: dict | None, device):
    """(v_core_nom, v_hbm_nom, v_io_nom, leak_scale) — the spec's nominals
    as f32 scalars on `device`, or the per-chip tensors of a FleetSpec
    variation. The scalars are device tensors, not Python numbers: the
    card divides a tensor by a Python number as a multiply by its f32
    reciprocal, which parts from the CPU's (and the reference's) true
    division in the last bit."""
    if variation is None:
        return (as_f32(_f32(spec.nominal_v_core), device),
                as_f32(_f32(spec.nominal_v_hbm), device),
                as_f32(_f32(spec.nominal_v_io), device), 1.0)
    return (variation["v_core_nom"], variation["v_hbm_nom"],
            variation["v_io_nom"], variation["leak_scale"])


def _over(numerator: float, denom: torch.Tensor) -> torch.Tensor:
    """f32(numerator) / denom as one true f32 division."""
    return torch.full_like(denom, _f32(numerator)) / denom


def step_terms(profile: StepProfile, state: PowerPlaneState,
               spec: ChipSpec = V5E, k_fraction: float = 0.25,
               variation: dict | None = None):
    """Three roofline terms (seconds) under the current rail state."""
    v_core_nom, v_hbm_nom, v_io_nom, _ = _nominals(spec, variation,
                                                   state.device)
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


@dataclasses.dataclass(frozen=True)
class BatchShares:
    """How much of each roofline term a continuous-batching decode batch
    shares across its resident lanes (1.0: one copy of the work serves
    every lane; 0.0: the term scales linearly with the batch). Decode FLOPs
    are per token; the HBM term is mostly the weights read, amortized over
    every lane; collectives carry mostly weight-sharded traffic with a
    per-lane activation tail."""
    flops: float = 0.0
    hbm: float = 0.9
    ici: float = 0.7


def batched_lane_time_s(t_comp, t_mem, t_coll, lanes,
                        shares: BatchShares = BatchShares(),
                        overlap: float = 1.0) -> torch.Tensor:
    """Per-lane step time of a `lanes`-deep continuous decode batch from
    the single-lane roofline terms: each term grows by its unshared
    fraction per extra lane,

        t_term' = t_term * (1 + (1 - share_term) * (b - 1)),  b = max(lanes, 1)

    and the terms recombine as in `step_time_s`. At b == 1 every scale
    factor is exactly 1.0f, so the result is bitwise `step_time_s` on the
    same terms (the serve engine's batch_cap=1 oracle): the f32 arithmetic
    is spelled in the reference's order."""
    b = torch.clamp(as_f32(lanes, t_comp.device), min=1.0)
    extra = b - 1.0
    tc = t_comp * (1.0 + _f32(1.0 - shares.flops) * extra)
    tm = t_mem * (1.0 + _f32(1.0 - shares.hbm) * extra)
    tl = t_coll * (1.0 + _f32(1.0 - shares.ici) * extra)
    t_max = torch.maximum(tc, torch.maximum(tm, tl))
    t_sum = tc + tm + tl
    return overlap * t_max + (1.0 - overlap) * t_sum


def chip_power_w(state: PowerPlaneState, util_mxu, util_hbm, util_ici,
                 spec: ChipSpec = V5E,
                 variation: dict | None = None) -> torch.Tensor:
    """Rail-resolved chip power. The reference spells it
    `chip_power_w_jnp` (`repro/core/power_plane.py`); this is the same
    function under the port's name."""
    v_core_nom, v_hbm_nom, v_io_nom, leak = _nominals(spec, variation,
                                                      state.device)
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


def fleet_nominals(variation: dict) -> dict[str, torch.Tensor]:
    """The frame's per-chip nominal anchors, from a `fleet_variation`."""
    return {"v_nom_core": variation["v_core_nom"],
            "v_nom_hbm": variation["v_hbm_nom"],
            "v_nom_io": variation["v_io_nom"]}


def account_step_fleet(profile: StepProfile, state: PowerPlaneState,
                       spec: "ChipSpec | FleetSpec" = V5E,
                       overlap: float = 1.0,
                       variation: dict | None = None):
    """`account_step` over a `[n_chips]` state; with a `FleetSpec` each chip
    is accounted at its own process-varied nominals. `variation` may carry
    `fleet_variation(spec, device)` built once by the caller (a loop that
    accounts every tick): the FleetSpec's arrays are then not copied to the
    device again. The results are the same either way."""
    if isinstance(spec, FleetSpec):
        if spec.n_chips != state.n_chips:
            raise ValueError(f"FleetSpec has {spec.n_chips} chips but the "
                             f"state has {state.n_chips}")
        if variation is None:
            variation = fleet_variation(spec, state.device)
        return account_step(profile, state, spec.base, overlap,
                            variation=variation)
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
                              overlap: float = 1.0,
                              variation: dict | None = None):
    """`account_step_fleet` returning (state', frame, metrics): the EXACT
    `[n_chips]` observation, anchored to each chip's process-varied nominal
    voltages when `spec` is a `FleetSpec`. A prebuilt `variation` (see
    `account_step_fleet`) also supplies those anchors, so a call makes no
    host-to-device copy."""
    from repro_torch.core.telemetry import TelemetryFrame
    nominals = None
    if isinstance(spec, FleetSpec):
        if variation is None:
            variation = fleet_variation(spec, state.device)
        nominals = fleet_nominals(variation)
    new, metrics = account_step_fleet(profile, state, spec, overlap,
                                      variation=variation)
    frame = TelemetryFrame.from_account(new, metrics, nominals=nominals)
    return new, frame, metrics


def fleet_summary(state: PowerPlaneState) -> dict[str, torch.Tensor]:
    """Fleet-level reductions of a batched state (worst/best chip and
    totals), as device tensors."""
    if not state.is_fleet:
        raise ValueError("fleet_summary needs a batched ([n_chips]) state")
    return {
        "v_core_min": state.v_core.min(), "v_core_max": state.v_core.max(),
        "v_io_min": state.v_io.min(), "v_io_max": state.v_io.max(),
        "energy_total_j": state.energy_j.sum(),
        "comp_level_min": state.comp_level.min(),
    }
