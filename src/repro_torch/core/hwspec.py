"""Target hardware constants of the simulated fleet (TPU v5e) shared by the
energy model, copied from `repro/core/hwspec.py` (numpy only, so
`FleetSpec.sample` draws exactly the reference's arrays). These describe the
modelled chips whose rails the control plane drives, not the card the port
runs on.

Roofline constants are the ones mandated for this reproduction:
197 TFLOP/s bf16 per chip, 819 GB/s HBM, ~50 GB/s per ICI link.

Chip power constants are stated assumptions (vendor does not publish a rail
breakdown); they only set the *scale* of the energy numbers — all paper-
validation claims are expressed as ratios, which are insensitive to them.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    name: str = "tpu-v5e"
    peak_bf16_flops: float = 197e12        # FLOP/s per chip
    hbm_bandwidth: float = 819e9           # bytes/s per chip
    ici_link_bandwidth: float = 50e9       # bytes/s per link (per direction)
    ici_links_per_chip: int = 4            # 2-D torus on a 16x16 pod
    hbm_bytes: float = 16e9                # 16 GB HBM per chip
    vmem_bytes: float = 128 * 2**20        # ~128 MiB VMEM

    # --- power model assumptions (documented in DESIGN.md) -----------------
    nominal_v_core: float = 0.90
    nominal_v_hbm: float = 1.10
    nominal_v_io: float = 0.95
    p_core_dynamic_w: float = 90.0   # at 100% MXU utilization, nominal V/f
    p_core_static_w: float = 25.0
    p_hbm_w: float = 30.0            # at 100% bandwidth utilization
    p_ici_w: float = 15.0            # at 100% link utilization (all links)
    p_other_w: float = 10.0          # fans/host share/uncore, not scalable

    def idle_power_w(self) -> float:
        return self.p_core_static_w + self.p_other_w


V5E = ChipSpec()


# ---------------------------------------------------------------------------
# Fleet-scale process variation
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FleetSpec:
    """Per-chip process variation over an `n_chips` fleet.

    The VolTune case study shows each board has its own safe operating
    region, so fleet-level control must track per-chip margins, not fleet
    means. A `FleetSpec` is the vectorized `ChipSpec`: `[n_chips]` arrays of
    per-chip nominal rail voltages (a weak chip *needs* more voltage for the
    same frequency), leakage spread (static power multiplier), and a
    BER-curve offset (how fast the measured link/gradient error grows as the
    chip digs below its own nominal — the worst chip's curve is the one that
    gates a worst-chip-bounded fleet policy).

    Sampling is seeded and reproducible: the same (n_chips, seed, sigmas)
    always yields the same fleet, so fleet experiments are replayable and
    checkpoint/restart sees an identical fleet.
    """
    base: ChipSpec
    seed: int
    v_core_nominal: np.ndarray      # f32 [n_chips]
    v_hbm_nominal: np.ndarray       # f32 [n_chips]
    v_io_nominal: np.ndarray        # f32 [n_chips]
    leakage_scale: np.ndarray       # f32 [n_chips] — multiplies static power
    error_sensitivity: np.ndarray   # f32 [n_chips] — BER-curve offset (>=0)

    @property
    def n_chips(self) -> int:
        return int(self.v_core_nominal.shape[0])

    @staticmethod
    def sample(
        n_chips: int,
        seed: int = 0,
        spec: ChipSpec = V5E,
        *,
        sigma_v: float = 0.01,         # relative σ of per-chip nominal voltage
        sigma_leakage: float = 0.08,   # σ of log leakage multiplier
        error_spread: float = 1.2,     # worst chip ≈ (1 + spread)× the best
    ) -> "FleetSpec":
        """Draw a reproducible fleet. Voltage spread is truncated at ±3σ so
        every chip's nominal stays inside the platform rail envelope."""
        if n_chips < 1:
            raise ValueError(f"n_chips must be >= 1, got {n_chips}")
        rng = np.random.default_rng(seed)

        def nominal(v_nom: float) -> np.ndarray:
            z = np.clip(rng.standard_normal(n_chips), -3.0, 3.0)
            return (v_nom * (1.0 + sigma_v * z)).astype(np.float32)

        leak = np.exp(sigma_leakage * np.clip(
            rng.standard_normal(n_chips), -3.0, 3.0)).astype(np.float32)
        sens = (1.0 + error_spread * rng.uniform(size=n_chips)).astype(np.float32)
        return FleetSpec(
            base=spec, seed=seed,
            v_core_nominal=nominal(spec.nominal_v_core),
            v_hbm_nominal=nominal(spec.nominal_v_hbm),
            v_io_nominal=nominal(spec.nominal_v_io),
            leakage_scale=leak,
            error_sensitivity=sens,
        )

    @staticmethod
    def uniform(n_chips: int, spec: ChipSpec = V5E) -> "FleetSpec":
        """Zero-spread fleet: every chip exactly at the base spec. At
        n_chips=1 this makes the fleet code paths numerically equivalent to
        the scalar ones (pinned by tests)."""
        ones = np.ones((n_chips,), np.float32)
        return FleetSpec(
            base=spec, seed=0,
            v_core_nominal=ones * np.float32(spec.nominal_v_core),
            v_hbm_nominal=ones * np.float32(spec.nominal_v_hbm),
            v_io_nominal=ones * np.float32(spec.nominal_v_io),
            leakage_scale=ones.copy(),
            error_sensitivity=ones.copy(),
        )

    def chip(self, i: int) -> ChipSpec:
        """Scalar `ChipSpec` view of chip `i` (host-side consumers)."""
        return dataclasses.replace(
            self.base,
            nominal_v_core=float(self.v_core_nominal[i]),
            nominal_v_hbm=float(self.v_hbm_nominal[i]),
            nominal_v_io=float(self.v_io_nominal[i]),
            p_core_static_w=float(self.base.p_core_static_w
                                  * self.leakage_scale[i]),
        )

    def variation(self) -> dict[str, np.ndarray]:
        """The `[n_chips]` arrays consumed (via vmap) by the power-plane
        accounting — see power_plane.account_step's `variation` argument."""
        return {
            "v_core_nom": self.v_core_nominal,
            "v_hbm_nom": self.v_hbm_nominal,
            "v_io_nom": self.v_io_nominal,
            "leak_scale": self.leakage_scale,
        }


def core_frequency_scale(v_core: float, spec: ChipSpec = V5E) -> float:
    """Linear DVFS approximation: f ∝ v (clamped at 40% floor)."""
    return max(0.4, v_core / spec.nominal_v_core)


def chip_power_w(
    *,
    v_core: float,
    v_hbm: float,
    v_io: float,
    mxu_utilization: float,
    hbm_utilization: float,
    ici_utilization: float,
    spec: ChipSpec = V5E,
) -> float:
    """Rail-resolved chip power.

    Dynamic power ∝ v^2 * f with f ∝ v (=> v^3); static ∝ v^2 (leakage is
    super-linear in v; quadratic is the standard compact model). Utilizations
    come from the compiled-step roofline terms.
    """
    sv_core = v_core / spec.nominal_v_core
    sv_hbm = v_hbm / spec.nominal_v_hbm
    sv_io = v_io / spec.nominal_v_io
    p_core = (spec.p_core_dynamic_w * mxu_utilization * sv_core**3
              + spec.p_core_static_w * sv_core**2)
    p_hbm = spec.p_hbm_w * (0.3 + 0.7 * hbm_utilization) * sv_hbm**2
    p_ici = spec.p_ici_w * (0.15 + 0.85 * ici_utilization) * sv_io**2
    return p_core + p_hbm + p_ici + spec.p_other_w
