"""Controller overhead accounting (paper §V-F, Tables VII-IX).

Two halves:

1. The paper's measured Vivado numbers for the KC705 prototype, kept as
   structured reference data. The benchmarks regenerate the paper's headline
   ratios from these (SW/HW BRAM 31.96x, static power 5.60x, HW total ~2% of
   the subsystem static budget) and the tests pin them.

2. The analogous accounting for *this* system's controller: the in-graph
   (HW-path analogue) controller adds FLOPs/bytes to the compiled step and
   the host (SW-path analogue) controller adds host milliseconds between
   steps. `controller_budget_fraction` asserts the paper's design goal —
   the control plane must stay a <2% add-on to the application budget.

Copied from `repro/core/overhead.py` (plain Python).
"""

from __future__ import annotations

import dataclasses

# Device totals on the KC705 (XC7K325T), from the Table VII/VIII headers.
KC705_TOTALS = {
    "slice_luts": 203_800,
    "slice_regs": 407_600,
    "slices": 50_950,
    "lut_logic": 203_800,
    "lut_mem": 64_000,
    "bram_tiles": 445,
    "dsps": 840,
}

# Table VII: hardware-based implementation (percent of device totals).
HW_UTILIZATION_PCT = {
    "counter": {"slice_luts": 0.01, "slice_regs": 0.02, "slices": 0.03,
                "lut_logic": 0.01, "lut_mem": 0.00, "bram_tiles": 0.00, "dsps": 0.00},
    "power_manager": {"slice_luts": 0.31, "slice_regs": 0.46, "slices": 1.19,
                      "lut_logic": 0.31, "lut_mem": 0.02, "bram_tiles": 0.00, "dsps": 0.24},
    "pmbus": {"slice_luts": 0.12, "slice_regs": 0.03, "slices": 0.15,
              "lut_logic": 0.12, "lut_mem": 0.00, "bram_tiles": 0.00, "dsps": 0.00},
    "total": {"slice_luts": 1.45, "slice_regs": 1.30, "slices": 3.48,
              "lut_logic": 1.22, "lut_mem": 0.72, "bram_tiles": 1.80, "dsps": 0.24},
}

# Table VIII: software-based implementation (percent of device totals).
SW_UTILIZATION_PCT = {
    "axi_gpio": {"slice_luts": 0.03, "slice_regs": 0.02, "slices": 0.05, "bram_tiles": 0.00, "dsps": 0.00},
    "axi_timer": {"slice_luts": 0.10, "slice_regs": 0.04, "slices": 0.16, "bram_tiles": 0.00, "dsps": 0.00},
    "axi_uartlite": {"slice_luts": 0.05, "slice_regs": 0.03, "slices": 0.09, "bram_tiles": 0.00, "dsps": 0.00},
    "axis_dwidth_converter": {"slice_luts": 0.01, "slice_regs": 0.06, "slices": 0.11, "bram_tiles": 0.00, "dsps": 0.00},
    "mdm_1": {"slice_luts": 0.05, "slice_regs": 0.03, "slices": 0.08, "bram_tiles": 0.00, "dsps": 0.00},
    "microblaze": {"slice_luts": 0.76, "slice_regs": 0.31, "slices": 1.12, "bram_tiles": 0.00, "dsps": 0.36},
    "microblaze_local_memory": {"slice_luts": 0.36, "slice_regs": 0.32, "slices": 0.98, "bram_tiles": 57.53, "dsps": 0.00},
    "pmbus_io": {"slice_luts": 0.00, "slice_regs": 0.00, "slices": 0.00, "bram_tiles": 0.00, "dsps": 0.00},
    "smartconnect": {"slice_luts": 0.19, "slice_regs": 0.09, "slices": 0.36, "bram_tiles": 0.00, "dsps": 0.00},
    "util_vector_logic": {"slice_luts": 0.01, "slice_regs": 0.00, "slices": 0.01, "bram_tiles": 0.00, "dsps": 0.00},
    "total": {"slice_luts": 1.53, "slice_regs": 0.90, "slices": 2.81,
              "lut_logic": 1.34, "lut_mem": 0.62, "bram_tiles": 57.52, "dsps": 0.36},
}

# Table IX: static power breakdown (watts).
HW_STATIC_POWER_W = {"power_manager": 0.011, "pmbus": 0.003, "counter": 0.001}
SW_STATIC_POWER_W = {
    "microblaze": 0.052, "microblaze_local_memory": 0.023, "smartconnect": 0.003,
    "axi_timer": 0.002, "axis_dwidth_converter": 0.001, "axi_uartlite": 0.001,
    "mdm_1": 0.001, "axi_gpio": 0.001,
}

HW_STATIC_TOTAL_W = round(sum(HW_STATIC_POWER_W.values()), 4)   # 0.015 W (2% share)
SW_STATIC_TOTAL_W = round(sum(SW_STATIC_POWER_W.values()), 4)   # 0.084 W (9% share)
HW_STATIC_SHARE = 0.02
SW_STATIC_SHARE = 0.09


def static_power_ratio() -> float:
    """Paper §V-F: SW path increases static power 5.60x."""
    return SW_STATIC_TOTAL_W / HW_STATIC_TOTAL_W


def bram_ratio() -> float:
    """Paper §V-F: SW path trades a 31.96x BRAM increase for programmability."""
    return SW_UTILIZATION_PCT["total"]["bram_tiles"] / HW_UTILIZATION_PCT["total"]["bram_tiles"]


# ---------------------------------------------------------------------------
# This system's controller overhead (the TPU-adaptation analogue)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ControllerOverheadReport:
    """Overhead of the power-control plane relative to the training step —
    the analogue of 'percent of the KC705 device' for our deployment."""
    path: str                      # 'in_graph' (HW analogue) | 'host' (SW analogue)
    controller_flops_per_step: float
    model_flops_per_step: float
    controller_bytes_per_step: float
    model_bytes_per_step: float
    host_seconds_per_step: float
    step_seconds: float

    @property
    def flops_fraction(self) -> float:
        return self.controller_flops_per_step / max(self.model_flops_per_step, 1.0)

    @property
    def bytes_fraction(self) -> float:
        return self.controller_bytes_per_step / max(self.model_bytes_per_step, 1.0)

    @property
    def time_fraction(self) -> float:
        return self.host_seconds_per_step / max(self.step_seconds, 1e-12)

    def within_budget(self, budget: float = 0.02) -> bool:
        """The paper's integration-cost goal: control plane <2% of budget."""
        return (self.flops_fraction <= budget and self.bytes_fraction <= budget
                and self.time_fraction <= budget)
