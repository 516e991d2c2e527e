"""Rail maps: lane -> (PMBus address, PAGE) (paper Table II) plus the TPU
logical-rail map used by the adaptation layer (DESIGN.md §2.2). Copied from
`repro/core/rails.py`.

The lane number is a VolTune-specific identifier, not part of the PMBus
standard (paper §IV-C). Porting to another platform only requires providing
this mapping (paper §VII-D) — which is exactly what `TPU_V5E_RAILS` does for
the simulated TPU power plane.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Rail:
    lane: int
    name: str
    pmbus_address: int
    page: int
    nominal_v: float
    # Safe runtime envelope (paper §VII-B: per-rail safety envelopes are
    # platform-specific and enforced by the policy layer, not the mechanism).
    v_min: float
    v_max: float


# Paper Table II, with nominal voltages from the KC705 user guide (UG810).
KC705_RAILS: tuple[Rail, ...] = (
    Rail(0, "VCCINT", 52, 0, 1.00, 0.50, 1.10),
    Rail(1, "VCCAUX", 52, 1, 1.80, 1.50, 1.98),
    Rail(2, "VCC3V3", 52, 2, 3.30, 3.00, 3.60),
    Rail(3, "VADJ", 52, 3, 2.50, 1.80, 3.30),
    Rail(4, "VCC2V5", 53, 0, 2.50, 2.20, 2.75),
    Rail(5, "VCC1V5", 53, 1, 1.50, 1.30, 1.65),
    Rail(6, "MGTAVCC", 53, 2, 1.00, 0.50, 1.10),
    Rail(7, "MGTAVTT", 53, 3, 1.20, 1.00, 1.32),
    Rail(8, "VCCAUX_IO", 54, 0, 1.80, 1.60, 1.98),
    Rail(9, "VCCBRAM", 54, 1, 1.00, 0.70, 1.10),
    Rail(10, "MGTVCCAUX", 54, 2, 1.80, 1.60, 1.98),
)


# TPU v5e logical rails (DESIGN.md §2.2). One UCD9248-like simulated regulator
# device per chip; lanes follow the same lane->(address,page) discipline so the
# whole PowerManager/PMBus stack is reused unchanged.
TPU_V5E_RAILS: tuple[Rail, ...] = (
    Rail(0, "VDD_CORE", 96, 0, 0.90, 0.60, 0.99),   # MXU/VPU/scalar core
    Rail(1, "VDD_HBM", 96, 1, 1.10, 0.90, 1.21),    # HBM2e interface + stacks
    Rail(2, "VDD_IO", 96, 2, 0.95, 0.65, 1.05),     # ICI SerDes (the MGTAVCC analogue)
)


class RailMap:
    """Lane-indexed rail lookup used by the PowerManager conversion path
    (paper §IV-D step 1: resolve lane -> (address, PAGE))."""

    def __init__(self, rails: tuple[Rail, ...]):
        self._by_lane = {r.lane: r for r in rails}
        self._by_name = {r.name: r for r in rails}
        if len(self._by_lane) != len(rails):
            raise ValueError("duplicate lane numbers in rail map")

    def by_lane(self, lane: int) -> Rail:
        try:
            return self._by_lane[lane]
        except KeyError:
            raise KeyError(f"unknown lane {lane}; known: {sorted(self._by_lane)}") from None

    def by_name(self, name: str) -> Rail:
        try:
            return self._by_name[name]
        except KeyError:
            raise KeyError(f"unknown rail {name!r}; known: {sorted(self._by_name)}") from None

    def lanes(self) -> list[int]:
        return sorted(self._by_lane)

    def devices(self) -> list[int]:
        """Distinct PMBus device addresses in this map."""
        return sorted({r.pmbus_address for r in self._by_lane.values()})

    def pages_for_device(self, address: int) -> dict[int, Rail]:
        return {r.page: r for r in self._by_lane.values() if r.pmbus_address == address}

    def __iter__(self):
        return iter(sorted(self._by_lane.values(), key=lambda r: r.lane))

    def __len__(self) -> int:
        return len(self._by_lane)


KC705_RAIL_MAP = RailMap(KC705_RAILS)
TPU_V5E_RAIL_MAP = RailMap(TPU_V5E_RAILS)
