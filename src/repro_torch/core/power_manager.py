"""The VolTune PowerManager subsystem (paper §III, §IV-D, Table III).
Copied from `repro/core/power_manager.py`.

Accepts structured requests — (VolTune opcode, target lane, value) — and
converts them into PMBus command sequences per the three-step conversion path
of §IV-D:

  1. resolve lane -> (PMBus device address, PAGE) via the rail map,
  2. select the transaction primitive (Write Word for programming,
     Read Word for readback),
  3. pack the PMBus command byte + LINEAR16 payload into the request stream.

Two control paths are modelled, with per-(path, clock) controller overheads
calibrated so the telemetry measurement interval reproduces paper Table VI
exactly (HW: 0.2/0.6 ms, SW: 0.8/1.0 ms at 400/100 kHz), and so that a full
HW-path/400 kHz voltage-update sequence + regulator settling for a
1.0 V -> 0.5 V step completes end-to-end in 2.3 ms (paper Fig 7a).

Opcode map (paper Table III):
  0x0 CLEAR_STATUS         controller-internal reset, no PMBus transaction
  0x1 SET_UNDER_VOLTAGE    PAGE (on lane change) + VOUT_UV_WARN + VOUT_UV_FAULT
  0x2 SET_POWER_GOOD_ON    POWER_GOOD_ON
  0x3 SET_POWER_GOOD_OFF   POWER_GOOD_OFF
  0x4 SET_VOLTAGE          VOUT_COMMAND
  0x5 GET_VOLTAGE          READ_VOUT
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Callable

import numpy as np

from repro_torch.core import codecs
from repro_torch.core.pmbus import (
    Cmd, Completion, PmBus, Primitive, SimClock, Transaction, build_board,
    transaction_seconds,
)
from repro_torch.core.rails import KC705_RAIL_MAP, RailMap


class Opcode(enum.IntEnum):
    CLEAR_STATUS = 0x0
    SET_UNDER_VOLTAGE = 0x1
    SET_POWER_GOOD_ON = 0x2
    SET_POWER_GOOD_OFF = 0x3
    SET_VOLTAGE = 0x4
    GET_VOLTAGE = 0x5


class ControlPath(str, enum.Enum):
    HARDWARE = "hw"   # RTL FSM: deterministic, low-latency (paper §III-B)
    SOFTWARE = "sw"   # MicroBlaze: flexible, higher per-transaction cost (§III-C)


# Controller-side time added around each PMBus wire transaction, calibrated to
# paper Table VI / Fig 7 (see module docstring). "write gap" models FSM /
# software sequencing between write transactions; "read overhead" additionally
# covers ADC sample scheduling + result handling for telemetry reads.
_WRITE_GAP_S: dict[tuple[ControlPath, int], float] = {
    (ControlPath.HARDWARE, 400_000): 10e-6,
    (ControlPath.HARDWARE, 100_000): 15e-6,
    (ControlPath.SOFTWARE, 400_000): 310e-6,
    (ControlPath.SOFTWARE, 100_000): 330e-6,
}
_READ_OVERHEAD_S: dict[tuple[ControlPath, int], float] = {
    (ControlPath.HARDWARE, 400_000): 80e-6,
    (ControlPath.HARDWARE, 100_000): 120e-6,
    (ControlPath.SOFTWARE, 400_000): 680e-6,
    (ControlPath.SOFTWARE, 100_000): 520e-6,
}


@dataclasses.dataclass
class RequestResult:
    ok: bool
    opcode: Opcode
    lane: int
    value: float | None = None
    completions: tuple[Completion, ...] = ()
    t_issue: float = 0.0
    t_done: float = 0.0
    error: str | None = None

    @property
    def elapsed_s(self) -> float:
        return self.t_done - self.t_issue


@dataclasses.dataclass
class Thresholds:
    """Protection/monitoring limits programmed before VOUT_COMMAND in the
    prototype measurement workflow (paper §IV-E, Fig 5). Expressed as factors
    of the requested setpoint."""
    uv_warn: float = 0.90
    uv_fault: float = 0.85
    pg_on: float = 0.92
    pg_off: float = 0.88


class PowerManager:
    """FPGA-resident voltage-control subsystem (hardware or software path)."""

    def __init__(
        self,
        rail_map: RailMap = KC705_RAIL_MAP,
        *,
        path: ControlPath | str = ControlPath.HARDWARE,
        clock_hz: int = 400_000,
        loads: dict[str, Callable[[float, float], float]] | None = None,
        clock: SimClock | None = None,
        seed: int = 0,
    ):
        self.rail_map = rail_map
        self.path = ControlPath(path)
        self.clock_hz = clock_hz
        self.clock, self.bus, self.channels = build_board(
            rail_map, clock=clock, clock_hz=clock_hz, loads=loads, seed=seed)
        # PAGE cache per device address: PAGE is written only when the target
        # lane changes (paper §IV-C).
        self._page_cache: dict[int, int] = {}
        self.request_log: list[RequestResult] = []
        self.status_fault = False

    # -- controller timing ---------------------------------------------------
    def _write_gap(self) -> float:
        return _WRITE_GAP_S[(self.path, self.clock_hz)]

    def _read_overhead(self) -> float:
        return _READ_OVERHEAD_S[(self.path, self.clock_hz)]

    def measurement_interval_s(self) -> float:
        """Telemetry sampling interval for this (path, clock) configuration —
        reproduces paper Table VI."""
        return transaction_seconds(Primitive.READ_WORD, self.clock_hz) + self._read_overhead()

    # -- PMBus issue helpers ---------------------------------------------------
    def _issue(self, txn: Transaction, *, is_read: bool) -> Completion:
        comp = self.bus.execute(txn)
        self.clock.advance(self._read_overhead() if is_read else self._write_gap())
        return comp

    def _page_txn_if_needed(self, lane: int) -> list[Completion]:
        rail = self.rail_map.by_lane(lane)
        comps: list[Completion] = []
        if self._page_cache.get(rail.pmbus_address) != rail.page:
            comps.append(self._issue(Transaction(
                Primitive.WRITE_BYTE, rail.pmbus_address, Cmd.PAGE, (rail.page,)),
                is_read=False))
            if comps[-1].ok:
                self._page_cache[rail.pmbus_address] = rail.page
        return comps

    def _write_word(self, lane: int, cmd: Cmd, volts: float) -> Completion:
        rail = self.rail_map.by_lane(lane)
        payload = codecs.word_to_bytes_le(codecs.linear16_encode(volts))
        return self._issue(Transaction(Primitive.WRITE_WORD, rail.pmbus_address, cmd, payload),
                           is_read=False)

    def _read_word(self, lane: int, cmd: Cmd) -> Completion:
        rail = self.rail_map.by_lane(lane)
        return self._issue(Transaction(Primitive.READ_WORD, rail.pmbus_address, cmd),
                           is_read=True)

    # Opcodes whose conversion path consumes `value` (Table III); a missing
    # value must come back as a structured error, not a TypeError mid-sequence.
    _VALUE_REQUIRED = frozenset({
        Opcode.SET_UNDER_VOLTAGE, Opcode.SET_POWER_GOOD_ON,
        Opcode.SET_POWER_GOOD_OFF, Opcode.SET_VOLTAGE,
    })

    # -- the opcode interface (Table III) -------------------------------------
    def execute(self, opcode: Opcode | int, lane: int = 0,
                value: float | None = None) -> RequestResult:
        opcode = Opcode(opcode)
        t0 = self.clock.now
        comps: list[Completion] = []
        out_value: float | None = None
        err: str | None = None

        if opcode in self._VALUE_REQUIRED and value is None:
            self.status_fault = True
            res = RequestResult(False, opcode, lane, None, (), t0, t0,
                                f"opcode {opcode.name} requires a value")
            self.request_log.append(res)
            return res

        if opcode == Opcode.CLEAR_STATUS:
            # Controller-internal reset only — no PMBus transaction (Table III).
            self.status_fault = False
        elif opcode == Opcode.SET_UNDER_VOLTAGE:
            # Table III: one opcode expands to both UV limit registers
            # (warn at the requested threshold, fault slightly below it).
            comps += self._page_txn_if_needed(lane)
            comps.append(self._write_word(lane, Cmd.VOUT_UV_WARN_LIMIT, value))
            comps.append(self._write_word(lane, Cmd.VOUT_UV_FAULT_LIMIT, value * 0.95))
        elif opcode == Opcode.SET_POWER_GOOD_ON:
            comps += self._page_txn_if_needed(lane)
            comps.append(self._write_word(lane, Cmd.POWER_GOOD_ON, value))
        elif opcode == Opcode.SET_POWER_GOOD_OFF:
            comps += self._page_txn_if_needed(lane)
            comps.append(self._write_word(lane, Cmd.POWER_GOOD_OFF, value))
        elif opcode == Opcode.SET_VOLTAGE:
            comps += self._page_txn_if_needed(lane)
            comps.append(self._write_word(lane, Cmd.VOUT_COMMAND, value))
        elif opcode == Opcode.GET_VOLTAGE:
            comps += self._page_txn_if_needed(lane)
            comp = self._read_word(lane, Cmd.READ_VOUT)
            comps.append(comp)
            if comp.ok:
                out_value = codecs.linear16_decode(codecs.bytes_le_to_word(*comp.data))
        else:  # pragma: no cover
            err = f"unknown opcode {opcode}"

        ok = err is None and all(c.ok for c in comps)
        if not ok:
            self.status_fault = True
            err = err or "; ".join(c.error for c in comps if c.error)
        res = RequestResult(ok, opcode, lane, out_value, tuple(comps),
                            t0, self.clock.now, err)
        self.request_log.append(res)
        return res

    # -- composite workflows ---------------------------------------------------
    def set_voltage(self, lane: int, volts: float,
                    thresholds: Thresholds | None = None) -> RequestResult:
        """The full prototype voltage-update workflow (paper Fig 5 / §IV-E):
        threshold-register configuration, then the VOUT_COMMAND setpoint.
        Expands to PAGE + 4 Write Words + VOUT_COMMAND = 6 PMBus transactions
        when the lane changed, 5 otherwise."""
        rail = self.rail_map.by_lane(lane)
        # Mechanism-level envelope check; policy owns the smart limits. The
        # epsilon admits float32-rounded policy outputs sitting exactly on the
        # envelope edge (e.g. f32(0.65) < 0.65), which are then clamped in.
        eps = 1e-6
        if not (rail.v_min - eps <= volts <= rail.v_max + eps):
            return RequestResult(False, Opcode.SET_VOLTAGE, lane, volts,
                                 t_issue=self.clock.now, t_done=self.clock.now,
                                 error=f"{volts} V outside [{rail.v_min}, {rail.v_max}] "
                                       f"for {rail.name}")
        volts = min(max(volts, rail.v_min), rail.v_max)
        th = thresholds or Thresholds()
        t0 = self.clock.now
        r1 = self.execute(Opcode.SET_UNDER_VOLTAGE, lane, volts * th.uv_warn)
        r2 = self.execute(Opcode.SET_POWER_GOOD_ON, lane, volts * th.pg_on)
        r3 = self.execute(Opcode.SET_POWER_GOOD_OFF, lane, volts * th.pg_off)
        r4 = self.execute(Opcode.SET_VOLTAGE, lane, volts)
        ok = all(r.ok for r in (r1, r2, r3, r4))
        comps = r1.completions + r2.completions + r3.completions + r4.completions
        res = RequestResult(ok, Opcode.SET_VOLTAGE, lane, volts, comps,
                            t0, self.clock.now,
                            None if ok else "sequence failure")
        return res

    def get_voltage(self, lane: int) -> float:
        res = self.execute(Opcode.GET_VOLTAGE, lane)
        if not res.ok:
            raise RuntimeError(f"GET_VOLTAGE failed: {res.error}")
        return res.value

    def rail_voltage_now(self, lane: int) -> float:
        """Instantaneous true rail voltage (oscilloscope view, paper §V-E) —
        bypasses PMBus sampling; for validation only."""
        return self.channels[lane].voltage_at(self.clock.now)

    def sample_trace(self, lane: int, duration_s: float) -> tuple[np.ndarray, np.ndarray]:
        """Periodic READ_VOUT sampling for `duration_s` of simulated time.
        The achievable sample interval is set by the control path and PMBus
        clock (paper Table VI); returns (times_s, volts)."""
        t_stop = self.clock.now + duration_s
        ts, vs = [], []
        while self.clock.now < t_stop:
            res = self.execute(Opcode.GET_VOLTAGE, lane)
            if res.ok:
                ts.append(res.t_done)
                vs.append(res.value)
        return np.asarray(ts), np.asarray(vs)

    def measure_transition(self, lane: int, target_v: float,
                           duration_s: float = 6e-3) -> "TransitionTrace":
        """Issue a full voltage-update workflow, then sample the rail until
        `duration_s` after the request (the paper Fig 7 experiment). t=0 is
        the request issue time at the PowerManager interface."""
        t0 = self.clock.now
        v_from = self.rail_voltage_now(lane)
        res = self.set_voltage(lane, target_v)
        if not res.ok:
            raise RuntimeError(f"set_voltage failed: {res.error}")
        remaining_s = duration_s - (self.clock.now - t0)
        if remaining_s <= 0.0:
            # Slow configurations (SW path / 100 kHz) can spend the whole
            # window on the command sequence itself; an empty trace yields a
            # NaN latency rather than a silently-bogus settling estimate.
            remaining_s = 0.0
        ts, vs = self.sample_trace(lane, remaining_s)
        return TransitionTrace(lane=lane, v_from=v_from, v_target=target_v,
                               t_request=t0, times=ts - t0, volts=vs,
                               command_time_s=res.elapsed_s)

    # -- bookkeeping -----------------------------------------------------------
    def stats(self) -> dict[str, float]:
        return {
            "transactions": self.bus.transaction_count,
            "bus_busy_s": self.bus.busy_seconds,
            "sim_time_s": self.clock.now,
            "requests": len(self.request_log),
        }


@dataclasses.dataclass
class TransitionTrace:
    """A sampled voltage transition, times relative to request issue."""
    lane: int
    v_from: float
    v_target: float
    t_request: float
    times: np.ndarray
    volts: np.ndarray
    command_time_s: float

    def end_to_end_latency_s(self, *, n: int = 8, band_pct: float = 1.0) -> float:
        """Paper §V-A metric: elapsed time from issuing the voltage-update
        request at the PowerManager interface until the measured rail voltage
        reaches and remains within the stable band — i.e. the §V-D settling
        index measured on the sampled trace, offset by the first-sample time
        (samples only begin once the command sequence left the bus)."""
        from repro_torch.core.settling import settling_time
        if self.times.size == 0:
            # command sequence consumed the whole measurement window
            return float("nan")
        res = settling_time(self.times, self.volts, n=n, band_pct=band_pct)
        if not res.settled:
            return float("nan")
        return float(self.times[res.t_s_index])
