"""Fleet-scale PMBus: N boards, each with its own serialized bus segment,
sharing one fleet timeline through an event queue.

The single-board model (pmbus.PmBus) serializes every transaction on one
global clock, so actuating a fleet of N chips would cost N x the single-board
latency in simulated time — physically wrong (each board has its own two-wire
bus) and computationally hopeless for 1000-chip sweeps. Here each board is a
`BusSegment`: a full PowerManager stack (UCD9248 model + regulator dynamics +
per-path controller overheads) on its *own local clock*. Fleet-level
operations schedule per-segment work as events on the shared timeline
(pmbus.EventQueue), let every segment run ahead independently, then advance
fleet time to the max over segments — fleet actuations overlap in simulated
time exactly as N independent buses would.

Copied from `repro/core/fleet.py`; `poll_frame` returns the port's
`telemetry.TelemetryFrame`, whose sampled values are float32 tensors on the
CPU: the bus's sample is made on the host, and the consumer moves it onto
its plane's device.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Iterable, Sequence

import numpy as np
import torch

from repro_torch.core.pmbus import EventQueue, SimClock
from repro_torch.core.power_manager import ControlPath, Opcode, PowerManager
from repro_torch.core.rails import TPU_V5E_RAIL_MAP, RailMap
from repro_torch.core.telemetry import (RAIL_OBSERVABLE_KEYS, Provenance,
                                        TelemetryFrame)


@dataclasses.dataclass
class FleetActuationReport:
    """Timing + outcome of one fleet-wide actuation round."""
    boards_touched: int
    lane_writes: int            # command sequences that completed on a bus
    elapsed_s: float            # fleet-time cost (max over segments)
    serialized_s: float         # what one shared bus would have cost (sum)
    failed_writes: int = 0      # rejected requests (e.g. outside envelope)
    errors: tuple[str, ...] = ()
    deadband_skipped: int = 0   # lanes already within deadband_v (no write)

    @property
    def ok(self) -> bool:
        return self.failed_writes == 0

    @property
    def overlap_speedup(self) -> float:
        return self.serialized_s / self.elapsed_s if self.elapsed_s > 0 else 1.0


class BusSegment:
    """One board's serialized PMBus + regulators on a local timeline.

    The local clock may run ahead of fleet time while an actuation is in
    flight; `catch_up` models the segment sitting idle until fleet time
    passes it again."""

    def __init__(self, board_id: int, pm: PowerManager):
        self.board_id = board_id
        self.pm = pm
        self.busy_seconds = 0.0

    @property
    def local_now(self) -> float:
        return self.pm.clock.now

    def catch_up(self, t: float) -> None:
        self.pm.clock.advance_to(t)

    def set_voltage_settled(self, lane: int, volts: float,
                            settle_band_frac: float = 0.01
                            ) -> tuple[float, str | None]:
        """Full voltage-update workflow + wait for regulator settling on this
        segment's local clock; returns (achieved rail voltage, error) where
        error is None on success and the rejection reason otherwise."""
        t0 = self.pm.clock.now
        res = self.pm.set_voltage(lane, volts)
        if res.ok:
            ch = self.pm.channels[lane]
            self.pm.clock.advance(
                ch.settle_time_to_band(abs(volts) * settle_band_frac))
        self.busy_seconds += self.pm.clock.now - t0
        return self.pm.rail_voltage_now(lane), (None if res.ok else res.error)

    def rail_voltage(self, lane: int) -> float:
        return self.pm.rail_voltage_now(lane)


@dataclasses.dataclass
class SegmentPollStats:
    """Outcome of one segment's periodic READ_VOUT telemetry polling.

    `requested_interval_s` is what the operator asked for (defaults to the
    segment's Table VI measurement interval x lanes); `achieved_interval_s`
    is what the bus actually delivered. When a segment's poll rate exceeds
    its serialized two-wire capacity — or actuation traffic occupies the bus
    — polls slip (`deferred`) and the achieved interval degrades; polls are
    *paced*, never queued into a backlog, and actuations are never dropped.

    Deadband back-pressure (`set_poll_relax`): a segment whose lanes all sit
    steady inside their confidence-scaled deadband at a learned floor is
    polled at `relax_factor` x the requested interval — `relaxed_lanes`
    records how many lanes pinned it there and `relaxed_polls` counts the
    rounds fired at the relaxed rate."""
    board_id: int
    requested_interval_s: float
    polls: int = 0              # poll rounds completed
    samples: int = 0            # successful per-lane READ_VOUT samples
    deferred: int = 0           # rounds that slipped past their deadline
    busy_s: float = 0.0         # bus time spent polling
    relax_factor: float = 1.0   # current READ_VOUT interval multiplier
    relaxed_lanes: int = 0      # deadband-pinned lanes behind the relax
    relaxed_polls: int = 0      # poll rounds fired at a relaxed interval
    _last_done: float = math.nan
    _interval_sum_s: float = 0.0
    _intervals: int = 0

    @property
    def achieved_interval_s(self) -> float:
        return (self._interval_sum_s / self._intervals if self._intervals
                else math.nan)

    @property
    def backpressure(self) -> float:
        """achieved / requested interval; > 1 means the segment is
        oversubscribed and polling degraded to what the bus can carry."""
        a = self.achieved_interval_s
        return a / self.requested_interval_s if not math.isnan(a) else 1.0


class FleetPowerManager:
    """Event-scheduled multi-segment bus: one PowerManager per board, one
    shared fleet clock, actuation rounds that cost max-over-segments.

    `apply_setpoints` is the fleet analogue of the old single-board
    HostPowerController.apply: push per-chip rail setpoints, pay the
    characterized PMBus + settling cost *concurrently across boards*, and
    read back what each regulator actually achieved."""

    def __init__(
        self,
        n_boards: int,
        rail_map: RailMap = TPU_V5E_RAIL_MAP,
        *,
        path: ControlPath | str = ControlPath.SOFTWARE,
        clock_hz: int = 400_000,
        seed: int = 0,
        loads: dict[str, Callable[[float, float], float]] | None = None,
    ):
        if n_boards < 1:
            raise ValueError(f"n_boards must be >= 1, got {n_boards}")
        self.rail_map = rail_map
        self.clock = SimClock()            # fleet (global) time
        self.events = EventQueue()
        self.segments = [
            BusSegment(i, PowerManager(rail_map, path=path, clock_hz=clock_hz,
                                       loads=loads, seed=seed * 8191 + i))
            for i in range(n_boards)
        ]
        self.actuation_rounds = 0
        self.actuation_seconds = 0.0       # fleet-time total
        self.serialized_seconds = 0.0      # sum-over-segments total
        self.lane_writes = 0
        self.failed_writes = 0
        self.deadband_skips = 0            # lanes held by the write deadband
        # periodic READ_VOUT telemetry polling (paper Table VI intervals)
        self._polling = False
        self._poll_gen = 0   # invalidates stale periodic events on restart
        self.poll_stats: dict[int, SegmentPollStats] = {}
        self.last_poll: dict[int, dict[int, tuple[float, float]]] = {}

    @property
    def n_boards(self) -> int:
        return len(self.segments)

    # -- timeline management ---------------------------------------------------
    def _barrier(self) -> float:
        """Drain due events and advance fleet time to the max segment time."""
        t = max((s.local_now for s in self.segments), default=self.clock.now)
        t = max(t, self.clock.now)
        self.events.run_until(t)
        return self.clock.advance_to(t)

    def sync(self) -> None:
        """Bring every idle segment up to fleet time."""
        for s in self.segments:
            s.catch_up(self.clock.now)

    def idle(self, dt: float) -> None:
        """Let simulated fleet time pass with no bus traffic (e.g. the
        training step between host-path control rounds)."""
        if dt < 0:
            raise ValueError("time cannot go backwards")
        self.clock.advance(dt)
        self.events.run_until(self.clock.now)
        self.sync()

    # -- fleet actuation --------------------------------------------------------
    def apply_setpoints(
        self,
        setpoints: Sequence[dict[int, float]],
        *,
        settle_band_frac: float = 0.01,
        deadband_v: float = 1e-4,
    ) -> tuple[list[dict[int, float]], FleetActuationReport]:
        """Push per-board {lane: volts} setpoints through every segment.

        Per board: skip lanes already within `deadband_v` of the request;
        otherwise run the full Fig-5 command sequence + settling on that
        board's local clock. All touched boards proceed concurrently in
        simulated time; fleet time advances by the slowest board's cost.
        Returns (per-board achieved {lane: volts}, timing report)."""
        if len(setpoints) != self.n_boards:
            raise ValueError(
                f"expected {self.n_boards} setpoint dicts, got {len(setpoints)}")
        self.sync()
        t0 = self.clock.now
        achieved: list[dict[int, float]] = [dict() for _ in self.segments]
        touched = 0
        writes = 0
        skipped = 0
        errors: list[str] = []

        def make_actuation(seg: BusSegment, wanted: dict[int, float]):
            def fire(t_fire: float, seg=seg, wanted=wanted):
                nonlocal writes, skipped
                seg.catch_up(t_fire)
                for lane, volts in sorted(wanted.items()):
                    if abs(seg.rail_voltage(lane) - volts) > deadband_v:
                        v, err = seg.set_voltage_settled(
                            lane, volts, settle_band_frac)
                        achieved[seg.board_id][lane] = v
                        if err is None:
                            writes += 1
                        else:
                            errors.append(
                                f"board {seg.board_id} lane {lane}: {err}")
                    else:
                        skipped += 1
                        achieved[seg.board_id][lane] = seg.rail_voltage(lane)
            return fire

        for seg, wanted in zip(self.segments, setpoints):
            if not wanted:
                continue
            need = any(abs(seg.rail_voltage(l) - v) > deadband_v
                       for l, v in wanted.items())
            if need:
                touched += 1
            # schedule even deadband-only boards so readback is time-consistent
            self.events.schedule(t0, make_actuation(seg, dict(wanted)))

        self.events.run_until(t0)          # fire this round's actuations
        self._barrier()
        elapsed = self.clock.now - t0
        serialized = sum(s.local_now - t0 for s in self.segments
                         if s.local_now > t0)
        self.actuation_rounds += 1
        self.actuation_seconds += elapsed
        self.serialized_seconds += serialized
        self.lane_writes += writes
        self.failed_writes += len(errors)
        self.deadband_skips += skipped
        return achieved, FleetActuationReport(touched, writes, elapsed,
                                              serialized, len(errors),
                                              tuple(errors),
                                              deadband_skipped=skipped)

    # -- periodic telemetry polling ---------------------------------------------
    def start_polling(self, interval_s: float | None = None,
                      lanes: Iterable[int] | None = None) -> None:
        """Start periodic per-segment READ_VOUT polling on the fleet
        timeline, interleaved with actuations.

        Every segment samples each polled lane through its own PowerManager
        (paying the full Read Word + controller overhead of paper Table VI)
        at the requested interval. `interval_s=None` asks for the fastest
        the configuration supports: the segment's measurement interval times
        the number of polled lanes. Polls fire whenever fleet time advances
        (`idle`, actuation barriers), so telemetry and actuation traffic
        share each segment's serialized bus.

        Back-pressure: a poll that finds its bus still busy (actuation in
        flight, or the previous poll still draining) slips to when the bus
        frees up, and the *next* poll is scheduled from its completion — the
        effective interval degrades to what the segment can carry instead of
        building a backlog, and pending actuations are never dropped."""
        if self._polling:
            raise RuntimeError("polling already active; stop_polling() first")
        lanes = list(lanes) if lanes is not None else self.rail_map.lanes()
        if not lanes:
            raise ValueError("need at least one lane to poll")
        self._polling = True
        self._poll_gen += 1
        self.poll_stats = {}
        self.last_poll = {s.board_id: {} for s in self.segments}
        for seg in self.segments:
            req = (interval_s if interval_s is not None
                   else seg.pm.measurement_interval_s() * len(lanes))
            if req <= 0:
                raise ValueError(f"poll interval must be > 0, got {req}")
            st = SegmentPollStats(seg.board_id, req)
            self.poll_stats[seg.board_id] = st
            self.events.schedule_periodic(
                self.clock.now + req, self._make_poll(seg, st, lanes))

    def stop_polling(self) -> None:
        """Stop polling; in-flight periodic events unschedule themselves on
        their next firing."""
        self._polling = False

    def set_poll_relax(self, board_id: int, factor: float,
                       lanes_pinned: int = 0) -> None:
        """Deadband-paired poll back-pressure: when every governed lane on a
        segment sits inside its confidence-scaled deadband at a learned
        floor, its READ_VOUT samples carry no new information at the full
        Table VI rate — relax the segment's poll interval by `factor`
        (>= 1.0; 1.0 restores the requested rate). Takes effect from the
        segment's next firing: the periodic event reads the factor live, so
        entering/leaving the deadband needs no reschedule and never drops an
        in-flight poll. `lanes_pinned` records how many lanes justified the
        relax (SegmentPollStats.relaxed_lanes). No-op when the segment is
        not polling."""
        if factor < 1.0:
            raise ValueError(f"relax factor must be >= 1.0, got {factor}")
        st = self.poll_stats.get(board_id)
        if st is None:
            return
        st.relax_factor = factor
        st.relaxed_lanes = lanes_pinned if factor > 1.0 else 0

    def _make_poll(self, seg: BusSegment, st: SegmentPollStats,
                   lanes: list[int]):
        gen = self._poll_gen
        def poll(t_fire: float) -> float | None:
            # gen check kills events of a stopped run even if polling has
            # been restarted since (else a stop/start revives the old
            # periodic events and the segment polls at double rate)
            if not self._polling or gen != self._poll_gen:
                return None
            start = max(t_fire, seg.local_now)
            slipped = start - t_fire > 1e-12
            seg.catch_up(start)
            for lane in lanes:
                res = seg.pm.execute(Opcode.GET_VOLTAGE, lane)
                if res.ok:
                    self.last_poll[seg.board_id][lane] = (res.t_done, res.value)
                    st.samples += 1
            done = seg.local_now
            st.polls += 1
            st.busy_s += done - start
            # deadband back-pressure: the effective interval is the request
            # stretched by the live relax factor (read per firing, so the
            # controller flips it between rounds with no reschedule)
            interval = st.requested_interval_s * max(st.relax_factor, 1.0)
            if st.relax_factor > 1.0:
                st.relaxed_polls += 1
            if slipped or done > t_fire + interval:
                st.deferred += 1
            if not math.isnan(st._last_done):
                st._interval_sum_s += done - st._last_done
                st._intervals += 1
            st._last_done = done
            # degrade, don't backlog: next poll no earlier than completion
            return max(t_fire + interval, done)
        return poll

    def poll_readback(self, lanes: Iterable[int] | None = None) -> np.ndarray:
        """Latest PMBus-*sampled* rail voltages, [n_boards, n_lanes] (NaN
        where a lane was never polled) — the telemetry-path counterpart of
        `readback`'s oscilloscope view."""
        return self.poll_observation(lanes)[0]

    def poll_observation(self, lanes: Iterable[int] | None = None
                         ) -> tuple[np.ndarray, np.ndarray]:
        """(values, ages): the latest READ_VOUT sample of each lane and how
        stale it is, both [n_boards, n_lanes] (NaN where never polled). Ages
        are fleet-clock seconds since each sample completed on its segment's
        bus — the sampling delay a poll-driven host policy decides under."""
        lanes = list(lanes) if lanes is not None else self.rail_map.lanes()
        vals = np.full((self.n_boards, len(lanes)), np.nan)
        ages = np.full((self.n_boards, len(lanes)), np.nan)
        for s in self.segments:
            got = self.last_poll.get(s.board_id, {})
            for j, lane in enumerate(lanes):
                if lane in got:
                    t_done, v = got[lane]
                    vals[s.board_id, j] = v
                    ages[s.board_id, j] = self.clock.age(t_done)
        return vals, ages

    def poll_frame(self, *, grad_error=None) -> TelemetryFrame:
        """The latest polled observation as a typed `TelemetryFrame`
        (Provenance.POLLED): per-board sampled rail voltages keyed by the
        rail map's VDD_CORE/VDD_HBM/VDD_IO names, `age_s` = each board's
        *stalest* sampled lane (a decision is only as fresh as its oldest
        input). NaN where a lane was never polled — the consumer decides the
        fallback (HostRailController uses the oracle plane value at age 0;
        the SOR learner records the chip as having no sample).

        `grad_error` optionally merges the caller's measured-error telemetry
        (the non-electrical inputs the frontier fits need) onto the sampled
        frame — this is how `poll_frame` feeds `telemetry.FrameHistory`
        without pretending the error came off the bus. It is either the
        historical scalar/array (the VDD_IO measured error, recorded under
        the `grad_error` field alone) or a dict keyed by RAIL NAME mapping
        each rail to its own failure observable
        (`telemetry.RAIL_OBSERVABLE_KEYS` places them: VDD_IO ->
        `grad_error`, VDD_CORE -> `straggle_rate`, VDD_HBM ->
        `hbm_error_rate`). Rails missing from the dict record NaN — an
        invalid sample for that rail's fit — instead of silently attributing
        another rail's error to it."""
        fields = {"VDD_CORE": "v_core", "VDD_HBM": "v_hbm", "VDD_IO": "v_io"}
        lanes, names = [], []
        for rail in self.rail_map:
            if rail.name in fields:
                lanes.append(rail.lane)
                names.append(fields[rail.name])
        vals, ages = self.poll_observation(lanes)
        kw = {name: torch.from_numpy(vals[:, j].astype(np.float32))
              for j, name in enumerate(names)}
        extras: dict = {}
        if isinstance(grad_error, dict):
            unknown = set(grad_error) - set(RAIL_OBSERVABLE_KEYS)
            if unknown:
                raise ValueError(
                    f"unknown rail(s) {sorted(unknown)} in grad_error dict; "
                    f"known: {sorted(RAIL_OBSERVABLE_KEYS)}")
            # missing rails record NaN -> an invalid sample for that rail
            kw["grad_error"] = grad_error.get("VDD_IO", math.nan)
            for rail, key in RAIL_OBSERVABLE_KEYS.items():
                if rail != "VDD_IO":
                    extras[key] = grad_error.get(rail, math.nan)
        elif grad_error is not None:
            kw["grad_error"] = grad_error
        # max over lanes, NaN-aware without the all-NaN-slice warning
        masked = np.where(np.isnan(ages), -np.inf, ages)
        age = masked.max(axis=1, initial=-np.inf)
        age = np.where(np.isinf(age), np.nan, age)
        return TelemetryFrame(age_s=torch.from_numpy(age.astype(np.float32)),
                              extras=extras,
                              provenance=Provenance.POLLED, **kw)

    # -- telemetry --------------------------------------------------------------
    def readback(self, lanes: Iterable[int] | None = None) -> np.ndarray:
        """Instantaneous true rail voltages, [n_boards, n_lanes] (oscilloscope
        view; PMBus-sampled telemetry goes through each segment's PowerManager)."""
        lanes = list(lanes) if lanes is not None else self.rail_map.lanes()
        self.sync()
        return np.array([[s.rail_voltage(l) for l in lanes]
                         for s in self.segments])

    def stats(self) -> dict[str, float]:
        return {
            "boards": self.n_boards,
            "actuation_rounds": self.actuation_rounds,
            "actuation_s": self.actuation_seconds,
            "serialized_s": self.serialized_seconds,
            "lane_writes": self.lane_writes,
            "failed_writes": self.failed_writes,
            "events_processed": self.events.processed,
            "fleet_time_s": self.clock.now,
            "transactions": sum(s.pm.bus.transaction_count for s in self.segments),
            "polls": sum(st.polls for st in self.poll_stats.values()),
            "poll_samples": sum(st.samples for st in self.poll_stats.values()),
            "polls_deferred": sum(st.deferred
                                  for st in self.poll_stats.values()),
            "polls_relaxed": sum(st.relaxed_polls
                                 for st in self.poll_stats.values()),
            "relaxed_lanes": sum(st.relaxed_lanes
                                 for st in self.poll_stats.values()),
        }
