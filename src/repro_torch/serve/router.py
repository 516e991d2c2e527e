"""Headroom-aware fleet placement and per-request SLO accounting (port of
`repro/serve/router.py`).

The control plane learns per-chip, per-rail safe operating regions
(`core/sor.py`); this module spends them. Each chip's per-rail headroom
(held voltage minus its confidence-blended learned floor) is the margin it
has left to absorb runtime drift, so work goes where that margin is
deepest:

* decode-heavy requests go to the deepest-VDD_HBM-headroom chips,
  prefill-heavy ones weigh VDD_CORE;
* chips pinned at an envelope floor (`control_plane.pinned_rails`) take no
  new work and drain what they hold;
* `RoundRobinRouter` is the headroom-blind baseline.

`rail_headroom` reads the plane and the envelopes from the device in one
stacked copy; everything else here is host numpy with the reference's
arithmetic and tie-breaks (np.argmax: the lowest chip index), so the same
inputs place the same way in both packages.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.core.power_plane import PowerPlaneState
from repro_torch.core.rails import TPU_V5E_RAIL_MAP, RailMap

_RAIL_FIELDS = {"VDD_CORE": "v_core", "VDD_HBM": "v_hbm", "VDD_IO": "v_io"}


def rail_headroom(plane: PowerPlaneState, envelopes: Any,
                  rail_map: RailMap = TPU_V5E_RAIL_MAP
                  ) -> dict[str, np.ndarray]:
    """{rail: [n_chips] float64}: held voltage minus the rail's
    confidence-blended floor (`SafeEnvelope.floor(static v_min)`; the
    static floor where no envelope is fitted). 0 means the chip operates
    at its learned limit. All three rails come back in one stacked
    device-to-host copy; the fused serve tick packs the same rows into its
    bundle instead (`headroom_from_packed`)."""
    from repro_torch.core.control_plane import rail_floors
    n = plane.n_chips
    held = torch.stack([
        torch.atleast_1d(getattr(plane, field).to(torch.float32)).expand(n)
        for field in _RAIL_FIELDS.values()])
    h = (held - rail_floors(plane, envelopes, rail_map)).cpu().numpy(
        ).astype(np.float64)
    return {name: h[i].copy() for i, name in enumerate(_RAIL_FIELDS)}


def headroom_from_packed(rows) -> dict[str, np.ndarray]:
    """{rail: [n_chips] float64} from per-rail headroom rows already on the
    host (`[n_rails, n_chips]`, `control_plane.RAIL_LANES` order): the
    fused serve tick's bundle. No device read."""
    a = np.asarray(rows, np.float64)
    return {name: a[i].copy() for i, name in enumerate(_RAIL_FIELDS)}


@dataclasses.dataclass
class HeadroomRouter:
    """Scores each chip from the live learned envelopes and places a request
    on the best-scoring eligible chip.

    score_i = w_prefill * headroom[prefill_rail][i]
            + w_decode  * headroom[decode_rail][i]
            - occupancy_weight_v * occupancy[i] / capacity

    where (w_prefill, w_decode) is the request's token mix — decode-heavy
    requests chase VDD_HBM headroom (decode is HBM-bound), prefill-heavy
    ones VDD_CORE — and the occupancy term trades volts of headroom against
    queueing (one full batch slot costs `occupancy_weight_v / capacity`
    volts of score). Pinned chips are excluded while `drain_pinned` (they
    finish what they hold and shed first); ties break on the lowest chip
    index (np.argmax), so placement is deterministic given the inputs."""
    capacity: int
    decode_rail: str = "VDD_HBM"
    prefill_rail: str = "VDD_CORE"
    occupancy_weight_v: float = 0.01
    drain_pinned: bool = True
    name: str = "headroom"

    def __post_init__(self):
        if self.capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {self.capacity}")

    def reset(self) -> None:
        """Per-trace reset (`serve_trace` calls it at trace start). The
        headroom router is stateless — this exists so both routers share
        the trace-lifecycle interface."""

    def place(self, request, occupancy, headroom: dict[str, np.ndarray],
              pinned=None) -> "int | None":
        occ = np.asarray(occupancy, np.float64)
        n = occ.shape[0]
        eligible = occ < self.capacity
        if self.drain_pinned and pinned is not None:
            eligible &= ~np.asarray(pinned, bool)
        if not eligible.any():
            return None
        w_decode = request.decode_fraction
        zeros = np.zeros(n, np.float64)
        h_d = np.asarray(headroom.get(self.decode_rail, zeros), np.float64)
        h_p = np.asarray(headroom.get(self.prefill_rail, zeros), np.float64)
        score = ((1.0 - w_decode) * h_p + w_decode * h_d
                 - self.occupancy_weight_v * occ / self.capacity)
        score = np.where(eligible, score, -np.inf)
        return int(np.argmax(score))

    def place_batch(self, requests, occupancy,
                    headroom: dict[str, np.ndarray],
                    pinned=None) -> list[int]:
        """Place a whole FIFO queue in one pass: the headroom terms of
        every request's score are computed as one `[n_requests, n_chips]`
        matrix, and only the occupancy term (the one thing placement
        itself changes) updates between requests. Returns the chip per
        placed request, head-of-line prefix order — placement stops at the
        first request with no eligible chip, exactly like repeated
        sequential `place()` calls (same arithmetic, same lowest-index
        tie-break), which tests pin bit-equal."""
        if not requests:
            return []
        occ = np.asarray(occupancy, np.float64).copy()
        n = occ.shape[0]
        elig = np.ones(n, bool)
        if self.drain_pinned and pinned is not None:
            elig &= ~np.asarray(pinned, bool)
        w = np.asarray([r.decode_fraction for r in requests], np.float64)
        zeros = np.zeros(n, np.float64)
        h_d = np.asarray(headroom.get(self.decode_rail, zeros), np.float64)
        h_p = np.asarray(headroom.get(self.prefill_rail, zeros), np.float64)
        base = (1.0 - w)[:, None] * h_p[None, :] + w[:, None] * h_d[None, :]
        out: list[int] = []
        for k in range(len(requests)):
            eligible = elig & (occ < self.capacity)
            if not eligible.any():
                break
            score = base[k] - self.occupancy_weight_v * occ / self.capacity
            score = np.where(eligible, score, -np.inf)
            chip = int(np.argmax(score))
            out.append(chip)
            occ[chip] += 1.0
        return out

    def plan_migration(self, requests, occupancy,
                       headroom: dict[str, np.ndarray],
                       pinned=None, exclude=None) -> "list[int | None]":
        """Destinations for in-flight lanes being evacuated off hot chips:
        one entry per request, the deepest-headroom eligible chip by the
        SAME score `place` uses (phase-mix headroom blend minus the
        occupancy term, lowest-index tie-break), or None when no chip is
        eligible. Unlike `place_batch` an unplaceable request does NOT
        block the ones behind it — migration is best-effort, not FIFO.
        Eligibility: below capacity, not `exclude`d (the source chips
        being evacuated), and never pinned — pinned chips are excluded
        regardless of `drain_pinned`, since parking evacuated work on a
        chip already at its envelope floor recreates the problem being
        solved. Occupancy advances per granted destination, so one
        planning pass spreads a whole evacuation."""
        if not requests:
            return []
        occ = np.asarray(occupancy, np.float64).copy()
        n = occ.shape[0]
        elig = np.ones(n, bool)
        if pinned is not None:
            elig &= ~np.asarray(pinned, bool)
        if exclude is not None:
            elig &= ~np.asarray(exclude, bool)
        w = np.asarray([r.decode_fraction for r in requests], np.float64)
        zeros = np.zeros(n, np.float64)
        h_d = np.asarray(headroom.get(self.decode_rail, zeros), np.float64)
        h_p = np.asarray(headroom.get(self.prefill_rail, zeros), np.float64)
        base = (1.0 - w)[:, None] * h_p[None, :] + w[:, None] * h_d[None, :]
        out: "list[int | None]" = []
        for k in range(len(requests)):
            eligible = elig & (occ < self.capacity)
            if not eligible.any():
                out.append(None)
                continue
            score = base[k] - self.occupancy_weight_v * occ / self.capacity
            score = np.where(eligible, score, -np.inf)
            chip = int(np.argmax(score))
            out.append(chip)
            occ[chip] += 1.0
        return out


@dataclasses.dataclass
class RoundRobinRouter:
    """Headroom-blind baseline: next chip with a free batch slot, cursor
    order, ignoring envelopes and pinning entirely — what serving looked
    like before the fleet had per-chip margins to read."""
    capacity: int
    name: str = "roundrobin"
    _cursor: int = dataclasses.field(default=0, repr=False)

    def __post_init__(self):
        if self.capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {self.capacity}")

    def reset(self) -> None:
        """Per-trace reset: rewind the cursor so back-to-back traces on
        one engine place identically (`serve_trace` calls it at trace
        start; historically the second trace started mid-cursor)."""
        self._cursor = 0

    def place(self, request, occupancy, headroom=None,
              pinned=None) -> "int | None":
        n = len(occupancy)
        for k in range(n):
            i = (self._cursor + k) % n
            if occupancy[i] < self.capacity:
                self._cursor = (i + 1) % n
                return i
        return None

    def place_batch(self, requests, occupancy, headroom=None,
                    pinned=None) -> list[int]:
        """Whole-queue round-robin in one numpy pass. Sequential cursor
        semantics place one request per free chip per cyclic sweep (between
        two visits to the same chip every other chip is visited once), so
        the placement order is exactly: sweep s = 0, 1, ... over the
        cursor-rotated chip order, keeping chips with more than s free
        slots — which vectorizes as a boolean [capacity, n_chips] mask.
        Tests pin the result bit-equal to repeated `place()` calls,
        including the final cursor position."""
        if not requests:
            return []
        occ = np.asarray(occupancy, np.int64)
        n = occ.shape[0]
        rot = (self._cursor + np.arange(n)) % n
        free = self.capacity - occ[rot]
        keep = free[None, :] > np.arange(self.capacity)[:, None]
        order = np.broadcast_to(rot, keep.shape)[keep]   # sweep-major
        out = order[: len(requests)].tolist()
        if out:
            self._cursor = int((out[-1] + 1) % n)
        return [int(i) for i in out]


# ---------------------------------------------------------------------------
# Per-request SLO accounting
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _RequestRecord:
    rid: int
    t_arrival_s: float
    prefill_tokens: int
    decode_tokens: int
    t_placed_s: "float | None" = None
    chip: "int | None" = None
    t_done_s: "float | None" = None
    tokens_out: int = 0
    energy_j: float = 0.0        # modeled busy-energy share while resident
    defers: int = 0
    defer_time_s: float = 0.0
    migrations: int = 0          # in-flight moves off pinned/over chips
    stall_time_s: float = 0.0    # KV-transfer stall paid across migrations


class RequestLedger:
    """Per-request SLO accounting for a routed serve run: admission,
    placement, deferral (by reason code), completion, and modeled energy —
    plus the latency percentiles the SLO story is told in. Timestamps are
    trace-time seconds supplied by the caller (the engine's simulated
    clock), so ledgers from the same seeded trace are reproducible."""

    def __init__(self):
        self._recs: dict[int, _RequestRecord] = {}
        self._order: list[int] = []
        self.fleet_energy_j = 0.0           # all chips, busy + idle
        self.defers_by_reason: dict[str, int] = {}
        # "migrated" lifecycle events, trace order: one dict per in-flight
        # move (rid, t_s, src, dst, stall_s, src_streak — the pinned/over
        # streak length that triggered the evacuation)
        self.migration_events: list[dict] = []

    def __len__(self) -> int:
        return len(self._recs)

    def __getitem__(self, rid: int) -> _RequestRecord:
        return self._recs[rid]

    def records(self) -> list[_RequestRecord]:
        return [self._recs[r] for r in self._order]

    # -- lifecycle ------------------------------------------------------------
    def admit(self, request, t_s: "float | None" = None) -> None:
        if request.rid in self._recs:
            raise ValueError(f"request {request.rid} already admitted")
        self._recs[request.rid] = _RequestRecord(
            rid=request.rid,
            t_arrival_s=float(request.t_arrival_s if t_s is None else t_s),
            prefill_tokens=request.prefill_tokens,
            decode_tokens=request.decode_tokens)
        self._order.append(request.rid)

    def place(self, rid: int, t_s: float, chip: int) -> None:
        rec = self._recs[rid]
        if rec.t_placed_s is not None:
            raise ValueError(f"request {rid} already placed")
        rec.t_placed_s = float(t_s)
        rec.chip = int(chip)

    def defer(self, rid: int, reason: str, dt_s: float = 0.0) -> None:
        rec = self._recs[rid]
        rec.defers += 1
        rec.defer_time_s += float(dt_s)
        self.defers_by_reason[reason] = (
            self.defers_by_reason.get(reason, 0) + 1)

    def migrate(self, rid: int, t_s: float, src: int, dst: int,
                stall_s: float = 0.0, src_streak: int = 0) -> None:
        """Record an in-flight move of a resident request from chip `src`
        to chip `dst` (the "migrated" lifecycle event): the record's chip
        becomes the destination, and the KV-transfer stall it pays is
        accumulated. Guards mirror the rest of the lifecycle — migrating
        an unplaced or finished request raises, as does a source that
        disagrees with where the ledger believes the request lives."""
        rec = self._recs[rid]
        if rec.t_placed_s is None:
            raise ValueError(f"request {rid} migrated before placement")
        if rec.t_done_s is not None:
            raise ValueError(f"request {rid} migrated after completion")
        if rec.chip != int(src):
            raise ValueError(f"request {rid} lives on chip {rec.chip}, "
                             f"not the claimed source {src}")
        if int(src) == int(dst):
            raise ValueError(f"request {rid}: migration source == "
                             f"destination ({src})")
        rec.chip = int(dst)
        rec.migrations += 1
        rec.stall_time_s += float(stall_s)
        self.migration_events.append({
            "rid": rid, "t_s": float(t_s), "src": int(src),
            "dst": int(dst), "stall_s": float(stall_s),
            "src_streak": int(src_streak)})

    def charge(self, rid: int, joules: float) -> None:
        self._recs[rid].energy_j += float(joules)

    def tick_energy(self, joules: float) -> None:
        self.fleet_energy_j += float(joules)

    def finish(self, rid: int, t_s: float, tokens_out: int) -> None:
        rec = self._recs[rid]
        if rec.t_placed_s is None:
            raise ValueError(f"request {rid} finished before placement")
        rec.t_done_s = float(t_s)
        rec.tokens_out = int(tokens_out)

    # -- statistics -----------------------------------------------------------
    @staticmethod
    def percentile(values, q: float) -> float:
        """Linear-interpolated percentile at rank q/100 * (n-1) — the exact
        arithmetic pinned by tests (numpy's default 'linear' method,
        spelled out so the SLO numbers are specified, not inherited)."""
        vals = sorted(float(v) for v in values)
        if not vals:
            return float("nan")
        if not 0.0 <= q <= 100.0:
            raise ValueError(f"q must be in [0, 100], got {q}")
        rank = (len(vals) - 1) * q / 100.0
        lo = int(np.floor(rank))
        hi = int(np.ceil(rank))
        frac = rank - lo
        return vals[lo] * (1.0 - frac) + vals[hi] * frac

    def summary(self) -> dict[str, Any]:
        recs = self.records()
        done = [r for r in recs if r.t_done_s is not None]
        latency = [r.t_done_s - r.t_arrival_s for r in done]
        queue = [r.t_placed_s - r.t_arrival_s for r in done]
        tokens = sum(r.tokens_out for r in done)
        out = {
            "n_requests": len(recs),
            "completed": len(done),
            "placed": sum(1 for r in recs if r.t_placed_s is not None),
            "defers": sum(r.defers for r in recs),
            "defers_by_reason": dict(self.defers_by_reason),
            "tokens_out": tokens,
            "fleet_energy_j": self.fleet_energy_j,
            "tokens_per_joule": tokens / max(self.fleet_energy_j, 1e-12),
            "request_energy_j": sum(r.energy_j for r in recs),
            "migrations": sum(r.migrations for r in recs),
            "migration_stall_s": sum(r.stall_time_s for r in recs),
        }
        for label, vals in (("latency_s", latency), ("queue_s", queue)):
            out[f"p50_{label}"] = self.percentile(vals, 50.0)
            out[f"p95_{label}"] = self.percentile(vals, 95.0)
            out[f"p99_{label}"] = self.percentile(vals, 99.0)
            out[f"mean_{label}"] = (float(np.mean(vals)) if vals
                                    else float("nan"))
        return out
