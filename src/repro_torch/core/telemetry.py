"""Telemetry plumbing (port of `repro/core/telemetry.py`): the typed
per-step observation (`TelemetryFrame`), the per-rail observable
declarations, the `FrameHistory` ring the safe-operating-region learner
fits over, and the trainer's host-side store (`StepRecord`,
`TelemetryLog`).

A frame's fields are scalars (one chip) or `[n_chips]` tensors (a fleet).
Fields its constructor did not measure keep their Python defaults (0.0,
or None for rail voltages); consumers convert them onto the plane's
device.

The ring's write cursor and push count are host integers: the serving loop
decides the refit cadence on the host, so no device value is read back to
steer control flow.
"""

from __future__ import annotations

import collections
import dataclasses
import enum
import json
from typing import Any

import numpy as np
import torch

from repro_torch.core.power_plane import as_f32
from repro_torch.kernels import ref


class Provenance(enum.Enum):
    """Where a frame's rail-voltage observations came from."""
    EXACT = "exact"      # in-graph accounting state (oracle, age 0)
    POLLED = "polled"    # PMBus READ_VOUT samples (quantized + aged)


# metrics dict keys with first-class TelemetryFrame fields
_FRAME_METRIC_KEYS = ("grad_error", "t_step_s", "t_comp_s", "t_mem_s",
                      "t_coll_s", "power_w", "energy_step_j")
_FRAME_RAIL_KEYS = ("v_core", "v_hbm", "v_io")
_FRAME_NOM_KEYS = ("v_nom_core", "v_nom_hbm", "v_nom_io")


def ndim(x) -> int:
    return x.dim() if isinstance(x, torch.Tensor) else np.ndim(x)


@dataclasses.dataclass(frozen=True)
class TelemetryFrame:
    """One typed observation of a chip (or `[n_chips]` fleet): what a policy
    decides from. Rail voltages may be None when its constructor had no
    view of the rails (policies fall back to the plane state then); nominal
    anchors are the per-chip `FleetSpec` voltages, or None on the scalar
    path."""
    grad_error: Any = 0.0
    t_step_s: Any = 0.0
    t_comp_s: Any = 0.0
    t_mem_s: Any = 0.0
    t_coll_s: Any = 0.0
    power_w: Any = 0.0
    energy_step_j: Any = 0.0
    v_core: Any = None
    v_hbm: Any = None
    v_io: Any = None
    v_nom_core: Any = None
    v_nom_hbm: Any = None
    v_nom_io: Any = None
    age_s: Any = 0.0
    extras: dict[str, Any] = dataclasses.field(default_factory=dict)
    provenance: Provenance = Provenance.EXACT

    @staticmethod
    def from_dict(telemetry: dict[str, Any], *, state=None
                  ) -> "TelemetryFrame":
        """EXACT frame from a string-keyed metrics dict (the train step's
        `metrics`, or a caller's `{"grad_error": ...}`): known keys land in
        typed fields, everything else in `extras`; rail voltages the dict
        does not carry come from `state`."""
        t = dict(telemetry)
        kw: dict[str, Any] = {}
        for k in _FRAME_METRIC_KEYS + _FRAME_NOM_KEYS + _FRAME_RAIL_KEYS:
            v = t.pop(k, None)
            if v is not None:
                kw[k] = v
            elif k in _FRAME_RAIL_KEYS and state is not None:
                kw[k] = getattr(state, k)
        return TelemetryFrame(extras=t, **kw)

    @staticmethod
    def from_account(state, metrics: dict[str, Any], *,
                     nominals: dict[str, Any] | None = None
                     ) -> "TelemetryFrame":
        """EXACT frame from an `account_step[_fleet]` result: voltages are
        the plane state, `age_s` is 0."""
        kw = {k: metrics[k] for k in _FRAME_METRIC_KEYS if k in metrics}
        if nominals:
            for k in _FRAME_NOM_KEYS:
                if k in nominals:
                    kw[k] = nominals[k]
        extras = {k: v for k, v in metrics.items()
                  if k not in _FRAME_METRIC_KEYS and k not in _FRAME_NOM_KEYS}
        return TelemetryFrame(v_core=state.v_core, v_hbm=state.v_hbm,
                              v_io=state.v_io, extras=extras,
                              provenance=Provenance.EXACT, **kw)

    def to_dict(self) -> dict[str, Any]:
        """The metrics-dict view (for the `update_*` policies and logging):
        the non-None typed fields plus the extras."""
        out = dict(self.extras)
        for k in _FRAME_METRIC_KEYS + _FRAME_NOM_KEYS + _FRAME_RAIL_KEYS:
            v = getattr(self, k)
            if v is not None:
                out[k] = v
        return out

    def get(self, key: str, default: Any = None) -> Any:
        """dict-style access over typed fields + extras."""
        if key in self.extras:
            return self.extras[key]
        v = getattr(self, key, None)
        return v if v is not None else default

    def reduce_worst(self, keys: tuple[str, ...]) -> "TelemetryFrame":
        """Broadcast the fleet-worst (max) value of each named observation
        to every chip. NaN lanes mean "not measured this round": the worst
        is taken over measured lanes only; all-NaN stays NaN."""
        def worst(v):
            m = torch.where(torch.isnan(v), float("-inf"), v).max()
            return torch.where(torch.isneginf(m), float("nan"), m)

        kw: dict[str, Any] = {}
        extras = dict(self.extras)
        for k in keys:
            if k in extras:
                v = extras[k]
                if ndim(v) >= 1:
                    extras[k] = worst(v).expand(v.shape)
                continue
            v = getattr(self, k, None)
            if v is not None and ndim(v) >= 1:
                kw[k] = worst(v).expand(v.shape)
        return dataclasses.replace(self, extras=extras, **kw)


def as_frame(telemetry, *, state=None) -> TelemetryFrame:
    """Normalize a controller input: a TelemetryFrame passes through, its
    rail observations filled from `state` when it has none; a metrics dict
    goes through `TelemetryFrame.from_dict`."""
    if not isinstance(telemetry, TelemetryFrame):
        return TelemetryFrame.from_dict(telemetry, state=state)
    if state is not None and telemetry.v_core is None:
        return dataclasses.replace(
            telemetry, v_core=state.v_core, v_hbm=state.v_hbm,
            v_io=state.v_io)
    return telemetry


# ---------------------------------------------------------------------------
# RailObservable + FrameHistory
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RailObservable:
    """Which frame field carries one rail's voltage observation and which
    field/extras key carries its failure observable; `error_bound`/`guard_v`
    optionally override the SorConfig globals for this rail."""
    rail: str
    voltage: str
    key: str
    error_bound: "float | None" = None
    guard_v: "float | None" = None


VDD_IO_BER = RailObservable("VDD_IO", "v_io", "grad_error")
VDD_CORE_STRAGGLE = RailObservable("VDD_CORE", "v_core", "straggle_rate")
VDD_HBM_ERROR = RailObservable("VDD_HBM", "v_hbm", "hbm_error_rate")

DEFAULT_RAIL_OBSERVABLES = (VDD_IO_BER,)
ALL_RAIL_OBSERVABLES = (VDD_CORE_STRAGGLE, VDD_HBM_ERROR, VDD_IO_BER)

RAIL_OBSERVABLE_KEYS = {s.rail: s.key for s in ALL_RAIL_OBSERVABLES}


def validate_rails(rails) -> tuple:
    """Non-empty, unique rail names."""
    rails = tuple(rails)
    if not rails:
        raise ValueError("need at least one RailObservable")
    names = [s.rail for s in rails]
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate rails in {names}")
    return rails


def rail_index(rails, name: str) -> int:
    for i, s in enumerate(rails):
        if s.rail == name:
            return i
    raise KeyError(f"rail {name!r} not tracked; "
                   f"have {[s.rail for s in rails]}")


@dataclasses.dataclass(frozen=True)
class FrameHistory:
    """Fixed-capacity ring of `TelemetryFrame` samples stored as stacked
    tensors `[capacity, n_rails, *chip]`: per sample, rail and chip the
    voltage observation and the rail's failure observable, plus staleness
    (`age_s`) and a POLLED/EXACT flag. `valid` masks (rail, chip) lanes
    whose voltage or observable was non-finite at push time."""
    v: torch.Tensor        # f32 [capacity, n_rails, *chip]
    obs: torch.Tensor      # f32 [capacity, n_rails, *chip]
    age_s: torch.Tensor    # f32 [capacity, *chip]
    polled: torch.Tensor   # f32 [capacity, *chip] — 1.0 POLLED, 0.0 EXACT
    valid: torch.Tensor    # bool [capacity, n_rails, *chip]
    cursor: int            # next slot to write
    count: int             # total pushes (not capped)
    capacity: int
    rails: tuple = DEFAULT_RAIL_OBSERVABLES

    @staticmethod
    def create(capacity: int, n_chips: int | None = None,
               rails: tuple = DEFAULT_RAIL_OBSERVABLES,
               device="cuda") -> "FrameHistory":
        if capacity < 2:
            raise ValueError(f"capacity must be >= 2, got {capacity}")
        rails = validate_rails(rails)
        chip = () if n_chips is None else (n_chips,)
        zr = torch.zeros((capacity, len(rails)) + chip, dtype=torch.float32,
                         device=device)
        zc = torch.zeros((capacity,) + chip, dtype=torch.float32,
                         device=device)
        return FrameHistory(v=zr, obs=zr.clone(), age_s=zc,
                            polled=zc.clone(),
                            valid=torch.zeros(zr.shape, dtype=torch.bool,
                                              device=device),
                            cursor=0, count=0, capacity=capacity, rails=rails)

    @property
    def chip_shape(self) -> tuple[int, ...]:
        return tuple(self.v.shape[2:])

    @property
    def n_rails(self) -> int:
        return len(self.rails)

    def rail_index(self, name: str) -> int:
        return rail_index(self.rails, name)

    # the single-rail views (the field names of the one-rail layout)
    @property
    def v_io(self) -> torch.Tensor:
        return self.v[:, self.rail_index("VDD_IO")]

    @property
    def error(self) -> torch.Tensor:
        return self.obs[:, self.rail_index("VDD_IO")]

    def partition_specs(self, axis_name: str = "chips"):
        """The placement tree of this ring on a 1-D `axis_name` chip mesh:
        the `[capacity, n_rails, n]` tensors shard their trailing chip axis
        (`Shard(-1)`), `cursor` and `count` replicate, so a sharded control
        round never gathers the window. A scalar or multi-dim chip shape
        replicates every leaf."""
        from torch.distributed.tensor import Replicate

        from repro_torch.kernels import ops
        if len(self.chip_shape) == 1:
            return ops.chip_specs(self, self.chip_shape[0], axis_name)
        return ops._map_tree(lambda leaf: Replicate(), self)

    def push(self, frame: TelemetryFrame) -> "FrameHistory":
        """Functional append of one observation. (rail, chip) lanes whose
        voltage or observable is non-finite record as invalid."""
        shape = self.chip_shape
        dev = self.v.device

        def val(x, default=None):
            if x is None:
                x = float("nan") if default is None else default
            return as_f32(x, dev).expand(shape)

        v = torch.stack([val(frame.get(s.voltage)) for s in self.rails])
        obs = torch.stack([val(frame.get(s.key)) for s in self.rails])
        age = val(frame.age_s, default=0.0)
        ok = torch.isfinite(v) & torch.isfinite(obs)
        polled = float(frame.provenance is Provenance.POLLED)

        def put(buf, x):
            buf = buf.clone()
            if isinstance(x, float):
                buf[self.cursor].fill_(x)   # no host tensor to copy over
            else:
                buf[self.cursor] = x
            return buf

        # unknown staleness (NaN) records as +inf: zero weight under
        # SorConfig.age_halflife_s
        return dataclasses.replace(
            self,
            v=put(self.v, v),
            obs=put(self.obs, obs),
            age_s=put(self.age_s, torch.where(torch.isfinite(age), age,
                                              float("inf"))),
            polled=put(self.polled, polled),
            valid=put(self.valid, ok),
            cursor=(self.cursor + 1) % self.capacity,
            count=self.count + 1)

    def recency_weights(self, decay: float) -> torch.Tensor:
        """`[capacity, n_rails, *chip]` exponential recency weights: the
        newest valid sample weighs 1, each older slot `decay`x less, invalid
        lanes 0."""
        return ref.recency_weights(self.valid, self.cursor, decay)


def scalar_view(x) -> float:
    """A scalar metric passes through, a `[n_chips]` metric reports the
    fleet mean (one device-to-host copy)."""
    a = np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x,
                   dtype=np.float64)
    return float(a.mean()) if a.ndim else float(a)


# metrics with first-class StepRecord fields
_CORE_KEYS = ("grad_error", "t_step_s", "power_w", "energy_step_j")
_PLANE_FIELDS = ("v_core", "v_hbm", "v_io", "comp_level")


@dataclasses.dataclass
class StepRecord:
    step: int
    loss: float
    grad_error: float
    t_step_s: float
    power_w: float
    energy_step_j: float
    comp_level: int
    v_core: float
    v_hbm: float
    v_io: float
    n_chips: int = 1
    extras: dict[str, float] = dataclasses.field(default_factory=dict)
    # fleet-shaped state only: per-chip vectors + host-side reductions
    per_chip: dict[str, list[float]] = dataclasses.field(default_factory=dict)
    fleet: dict[str, float] = dataclasses.field(default_factory=dict)


def _to_host(values: dict[str, Any]) -> dict[str, np.ndarray]:
    """Every tensor of `values` to numpy in ONE device-to-host copy: the
    tensors are flattened into one float64 buffer (exact for f32 and int32)
    on their device, copied once and split again. Non-tensors pass through
    numpy as they are."""
    keys = [k for k, v in values.items() if isinstance(v, torch.Tensor)]
    out = {k: np.asarray(v) for k, v in values.items() if k not in keys}
    if keys:
        flat = torch.cat([values[k].detach().reshape(-1).to(torch.float64)
                          for k in keys]).cpu().numpy()
        at = 0
        for k in keys:
            t = values[k]
            n = t.numel()
            out[k] = flat[at:at + n].reshape(tuple(t.shape)).astype(
                np.float32 if t.is_floating_point() else np.int64)
            at += n
    return out


class TelemetryLog:
    """Bounded host-side telemetry store (ring buffer)."""

    def __init__(self, capacity: int = 100_000):
        self.records: collections.deque[StepRecord] = collections.deque(
            maxlen=capacity)

    def append_from(self, step: int, loss, metrics: dict[str, Any],
                    state) -> StepRecord:
        per_chip: dict[str, list[float]] = {}
        fleet: dict[str, float] = {}

        # one device-to-host copy for everything this record needs
        host = _to_host({"loss": loss, **{f"m/{k}": v
                                          for k, v in metrics.items()},
                         **{f"s/{f}": getattr(state, f)
                            for f in _PLANE_FIELDS}})
        loss = host["loss"]
        # in sorted key order, as the reference's `jax.device_get` returns
        # the dict: the record's extras, per_chip and fleet keep its order
        metrics = {k: host[f"m/{k}"] for k in sorted(metrics)}
        state_v = {f: host[f"s/{f}"] for f in _PLANE_FIELDS}

        v_core_a = np.asarray(state_v["v_core"])
        n_chips = int(v_core_a.shape[0]) if v_core_a.ndim else 1

        def record(key: str, x) -> float | None:
            """Scalar -> float. [n_chips] -> per-chip list + max/min/mean/
            p95 reductions, returning the fleet mean as the scalar view.
            Arrays that are not `[n_chips]`-shaped are not per-chip
            telemetry -> None."""
            a = np.asarray(x)
            if a.ndim == 0:
                return float(a)
            if a.ndim == 1 and a.shape[0] == n_chips:
                af = a.astype(np.float64)
                per_chip[key] = [float(v) for v in af]
                fleet[f"{key}_max"] = float(af.max())
                fleet[f"{key}_min"] = float(af.min())
                fleet[f"{key}_mean"] = float(af.mean())
                fleet[f"{key}_p95"] = float(np.percentile(af, 95.0))
                return float(af.mean())
            return None

        core = {k: record(k, metrics.get(k, 0.0)) or 0.0 for k in _CORE_KEYS}
        rails = {f: record(f, state_v[f]) or 0.0
                 for f in ("v_core", "v_hbm", "v_io")}
        comp = np.asarray(state_v["comp_level"])
        if comp.ndim:
            per_chip["comp_level"] = [float(c) for c in comp]
            comp_level = int(comp.min())   # fleet view: most conservative chip
        else:
            comp_level = int(comp)

        extras: dict[str, float] = {}
        for k, v in metrics.items():
            if k in _CORE_KEYS or k == "loss":
                continue
            if k.startswith("fleet/"):
                fleet[k.split("/", 1)[1]] = float(np.asarray(v))
                continue
            s = record(k, v)
            if s is not None and k not in per_chip:
                extras[k] = s

        rec = StepRecord(
            step=step,
            loss=float(np.mean(np.asarray(loss))),
            grad_error=core["grad_error"],
            t_step_s=core["t_step_s"],
            power_w=core["power_w"],
            energy_step_j=core["energy_step_j"],
            comp_level=comp_level,
            v_core=rails["v_core"], v_hbm=rails["v_hbm"], v_io=rails["v_io"],
            n_chips=n_chips,
            extras=extras, per_chip=per_chip, fleet=fleet,
        )
        self.records.append(rec)
        return rec

    def totals(self) -> dict[str, float]:
        if not self.records:
            return {"steps": 0, "energy_j": 0.0, "mean_power_w": 0.0,
                    "time_s": 0.0, "fleet_energy_j": 0.0}
        # scalar fields are per-chip means, so these are per-chip totals;
        # fleet_energy_j is the whole fleet's energy (mean x n_chips).
        e = sum(r.energy_step_j for r in self.records)
        t = sum(r.t_step_s for r in self.records)
        ef = sum(r.energy_step_j * r.n_chips for r in self.records)
        return {"steps": len(self.records), "energy_j": e,
                "mean_power_w": e / max(t, 1e-12), "time_s": t,
                "fleet_energy_j": ef}

    def per_chip_series(self, key: str) -> np.ndarray:
        """[steps, n_chips] history of one per-chip metric (records lacking
        the key are skipped)."""
        rows = [r.per_chip[key] for r in self.records if key in r.per_chip]
        if not rows:
            raise KeyError(f"no per-chip telemetry recorded for {key!r}")
        return np.asarray(rows)

    def dump_jsonl(self, path: str) -> None:
        with open(path, "w") as f:
            for r in self.records:
                f.write(json.dumps(dataclasses.asdict(r)) + "\n")
