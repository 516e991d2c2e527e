"""Trainer (port of `repro/train/trainer.py`): the step loop with
checkpoints on a cadence and restart, simulated node-failure recovery,
injected straggler events with deadline-based mitigation (host numpy rng,
the same draws as the reference), host-path power control, the telemetry
log and the SOR summary.

One host sync per step: the loss is read back (as the reference blocks on
it) and the step's wall time taken after it; the telemetry record then
costs one more device-to-host copy of an already-finished step. A host
controller (`TrainerConfig.controller`) runs one `control_step` between
steps and reads the plane back itself.

Checkpoints (`checkpoint/ckpt.py`, the reference's layout) are written
only when `TrainerConfig.ckpt_dir` names a directory; the reference
defaults to `/tmp/repro_ckpt`. Given one, the cadence is the reference's:
after every `ckpt_every`-th step and after the last. A restore writes into
the live state's tensors.

The node failure is drawn BEFORE the step runs, where the reference draws
it after the step and drops the step's result: the port's step updates
the parameters, the moments and the residuals in place, so a failure
drawn after it could not be undone. The draws depend on nothing the step
computes, so the fail draw before the step and the straggler draw after
it give the reference's sequence of events. As in the reference, a
failure with no checkpoint to go back to restarts the span at the step it
started from, with the state as it stands, so the log repeats those
steps.

With `TrainerConfig.mesh` (the chips mesh of a sharded fleet step,
`train.step.FleetStepConfig(mesh=)`) the per-chip groups (plane, SOR
state) are this rank's block of chips: a checkpoint gathers them and rank
0 writes the reference's layout (`CheckpointManager.save(mesh=)`), and a
restore reads the whole state, remaps it to the run's fleet and takes the
rank's block again (`train.step.shard_fleet_state`). Every rank runs the
same loop, so the fault draws, the restarts and the checkpoint cadence
are the same on each.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import numpy as np

from repro_torch.checkpoint.ckpt import (CheckpointManager, remap_plane,
                                         remap_sor)
from repro_torch.core import ecollectives
from repro_torch.core import sor as sor_mod
from repro_torch.core.control_plane import as_controller, sor_summary_of
from repro_torch.core.hwspec import FleetSpec
from repro_torch.core.power_plane import PowerPlaneState
from repro_torch.core.telemetry import TelemetryLog
from repro_torch.models.common import resolve_device
from repro_torch.models.lm import tree_leaves


class SimulatedNodeFailure(RuntimeError):
    """An injected node loss (`FaultConfig.fail_prob`); `Trainer.run`
    recovers from it."""


@dataclasses.dataclass
class FaultConfig:
    fail_prob: float = 0.0           # per-step probability of a node loss
    straggler_prob: float = 0.0      # per-step probability of a slow node
    straggler_factor: float = 4.0    # slow node runs this much slower
    grace: float = 1.5               # deadline = grace * median step time
    seed: int = 0


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int
    ckpt_every: int = 50
    # None writes no checkpoint (the reference defaults to a /tmp path)
    ckpt_dir: "str | None" = None
    async_ckpt: bool = True
    # host-path (SW analogue) control plane: a controller, or a bare Policy
    # (wrapped into a decide-only HostDecisionController); pass a
    # HostRailController to also pay PMBus actuation. The in-graph path is
    # configured on the step (StepConfig.policy).
    controller: Any = None
    faults: FaultConfig = dataclasses.field(default_factory=FaultConfig)
    # fleet provenance: checkpointed beside the plane, so a restart onto a
    # fleet of another size remaps per-chip state explicitly
    fleet: "FleetSpec | None" = None
    # the SorConfig the train step was built with (FleetStepConfig.sor):
    # with it (and init_state["sor"]) the trainer threads the SorState
    # through the 6-arg step and folds the learned view into summary()
    sor: Any = None
    # the chips mesh of a sharded fleet step: restored per-chip state
    # (plane, SorState) is re-sliced onto it after a restore or a remap,
    # and checkpoints gather it first
    mesh: Any = None
    shard_axis: str = "chips"
    device: Any = "cuda"

    def __post_init__(self):
        self.controller = as_controller(self.controller, host=True)


class Trainer:
    def __init__(self, train_step: Callable, data, cfg: TrainerConfig,
                 init_state: dict[str, Any]):
        """init_state: {'params', 'opt', 'plane', 'ef'} (+ 'sor'), on
        `cfg.device`; data: a `SyntheticLM` (its `torch_batch`)."""
        self.device = resolve_device(cfg.device)
        plane = init_state["plane"]
        if plane.device.type != self.device.type:
            raise ValueError(f"the state lives on {plane.device}, the "
                             f"trainer on {self.device}")
        self.train_step = train_step
        self.data = data
        self.cfg = cfg
        self.state = dict(init_state)
        self.ckpt = (CheckpointManager(cfg.ckpt_dir,
                                       async_save=cfg.async_ckpt)
                     if cfg.ckpt_dir is not None else None)
        self.log = TelemetryLog()
        self.start_step = 0
        self.restarts = 0
        self.straggler_events = 0
        self.ckpt_writes = 0
        self._rng = np.random.default_rng(cfg.faults.seed)
        self._step_times: list[float] = []
        ss = self.state.get("sor")
        if (cfg.sor is None) != (ss is None):
            raise ValueError(
                "TrainerConfig.sor and init_state['sor'] must be set "
                "together: the SOR train step (FleetStepConfig.sor) takes "
                "the 6-arg signature and threads the state the trainer "
                "carries — configure both or neither")
        if ss is not None and ss.history.rails != cfg.sor.rails:
            raise ValueError(
                f"TrainerConfig.sor declares rails "
                f"{[s.rail for s in cfg.sor.rails]} but init_state['sor'] "
                f"was built with {[s.rail for s in ss.history.rails]}; "
                f"pass the same SorConfig as FleetStepConfig.sor")

    @property
    def step_times(self) -> list[float]:
        """Host wall seconds of each step run so far (after the loss sync,
        with injected straggler time)."""
        return list(self._step_times)

    # -- checkpoint/restart ----------------------------------------------------
    def maybe_restore(self) -> bool:
        """Restore the latest complete checkpoint, if there is one, into
        the live state and continue from its step."""
        if self.ckpt is None or self.ckpt.latest_step() is None:
            return False
        self.start_step = self._restore()
        return True

    def _restore(self) -> int:
        step, restored = self.ckpt.restore(self.state, optional=("sor",))
        self.state.update(restored)
        self._remap_restored_plane()
        if self.cfg.mesh is not None:
            # take this rank's block of the (whole, remapped) per-chip
            # state again before the next sharded step
            from repro_torch.train.step import shard_fleet_state
            self.state = shard_fleet_state(self.state, self.cfg.mesh,
                                           self.cfg.shard_axis)
        return step

    def _remap_restored_plane(self) -> None:
        """Elastic fleet restore: when this run's FleetSpec differs in size
        from the checkpoint's, remap the restored plane (and SorState) onto
        the current fleet explicitly: survivors keep their per-chip state,
        joiners start at their own nominal point and the cold-start pin."""
        if self.cfg.fleet is None:
            return
        n_target = self.cfg.fleet.n_chips
        plane = self.state["plane"]
        if not (plane.is_fleet and plane.n_chips == n_target):
            self.state["plane"] = remap_plane(plane, self.cfg.fleet)
        ss = self.state.get("sor")
        if ss is not None and ss.history.chip_shape \
                and ss.history.chip_shape[0] != n_target:
            self.state["sor"] = remap_sor(ss, self.cfg.fleet)

    def _save(self, step: int):
        self.ckpt.save(step, self.state, fleet=self.cfg.fleet,
                       mesh=self.cfg.mesh, axis_name=self.cfg.shard_axis)
        self.ckpt_writes += 1

    # -- fault injection ---------------------------------------------------------
    def _inject_failure(self, step: int) -> None:
        """The fail draw of `step`, made before the step runs."""
        f = self.cfg.faults
        if f.fail_prob and self._rng.random() < f.fail_prob:
            raise SimulatedNodeFailure(f"node lost at step {step}")

    def _inject_straggler(self, t_step: float) -> float:
        f = self.cfg.faults
        if f.straggler_prob and self._rng.random() < f.straggler_prob:
            # a straggling node would stretch the step by straggler_factor;
            # deadline-based mitigation caps the damage at grace * median
            # (the median skips the first step and uses a recent window)
            recent = self._step_times[1:][-20:]
            med = float(np.median(recent)) if recent else t_step
            slow = t_step * f.straggler_factor
            mitigated = min(slow, med * f.grace)
            self.straggler_events += 1
            return mitigated
        return t_step

    # -- the loop -----------------------------------------------------------------
    def run(self) -> TelemetryLog:
        step = self.start_step
        while step < self.cfg.total_steps:
            try:
                step = self._run_span(step)
            except SimulatedNodeFailure:
                # recovery: reload the last complete checkpoint and resume
                # (the data pipeline is stateless in step); without one,
                # restart the span from the in-memory state
                self.restarts += 1
                if self.ckpt is not None:
                    self.ckpt.wait()
                    if self.ckpt.latest_step() is not None:
                        step = self._restore()
        if self.ckpt is not None:
            self.ckpt.wait()
        return self.log

    def _run_span(self, step: int) -> int:
        cfg = self.cfg
        while step < cfg.total_steps:
            self._inject_failure(step)
            batch = self.data.torch_batch(step, self.device)
            t0 = time.perf_counter()
            if "sor" in self.state:
                params, opt, plane, ef, sor_state, metrics = self.train_step(
                    self.state["params"], self.state["opt"],
                    self.state["plane"], self.state["ef"],
                    self.state["sor"], batch)
            else:
                sor_state = None
                params, opt, plane, ef, metrics = self.train_step(
                    self.state["params"], self.state["opt"],
                    self.state["plane"], self.state["ef"], batch)
            metrics["loss"].item()     # the step's one host sync
            wall = time.perf_counter() - t0
            wall = self._inject_straggler(wall)
            self._step_times.append(wall)

            self.state.update(params=params, opt=opt, plane=plane, ef=ef)
            if sor_state is not None:
                self.state["sor"] = sor_state
            # host-path control (SW analogue): decide + PMBus-actuate
            if cfg.controller is not None:
                self.state["plane"] = cfg.controller.control_step(
                    plane, metrics)
                metrics = self._with_sor_metrics(metrics)
            self.log.append_from(step, metrics["loss"], metrics,
                                 self.state["plane"])
            step += 1
            if self.ckpt is not None and (step % cfg.ckpt_every == 0
                                          or step == cfg.total_steps):
                self._save(step)
        return step

    def _with_sor_metrics(self, metrics: dict[str, Any]) -> dict[str, Any]:
        """Fold the host controller's learned safe-operating-region view
        into the step telemetry as `sor/...` scalar keys."""
        s = sor_summary_of(self.cfg.controller)
        if not s:
            return metrics
        return {**metrics,
                **{f"sor/{k}": float(v) for k, v in s.items()
                   if np.isfinite(v)}}

    # -- reporting -------------------------------------------------------------
    def summary(self) -> dict[str, Any]:
        t = self.log.totals()
        ctrl = (self.cfg.controller.stats() if self.cfg.controller is not None
                else None)
        out = {
            **t,
            "restarts": self.restarts,
            "straggler_events": self.straggler_events,
            "ckpt_writes": self.ckpt_writes,
            "host_actuations": ctrl.actuations if ctrl else 0,
            "host_actuation_s": ctrl.actuation_seconds if ctrl else 0.0,
            "host_skipped_actuations": ctrl.skipped_actuations if ctrl else 0,
            "mean_wall_step_s": float(np.mean(self._step_times))
            if self._step_times else 0.0,
        }
        if self.log.records:
            last = self.log.records[-1]
            out["n_chips"] = last.n_chips
            if last.fleet:   # fleet run: surface the gating worst-chip view
                out["fleet_last"] = dict(last.fleet)
        sor = sor_summary_of(self.cfg.controller)
        if sor is None and self.cfg.sor is not None \
                and self.state.get("sor") is not None:
            # in-graph learner: summarize the state threaded through the step
            sor = sor_mod.summary(self.state["sor"].estimate, self.cfg.sor)
        if sor:
            out["sor"] = sor
        return out


def initial_plane_and_ef(params, fleet: FleetSpec | None = None
                         ) -> tuple[PowerPlaneState, Any]:
    """Initial (plane, error-feedback residuals) on the parameters'
    device. With a `FleetSpec`, the plane is `[n_chips]` with every chip at
    its own process-varied nominal point (pair with
    `train.step.make_fleet_train_step`)."""
    dev = next(tree_leaves(params)).device
    plane = (PowerPlaneState.from_fleet(fleet, dev) if fleet is not None
             else PowerPlaneState.nominal(device=dev))
    return plane, ecollectives.zeros_like_residuals(params)
