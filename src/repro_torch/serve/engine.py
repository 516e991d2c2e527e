"""Batched serving engine: prefill + greedy decode with KV caches,
power-plane energy accounting per token, and the in-graph rail controller
(port of `repro/serve/engine.py`, the `generate` path).

Fleet serving (`fleet=`): every prefill/decode step is accounted at each
chip's own process-varied operating point of a `[n_chips]` plane, and a
bare policy is wrapped in `WorstChipGate`. With `sor=` (or a controller
carrying one) each accounting step runs one learned control round: the
frame enters the SOR history, the frontier refit runs on its cadence, and
the envelope-clamped decision moves the rails.

Everything lives on the engine's device ("cuda" unless the caller asks
for the CPU). Per step the host reads back what the reference reads: the
fleet-mean energy and step time (`scalar_view`) and, with `eos_id`, the
end-of-sequence check. Routed serving (`serve_trace`, `router=`,
`batch_cap=`) and the sharded control round (`mesh=`) are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import sor as sor_mod
from repro_torch.core.control_plane import (InGraphRailController,
                                            as_controller, pinned_rails,
                                            with_sor)
from repro_torch.core.hwspec import FleetSpec
from repro_torch.core.policy import WorstChipGate
from repro_torch.core.power_plane import (PowerPlaneState, StepProfile,
                                          account_and_observe,
                                          account_fleet_and_observe,
                                          step_time_s)
from repro_torch.core.telemetry import scalar_view
from repro_torch.models import registry
from repro_torch.models.common import resolve_device


@dataclasses.dataclass
class ServeStats:
    prefill_tokens: int = 0
    decode_tokens: int = 0
    energy_j: float = 0.0          # per-chip (fleet mean) energy
    model_time_s: float = 0.0
    fleet_energy_j: float = 0.0    # whole-fleet energy (mean x n_chips)
    decode_sheds: int = 0          # decode batches deferred by admission gate
    defer_time_s: float = 0.0      # simulated time spent waiting out sheds
    sheds_by_rail: dict = dataclasses.field(default_factory=dict)
    sheds_by_reason: dict = dataclasses.field(default_factory=dict)


class ServeEngine:
    def __init__(self, cfg: ModelConfig, params, *, max_len: int,
                 batch_size: int,
                 prefill_profile: StepProfile | None = None,
                 decode_profile: StepProfile | None = None,
                 controller=None, policy=None,
                 fleet: FleetSpec | None = None,
                 sor: "sor_mod.SorConfig | None" = None,
                 admission_gate: bool = False,
                 router=None, mesh=None, batch_cap: "int | None" = None,
                 device="cuda"):
        for name, value in (("router", router), ("mesh", mesh),
                            ("batch_cap", batch_cap)):
            if value is not None:
                raise NotImplementedError(f"ServeEngine({name}=...) is not "
                                          f"yet ported")
        self.device = resolve_device(device)
        embed = params["embed"]
        if embed.device.type != self.device.type or (
                self.device.index is not None
                and embed.device.index != self.device.index):
            raise ValueError(f"params live on {embed.device}, the engine "
                             f"on {self.device}")
        self.cfg = cfg
        self.params = params
        self.api = registry.build(cfg)
        self.max_len = max_len
        self.batch_size = batch_size
        self.fleet_spec = fleet
        self.plane = (PowerPlaneState.from_fleet(fleet, self.device)
                      if fleet is not None
                      else PowerPlaneState.nominal(device=self.device))
        if controller is not None and policy is not None:
            raise ValueError("pass either controller= or policy=, not both")
        if (fleet is not None and policy is not None
                and not isinstance(policy, WorstChipGate)
                and not hasattr(policy, "control_step")):
            policy = WorstChipGate(policy)
        self.controller = as_controller(controller if controller is not None
                                        else policy)
        if sor is not None:
            if not isinstance(self.controller, InGraphRailController):
                raise ValueError("sor= needs an in-graph policy/controller")
            self.controller = with_sor(self.controller, sor)
        self._sor_state = None
        self.admission_gate = admission_gate
        self.last_shed_reason: str | None = None
        self._last_pinned_rails: list[str] = []
        self.prefill_profile = prefill_profile or StepProfile(1e9, 1e9, 0.0)
        self.decode_profile = decode_profile or StepProfile(1e8, 1e9, 0.0)
        self.stats = ServeStats()

    @property
    def n_chips(self) -> int:
        return self.plane.n_chips

    def _control_tick(self, frame) -> None:
        """One controller round on `frame`."""
        if self.controller is None:
            return
        c = self.controller
        if getattr(c, "sor", None) is not None and hasattr(
                c, "control_step_sor"):
            if self._sor_state is None:
                self._sor_state = c.init_sor(
                    self.n_chips if self.plane.is_fleet else None,
                    device=self.device)
            self.plane, self._sor_state = c.control_step_sor(
                self.plane, frame, self._sor_state)
        else:
            self.plane = c.control_step(self.plane, frame)

    def _account(self, profile: StepProfile, n: int = 1):
        for _ in range(n):
            if self.fleet_spec is not None:
                self.plane, frame, m = account_fleet_and_observe(
                    profile, self.plane, self.fleet_spec)
            else:
                self.plane, frame, m = account_and_observe(profile,
                                                           self.plane)
            # scalars pass through, [n_chips] metrics report the fleet mean
            e = scalar_view(m["energy_step_j"])
            self.stats.energy_j += e
            self.stats.fleet_energy_j += e * self.n_chips
            self.stats.model_time_s += scalar_view(m["t_step_s"])
            self._control_tick(frame)

    def _worst_chip_pinned(self) -> bool:
        """Did the latest arbitration pin any chip at any requested rail's
        envelope floor?"""
        c = self.controller
        req = getattr(c, "last_request", None) if c is not None else None
        env = getattr(c, "last_envelope", None) if c is not None else None
        if req is None:
            return False
        masks = pinned_rails(self.plane, req, envelope=env)
        rails = [r for r, m in masks.items() if m.any()]
        if not rails:
            return False
        self._last_pinned_rails = rails
        self.last_shed_reason = req.reason or "pinned-at-envelope-floor"
        return True

    def _defer_tick(self) -> None:
        """Admission shed: the batch waits out one accounted decode tick."""
        self.stats.decode_sheds += 1
        reason = self.last_shed_reason or "pinned-at-envelope-floor"
        self.stats.sheds_by_reason[reason] = (
            self.stats.sheds_by_reason.get(reason, 0) + 1)
        for rail in self._last_pinned_rails:
            self.stats.sheds_by_rail[rail] = (
                self.stats.sheds_by_rail.get(rail, 0) + 1)
        self.stats.defer_time_s += scalar_view(
            step_time_s(self.decode_profile, self.plane))
        self._account(self.decode_profile)

    def _greedy(self, logits) -> torch.Tensor:
        return logits[:, -1, : self.cfg.vocab_size].argmax(dim=-1).to(
            torch.int32)[:, None]

    @torch.no_grad()
    def generate(self, prompts: np.ndarray, max_new_tokens: int,
                 eos_id: int | None = None) -> np.ndarray:
        """prompts [B, Tp] int32 -> generated [B, max_new_tokens]."""
        B, Tp = prompts.shape
        if B != self.batch_size:
            raise ValueError(f"batch {B} != engine batch_size "
                             f"{self.batch_size}")
        toks = torch.as_tensor(np.asarray(prompts, np.int32)).to(self.device)

        logits, cache, _ = self.api.prefill_fn(self.params, toks,
                                               self.max_len)
        self._account(self.prefill_profile)
        self.stats.prefill_tokens += B * Tp
        out = [self._greedy(logits)]
        cur_index = Tp
        for _ in range(max_new_tokens - 1):
            if self.admission_gate and self._worst_chip_pinned():
                self._defer_tick()
            logits, cache = self.api.decode_fn(
                self.params, cache, {"tokens": out[-1],
                                     "cur_index": cur_index})
            self._account(self.decode_profile)
            self.stats.decode_tokens += B
            nxt = self._greedy(logits)
            out.append(nxt)
            cur_index += 1
            if eos_id is not None and bool((nxt == eos_id).all()):
                break
        return torch.cat(out, dim=1).cpu().numpy()

    def summary(self) -> dict[str, Any]:
        toks = max(self.stats.decode_tokens, 1)
        out = {
            "prefill_tokens": self.stats.prefill_tokens,
            "decode_tokens": self.stats.decode_tokens,
            "energy_j": self.stats.energy_j,
            "model_time_s": self.stats.model_time_s,
            "v_core": scalar_view(self.plane.v_core),
            "v_io": scalar_view(self.plane.v_io),
            "n_chips": self.n_chips,
        }
        if self.plane.is_fleet:
            out["fleet_energy_j"] = self.stats.fleet_energy_j
            out["fleet_j_per_decoded_token"] = (
                self.stats.fleet_energy_j / toks)
            out["v_core_min"] = float(self.plane.v_core.min())
            out["v_io_min"] = float(self.plane.v_io.min())
            out["comp_level_min"] = int(self.plane.comp_level.min())
        else:
            out["j_per_decoded_token"] = self.stats.energy_j / toks
        if self.admission_gate:
            out["decode_sheds"] = self.stats.decode_sheds
            out["defer_time_s"] = self.stats.defer_time_s
            out["decode_sheds_by_rail"] = dict(self.stats.sheds_by_rail)
            out["decode_sheds_by_reason"] = dict(self.stats.sheds_by_reason)
            if self.last_shed_reason is not None:
                out["shed_reason"] = self.last_shed_reason
        if self._sor_state is not None:
            out["sor"] = sor_mod.summary(self._sor_state.estimate,
                                         self.controller.sor)
        return out
