"""Batched serving engine: prefill + greedy decode with KV caches,
power-plane energy accounting per token, and the in-graph rail controller
(port of `repro/serve/engine.py`, the `generate` path).

Fleet serving (`fleet=`): every prefill/decode step is accounted at each
chip's own process-varied operating point of a `[n_chips]` plane, and a
bare policy is wrapped in `WorstChipGate`. With `sor=` (or a controller
carrying one) each accounting step runs one learned control round: the
frame enters the SOR history, the frontier refit runs on its cadence, and
the envelope-clamped decision moves the rails.

A host controller (`control_plane.HostRailController`, the SW-path
analogue) runs through its `control_step` after each accounting step: it
decides between steps and actuates the simulated PMBus fleet; with its own
`sor=` it learns from its READ_VOUT polls.

Everything lives on the engine's device ("cuda" unless the caller asks
for the CPU). Per step the host reads back what the reference reads: the
fleet-mean energy and step time (`scalar_view`) and, with `eos_id`, the
end-of-sequence check (a host controller adds its own reads of the
plane).

Routed serving (`router=`, `serve_trace`): a seeded traffic trace is
placed over the fleet by per-rail voltage headroom (`serve/router.py`) in
simulated time, no model forward. The fused path runs one tick function a
tick (accounting, the caller's observables, the control round, the
busy/idle energy rescale, the rate and over-bound flags), eager tensor code
whose one device-to-host copy is the packed bundle and whose one
host-to-device copy is the tick's busy fraction; slot bookkeeping is numpy
over `[n_chips, capacity]` lanes. The per-tick host loop is kept as the
oracle the fused path is held against, and is the only path a
`HostRailController` runs. `batch_cap=` makes each chip a continuous decode
batch over its lanes; `migrate_after_ticks=` moves resident decode lanes
off chips that stay pinned or over the error bound.

The sharded control round (`mesh=`, a 1-D `chips` mesh over a
`torch.distributed` world; `shard_control` as the reference's): every rank
builds the same engine, and the fused `serve_trace` runs on its block of
chips (`ops.chip_block`, `engine.chip_block`): the plane, the SOR state
and the FleetSpec's block go to the rank at the trace's start
(`ops.shard_chip_tree`), the tick function runs the sharded round
(`control_plane.sharded_control_round`) on the block, and the caller's
`observe` sees the block (its plane, frame and busy fraction are
`[n/P]`). The host bookkeeping (placement, migration, the SLO ledger)
needs the whole fleet: each rank makes the tick's one device-to-host copy
of its block's bundle, and the ranks exchange those host bundles with one
`all_gather` over a gloo group (`ops.host_group`), so every rank runs the
same host loop on the same numbers and places alike. The busy fraction's
host-to-device copy takes the rank's slice. A tick on a rank is then:
its kernels, two scalar `all_reduce`s of the confidence (through the host
under gloo), the bundle's copy, the host `all_gather` and the busy
fraction's copy. After such a trace the engine holds its block;
`summary()` gathers the plane and the SOR estimate (a collective), and
`generate` and the loop path refuse a sharded state.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import sor as sor_mod
from repro_torch.core.control_plane import (RAIL_LANES,
                                            InGraphRailController,
                                            _run_policy, as_controller,
                                            pinned_lane_masks, pinned_rails,
                                            rail_floors,
                                            sharded_control_round,
                                            sor_summary_of, with_sor)
from repro_torch.core.hwspec import FleetSpec
from repro_torch.core.policy import WorstChipGate
from repro_torch.core.power_plane import (BatchShares, PowerPlaneState,
                                          StepProfile, _f32,
                                          account_and_observe,
                                          account_fleet_and_observe,
                                          as_f32, batched_lane_time_s,
                                          chip_power_w, fleet_variation,
                                          step_time_s)
from repro_torch.core.rails import TPU_V5E_RAIL_MAP
from repro_torch.core.telemetry import scalar_view
from repro_torch.kernels import ops
from repro_torch.models import registry
from repro_torch.models.common import resolve_device

# the per-rail failure observables a routed tick reads back (the over-bound
# goodput-degrade signal): the caller's observe() extras and grad_error
_OBS_KEYS = ("grad_error", "straggle_rate", "hbm_error_rate")


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
                 router=None, mesh=None,
                 shard_control: "bool | None" = None,
                 batch_cap: "int | None" = None,
                 batch_shares: "BatchShares | None" = None,
                 device="cuda"):
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
                raise ValueError("sor= needs an in-graph policy/controller "
                                 "(the serve loop threads SorState through "
                                 "InGraphRailController.control_step_sor); "
                                 "for a HostRailController pass sor= to the "
                                 "controller itself")
            self.controller = with_sor(self.controller, sor)
        self._sor_state = None
        self.admission_gate = admission_gate
        self.last_shed_reason: str | None = None
        self._last_pinned_rails: list[str] = []
        # headroom-aware placement (serve/router.py): serve_trace() routes a
        # traffic trace over the fleet by per-rail voltage headroom
        self.router = router
        if router is not None and fleet is None:
            raise ValueError("router= places work across a fleet; pass "
                             "fleet=FleetSpec (n_chips=1 degenerates to the "
                             "plain engine)")
        self.last_trace: dict | None = None
        # continuous batching: batch_cap=B makes each chip a token-level
        # decode batch over its B resident lanes (the lanes are the
        # router's slots, so the cap equals the router's capacity); None
        # keeps the full-rate-per-slot model, and batch_cap=1 is exactly
        # that model (the rate is bitwise the base model at b=1), so both
        # build the unbatched tick
        if batch_cap is not None:
            if router is None:
                raise ValueError("batch_cap batches a chip's resident "
                                 "lanes; pass router= (the lanes are the "
                                 "router's slots)")
            if batch_cap < 1:
                raise ValueError(f"batch_cap must be >= 1, got {batch_cap}")
            if batch_cap != router.capacity:
                raise ValueError(
                    f"batch_cap={batch_cap} must equal the router's "
                    f"capacity ({router.capacity}) — lanes are the "
                    f"router's slots, one number describes both")
        self.batch_cap = batch_cap
        self.batch_shares = batch_shares or BatchShares()
        self._batched = batch_cap is not None and batch_cap > 1
        if batch_shares is not None and batch_cap is None:
            raise ValueError("batch_shares= tunes the batched rate model; "
                             "pass batch_cap= as well")
        self.prefill_profile = prefill_profile or StepProfile(1e9, 1e9, 0.0)
        self.decode_profile = decode_profile or StepProfile(1e8, 1e9, 0.0)
        self.stats = ServeStats()
        # fleet-scale serving: `mesh=` (a 1-D chips mesh) runs the fused
        # tick's learned round sharded over the mesh's ranks (module
        # docstring); `shard_control` None enables it when the mesh spans
        # more than one rank, True forces it on a one-rank mesh (the
        # bit-equality pin), False leaves a supplied mesh unused
        self.mesh = mesh
        if shard_control is None:
            shard_control = mesh is not None and mesh.size() > 1
        if shard_control:
            if mesh is None:
                raise ValueError("shard_control=True needs a mesh")
            if fleet is None:
                raise ValueError("mesh= shards the [n_chips] serve plane; "
                                 "pass fleet=FleetSpec")
            if not (isinstance(self.controller, InGraphRailController)
                    and self.controller.sor is not None):
                raise ValueError(
                    "mesh= shards the in-tick learned control round; build "
                    "the engine with an in-graph controller carrying "
                    "sor=SorConfig(...) (cross-chip policies are rejected "
                    "— their fleet reduction would only see one shard)")
            if fleet.n_chips % mesh.size():
                raise ValueError(
                    f"n_chips={fleet.n_chips} is not divisible by the mesh "
                    f"size {mesh.size()}")
            self._sharded_round = sharded_control_round(self.controller,
                                                        mesh)
            self.chip_block = ops.chip_block(mesh, fleet.n_chips)
            self._host_group = ops.host_group(mesh)
        else:
            self._sharded_round = None
            self.chip_block = None
        self.shard_control = bool(shard_control)
        self._sharded_state = False   # plane and SOR state are the block
        self._tick_cache: dict = {}   # (observe id, tick_s, bound) -> tick

    @property
    def n_chips(self) -> int:
        if self._sharded_state:
            return self.fleet_spec.n_chips
        return self.plane.n_chips

    def _refuse_sharded(self, what: str) -> None:
        if self._sharded_state:
            raise ValueError(
                f"{what} needs the whole plane; this engine holds its "
                f"rank's block of chips after a sharded serve_trace")

    def _shard_state(self) -> None:
        """This rank's block of the plane and the SOR state (once)."""
        if self._sharded_state:
            return
        n = self.fleet_spec.n_chips
        self.plane = ops.shard_chip_tree(self.plane, self.mesh, n)
        if self._sor_state is not None:
            self._sor_state = ops.shard_chip_tree(self._sor_state,
                                                  self.mesh, n)
        self._sharded_state = True

    def _whole(self, tree, n_block: int):
        """The whole fleet's tree from every rank's block (a collective);
        the tree itself when the engine is not sharded."""
        if not self._sharded_state:
            return tree
        return ops.gather_chip_tree(tree, self.mesh, n_block)

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
        self._refuse_sharded("generate")
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
        if self.api.prefill_fn is None:
            raise NotImplementedError(
                f"{self.cfg.family} serving has no prefill: drive "
                f"`registry.build(cfg).decode_fn` with the encoder's "
                f"`cross_kv` (`models/encdec.py`)")
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

    # -- routed serving ------------------------------------------------------

    def serve_trace(self, trace, *, max_ticks: int = 20_000,
                    observe=None, tick_s: "float | None" = None,
                    error_bound: float = 5e-3, degrade: float = 0.5,
                    prefill_speedup: float = 8.0,
                    fused: "bool | None" = None,
                    fast_forward: bool = False,
                    migrate_after_ticks: "int | None" = None,
                    migrate_stall_s_per_token: float = 1e-3):
        """Route a seeded traffic trace (`serve/traffic.py`) over the fleet
        and return the per-request SLO ledger (`serve/router.py`).

        A modeled continuous-batching loop in simulated time; no model
        forward runs. Each tick:

        1. arrivals with `t_arrival_s <= now` join the FIFO queue;
        2. the fleet is accounted (`account_fleet_and_observe`) and the
           caller's `observe(plane, frame, tick, busy_frac)` overlays the
           per-rail failure observables;
        3. the controller runs one round (SOR learning included);
        4. per-rail headroom and the pinned-chip drain mask feed the
           router, which places queued requests head-of-line FIFO (a
           request it cannot place defers: reason `capacity` when every
           slot is full, `pinned-drain` when only pinned chips had room);
        5. resident requests progress at their chip's modeled rate
           (`tick_s / t_step_chip` decode tokens a tick, prefill
           `prefill_speedup` x faster); a chip whose observables sit over
           `error_bound` delivers `degrade` of its rate;
        6. energy is accounted busy/idle-blended per chip into the ledger
           and the engine stats, each resident request charged its share
           of its chip's busy energy.

        `fused=None` resolves to the fused tick for in-graph controllers
        (and controller-less engines) and to the per-tick host loop for a
        host-actuated controller; `fused=False` forces the loop, the oracle
        the fused ledger is held against. `fast_forward=True` (fused only)
        jumps simulated time to the next arrival while the fleet is idle
        and the queue empty; the skipped ticks run no accounting and no
        control round. `migrate_after_ticks=K` (fused, headroom router)
        moves a chip's resident decode lanes after its pinned/over flag
        held K consecutive ticks, each paying a KV-transfer stall of
        `migrate_stall_s_per_token` per token processed so far. `tick_s`
        defaults to the fleet-mean decode step time at the current
        operating point. Deterministic given (trace, observe, controller):
        ties break on the lowest chip index."""
        if self.router is None:
            raise ValueError("serve_trace needs the engine built with "
                             "router= (HeadroomRouter or RoundRobinRouter)")
        if self.fleet_spec is None:
            raise ValueError("serve_trace routes over a fleet plane; pass "
                             "fleet=FleetSpec")
        from repro_torch.serve.router import RequestLedger
        # routers carry placement state (the round-robin cursor): reset it
        # so back-to-back traces on one engine place identically
        reset = getattr(self.router, "reset", None)
        if callable(reset):
            reset()
        if fused is None:
            fused = (self.controller is None
                     or isinstance(self.controller, InGraphRailController))
        if fused and self.controller is not None and not isinstance(
                self.controller, InGraphRailController):
            raise ValueError(
                "fused=True runs the control round inside the serve "
                "tick; a host-actuated controller (PMBus path) needs "
                "fused=False")
        if fast_forward and not fused:
            raise ValueError("fast_forward rides the fused tick path; "
                             "drop fused=False (or the host controller)")
        if self._batched and not fused:
            raise ValueError(
                "continuous batching (batch_cap >= 2) rides the fused "
                "tick path — the loop path is kept as the batch-cap=1 "
                "semantics oracle; drop fused=False")
        if migrate_after_ticks is not None:
            if migrate_after_ticks < 1:
                raise ValueError(f"migrate_after_ticks must be >= 1, got "
                                 f"{migrate_after_ticks}")
            if not fused:
                raise ValueError("migration rides the fused tick path; "
                                 "drop fused=False")
            if not callable(getattr(self.router, "plan_migration", None)):
                raise ValueError(
                    "migrate_after_ticks needs a router with a migration "
                    "planner (HeadroomRouter.plan_migration) — the "
                    "round-robin baseline is headroom-blind and cannot "
                    "pick destinations")
        if self._sharded_round is not None and not fused:
            raise ValueError("the sharded control round (mesh=) rides the "
                             "fused tick path; drop fused=False")
        if tick_s is None:
            tick_s = float(scalar_view(step_time_s(
                self.decode_profile,
                self._whole(self.plane, self.plane.n_chips))))
        ledger = RequestLedger()
        arrivals = sorted(trace, key=lambda r: (r.t_arrival_s, r.rid))
        kw = dict(max_ticks=max_ticks, observe=observe, tick_s=tick_s,
                  error_bound=error_bound, degrade=degrade,
                  prefill_speedup=prefill_speedup)
        if fused:
            return self._serve_trace_fused(
                arrivals, ledger, fast_forward=fast_forward,
                migrate_after_ticks=migrate_after_ticks,
                migrate_stall_s_per_token=migrate_stall_s_per_token, **kw)
        return self._serve_trace_loop(arrivals, ledger, **kw)

    # -- fused path: one tick function a tick, vectorized host bookkeeping --

    def _serve_tick_jit(self, observe, tick_s: float, error_bound: float):
        """The cached tick function for this (observe, tick_s, error_bound)
        world (the reference jits it under this name; here it is built
        once, with the fleet's variation on the device, and reused)."""
        key = (id(observe), float(tick_s), float(error_bound))
        fn = self._tick_cache.get(key)
        if fn is None:
            fn = self._build_serve_tick(observe, tick_s, error_bound)
            self._tick_cache[key] = fn
        return fn

    def _build_serve_tick(self, observe, tick_s: float, error_bound: float):
        """One serve tick as eager tensor code: accounting -> observe
        overlay -> control round -> busy/idle energy rescale -> per-chip
        rate and over-bound flags. Returns `tick(plane, sor_state,
        busy_frac, tick) -> (plane', sor_state', bundle, request, env)`
        where `bundle` is the packed `[13, n_chips]` f32 tensor: rows 0-3
        `e_tick`, `e_busy`, `t_step`, `over`; rows 4-6 the per-rail
        floors; rows 7-9 the per-rail headroom; rows 10-12 the per-rail
        pinned masks (`RAIL_LANES` order). A batching engine (`batch_cap
        >= 2`) grows it to `[15, n_chips]`: row 13 the batch depth the rate
        was computed at (`max(round(busy_frac * batch_cap), 1)`) and row
        14 the batched per-lane step time (`batched_lane_time_s`). The
        tick reads nothing back from the device: its caller copies the
        bundle to the host once. The fleet's variation is built on the
        device here, once per tick function."""
        sharded = self._sharded_round
        spec = (ops.shard_chip_tree(self.fleet_spec, self.mesh,
                                    self.fleet_spec.n_chips)
                if sharded is not None else self.fleet_spec)
        dev = self.device
        variation = fleet_variation(spec, dev)
        profile = self.decode_profile
        c = self.controller
        n = spec.n_chips
        rail_map = (getattr(c, "rail_map", TPU_V5E_RAIL_MAP)
                    if c is not None else TPU_V5E_RAIL_MAP)
        use_sor = (c is not None and getattr(c, "sor", None) is not None
                   and hasattr(c, "control_step_sor"))
        ts = _f32(tick_s)
        bound = _f32(error_bound)
        batched = self._batched
        cap = float(self.batch_cap) if batched else None
        shares = self.batch_shares

        def _b(x):
            return torch.atleast_1d(as_f32(x, dev)).expand(n)

        def tick(plane, sor_state, busy_frac, tick_idx):
            plane, frame, m = account_fleet_and_observe(
                profile, plane, spec, variation=variation)
            if observe is not None:
                frame = observe(plane, frame, tick_idx, busy_frac)
            request = env = None
            if c is None:
                pass
            elif sharded is not None:
                # the rank's block through the sharded round: the request
                # and envelopes it arbitrated with feed the bundle's rows
                plane, sor_state, _sum, _min, request, env = sharded(
                    plane, frame, sor_state, with_request=True)
            elif use_sor:
                plane, sor_state, request, env = c.control_round(
                    plane, frame, sor_state)
            else:
                plane, request = _run_policy(c.policy, plane, frame,
                                             rail_map)
            # busy/idle-blended energy: accounting assumed every chip fully
            # busy; rescale to this tick's occupancy (idle slots burn
            # static and uncore power only) and rewrite the accumulator
            p_busy = m["power_w"]
            p_idle = chip_power_w(plane, 0.0, 0.0, 0.0, spec.base,
                                  variation=variation)
            p_eff = p_idle + (p_busy - p_idle) * busy_frac
            e_tick = p_eff * ts
            plane = dataclasses.replace(
                plane, energy_j=plane.energy_j - m["energy_step_j"]
                + e_tick)
            over = torch.zeros(n, dtype=torch.bool, device=dev)
            for key in _OBS_KEYS:
                v = frame.get(key)
                if v is None:
                    continue
                a = _b(v)
                over = over | (~torch.isnan(a) & (a > bound))
            floors = rail_floors(plane, env, rail_map)
            held = torch.stack([_b(getattr(plane, f))
                                for f in ("v_core", "v_hbm", "v_io")])
            pinned = pinned_lane_masks(plane, request, rail_map,
                                       envelope=env)
            rows = [
                torch.stack([_b(e_tick), _b((p_eff - p_idle) * ts),
                             _b(m["t_step_s"]), over.to(torch.float32)]),
                floors,
                held - floors,
                pinned.to(torch.float32),
            ]
            if batched:
                # the batch depth from the busy fraction (occ / cap is
                # exact in f32 for occ <= cap; round removes the dust) and
                # the shared-roofline per-lane step time it implies
                b_eff = torch.clamp(torch.round(_b(busy_frac) * cap),
                                    min=1.0)
                t_lane = batched_lane_time_s(
                    _b(m["t_comp_s"]), _b(m["t_mem_s"]), _b(m["t_coll_s"]),
                    b_eff, shares)
                rows.append(torch.stack([b_eff, t_lane]))
            return plane, sor_state, torch.cat(rows), request, env

        return tick

    def _serve_trace_fused(self, arrivals, ledger, *, max_ticks, observe,
                           tick_s, error_bound, degrade, prefill_speedup,
                           fast_forward, migrate_after_ticks=None,
                           migrate_stall_s_per_token=1e-3):
        """The fused serve loop: a tick is one call of the tick function,
        one host-to-device copy (the busy fraction) and one device-to-host
        copy (the bundle); slot progress and finish bookkeeping run as
        numpy `[n_chips, capacity]` lane arrays. A batching engine reads
        its per-lane rate from the bundle's grown rows; migration (when
        armed) re-places decode-phase lanes off chips whose pinned/over
        flag held K ticks, before placement sees the tick's queue."""
        from repro_torch.serve.router import headroom_from_packed
        n = self.n_chips
        cap = self.router.capacity
        c = self.controller
        use_sor = (c is not None and getattr(c, "sor", None) is not None
                   and hasattr(c, "control_step_sor"))
        if use_sor and self._sor_state is None:
            self._sor_state = c.init_sor(n if self.plane.is_fleet else None,
                                         device=self.device)
        lo, hi = 0, n
        if self._sharded_round is not None:
            self._shard_state()
            lo, hi = self.chip_block
        tick_fn = self._serve_tick_jit(observe, tick_s, error_bound)

        n_req = len(arrivals)
        arr_t = np.asarray([r.t_arrival_s for r in arrivals], np.float64)
        req_prefill = np.asarray([r.prefill_tokens for r in arrivals],
                                 np.int64)
        req_decode = np.asarray([r.decode_tokens for r in arrivals],
                                np.int64)
        # per-request busy-energy accumulator, charged to the ledger once
        # at trace end: one float64 add per resident tick in tick order,
        # float-equal to the loop path's per-tick ledger.charge
        energy_acc = np.zeros(n_req, np.float64)
        charged = np.zeros(n_req, bool)

        slot_req = np.full((n, cap), -1, np.int64)   # arrival index; -1 free
        slot_prefill = np.zeros((n, cap), np.float64)
        slot_decode = np.zeros((n, cap), np.float64)
        # KV-transfer stall left per lane (seconds): a migrated lane
        # occupies its destination but makes no progress until it drains
        slot_stall = np.zeros((n, cap), np.float64)
        migrating = migrate_after_ticks is not None
        streak = np.zeros(n, np.int64)   # consecutive pinned/over ticks
        n_migrations = 0

        pending: collections.deque = collections.deque()  # arrival indices
        ai = 0
        t = 0.0
        max_occ = 0
        degraded_ticks = 0
        resident_degraded_ticks = 0
        ticks_run = 0
        ff_ticks = 0
        # the busy fraction goes to the card from one pinned buffer without
        # a stream sync; the buffer is rewritten only after the bundle's
        # read has synchronized the stream, so the last copy has landed
        on_card = self.device.type == "cuda"
        busy_host = torch.empty(hi - lo, dtype=torch.float32,
                                pin_memory=on_card)

        for tick in range(max_ticks):
            active = slot_req >= 0
            resident = bool(active.any())
            if ai >= n_req and not pending and not resident:
                break
            if (fast_forward and not pending and not resident
                    and ai < n_req and arr_t[ai] > t):
                # idle fleet, empty queue: jump simulated time to the first
                # on-grid tick that reaches the next arrival
                k = int(np.ceil((arr_t[ai] - t) / tick_s))
                t += k * tick_s
                ff_ticks += k
            ticks_run += 1
            while ai < n_req and arrivals[ai].t_arrival_s <= t:
                ledger.admit(arrivals[ai])
                pending.append(ai)
                ai += 1
            occ = active.sum(axis=1)
            busy_host.numpy()[:] = np.minimum(occ[lo:hi].astype(np.float64),
                                              cap) / cap
            busy_frac = (busy_host.to(self.device, non_blocking=True)
                         if on_card else busy_host.clone())

            self.plane, self._sor_state, bundle, request, env = tick_fn(
                self.plane, self._sor_state, busy_frac, tick)
            if c is not None:
                c.last_request = request
                c.last_envelope = env
            b = bundle.cpu()                               # the one copy
            if self._sharded_round is not None:
                # every rank's block of the bundle, in chip order
                b = ops.gather_stack(b, self._host_group).permute(
                    1, 0, 2).reshape(b.shape[0], n)
            b = b.numpy().astype(np.float64)
            e_np, e_busy, t_step = b[0], b[1], b[2]
            over = b[3] > 0.5
            headroom = headroom_from_packed(b[7:10])
            pinned_rows = b[10:13] > 0.5
            pinned = pinned_rows.any(axis=0)
            # batching engines progress lanes at the per-lane step time of
            # row 14; unbatched (and batch_cap=1) engines keep the base step
            # time: the same host arithmetic either way
            t_rate = b[14] if self._batched else t_step

            self.stats.energy_j += float(e_np.mean())
            self.stats.fleet_energy_j += float(e_np.sum())
            self.stats.model_time_s += tick_s
            ledger.tick_energy(float(e_np.sum()))
            if resident:
                chips, slots = np.nonzero(active)
                idx = slot_req[chips, slots]
                np.add.at(energy_acc, idx, e_busy[chips] / occ[chips])
                charged[idx] = True
                resident_degraded_ticks += int((over & (occ > 0)).sum())

            # in-flight migration: a chip whose pinned/over flag held K
            # consecutive ticks hands its decode-phase lanes to the
            # planner, most decode left first; each migrated lane pays a
            # token-proportional stall at its destination. Runs before
            # placement, so this tick's admits see the moved occupancy.
            if migrating:
                streak = np.where(pinned | over, streak + 1, 0)
                trig = streak >= migrate_after_ticks
                cand = (active & trig[:, None] & (slot_prefill <= 0)
                        if trig.any() else None)
                if cand is not None and cand.any():
                    c_chips, c_slots = np.nonzero(cand)
                    left = slot_decode[c_chips, c_slots]
                    order = np.lexsort(
                        (slot_req[c_chips, c_slots], -left))
                    reqs = [arrivals[int(slot_req[c_chips[k], c_slots[k]])]
                            for k in order]
                    dests = self.router.plan_migration(
                        reqs, occ, headroom, pinned=pinned, exclude=trig)
                    for k, dst in zip(order, dests):
                        if dst is None:
                            continue
                        src_c, src_s = int(c_chips[k]), int(c_slots[k])
                        i = int(slot_req[src_c, src_s])
                        d_slot = int(np.argmin(slot_req[dst]))  # first free
                        done_tokens = (req_prefill[i] + req_decode[i]
                                       - slot_decode[src_c, src_s])
                        stall_s = float(migrate_stall_s_per_token
                                        * done_tokens)
                        slot_req[dst, d_slot] = i
                        slot_prefill[dst, d_slot] = 0.0
                        slot_decode[dst, d_slot] = slot_decode[src_c, src_s]
                        slot_stall[dst, d_slot] = stall_s
                        slot_req[src_c, src_s] = -1
                        slot_stall[src_c, src_s] = 0.0
                        active[dst, d_slot] = True
                        active[src_c, src_s] = False
                        occ[dst] += 1
                        occ[src_c] -= 1
                        ledger.migrate(arrivals[i].rid, t, src_c, int(dst),
                                       stall_s=stall_s,
                                       src_streak=int(streak[src_c]))
                        n_migrations += 1
                if trig.any():
                    # triggered chips had their turn (or nothing to move);
                    # re-arm after another K hot ticks
                    streak[trig] = 0

            # placement: the whole pending queue in one router pass, FIFO
            # head-of-line; an unplaceable head defers once and blocks the
            # queue behind it
            if pending:
                placed = self.router.place_batch(
                    [arrivals[i] for i in pending], occ, headroom, pinned)
                for chip in placed:
                    i = pending.popleft()
                    ledger.place(arrivals[i].rid, t, chip)
                    slot = int(np.argmin(slot_req[chip]))   # first free
                    slot_req[chip, slot] = i
                    slot_prefill[chip, slot] = float(
                        arrivals[i].prefill_tokens)
                    slot_decode[chip, slot] = float(
                        arrivals[i].decode_tokens)
                    slot_stall[chip, slot] = 0.0
                    active[chip, slot] = True
                    occ[chip] += 1
                if pending:
                    reason = ("capacity" if bool((occ >= cap).all())
                              else "pinned-drain")
                    ledger.defer(arrivals[pending[0]].rid, reason, tick_s)
                    self.stats.decode_sheds += 1
                    self.stats.sheds_by_reason[reason] = (
                        self.stats.sheds_by_reason.get(reason, 0) + 1)
                    if reason == "pinned-drain":
                        for lane, rail in enumerate(RAIL_LANES):
                            if pinned_rows[lane].any():
                                self.stats.sheds_by_rail[rail] = (
                                    self.stats.sheds_by_rail.get(rail, 0)
                                    + 1)
                    self.stats.defer_time_s += tick_s
            max_occ = max(max_occ, int(occ.max()) if n else 0)

            # progress: batched decode over the lane arrays; over-bound
            # chips deliver degraded goodput this tick
            rate = tick_s / np.maximum(t_rate, 1e-12)
            if over.any():
                degraded_ticks += int(over.sum())
            rate = np.where(over, rate * degrade, rate)
            t_end = t + tick_s
            rate2d = np.broadcast_to(rate[:, None], (n, cap))
            if migrating:
                # migrated lanes sit out their stall: they occupy (and count
                # toward the batch) but advance nothing until it drains
                stalled = active & (slot_stall > 0)
                if stalled.any():
                    slot_stall[stalled] -= tick_s
                    active = active & ~stalled
            in_prefill = active & (slot_prefill > 0)
            if in_prefill.any():
                slot_prefill[in_prefill] -= (rate2d[in_prefill]
                                             * prefill_speedup)
                pf_done = in_prefill & (slot_prefill <= 0)
                if pf_done.any():
                    self.stats.prefill_tokens += int(
                        req_prefill[slot_req[pf_done]].sum())
            # a slot whose prefill crossed zero this tick decodes only from
            # the next tick (the loop path's `continue`)
            in_decode = active & ~in_prefill
            if in_decode.any():
                slot_decode[in_decode] -= rate2d[in_decode]
                fin = in_decode & (slot_decode <= 0)
                if fin.any():
                    for chip, slot in zip(*np.nonzero(fin)):
                        i = slot_req[chip, slot]
                        self.stats.decode_tokens += int(req_decode[i])
                        ledger.finish(arrivals[i].rid, t_end,
                                      tokens_out=int(req_decode[i]))
                    slot_req[fin] = -1
            t = t_end

        for i in np.nonzero(charged)[0]:
            ledger.charge(arrivals[int(i)].rid, float(energy_acc[i]))

        self.last_trace = {
            "router": getattr(self.router, "name",
                              type(self.router).__name__),
            "ticks": ticks_run, "tick_s": tick_s,
            "max_occupancy": max_occ, "capacity": cap,
            "degraded_chip_ticks": degraded_ticks,
            "resident_degraded_ticks": resident_degraded_ticks,
            "unplaced": len(pending),
            "unfinished": int((slot_req >= 0).sum()),
            "fused": True,
            "fast_forward_ticks": ff_ticks,
            "batch_cap": self.batch_cap,
            "migrations": n_migrations,
        }
        return ledger

    # -- loop path: the per-tick host loop (the fused path's oracle) --------

    def _serve_trace_loop(self, arrivals, ledger, *, max_ticks, observe,
                          tick_s, error_bound, degrade, prefill_speedup):
        """The per-tick host loop: accounting, one control round and
        scattered device reads a tick, per-slot dict bookkeeping. Kept as
        the semantics oracle the fused path is held against, and the only
        path host-actuated (PMBus) controllers run."""
        from repro_torch.serve.router import rail_headroom
        self._refuse_sharded("the loop path")
        n = self.n_chips
        cap = self.router.capacity
        spec = self.fleet_spec
        variation = fleet_variation(spec, self.device)
        account = lambda p: account_fleet_and_observe(
            self.decode_profile, p, spec, variation=variation)
        p_idle_fn = lambda p: chip_power_w(
            p, 0.0, 0.0, 0.0, spec.base, variation=variation)
        host = lambda x: x.cpu().numpy().astype(np.float64)

        ai = 0
        pending: collections.deque = collections.deque()
        running: list[list[dict]] = [[] for _ in range(n)]
        t = 0.0
        max_occ = 0
        degraded_ticks = 0
        ticks_run = 0

        for tick in range(max_ticks):
            if ai >= len(arrivals) and not pending \
                    and not any(running):
                break
            ticks_run += 1
            while ai < len(arrivals) and arrivals[ai].t_arrival_s <= t:
                ledger.admit(arrivals[ai])
                pending.append(arrivals[ai])
                ai += 1
            occ = np.array([len(r) for r in running], np.float64)
            busy_frac = torch.from_numpy(
                (np.minimum(occ, cap) / cap).astype(np.float32)).to(
                    self.device)

            self.plane, frame, m = account(self.plane)
            if observe is not None:
                frame = observe(self.plane, frame, tick, busy_frac)
            self._control_tick(frame)

            # busy/idle-blended energy: the accounting above assumed every
            # chip fully busy; rescale its step energy to this tick's
            # occupancy and rewrite the plane's accumulator to match
            p_busy = m["power_w"]
            p_idle = p_idle_fn(self.plane)
            p_eff = p_idle + (p_busy - p_idle) * busy_frac
            e_tick = p_eff * _f32(tick_s)
            self.plane = dataclasses.replace(
                self.plane,
                energy_j=self.plane.energy_j - m["energy_step_j"] + e_tick)
            e_np = host(e_tick)
            e_busy = host((p_eff - p_idle) * _f32(tick_s))
            self.stats.energy_j += float(e_np.mean())
            self.stats.fleet_energy_j += float(e_np.sum())
            self.stats.model_time_s += tick_s
            ledger.tick_energy(float(e_np.sum()))
            for i in range(n):
                if running[i]:
                    share = e_busy[i] / len(running[i])
                    for slot in running[i]:
                        ledger.charge(slot["req"].rid, share)

            # placement: headroom and the drain mask from the round just
            # run, FIFO with head-of-line blocking; the pinned masks are
            # read once a tick and reused by the defer path
            envs = getattr(self.controller, "last_envelope", None) \
                if self.controller is not None else None
            req = getattr(self.controller, "last_request", None) \
                if self.controller is not None else None
            headroom = rail_headroom(self.plane, envs)
            pin_masks = (pinned_rails(self.plane, req, envelope=envs)
                         if req is not None else {})
            pinned = np.zeros(n, bool)
            for mask in pin_masks.values():
                pinned |= mask
            while pending:
                occ_now = [len(r) for r in running]
                chip = self.router.place(pending[0], occ_now, headroom,
                                         pinned)
                if chip is None:
                    reason = ("capacity"
                              if all(o >= cap for o in occ_now)
                              else "pinned-drain")
                    ledger.defer(pending[0].rid, reason, tick_s)
                    self.stats.decode_sheds += 1
                    self.stats.sheds_by_reason[reason] = (
                        self.stats.sheds_by_reason.get(reason, 0) + 1)
                    if reason == "pinned-drain":
                        for rail, mask in pin_masks.items():
                            if mask.any():
                                self.stats.sheds_by_rail[rail] = (
                                    self.stats.sheds_by_rail.get(rail, 0)
                                    + 1)
                    self.stats.defer_time_s += tick_s
                    break
                r = pending.popleft()
                ledger.place(r.rid, t, chip)
                running[chip].append({
                    "req": r,
                    "prefill_left": float(r.prefill_tokens),
                    "decode_left": float(r.decode_tokens)})
            max_occ = max(max_occ, max(len(r) for r in running))

            # progress: every resident slot advances at the chip's modeled
            # token rate; over-bound chips deliver degraded goodput
            t_step = host(m["t_step_s"])
            rate = tick_s / np.maximum(
                np.broadcast_to(np.atleast_1d(t_step), (n,)), 1e-12)
            over = np.zeros(n, bool)
            for key in _OBS_KEYS:
                v = frame.get(key)
                if v is None:
                    continue
                a = host(v) if isinstance(v, torch.Tensor) \
                    else np.asarray(v, np.float64)
                a = np.broadcast_to(np.atleast_1d(a), (n,))
                over |= (~np.isnan(a)) & (a > error_bound)
            if over.any():
                degraded_ticks += int(over.sum())
            rate = np.where(over, rate * degrade, rate)
            t_end = t + tick_s
            for i in range(n):
                if not running[i]:
                    continue
                finished = []
                for slot in running[i]:
                    if slot["prefill_left"] > 0:
                        slot["prefill_left"] -= rate[i] * prefill_speedup
                        if slot["prefill_left"] <= 0:
                            self.stats.prefill_tokens += (
                                slot["req"].prefill_tokens)
                        continue
                    slot["decode_left"] -= rate[i]
                    if slot["decode_left"] <= 0:
                        finished.append(slot)
                for slot in finished:
                    running[i].remove(slot)
                    self.stats.decode_tokens += slot["req"].decode_tokens
                    ledger.finish(slot["req"].rid, t_end,
                                  tokens_out=slot["req"].decode_tokens)
            t = t_end

        self.last_trace = {
            "router": getattr(self.router, "name",
                              type(self.router).__name__),
            "ticks": ticks_run, "tick_s": tick_s,
            "max_occupancy": max_occ, "capacity": cap,
            "degraded_chip_ticks": degraded_ticks,
            "unplaced": len(pending),
            "unfinished": sum(len(r) for r in running),
            "fused": False,
            "fast_forward_ticks": 0,
        }
        return ledger

    def summary(self) -> dict[str, Any]:
        """The run's totals; on a sharded engine every rank calls it (the
        plane and the SOR estimate are gathered)."""
        toks = max(self.stats.decode_tokens, 1)
        plane = self._whole(self.plane, self.plane.n_chips)
        out = {
            "prefill_tokens": self.stats.prefill_tokens,
            "decode_tokens": self.stats.decode_tokens,
            "energy_j": self.stats.energy_j,
            "model_time_s": self.stats.model_time_s,
            "v_core": scalar_view(plane.v_core),
            "v_io": scalar_view(plane.v_io),
            "n_chips": self.n_chips,
        }
        if plane.is_fleet:
            out["fleet_energy_j"] = self.stats.fleet_energy_j
            out["fleet_j_per_decoded_token"] = (
                self.stats.fleet_energy_j / toks)
            out["v_core_min"] = float(plane.v_core.min())
            out["v_io_min"] = float(plane.v_io.min())
            out["comp_level_min"] = int(plane.comp_level.min())
        else:
            out["j_per_decoded_token"] = self.stats.energy_j / toks
        if self.admission_gate or self.router is not None:
            out["decode_sheds"] = self.stats.decode_sheds
            out["defer_time_s"] = self.stats.defer_time_s
            out["decode_sheds_by_rail"] = dict(self.stats.sheds_by_rail)
            out["decode_sheds_by_reason"] = dict(self.stats.sheds_by_reason)
            if self.last_shed_reason is not None:
                out["shed_reason"] = self.last_shed_reason
        if self._sor_state is not None:
            est = self._sor_state.estimate
            out["sor"] = sor_mod.summary(
                self._whole(est, est.confidence.shape[-1]),
                self.controller.sor)
        elif host_sor := sor_summary_of(self.controller):
            # a HostRailController(sor=...) learns on its own control_step
            out["sor"] = host_sor
        return out
