"""Train-step factories (port of `repro/train/step.py`): microbatch
gradient accumulation, AdamW update, and the power plane woven through the
step, with the in-graph controller (observation -> policy.decide ->
arbitrate) running as tensor code on the plane's device after the update.

The reference jits a pure step; here the step runs eagerly. Gradients come
from `torch.autograd.grad` over the parameter leaves, and AdamW updates the
parameters and moments in place (`optim.adamw.apply_updates`), the
counterpart of the reference's donated buffers: callers rebind to the
returned trees, which are the trees they passed in.

Error-feedback compressed gradient sync (`grad_sync="ef_int8"`,
`"ef_int8_topk"`) runs the reference's sequence leaf by leaf
(`_ef_sync`): the raw gradient leaf is compressed with error feedback
(the residual updated in place), its terms of the relative L2 error
(`grad_error`) are summed, the compressed leaf is reduced at the int8
level over the data-parallel axis (a world of one, `core/ecollectives.py`),
and the raw leaf is dropped before the next, so no second full f32
gradient tree is held.

Not ported yet (each raises `NotImplementedError`): the sharded fleet step
(`FleetStepConfig.mesh`, `shard_control`) and the gradient sync over a
`torch.distributed` world larger than one.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

from repro_torch.core import ecollectives
from repro_torch.core.control_plane import as_controller, with_sor
from repro_torch.core.hwspec import FleetSpec
from repro_torch.core.power_plane import (PowerPlaneState, StepProfile,
                                          account_and_observe,
                                          account_fleet_and_observe, as_f32)
from repro_torch.kernels import ops
from repro_torch.optim import adamw


@dataclasses.dataclass(frozen=True)
class StepConfig:
    microbatches: int = 1
    grad_sync: str = "auto"          # auto | ef_int8 | ef_int8_topk
    k_fraction: float = 0.25
    policy: Any = None               # in-graph policy/controller or None
    dp_axes: tuple[str, ...] = ("data",)  # the axis of the ef sync


@dataclasses.dataclass(frozen=True)
class FleetStepConfig:
    """Fleet-native extension of StepConfig: one step drives a `[n_chips]`
    power plane whose chips carry per-chip process variation
    (`FleetSpec`), with per-chip straggler/fault injection coupled to each
    chip's voltage margin. See the reference for each knob."""
    spec: FleetSpec
    error_gain: float = 12.0
    link_ber_floor: float = 0.0
    telemetry_noise: float = 0.0
    straggler_prob: float = 0.0
    straggler_factor: float = 4.0
    straggler_margin_gain: float = 8.0
    hbm_error_base: float = 0.0
    hbm_error_gain: float = 24.0
    mesh: Any = None                 # sharded fleet step: not ported yet
    shard_control: "bool | None" = None
    # in-graph safe-operating-region learning: the step threads a
    # `sor.SorState` through its signature (see make_fleet_train_step)
    sor: Any = None
    seed: int = 0


GRAD_SYNCS = ("auto", "ef_int8", "ef_int8_topk")


def _check_step_cfg(step_cfg: StepConfig) -> None:
    if step_cfg.grad_sync not in GRAD_SYNCS:
        raise ValueError(f"grad_sync must be one of {GRAD_SYNCS}, got "
                         f"{step_cfg.grad_sync!r}")
    if step_cfg.microbatches < 1:
        raise ValueError(f"microbatches must be >= 1, got "
                         f"{step_cfg.microbatches}")


def _accumulate_grads(loss_fn, params, batch, microbatches: int):
    """Returns (mean_loss, metrics, grads): grads a tree like `params`, in
    the parameters' dtype with one microbatch, summed in f32 and scaled by
    1/microbatches with several (as the reference's scan does)."""
    paths = adamw.leaf_paths(params)
    leaves = [adamw.get_path(params, p) for p in paths]
    for leaf in leaves:
        leaf.requires_grad_(True)

    def tree(values):
        out: dict = {}
        for path, val in zip(paths, values):
            node = out
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = val
        return out

    def one(mb):
        loss, metrics = loss_fn(params, mb)
        # a leaf the batch leaves unused (a vlm's img_proj on a batch
        # without images) gets a zero gradient, as jax.grad gives it
        grads = torch.autograd.grad(loss, leaves, materialize_grads=True)
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
            grads

    if microbatches <= 1:
        loss, metrics, grads = one(batch)
        return loss, metrics, tree(grads)

    def split(a, i):
        b = a.shape[0]
        return a.reshape((microbatches, b // microbatches)
                         + tuple(a.shape[1:]))[i]

    loss_sum = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    acc = [torch.zeros(leaf.shape, dtype=torch.float32, device=leaf.device)
           for leaf in leaves]
    for i in range(microbatches):
        loss, metrics, grads = one({k: split(v, i) for k, v in batch.items()})
        for a, g in zip(acc, grads):
            a.add_(g)
        loss_sum = loss_sum + loss
        del grads
    inv = 1.0 / microbatches
    return loss_sum * inv, metrics, tree([a.mul_(inv) for a in acc])


def _ef_sync(grads, ef_resid, step_cfg: StepConfig):
    """The reference's error-feedback sync (`step.py:143-157`), leaf by
    leaf in its tree order, one pass a leaf (`ecollectives.ef_sync_leaf_`,
    K10's fused kernel on the card): compress g + r at the configured level
    (the residual updated in place), the leaf's terms of the relative L2
    error, and the compressed leaf reduced at the int8 level over the
    data-parallel axis, which replaces the raw leaf. Returns (reduced
    grads, f32 as in the reference; ef_resid; grad_error)."""
    level = (ecollectives.LEVEL_INT8_TOPK
             if step_cfg.grad_sync == "ef_int8_topk"
             else ecollectives.LEVEL_INT8)
    axis = step_cfg.dp_axes[0]
    num = den = 0
    ecollectives.own_residuals(ef_resid)
    for path in adamw.leaf_paths(grads):
        parent = adamw.get_path(grads, path[:-1])
        parent[path[-1]], n, d = ecollectives.ef_sync_leaf_(
            parent[path[-1]], adamw.get_path(ef_resid, path), level, axis,
            step_cfg.k_fraction)
        num, den = num + n, den + d
    return grads, ef_resid, ecollectives.error_norm_from_sums(num, den)


def _grads_and_update(loss_fn, opt_cfg, schedule_fn, step_cfg, params,
                      opt_state, ef_resid, batch):
    """The model side of a train step, shared by the scalar and fleet
    factories: microbatched grads, the optional error-feedback compressed
    sync and the AdamW update. Returns (params', opt_state', ef_resid',
    loss, metrics, opt_metrics, grad_error)."""
    loss, metrics, grads = _accumulate_grads(loss_fn, params, batch,
                                             step_cfg.microbatches)
    grad_error = torch.zeros((), dtype=torch.float32, device=loss.device)
    if step_cfg.grad_sync != "auto":
        # pmean(loss) over the world of one is the loss itself
        grads, ef_resid, grad_error = _ef_sync(grads, ef_resid, step_cfg)
    lr = schedule_fn(opt_state["step"])
    params, opt_state, opt_metrics = adamw.apply_updates(
        params, grads, opt_state, lr, opt_cfg)
    return params, opt_state, ef_resid, loss, metrics, opt_metrics, grad_error


def make_train_step(loss_fn: Callable, opt_cfg: adamw.AdamWConfig,
                    schedule_fn: Callable, profile: StepProfile,
                    step_cfg: StepConfig):
    """Returns train_step(params, opt_state, plane, ef_resid, batch) ->
    (params', opt_state', plane', ef_resid', metrics)."""
    _check_step_cfg(step_cfg)
    controller = as_controller(step_cfg.policy)

    def train_step(params, opt_state, plane: PowerPlaneState, ef_resid,
                   batch):
        (params, opt_state, ef_resid, loss, metrics, opt_metrics,
         grad_error) = _grads_and_update(loss_fn, opt_cfg, schedule_fn,
                                         step_cfg, params, opt_state,
                                         ef_resid, batch)
        plane, frame, power_metrics = account_and_observe(profile, plane)
        frame = dataclasses.replace(frame, grad_error=grad_error)
        if controller is not None:
            plane = controller.control_step(plane, frame)
        telemetry = {**power_metrics, "grad_error": grad_error}
        out_metrics = {"loss": loss, **metrics, **opt_metrics, **telemetry}
        return params, opt_state, plane, ef_resid, out_metrics

    return train_step


_MASK32 = 0xFFFFFFFF


def _hash32(x: torch.Tensor) -> torch.Tensor:
    """An integer mixer on int64 tensors holding 32-bit values (multipliers
    below 2^31, so no product leaves int64): the same bits on every
    device."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _MASK32
    x = x ^ (x >> 15)
    x = (x * 0x5BD1E995) & _MASK32
    return x ^ (x >> 16)


def fleet_draws(seed: int, step: torch.Tensor, n: int):
    """(normal [n], uniform [n]) f32 draws for step `step` (a 0-d int
    tensor on the plane's device) of the fleet step seeded with `seed`: a
    counter-based generator hashing (seed, step, chip, stream) on the
    device. It reads nothing back to the host, and a CPU and a CUDA plane
    draw the same numbers. It does not reproduce `jax.random`: tests that
    need equal draws in both packages inject them."""
    dev = step.device
    chip = torch.arange(n, dtype=torch.int64, device=dev)
    base = _hash32((step.to(torch.int64) * 0x2545F491
                    + (seed & _MASK32)) & _MASK32)

    def uniform(stream: int, open_low: bool):
        h = _hash32((base + chip * 0x3C6EF372 + stream) & _MASK32)
        u = (h >> 8).to(torch.float32)
        return (u + 0.5 if open_low else u) * (1.0 / (1 << 24))

    # Box-Muller on two open uniforms
    u1, u2 = uniform(1, True), uniform(2, False)
    normal = torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(2.0 * math.pi * u2)
    return normal, uniform(3, False)


def make_fleet_train_step(loss_fn: Callable, opt_cfg: adamw.AdamWConfig,
                          schedule_fn: Callable, profile: StepProfile,
                          step_cfg: StepConfig, fleet_cfg: FleetStepConfig):
    """Fleet-native train step: the scalar step's model and optimizer math,
    a `[n_chips]` power plane with per-chip process variation, per-chip
    margin-coupled error/straggler/HBM-error observables, and the fleet
    reductions (worst/mean/p95) in one launch of `ops.fleet_stats`.

    Returns train_step(params, opt_state, plane, ef_resid, batch) ->
    (params', opt_state', plane', ef_resid', metrics); with
    `fleet_cfg.sor` set, train_step(params, opt_state, plane, ef_resid,
    sor_state, batch) -> (..., sor_state', metrics): the in-graph
    controller pushes every step's frame into the `sor.SorState`, refits
    the per-rail frontiers on the configured cadence (decided on the host
    from the state's integer tick) and decides under the learned
    envelopes."""
    _check_step_cfg(step_cfg)
    if fleet_cfg.mesh is not None or fleet_cfg.shard_control:
        raise NotImplementedError(
            "the sharded fleet step (FleetStepConfig.mesh / shard_control) "
            "is not yet ported (ROADMAP.md, open item 'Sharding')")
    controller = as_controller(step_cfg.policy)
    sor_cfg = fleet_cfg.sor
    if sor_cfg is not None:
        if controller is None:
            raise ValueError("FleetStepConfig.sor needs an in-graph policy "
                             "(StepConfig.policy) to consume the learned "
                             "envelopes")
        controller = with_sor(controller, sor_cfg)
    fs = fleet_cfg.spec
    n = fs.n_chips

    def _step_body(params, opt_state, plane: PowerPlaneState, ef_resid,
                   sor_state, batch):
        (params, opt_state, ef_resid, loss, metrics, opt_metrics,
         grad_error) = _grads_and_update(loss_fn, opt_cfg, schedule_fn,
                                         step_cfg, params, opt_state,
                                         ef_resid, batch)
        dev = plane.device
        v_nom_core = as_f32(fs.v_core_nominal, dev)
        v_nom_hbm = as_f32(fs.v_hbm_nominal, dev)
        v_nom_io = as_f32(fs.v_io_nominal, dev)
        sens = as_f32(fs.error_sensitivity, dev)

        plane, frame, power_metrics = account_fleet_and_observe(
            profile, plane, fs)
        normal, uniform = fleet_draws(fleet_cfg.seed, plane.step[0], n)

        # per-chip measured error: the shared compression error (plus any
        # intrinsic link floor) seen through each chip's own BER curve,
        # amplified by ITS VDD_IO undervolt margin
        margin_io = torch.clamp(v_nom_io - plane.v_io, min=0.0) / v_nom_io
        noise = 1.0 + fleet_cfg.telemetry_noise * normal
        err = ((grad_error + fleet_cfg.link_ber_floor) * sens * noise
               * (1.0 + fleet_cfg.error_gain * margin_io))

        # per-chip stragglers: thin VDD_CORE margin -> higher odds; the
        # margin-coupled rate is the VDD_CORE failure observable
        margin_core = (torch.clamp(v_nom_core - plane.v_core, min=0.0)
                       / v_nom_core)
        p_straggle = torch.clamp(
            fleet_cfg.straggler_prob
            * (1.0 + fleet_cfg.straggler_margin_gain * margin_core), 0.0,
            1.0)
        straggle = uniform < p_straggle
        t_chip = power_metrics["t_step_s"] * torch.where(
            straggle, fleet_cfg.straggler_factor, 1.0)

        # per-chip HBM interface errors: thin VDD_HBM margin -> higher rate
        margin_hbm = torch.clamp(v_nom_hbm - plane.v_hbm, min=0.0) / v_nom_hbm
        hbm_rate = (as_f32(fleet_cfg.hbm_error_base, dev) * sens
                    * (1.0 + fleet_cfg.hbm_error_gain * margin_hbm))

        frame = dataclasses.replace(
            frame, grad_error=err,
            extras={**frame.extras, "t_chip_s": t_chip,
                    "straggle_rate": p_straggle, "hbm_error_rate": hbm_rate})
        telemetry = {**power_metrics, "grad_error": err, "t_chip_s": t_chip,
                     "straggle_rate": p_straggle, "hbm_error_rate": hbm_rate}
        if sor_cfg is not None:
            plane, sor_state = controller.control_step_sor(plane, frame,
                                                           sor_state)
        elif controller is not None:
            plane = controller.control_step(plane, frame)

        # the fleet reductions (worst/mean/p95, stragglers, the learned
        # region's confidence) in one launch
        fleet_metrics = ops.fleet_stats(
            power_metrics["power_w"], t_chip, err,
            power_metrics["energy_step_j"], plane.v_io, straggle,
            None if sor_cfg is None else sor_state.estimate.confidence)

        out_metrics = {"loss": loss, **metrics, **opt_metrics, **telemetry,
                       **fleet_metrics}
        return params, opt_state, plane, ef_resid, sor_state, out_metrics

    if sor_cfg is not None:
        def train_step(params, opt_state, plane, ef_resid, sor_state, batch):
            return _step_body(params, opt_state, plane, ef_resid, sor_state,
                              batch)
    else:
        def train_step(params, opt_state, plane, ef_resid, batch):
            out = _step_body(params, opt_state, plane, ef_resid, None, batch)
            return out[:4] + (out[5],)

    return train_step
