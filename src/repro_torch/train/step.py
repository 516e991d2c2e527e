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

Sharding over `torch.distributed` (the reference's `shard_map` paths):
- `FleetStepConfig(mesh=, shard_control=)` runs the fleet step on this
  rank's block of chips (`ops.chip_block`): its plane and `SorState` are
  the block (`shard_fleet_state`), the accounting reads the block of the
  `FleetSpec`, the draws hash the block's global chip indices (so they are
  the unsharded step's slice), the control round is
  `control_plane.sharded_control_round`, and the reduction tail gathers
  the block's fields once (one `all_gather` of `[5 + 1 + n_rails, n/P]`
  f32) and runs `ops.fleet_stats` on the whole fleet on every rank, so
  every `fleet/*` metric equals the unsharded step's bit for bit (the
  reference instead reduces worst and mean per shard and gathers only the
  two p95 inputs; at 64 to 4096 chips the gather is 2-200 KB, one
  collective and one launch in place of four collectives and two).
- `shard_map_ef_step(step, mesh, dp_axes)` splits the batch over the data
  ranks and binds the DP axes to their groups for the ef sync
  (`core/ecollectives.py`): params and optimizer state stay replicated, the
  loss is averaged over the ranks, and the ef residual, `grad_error` and
  the plane stay each rank's own, where the reference declares them
  replicated (`out_specs=P()`) and returns one device's.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

from repro_torch.core import ecollectives
from repro_torch.core.control_plane import (as_controller,
                                            sharded_control_round, with_sor)
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
    # the chips mesh: with it the step runs on this rank's block of chips
    # (see the module docstring); `shard_control` None shards the learned
    # round when the mesh spans more than one rank, True forces the sharded
    # round and the gathered tail on a one-rank mesh (the bit-equality
    # pin), False keeps it unsharded (a one-rank mesh only)
    mesh: Any = None
    shard_axis: str = "chips"
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
        grads, ef_resid, grad_error = _ef_sync(grads, ef_resid, step_cfg)
        loss = ecollectives.pmean(loss, step_cfg.dp_axes[0])
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


def fleet_draws(seed: int, step: torch.Tensor, n: int, first: int = 0):
    """(normal [n], uniform [n]) f32 draws for step `step` (a 0-d int
    tensor on the plane's device) of the fleet step seeded with `seed`, for
    chips first .. first + n - 1: a counter-based generator hashing (seed,
    step, chip, stream) on the device. It reads nothing back to the host, a
    CPU and a CUDA plane draw the same numbers, and a rank's block of chips
    (`first` its first global index) draws the whole fleet's slice. It does
    not reproduce `jax.random`: tests that need equal draws in both
    packages inject them."""
    dev = step.device
    chip = torch.arange(first, first + n, dtype=torch.int64, device=dev)
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
    controller = as_controller(step_cfg.policy)
    sor_cfg = fleet_cfg.sor
    if sor_cfg is not None:
        if controller is None:
            raise ValueError("FleetStepConfig.sor needs an in-graph policy "
                             "(StepConfig.policy) to consume the learned "
                             "envelopes")
        controller = with_sor(controller, sor_cfg)

    # the sharded-control-round knob, resolved once at factory time
    mesh = fleet_cfg.mesh
    shard_control = fleet_cfg.shard_control
    if shard_control:
        if mesh is None:
            raise ValueError("FleetStepConfig.shard_control=True needs a mesh")
        if sor_cfg is None:
            raise ValueError("FleetStepConfig.shard_control shards the "
                             "learned (SOR) control round — set "
                             "FleetStepConfig.sor, or leave shard_control "
                             "off (the reduction still shards via mesh=)")
    multi = mesh is not None and mesh.size() > 1
    if shard_control is None:
        shard_control = multi and sor_cfg is not None
    sharded_round = None
    if shard_control:
        sharded_round = sharded_control_round(controller, mesh,
                                              fleet_cfg.shard_axis)
    elif multi and sor_cfg is not None:
        raise ValueError(
            "FleetStepConfig.shard_control=False on a mesh of "
            f"{mesh.size()} ranks: the port's ranks hold only their block "
            "of chips, so the learned round runs sharded (shard_control "
            "None or True)")
    elif multi and getattr(getattr(controller, "policy", None),
                           "cross_chip", False):
        raise ValueError(
            f"policy {controller.policy.name!r} reduces across chips "
            "(cross_chip=True); on a mesh of several ranks it would only "
            "see its rank's chips. Run it without the mesh.")
    sharded = shard_control or multi
    fs = fleet_cfg.spec
    n = fs.n_chips
    lo, hi = (ops.chip_block(mesh, n, fleet_cfg.shard_axis) if sharded
              else (0, n))
    fs_local = (ops.shard_chip_tree(fs, mesh, n, fleet_cfg.shard_axis)
                if sharded else fs)

    def _step_body(params, opt_state, plane: PowerPlaneState, ef_resid,
                   sor_state, batch):
        (params, opt_state, ef_resid, loss, metrics, opt_metrics,
         grad_error) = _grads_and_update(loss_fn, opt_cfg, schedule_fn,
                                         step_cfg, params, opt_state,
                                         ef_resid, batch)
        dev = plane.device
        v_nom_core = as_f32(fs_local.v_core_nominal, dev)
        v_nom_hbm = as_f32(fs_local.v_hbm_nominal, dev)
        v_nom_io = as_f32(fs_local.v_io_nominal, dev)
        sens = as_f32(fs_local.error_sensitivity, dev)

        plane, frame, power_metrics = account_fleet_and_observe(
            profile, plane, fs_local)
        normal, uniform = fleet_draws(fleet_cfg.seed, plane.step[0], hi - lo,
                                      first=lo)

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
        if sharded_round is not None:
            # this rank's block through the sharded round: its frame lands
            # in its own ring; the confidence summary crosses ranks
            plane, sor_state, _conf_sum, _conf_min = sharded_round(
                plane, frame, sor_state)
        elif sor_cfg is not None:
            plane, sor_state = controller.control_step_sor(plane, frame,
                                                           sor_state)
        elif controller is not None:
            plane = controller.control_step(plane, frame)

        # the fleet reductions (worst/mean/p95, stragglers, the learned
        # region's confidence) in one launch, over the whole fleet
        fields = (power_metrics["power_w"], t_chip, err,
                  power_metrics["energy_step_j"], plane.v_io)
        conf = None if sor_cfg is None else sor_state.estimate.confidence
        if sharded:
            fields, straggle, conf = _gather_tail(
                mesh, fleet_cfg.shard_axis, fields, straggle, conf)
        fleet_metrics = ops.fleet_stats(*fields, straggle, conf)

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


def _gather_tail(mesh, axis_name: str, fields, straggle, conf):
    """The reduction tail's inputs of every rank's block, joined in chip
    order, from one all-gather: five [n/P] f32 fields, the straggle mask
    and the [n_rails, n/P] confidence (or None) -> the whole fleet's."""
    group, _, _ = ops.axis_group(mesh, axis_name)
    rows = [f.reshape(1, -1) for f in fields]
    rows.append(straggle.to(torch.float32).reshape(1, -1))
    if conf is not None:
        rows.append(conf.reshape(-1, fields[0].shape[-1]))
    packed = torch.cat(rows)
    whole = ops.gather_stack(packed, group).permute(1, 0, 2).reshape(
        packed.shape[0], -1)
    full = tuple(whole[i].contiguous() for i in range(5))
    whole_conf = None if conf is None else whole[6:].contiguous()
    return full, whole[5] > 0.5, whole_conf


def shard_fleet_state(state: dict, mesh, axis_name: str = "chips") -> dict:
    """This rank's block of the per-chip groups of a trainer state dict
    (`plane`, `sor`) on `mesh` (`ops.shard_chip_tree`: the ring [capacity,
    n_rails, n] and the estimate [n_rails, n] take the block, the host
    integers replicate). Model groups pass through untouched: the fleet
    step is replicated over the model. Use after building (or restoring)
    the whole state, before the first sharded step; `ckpt.save(mesh=)`
    gathers the blocks again on the way out."""
    out = dict(state)
    plane = state.get("plane")
    n_chips = None
    if plane is not None and plane.v_core.dim() == 1:
        n_chips = plane.v_core.shape[0]
    for group in ("plane", "sor"):
        tree = state.get(group)
        if tree is None or n_chips is None:
            continue
        out[group] = ops.shard_chip_tree(tree, mesh, n_chips, axis_name)
    return out


def _dp_index(mesh, dp_axes) -> tuple[int, int]:
    """(this rank's index, their count) over the product of `mesh`'s DP
    axes, in the mesh's axis order."""
    index, count = 0, 1
    for name in dp_axes:
        _, r, size = ops.axis_group(mesh, name)
        index, count = index * size + r, count * size
    return index, count


def shard_map_ef_step(train_step, mesh, dp_axes=("data",)):
    """Wrap a train step for error-feedback compressed data parallelism:
    each rank takes its rows of the batch (the last argument) over the DP
    axes, the DP axes are bound to their process groups for the ef sync
    (`ecollectives.bound_axes`), and params and optimizer state stay
    replicated (every rank applies the same reduced gradient). The wrapped
    step takes the 5-argument signature or the SOR step's 6."""
    groups = {name: ops.axis_group(mesh, name)[0] for name in dp_axes}
    index, count = _dp_index(mesh, dp_axes)

    def rows(a):
        b = a.shape[0]
        if b % count:
            raise ValueError(f"a batch of {b} rows does not split over "
                             f"{count} data-parallel ranks")
        k = b // count
        return a[index * k:(index + 1) * k]

    def mapped(*args):
        *state, batch = args
        local = ({k: rows(v) for k, v in batch.items()}
                 if isinstance(batch, dict) else rows(batch))
        with ecollectives.bound_axes(groups):
            return train_step(*state, local)

    return mapped
