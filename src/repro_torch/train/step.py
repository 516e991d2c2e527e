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

Placed training, `make_train_step(..., mesh=)`: the counterpart of the
reference's `jax.jit(step)` called with params and moments placed by
`parallel.sharding.named_shardings` and the batch over the DP axes. The
params and the AdamW moments are DTensors (`sharding.place`); each step
- takes this rank's rows of the batch over the DP axes (those the active
  `mesh_context` resolves the batch to, else 'pod' and 'data'; the rows
  must split evenly, so the mean of the ranks' mean losses is the
  batch's);
- takes each leaf in the TP forward's layout (`sharding.tp_cuts`,
  `sharding.fetch_block`): gathered along its DP and FSDP mesh dims only
  (`sharding.gather_dims`: one `all_gather` a dim), its block along
  'model' kept where the leaf is a tensor-parallel block (heads, kv
  heads, ff, vocab, ssm heads, the MoE's experts, d_model or ff); where
  the MoE's `w_out` holds no block the layer splits (its experts do not
  divide over 'model'), the rows of its ff that the rank's activation
  reads are moved to the rank (`sharding.relayout`, one all-to-all). So
  the loss runs the TP forward on the rank's blocks under the mesh's
  model group (`sharding.model_group_context`; the regions' collectives
  are the models'), and every hand-written kernel runs on the rank's
  heads;
- reduces each gradient to this rank's block of its leaf's placement: a
  TP block's gradient is already the rank's; along a DP dim the blocks
  are exchanged (`all_to_all_single`, a reduce-scatter in rank order) or,
  where the leaf is replicated over it, summed on every rank (beyond two
  ranks a reduce-scatter and an all-gather, else gathered whole), added
  in rank order in f32 (`_rank_order_sum`), then divided by the DP ranks'
  count; along a non-DP dim that is not a TP block (the wide-FSDP
  profile's model dim where the batch is not split over it) the ranks
  computed the same gradient, which is cut; a gradient in a layout the
  placement does not hold (the fetched `w_out` rows) is reduce-scattered
  over the DP ranks there and its pieces moved to the placement's blocks
  (`sharding.relayout`);
- takes a statistic of the whole batch that a loss reads without a
  gradient (the MoE's top-1 expert shares, `sharding.batch_mean`) as the
  mean over the DP ranks, so the ranks' mean loss and gradient are the
  global batch's, as in the reference;
- takes the global gradient norm from every distinct block's sum of
  squares, leaves in the reference's order and blocks in rank order;
- updates this rank's blocks of the params and moments in place with the
  same AdamW (`adamw.apply_updates(..., grad_norm=)`): the update is
  elementwise, so a block equals the slice of the same update made whole.
  The int8 moments are flat `[n_blocks, 256]` codes of the leaf's
  row-major flattening, placed over FSDP on their rows (`_int8_leaf`, a
  leaf at a time): the elements of the gradient's block go to the ranks
  holding their rows, the rows are updated whole (256-element blocks)
  into AdamW's direction, and the direction's elements come back to the
  param's block, each move one all-to-all (`sharding.relayout`; a
  block's rows put together from fragments where its dims do not hold
  whole rows, as attention's 384- or 128-element head blocks). A rank
  receives its moment rows' and its param block's elements, and the
  result is the unplaced int8 update's bits.
A one-process run that takes each rank's rows in turn, splits the model
ranks as the TP forward does (`sharding.run_model_ranks`), adds the
gradients in rank order and takes the norm block by block makes the same
bits (`tests/sharded_worlds.py` `placed_oracle`). The ef sync is refused
on a placed step (`NotImplementedError`): the reference's binds a data
axis through `shard_map_ef_step`, which keeps the params replicated.
"""

from __future__ import annotations

import dataclasses
import functools
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
from repro_torch.parallel import sharding as shd


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
        return _tree(paths, values)

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
                    step_cfg: StepConfig, *, mesh=None):
    """Returns train_step(params, opt_state, plane, ef_resid, batch) ->
    (params', opt_state', plane', ef_resid', metrics).

    With `mesh` the step is the placed (FSDP) step of the module docstring:
    params and the AdamW state (moments and step) are DTensors on `mesh`
    (`sharding.place` of `sharding.named_shardings` of each tree), the
    batch is the global batch on every rank, and the mesh's 'pod' and
    'data' axes split its rows."""
    _check_step_cfg(step_cfg)
    controller = as_controller(step_cfg.policy)
    if mesh is None:
        update = functools.partial(_grads_and_update, loss_fn, opt_cfg,
                                   schedule_fn, step_cfg)
    else:
        update = _placed_update(loss_fn, opt_cfg, schedule_fn, step_cfg,
                                mesh)

    def train_step(params, opt_state, plane: PowerPlaneState, ef_resid,
                   batch):
        (params, opt_state, ef_resid, loss, metrics, opt_metrics,
         grad_error) = update(params, opt_state, ef_resid, batch)
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


def _dp_rows(mesh, dp_axes):
    """(this rank's rows of a batch over the DP axes: a function of a
    tensor or a dict of them, the DP ranks' count)."""
    index, count = _dp_index(mesh, dp_axes)

    def rows(a):
        b = a.shape[0]
        if b % count:
            raise ValueError(f"a batch of {b} rows does not split over "
                             f"{count} data-parallel ranks")
        k = b // count
        return a[index * k:(index + 1) * k]

    def local(batch):
        return ({k: rows(v) for k, v in batch.items()}
                if isinstance(batch, dict) else rows(batch))

    return local, count


def shard_map_ef_step(train_step, mesh, dp_axes=("data",)):
    """Wrap a train step for error-feedback compressed data parallelism:
    each rank takes its rows of the batch (the last argument) over the DP
    axes, the DP axes are bound to their process groups for the ef sync
    (`ecollectives.bound_axes`), and params and optimizer state stay
    replicated (every rank applies the same reduced gradient). The wrapped
    step takes the 5-argument signature or the SOR step's 6."""
    groups = {name: ops.axis_group(mesh, name)[0] for name in dp_axes}
    rows, _ = _dp_rows(mesh, dp_axes)

    def mapped(*args):
        *state, batch = args
        with ecollectives.bound_axes(groups):
            return train_step(*state, rows(batch))

    return mapped


# -- placed (FSDP) training -------------------------------------------------------

def _rank_order_sum(parts):
    """The f32 sum of `parts`, added one at a time in rank order."""
    acc = parts[0].to(torch.float32, copy=True)
    for x in parts[1:]:
        acc.add_(x)
    return acc


def _gather_list(x, group, n: int) -> list:
    import torch.distributed as dist
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return parts


def _exchange(x, d: int, group, n: int):
    """x cut into n blocks along dim d, block j sent to rank j of `group`:
    the blocks of this rank's index that every rank sent, in rank order
    (one `all_to_all_single`)."""
    import torch.distributed as dist
    send = torch.stack(x.chunk(n, d))
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    return recv.unbind(0)


def _all_sum(g, group, n: int):
    """The f32 sum of every rank's `g` over `group` (n ranks), added in
    rank order, on every rank: beyond two ranks a reduce-scatter along a
    dim that divides (`_exchange`) and an all-gather, so a rank receives
    twice its gradient's bytes, not n times; else every rank's `g`
    gathered."""
    t = next((d for d in range(g.dim()) if g.shape[d] % n == 0), None) \
        if n > 2 else None
    if t is None:
        return _rank_order_sum(_gather_list(g, group, n))
    part = _rank_order_sum(_exchange(g, t, group, n))
    return torch.cat(_gather_list(part, group, n), t)


def _grad_block(g, mesh, dims: tuple, dp: tuple, cuts: tuple = (),
                shape: tuple | None = None) -> torch.Tensor:
    """This rank's block of the sum over the DP ranks of their gradients of
    one leaf (`g`, this rank's gradient of the leaf as the forward took it:
    in the layout `cuts`, `sharding.tp_cuts`; `dims`, per mesh dim the
    tensor dim its placement shards; `shape`, the whole leaf's), in f32.

    Where the forward took the placement's own blocks, mesh dims cut in
    mesh order, as DTensor nests them; a non-DP cut on a tensor dim no
    other mesh dim shards goes first, since cuts on distinct dims commute
    and it shrinks what the DP dims move. Where a cut is not the
    placement's (the MoE `w_out`'s ff on the production meshes), the DP
    ranks' sums are reduce-scattered in the forward's layout and the
    pieces moved to the placement's blocks (`sharding.relayout`). Either
    way each element is the DP ranks' gradients added in rank order."""
    coord, sizes = mesh.get_coordinate(), tuple(mesh.shape)
    keep = tuple(i for i, t in cuts if dims[i] == t)
    if len(keep) != len(cuts):
        layout = list(cuts)
        for i in dp:
            group, d = mesh.get_group(i), dims[i]
            if d is not None and g.shape[d] % sizes[i] == 0:
                g = _rank_order_sum(_exchange(g, d, group, sizes[i]))
                layout.append((i, d))
            else:
                g = _all_sum(g, group, sizes[i])
        if not dp:
            g = g.to(torch.float32, copy=True)
        src = shd.placement_layout(shape, mesh, dims)
        return shd.relayout(g, dataclasses.replace(src, cuts=tuple(layout)),
                            src, mesh)

    def cut(x, i):
        k = x.shape[dims[i]] // sizes[i]
        return x.narrow(dims[i], coord[i] * k, k)

    alone = [i for i, d in enumerate(dims)
             if d is not None and i not in dp and i not in keep
             and dims.count(d) == 1]
    for i in alone:
        g = cut(g, i)
    summed = False
    for i, d in enumerate(dims):
        if i in alone or i in keep:
            continue
        if i not in dp:
            if d is not None:
                g = cut(g, i)
            continue
        group = mesh.get_group(i)
        g = (_all_sum(g, group, sizes[i]) if d is None
             else _rank_order_sum(_exchange(g, d, group, sizes[i])))
        summed = True
    return g if summed else g.to(torch.float32, copy=True)


def _dp_mean(x, mesh, dp: tuple):
    """The mean over the DP ranks of a tensor, their values added in rank
    order."""
    shape = x.shape
    x = x.reshape(-1)
    for i in dp:
        x = _rank_order_sum(_gather_list(x, mesh.get_group(i),
                                        mesh.size(i))).div_(mesh.size(i))
    return x.reshape(shape)


def _placed_norm(blocks: list, dims: list, mesh):
    """The global norm of a gradient held as this rank's blocks (`blocks`,
    leaves in the reference's order; `dims`, each leaf's sharded tensor
    dim per mesh dim): every distinct block's f32 sum of squares, gathered
    from every rank, added leaf by leaf and block by block in rank order."""
    sums = torch.stack([b.to(torch.float32, copy=True).square_().sum()
                        for b in blocks])
    every = sums
    for i in reversed(range(mesh.ndim)):
        every = torch.stack(_gather_list(every, mesh.get_group(i),
                                         mesh.size(i)))
    sizes = tuple(mesh.shape)
    total = None
    for j, d in enumerate(dims):
        for coord in shd.distinct_blocks(sizes, d):
            sq = every[coord + (j,)]
            total = sq if total is None else total + sq
    return torch.sqrt(total)


def _placed_dp(mesh) -> tuple[str, ...]:
    """The placed step's data-parallel axes: those the active
    `mesh_context` resolves the batch to (the wide-FSDP profile puts it
    over data and model), else the mesh's 'pod' and 'data'."""
    from repro_torch.launch.mesh import dp_axes
    if shd.active_mesh() is None:
        return dp_axes(mesh)
    return tuple(a for a in shd._entry_axes(shd.resolve("batch")[0])
                 if a in mesh.mesh_dim_names)


def _int8_leaf(g, leaf, dims: tuple, m: dict, v: dict, q, mesh, scalars,
               opt_cfg) -> None:
    """One leaf's AdamW step with int8 moments on the placed step, in
    place: `g`, this rank's block of the reduced gradient under the
    placement `dims`; `m`, `v`, its local rows of the moments (flat
    256-element blocks of the leaf in row-major order, `q` their codes
    as placed: over FSDP on their rows). The gradient's elements go to the
    moments' rows, the rows are updated whole (`adamw.int8_rows_direction`)
    and the direction's elements come back to the param's block
    (`adamw.apply_direction`), each move one all-to-all over the mesh
    (`sharding.relayout`): a rank receives its moment rows' and its
    param block's elements, and holds one leaf's rows at a time. The
    update is elementwise, so the bits are the unplaced int8 update's."""
    clip, bc1, bc2, lr = scalars
    block = shd.placement_layout(leaf.shape, mesh, dims)
    qd = shd.sharding_of(q)[1]
    rows = shd.Layout(block.shape, block.sizes, tuple(
        (i, 0) for i, d in enumerate(qd) if d == 0),
        rows=(q.shape[0], adamw.Q_BLOCK))
    g_rows = shd.relayout(g, block, rows, mesh)
    del g
    upd = adamw.int8_rows_direction(g_rows, m, v, clip, bc1, bc2, opt_cfg)
    del g_rows
    upd = shd.relayout(upd, rows, block, mesh)
    adamw.apply_direction(leaf.to_local(), upd, lr, opt_cfg)


def _placed_update(loss_fn, opt_cfg, schedule_fn, step_cfg, mesh):
    """The model side of the placed step (module docstring), with the
    signature of `_grads_and_update` once its configuration is bound."""
    from torch.distributed.tensor import DTensor, Replicate
    if step_cfg.grad_sync != "auto":
        raise NotImplementedError(
            f"grad_sync={step_cfg.grad_sync!r} on placed parameters: the "
            "ef sync runs over replicated params (shard_map_ef_step), as "
            "the reference's pmean needs a bound data axis")
    int8 = opt_cfg.state_dtype == "int8"

    def update(params, opt_state, ef_resid, batch):
        names = tuple(mesh.mesh_dim_names)
        dp_names = _placed_dp(mesh)
        dp = tuple(names.index(a) for a in dp_names)
        rows, n_dp = _dp_rows(mesh, dp_names)
        paths = adamw.leaf_paths(params)
        leaves = [adamw.get_path(params, p) for p in paths]
        for path, leaf in zip(paths, leaves):
            if not isinstance(leaf, DTensor) or leaf.device_mesh != mesh:
                raise ValueError(f"params leaf {'/'.join(path)} is not "
                                 "placed on the step's mesh "
                                 "(sharding.place)")
        dims = [shd.sharding_of(a)[1] for a in leaves]
        shapes = [tuple(a.shape) for a in leaves]
        cuts = shd.tp_cuts(_tree(paths, dims), names, dp,
                           shapes=_tree(paths, shapes),
                           sizes=tuple(mesh.shape))
        cuts = [adamw.get_path(cuts, p) for p in paths]
        local = _tree(paths, [shd.fetch_block(a, mesh, d, c).detach()
                              for a, d, c in zip(leaves, dims, cuts)])
        group = (None if "model" not in names or names.index("model") in dp
                 else shd.mesh_model_group(mesh))
        with shd.batch_context(lambda x: _dp_mean(x, mesh, dp)), \
                shd.model_group_context(group):
            loss, metrics, grads = _accumulate_grads(
                loss_fn, local, rows(batch), step_cfg.microbatches)
        del local
        blocks = []
        for path, d, c, shape in zip(paths, dims, cuts, shapes):
            parent = adamw.get_path(grads, path[:-1])
            g = parent.pop(path[-1])
            blocks.append(_grad_block(g, mesh, d, dp, c, shape).div_(n_dp))
            del g
        gnorm = _placed_norm(blocks, dims, mesh)
        loss = _dp_mean(loss, mesh, dp)
        metrics = {k: _dp_mean(v, mesh, dp) for k, v in metrics.items()}

        def local_of(tree):
            return _tree(paths, [shd.to_local_tree(adamw.get_path(tree, p))
                                 for p in paths])

        state = {"step": opt_state["step"].to_local(),
                 "m": local_of(opt_state["m"]), "v": local_of(opt_state["v"])}
        lr = schedule_fn(state["step"])
        if not int8:
            _, state, opt_metrics = adamw.apply_updates(
                local_of(params), _tree(paths, blocks), state, lr, opt_cfg,
                grad_norm=gnorm)
        else:
            state["step"], clip, bc1, bc2 = adamw.step_scalars(
                state["step"], gnorm, opt_cfg)
            for j, (path, leaf, d) in enumerate(zip(paths, leaves, dims)):
                _int8_leaf(blocks[j], leaf, d, adamw.get_path(state["m"], path),
                           adamw.get_path(state["v"], path),
                           adamw.get_path(opt_state["m"], path)["q"], mesh,
                           (clip, bc1, bc2, lr), opt_cfg)
                blocks[j] = None
            opt_metrics = {"grad_norm": gnorm, "lr": lr}
        opt_state["step"] = DTensor.from_local(
            state["step"], mesh, [Replicate()] * mesh.ndim, run_check=False)
        grad_error = torch.zeros((), dtype=torch.float32, device=loss.device)
        return (params, opt_state, ef_resid, loss, metrics, opt_metrics,
                grad_error)

    return update


def _tree(paths, values) -> dict:
    """Nested dicts with `values` at the key `paths`."""
    out: dict = {}
    for path, val in zip(paths, values):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = val
    return out
