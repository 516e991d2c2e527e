"""Public entry to the port's kernels, mirroring `repro/kernels/ops.py`.

Dispatch is by the device of the tensors: a CPU tensor runs the plain
PyTorch version, a CUDA tensor launches the hand-written CUDA kernel (built
at first use) or raises. There is no switch and no fallback. A meta tensor
(the dry run's, `launch/dryrun.py`) takes a third branch for the model
path's kernels (K2-K5, K8, K9): outputs of the kernel's shapes, nothing
computed, and the kernel's operations and bytes (the formulas of
`chip_smoke.py`'s bounds) added to the active `kernel_costs()` counter. It
never runs the plain version, which would materialise what the kernel
never writes (K2's T x S scores at prefill_32k) or walk a scan step by
step (524,288 Python steps a layer at long_500k).

Launch counts: each kernel wrapper carries a `launches` integer that it
increments where it launches its kernel and nowhere else;
`launch_counts()` reads them and `reset_launch_counts()` zeroes them.

The fleet's chip axis over a mesh (`chip_specs`, `shard_chip_tree`,
`gather_chip_tree`, `sharded_fleet_reduce`): a `torch.distributed` rank
holds only its contiguous block of chips, `[r n/P, (r+1) n/P)` on the
mesh's `chips` axis (the block layout of the reference's `NamedSharding`),
as tensors of its own; a sharded tree is that rank's block. Where the
reference's `shard_map` hands each device its slice of a global array, the
port's rank already holds it, and the collectives run over the axis's
process group."""

from __future__ import annotations

import contextlib
import contextvars
import copy
import dataclasses
import functools

import numpy as np
import torch

from repro_torch.kernels import decode_attention as _da
from repro_torch.kernels import fleet_telemetry as _ft
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import mamba2_ssd as _m2
from repro_torch.kernels import quant_codec as _qc
from repro_torch.kernels import ref
from repro_torch.kernels import rwkv6_scan as _r6

# name -> the wrapper carrying the launch count
KERNELS = {
    "sor_fit": _ft.sor_fit,
    "sor_accumulate": _ft.sor_accumulate,
    "sor_refit": _ft.sor_refit,
    "flash_attention_fwd": _fa.flash_attention,
    "decode_attention": _da.decode_attention,
    "flash_attention_bwd_dq": _fa.flash_attention_bwd_dq,
    "flash_attention_bwd_dkv": _fa.flash_attention_bwd_dkv,
    "fleet_reduce": _ft.fleet_reduce,
    "fleet_stats": _ft.fleet_stats,
    "rwkv6_scan": _r6.rwkv6_scan,
    "mamba2_ssd": _m2.mamba2_ssd,
    "quantize_int8": _qc.quantize_int8,
    "ef_sync_leaf": _qc.ef_sync_leaf,
}


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


# -- the meta branch ---------------------------------------------------------------

_COSTS: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_kernel_costs", default=None)


@contextlib.contextmanager
def kernel_costs():
    """Counts what the meta branch's kernels would do: yields {kernel name:
    {"launches", "flops", "bytes"}}, filled as meta calls run."""
    costs: dict = {}
    token = _COSTS.set(costs)
    try:
        yield costs
    finally:
        _COSTS.reset(token)


def _count(name: str, flops: float, n_bytes: float, launches: int = 1):
    costs = _COSTS.get()
    if costs is None:
        return
    row = costs.setdefault(name, {"launches": 0, "flops": 0.0,
                                  "bytes": 0.0})
    row["launches"] += launches
    row["flops"] += float(flops)
    row["bytes"] += float(n_bytes)


def _nbytes(*tensors) -> int:
    return sum(a.numel() * a.element_size() for a in tensors
               if a is not None)


def attention_pairs(T: int, S: int, causal: bool, window: int) -> int:
    """The (query, key) pairs one head of a flash call scores: all T x S,
    or causally (the last query row at key S - 1) each row's keys, at most
    `window` of them."""
    if not causal:
        return T * S
    seen = np.minimum(np.arange(T, dtype=np.int64) + (S - T) + 1, S)
    if window:
        seen = np.minimum(seen, window)
    return int(seen.clip(0).sum())


def _flash_costs(q, k, causal, group, window):
    B, T, Hq, Dh = q.shape
    pairs = B * Hq * attention_pairs(T, k.shape[1], causal, window)
    qb, kb = _nbytes(q), _nbytes(k)
    stats = 4 * B * Hq * T
    return pairs, qb, kb, stats


class _MetaFlash(torch.autograd.Function):
    """K2 on meta tensors (K4 + K5 its backward): shapes and costs only."""

    @staticmethod
    def forward(ctx, q, k, v, causal, group, window):
        ctx.save_for_backward(q, k, v)
        ctx.kw = (causal, group, window)
        pairs, qb, kb, stats = _flash_costs(q, k, causal, group, window)
        _count("flash_attention_fwd", 4 * q.shape[3] * pairs,
               2 * qb + 2 * kb + stats)
        return torch.empty_like(q)

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        pairs, qb, kb, stats = _flash_costs(q, k, *ctx.kw)
        Dh = q.shape[3]
        _count("flash_attention_bwd_dq", 6 * Dh * pairs,
               3 * qb + 2 * kb + 2 * stats)
        _count("flash_attention_bwd_dkv", 8 * Dh * pairs,
               2 * qb + 4 * kb + 2 * stats)
        return (torch.empty_like(q), torch.empty_like(k),
                torch.empty_like(v), None, None, None)


def flash_attention(q, k, v, *, causal: bool = True, group: int = 1,
                    sliding_window: int = 0):
    """q [B,T,Hq,Dh], k/v [B,S,Hkv,Dh] -> [B,T,Hq,Dh], differentiable: the
    forward is K2, the backward K4 + K5 (`flash_attention.FlashAttention`)."""
    if q.device.type == "meta":
        return _MetaFlash.apply(q, k, v, causal, group, sliding_window)
    return _fa.FlashAttention.apply(q, k, v, causal, group, sliding_window)


def decode_attention(q, k, v, lengths, *, group: int = 1, n_valid=None):
    """q [B,1,Hq,Dh] against cache k/v [B,S,Hkv,Dh]; lengths [B] valid
    slots. On meta tensors (whose lengths hold no values) `n_valid`, the
    valid slots of every row, sizes the count."""
    if q.device.type == "meta":
        B, _, Hq, Dh = q.shape
        n = B * (k.shape[1] if n_valid is None else n_valid)
        _count("decode_attention", 4 * Dh * Hq * n,
               2 * _nbytes(q) + 2 * n * k.shape[2] * Dh * k.element_size()
               + 4 * B)
        return torch.empty_like(q)
    return _da.decode_attention(q, k, v, lengths, group=group)


def sor_fit(x, y, w, log10_bound, guard, *, min_slope: float,
            min_spread_v: float, conf_samples: float):
    """Fused safe-operating-region fit over the `[window, n]` window.
    Returns (intercept, slope, v_frontier, confidence, n_eff, floor), each
    [n] f32."""
    return _ft.sor_fit(x, y, w, log10_bound, guard, min_slope=min_slope,
                       min_spread_v=min_spread_v, conf_samples=conf_samples)


def sor_accumulate(x, y, w):
    """The five EWLS sums (Σw, Σwx, Σwy, Σwx², Σwxy) over the `[window, n]`
    window, each [n] f32 (K7): the split fit's first stage."""
    return _ft.sor_accumulate(x, y, w)


def sor_accumulate_ring(v, obs, valid, age_s, *, cursor: int, decay: float,
                        age_halflife_s):
    """K7 on the SOR history ring as it stands (v, obs, valid [capacity,
    n_rails, n_chips], age_s [capacity, n_chips], `cursor` the next write
    slot): the five EWLS sums of its window, each [n_rails, n_chips] f32."""
    return _ft.sor_accumulate_ring(v, obs, valid, age_s, cursor=cursor,
                                   decay=decay,
                                   age_halflife_s=age_halflife_s)


def sor_refit(v, obs, valid, age_s, old, log10_bound, *, cursor: int,
              decay: float, age_halflife_s, update_gain: float,
              min_slope: float, min_spread_v: float, conf_samples: float):
    """One refit on cadence in one pass (K1's refit): the ring's window
    inputs, the sums, the solve and the blend into the old estimate (five
    [n_rails, n_chips] fields) -> the five new fields."""
    return _ft.sor_refit(v, obs, valid, age_s, old, log10_bound,
                         cursor=cursor, decay=decay,
                         age_halflife_s=age_halflife_s,
                         update_gain=update_gain, min_slope=min_slope,
                         min_spread_v=min_spread_v,
                         conf_samples=conf_samples)


def fleet_reduce(x):
    """x [n_chips, n_fields] -> (max, min, sum) over chips, each
    [n_fields] f32 (K6)."""
    return _ft.fleet_reduce(x)


def fleet_stats(power_w, t_chip_s, grad_error, energy_step_j, v_io,
                straggle, conf=None):
    """The fleet train step's reduction tail in one launch (K6's fold):
    five [n] f32 fields, the [n] bool straggle mask and, optionally, the
    SOR confidence -> {`fleet/*` key: 0-d f32}: worst (v_io: min) and mean
    of each field, t_fleet_s, the p95s of t_chip_s and grad_error, the
    straggler fraction, and the confidence's mean and min."""
    return _ft.fleet_stats(power_w, t_chip_s, grad_error, energy_step_j,
                           v_io, straggle, conf)


def _differentiated(*tensors) -> bool:
    """Whether a scan call must be differentiable: grad mode is on and an
    input requires a gradient (the serve paths run under `no_grad`)."""
    return torch.is_grad_enabled() and any(
        a is not None and a.requires_grad for a in tensors)


def rwkv6_scan(r, k, v, w, u, *, init_state=None, state_out=None):
    """RWKV6 recurrence (K9): r, k, v [B,T,H,Dh], w [B,T,H,Dh] f32
    log-decay, u [H,Dh] f32, init_state [B,H,Dh,Dh] f32 or None -> (y
    [B,T,H,Dh], final state [B,H,Dh,Dh] f32). With `state_out` the final
    state is written there (it may be `init_state`: in place) and it is
    the state returned. Under grad, with an input that requires one, the
    call is differentiable (`rwkv6_scan.Rwkv6Scan`: K9 forward, the plain
    version's gradient) and refuses `state_out`."""
    if r.device.type == "meta":
        return _meta_scan("rwkv6_scan", 5 * r.shape[3] ** 2 * r.shape[0]
                          * r.shape[1] * r.shape[2], (r, k, v, w, u),
                          init_state, state_out,
                          (r.shape[0], r.shape[2], r.shape[3], v.shape[3]))
    if _differentiated(r, k, v, w, u, init_state):
        return _r6.Rwkv6Scan.apply(r, k, v, w, u, init_state, state_out)
    return _r6.rwkv6_scan(r, k, v, w, u, init_state=init_state,
                          state_out=state_out)


def mamba2_scan(x, dt, A, B, C, D, *, init_state=None, state_out=None):
    """Mamba2 SSD scan (K8): x [Bt,T,H,P], dt [Bt,T,H] f32, A, D [H] f32,
    B, C [Bt,T,G,N], init_state [Bt,H,N,P] f32 or None -> (y [Bt,T,H,P],
    final state [Bt,H,N,P] f32). With `state_out` the final state is
    written there (it may be `init_state`: in place) and it is the state
    returned. Under grad, with an input that requires one, the call is
    differentiable (`mamba2_ssd.Mamba2Scan`: K8 forward, the plain
    version's gradient) and refuses `state_out`."""
    if x.device.type == "meta":
        b, t, h, p = x.shape
        return _meta_scan("mamba2_ssd", 5 * B.shape[3] * p * b * t * h,
                          (x, dt, A, B, C, D), init_state, state_out,
                          (b, h, B.shape[3], p))
    if _differentiated(x, dt, A, B, C, D, init_state):
        return _m2.Mamba2Scan.apply(x, dt, A, B, C, D, init_state, state_out)
    return _m2.mamba2_ssd(x, dt, A, B, C, D, init_state=init_state,
                          state_out=state_out)


class _MetaScan(torch.autograd.Function):
    """K8 / K9 on meta tensors: (y, final state) of the kernel's shapes and
    its costs; the backward (the plain version's gradient on the card,
    `ref.plain_vjp`) counted as twice the forward's operations, reading
    the forward's inputs and outputs and writing the inputs' gradients."""

    @staticmethod
    def forward(ctx, name, flops, state_shape, init_state, *inputs):
        ctx.name, ctx.flops = name, flops
        ctx.n_in = len(inputs)
        ctx.shapes = [(a.shape, a.dtype) for a in inputs]
        ctx.init = None if init_state is None else (init_state.shape,
                                                    init_state.dtype)
        y = torch.empty_like(inputs[0])
        state = torch.empty(state_shape, dtype=torch.float32,
                            device=inputs[0].device)
        ctx.io = _nbytes(*inputs, y, state, init_state)
        return y, state

    @staticmethod
    def backward(ctx, dy, dstate):
        _count(ctx.name + "_bwd_plain", 2 * ctx.flops, 2 * ctx.io,
               launches=0)
        grads = [torch.empty(s, dtype=d, device="meta")
                 for s, d in ctx.shapes]
        init = (None if ctx.init is None
                else torch.empty(ctx.init[0], dtype=ctx.init[1],
                                 device="meta"))
        return (None, None, None, init, *grads)


def _meta_scan(name, flops, inputs, init_state, state_out, state_shape):
    y, state = _MetaScan.apply(name, flops, state_shape, init_state,
                               *inputs)
    _count(name, flops, _nbytes(*inputs, y, state, init_state))
    return y, (state if state_out is None else state_out)


def quantize_int8(x, *, block: int = 256):
    """Blockwise symmetric int8 codec (K10): x any shape, f32 or bf16 ->
    (q [nblocks, block] int8, scale [nblocks, 1] f32), the tail block
    zero-padded."""
    return _qc.quantize_int8(x, block=block)


def ef_sync_leaf(g, r, thresholds=None):
    """One leaf of the error-feedback int8 sync in one pass (K10 fused):
    r (f32) becomes the new residual in place; returns (out f32, q int8,
    scale f32, num f32, den in g's dtype). `thresholds` [nblocks, 1] f32
    selects level 2 (top-k), None level 1."""
    return _qc.ef_sync_leaf(g, r, thresholds)


def fleet_percentile(x, q: float):
    """`[n_chips]` stat vector -> the q-th percentile, [] f32. Sort-bound,
    so the plain version runs on every device, as in the reference."""
    return ref.fleet_percentile_reference(x, q)


# ---------------------------------------------------------------------------
# the fleet's chip axis over a mesh
# ---------------------------------------------------------------------------

def axis_group(mesh, axis_name: str):
    """(process group, this rank's index, size) of `mesh`'s axis
    `axis_name`; raises for an axis the mesh does not have."""
    names = tuple(mesh.mesh_dim_names or ())
    if axis_name not in names:
        raise ValueError(f"mesh has axes {names}, not {axis_name!r}")
    return (mesh.get_group(axis_name), mesh.get_local_rank(axis_name),
            mesh.size(names.index(axis_name)))


def chip_block(mesh, n_chips: int, axis_name: str = "chips"
               ) -> tuple[int, int]:
    """This rank's chips on `mesh`'s `axis_name`: `[r n/P, (r+1) n/P)`."""
    _, r, size = axis_group(mesh, axis_name)
    if n_chips % size:
        raise ValueError(f"n_chips={n_chips} is not divisible by the mesh "
                         f"axis {axis_name!r} of size {size}")
    k = n_chips // size
    return r * k, (r + 1) * k


def gather_stack(x, group):
    """All-gather x over `group`: [P, *x.shape] in rank order, each rank's
    copy landing in its row of one buffer (a collective every rank of the
    group calls)."""
    import torch.distributed as dist
    out = x.new_empty((dist.get_world_size(group),) + tuple(x.shape))
    dist.all_gather(list(out.unbind(0)), x.contiguous(), group=group)
    return out


def _is_array(x) -> bool:
    return isinstance(x, (torch.Tensor, np.ndarray))


def _map_tree(fn, tree):
    """Rebuild `tree` with fn(leaf) at each tensor, ndarray or int leaf:
    through dicts and every field of a dataclass (set on a copy, so no
    `__post_init__` runs again); other values (the ring's rails, enums,
    floats, None) stay as they are."""
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        out = copy.copy(tree)
        for f in dataclasses.fields(tree):
            object.__setattr__(out, f.name, _map_tree(fn, getattr(tree,
                                                                 f.name)))
        return out
    if _is_array(tree) or (isinstance(tree, int)
                           and not isinstance(tree, bool)):
        return fn(tree)
    return tree


def _trailing(leaf, n: int) -> bool:
    return _is_array(leaf) and leaf.ndim >= 1 and leaf.shape[-1] == n


def chip_specs(tree, n_chips: int, axis_name: str = "chips"):
    """Per-leaf placement tree for a fleet-state tree: any tensor leaf whose
    *trailing* axis is the `[n_chips]` fleet axis shards it (`Shard(-1)`);
    every other leaf (the host integers such as `SorState.tick`, the
    window/rail leading axes of `FrameHistory`) replicates (`Replicate()`).
    The chip axis is trailing everywhere (`PowerPlaneState` `[n]`,
    `TelemetryFrame` `[n]`, `FrameHistory` `[capacity, n_rails, n]`,
    `SorEstimate` `[n_rails, n]`), so trailing-axis matching is exact.
    `axis_name` names the mesh axis the `Shard` placements stand for."""
    from torch.distributed.tensor import Replicate, Shard
    return _map_tree(lambda leaf: Shard(-1) if _trailing(leaf, n_chips)
                     else Replicate(), tree)


def shard_chip_tree(tree, mesh, n_chips: int, axis_name: str = "chips"):
    """This rank's block of a fleet-state tree on `mesh`'s `axis_name`
    (`chip_specs` placement): every leaf with the trailing `[n_chips]` axis
    becomes its contiguous `[..., lo:hi]` copy (`chip_block`), on its own
    device; replicated leaves pass through as they are. Works on any tree
    of dicts and dataclasses, a `FleetSpec`'s numpy arrays included."""
    lo, hi = chip_block(mesh, n_chips, axis_name)

    def take(leaf):
        if not _trailing(leaf, n_chips):
            return leaf
        block = leaf[..., lo:hi]
        return (block.contiguous().clone() if isinstance(leaf, torch.Tensor)
                else np.ascontiguousarray(block).copy())

    return _map_tree(take, tree)


def gather_chip_tree(tree, mesh, n_block: int, axis_name: str = "chips"):
    """The inverse of `shard_chip_tree`, a collective every rank of the
    axis calls: each tensor leaf with the trailing `[n_block]` axis (this
    rank's block) is all-gathered over the axis's group and joined along
    that axis in rank order, `[..., n_block * P]`; the rest passes through
    as it is."""
    group, _, _ = axis_group(mesh, axis_name)

    def gather(leaf):
        if not (isinstance(leaf, torch.Tensor) and _trailing(leaf, n_block)):
            return leaf
        if leaf.dtype == torch.bool:   # gloo gathers bytes, not bools
            return gather(leaf.to(torch.uint8)).to(torch.bool)
        return torch.cat(gather_stack(leaf, group).unbind(0), dim=-1)

    return _map_tree(gather, tree)


@functools.lru_cache(maxsize=None)
def _host_groups(ranks: tuple[int, ...]):
    import torch.distributed as dist
    return dist.new_group(ranks=list(ranks), backend="gloo")


def host_group(mesh, axis_name: str = "chips"):
    """A gloo group over the ranks of `mesh`'s `axis_name` (every rank of
    the world calls it, in the same order), for host (CPU) tensors
    whatever the mesh's own backend: the serve engine's bundle exchange."""
    import torch.distributed as dist
    group, _, _ = axis_group(mesh, axis_name)
    return _host_groups(tuple(dist.get_process_group_ranks(group)))


def sharded_fleet_reduce(x, *, mesh=None, axis_name: str = "chips",
                         use_shard_map: bool | None = None):
    """`fleet_reduce` over a fleet axis sharded across ranks.

    x is this rank's `[n_chips / P, n_fields]` block. When `mesh` spans more
    than one rank, each rank reduces its block through K6 (`fleet_reduce`),
    then the partials combine with `all_reduce` MAX, MIN and SUM over the
    axis's group: the per-chip telemetry never gathers. With `mesh=None`
    or a one-rank mesh it is the plain `fleet_reduce`; `use_shard_map=True`
    forces the collective path (tests take it on a one-rank mesh), keeping
    the reference's keyword."""
    import torch.distributed as dist
    if use_shard_map is None:
        use_shard_map = mesh is not None and mesh.size() > 1
    if not use_shard_map:
        return fleet_reduce(x)
    if mesh is None:
        raise ValueError("sharded_fleet_reduce needs a mesh for its "
                         "collectives")
    group, _, _ = axis_group(mesh, axis_name)
    mx, mn, sm = fleet_reduce(x)
    dist.all_reduce(mx, op=dist.ReduceOp.MAX, group=group)
    dist.all_reduce(mn, op=dist.ReduceOp.MIN, group=group)
    dist.all_reduce(sm, op=dist.ReduceOp.SUM, group=group)
    return mx, mn, sm
