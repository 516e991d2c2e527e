"""Error-bounded collectives (port of `repro/core/ecollectives.py`): the
gradient-domain analogue of the paper's bounded-BER link. Gradients are
compressed on the wire (blockwise int8, optionally top-k sparsified), the
compression residual is carried forward with error feedback so the error
stays bounded over training, and the relative L2 error is the step's
`grad_error` observable that `policy.BERBounded` reads.

Compression levels (the "voltage knob" of the ICI rail):
    0  lossless     : bf16/f32 psum
    1  int8 + EF    : blockwise int8 quantized
    2  int8+topk+EF : additionally top-k sparsified

The codec's quantize is K10 (`kernels.ops.quantize_int8`, the CUDA kernel
on a CUDA tensor), as the reference's docstring says its module does on
the TPU; dequantize, `topk_mask` and the norms are torch ops, as the
reference leaves them to XLA. The train step's sync does not compose them:
`ef_sync_leaf_` runs one leaf's `ef_compress_leaf_`, `error_sums` and
`reduce_leaf(..., LEVEL_INT8)` as one pass (`kernels.ops.ef_sync_leaf`,
K10's codec fused with the arithmetic around it), equal to the composed
sequence bit for bit (its two sums up to their order on the card).

Axes and worlds. The reference's collectives name a `shard_map` axis;
the port's name an axis bound to a `torch.distributed` process group by
`train.step.shard_map_ef_step` (or `bound_axes`). An unbound axis is the
reference's one-device world: the all-gather stacks one copy, `psum(1)`
is 1 and `pmean(loss)` is the loss, and the whole sequence still runs
(quantize, a gather of one, the dequantize-sum). A bound axis of P ranks
runs the collectives over its group: `psum_lossless` is an `all_reduce`,
`psum_int8` quantizes locally (K10), all-gathers the int8 codes and f32
scales and adds the P dequantized payloads in rank order, as the
reference's `jnp.sum(axis=0)` does. An unbound axis in a started world
larger than one raises: the step must run under `shard_map_ef_step`.

Unlike the reference's pure `ef_compress`, the port's updates the residual
tree in place (the counterpart of a donated buffer) and returns it.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch

from repro_torch.kernels import ops
from repro_torch.models.lm import tree_map
from repro_torch.optim.adamw import get_path, leaf_paths

DEFAULT_BLOCK = 256
LEVEL_LOSSLESS, LEVEL_INT8, LEVEL_INT8_TOPK = 0, 1, 2


# ---------------------------------------------------------------------------
# Blockwise int8 quantization (the codec; LINEAR16 analogue for gradients)
# ---------------------------------------------------------------------------

def _pad_to_block(x, block: int):
    flat = x.reshape(-1)
    pad = (-flat.numel()) % block
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat, pad


def quantize_int8(x, block: int = DEFAULT_BLOCK):
    """Blockwise symmetric int8 quantization through K10. Returns
    (q [nblocks, block] int8, scales [nblocks, 1] f32)."""
    return ops.quantize_int8(x.contiguous(), block=block)


def dequantize_int8(q, scale, shape, dtype=torch.float32):
    flat = q.to(torch.float32).mul_(scale).reshape(-1)
    n = 1
    for d in shape:
        n *= d
    return flat[:n].reshape(shape).to(dtype)


def dequantize_like(blocks_sum, x):
    flat = blocks_sum.reshape(-1)[: x.numel()]
    return flat.reshape(x.shape).to(x.dtype)


def topk_mask(x, k_fraction: float, block: int = DEFAULT_BLOCK):
    """Keep the round(k_fraction * block) largest magnitudes of each block
    (at least one; ties at the threshold are all kept), zero the rest."""
    flat, pad = _pad_to_block(x, block)
    blocks = flat.reshape(-1, block)
    mag = blocks.abs()
    out = torch.where(mag >= _kth_largest(mag, k_fraction, block), blocks,
                      0.0).reshape(-1)
    if pad:
        out = out[:-pad]
    return out.reshape(x.shape)


def _kth_largest(mag, k_fraction: float, block: int):
    """Each row's round(k_fraction * block)-th largest value (at least the
    first), [nblocks, 1]: the k-th largest is the (block - k + 1)-th
    smallest."""
    k = max(1, int(round(k_fraction * block)))
    return mag.kthvalue(block - k + 1, dim=1, keepdim=True).values


def topk_thresholds(x, k_fraction: float, block: int = DEFAULT_BLOCK):
    """`topk_mask`'s per-block thresholds of x: the least |x| a block keeps,
    over zero-padded blocks, [nblocks, 1] in x's dtype. Takes |x| in place
    when x needs no padding, so the caller passes a temporary."""
    flat, _ = _pad_to_block(x, block)
    return _kth_largest(flat.reshape(-1, block).abs_(), k_fraction, block)


# ---------------------------------------------------------------------------
# Compressed reduction over a data-parallel axis
# ---------------------------------------------------------------------------

# axis name -> the process group it is bound to (`bound_axes`)
_BOUND: dict = {}


@contextlib.contextmanager
def bound_axes(groups: dict):
    """Bind axis names to `torch.distributed` process groups for the
    collectives called inside (the counterpart of `shard_map`'s axis
    names); `train.step.shard_map_ef_step` binds its mesh's DP axes."""
    saved = dict(_BOUND)
    _BOUND.update(groups)
    try:
        yield
    finally:
        _BOUND.clear()
        _BOUND.update(saved)


def axis_group(axis_name):
    """The process group bound to `axis_name`, or None for the one-device
    world (an unbound axis and no started world larger than one)."""
    if axis_name in _BOUND:
        return _BOUND[axis_name]
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1:
        raise ValueError(
            f"axis {axis_name!r} is not bound to a process group in a world "
            f"of {dist.get_world_size()}: run the step under "
            f"train.step.shard_map_ef_step (or ecollectives.bound_axes)")
    return None


def axis_size(axis_name) -> int:
    """Replicas along `axis_name`: its group's size, 1 unbound."""
    import torch.distributed as dist
    group = axis_group(axis_name)
    return 1 if group is None else dist.get_world_size(group)


def _divide(x, size: int):
    """x / size in x's dtype as a true division (the reference divides by
    the traced `psum(1)`; torch on the card divides by a Python number as
    a multiply by its reciprocal)."""
    if size == 1:
        return x
    return x / torch.full((), size, dtype=x.dtype, device=x.device)


def pmean(x, axis_name):
    """The mean of x over `axis_name`'s replicas (x itself unbound)."""
    import torch.distributed as dist
    group = axis_group(axis_name)
    if group is None:
        return x
    y = x.clone()
    dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
    return _divide(y, dist.get_world_size(group))


def psum_lossless(x, axis_name):
    import torch.distributed as dist
    group = axis_group(axis_name)
    if group is None:
        return x
    y = x.clone()
    dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
    return y


def gather_codes(q, s, axis_name):
    """All-gather one payload's int8 codes [nblk, block] and f32 scales
    [nblk, 1] over `axis_name`: ([P, nblk, block], [P, nblk, 1]) in rank
    order (P = 1, the payload itself, unbound)."""
    group = axis_group(axis_name)
    if group is None:
        return q[None], s[None]
    return ops.gather_stack(q, group), ops.gather_stack(s, group)


# rows of blocks a dequantize-and-sum pass takes at once: one rank's f32
# term over them is 64 MB at 256-element blocks
SUM_ROWS = 1 << 16
# rows of blocks the fused sync gathers at once: 64 MB of int8 codes a rank
GATHER_ROWS = 1 << 18


def dequantize_sum(qg, sg, out=None):
    """sum_p qg[p] * sg[p] in f32, [nblk, block] (into `out` when given):
    the ranks added in rank order (((d0 + d1) + d2) + ...), each product
    rounded before its add, SUM_ROWS rows at a time."""
    size, nblk, block = qg.shape
    total = (torch.empty((nblk, block), dtype=torch.float32,
                         device=qg.device) if out is None else out)
    for lo in range(0, nblk, SUM_ROWS):
        hi = min(nblk, lo + SUM_ROWS)
        acc = total[lo:hi]
        torch.mul(qg[0, lo:hi], sg[0, lo:hi], out=acc)
        for p in range(1, size):
            acc.add_(qg[p, lo:hi].to(torch.float32).mul_(sg[p, lo:hi]))
    return total


def psum_int8(x, axis_name, block: int = DEFAULT_BLOCK):
    """Bounded-error sum over `axis_name`: quantize locally to int8 (K10),
    gather the codes and scales of every replica, dequantize and sum in
    rank order."""
    q, s = quantize_int8(x, block)
    return dequantize_like(dequantize_sum(*gather_codes(q, s, axis_name)), x)


def psum_int8_topk(x, axis_name, k_fraction: float = 0.25,
                   block: int = DEFAULT_BLOCK):
    """Level 2: top-k sparsify, then the int8 sum."""
    return psum_int8(topk_mask(x, k_fraction, block), axis_name, block)


def reduce_leaf(g, axis_name, level: int, k_fraction: float = 0.25,
                mean: bool = True):
    """One leaf of `reduce_gradients`."""
    if level == LEVEL_LOSSLESS:
        out = psum_lossless(g, axis_name)
    elif level == LEVEL_INT8:
        out = psum_int8(g, axis_name)
    elif level == LEVEL_INT8_TOPK:
        out = psum_int8_topk(g, axis_name, k_fraction)
    else:
        raise ValueError(f"unknown compression level {level}")
    return _divide(out, axis_size(axis_name)) if mean else out


def reduce_gradients(grads, axis_name, level: int, k_fraction: float = 0.25,
                     mean: bool = True):
    """Reduce a gradient tree across `axis_name` at a compression level."""
    return tree_map(lambda g: reduce_leaf(g, axis_name, level, k_fraction,
                                          mean), grads)


# ---------------------------------------------------------------------------
# Error feedback (keeps the compression error bounded over training)
# ---------------------------------------------------------------------------

def ef_compress_leaf_(g, r, level: int, k_fraction: float = 0.25,
                      block: int = DEFAULT_BLOCK):
    """One leaf of `ef_compress` at level 1 or 2: r becomes corrected =
    g + r in place, g_hat = dequantize(quantize(corrected, top-k'd at
    level 2)) and then r = corrected - g_hat. Returns g_hat (f32, as r)."""
    corrected = r.add_(g)
    kept = (topk_mask(corrected, k_fraction, block)
            if level == LEVEL_INT8_TOPK else corrected)
    q, s = quantize_int8(kept, block)
    del kept
    g_hat = dequantize_int8(q, s, corrected.shape, corrected.dtype)
    corrected.sub_(g_hat)
    return g_hat


def ef_sync_leaf_(g, r, level: int, axis_name, k_fraction: float = 0.25):
    """One leaf of the reference's ef sync (`step.py:143-157`) in one pass:
    `ef_compress_leaf_` (r becomes (g + r) - g_hat in place), the leaf's
    `error_sums` and `reduce_leaf(g_hat, axis_name, LEVEL_INT8)`, through
    K10's fused kernel on a CUDA tensor (`ops.ef_sync_leaf`). Returns (the
    reduced leaf, f32; sum (g - g_hat)^2; sum g^2). At level 2 the
    per-block thresholds are `topk_thresholds(g + r)`, an n-element f32
    temporary while they are taken (2.1 GB at MiniCPM-2B's 530.8 M-element
    MLP leaves).

    Unbound, the pass's own output is the reduced leaf (the world of one:
    the mean is the sum). Over a bound axis of P ranks the pass's codes
    and scales (the wire codec's) are all-gathered, GATHER_ROWS blocks at
    a time, and the reduced leaf is their dequantize-and-sum in rank order
    (`dequantize_sum`) divided by P in place; the pass's local dequantize
    is dropped."""
    if level not in (LEVEL_INT8, LEVEL_INT8_TOPK):
        raise ValueError(f"ef_sync_leaf_ takes level 1 or 2, got {level}")
    group = axis_group(axis_name)
    thresholds = (topk_thresholds(r + g, k_fraction)
                  if level == LEVEL_INT8_TOPK else None)
    out, q, s, num, den = ops.ef_sync_leaf(g.contiguous(), r, thresholds)
    if group is not None:
        del out
        total = torch.empty(q.shape, dtype=torch.float32, device=q.device)
        for lo in range(0, q.shape[0], GATHER_ROWS):
            hi = min(q.shape[0], lo + GATHER_ROWS)
            qg, sg = gather_codes(q[lo:hi], s[lo:hi], axis_name)
            dequantize_sum(qg, sg, out=total[lo:hi])
            del qg, sg
        size = axis_size(axis_name)
        total.div_(torch.full((), size, dtype=torch.float32,
                              device=total.device))
        out = total.reshape(-1)[:g.numel()].reshape(g.shape)
    return out, num, den


def ef_compress(grads, residuals, level: int, k_fraction: float = 0.25,
                block: int = DEFAULT_BLOCK):
    """Error-feedback transform: g' = compress(g + r); r' = (g + r) - g'.
    Returns (g', residuals), the residual tree updated in place. At level 0
    both come back unchanged."""
    if level == LEVEL_LOSSLESS:
        return grads, residuals
    own_residuals(residuals)
    return tree_map(lambda g, r: ef_compress_leaf_(g, r, level, k_fraction,
                                                   block),
                    grads, residuals), residuals


def zeros_like_residuals(params):
    """f32 zeros shaped like every parameter leaf (nested dicts), on the
    leaves' devices, each a broadcast view of one zero: the tree holds no
    memory until the ef sync first writes it (`own_residuals`). A step
    without the ef sync passes it through untouched; as f32 tensors it
    would hold 4 bytes a parameter (30.3 GB at RWKV6-7B)."""
    return tree_map(lambda p: torch.zeros(
        (), dtype=torch.float32, device=p.device).expand(p.shape), params)


def own_residuals(residuals):
    """Give each leaf of a residual tree memory of its own, in place (a
    broadcast view from `zeros_like_residuals` becomes a tensor of zeros),
    so the error feedback can write it; returns the tree."""
    for path in leaf_paths(residuals):
        r = get_path(residuals, path)
        if not r.is_contiguous():
            get_path(residuals, path[:-1])[path[-1]] = r.contiguous()
    return residuals


# ---------------------------------------------------------------------------
# Wire-byte accounting (feeds the step model + energy model)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class WireCost:
    bytes_per_element: float     # on-wire bytes per gradient element per device
    description: str


def wire_cost(level: int, k_fraction: float = 0.25,
              elem_bytes: int = 2, block: int = DEFAULT_BLOCK) -> WireCost:
    """Ring-collective wire bytes per gradient element (per device).

    Lossless ring all-reduce: 2 passes x elem_bytes. int8 all-gather +
    local reduce: 1 byte + scales overhead. top-k: fraction kept + scales."""
    scale_overhead = 4.0 / block
    if level == LEVEL_LOSSLESS:
        return WireCost(2.0 * elem_bytes, "ring all-reduce bf16")
    if level == LEVEL_INT8:
        return WireCost(1.0 + scale_overhead, "int8 all-gather + local reduce")
    if level == LEVEL_INT8_TOPK:
        return WireCost(k_fraction * 1.0 + scale_overhead + 0.25,
                        "top-k int8 (+index bitmap) all-gather + local reduce")
    raise ValueError(f"unknown level {level}")


def error_sums(g, g_hat):
    """One leaf's terms of `compression_error_norm`: (sum (g - g_hat)^2,
    sum g^2), each in the dtype the reference's sums take."""
    return ((g - g_hat) ** 2).sum(), (g ** 2).sum()


def error_norm_from_sums(num, den):
    return torch.sqrt(num / torch.clamp(den, min=1e-30))


def compression_error_norm(grads, grads_hat):
    """Relative L2 error — the gradient-domain 'BER' telemetry channel;
    leaves summed in the reference's (sorted-key) tree order."""
    num = den = 0
    for path in leaf_paths(grads):
        n, d = error_sums(get_path(grads, path), get_path(grads_hat, path))
        num, den = num + n, den + d
    return error_norm_from_sums(num, den)
