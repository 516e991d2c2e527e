"""Sharding: logical-axis rules, activation constraints and parameter
placement trees (port of `repro/parallel/sharding.py`), path-name driven,
over `torch.distributed`'s `DeviceMesh` and DTensor placements.

Mesh axes (`launch/mesh.py`): ('pod', 'data', 'model') multi-pod or
('data', 'model') single-pod. Logical axes used by the models:

    batch   -> ('pod', 'data')   (replicated when the batch doesn't divide)
    seq     -> None
    heads/kv_heads/ff/experts_ff -> 'model'   (TP)
    vocab   -> 'model'
    fsdp    -> 'data'            (parameter/optimizer-state sharding)

What the port does with them:
- A spec is a `P`, a plain tuple with one entry per dim: `None`, an axis
  name, or a tuple of axis names; `tuple(P(...))` equals
  `tuple(jax.sharding.PartitionSpec(...))` entry for entry.
- The spec functions (`param_pspecs`, `cache_pspecs`, `resolve`) read only
  axis names and sizes: they take a `DeviceMesh` or a `SpecMesh` stand-in,
  so the production meshes (16 x 16, 2 x 16 x 16) give their spec trees
  without a world of 256 or 512 ranks.
- `NamedSharding(mesh, spec).placements` are the DTensor placements, one
  per mesh dim: `Shard(d)` where the spec names that mesh axis at tensor
  dim d, `Replicate()` otherwise. A tuple of axes on one dim is `Shard(d)`
  on each of their mesh dims, which DTensor nests in mesh-dim order: JAX's
  major-to-minor only when the tuple follows the mesh's order, so a tuple
  against it raises `ValueError`, as does an axis the mesh lacks or one
  named twice.
- `place(tree, shardings)` makes each leaf a DTensor from this rank's own
  block (no collective: every rank holds the whole leaf); `full_tensor`
  gathers one back with explicit `all_gather`s over its sharded mesh dims.
- `constrain(x, *logical)` returns `x` unchanged without an active mesh, as
  the reference does. Under `mesh_context` it redistributes a DTensor to
  the resolved placements and returns a plain tensor unchanged: in the
  placed train step (`train/step.py`) a plain activation is the rank's own
  rows of the batch-sharded activation, the local view of the reference's
  constraint. The spec is resolved (and checked against the mesh) either
  way.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import re
from typing import Any, NamedTuple

import numpy as np


def _normalize(entry):
    """An entry as `PartitionSpec` keeps it: a list as a tuple, a tuple of
    one axis as the axis, an empty tuple as None."""
    if isinstance(entry, (tuple, list)):
        entry = tuple(entry)
        if len(entry) <= 1:
            return entry[0] if entry else None
    return entry


class P(tuple):
    """A partition spec: one entry per tensor dim (None, an axis name or a
    tuple of axis names), normalized as `jax.sharding.PartitionSpec`
    normalizes its entries."""

    def __new__(cls, *axes):
        return super().__new__(cls, (_normalize(a) for a in axes))

    def __repr__(self) -> str:
        return "P(" + ", ".join(repr(a) for a in self) + ")"


class SpecMesh(NamedTuple):
    """A mesh's axis names and sizes, all the spec functions read: the
    production meshes' stand-in where no world of their size exists."""
    axis_names: tuple[str, ...]
    shape: tuple[int, ...]


def mesh_axes(mesh) -> dict[str, int]:
    """{axis name: size} of a `DeviceMesh`, a `SpecMesh` or anything with
    `axis_names` and `devices.shape` (a JAX mesh's fields)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    shape = mesh.shape if isinstance(mesh, SpecMesh) else mesh.devices.shape
    return dict(zip(mesh.axis_names, tuple(shape)))


def _axis_names(mesh) -> tuple[str, ...]:
    return tuple(mesh_axes(mesh))


_ACTIVE: contextvars.ContextVar = contextvars.ContextVar("repro_torch_mesh",
                                                        default=None)

DEFAULT_RULES: dict[str, Any] = {
    "batch": ("pod", "data"),
    "batch_nodp": None,        # long_500k: batch of 1 cannot shard
    "seq": None,
    "kv_seq": None,
    "embed": None,
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "ff": "model",
    "vocab": "model",
    "fsdp": "data",
    "experts": None,
    "ssm_heads": "model",
    "state": None,
}

def rules_for_mesh(mesh, overrides: dict | None = None) -> dict:
    rules = dict(DEFAULT_RULES)
    if "pod" not in _axis_names(mesh):
        rules["batch"] = ("data",)
    if overrides:
        rules.update(overrides)
    return rules


@contextlib.contextmanager
def mesh_context(mesh, overrides: dict | None = None):
    """Activates the (mesh, rules) pair that `constrain` resolves
    against."""
    token = _ACTIVE.set((mesh, rules_for_mesh(mesh, overrides)))
    try:
        yield
    finally:
        _ACTIVE.reset(token)


def active_mesh():
    st = _ACTIVE.get()
    return st[0] if st else None


def resolve(*logical: str | None) -> P:
    st = _ACTIVE.get()
    if st is None:
        return P()
    _, rules = st
    return P(*(rules.get(name) if name else None for name in logical))


def constrain(x, *logical: str | None):
    """The reference's `with_sharding_constraint` against the ambient mesh
    (no-op without one; see the module docstring)."""
    st = _ACTIVE.get()
    if st is None:
        return x
    mesh, _ = st
    placements = NamedSharding(mesh, resolve(*logical)).placements
    from torch.distributed.tensor import DTensor
    if isinstance(x, DTensor):
        return x.redistribute(mesh, placements)
    return x


_BATCH: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_batch_mean", default=None)


@contextlib.contextmanager
def batch_context(mean_fn):
    """Activates `mean_fn`, what `batch_mean` applies: the placed train
    step's mean over its data-parallel ranks."""
    token = _BATCH.set(mean_fn)
    try:
        yield
    finally:
        _BATCH.reset(token)


def batch_mean(x):
    """The mean over the data-parallel ranks of `x`, a statistic of this
    rank's rows that carries no gradient (the MoE's top-1 expert shares),
    where a placed step splits the batch over ranks: what the reference's
    global-batch statistic is where its batch is sharded. `x` itself
    elsewhere."""
    fn = _BATCH.get()
    return x if fn is None else fn(x)


# ---------------------------------------------------------------------------
# Placements
# ---------------------------------------------------------------------------

def _entry_axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    if isinstance(entry, (tuple, list)):
        return tuple(entry)
    return (entry,)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (the counterpart of `jax.sharding.NamedSharding`);
    `placements` are DTensor's (module docstring)."""
    mesh: Any
    spec: P

    def __post_init__(self):
        names = _axis_names(self.mesh)
        seen = set()
        for d, entry in enumerate(self.spec):
            axes = _entry_axes(entry)
            for a in axes:
                if a not in names:
                    raise ValueError(f"axis {a!r} of {self.spec} is not in "
                                     f"the mesh's axes {names}")
                if a in seen:
                    raise ValueError(f"axis {a!r} is named twice in "
                                     f"{self.spec}")
                seen.add(a)
            order = [names.index(a) for a in axes]
            if order != sorted(order):
                raise ValueError(
                    f"dim {d} of {self.spec} orders its axes {axes} against "
                    f"the mesh's {names}: DTensor nests a dim's shards in "
                    f"mesh order, so this layout has no placement")

    @property
    def shard_dims(self) -> tuple:
        """Per mesh dim, the tensor dim it shards (None: replicated)."""
        out = []
        for a in _axis_names(self.mesh):
            dims = [d for d, e in enumerate(self.spec)
                    if a in _entry_axes(e)]
            out.append(dims[0] if dims else None)
        return tuple(out)

    @property
    def placements(self) -> tuple:
        from torch.distributed.tensor import Replicate, Shard
        return tuple(Replicate() if d is None else Shard(d)
                     for d in self.shard_dims)


def _check_divides(shape, sharding: NamedSharding) -> None:
    sizes = list(mesh_axes(sharding.mesh).values())
    per_dim = {}
    for i, d in enumerate(sharding.shard_dims):
        if d is not None:
            if d >= len(shape):
                raise ValueError(f"{sharding.spec} shards dim {d} of a "
                                 f"rank-{len(shape)} leaf")
            per_dim[d] = per_dim.get(d, 1) * sizes[i]
    for d, n in per_dim.items():
        if shape[d] % n:
            raise ValueError(f"dim {d} of shape {tuple(shape)} does not "
                             f"divide into {n} blocks ({sharding.spec})")


def block_index(shape, sharding: NamedSharding, coord) -> tuple:
    """The slices of a leaf of `shape` that the rank at mesh coordinate
    `coord` holds: each sharded mesh dim, in mesh order, cuts its tensor
    dim into equal blocks (DTensor's nesting)."""
    _check_divides(shape, sharding)
    sizes = list(mesh_axes(sharding.mesh).values())
    start, length = [0] * len(shape), list(shape)
    for i, d in enumerate(sharding.shard_dims):
        if d is not None:
            length[d] //= sizes[i]
            start[d] += coord[i] * length[d]
    return tuple(slice(s, s + n) for s, n in zip(start, length))


def distinct_blocks(sizes, dims) -> list[tuple]:
    """The mesh coordinates whose blocks partition a leaf (`sizes`, the
    mesh's; `dims`, per mesh dim the tensor dim it shards or None), in rank
    order: coordinate 0 on every mesh dim the leaf is replicated over."""
    return [tuple(int(c) for c in idx) for idx in np.ndindex(
        *[n if d is not None else 1 for n, d in zip(sizes, dims)])]


def distinct_coords(sharding: NamedSharding) -> list[tuple]:
    """`distinct_blocks` of a leaf under `sharding`."""
    return distinct_blocks(list(mesh_axes(sharding.mesh).values()),
                           sharding.shard_dims)


def _coordinate(mesh) -> tuple:
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError("this rank is not in the mesh")
    return tuple(coord)


def local_block(full, sharding: NamedSharding):
    """This rank's block of the whole leaf `full` (a tensor or a numpy
    array), as a contiguous copy."""
    idx = block_index(tuple(full.shape), sharding,
                      _coordinate(sharding.mesh))
    if isinstance(full, np.ndarray):
        return np.array(full[idx], order="C")
    block = full[idx]
    import torch
    return block.clone(memory_format=torch.contiguous_format)


def from_block(block, sharding: NamedSharding, shape):
    """A DTensor on the sharding's mesh from this rank's `block` of a leaf
    of `shape`."""
    import torch
    from torch.distributed.tensor import DTensor
    stride = tuple(int(s) for s in torch.empty(
        tuple(shape), device="meta").stride())
    return DTensor.from_local(block, sharding.mesh, sharding.placements,
                              run_check=False, shape=torch.Size(shape),
                              stride=stride)


def _tree_map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def place(tree, shardings):
    """Each leaf of `tree` (the whole leaf, the same on every rank) as a
    DTensor holding this rank's block under the matching leaf of
    `shardings` (a tree of `NamedSharding`s). No collective runs."""
    import torch

    def one(leaf, sh):
        with torch.no_grad():
            return from_block(local_block(leaf.detach(), sh), sh,
                              tuple(leaf.shape))
    return _tree_map(one, tree, shardings)


def sharding_of(dt) -> tuple:
    """(mesh, per mesh dim the tensor dim it shards or None) of a
    DTensor."""
    from torch.distributed.tensor import Shard
    return dt.device_mesh, tuple(p.dim if isinstance(p, Shard) else None
                                 for p in dt.placements)


def full_tensor(dt):
    """The whole leaf of a DTensor as a plain tensor, gathered with one
    `all_gather` (list form) a sharded mesh dim, innermost first. Every
    rank of the mesh calls it."""
    import torch
    import torch.distributed as dist
    mesh, dims = sharding_of(dt)
    x = dt.to_local()
    for i in reversed(range(len(dims))):
        d = dims[i]
        if d is None:
            continue
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(mesh.size(i))]
        dist.all_gather(parts, x, group=mesh.get_group(i))
        x = torch.cat(parts, d)
    return x


# ---------------------------------------------------------------------------
# Parameter specs by path-name convention
# ---------------------------------------------------------------------------

def _p(*axes):
    return lambda shape: P(*axes[: len(shape)]) if len(axes) >= len(shape) \
        else P(*(list(axes) + [None] * (len(shape) - len(axes))))


PARAM_RULES: list[tuple[str, Any]] = [
    # embeddings / unembedding
    (r"embed$", _p("model", "fsdp")),                    # [Vp, D]
    (r"lm_head$", _p("fsdp", "model")),                  # [D, Vp]
    # attention
    (r"\bwq$", _p("fsdp", "model", None)),               # [D, Hq, Dh]
    (r"\bwk$", _p("fsdp", "model", None)),
    (r"\bwv$", _p("fsdp", "model", None)),
    (r"\bwo$", _p("model", None, "fsdp")),               # [Hq, Dh, D]
    (r"\bb[qkv]$", _p("model", None)),                   # [H, Dh]
    # dense mlp
    (r"w_gate$", _p("fsdp", "model")),                   # [D, F]
    (r"w_in$", _p("fsdp", "model")),
    (r"w_out$", _p("model", "fsdp")),                    # [F, D]
    (r"b_in$", _p("model")),
    (r"b_out$", _p(None)),
    # moe (leading E dim; experts replicated, ff TP + fsdp)
    (r"moe.*router$", _p("fsdp", None)),                 # [D, E]
    (r"moe.*w_gate$", _p(None, "fsdp", "model")),        # [E, D, F]
    (r"moe.*w_in$", _p(None, "fsdp", "model")),
    (r"moe.*w_out$", _p(None, "model", "fsdp")),         # [E, F, D]
    # mamba2
    (r"mamba.*w_z$", _p("fsdp", "model")),               # [D, Din]
    (r"mamba.*w_x$", _p("fsdp", "model")),
    (r"mamba.*w_B$", _p("fsdp", None)),                  # [D, G*N] tiny
    (r"mamba.*w_C$", _p("fsdp", None)),
    (r"mamba.*w_dt$", _p("fsdp", "model")),              # [D, H]
    (r"mamba.*conv_x_w$", _p(None, "model")),
    (r"mamba.*conv_[BC]_w$", _p(None, None)),
    (r"mamba.*conv_x_b$", _p("model")),
    (r"mamba.*conv_[BC]_b$", _p(None)),
    (r"mamba.*(A_log|dt_bias)$", _p("model")),           # [H]
    (r"mamba.*\bD$", _p("model")),
    (r"mamba.*norm_w$", _p("model")),                    # [Din]
    (r"mamba.*w_out$", _p("model", "fsdp")),             # [Din, D]
    # rwkv6
    (r"rwkv.*w_[rkvg]$", _p("fsdp", "model")),           # [D, D]
    (r"rwkv.*w_o$", _p("model", "fsdp")),
    (r"rwkv.*mix_base$", _p(None, None)),
    (r"rwkv.*mix_w1$", _p("fsdp", None)),
    (r"rwkv.*mix_w2$", _p(None, None, None)),
    (r"rwkv.*decay_base$", _p(None)),
    (r"rwkv.*decay_w1$", _p("fsdp", None)),
    (r"rwkv.*decay_w2$", _p(None, "model")),
    (r"rwkv.*bonus_u$", _p("model", None)),              # [H, Dh]
    (r"rwkv.*ln_x_[wb]$", _p(None)),
    (r"rwkv.*cmix_[kr]$", _p(None)),
    (r"rwkv.*cm_wk$", _p("fsdp", "model")),
    (r"rwkv.*cm_wv$", _p("model", "fsdp")),
    (r"rwkv.*cm_wr$", _p("fsdp", "model")),
    # int8 optimizer moments: flat [n_blocks, block]/[n_blocks, 1] arrays,
    # FSDP-sharded over the block dim when divisible
    (r"\.q$", _p("fsdp", None)),
    (r"\.scale$", _p("fsdp", None)),
    # norms / misc scalars+vectors
    (r"(ln|norm).*(_w|_b|weight|bias)?$", _p(None)),
]

# expert parallelism (E % model == 0): experts over 'model', per-expert F
# kept full-width. Consulted before the base table under the moe_ep
# profile.
PARAM_RULES_MOE_EP: list[tuple[str, Any]] = [
    (r"moe.*router$", _p("fsdp", None)),
    (r"moe.*w_gate$", _p("model", "fsdp", None)),
    (r"moe.*w_in$", _p("model", "fsdp", None)),
    (r"moe.*w_out$", _p("model", None, "fsdp")),
]


def spec_for_path(path: str, shape: tuple[int, ...], *,
                  moe_ep: bool = False) -> P:
    if moe_ep:
        for pat, make_spec in PARAM_RULES_MOE_EP:
            if re.search(pat, path):
                return make_spec(shape)
    for pat, make_spec in PARAM_RULES:
        if re.search(pat, path):
            return make_spec(shape)
    return P(*([None] * len(shape)))


def _axis_size(mesh, name) -> int:
    """Axis size; 0 for axes absent from this mesh (caller drops them)."""
    if name is None:
        return 1
    if isinstance(name, (tuple, list)):
        s = 1
        for n in name:
            sz = _axis_size(mesh, n)
            if sz == 0:
                return 0
            s *= sz
        return s
    return mesh_axes(mesh).get(name, 0)


def _validate_divisible(spec: P, shape: tuple[int, ...], mesh,
                        path: str) -> P:
    """Drop sharding on dims the mesh axis doesn't divide, or axes the mesh
    doesn't have (tests/examples on smaller meshes)."""
    out = []
    for dim, ax in zip(shape, tuple(spec) + (None,) * (len(shape)
                                                       - len(spec))):
        size = _axis_size(mesh, ax)
        if ax is not None and (size == 0 or dim % size != 0):
            out.append(None)
        else:
            out.append(ax)
    return P(*out)


def _rewrite_fsdp(spec: P, fsdp_axes) -> P:
    return P(*((fsdp_axes if ax == "fsdp" else ax) for ax in spec))


def _map_with_path(fn, tree, prefix=()):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, prefix + (k,))
                for k, v in tree.items()}
    return fn(prefix, tree)


def param_pspecs(abstract_params, mesh, *, fsdp="data", moe_ep=False,
                 stacked_prefixes: tuple[str, ...] = ("blocks", "enc_blocks",
                                                      "dec_blocks")):
    """Spec tree for a parameter tree (nested dicts of tensors, meta ones
    included; the path is the dot-joined keys).

    Stacked (layer-stacked) params carry a leading L dim which is never
    sharded: rules are applied to the trailing dims and shifted right."""
    def one(path_tuple, leaf):
        path = ".".join(str(k) for k in path_tuple)
        shape = tuple(leaf.shape)
        # int8-optimizer moment leaves (…/q, …/scale) are flat block arrays,
        # never layer-stacked even when their path mentions 'blocks'
        flat_moment = re.search(r"\.(q|scale)$", path) is not None
        stacked = (not flat_moment and len(shape) >= 1
                   and any(seg in stacked_prefixes for seg in path.split(".")))
        eff_shape = shape[1:] if stacked else shape
        spec = spec_for_path(path, tuple(eff_shape), moe_ep=moe_ep)
        spec = _rewrite_fsdp(spec, fsdp)
        if fsdp is not None and not isinstance(fsdp, str):
            # wide-FSDP profiles shard params over (data, model): drop the
            # 'model' TP assignment so dims aren't double-sharded
            spec = P(*((None if ax == "model" else ax) for ax in spec))
        spec = _validate_divisible(spec, tuple(eff_shape), mesh, path)
        if stacked:
            spec = P(None, *spec)
        return spec

    return _map_with_path(one, abstract_params)


def named_shardings(abstract_params, mesh, **kw):
    specs = param_pspecs(abstract_params, mesh, **kw)
    return _tree_map(lambda s: NamedSharding(mesh, s), specs)


# ---------------------------------------------------------------------------
# Decode-cache specs (leading stacked layer/occurrence axis)
# ---------------------------------------------------------------------------

def cache_pspecs(abstract_cache, mesh, *, batch_axes) -> Any:
    """Shard decode caches: batch over the DP axes, heads over 'model'.

    Leaf layouts (leading L = stacked layers/occurrences):
      k/v        [L,B,S,Hkv,Dh] -> (None, batch, None, 'model', None)
      wkv        [L,B,H,Dk,Dv]  -> (None, batch, 'model', None, None)
      ssm state  [L,B,H,N,P]    -> (None, batch, 'model', None, None)
      conv state [L,B,W-1,C]    -> (None, batch, None, 'model')
      *_last     [L,B,1,D]      -> (None, batch, None, None)
    Dims that don't divide fall back to replication (validated)."""
    def one(path_tuple, leaf):
        path = ".".join(str(k) for k in path_tuple)
        shape = tuple(leaf.shape)
        rank = len(shape)
        if re.search(r"(^|\.)([kv]|wkv)$", path) and rank == 5:
            spec = P(None, batch_axes, None, "model", None)
        elif rank == 5:
            spec = P(None, batch_axes, "model", None, None)
        elif rank == 4 and shape[-1] % _axis_size(mesh, "model") == 0 \
                and "last" not in path:
            spec = P(None, batch_axes, None, "model")
        elif rank >= 2:
            spec = P(*((None, batch_axes) + (None,) * (rank - 2)))
        else:
            spec = P(*([None] * rank))
        return _validate_divisible(spec, shape, mesh, path)

    return _map_with_path(one, abstract_cache)
