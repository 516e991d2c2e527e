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
  placed paths a plain activation is the rank's own block of the
  reference's (its rows of the batch, its heads, ff or vocab), the local
  view of the reference's constraint. The spec is resolved (and checked
  against the mesh) either way.
- Tensor parallelism over 'model' (the section below): the Megatron
  region functions over the 'model' group, `tp_plan` (which leaves the
  forward keeps as blocks), the placed serve paths' helpers, and
  `run_model_ranks`, a one-process emulation of the axis that the tests'
  and the card's oracles use.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import re
from typing import Any, NamedTuple

import numpy as np
import torch
import torch.distributed as dist


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
    return block.clone(memory_format=torch.contiguous_format)


def from_block(block, sharding: NamedSharding, shape):
    """A DTensor on the sharding's mesh from this rank's `block` of a leaf
    of `shape`."""
    from torch.distributed.tensor import DTensor
    stride, n = [], 1
    for d in reversed(tuple(shape)):
        stride.insert(0, n)
        n *= max(int(d), 1)
    return DTensor.from_local(block, sharding.mesh, sharding.placements,
                              run_check=False, shape=torch.Size(shape),
                              stride=tuple(stride))


def _tree_map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def place(tree, shardings):
    """Each leaf of `tree` (the whole leaf, the same on every rank) as a
    DTensor holding this rank's block under the matching leaf of
    `shardings` (a tree of `NamedSharding`s). No collective runs."""

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


# ---------------------------------------------------------------------------
# Tensor parallelism over 'model'
# ---------------------------------------------------------------------------
#
# A leaf placed over 'model' alone on one of its dims (heads, kv heads, ff,
# vocab, ssm heads, experts under moe_ep) reaches the model as this rank's
# block, and the layer computes on that block: the Megatron regions. A
# replicated activation enters rank-local work through `copy` (identity
# forward, all-reduce of the gradient backward), and a rank-local partial
# leaves it through `reduce` (all-reduce forward, identity backward), so a
# leaf replicated over 'model' gets its whole gradient on every rank and a
# block leaf its block's. The model code asks `tp_local(n_local, n_full)`
# whether a leaf's dim holds a block; with no group, or one of one rank,
# nothing changes and no collective runs. `model_group()` is the group of
# the active context: a `model_group_context`'s, else the 'model' axis of
# `mesh_context`'s mesh. The all-reduces are plain `dist.all_reduce`s: at
# two ranks a sum of two terms is the same bits in either order, which is
# what a one-process emulation (`run_model_ranks`, rank-order sums) makes.

_MODEL_GROUP: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_model_group", default=None)


@contextlib.contextmanager
def model_group_context(group):
    """Activates `group` (a `DistModelGroup` or a `ThreadModelGroup`, or
    None for no TP) as what `model_group` returns."""
    token = _MODEL_GROUP.set(group if group is not None else False)
    try:
        yield
    finally:
        _MODEL_GROUP.reset(token)


def mesh_model_group(mesh):
    """The TP group of `mesh`'s 'model' axis, None where the mesh has no
    such axis or it holds one rank."""
    names = tuple(getattr(mesh, "mesh_dim_names", None) or ())
    if "model" not in names or mesh.size(names.index("model")) == 1:
        return None
    return DistModelGroup(mesh.get_group("model"),
                          mesh.get_local_rank("model"),
                          mesh.size(names.index("model")))


def model_group():
    """The active TP group, or None (module note above)."""
    g = _MODEL_GROUP.get()
    if g is not None:
        return g or None
    st = _ACTIVE.get()
    if st is None or not hasattr(st[0], "get_group"):
        return None
    return mesh_model_group(st[0])


def tp_local(n_local: int, n_full: int):
    """The TP group when a leaf's dim holds `n_local` of its `n_full`
    entries (this rank's block along 'model'), None when it holds them
    all. The block's global offset is `group.rank * n_local`."""
    if n_local == n_full:
        return None
    tp = model_group()
    if tp is None or n_local * tp.size != n_full:
        raise ValueError(
            f"a leaf holds {n_local} of {n_full} entries along a dim, which "
            f"is not a block of the active model group "
            f"({None if tp is None else tp.size} ranks)")
    return tp


def _rank_sum(parts):
    acc = parts[0].clone()
    for p in parts[1:]:
        acc.add_(p)
    return acc


class _Copy(torch.autograd.Function):
    """copy to the model region: identity forward, all-reduce backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _Reduce(torch.autograd.Function):
    """reduce from the model region: all-reduce forward, identity
    backward."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    """gather from the model region along `dim`: all-gather forward, this
    rank's block of the gradient backward."""

    @staticmethod
    def forward(ctx, x, dim, group, rank, size):
        ctx.dim, ctx.rank, ctx.n = dim, rank, x.shape[dim]
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(size)]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts, dim)

    @staticmethod
    def backward(ctx, g):
        return (g.narrow(ctx.dim, ctx.rank * ctx.n, ctx.n), None, None, None,
                None)


class DistModelGroup:
    """The ranks along 'model' over `torch.distributed`: `rank`, `size`
    and the region functions on the axis's process group."""

    def __init__(self, group, rank: int, size: int):
        self.group, self.rank, self.size = group, rank, size

    def copy(self, x):
        return _Copy.apply(x, self.group)

    def reduce(self, x):
        return _Reduce.apply(x, self.group)

    def allsum(self, x):
        """The sum over the ranks of a statistic that then enters
        rank-local work: all-reduce forward and backward."""
        return self.copy(self.reduce(x))

    def gather(self, x, dim: int):
        return _Gather.apply(x, dim, self.group, self.rank, self.size)

    def max(self, x):
        """The elementwise max over the ranks, without a gradient."""
        y = x.detach().clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, op=dist.ReduceOp.MAX, group=self.group)
        return y

    def gather_list(self, x) -> list:
        """Every rank's `x` in rank order, without a gradient."""
        x = x.detach().contiguous()
        parts = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(parts, x, group=self.group)
        return parts


# -- the one-process emulation: one thread a model rank ------------------------

class _JointCopy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, *xs):
        return xs

    @staticmethod
    def backward(ctx, *gs):
        s = _rank_sum(gs)
        return tuple(s.clone() for _ in gs)


class _JointReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, *xs):
        s = _rank_sum(xs)
        return tuple(s.clone() for _ in xs)

    @staticmethod
    def backward(ctx, *gs):
        return gs


class _JointGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, dim, *xs):
        ctx.dim, ctx.n = dim, xs[0].shape[dim]
        whole = torch.cat(xs, dim)
        return tuple(whole.clone() for _ in xs)

    @staticmethod
    def backward(ctx, *gs):
        return (None,) + tuple(g.narrow(ctx.dim, r * ctx.n, ctx.n)
                               for r, g in enumerate(gs))


class _JointWorld:
    """What the threads of `run_model_ranks` meet at: each collective
    waits for every rank's input, rank 0's thread combines them (an
    autograd node joining the ranks' graphs, or a plain rank-order
    reduction) and each rank takes its output."""

    def __init__(self, size: int):
        import threading
        self.size = size
        self.barrier = threading.Barrier(size)
        self.slots: list = [None] * size
        self.out = None

    def exchange(self, rank: int, value, combine):
        self.slots[rank] = value
        self.barrier.wait()
        if rank == 0:
            self.out = combine(list(self.slots))
        self.barrier.wait()
        out = self.out
        self.barrier.wait()
        return out


_BUMP_LEAF = torch.zeros((), requires_grad=True)


def _bump_sequence(x) -> None:
    """Takes one autograd sequence number on this thread, as the node a
    real rank's region makes here would (a node exists only where grad
    mode is on and `x` needs a gradient): the backward runs ready nodes in
    the order of their sequence numbers, so every emulated rank's nodes
    keep the order a real rank's have."""
    if torch.is_grad_enabled() and x.requires_grad:
        _BUMP_LEAF.mul(1)


class ThreadModelGroup:
    """One rank of a one-process emulation of the 'model' axis
    (`run_model_ranks`): the same region functions, each collective a
    meeting of the ranks' threads whose sums run in rank order. The ranks'
    graphs join at each region, in one node that rank 0's thread makes
    (the other threads take a sequence number in its place, so each rank's
    nodes keep a real rank's order), so one `torch.autograd.grad` over
    every rank's loss gives each rank's gradients; no collective runs in
    the backward, which may therefore run in any thread."""

    def __init__(self, world: _JointWorld, rank: int):
        self.world, self.rank, self.size = world, rank, world.size

    def _joint(self, cls, x, *lead):
        if self.rank:
            _bump_sequence(x)
        outs = self.world.exchange(self.rank, x,
                                   lambda xs: cls.apply(*lead, *xs))
        return outs[self.rank]

    def copy(self, x):
        return self._joint(_JointCopy, x)

    def reduce(self, x):
        return self._joint(_JointReduce, x)

    def allsum(self, x):
        return self.copy(self.reduce(x))

    def gather(self, x, dim: int):
        return self._joint(_JointGather, x, dim)

    def max(self, x):
        out = self.world.exchange(
            self.rank, x.detach(),
            lambda xs: torch.stack(xs).amax(0))
        return out.clone()

    def gather_list(self, x) -> list:
        return [p.clone() for p in self.world.exchange(
            self.rank, x.detach(), lambda xs: xs)]


def run_model_ranks(size: int, fn) -> list:
    """`fn(rank)` for each rank of a one-process emulation of a 'model'
    axis of `size` ranks, each in a thread of its own under
    `model_group_context` of its `ThreadModelGroup`; returns the results
    in rank order (raises the first rank's exception). Every rank must
    make the same collectives in the same order, as the ranks of a real
    group do."""
    import threading
    world = _JointWorld(size)
    results: list = [None] * size
    errors: list = [None] * size
    grad = torch.is_grad_enabled()

    def one(r):
        try:
            with torch.set_grad_enabled(grad), model_group_context(
                    ThreadModelGroup(world, r)):
                results[r] = fn(r)
        except BaseException as e:   # re-raised below, in the caller
            errors[r] = e
            world.barrier.abort()

    threads = [threading.Thread(target=one, args=(r,)) for r in range(size)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for e in errors:
        if e is not None and not isinstance(
                e, threading.BrokenBarrierError):
            raise e
    for e in errors:
        if e is not None:
            raise e
    return results


# -- a leaf's block along 'model' and the TP dims of a placement ------------------

def tp_mesh_dims(dims: tuple, names: tuple, dp: tuple = ()) -> tuple:
    """The mesh dims of a leaf's placement (`dims`: per mesh dim the
    tensor dim it shards or None) that may keep the leaf a block in the TP
    forward: 'model', when it is not a data-parallel dim (`dp`) and shards
    its tensor dim alone (the wide-FSDP profile shards the FSDP dim over
    data and model together: that is a parameter block, gathered)."""
    return tuple(i for i, d in enumerate(dims)
                 if names[i] == "model" and d is not None and i not in dp
                 and dims.count(d) == 1)


# the dims of a leaf (unstacked) that the TP forward computes on a block
# of: heads, kv heads, ff, vocab, ssm heads and the MoE's experts or ff
TP_DIMS: list[tuple[str, tuple[int, ...]]] = [
    (r"moe.*w_(gate|in)$", (0, 2)),                # [E, D, F]: E or F
    (r"moe.*w_out$", (0, 1)),                      # [E, F, D]
    (r"mamba.*w_(z|x|dt)$", (1,)),
    (r"mamba.*conv_x_w$", (1,)),
    (r"mamba.*(conv_x_b|A_log|dt_bias|norm_w)$", (0,)),
    (r"mamba.*\bD$", (0,)),
    (r"mamba.*w_out$", (0,)),
    (r"rwkv.*w_[rkvg]$", (1,)),
    (r"rwkv.*(w_o|bonus_u|cm_wv)$", (0,)),
    (r"rwkv.*(decay_w2|cm_wk|cm_wr)$", (1,)),
    (r"embed$", (0,)),
    (r"lm_head$", (1,)),
    (r"\bw[qkv]$", (1,)),
    (r"\b(wo|b[qkv])$", (0,)),
    (r"w_(gate|in)$", (1,)),
    (r"(w_out|b_in)$", (0,)),
]
_MOE_LAYOUTS = ({"w_gate": 0, "w_in": 0, "w_out": 0},     # experts (moe_ep)
                {"w_gate": 2, "w_in": 2, "w_out": 1})     # the experts' ff


def _tp_dim_ok(path: str, dim: int, stacked: bool) -> bool:
    d = dim - 1 if stacked else dim
    for pat, ok in TP_DIMS:
        if re.search(pat, path):
            return d in ok
    return False


def tp_plan(dims_tree, names: tuple, dp: tuple = (),
            stacked_prefixes: tuple[str, ...] = ("blocks", "enc_blocks",
                                                 "dec_blocks")):
    """Per leaf of a parameter tree (`dims_tree`: each leaf's per-mesh-dim
    sharded tensor dims), the mesh dims along which the TP forward keeps
    it a block: `tp_mesh_dims`, where the dim is one the layer splits
    (`TP_DIMS`). A MoE layer keeps its three weights blocks only when they
    split the same thing (its experts under `moe_ep`, or their ff); under
    the default rules the dense `w_gate`/`w_out` patterns match the MoE's
    leaves first (in the reference's table too), placing their d_model or
    experts over 'model', and the layer then takes them whole."""
    plan = {}

    def one(path_tuple, dims):
        path = ".".join(str(k) for k in path_tuple)
        stacked = any(seg in stacked_prefixes for seg in path_tuple)
        plan[path_tuple] = tuple(
            i for i in tp_mesh_dims(dims, names, dp)
            if _tp_dim_ok(path, dims[i], stacked))
        return plan[path_tuple]

    out = _map_with_path(one, dims_tree)
    for path_tuple in list(plan):
        if path_tuple[-1] != "w_gate" or "moe" not in path_tuple:
            continue
        parent = path_tuple[:-1]
        trio = {k: plan.get(parent + (k,), ()) for k in ("w_gate", "w_in",
                                                          "w_out")}
        got = {}
        for k, keep in trio.items():
            dims = _get_path(dims_tree, parent + (k,))
            got[k] = dims[keep[0]] - (1 if any(
                seg in stacked_prefixes for seg in parent) else 0) \
                if keep else None
        if got not in _MOE_LAYOUTS:
            node = _get_path(out, parent)
            for k in trio:
                node[k] = ()
    return out


def _get_path(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def gather_dims(x, mesh, dims: tuple, along: tuple):
    """`x` (this rank's block under `dims`) gathered whole along the mesh
    dims `along`, innermost first, with one `all_gather` each."""
    for i in reversed(range(len(dims))):
        if i not in along or dims[i] is None:
            continue
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(mesh.size(i))]
        dist.all_gather(parts, x, group=mesh.get_group(i))
        x = torch.cat(parts, dims[i])
    return x


def tp_blocks(params, dp: tuple = ()):
    """A placed parameter tree as the TP forward takes it: each leaf's
    block along the mesh dims `tp_plan` keeps, gathered whole along every
    other mesh dim that shards it (explicit `all_gather`s)."""
    mesh = mesh_of(params)
    dims = _tree_map(lambda a: sharding_of(a)[1], params)
    plan = tp_plan(dims, tuple(mesh.mesh_dim_names), dp)
    return _tree_map(lambda a, d, keep: gather_dims(
        a.to_local(), mesh, d,
        tuple(i for i in range(len(d)) if i not in keep)), params, dims,
        plan)


def vocab_argmax(logits, n_vocab: int):
    """Greedy tokens from logits whose last dim holds `n_vocab` entries or
    this rank's block of them: each rank's max and its global index, one
    gather of both over the model group, the first rank holding the
    largest value (torch.argmax's first index on a tie). int64."""
    tp = tp_local(logits.shape[-1], n_vocab)
    if tp is None:
        return logits.argmax(-1)
    vals, idx = logits.float().max(-1)
    idx = idx + tp.rank * logits.shape[-1]
    both = tp.gather_list(torch.stack([vals, idx.to(torch.float64)
                                       .to(vals.dtype)]))
    # indices travel as exact integers in the float dtype (< 2**24)
    vals_all = torch.stack([b[0] for b in both])
    idx_all = torch.stack([b[1] for b in both])
    pick = vals_all.argmax(0, keepdim=True)
    return idx_all.gather(0, pick)[0].to(torch.int64)


def serve_cache_pspecs(abstract_cache, mesh, *, batch_axes):
    """The placed serve paths' cache specs: `cache_pspecs`, but for the
    RWKV6 state `wkv` [L, B, H, Dk, Dv], which the reference's k/v pattern
    places by its key dim (dim 3) over 'model': it is placed by its heads
    (dim 2), the block the TP forward's scan holds."""
    specs = cache_pspecs(abstract_cache, mesh, batch_axes=batch_axes)
    if isinstance(specs, dict) and "wkv" in specs:
        wkv = abstract_cache["wkv"]
        specs["wkv"] = _validate_divisible(
            P(None, batch_axes, "model", None, None), tuple(wkv.shape), mesh,
            "wkv")
    return specs


_SHAPES_ONLY: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_shapes_only", default=False)


@contextlib.contextmanager
def shapes_only():
    """Marks the meta tensors made inside as shape records the program
    never allocates (a whole cache whose blocks a rank holds): the dry
    run's counters (`launch/dryrun.py` `LiveBytes`, `roofline/op_costs.py`)
    skip the ops that run under it."""
    token = _SHAPES_ONLY.set(True)
    try:
        yield
    finally:
        _SHAPES_ONLY.reset(token)


def is_shapes_only() -> bool:
    return _SHAPES_ONLY.get()


def local_zeros(abstract_cache, model_ranks: int, device):
    """Zeros of this rank's blocks of a decode cache (`abstract_cache`, the
    whole cache as meta tensors) along a 'model' axis of `model_ranks`:
    each dim `cache_pspecs` places on 'model' cut into that many blocks."""
    specs = serve_cache_pspecs(abstract_cache, SpecMesh(("model",),
                                                        (model_ranks,)),
                               batch_axes=None)

    def one(leaf, spec):
        shape = [n // model_ranks if a == "model" else n
                 for n, a in zip(leaf.shape, tuple(spec) + (None,) * 8)]
        return torch.zeros(shape, dtype=leaf.dtype, device=device)
    return _tree_map(one, abstract_cache, specs)


def to_local_tree(tree):
    """Each DTensor leaf of `tree` (a leaf or nested dicts) as its local
    block."""
    if isinstance(tree, dict):
        return {k: to_local_tree(v) for k, v in tree.items()}
    return tree.to_local()


# -- placed serving: the rank's blocks in, placed outputs back ----------------------

def is_placed(tree) -> bool:
    """Whether `tree`'s first leaf is a DTensor (a placed tree)."""
    from torch.distributed.tensor import DTensor
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return isinstance(tree, DTensor)


def mesh_of(tree):
    """The device mesh of a placed tree's first leaf."""
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree.device_mesh


def serve_batch_axes(mesh, batch: int):
    """The mesh axes a batch of `batch` rows splits over: those the active
    `mesh_context` resolves 'batch' to (else the mesh's 'pod' and 'data'),
    None where the rows do not divide over them (replicated), as
    `_validate_divisible` drops them."""
    if active_mesh() is not None:
        axes = _entry_axes(resolve("batch")[0])
    else:
        axes = tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))
    axes = tuple(a for a in axes if a in mesh.mesh_dim_names)
    if not axes or batch % _axis_size(mesh, axes):
        return None
    return axes


def batch_pspecs(batch_tree, batch_axes):
    """The batch's specs (`launch/dryrun.py` of the reference): rows over
    `batch_axes`; the encdec decode's stacked cross K/V [L, B, S, H, Dh]
    also its heads over 'model'; 0-d leaves replicated."""
    def one(path_tuple, leaf):
        if getattr(leaf, "dim", lambda: 0)() == 0:
            return P()
        if "cross_kv" in path_tuple:
            return P(None, batch_axes, None, "model", None)
        return P(*((batch_axes,) + (None,) * (leaf.dim() - 1)))
    return _map_with_path(one, batch_tree)


def local_inputs(tree, specs, mesh):
    """This rank's block of each leaf of a batch tree under `specs`
    (`batch_pspecs`, validated against each leaf's shape): a DTensor
    leaf's local block; a plain tensor leaf, the whole global value on
    every rank, cut to the block (contiguous: the kernels take it); other
    leaves (a host int) as they are."""
    from torch.distributed.tensor import DTensor

    def one(leaf, spec):
        if isinstance(leaf, DTensor):
            return leaf.to_local()
        if not isinstance(leaf, torch.Tensor):
            return leaf
        spec = _validate_divisible(spec, tuple(leaf.shape), mesh, "")
        return leaf[block_index(tuple(leaf.shape), NamedSharding(mesh, spec),
                                _coordinate(mesh))].contiguous()
    return _tree_map(one, tree, specs)


def place_blocks(blocks, specs, abstract, mesh):
    """DTensors on `mesh` from this rank's `blocks` of a tree whose whole
    leaves `abstract` (meta tensors) are placed by `specs`; each block's
    shape is checked against its placement."""
    def one(block, spec, whole):
        sh = NamedSharding(mesh, spec)
        idx = block_index(tuple(whole.shape), sh, _coordinate(mesh))
        want = tuple(s.stop - s.start for s in idx)
        if tuple(block.shape) != want:
            raise ValueError(f"a block of shape {tuple(block.shape)} is not "
                             f"the {want} block of {tuple(whole.shape)} "
                             f"under {spec}")
        return from_block(block, sh, tuple(whole.shape))
    return _tree_map(one, blocks, specs, abstract)


def _leaves_of(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves_of(tree[k])]
    return [tree]
