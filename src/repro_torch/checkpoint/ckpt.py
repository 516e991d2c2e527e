"""Step-atomic checkpoints with fleet provenance (port of
`repro/checkpoint/ckpt.py`), in the reference's on-disk layout, so that a
checkpoint written by either package restores in the other.

Layout: <dir>/step_<N:08d>/
    manifest.msgpack   — every leaf's shape and dtype by group, the step,
                         the write time, the SOR groups' rail layout and
                         (fleet runs) the FleetSpec provenance
    arrays.npz         — one entry per leaf, keyed `<group>::<path>`, the
                         path the `/`-joined keys of the leaf (dict keys,
                         the reference's pytree data fields of the state's
                         dataclasses); bf16 leaves as
                         their uint16 bits; fleet runs add a `fleet_spec::`
                         group with the per-chip nominals
    .complete          — commit marker written LAST (a partially written
                         checkpoint is never visible to restore)

What the port does differently, each for a reason:
- The manifest goes through the port's own MessagePack codec
  (`_msgpack`), byte-equal to `msgpack.packb` on it.
- The snapshot is taken in `save`, before it returns: every leaf's bytes
  are on the host then, because the next train step updates the
  parameters, the moments and the error-feedback residuals in place. An
  async save's writer thread touches only numpy arrays. An exception in the
  writer is raised again by `wait` (and by the next `save`).
- A broadcast-view leaf (`ecollectives.zeros_like_residuals`: one zero
  viewed at a parameter's shape) is written from a numpy broadcast view,
  which `np.savez` streams in chunks; the file holds the full zeros, as the
  reference's does.
- `restore` writes into `state_like`'s tensors, leaf by leaf, from host
  arrays (`copy_`), and returns them: no second copy of the state is ever
  on the device. It reads `arrays.npz` through memory maps of its stored
  members (`_NpzMembers`), not by copying each member out of the zip. A broadcast-view leaf whose saved bytes are all zero stays
  the view; one that is not gets memory of its own first. Where a leaf's
  saved shape or dtype differs from the live tensor's (a checkpoint of
  another fleet size, before `remap_plane`), it comes back as a new tensor
  on the live tensor's device. The host integers of the SOR state
  (`FrameHistory.cursor`, `.count`, `SorState.tick`) are written as int32
  0-d leaves, as the reference's arrays are, and read back as ints.
- In a `torch.distributed` world larger than one, rank 0 writes and the
  other ranks wait at a barrier until the checkpoint is complete (after the
  write of a synchronous save, at the next `wait` of an asynchronous one),
  so every rank sees it. With `save(mesh=)` the per-chip groups (`plane`,
  `sor`) are each rank's block of chips (`train.step.shard_fleet_state`)
  and are gathered over the mesh's chips axis first, so the files hold the
  whole fleet in the reference's layout and restore bit for bit in a
  world of one and in the reference. `restore` reads the whole state; the
  caller takes its block again (`Trainer` does).
- Placed groups (DTensor leaves, `parallel.sharding.place`) are written
  whole: `save` gathers each such leaf on every rank
  (`sharding.full_tensor`, a collective every rank of its mesh calls, leaf
  by leaf so one whole leaf is on the device at a time) and rank 0 writes
  it in the reference's layout, so a placed run's checkpoint restores in
  the reference and in a world of any size.
- `restore(shardings=)`: each leaf of a group named in `shardings` (a tree
  of `sharding.NamedSharding`s like the group's) comes back as a DTensor on
  that sharding's mesh, made from this rank's block of the host array
  (`sharding.local_block` of the member's memory map: a rank reads and
  copies to the device only its block); `state_like`'s leaves there give
  only the tree (meta tensors do). A group not named there restores as above,
  in place. This is how a run resumes on another number of ranks
  (`examples/elastic_restart.py`).
"""

from __future__ import annotations

import dataclasses
import os
import struct
import threading
import time
import zipfile
from typing import Any

import numpy as np
import torch

from repro_torch.checkpoint import _msgpack
from repro_torch.core.hwspec import V5E, ChipSpec, FleetSpec
from repro_torch.core.power_plane import PowerPlaneState
from repro_torch.core.sor import _FIELDS as _ESTIMATE_FIELDS
from repro_torch.core.sor import SorEstimate, SorState
from repro_torch.core.telemetry import FrameHistory

# FleetSpec per-chip arrays persisted under the `fleet_spec::` npz group
_FLEET_FIELDS = ("v_core_nominal", "v_hbm_nominal", "v_io_nominal",
                 "leakage_scale", "error_sensitivity")

# the fields each state dataclass registers as pytree data in the
# reference, in its order (the rest, such as the ring's capacity and rails,
# are static metadata and come from the restore's template)
_DATA_FIELDS = {
    PowerPlaneState: ("v_core", "v_hbm", "v_io", "comp_level", "energy_j",
                      "step"),
    FrameHistory: ("v", "obs", "age_s", "polled", "valid", "cursor",
                   "count"),
    SorEstimate: _ESTIMATE_FIELDS,
    SorState: ("history", "estimate", "tick"),
}

_TORCH_DTYPES = {"float32": torch.float32, "float64": torch.float64,
                 "float16": torch.float16, "bfloat16": torch.bfloat16,
                 "int8": torch.int8, "uint8": torch.uint8,
                 "int16": torch.int16, "int32": torch.int32,
                 "int64": torch.int64, "bool": torch.bool}


def remap_plane(plane: PowerPlaneState, target: FleetSpec) -> PowerPlaneState:
    """Explicitly remap a restored plane onto a `target` fleet of a possibly
    different size, on the plane's device: chips 0..min(n_old, n_new)-1
    keep their restored per-chip state (operating point, accumulated
    energy, step counter); chips beyond the restored fleet start at their
    own process-varied nominal point with zero energy. Joiners adopt the
    fleet's step counter (its max). A scalar plane is treated as a 1-chip
    fleet. Returns the plane itself when the sizes already match."""
    n_old, n_new = plane.n_chips, target.n_chips
    if plane.is_fleet and n_old == n_new:
        return plane
    fresh = PowerPlaneState.from_fleet(target, plane.device)
    k = min(n_old, n_new)

    def take(old, new):
        new[:k] = torch.atleast_1d(old)[:k].to(new.dtype)
        return new

    step = torch.atleast_1d(plane.step).max().to(torch.int32).repeat(n_new)
    return dataclasses.replace(
        fresh,
        v_core=take(plane.v_core, fresh.v_core),
        v_hbm=take(plane.v_hbm, fresh.v_hbm),
        v_io=take(plane.v_io, fresh.v_io),
        comp_level=take(plane.comp_level, fresh.comp_level),
        energy_j=take(plane.energy_j, fresh.energy_j),
        step=take(plane.step, step))


def remap_sor(sor_state: SorState, target) -> SorState:
    """Explicitly remap a restored `sor.SorState` onto a `target` fleet (a
    FleetSpec or an int chip count) of a possibly different size: chips
    0..min(n_old, n_new)-1 keep their telemetry window and fitted frontier;
    joiners start with an empty window and zero confidence (the cold-start
    pin). Returns the state itself when the sizes already match."""
    n_new = target.n_chips if hasattr(target, "n_chips") else int(target)
    hist = sor_state.history
    chip = hist.chip_shape
    if not chip:
        raise ValueError("remap_sor needs a fleet-shaped ([n_chips]) "
                         "SorState; a scalar learner has nothing to remap")
    n_old = chip[0]
    if n_old == n_new:
        return sor_state
    k = min(n_old, n_new)

    def take(a):
        z = a.new_zeros(tuple(a.shape[:-1]) + (n_new,))
        z[..., :k] = a[..., :k]
        return z

    est = sor_state.estimate
    return dataclasses.replace(
        sor_state,
        history=dataclasses.replace(
            hist, v=take(hist.v), obs=take(hist.obs),
            age_s=take(hist.age_s), polled=take(hist.polled),
            valid=take(hist.valid)),
        estimate=SorEstimate(*(take(getattr(est, f))
                               for f in _ESTIMATE_FIELDS)))


# -- reading arrays.npz ------------------------------------------------------------

_MAP_BYTES = 1 << 20        # members from this size up are memory-mapped


class _NpzMembers:
    """The members of an `arrays.npz` as numpy arrays, read without
    copying the file: `np.savez` stores each `<key>.npy` uncompressed, so
    a member from _MAP_BYTES up is a copy-on-write memory map of its bytes
    in the file (a restore reads from the page cache only what it copies
    on, a placed one its block), a smaller one is read whole. A member
    stored compressed is read through `np.load`."""

    def __init__(self, path: str):
        self.path = path
        self._zip = zipfile.ZipFile(path)
        self._file = open(path, "rb")
        self._infos = {i.filename[:-4] if i.filename.endswith(".npy")
                       else i.filename: i for i in self._zip.infolist()}

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self._file.close()
        self._zip.close()

    def __getitem__(self, key: str) -> np.ndarray:
        info = self._infos[key]
        if info.compress_type != zipfile.ZIP_STORED:
            with self._zip.open(info) as f:
                return np.lib.format.read_array(f)
        f = self._file
        f.seek(info.header_offset)
        head = f.read(30)
        name_len, extra_len = struct.unpack("<HH", head[26:30])
        f.seek(info.header_offset + 30 + name_len + extra_len)
        version = np.lib.format.read_magic(f)
        read_header = {(1, 0): np.lib.format.read_array_header_1_0,
                       (2, 0): np.lib.format.read_array_header_2_0}.get(
                           version)
        if read_header is None:
            with self._zip.open(info) as g:
                return np.lib.format.read_array(g)
        shape, fortran, dtype = read_header(f)
        n_bytes = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
        if n_bytes < _MAP_BYTES:
            a = np.frombuffer(f.read(n_bytes), dtype=dtype).copy()
            return a.reshape(shape, order="F" if fortran else "C")
        return np.memmap(self.path, dtype=dtype, mode="c", offset=f.tell(),
                         shape=shape, order="F" if fortran else "C")


# -- state trees ------------------------------------------------------------------

def _world() -> int:
    import torch.distributed as dist
    return (dist.get_world_size()
            if dist.is_available() and dist.is_initialized() else 1)


def _rank() -> int:
    import torch.distributed as dist
    return (dist.get_rank()
            if dist.is_available() and dist.is_initialized() else 0)


def gather_fleet_state(state: dict, mesh, axis_name: str = "chips") -> dict:
    """The whole fleet's per-chip groups from every rank's block (the
    inverse of `train.step.shard_fleet_state`, a collective every rank of
    the axis calls): `plane` and `sor` gathered along their trailing chip
    axis in rank order; other groups pass through."""
    from repro_torch.kernels import ops
    out = dict(state)
    plane = state.get("plane")
    if plane is not None and plane.v_core.dim() == 1:
        out["plane"] = ops.gather_chip_tree(plane, mesh,
                                            plane.v_core.shape[0], axis_name)
    ss = state.get("sor")
    if ss is not None and ss.history.chip_shape:
        out["sor"] = ops.gather_chip_tree(ss, mesh, ss.history.chip_shape[0],
                                          axis_name)
    return out


def _map_with_path(fn, tree, path: tuple = ()):
    """Rebuild `tree` with fn(path, leaf) at each leaf, visiting leaves in
    the reference's flatten order: dict keys sorted, the registered data
    fields of a state dataclass in their order."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, tree[k], path + (k,))
                for k in sorted(tree)}
    if dataclasses.is_dataclass(tree):
        fields = _DATA_FIELDS.get(type(tree))
        if fields is None:
            raise TypeError(f"no checkpoint layout for "
                            f"{type(tree).__name__}")
        return dataclasses.replace(tree, **{
            f: _map_with_path(fn, getattr(tree, f), path + (f,))
            for f in fields})
    return fn(path, tree)


def _path_key(path: tuple) -> str:
    return "/".join(str(k) for k in path)


def _is_broadcast(t: torch.Tensor) -> bool:
    """One element viewed at a larger shape (every dim of size > 1 has
    stride 0)."""
    return t.numel() > 1 and all(st == 0 for st, n in
                                 zip(t.stride(), t.shape) if n > 1)


def _is_placed(leaf) -> bool:
    if not isinstance(leaf, torch.Tensor):
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(leaf, DTensor)


def _to_host(leaf, keep: bool = True):
    """A leaf as (a numpy array that owns its bytes, its manifest dtype):
    bf16 as its uint16 bits, a broadcast view as a numpy broadcast view of
    its one element, a host int as an int32 0-d array; a placed leaf
    gathered whole first (every rank calls this for it). None where `keep`
    is false (a rank that does not write)."""
    if isinstance(leaf, int) and not isinstance(leaf, bool):
        return np.asarray(leaf, np.int32), "int32"
    if not isinstance(leaf, torch.Tensor):
        raise TypeError(f"cannot checkpoint a leaf of type "
                        f"{type(leaf).__name__}")
    if _is_placed(leaf):
        from repro_torch.parallel import sharding
        leaf = sharding.full_tensor(leaf)
    if not keep:
        return None
    t = leaf.detach()
    bf16 = t.dtype == torch.bfloat16
    if bf16:
        t = t.view(torch.int16)
    if _is_broadcast(t):
        one = t[(0,) * t.dim()].to("cpu", copy=True).numpy()
        a = np.broadcast_to(one, tuple(t.shape))
    else:
        a = t.to("cpu", copy=True).numpy()
    if bf16:
        return a.view(np.uint16), "bfloat16"
    return a, str(a.dtype)


def _flatten(tree, keep: bool = True) -> dict[str, tuple[np.ndarray, str]]:
    flat = {}

    def go(path, leaf):
        flat[_path_key(path)] = _to_host(leaf, keep)

    _map_with_path(go, tree)
    return flat


def _has_placed(state: dict) -> bool:
    found = []
    for tree in state.values():
        _map_with_path(lambda path, leaf: found.append(_is_placed(leaf)),
                       tree)
    return any(found)


def _contiguous(a: np.ndarray) -> np.ndarray:
    """`a` in C order (0-d stays 0-d, which `np.ascontiguousarray` would
    make 1-d)."""
    return a if a.flags.c_contiguous else a.copy(order="C")


def _all_zero_bits(a: np.ndarray) -> bool:
    return not _contiguous(a).view(np.uint8).any()


def _host_tensor(a: np.ndarray, dtype: str) -> torch.Tensor:
    """A host array from the npz as a CPU tensor of the manifest's dtype
    (sharing its memory)."""
    a = _contiguous(a)
    if dtype == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


@torch.no_grad()
def _restore_leaf(live, a: np.ndarray, dtype: str):
    """The saved array `a` put back in the place of `live` (see the module
    docstring)."""
    if isinstance(live, int) and not isinstance(live, bool):
        if a.shape != ():
            raise ValueError(f"a host integer leaf restores from a 0-d "
                             f"array, got shape {a.shape}")
        return int(a)
    if not isinstance(live, torch.Tensor):
        raise TypeError(f"cannot restore into a leaf of type "
                        f"{type(live).__name__}")
    shape, want = tuple(a.shape), _TORCH_DTYPES[dtype]
    if tuple(live.shape) != shape or live.dtype != want:
        return _host_tensor(a, dtype).to(live.device, copy=True)
    if _is_broadcast(live):
        one = live[(0,) * live.dim()].reshape(1).view(torch.uint8)
        if _all_zero_bits(a) and not bool(one.any()):
            return live
        live = torch.empty(shape, dtype=want, device=live.device)
    live.copy_(_host_tensor(a, dtype))
    return live


def _sharding_at(tree, path: tuple):
    for k in path:
        if not isinstance(tree, dict) or k not in tree:
            raise KeyError(f"shardings has no leaf at {_path_key(path)}")
        tree = tree[k]
    return tree


@torch.no_grad()
def _placed_leaf(a: np.ndarray, dtype: str, sh):
    """The saved array `a` as a DTensor under the NamedSharding `sh`, from
    this rank's block of it."""
    from repro_torch.parallel import sharding
    block = sharding.local_block(_contiguous(a), sh)
    dev = torch.device(sh.mesh.device_type)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    return sharding.from_block(_host_tensor(block, dtype).to(dev, copy=True),
                               sh, a.shape)


@dataclasses.dataclass
class CheckpointManager:
    directory: str
    keep: int = 3
    async_save: bool = False
    _thread: threading.Thread | None = None
    # seconds and bytes of the last save and restore: `snapshot_s` (the
    # host copy, inside `save`), `write_s` and `bytes` (the writer),
    # `restore_s` and `restore_bytes`
    timings: dict = dataclasses.field(default_factory=dict)
    _error: Exception | None = None
    _barrier: bool = False      # a save every rank still has to wait for

    def __post_init__(self):
        os.makedirs(self.directory, exist_ok=True)

    # -- save ---------------------------------------------------------------
    def save(self, step: int, state: dict[str, Any],
             fleet: FleetSpec | None = None, mesh: Any = None,
             axis_name: str = "chips") -> str:
        """state: dict of state trees, e.g. {'params': ..., 'opt': ...,
        'plane': ...}. Every leaf is copied to the host before this
        returns. `fleet` additionally records the FleetSpec (seed and the
        per-chip nominal arrays) the plane was seeded from, so an elastic
        restart onto a different fleet size can remap per-chip state
        explicitly. With `mesh` (a collective every rank calls) the
        per-chip groups are this rank's block and are gathered first; in a
        world larger than one only rank 0 writes (module docstring)."""
        self.wait()
        path = os.path.join(self.directory, f"step_{step:08d}")
        if mesh is not None:
            state = gather_fleet_state(state, mesh, axis_name)
        writer = _rank() == 0
        self._barrier = _world() > 1
        t0 = time.perf_counter()
        if not writer:
            if _has_placed(state):      # the gathers every rank joins
                for tree in state.values():
                    _flatten(tree, keep=False)
            if not self.async_save:
                self.wait()
            return path
        host = {name: _flatten(tree) for name, tree in state.items()}
        self.timings["snapshot_s"] = time.perf_counter() - t0
        # learned-region groups (sor.SorState) record their rail layout and
        # window depth, so a restore under other rails refuses
        sor_rails = {name: {"rails": [dataclasses.asdict(s)
                                      for s in tree.history.rails],
                            "capacity": int(tree.history.capacity)}
                     for name, tree in state.items()
                     if hasattr(getattr(tree, "history", None), "rails")}
        fleet_arrays = ({f: np.asarray(getattr(fleet, f))
                         for f in _FLEET_FIELDS} if fleet is not None else None)
        fleet_meta = ({"n_chips": fleet.n_chips, "seed": fleet.seed,
                       "base": dataclasses.asdict(fleet.base)}
                      if fleet is not None else None)

        def write():
            t1 = time.perf_counter()
            os.makedirs(path, exist_ok=True)
            arrays = {}
            manifest = {"step": step, "groups": {}, "time": time.time()}
            if sor_rails:
                manifest["sor_rails"] = sor_rails
            if fleet_meta is not None:
                manifest["fleet"] = fleet_meta
                for f, v in fleet_arrays.items():
                    arrays[f"fleet_spec::{f}"] = v
            for name, flat in host.items():
                manifest["groups"][name] = {
                    k: {"shape": list(v.shape), "dtype": dtype}
                    for k, (v, dtype) in flat.items()}
                for k, (v, _) in flat.items():
                    arrays[f"{name}::{k}"] = v
            np.savez(os.path.join(path, "arrays.npz"), **arrays)
            with open(os.path.join(path, "manifest.msgpack"), "wb") as f:
                f.write(_msgpack.packb(manifest))
            with open(os.path.join(path, ".complete"), "w") as f:
                f.write("ok")
            self.timings["write_s"] = time.perf_counter() - t1
            self.timings["bytes"] = sum(
                os.path.getsize(os.path.join(path, fn))
                for fn in os.listdir(path))
            self._gc()

        if self.async_save:
            def guarded():
                try:
                    write()
                except Exception as e:   # handed to wait(), re-raised
                    self._error = e
            self._thread = threading.Thread(target=guarded, daemon=True)
            self._thread.start()
        else:
            write()
            self.wait()
        return path

    def wait(self):
        """Join the writer of an async save; in a world larger than one,
        then wait for every rank at a barrier; re-raise the writer's
        exception."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._barrier:
            import torch.distributed as dist
            self._barrier = False
            dist.barrier()
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self):
        steps = self.list_steps()
        for s in steps[:-self.keep]:
            p = os.path.join(self.directory, f"step_{s:08d}")
            for fn in os.listdir(p):
                os.unlink(os.path.join(p, fn))
            os.rmdir(p)

    # -- restore --------------------------------------------------------------
    def list_steps(self) -> list[int]:
        out = []
        for d in os.listdir(self.directory):
            if d.startswith("step_") and os.path.exists(
                    os.path.join(self.directory, d, ".complete")):
                out.append(int(d.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.list_steps()
        return steps[-1] if steps else None

    def _manifest(self, path: str) -> dict:
        with open(os.path.join(path, "manifest.msgpack"), "rb") as f:
            return _msgpack.unpackb(f.read())

    def restore_fleet(self, step: int | None = None) -> FleetSpec | None:
        """The FleetSpec a checkpoint was written under (None for scalar /
        pre-fleet checkpoints): seed and the exact per-chip nominal arrays,
        so a restart can compare it to its own fleet and `remap_plane`
        explicitly when the sizes differ."""
        if step is None:
            step = self.latest_step()
        if step is None:
            return None
        path = os.path.join(self.directory, f"step_{step:08d}")
        meta = self._manifest(path).get("fleet")
        if meta is None:
            return None
        base = ChipSpec(**meta["base"]) if meta.get("base") else V5E
        with np.load(os.path.join(path, "arrays.npz")) as z:
            arrs = {f: z[f"fleet_spec::{f}"] for f in _FLEET_FIELDS}
        return FleetSpec(base=base, seed=int(meta["seed"]), **arrs)

    def restore(self, state_like: dict[str, Any], step: int | None = None,
                shardings: dict[str, Any] | None = None,
                optional: tuple = ()) -> tuple[int, dict]:
        """Restore into the structure of `state_like`, writing into its
        tensors (see the module docstring) and returning them; a group named
        in `shardings` comes back placed as its tree of NamedShardings
        says (module docstring), every rank reading its own block. A group
        the
        checkpoint never recorded raises KeyError, unless named in
        `optional`, in which case it is skipped (absent from the returned
        dict): that is how a SOR-enabled trainer restores a pre-SOR
        checkpoint and keeps its in-memory cold start, without a missing
        required group silently restarting from fresh state."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        t0 = time.perf_counter()
        path = os.path.join(self.directory, f"step_{step:08d}")
        manifest = self._manifest(path)
        n_bytes = 0
        with _NpzMembers(os.path.join(path, "arrays.npz")) as z:
            out = {}
            for name, tree in state_like.items():
                if name not in manifest["groups"]:
                    if name in optional:
                        continue
                    raise KeyError(
                        f"checkpoint step_{step:08d} has no state group "
                        f"{name!r} (has {sorted(manifest['groups'])}); "
                        f"pass optional=({name!r},) if the caller can "
                        f"genuinely proceed without it")
                saved = manifest.get("sor_rails", {}).get(name)
                if saved is not None:
                    hist = getattr(tree, "history", None)
                    want = {"rails": [dataclasses.asdict(s) for s in
                                      getattr(hist, "rails", ())],
                            "capacity": int(getattr(hist, "capacity", 0))}
                    if saved != want:
                        raise ValueError(
                            f"checkpoint group {name!r} was learned under "
                            f"rails/capacity {saved} but this run's "
                            f"SorConfig declares {want}; restore with the "
                            f"config the state was learned under (or drop "
                            f"the group)")
                metas = manifest["groups"][name]
                placed = (shardings or {}).get(name)

                def put(path, leaf, name=name, metas=metas, placed=placed):
                    nonlocal n_bytes
                    key = _path_key(path)
                    a = z[f"{name}::{key}"]
                    n_bytes += a.nbytes
                    if placed is not None:
                        return _placed_leaf(a, metas[key]["dtype"],
                                            _sharding_at(placed, path))
                    return _restore_leaf(leaf, a, metas[key]["dtype"])

                out[name] = _map_with_path(put, tree)
        self.timings["restore_s"] = time.perf_counter() - t0
        self.timings["restore_bytes"] = n_bytes
        return manifest["step"], out
