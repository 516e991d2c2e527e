"""Device meshes over a `torch.distributed` world (port of
`repro/launch/mesh.py`).

A mesh is a `torch.distributed.device_mesh.DeviceMesh` whose axes carry
the reference's names: `("chips",)` for the fleet's chip axis,
`("data",)`, `("data", "model")` and `("pod", "data", "model")`. Where the
reference reads `mesh.devices.size` the port reads `mesh.size()`; an
axis's process group is `mesh.get_group(name)`.

The caller starts the process group, and its backend is the caller's
choice: NCCL where each rank has a card of its own, gloo where ranks share
one card or run on the CPU (gloo stages CUDA tensors through the host).
Nothing here picks or changes a backend. `device_type` says where the
state the mesh places lives ("cuda" unless the caller asks for "cpu"); a
gloo world sharing one card takes "cuda" too.

Functions, not module-level constants, so importing never touches the
process group.
"""

from __future__ import annotations

import math

import torch


def _world_size() -> int:
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "a device mesh needs a started process group: call "
            "torch.distributed.init_process_group(backend, init_method=..., "
            "rank=..., world_size=...) first (gloo on the CPU or for ranks "
            "sharing one card, nccl for a card a rank)")
    return dist.get_world_size()


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...],
              device_type: str = "cuda"):
    """A mesh of `shape` over ranks 0 .. prod(shape) - 1 of the world, its
    axes named `axes` (the counterpart of `jax.make_mesh`)."""
    from torch.distributed.device_mesh import DeviceMesh
    if len(shape) != len(axes):
        raise ValueError(f"shape {shape} and axes {axes} differ in length")
    n = math.prod(shape)
    world = _world_size()
    if world < n:
        raise RuntimeError(
            f"mesh {shape} needs {n} ranks, found a world of {world}")
    ranks = torch.arange(n, dtype=torch.int64).reshape(shape)
    return DeviceMesh(device_type, ranks, mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """Single pod = 16 x 16 (256 ranks) over ('data', 'model'); multi-pod
    adds a leading 'pod' axis: (2, 16, 16) = 512 ranks. Raises when the
    world is smaller, as the reference does when it has too few devices."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = math.prod(shape)
    world = _world_size()
    if world < n:
        raise RuntimeError(
            f"mesh {shape} needs {n} devices, found {world} — start a "
            f"world of {n} ranks")
    return make_mesh(shape, axes, device_type)


def make_debug_mesh(data: int = 2, model: int = 2, pod: int = 0,
                    device_type: str = "cuda"):
    """Small mesh for tests: (data, model), or (pod, data, model) with
    `pod`, over the world's first ranks."""
    if pod:
        return make_mesh((pod, data, model), ("pod", "data", "model"),
                         device_type)
    return make_mesh((data, model), ("data", "model"), device_type)


def make_chips_mesh(n_ranks: int | None = None, device_type: str = "cuda"):
    """The 1-D `("chips",)` mesh the sharded control plane runs on: the
    fleet's chip axis over `n_ranks` ranks (the whole world by default)."""
    n = _world_size() if n_ranks is None else n_ranks
    return make_mesh((n,), ("chips",), device_type)


def dp_axes(mesh) -> tuple[str, ...]:
    return tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))
