"""Cost walk over the aten ops one run dispatches: the counterpart of the
reference's `roofline/hlo_costs.py`, which parses post-optimization HLO
text.

The reference needs a walker because XLA's `cost_analysis()` counts a
`while` body once (a `lax.scan` over layers or microbatches is one body),
so it multiplies each computation by its loops' trip counts. The port has
no HLO and no compiled loops: its layers and microbatches are Python loops
that dispatch every op of every iteration, so one run's ops are already
the whole count and nothing here needs trip counts (`Costs.n_whiles` stays
0 and `max_mult` 1).

`analyze_ops(fn, *args)` runs `fn` under a `TorchDispatchMode` (and
`torch.utils.flop_counter.FlopCounterMode`) and returns the reference's
`Costs` fields:
- `flops`: the matmuls' and convolutions' FLOPs (`FlopCounterMode`'s
  formulas: 2 m n k a product) plus the hand-written kernels' own counts
  on meta tensors (`kernels.ops.kernel_costs`), elementwise FLOPs ignored
  as in the reference;
- `hbm_bytes`: the reference's producer/consumer-boundary model, every
  dispatched op a boundary (eager PyTorch fuses nothing): each op's tensor
  operands and outputs, views and allocations skipped, plus the kernels'
  bytes; an upper bound on the device's traffic (the meta tensors made
  only for their shapes, `sharding.shapes_only`, count nowhere);
- `collective_bytes`: per kind under the reference's names, the wire bytes
  of each c10d collective with the reference's ring factors (P the group's
  size): all-gather out (P-1)/P (out the gathered buffer), all-reduce 2
  out (P-1)/P, reduce-scatter out (P-1) (out the shard), all-to-all out
  (P-1)/P; `op_counts` beside them.
"""

from __future__ import annotations

import dataclasses

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.parallel.sharding import is_shapes_only

# c10d op name -> the reference's collective kind
COLLECTIVE_KINDS = {
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "alltoall_base_": "all-to-all", "alltoall_": "all-to-all",
    "send": "collective-permute",
}
_ALLOC = ("empty", "empty_like", "empty_strided", "new_empty",
          "new_empty_strided", "detach", "lift_fresh")


def ring_factor(kind: str, p: int) -> float:
    return {"all-gather": (p - 1) / p,
            "all-reduce": 2 * (p - 1) / p,
            "reduce-scatter": float(p - 1),
            "all-to-all": (p - 1) / p,
            "collective-permute": 1.0}[kind]


@dataclasses.dataclass
class Costs:
    flops: float = 0.0
    hbm_bytes: float = 0.0
    collective_bytes: dict[str, float] = dataclasses.field(
        default_factory=dict)
    n_whiles: int = 0
    max_mult: float = 1.0
    op_counts: dict[str, int] = dataclasses.field(default_factory=dict)

    @property
    def collective_total(self) -> float:
        return sum(self.collective_bytes.values())


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)


def _nbytes(x) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(x))


def _group_size(args) -> int:
    """The size of the process group a c10d op's arguments carry (a
    TorchBind `ProcessGroup` among them)."""
    import torch.distributed as dist
    for a in args:
        if isinstance(a, torch.ScriptObject) and \
                a._type().qualified_name().endswith(".ProcessGroup"):
            return dist.ProcessGroup.unbox(a).size()
    raise ValueError("a c10d op without a process group")


class OpWalk(TorchDispatchMode):
    """Counts HBM bytes at op boundaries and collective wire bytes into
    `costs` (a `Costs`) as ops dispatch."""

    def __init__(self, costs: Costs):
        super().__init__()
        self.costs = costs

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if is_shapes_only():
            return out
        ns = func.namespace
        name = func.__name__.split(".")[0]
        if ns == "c10d":
            kind = COLLECTIVE_KINDS.get(name)
            if kind is not None:
                # the output: the in-place tensors (args[0]) of every form
                moved = _nbytes(args[0])
                c = self.costs
                c.collective_bytes[kind] = (
                    c.collective_bytes.get(kind, 0.0)
                    + moved * ring_factor(kind, _group_size(args)))
                c.op_counts[kind] = c.op_counts.get(kind, 0) + 1
            return out
        schema = func._schema
        if name in _ALLOC or any(r.alias_info is not None
                                 for r in schema.returns):
            return out
        self.costs.hbm_bytes += _nbytes(list(args)) + _nbytes(
            list((kwargs or {}).values())) + _nbytes(out)
        return out


def analyze_ops(fn, *args, **kwargs) -> Costs:
    """The costs of one call `fn(*args, **kwargs)` (module docstring)."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.kernels.ops import kernel_costs
    costs = Costs()
    with kernel_costs() as kernels, FlopCounterMode(display=False) as fc, \
            OpWalk(costs):
        fn(*args, **kwargs)
    costs.flops = float(fc.get_total_flops()) + sum(
        k["flops"] for k in kernels.values())
    costs.hbm_bytes += sum(k["bytes"] for k in kernels.values())
    return costs
