"""Feed-forward layers: SwiGLU (LLaMA family), GELU (Whisper) and the MoE
layer (top-k routing, capacity-based dispatch), ported from
`repro/models/mlp.py`.

The MoE's products run where the reference runs them, outside any kernel:
its einsums are `torch.bmm` over the experts here. The reference's
constraints on the dispatch buffer, the activation and the expert output
are `parallel.sharding.constrain` at the same places, on the port's
expert-major layout (`[E, B*cap, ...]`, the reference's `[B, E, cap, ...]`
with the expert axis first): the logical axes are given in that order.
Its expert parallelism is the `moe_ep` placement profile
(`parallel.sharding.PARAM_RULES_MOE_EP`); like the reference, the port has
no all-to-all dispatch.

Tensor parallelism: where a leaf holds this rank's block along 'model'
(`parallel.sharding.tp_local`), the dense MLPs are column-parallel in and
row-parallel out with one reduce over the model group; the MoE splits its
experts' ff (the default rules) or, under `moe_ep`, computes the rank's
experts only, and reduces the combined output. The router stays
replicated, on true f32."""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.models import common
from repro_torch.parallel.sharding import batch_mean, constrain, tp_local


# ---------------------------------------------------------------------------
# Dense MLPs
# ---------------------------------------------------------------------------

def init_swiglu(gen: torch.Generator, d_model: int, d_ff: int,
                dtype=torch.float32):
    return {
        "w_gate": common.dense_init(gen, (d_model, d_ff), d_model, dtype),
        "w_in": common.dense_init(gen, (d_model, d_ff), d_model, dtype),
        "w_out": common.dense_init(gen, (d_ff, d_model), d_ff, dtype),
    }


def _enter(w, dim: int, n_full, x):
    """(tp group or None, x as the rank-local products take it): x enters
    the model region where `w` holds a block of its dim `dim`."""
    tp = None if n_full is None else tp_local(w.shape[dim], n_full)
    return tp, (x if tp is None else tp.copy(x))


def swiglu(params, x, d_ff: int | None = None):
    """The SwiGLU; with `d_ff` and `w_gate` holding this rank's block of
    it, column-parallel in and row-parallel out, reduced."""
    tp, xt = _enter(params["w_gate"], 1, d_ff, x)
    g = xt @ params["w_gate"]
    h = xt @ params["w_in"]
    act = F.silu(g.float()).to(x.dtype) * h
    y = act @ params["w_out"]
    return y if tp is None else tp.reduce(y)


def init_gelu_mlp(gen: torch.Generator, d_model: int, d_ff: int,
                  dtype=torch.float32):
    dev = gen.device
    return {
        "w_in": common.dense_init(gen, (d_model, d_ff), d_model, dtype),
        "b_in": torch.zeros((d_ff,), dtype=dtype, device=dev),
        "w_out": common.dense_init(gen, (d_ff, d_model), d_ff, dtype),
        "b_out": torch.zeros((d_model,), dtype=dtype, device=dev),
    }


def gelu_mlp(params, x, d_ff: int | None = None):
    """`jax.nn.gelu` defaults to the tanh approximation, and so does this.
    Tensor-parallel as `swiglu` (`b_out` added after the reduce)."""
    tp, xt = _enter(params["w_in"], 1, d_ff, x)
    h = xt @ params["w_in"] + params["b_in"]
    h = F.gelu(h.float(), approximate="tanh").to(x.dtype)
    y = h @ params["w_out"]
    return (y if tp is None else tp.reduce(y)) + params["b_out"]


# ---------------------------------------------------------------------------
# Mixture of Experts
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MoESpec:
    d_model: int
    d_ff: int           # per-expert hidden size
    n_experts: int
    k: int              # experts per token
    capacity_factor: float = 2.0


# the leaves the reference keeps in f32 in any model dtype
F32_PARAMS = ("router",)


def param_shapes(spec: MoESpec) -> dict:
    E, D, Fd = spec.n_experts, spec.d_model, spec.d_ff
    return {"router": (D, E), "w_gate": (E, D, Fd), "w_in": (E, D, Fd),
            "w_out": (E, Fd, D)}


def init_moe(gen: torch.Generator, spec: MoESpec, dtype=torch.float32):
    E, D, Fd = spec.n_experts, spec.d_model, spec.d_ff
    return {
        "router": common.dense_init(gen, (D, E), D, torch.float32),
        "w_gate": common.dense_init(gen, (E, D, Fd), D, dtype),
        "w_in": common.dense_init(gen, (E, D, Fd), D, dtype),
        "w_out": common.dense_init(gen, (E, Fd, D), Fd, dtype),
    }


def moe_capacity(n_tokens: int, spec: MoESpec) -> int:
    cap = max(1, int(spec.capacity_factor * n_tokens * spec.k
                     / spec.n_experts))
    # round to 8, but never inflate tiny decode caps (T=1: the top-k
    # experts are distinct, so every rank is 0 and cap=1 suffices)
    return -(-cap // 8) * 8 if cap >= 8 else cap


def moe_route(params, x, spec: MoESpec):
    """The router: f32 logits and softmax over the experts, the top-k in
    descending order with renormalised gates, and the Switch load-balance
    loss `E * sum(mean(probs) * mean(onehot(top-1)))`. x [B,T,D] ->
    (gates [B,T,K] f32, idx [B,T,K] int64, aux [] f32)."""
    E = spec.n_experts
    probs = torch.softmax(x.float() @ params["router"], dim=-1)
    gate_vals, idx = torch.topk(probs, spec.k, dim=-1)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True)
    me = probs.mean(dim=(0, 1))
    # the top-1 shares of the whole batch where a placed step splits it
    # over ranks (no gradient flows through them, so each rank's
    # E * sum(me * ce) averages to the global batch's loss and gradient)
    ce = batch_mean(F.one_hot(idx[..., 0], E).float().mean(dim=(0, 1)))
    return gate_vals, idx, E * (me * ce).sum()


def moe_ranks(idx, n_experts: int, cap: int):
    """Each routed slot's rank within its expert, an exclusive count over
    the row's T*K slots in order, per batch row (never across rows), and
    whether it is kept (rank < cap). idx [B,T,K] -> (rank, keep) [B,T*K]."""
    B = idx.shape[0]
    onehot = F.one_hot(idx.reshape(B, -1), n_experts)          # [B,TK,E]
    rank = ((onehot.cumsum(1) - onehot) * onehot).sum(-1)
    return rank, rank < cap


def moe_apply(params, x, spec: MoESpec):
    """Capacity-based top-k MoE with per-batch-row routing. x [B,T,D] ->
    (y [B,T,D], {"moe_aux": aux}).

    Slots over an expert's capacity (`moe_capacity` of this call's T) are
    dropped: the residual path carries them. The kept slots, unique (expert,
    row, rank) triples, are written into an `[E, B*cap, D]` buffer (the
    reference's `[B, E, cap, D]` with the expert axis first, so each
    expert's rows are one operand of a batched product); the dropped ones go
    to one spare row past its end, which nothing reads, so every write that
    is read is the only write to its row and the buffer has the same bits
    every run. A SwiGLU over the experts, then each slot's row gathered back
    and weighted by its gate, summed over the K slots in the router's
    order. Nothing leaves the device: no shape depends on the routing."""
    B, T, D = x.shape
    E, K = spec.n_experts, spec.k
    cap = moe_capacity(T, spec)
    gate_vals, idx, aux = moe_route(params, x, spec)
    rank, keep = moe_ranks(idx, E, cap)
    # tensor parallelism: the rank's block of the experts (moe_ep) or of
    # their ff (the default rules)
    tp_e = tp_local(params["w_gate"].shape[0], E)
    tp = tp_e or tp_local(params["w_gate"].shape[2], spec.d_ff)
    xt = x if tp is None else tp.copy(x)
    E_l = params["w_gate"].shape[0]
    e0 = 0 if tp_e is None else tp_e.rank * E_l
    flat_e = idx.reshape(B, T * K) - e0
    if tp_e is not None:
        keep = keep & (flat_e >= 0) & (flat_e < E_l)
    rows = torch.arange(B, device=x.device)[:, None]
    slot = (flat_e * B + rows) * cap + rank                    # [B,TK]
    n_rows = E_l * B * cap
    dest = torch.where(keep, slot, n_rows)
    xr = xt.repeat_interleave(K, dim=1)                        # [B,TK,D]
    buf = x.new_zeros((n_rows + 1, D)).index_put(
        (dest.reshape(-1),), xr.reshape(-1, D))
    buf = constrain(buf[:n_rows].view(E_l, B * cap, D), "experts", "batch",
                    "embed")
    g = torch.bmm(buf, params["w_gate"])
    h = torch.bmm(buf, params["w_in"])
    act = constrain(F.silu(g.float()).to(x.dtype) * h, "experts", "batch",
                    "ff")
    out = constrain(torch.bmm(act, params["w_out"]), "experts", "batch",
                    "embed").view(n_rows, D)
    y_slots = out[torch.where(keep, slot, 0)]                  # [B,TK,D]
    y_slots = torch.where(keep[..., None], y_slots, 0)
    w = gate_vals.reshape(B, T * K, 1).to(x.dtype)
    if tp is not None:
        # the gates (replicated) weight the rank's partial slots
        w = tp.copy(w)
    y = (y_slots * w).view(B, T, K, D).sum(2)
    return (y if tp is None else tp.reduce(y)), {"moe_aux": aux}
