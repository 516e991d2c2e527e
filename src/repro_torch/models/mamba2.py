"""Mamba2 block (state-space dual form), used by the zamba2 hybrid
architecture; ported from `repro/models/mamba2.py`. Prefill runs the SSD
scan over the prompt; decode carries (conv states, ssm state) and advances
one token in O(1).

The input projection is kept as separate weights (w_z, w_x, w_B, w_C,
w_dt), as in the reference, so weights carry over one to one; the
depthwise causal conv runs per component, which equals the fused layout.

The casts sit where the reference has them: the conv sums its shifted
products in the input dtype and applies silu in f32; the step size is
`softplus(dt in f32 + dt_bias)` and stays f32; `A = -exp(A_log)`; the gate
is `silu(z in f32)` cast back before the gated RMS norm. `A_log`, `D` and
`dt_bias` are f32 parameters in any model dtype. The scan itself is
`ops.mamba2_scan` (K8). Unlike the reference, whose functions are pure, a
caller may hand the scan an output buffer for the ssm state (`ssm_out`):
the serve path passes its cache slice, so a decode step updates the state
in place. The training path (`lm.forward_train`) passes none: every op
here is differentiable and writes nothing in place, and under grad the
scan is differentiable (K8's forward, the plain version's gradient; it
refuses an output buffer)."""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models import common
from repro_torch.parallel.sharding import tp_local

# parameters the reference creates in f32 whatever the model's dtype
F32_PARAMS = ("A_log", "D", "dt_bias")


@dataclasses.dataclass(frozen=True)
class Mamba2Spec:
    d_model: int
    d_state: int          # N
    head_dim: int = 64    # P
    expand: int = 2
    n_groups: int = 1     # B/C groups
    conv_width: int = 4

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def n_heads(self) -> int:
        return self.d_inner // self.head_dim


def param_shapes(spec: Mamba2Spec) -> dict[str, tuple[int, ...]]:
    D, Din, H, W = spec.d_model, spec.d_inner, spec.n_heads, spec.conv_width
    GN = spec.n_groups * spec.d_state
    return {
        "w_z": (D, Din), "w_x": (D, Din), "w_B": (D, GN), "w_C": (D, GN),
        "w_dt": (D, H),
        "conv_x_w": (W, Din), "conv_x_b": (Din,),
        "conv_B_w": (W, GN), "conv_B_b": (GN,),
        "conv_C_w": (W, GN), "conv_C_b": (GN,),
        "A_log": (H,), "D": (H,), "dt_bias": (H,),
        "norm_w": (Din,), "w_out": (Din, D),
    }


def init_mamba2(gen: torch.Generator, spec: Mamba2Spec, dtype=torch.float32):
    """Random weights from `gen` with the reference's distributions; the
    three f32 leaves are deterministic (log(linspace(1, 16, H)), ones,
    log(expm1(0.01)))."""
    D, Din, H, W = spec.d_model, spec.d_inner, spec.n_heads, spec.conv_width
    GN = spec.n_groups * spec.d_state
    dev = gen.device

    def dense(shape, fan_in):
        return common.dense_init(gen, shape, fan_in, dtype)

    def zeros(n):
        return torch.zeros((n,), dtype=dtype, device=dev)

    return {
        "w_z": dense((D, Din), D),
        "w_x": dense((D, Din), D),
        "w_B": dense((D, GN), D),
        "w_C": dense((D, GN), D),
        "w_dt": dense((D, H), D),
        "conv_x_w": dense((W, Din), W),
        "conv_x_b": zeros(Din),
        "conv_B_w": dense((W, GN), W),
        "conv_B_b": zeros(GN),
        "conv_C_w": dense((W, GN), W),
        "conv_C_b": zeros(GN),
        "A_log": torch.log(torch.linspace(1.0, 16.0, H, dtype=torch.float32,
                                          device=dev)),
        "D": torch.ones((H,), dtype=torch.float32, device=dev),
        "dt_bias": torch.full((H,), math.log(math.expm1(0.01)),
                              dtype=torch.float32, device=dev),
        "norm_w": torch.ones((Din,), dtype=dtype, device=dev),
        "w_out": dense((Din, D), Din),
    }


def _causal_conv(u, conv_w, conv_b, *, prev=None, silu=True):
    """Depthwise causal conv over time. u [B,T,C]; conv_w [W,C]; prev
    [B,W-1,C] prepends history (decode). Returns (y [B,T,C], new_prev)."""
    W, T = conv_w.shape[0], u.shape[1]
    if prev is None:
        prev = torch.zeros(u.shape[:1] + (W - 1, u.shape[-1]),
                           dtype=u.dtype, device=u.device)
    xfull = torch.cat([prev, u], dim=1)                    # [B,T+W-1,C]
    out = sum(xfull[:, i:i + T] * conv_w[i] for i in range(W))
    out = out + conv_b
    if silu:
        out = F.silu(out.float()).to(u.dtype)
    new_prev = xfull[:, -(W - 1):] if W > 1 else prev
    return out, new_prev


def init_mamba2_state(batch: int, spec: Mamba2Spec, dtype=torch.bfloat16,
                      device="cuda"):
    """Per-layer decode state: ((conv_x [B,W-1,Din], conv_B, conv_C
    [B,W-1,G*N]) in the model dtype, ssm [B,H,N,P] f32)."""
    device = common.resolve_device(device)
    W, GN = spec.conv_width, spec.n_groups * spec.d_state

    def zeros(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    convs = (zeros(batch, W - 1, spec.d_inner), zeros(batch, W - 1, GN),
             zeros(batch, W - 1, GN))
    ssm = zeros(batch, spec.n_heads, spec.d_state, spec.head_dim,
                dt=torch.float32)
    return convs, ssm


def mamba2_forward(params, x, spec: Mamba2Spec, *, init_state=None,
                   ssm_out=None):
    """A training or prefill pass (or a decode step with `init_state`).
    x [B,T,D] ->
    (y [B,T,D], ((conv_x, conv_B, conv_C), ssm)). With `ssm_out` (f32
    [B,H,N,P], e.g. the decode cache's slice, which may be `init_state`'s
    own ssm) the scan writes the new ssm state there in place and that
    tensor is returned."""
    B, T, _ = x.shape
    N, G, P = spec.d_state, spec.n_groups, spec.head_dim
    convs_prev = (None,) * 3 if init_state is None else init_state[0]
    ssm_prev = None if init_state is None else init_state[1]
    # tensor parallelism over the SSD heads: z, x, dt, the x conv, A, D,
    # dt_bias and the norm weight are the rank's; B and C stay whole
    tp = tp_local(params["w_x"].shape[1], spec.d_inner)
    xt = x if tp is None else tp.copy(x)
    H = params["w_dt"].shape[1]

    z = xt @ params["w_z"]
    xs = xt @ params["w_x"]
    Bm = x @ params["w_B"]
    Cm = x @ params["w_C"]
    dt = xt @ params["w_dt"]

    xs, sx = _causal_conv(xs, params["conv_x_w"], params["conv_x_b"],
                          prev=convs_prev[0])
    Bm, sB = _causal_conv(Bm, params["conv_B_w"], params["conv_B_b"],
                          prev=convs_prev[1])
    Cm, sC = _causal_conv(Cm, params["conv_C_w"], params["conv_C_b"],
                          prev=convs_prev[2])
    if tp is not None:
        Bm, Cm = tp.copy(Bm), tp.copy(Cm)

    xh = xs.reshape(B, T, H, P)
    Bh = Bm.reshape(B, T, G, N)
    Ch = Cm.reshape(B, T, G, N)
    dts = F.softplus(dt.float() + params["dt_bias"])
    A = -torch.exp(params["A_log"])

    y, ssm_state = ops.mamba2_scan(xh, dts, A, Bh, Ch, params["D"],
                                   init_state=ssm_prev, state_out=ssm_out)
    y = y.reshape(B, T, H * P)
    g = y * F.silu(z.float()).to(y.dtype)
    if tp is None:
        y = common.rms_norm(g, params["norm_w"])
        return y @ params["w_out"], ((sx, sB, sC), ssm_state)
    # the gated RMSNorm is over the whole d_inner: its sum of squares is
    # reduced over the model group, then w_out is row-parallel
    gf = g.float()
    var = tp.allsum(gf.square().sum(-1, keepdim=True)) / spec.d_inner
    y = (gf * torch.rsqrt(var + 1e-5) * params["norm_w"].float()).to(g.dtype)
    return tp.reduce(y @ params["w_out"]), ((sx, sB, sC), ssm_state)


def mamba2_decode(params, x, state, spec: Mamba2Spec):
    """Single-token step: x [B,1,D]."""
    return mamba2_forward(params, x, spec, init_state=state)
