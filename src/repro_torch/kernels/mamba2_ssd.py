"""Mamba2 SSD scan (K8): wrapper around the CUDA kernel
`csrc/mamba2_ssd.cu`, beside its plain PyTorch version.

Replaces the TPU kernel `repro/kernels/mamba2_ssd.py::mamba2_ssd` (:82;
`_kernel`, `pl.pallas_call` at :107), the chunked SSD form: three MXU
matmuls per chunk of time steps, with the `[N, P]` f32 state in VMEM across
a sequential grid axis of chunks.

What bounds it on this card: at the hybrid serve path's prefill (B 4, T
256, 64 heads, P 64, N 64, bf16) the bytes (~21.5 MB, ~6.4 us): the ~5 f32
operations per state element and time step (1.34 GFLOP) run on the bf16
tensor cores as three bf16 products at most (~4.1 us at 989 TFLOP/s); in
f32, on the CUDA cores, they take ~20 us at 67 TFLOP/s and bound it. At
decode (T = 1) the f32 state read and written (8.4 MB) bounds it.

Design: the chunked form, spread across the SMs. Blocks on the card run
in parallel and in no order, so the prefill is two launches of one kernel,
a tile per (batch row, head, chunk of `CHUNK` steps): the first computes
each chunk's end state and decay (chunk 0 from the initial state, with
its y; the others from zero), the second folds the state before each
later chunk from those and computes its y, the last chunk writing the
final state. A tile walks its chunk in sub-chunks of `SUB` steps whose
decays are products of the per-step factors (no difference of cumulative
sums). bf16 runs the products on the tensor cores with the f32 operands
split into bf16 terms (the state keeps f32's accuracy; y is rounded to
bf16 once, at its store); f32 runs them as FMAs. T <= `CHUNK` is one
launch; decode (T = 1) is one launch of a kernel with one CTA per (batch
row, head) that moves the state in 16-byte vectors. The wrapper
allocates the scratch (the chunks' end states and decays, ~17 MB at the
serve prefill) with `torch.empty`. Any T is taken (the Pallas kernel needs
T % min(128, T) == 0).

In place: `state_out` (f32 `[Bt,H,N,P]`, contiguous) receives the final
state and is returned; it may be the same tensor as `init_state`, so the
model hands the scan its cache slice and the step writes the state there
without a copy. Without `state_out` a new state is allocated.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises. The kernel's copies need x, B, C, the states and y on 16-byte
addresses; the wrapper refuses others.

Training: `Mamba2Scan` is the counterpart of the reference's
`jax.custom_vjp` around the Pallas kernel (`repro/kernels/ops.py:68-92`):
its forward is K8 (the plain version on a CPU tensor), its backward the
gradient of the plain version on the saved inputs, as the reference's is
`jax.vjp` of its oracle. The Pallas side has no backward kernel. So the
forward value is K8's chunked sum and the gradient is the step-by-step
recurrence's at the same inputs; on bf16 inputs the two part by K8's
rounding (the y it stores is rounded to bf16 once), as Pallas and oracle
part on the TPU. The backward re-runs the plain loop under autograd and
walks it back (`ref.plain_vjp`): ~8 tensor ops a time step each way, and
a few `[Bt,H,N,P]` f32 tensors saved a step."""

from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref

HEAD_DIMS = (64,)            # P in the kernel
STATE_DIMS = (16, 64)        # N: the kernel's template instances
DTYPES = (torch.float32, torch.bfloat16)
CHUNK = 64                   # time steps of one tile (the kernel's CHUNK)
SUB = 16                     # time steps of one sub-chunk (its SUB)


def mamba2_ssd_plain(x, dt, A, B, C, D, *, init_state=None,
                     state_out=None):
    """The plain PyTorch version: `ref.mamba2_scan_reference`; the final
    state is copied into `state_out` when one is given."""
    y, state = ref.mamba2_scan_reference(x, dt, A, B, C, D,
                                         init_state=init_state)
    return y, state if state_out is None else state_out.copy_(state)


def mamba2_ssd(x, dt, A, B, C, D, *, init_state=None, state_out=None):
    """x [Bt,T,H,P] f32 or bf16; dt [Bt,T,H] f32 (softplus output); A, D
    [H] f32; B, C [Bt,T,G,N] in x.dtype; init_state [Bt,H,N,P] f32 or None
    (zeros) -> (y [Bt,T,H,P] in x.dtype, final state [Bt,H,N,P] f32). The
    final state is written into `state_out` when given (it may be
    `init_state` itself) and that tensor is returned."""
    if x.device.type == "cpu":
        return mamba2_ssd_plain(x, dt, A, B, C, D, init_state=init_state,
                                state_out=state_out)
    if x.device.type != "cuda":
        raise ValueError(f"mamba2_ssd runs on cpu or cuda, got {x.device}")
    if x.dim() != 4 or B.dim() != 4:
        raise ValueError(f"mamba2_ssd: x must be [Bt,T,H,P] and B "
                         f"[Bt,T,G,N]; got {tuple(x.shape)}, "
                         f"{tuple(B.shape)}")
    Bt, T, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    if P not in HEAD_DIMS or N not in STATE_DIMS or x.dtype not in DTYPES \
            or G < 1 or H % G:
        raise ValueError(f"mamba2_ssd takes head_dim in {HEAD_DIMS}, "
                         f"d_state in {STATE_DIMS}, x dtype in {DTYPES} and "
                         f"groups dividing the heads; got P={P}, N={N}, "
                         f"{x.dtype}, G={G}, H={H}")
    want = [(dt, torch.float32, (Bt, T, H), "dt"),
            (A, torch.float32, (H,), "A"),
            (B, x.dtype, (Bt, T, G, N), "B"),
            (C, x.dtype, (Bt, T, G, N), "C"),
            (D, torch.float32, (H,), "D")]
    for st, name in ((init_state, "init_state"), (state_out, "state_out")):
        if st is not None:
            want.append((st, torch.float32, (Bt, H, N, P), name))
    for a, dtype, shape, name in [(x, x.dtype, x.shape, "x")] + want:
        if a.device != x.device or a.dtype != dtype or \
                tuple(a.shape) != tuple(shape) or not a.is_contiguous():
            raise ValueError(f"mamba2_ssd: {name} must be a contiguous "
                             f"{dtype} tensor of shape {tuple(shape)} on "
                             f"{x.device}; got {a.dtype} "
                             f"{tuple(a.shape)} on {a.device}")
    for a, name in ((x, "x"), (B, "B"), (C, "C"), (init_state, "init_state"),
                    (state_out, "state_out")):
        if a is not None and a.data_ptr() % 16:
            raise ValueError(f"mamba2_ssd: {name} must start on a 16-byte "
                             f"address (the kernel's vector copies)")
    y = torch.empty_like(x)
    state = state_out if state_out is not None else torch.empty(
        (Bt, H, N, P), dtype=torch.float32, device=x.device)
    if T == 0:                  # nothing to scan: the state carries over
        return y, state.zero_() if init_state is None else \
            state.copy_(init_state)
    nc = -(-T // CHUNK)
    slot = decay = None
    if T > CHUNK:
        slot = torch.empty((Bt * H, nc, N, P), dtype=torch.float32,
                                  device=x.device)
        decay = torch.empty((Bt * H, nc), dtype=torch.float32,
                                  device=x.device)
    lib = _build.load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.mamba2_ssd_fwd(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
            C.data_ptr(), D.data_ptr(),
            None if init_state is None else init_state.data_ptr(),
            y.data_ptr(), state.data_ptr(),
            None if slot is None else slot.data_ptr(),
            None if decay is None else decay.data_ptr(),
            Bt, T, H, G, N, P, CHUNK, int(x.dtype == torch.bfloat16),
            stream)
    _build.check(rc, "mamba2_ssd")
    mamba2_ssd.launches += 1
    return y, state


mamba2_ssd.launches = 0


class Mamba2Scan(torch.autograd.Function):
    """K8 with the plain version's gradient (see the module docstring):
    (x, dt, A, B, C, D, init_state or None) -> (y, final state). The
    final state's gradient may be absent; `init_state` gets one only when
    it was given, as in the reference's `_mamba2_bwd`."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, D, init_state, state_out=None):
        if state_out is not None:
            raise ValueError("mamba2_ssd: state_out (an in-place state "
                             "write) is refused on a differentiated call")
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, dt, A, B, C, D, init_state)
        return mamba2_ssd(x, dt, A, B, C, D, init_state=init_state)

    @staticmethod
    def backward(ctx, dy, dstate):
        return ref.plain_vjp(mamba2_ssd_plain, ctx, (dy, dstate)) + (None,)

