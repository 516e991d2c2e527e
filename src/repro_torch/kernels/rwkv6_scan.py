"""RWKV6 recurrence (K9): wrapper around the CUDA kernel
`csrc/rwkv6_scan.cu`, beside its plain PyTorch version.

Replaces the TPU kernel `repro/kernels/rwkv6_scan.py::rwkv6_scan`
(`_kernel`, `pl.pallas_call` at :84), which walks the time axis in chunks
on a sequential grid axis with the `[Dh, Dh]` f32 state in VMEM.

What bounds it on this card: at the serve path's prefill (B 4, T 256, 64
heads, Dh 64, bf16) the bytes (~55 MB, ~16 us): the ~5 f32 operations per
state element and time step (1.34 GFLOP) run on the bf16 tensor cores as
three bf16 products at most (~4.1 us at 989 TFLOP/s); in f32, on the CUDA
cores, they take ~20 us at 67 TFLOP/s and bound it. At decode (T = 1) the
f32 state read and written (8.4 MB) bounds it.

Design: the chunked gated-linear-attention form, spread across the SMs.
Blocks on the card run in parallel and in no order, so the prefill is two
launches of one kernel, a tile per (batch row, head, chunk of `CHUNK`
steps): the first computes each chunk's end state and per-key decay
(chunk 0 from the initial state, with its y; the others from zero), the
second folds the state before each later chunk from those and computes
its y, the last chunk writing the final state. A tile walks its chunk in
sub-chunks of `SUB` steps, and every decay inside is a running product of
at most `SUB` factors exp(w) in (0, 1], so no factor e^{-sum w} can
overflow whatever the decays (the factorised form overflows once a span's
sum |w| passes ~88). exp(w) is taken once an element. bf16 runs the
products with the state on the tensor cores, the f32 operands split into
bf16 terms (the state keeps f32's accuracy; y is rounded to bf16 once, at
its store); f32 runs them as FMAs. T <= `CHUNK` is one launch; decode (T =
1) is one launch of a kernel with one CTA per (batch row, head) that moves
the state in 16-byte vectors. The wrapper allocates
the scratch (the chunks' end states and decays, ~17 MB at the serve
prefill) with `torch.empty`. Any T is taken (the Pallas kernel needs T %
min(64, T) == 0).

In place: `state_out` (f32 `[B,H,Dh,Dh]`, contiguous) receives the final
state and is returned; it may be the same tensor as `init_state`, so the
model hands the scan its cache slice and the step writes the state there
without a copy. Without `state_out` a new state is allocated.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises. The kernel's copies need r, k, v, w, the states and y on 16-byte
addresses; the wrapper refuses others.

Training: `Rwkv6Scan` is the counterpart of the reference's
`jax.custom_vjp` around the Pallas kernel (`repro/kernels/ops.py:108-132`):
its forward is K9 (the plain version on a CPU tensor), its backward the
gradient of the plain version on the saved inputs (`ref.plain_vjp`), as
the reference's is `jax.vjp` of its oracle; the Pallas side has no
backward kernel. So the forward value is K9's chunked sum and the gradient
is the step-by-step recurrence's at the same inputs; on bf16 inputs the
two part by K9's rounding, as Pallas and oracle part on the TPU. The
backward re-runs the plain loop under autograd and walks it back: ~8
tensor ops a time step each way, and a few `[B,H,Dh,Dh]` f32 tensors
saved a step."""

from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref

HEAD_DIMS = (64,)      # DH in the kernel
DTYPES = (torch.float32, torch.bfloat16)
CHUNK = 64             # time steps of one tile (the kernel's CHUNK)
SUB = 16               # time steps of one sub-chunk (its SUB)


def rwkv6_scan_plain(r, k, v, w, u, *, init_state=None, state_out=None):
    """The plain PyTorch version: `ref.rwkv6_scan_reference`; the final
    state is copied into `state_out` when one is given."""
    y, state = ref.rwkv6_scan_reference(r, k, v, w, u,
                                        init_state=init_state)
    return y, state if state_out is None else state_out.copy_(state)


def rwkv6_scan(r, k, v, w, u, *, init_state=None, state_out=None):
    """r, k, v [B,T,H,Dh] in one dtype; w [B,T,H,Dh] f32 log-decay (<= 0);
    u [H,Dh] f32; init_state [B,H,Dh,Dh] f32 or None (zeros) -> (y
    [B,T,H,Dh] in r.dtype, final state [B,H,Dh,Dh] f32, key-major). The
    final state is written into `state_out` when given (it may be
    `init_state` itself) and that tensor is returned."""
    if r.device.type == "cpu":
        return rwkv6_scan_plain(r, k, v, w, u, init_state=init_state,
                                state_out=state_out)
    if r.device.type != "cuda":
        raise ValueError(f"rwkv6_scan runs on cpu or cuda, got {r.device}")
    if r.dim() != 4:
        raise ValueError(f"r must be [B,T,H,Dh], got {tuple(r.shape)}")
    B, T, H, Dh = r.shape
    if Dh not in HEAD_DIMS or r.dtype not in DTYPES:
        raise ValueError(f"rwkv6_scan takes head_dim in {HEAD_DIMS} and "
                         f"r/k/v dtype in {DTYPES}; got {Dh}, {r.dtype}")
    want = [(k, r.dtype, r.shape, "k"), (v, r.dtype, r.shape, "v"),
            (w, torch.float32, r.shape, "w"),
            (u, torch.float32, (H, Dh), "u")]
    for st, name in ((init_state, "init_state"), (state_out, "state_out")):
        if st is not None:
            want.append((st, torch.float32, (B, H, Dh, Dh), name))
    for a, dtype, shape, name in [(r, r.dtype, r.shape, "r")] + want:
        if a.device != r.device or a.dtype != dtype or \
                tuple(a.shape) != tuple(shape) or not a.is_contiguous():
            raise ValueError(f"rwkv6_scan: {name} must be a contiguous "
                             f"{dtype} tensor of shape {tuple(shape)} on "
                             f"{r.device}; got {a.dtype} "
                             f"{tuple(a.shape)} on {a.device}")
    for a, name in ((r, "r"), (k, "k"), (v, "v"), (w, "w"),
                    (init_state, "init_state"), (state_out, "state_out")):
        if a is not None and a.data_ptr() % 16:
            raise ValueError(f"rwkv6_scan: {name} must start on a 16-byte "
                             f"address (the kernel's vector copies)")
    y = torch.empty_like(r)
    state = state_out if state_out is not None else torch.empty(
        (B, H, Dh, Dh), dtype=torch.float32, device=r.device)
    if T == 0:                  # nothing to scan: the state carries over
        return y, state.zero_() if init_state is None else \
            state.copy_(init_state)
    nc = -(-T // CHUNK)
    slot = decay = None
    if T > CHUNK:
        slot = torch.empty((B * H, nc, Dh, Dh), dtype=torch.float32,
                                  device=r.device)
        decay = torch.empty((B * H, nc, Dh), dtype=torch.float32,
                                  device=r.device)
    lib = _build.load()
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        rc = lib.rwkv6_scan_fwd(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(),
            None if init_state is None else init_state.data_ptr(),
            y.data_ptr(), state.data_ptr(),
            None if slot is None else slot.data_ptr(),
            None if decay is None else decay.data_ptr(),
            B, T, H, Dh, CHUNK, int(r.dtype == torch.bfloat16), stream)
    _build.check(rc, "rwkv6_scan")
    rwkv6_scan.launches += 1
    return y, state


rwkv6_scan.launches = 0


class Rwkv6Scan(torch.autograd.Function):
    """K9 with the plain version's gradient (see the module docstring):
    (r, k, v, w, u, init_state or None) -> (y, final state). The final
    state's gradient may be absent; `init_state` gets one only when it was
    given, as in the reference's `_rwkv6_bwd`."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, init_state, state_out=None):
        if state_out is not None:
            raise ValueError("rwkv6_scan: state_out (an in-place state "
                             "write) is refused on a differentiated call")
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(r, k, v, w, u, init_state)
        return rwkv6_scan(r, k, v, w, u, init_state=init_state)

    @staticmethod
    def backward(ctx, dy, dstate):
        return ref.plain_vjp(rwkv6_scan_plain, ctx, (dy, dstate)) + (None,)
