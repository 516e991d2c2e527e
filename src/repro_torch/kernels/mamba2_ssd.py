"""Mamba2 SSD scan (K8): wrapper around the CUDA kernel
`csrc/mamba2_ssd.cu`, beside its plain PyTorch version.

Replaces the TPU kernel `repro/kernels/mamba2_ssd.py::mamba2_ssd` (:82;
`_kernel`, `pl.pallas_call` at :107), the chunked SSD form: three MXU
matmuls per chunk of time steps, with the `[N, P]` f32 state in VMEM across
a sequential grid axis of chunks.

What bounds it on this card: at the hybrid serve path's prefill (B 4, T
256, 64 heads, P 64, N 64) the ~5 f32 operations per state element and
time step (1.34 GFLOP, ~20 us at 67 TFLOP/s) outweigh the bytes (~21.5 MB,
~6.4 us); at decode (T = 1) the f32 state read and written (8.4 MB) bounds
it.

Design: blocks on the card run in parallel and in no order, so nothing
carries over between blocks: one block per (batch row, head) holds the
head's whole state in registers and runs the time loop itself. Column p of
the state is independent of the others (y_t[p] reads only S[:, p]), so four
threads share a column, N/4 rows each, and reduce y with two shuffles. The
decay is one scalar exp(dt*A) per (step, head). Per tile of time steps the
block stages x, dt*B, C and the decay in shared memory with coalesced
loads, and every column reuses them (B and C are shared by every head of a
group). Any T is taken (the Pallas kernel needs T % min(128, T) == 0);
decode runs at T = 1. The chunked tensor-core form would do the prefill's
work as bf16 matmuls (~3.2 GFLOP) and leave the bytes as the bound; it is
left to a later change.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises."""

from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref

HEAD_DIMS = (64,)            # P in the kernel
STATE_DIMS = (16, 64)        # N: the kernel's template instances
DTYPES = (torch.float32, torch.bfloat16)


def mamba2_ssd_plain(x, dt, A, B, C, D, *, init_state=None):
    """The plain PyTorch version: `ref.mamba2_scan_reference`."""
    return ref.mamba2_scan_reference(x, dt, A, B, C, D,
                                     init_state=init_state)


def mamba2_ssd(x, dt, A, B, C, D, *, init_state=None):
    """x [Bt,T,H,P] f32 or bf16; dt [Bt,T,H] f32 (softplus output); A, D
    [H] f32; B, C [Bt,T,G,N] in x.dtype; init_state [Bt,H,N,P] f32 or None
    (zeros) -> (y [Bt,T,H,P] in x.dtype, final state [Bt,H,N,P] f32)."""
    if x.device.type == "cpu":
        return mamba2_ssd_plain(x, dt, A, B, C, D, init_state=init_state)
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
    if init_state is not None:
        want.append((init_state, torch.float32, (Bt, H, N, P),
                     "init_state"))
    for a, dtype, shape, name in [(x, x.dtype, x.shape, "x")] + want:
        if a.device != x.device or a.dtype != dtype or \
                tuple(a.shape) != tuple(shape) or not a.is_contiguous():
            raise ValueError(f"mamba2_ssd: {name} must be a contiguous "
                             f"{dtype} tensor of shape {tuple(shape)} on "
                             f"{x.device}; got {a.dtype} "
                             f"{tuple(a.shape)} on {a.device}")
    y = torch.empty_like(x)
    state = torch.empty((Bt, H, N, P), dtype=torch.float32, device=x.device)
    lib = _build.load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.mamba2_ssd_fwd(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
            C.data_ptr(), D.data_ptr(),
            None if init_state is None else init_state.data_ptr(),
            y.data_ptr(), state.data_ptr(), Bt, T, H, G, N, P,
            int(x.dtype == torch.bfloat16), stream)
    _build.check(rc, "mamba2_ssd")
    mamba2_ssd.launches += 1
    return y, state


mamba2_ssd.launches = 0
