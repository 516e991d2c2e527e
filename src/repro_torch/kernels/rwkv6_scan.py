"""RWKV6 recurrence (K9): wrapper around the CUDA kernel
`csrc/rwkv6_scan.cu`, beside its plain PyTorch version.

Replaces the TPU kernel `repro/kernels/rwkv6_scan.py::rwkv6_scan`
(`_kernel`, `pl.pallas_call` at :84), which walks the time axis in chunks
on a sequential grid axis with the `[Dh, Dh]` f32 state in VMEM.

What bounds it on this card: at the serve path's prefill (B 4, T 256, 64
heads, Dh 64) the ~5 f32 operations per state element and time step (1.34
GFLOP, ~20 us at 67 TFLOP/s) slightly outweigh the bytes (~55 MB, ~16 us);
at decode (T = 1) the f32 state read and written (8.4 MB) bounds it.

Design: blocks on the card run in parallel and in no order, so nothing
carries over between blocks: one block per (batch row, head) holds the
head's whole state in registers and runs the time loop itself. Column j of
the state is independent of the others (y_t[j] reads only S[:, j]), so four
threads share a column, sixteen rows each, and reduce y with two shuffles.
Per tile of time steps the block stages r, k, exp(w) and u*k in shared
memory with coalesced loads, and every column reuses them. Any T is taken
(the Pallas kernel needs T % min(64, T) == 0); decode runs at T = 1.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises."""

from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref

HEAD_DIMS = (64,)      # DH in the kernel
DTYPES = (torch.float32, torch.bfloat16)


def rwkv6_scan_plain(r, k, v, w, u, *, init_state=None):
    """The plain PyTorch version: `ref.rwkv6_scan_reference`."""
    return ref.rwkv6_scan_reference(r, k, v, w, u, init_state=init_state)


def rwkv6_scan(r, k, v, w, u, *, init_state=None):
    """r, k, v [B,T,H,Dh] in one dtype; w [B,T,H,Dh] f32 log-decay (<= 0);
    u [H,Dh] f32; init_state [B,H,Dh,Dh] f32 or None (zeros) -> (y
    [B,T,H,Dh] in r.dtype, final state [B,H,Dh,Dh] f32, key-major)."""
    if r.device.type == "cpu":
        return rwkv6_scan_plain(r, k, v, w, u, init_state=init_state)
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
    if init_state is not None:
        want.append((init_state, torch.float32, (B, H, Dh, Dh),
                     "init_state"))
    for a, dtype, shape, name in [(r, r.dtype, r.shape, "r")] + want:
        if a.device != r.device or a.dtype != dtype or \
                tuple(a.shape) != tuple(shape) or not a.is_contiguous():
            raise ValueError(f"rwkv6_scan: {name} must be a contiguous "
                             f"{dtype} tensor of shape {tuple(shape)} on "
                             f"{r.device}; got {a.dtype} "
                             f"{tuple(a.shape)} on {a.device}")
    y = torch.empty_like(r)
    state = torch.empty((B, H, Dh, Dh), dtype=torch.float32, device=r.device)
    lib = _build.load()
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        rc = lib.rwkv6_scan_fwd(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(),
            None if init_state is None else init_state.data_ptr(),
            y.data_ptr(), state.data_ptr(), B, T, H, Dh,
            int(r.dtype == torch.bfloat16), stream)
    _build.check(rc, "rwkv6_scan")
    rwkv6_scan.launches += 1
    return y, state


rwkv6_scan.launches = 0
