"""Flash-attention forward (K2): wrapper around the CUDA kernel
`csrc/flash_attention.cu`, beside its plain PyTorch version.

Replaces the TPU kernel `repro/kernels/flash_attention.py::_fwd`
(`_fwd_kernel`). At the serve path's prefill shapes the least time is set by
memory (~34 MB moved); this first kernel runs its products on f32 FMAs, so
it is limited by FMA and shared-memory issue instead. One block per
(batch, q head, 64-row q tile) walks 32-key K/V tiles in shared memory with
the online softmax in registers and skips tiles the causal/window mask
empties; see the source's header note.

Layout is the reference's `[B, T, H, Dh]` throughout. Unlike the Pallas
kernel, T and S need not tile: the ragged tails are masked in the kernel.
The backward kernels (`_bwd_dq_kernel`, `_bwd_dkv_kernel`) are not ported
yet; the lse output is kept for them.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises."""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build, ref

HEAD_DIMS = (32, 64, 128)
DTYPES = (torch.float32, torch.bfloat16)


def flash_attention_plain(q, k, v, *, causal: bool = True, group: int = 1,
                          sliding_window: int = 0):
    """The plain PyTorch version: (o [B,T,Hq,Dh] in q.dtype, lse [B,Hq,T]
    f32). `o` is `ref.mha_reference` op for op."""
    scores = ref.masked_scores(q, k, causal=causal, group=group,
                               sliding_window=sliding_window)
    return (ref.attend(scores, v, group=group, dtype=q.dtype),
            torch.logsumexp(scores, dim=-1))


def flash_attention(q, k, v, *, causal: bool = True, group: int = 1,
                    sliding_window: int = 0):
    """q [B,T,Hq,Dh], k/v [B,S,Hkv,Dh] with Hq = group * Hkv -> (o in
    q.dtype [B,T,Hq,Dh], lse [B,Hq,T] f32)."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, group=group,
                                     sliding_window=sliding_window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cpu or cuda, "
                         f"got {q.device}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q [B,T,Hq,Dh], k/v [B,S,Hkv,Dh]; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, T, Hq, Dh = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != Dh or Hq != group * Hkv:
        raise ValueError(f"shapes {tuple(q.shape)} / {tuple(k.shape)} do "
                         f"not match group={group}")
    if Dh not in HEAD_DIMS or q.dtype not in DTYPES:
        raise ValueError(f"flash_attention takes head_dim in {HEAD_DIMS} "
                         f"and dtype in {DTYPES}; got {Dh}, {q.dtype}")
    if sliding_window and not causal:
        raise ValueError("sliding_window applies to causal attention only")
    for a in (q, k, v):
        if a.device != q.device or a.dtype != q.dtype or \
                not a.is_contiguous():
            raise ValueError("flash_attention takes contiguous q/k/v of one "
                             "dtype on one CUDA device")
    o = torch.empty_like(q)
    lse = torch.empty((B, Hq, T), dtype=torch.float32, device=q.device)
    lib = _build.load()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), B, T, S, Hq, Hkv, group, Dh,
            int(q.dtype == torch.bfloat16), int(causal), sliding_window,
            1.0 / math.sqrt(Dh), stream)
    _build.check(rc, "flash_attention")
    flash_attention.launches += 1
    return o, lse


flash_attention.launches = 0
