"""Decode attention (K3): wrapper around the CUDA kernel
`csrc/decode_attention.cu`, beside its plain PyTorch version.

Replaces the TPU kernel `repro/kernels/decode_attention.py::
decode_attention` (`_kernel`). It is bound by memory: each valid K/V row is
read once. One block per (batch row, kv head) serves the head's whole GQA
group, so the group shares each row read; warps take keys round-robin up
to `lengths[b]`; see the source's header note.

Any cache length S is taken (the Pallas kernel needs S % 512 == 0 past
512). Rows with length 0 return zeros, as the Pallas kernel does; the plain
version (`ref.mha_reference`) returns mean(v) there, a case the decode path
never reaches (`attention_decode` passes lengths >= 1).

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises."""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build, ref

HEAD_DIMS = (32, 64, 128)
DTYPES = (torch.float32, torch.bfloat16)
MAX_GROUP = 8   # MAXG in the kernel


def decode_attention_plain(q, k, v, lengths, *, group: int = 1):
    """The plain PyTorch version: `ref.mha_reference(lengths=)`."""
    return ref.mha_reference(q, k, v, causal=False, group=group,
                             lengths=lengths)


def decode_attention(q, k, v, lengths, *, group: int = 1):
    """q [B,1,Hq,Dh]; k/v [B,S,Hkv,Dh]; lengths [B] int32 -> [B,1,Hq,Dh]."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, lengths, group=group)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention runs on cpu or cuda, "
                         f"got {q.device}")
    if q.dim() != 4 or q.shape[1] != 1 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q [B,1,Hq,Dh], k/v [B,S,Hkv,Dh]; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, _, Hq, Dh = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != Dh or Hq != group * Hkv:
        raise ValueError(f"shapes {tuple(q.shape)} / {tuple(k.shape)} do "
                         f"not match group={group}")
    if Dh not in HEAD_DIMS or q.dtype not in DTYPES or \
            not 1 <= group <= MAX_GROUP:
        raise ValueError(f"decode_attention takes head_dim in {HEAD_DIMS}, "
                         f"dtype in {DTYPES} and group <= {MAX_GROUP}; got "
                         f"{Dh}, {q.dtype}, {group}")
    for a in (q, k, v):
        if a.device != q.device or a.dtype != q.dtype or \
                not a.is_contiguous():
            raise ValueError("decode_attention takes contiguous q/k/v of one "
                             "dtype on one CUDA device")
    if lengths.shape != (B,) or lengths.dtype != torch.int32 or \
            lengths.device != q.device:
        raise ValueError(f"lengths must be int32 [{B}] on {q.device}")
    lengths = lengths.contiguous()
    o = torch.empty_like(q)
    lib = _build.load()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.decode_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
            o.data_ptr(), B, S, Hq, Hkv, group, Dh,
            int(q.dtype == torch.bfloat16), 1.0 / math.sqrt(Dh), stream)
    _build.check(rc, "decode_attention")
    decode_attention.launches += 1
    return o


decode_attention.launches = 0
