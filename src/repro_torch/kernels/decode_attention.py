"""Decode attention (K3): wrapper around the CUDA kernel
`csrc/decode_attention.cu`, beside its plain PyTorch version.

Replaces the TPU kernel `repro/kernels/decode_attention.py::
decode_attention` (`_kernel`). It is bound by memory: each valid K/V row is
read once. The kernel splits the cache across CTAs (flash-decoding): the
grid is (batch row x kv head, split), each CTA streams its split's keys
through a ring of `cp.async` stages and serves the head's whole GQA group,
and the splits of one (row, kv head) form a thread-block cluster: each CTA
writes its partial softmax state into the others' shared memory and
merges its share of the output columns over the splits in split order;
see the source's header note. `split_plan` picks the split from S, a host
int.

Any cache length S is taken (the Pallas kernel needs S % 512 == 0 past
512). Rows with length 0 return zeros, as the Pallas kernel does; the plain
version (`ref.mha_reference`) returns mean(v) there, a case the decode path
never reaches (`attention_decode` passes lengths >= 1). The kernel's copies
need 16-byte-aligned q, k and v; the wrapper raises on others.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises."""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build, ref

HEAD_DIMS = (16, 32, 64, 128)    # 16 in f32 only (a row of 4+ chunks)
DTYPES = (torch.float32, torch.bfloat16)
MAX_GROUP = 8   # MAXG in the kernel
MAX_SPLITS = 8        # MAX_SPLITS in the kernel: a portable cluster
SPLIT_KEYS = 64       # a split is a multiple of 64 keys (of every tile)
CTAS_PER_SM = 4       # the splits aim at about this many CTAs an SM

_sms: dict = {}       # device index -> its SM count


def split_plan(B: int, S: int, Hkv: int, n_sm: int) -> tuple[int, int]:
    """(keys a split, splits) for a cache of S keys: splits of 64 keys or a
    multiple, as many as give about CTAS_PER_SM CTAs an SM over the
    B * Hkv (row, kv head) pairs, and at least one."""
    if S == 0:
        return SPLIT_KEYS, 1
    n = min(-(-S // SPLIT_KEYS), MAX_SPLITS,
            max(1, -(-CTAS_PER_SM * n_sm // (B * Hkv))))
    keys = -(-S // n)
    keys = -(-keys // SPLIT_KEYS) * SPLIT_KEYS
    return keys, -(-S // keys)


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
            (Dh == 16 and q.dtype != torch.float32) or \
            not 1 <= group <= MAX_GROUP:
        raise ValueError(f"decode_attention takes head_dim in {HEAD_DIMS} "
                         f"(16 in f32 only), dtype in {DTYPES} and group <= "
                         f"{MAX_GROUP}; got "
                         f"{Dh}, {q.dtype}, {group}")
    for a in (q, k, v):
        if a.device != q.device or a.dtype != q.dtype or \
                not a.is_contiguous():
            raise ValueError("decode_attention takes contiguous q/k/v of one "
                             "dtype on one CUDA device")
    if lengths.shape != (B,) or lengths.dtype != torch.int32 or \
            lengths.device != q.device:
        raise ValueError(f"lengths must be int32 [{B}] on {q.device}")
    if any(a.data_ptr() % 16 for a in (q, k, v)):
        raise ValueError("decode_attention takes 16-byte-aligned q, k, v "
                         "(the 16-byte copies' rule)")
    lengths = lengths.contiguous()
    o = torch.empty_like(q)
    lib = _build.load()
    dev = q.device.index
    if dev not in _sms:
        _sms[dev] = torch.cuda.get_device_properties(
            dev).multi_processor_count
    split_keys, n_split = split_plan(B, S, Hkv, _sms[dev])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.decode_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
            o.data_ptr(), B, S, Hq, Hkv, group, Dh,
            int(q.dtype == torch.bfloat16), split_keys, n_split,
            1.0 / math.sqrt(Dh), stream)
    _build.check(rc, "decode_attention")
    decode_attention.launches += 1
    return o


decode_attention.launches = 0
