"""Flash attention, forward (K2) and backward (K4 dq, K5 dk/dv): wrappers
around the CUDA kernels `csrc/flash_attention_sm90.cu` and
`csrc/flash_attention.cu` (K2), `csrc/flash_attention_bwd_sm90.cu` and
`csrc/flash_attention_bwd.cu` (K4, K5), beside their plain PyTorch
versions, and the `torch.autograd.Function` that joins them.

Replaces the TPU kernels of `repro/kernels/flash_attention.py`: `_fwd`
(`_fwd_kernel`) and `_bwd` (`_bwd_dq_kernel`, `_bwd_dkv_kernel`). At the
serve path's prefill and the training path's shapes the least time of each
is set by memory. Each entry point has two kernels behind it:

- bf16 at head_dim 64 and 128 (every full-width path) runs on the tensor
  cores: one warpgroup per 64-row output tile, operand tiles loaded by TMA
  into a two-stage ring, every product on `wgmma`. K2 walks K/V tiles for
  a q tile (Q K^T, P V; p rounded to bf16 before P V). K4 walks K/V tiles
  for a q tile (Q K^T, dO V^T, dS K); K5 walks the group members x q tiles
  for a 64-key tile (K Q^T, V dO^T, p^T dO, dS^T Q), each owning its output
  tile (no atomics, the same bits every run); p and dS are rounded to bf16
  before their products.
- f32, and bf16 at head_dim 32, run FMA kernels on shared-memory tiles
  (TF32 would lose the f32 callers' digits; these are the tiny configs).

See the sources' header notes for what bounds each and why.

Layout is the reference's `[B, T, H, Dh]` throughout. Unlike the Pallas
kernels, T and S need not tile: the ragged tails are masked in the kernels.
The kernels take 16-byte-aligned q, k, v (and do for the backward), TMA's
rule, and raise otherwise.

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


def _bwd_plain(q, k, v, do, lse, delta, *, causal: bool, group: int,
               sliding_window: int, want_dq: bool, want_dkv: bool):
    """The Pallas `_bwd` math in plain PyTorch: p recomputed from the saved
    lse, ds = p * (do v^T - delta), dq = scale * ds k, dk = ds^T (q *
    scale), dv = p^T do, dk/dv summed over the GQA group."""
    B, T, Hq, Dh = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    scale = 1.0 / math.sqrt(Dh)
    scores = ref.masked_scores(q, k, causal=causal, group=group,
                               sliding_window=sliding_window)
    p = torch.exp(scores - lse[..., None])                    # [B,Hq,T,S]
    dof = do.float()
    vf = v.float().repeat_interleave(group, dim=2)
    dp = torch.einsum("bthd,bshd->bhts", dof, vf)
    ds = p * (dp - delta[..., None])
    out = ()
    if want_dq:
        kf = k.float().repeat_interleave(group, dim=2)
        out += (torch.einsum("bhts,bshd->bthd", ds, kf).mul_(scale)
                .to(q.dtype),)
    if want_dkv:
        dk = torch.einsum("bhts,bthd->bshd", ds, q.float() * scale)
        dv = torch.einsum("bhts,bthd->bshd", p, dof)
        out += (dk.reshape(B, S, Hkv, group, Dh).sum(3).to(k.dtype),
                dv.reshape(B, S, Hkv, group, Dh).sum(3).to(v.dtype))
    return out


def flash_attention_bwd_dq_plain(q, k, v, do, lse, delta, *,
                                 causal: bool = True, group: int = 1,
                                 sliding_window: int = 0):
    """The plain version of K4: dq in q.dtype."""
    return _bwd_plain(q, k, v, do, lse, delta, causal=causal, group=group,
                      sliding_window=sliding_window, want_dq=True,
                      want_dkv=False)[0]


def flash_attention_bwd_dkv_plain(q, k, v, do, lse, delta, *,
                                  causal: bool = True, group: int = 1,
                                  sliding_window: int = 0):
    """The plain version of K5: (dk, dv) in k.dtype."""
    return _bwd_plain(q, k, v, do, lse, delta, causal=causal, group=group,
                      sliding_window=sliding_window, want_dq=False,
                      want_dkv=True)


def bwd_delta(o, do):
    """delta = rowsum(o * do) in f32, [B, Hq, T] (the Pallas `_bwd`
    computes it outside its kernels too)."""
    return (o.float() * do.float()).sum(-1).transpose(1, 2).contiguous()


def flash_attention_bwd_plain(q, k, v, o, lse, do, *, causal: bool = True,
                              group: int = 1, sliding_window: int = 0):
    """The plain backward: (dq, dk, dv) in q/k/v's dtypes from the forward's
    saved (q, k, v, o, lse) and the incoming do."""
    return _bwd_plain(q, k, v, do, lse, bwd_delta(o, do), causal=causal,
                      group=group, sliding_window=sliding_window,
                      want_dq=True, want_dkv=True)


def _check(name: str, q, k, v, extra, *, causal: bool, group: int,
           sliding_window: int):
    """The kernels' contract: CUDA, [B,T,Hq,Dh] q and `extra` tensors of
    q's shape, [B,S,Hkv,Dh] k/v, head_dim and dtype supported, all
    contiguous, one dtype and device."""
    if q.device.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda, got {q.device}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q [B,T,Hq,Dh], k/v [B,S,Hkv,Dh]; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, _, Hq, Dh = q.shape
    if k.shape[0] != B or k.shape[3] != Dh or Hq != group * k.shape[2]:
        raise ValueError(f"shapes {tuple(q.shape)} / {tuple(k.shape)} do "
                         f"not match group={group}")
    if Dh not in HEAD_DIMS or q.dtype not in DTYPES:
        raise ValueError(f"{name} takes head_dim in {HEAD_DIMS} and dtype in "
                         f"{DTYPES}; got {Dh}, {q.dtype}")
    if sliding_window and not causal:
        raise ValueError("sliding_window applies to causal attention only")
    for a in (q, k, v, *extra):
        if a.device != q.device or a.dtype != q.dtype or \
                not a.is_contiguous():
            raise ValueError(f"{name} takes contiguous tensors of one dtype "
                             f"on one CUDA device")
    for a in extra:
        if a.shape != q.shape:
            raise ValueError(f"{name}: {tuple(a.shape)} != q's "
                             f"{tuple(q.shape)}")


def _stats_ok(name: str, q, *stats):
    """lse / delta: contiguous f32 [B, Hq, T] on q's device."""
    B, T, Hq, _ = q.shape
    for a in stats:
        if tuple(a.shape) != (B, Hq, T) or a.dtype != torch.float32 or \
                a.device != q.device or not a.is_contiguous():
            raise ValueError(f"{name}: lse/delta must be contiguous float32 "
                             f"[{B}, {Hq}, {T}] on {q.device}")


def _aligned(name: str, **tensors):
    """TMA's rule: every tensor it loads starts on 16 bytes."""
    if any(a.data_ptr() % 16 for a in tensors.values()):
        raise ValueError(f"{name} takes 16-byte-aligned "
                         f"{', '.join(tensors)} (the TMA loads' rule)")


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def flash_attention(q, k, v, *, causal: bool = True, group: int = 1,
                    sliding_window: int = 0):
    """K2. q [B,T,Hq,Dh], k/v [B,S,Hkv,Dh] with Hq = group * Hkv -> (o in
    q.dtype [B,T,Hq,Dh], lse [B,Hq,T] f32)."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, group=group,
                                     sliding_window=sliding_window)
    _check("flash_attention", q, k, v, (), causal=causal, group=group,
           sliding_window=sliding_window)
    _aligned("flash_attention", q=q, k=k, v=v)
    B, T, Hq, Dh = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    o = torch.empty_like(q)
    lse = torch.empty((B, Hq, T), dtype=torch.float32, device=q.device)
    lib = _build.load()
    with torch.cuda.device(q.device):
        rc = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), B, T, S, Hq, Hkv, group, Dh,
            int(q.dtype == torch.bfloat16), int(causal), sliding_window,
            1.0 / math.sqrt(Dh), _stream(q.device))
    _build.check(rc, "flash_attention")
    flash_attention.launches += 1
    return o, lse


def flash_attention_bwd_dq(q, k, v, do, lse, delta, *, causal: bool = True,
                           group: int = 1, sliding_window: int = 0):
    """K4 on CUDA tensors: dq [B,T,Hq,Dh] in q.dtype from q, k, v, the
    incoming do [B,T,Hq,Dh], the forward's lse and delta = rowsum(o * do),
    both f32 [B,Hq,T]."""
    _check("flash_attention_bwd_dq", q, k, v, (do,), causal=causal,
           group=group, sliding_window=sliding_window)
    _stats_ok("flash_attention_bwd_dq", q, lse, delta)
    _aligned("flash_attention_bwd_dq", q=q, k=k, v=v, do=do)
    B, T, Hq, Dh = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    dq = torch.empty_like(q)
    lib = _build.load()
    with torch.cuda.device(q.device):
        rc = lib.flash_attention_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), B, T, S, Hq,
            Hkv, group, Dh, int(q.dtype == torch.bfloat16), int(causal),
            sliding_window, 1.0 / math.sqrt(Dh), _stream(q.device))
    _build.check(rc, "flash_attention_bwd_dq")
    flash_attention_bwd_dq.launches += 1
    return dq


def flash_attention_bwd_dkv(q, k, v, do, lse, delta, *, causal: bool = True,
                            group: int = 1, sliding_window: int = 0):
    """K5 on CUDA tensors: (dk, dv) [B,S,Hkv,Dh] in k.dtype, summed over
    the q rows and the GQA group; inputs as `flash_attention_bwd_dq`."""
    _check("flash_attention_bwd_dkv", q, k, v, (do,), causal=causal,
           group=group, sliding_window=sliding_window)
    _stats_ok("flash_attention_bwd_dkv", q, lse, delta)
    _aligned("flash_attention_bwd_dkv", q=q, k=k, v=v, do=do)
    B, T, Hq, Dh = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    lib = _build.load()
    with torch.cuda.device(q.device):
        rc = lib.flash_attention_bwd_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            B, T, S, Hq, Hkv, group, Dh, int(q.dtype == torch.bfloat16),
            int(causal), sliding_window, 1.0 / math.sqrt(Dh),
            _stream(q.device))
    _build.check(rc, "flash_attention_bwd_dkv")
    flash_attention_bwd_dkv.launches += 1
    return dk, dv


flash_attention.launches = 0
flash_attention_bwd_dq.launches = 0
flash_attention_bwd_dkv.launches = 0


def flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool = True,
                        group: int = 1, sliding_window: int = 0):
    """(dq, dk, dv). CPU tensors take the plain backward; CUDA tensors
    compute delta = rowsum(o * do) with one torch op (outside the kernels,
    as the Pallas `_bwd` does), then launch K4 and K5."""
    kw = dict(causal=causal, group=group, sliding_window=sliding_window)
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)
    delta = bwd_delta(o, do)
    dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, **kw)
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, **kw)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Attention with a flash backward: the forward is K2 and saves (q, k,
    v, o, lse); the backward is K4 + K5 (the plain versions on the CPU).
    The counterpart of the reference's `jax.custom_vjp` around `_fa`."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, group: int,
                sliding_window: int):
        o, lse = flash_attention(q, k, v, causal=causal, group=group,
                                 sliding_window=sliding_window)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.kw = dict(causal=causal, group=group,
                      sliding_window=sliding_window)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        # do arrives through the out-projection's reshape and may be a
        # strided view; the kernels take contiguous tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do.contiguous(),
                                         **ctx.kw)
        return dq, dk, dv, None, None, None
