"""Blockwise symmetric int8 codec (K10): wrappers around the CUDA kernels
of `csrc/quant_codec.cu`, beside their plain PyTorch versions.

Replaces the TPU kernel `repro/kernels/quant_codec.py::quantize_int8`
(`_kernel`, `pl.pallas_call` at :45), which pads x to whole blocks and then
to 32-block grid steps and quantizes each step's rows in VMEM. Two entry
points share the kernel's block codec:

- `quantize_int8`, the codec alone (`ecollectives.quantize_int8`).
- `ef_sync_leaf`, one parameter leaf of the error-feedback gradient sync
  in one pass: r + g, the level-2 mask, the codec, the dequantize, the new
  residual (in place), the leaf's error terms, and the int8 reduce (the
  codec again and its dequantize). It replaces ~10 torch kernels and two
  codec launches a leaf on the ef train path (`train/step._ef_sync`).

Both are bound by bytes. A warp holds one quantization block in registers
between its absmax and its encode, reads it with 16-byte loads and stores
the codes packed; see the source's header note. IEEE division and round
half to even are pinned, and the fused pass rounds every product before it
adds, so codes, scales and floats equal the plain versions' bit for bit
(the fused pass's two sums up to their order). The kernels take 16-byte-
aligned tensors and raise on others.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises."""

from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref

DTYPES = (torch.float32, torch.bfloat16)
MAX_BLOCK = 1024       # 32 elements per lane in the kernel
EF_BLOCK = 256         # the fused pass's block (the train step's)


def _check(name: str, x) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda, got {x.device}")
    if x.dtype not in DTYPES:
        raise ValueError(f"{name} takes float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{name} takes a contiguous tensor")
    if x.numel() == 0:
        raise ValueError(f"{name} takes a non-empty tensor")
    if x.data_ptr() % 16:
        raise ValueError(f"{name} takes 16-byte-aligned tensors (its "
                         f"16-byte loads' rule)")


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def quantize_int8_plain(x, *, block: int = 256):
    """The plain PyTorch version: `ref.quantize_int8_reference`."""
    return ref.quantize_int8_reference(x, block=block)


def quantize_int8(x, *, block: int = 256):
    """x any shape, f32 or bf16 -> (q [nblocks, block] int8, scale
    [nblocks, 1] f32), the tail block zero-padded."""
    if x.device.type == "cpu":
        return quantize_int8_plain(x, block=block)
    _check("quantize_int8", x)
    if block % 32 or not 32 <= block <= MAX_BLOCK:
        raise ValueError(f"block must be a multiple of 32 up to "
                         f"{MAX_BLOCK}, got {block}")
    n = x.numel()
    nblocks = -(-n // block)
    q = torch.empty((nblocks, block), dtype=torch.int8, device=x.device)
    scale = torch.empty((nblocks, 1), dtype=torch.float32, device=x.device)
    lib = _build.load()
    with torch.cuda.device(x.device):
        rc = lib.quantize_int8_launch(x.data_ptr(), q.data_ptr(),
                                      scale.data_ptr(), n, block,
                                      int(x.dtype == torch.bfloat16),
                                      _stream(x.device))
    _build.check(rc, "quantize_int8")
    quantize_int8.launches += 1
    return q, scale


quantize_int8.launches = 0


def ef_sync_leaf_plain(g, r, thresholds=None):
    """The plain PyTorch version of `ef_sync_leaf`: the op sequence of
    `ecollectives.ef_compress_leaf_`, `error_sums` and `reduce_leaf(...,
    LEVEL_INT8)` in a world of one, with the codec's plain version."""
    n, shape, block = g.numel(), g.shape, EF_BLOCK
    corrected = r.add_(g)
    kept = corrected
    if thresholds is not None:          # topk_mask with these thresholds
        flat = corrected.reshape(-1)
        pad = (-n) % block
        if pad:
            flat = torch.cat([flat, flat.new_zeros(pad)])
        blocks = flat.reshape(-1, block)
        kept = torch.where(blocks.abs() >= thresholds, blocks, 0.0)
        kept = kept.reshape(-1)[:n].reshape(shape)
    q1, s1 = ref.quantize_int8_reference(kept, block)
    del kept
    g_hat = q1.to(torch.float32).mul_(s1).reshape(-1)[:n].reshape(shape)
    corrected.sub_(g_hat)
    num, den = ((g - g_hat) ** 2).sum(), (g ** 2).sum()
    q2, s2 = ref.quantize_int8_reference(g_hat, block)
    total = torch.sum(q2[None].to(torch.float32).mul_(s2[None]), dim=0)
    out = total.reshape(-1)[:n].reshape(shape)
    return out, q2, s2, num, den


def ef_sync_leaf(g, r, thresholds=None):
    """One leaf of the error-feedback int8 sync in a world of one. g (f32 or
    bf16) and r (f32, updated in place to the new residual) of one shape;
    thresholds [nblocks, 1] f32 for level 2 (each block's least kept |r +
    g|) or None for level 1. Returns (out: the reduced leaf, f32, g's
    shape; q [nblocks, block] int8 and scale [nblocks, 1] f32: the codes
    the all-gather moves; num = sum (g - g_hat)^2, f32; den = sum g^2, in
    g's dtype). Blocks of 256, the train step's (EF_BLOCK)."""
    if g.shape != r.shape or r.dtype != torch.float32:
        raise ValueError(f"ef_sync_leaf takes g and an f32 r of one shape, "
                         f"got {tuple(g.shape)} {g.dtype} and "
                         f"{tuple(r.shape)} {r.dtype}")
    if r.device != g.device:
        raise ValueError("ef_sync_leaf takes g and r on one device")
    if g.device.type == "cpu":
        return ef_sync_leaf_plain(g, r, thresholds)
    _check("ef_sync_leaf", g)
    _check("ef_sync_leaf", r)
    n = g.numel()
    nblocks = -(-n // EF_BLOCK)
    if thresholds is not None and (
            thresholds.device != g.device
            or thresholds.dtype != torch.float32
            or not thresholds.is_contiguous()
            or thresholds.numel() != nblocks):
        raise ValueError(f"ef_sync_leaf takes {nblocks} contiguous f32 "
                         f"thresholds on {g.device}")
    dev = g.device
    out = torch.empty(g.shape, dtype=torch.float32, device=dev)
    q = torch.empty((nblocks, EF_BLOCK), dtype=torch.int8, device=dev)
    scale = torch.empty((nblocks, 1), dtype=torch.float32, device=dev)
    lib = _build.load()
    grid = lib.ef_sync_leaf_grid(n)
    partial = torch.empty((grid, 2), dtype=torch.float64, device=dev)
    with torch.cuda.device(dev):
        rc = lib.ef_sync_leaf_launch(
            g.data_ptr(), r.data_ptr(),
            None if thresholds is None else thresholds.data_ptr(),
            out.data_ptr(), q.data_ptr(), scale.data_ptr(),
            partial.data_ptr(), n, int(g.dtype == torch.bfloat16),
            _stream(dev))
    _build.check(rc, "ef_sync_leaf")
    ef_sync_leaf.launches += 1
    sums = partial.sum(0).float()
    return out, q, scale, sums[0], sums[1].to(g.dtype)


ef_sync_leaf.launches = 0
