"""Blockwise symmetric int8 codec (K10): wrapper around the CUDA kernel
`csrc/quant_codec.cu`, beside its plain PyTorch version.

Replaces the TPU kernel `repro/kernels/quant_codec.py::quantize_int8`
(`_kernel`, `pl.pallas_call` at :45), which pads x to whole blocks and then
to 32-block grid steps and quantizes each step's rows in VMEM. It is the
hot loop of the error-feedback gradient sync (`core/ecollectives.py`): two
calls per parameter leaf per train step.

What bounds it on this card: bytes (4 B read, 1 + 4/block B written per f32
element). One warp per quantization block, lanes on neighbouring elements,
the block held in registers between the absmax and the encode; the tail is
read with a bounds check, so no padded copy of the input is made. IEEE
division and round half to even are pinned in the source, so codes and
scales equal the plain version's bit for bit; see the source's header note.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises."""

from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref

DTYPES = (torch.float32, torch.bfloat16)
MAX_BLOCK = 1024       # 32 elements per lane in the kernel


def quantize_int8_plain(x, *, block: int = 256):
    """The plain PyTorch version: `ref.quantize_int8_reference`."""
    return ref.quantize_int8_reference(x, block=block)


def quantize_int8(x, *, block: int = 256):
    """x any shape, f32 or bf16 -> (q [nblocks, block] int8, scale
    [nblocks, 1] f32), the tail block zero-padded."""
    if x.device.type == "cpu":
        return quantize_int8_plain(x, block=block)
    if x.device.type != "cuda":
        raise ValueError(f"quantize_int8 runs on cpu or cuda, got "
                         f"{x.device}")
    if x.dtype not in DTYPES:
        raise ValueError(f"quantize_int8 takes float32 or bfloat16, got "
                         f"{x.dtype}")
    if not x.is_contiguous():
        raise ValueError("quantize_int8 takes a contiguous tensor")
    if block % 32 or not 32 <= block <= MAX_BLOCK:
        raise ValueError(f"block must be a multiple of 32 up to "
                         f"{MAX_BLOCK}, got {block}")
    n = x.numel()
    if n == 0:
        raise ValueError("quantize_int8 takes a non-empty tensor")
    nblocks = -(-n // block)
    q = torch.empty((nblocks, block), dtype=torch.int8, device=x.device)
    scale = torch.empty((nblocks, 1), dtype=torch.float32, device=x.device)
    lib = _build.load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.quantize_int8_launch(x.data_ptr(), q.data_ptr(),
                                      scale.data_ptr(), n, block,
                                      int(x.dtype == torch.bfloat16), stream)
    _build.check(rc, "quantize_int8")
    quantize_int8.launches += 1
    return q, scale


quantize_int8.launches = 0
