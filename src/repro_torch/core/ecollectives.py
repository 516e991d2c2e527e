"""Error-bounded collectives: the compression levels and their wire-byte
accounting that the power plane's step model reads (`power_plane.
step_terms`), copied from `repro/core/ecollectives.py`.

Compression levels (the "voltage knob" of the ICI rail):
    0  lossless     : bf16/f32 psum
    1  int8 + EF    : blockwise int8 quantized
    2  int8+topk+EF : additionally top-k sparsified

`zeros_like_residuals` makes the error-feedback residuals the train step
carries; the int8 codec itself (`quantize_int8`, error feedback, the
compressed psum) is not ported yet.
"""

from __future__ import annotations

import dataclasses

import torch

DEFAULT_BLOCK = 256
LEVEL_LOSSLESS, LEVEL_INT8, LEVEL_INT8_TOPK = 0, 1, 2


@dataclasses.dataclass(frozen=True)
class WireCost:
    bytes_per_element: float     # on-wire bytes per gradient element per device
    description: str


def wire_cost(level: int, k_fraction: float = 0.25,
              elem_bytes: int = 2, block: int = DEFAULT_BLOCK) -> WireCost:
    """Ring-collective wire bytes per gradient element (per device).

    Lossless ring all-reduce: 2 passes x elem_bytes. int8 all-gather +
    local reduce: 1 byte + scales overhead. top-k: fraction kept + scales."""
    scale_overhead = 4.0 / block
    if level == LEVEL_LOSSLESS:
        return WireCost(2.0 * elem_bytes, "ring all-reduce bf16")
    if level == LEVEL_INT8:
        return WireCost(1.0 + scale_overhead, "int8 all-gather + local reduce")
    if level == LEVEL_INT8_TOPK:
        return WireCost(k_fraction * 1.0 + scale_overhead + 0.25,
                        "top-k int8 (+index bitmap) all-gather + local reduce")
    raise ValueError(f"unknown level {level}")


def zeros_like_residuals(params):
    """f32 zeros shaped like every parameter leaf (nested dicts), on the
    leaves' devices."""
    if isinstance(params, dict):
        return {k: zeros_like_residuals(v) for k, v in params.items()}
    return torch.zeros(params.shape, dtype=torch.float32,
                       device=params.device)
