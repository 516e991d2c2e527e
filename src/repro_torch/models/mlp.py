"""Feed-forward layers: SwiGLU (LLaMA family), ported from
`repro/models/mlp.py`. The MoE and GELU layers are not ported yet."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import common


def init_swiglu(gen: torch.Generator, d_model: int, d_ff: int,
                dtype=torch.float32):
    return {
        "w_gate": common.dense_init(gen, (d_model, d_ff), d_model, dtype),
        "w_in": common.dense_init(gen, (d_model, d_ff), d_model, dtype),
        "w_out": common.dense_init(gen, (d_ff, d_model), d_ff, dtype),
    }


def swiglu(params, x):
    g = x @ params["w_gate"]
    h = x @ params["w_in"]
    act = F.silu(g.float()).to(x.dtype) * h
    return act @ params["w_out"]
