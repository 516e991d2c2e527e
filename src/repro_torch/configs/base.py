"""Config schema: ModelConfig (architecture), ShapeConfig (one cell's batch
and sequence), the shape grid and the arch registry, copied from
`repro/configs/base.py`. One module per ported architecture lives next to
this file; each exports CONFIG (the published hyperparameters) and TINY (a
reduced same-family config for CPU tests)."""

from __future__ import annotations

import dataclasses
import importlib
import math

from repro_torch.models.common import HeadPlan, plan_head_padding

VOCAB_ALIGN = 2048  # pad vocab to a multiple (TP-16 x 128-lane friendly)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | hybrid | ssm | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0           # 0 -> d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 1e4
    norm_eps: float = 1e-5
    # MoE
    n_experts: int = 0
    experts_per_token: int = 0
    # SSM / hybrid
    ssm_state: int = 0
    attn_every: int = 0
    sliding_window: int = 0
    # encoder-decoder
    n_enc_layers: int = 0
    enc_seq_len: int = 1500
    # VLM stub frontend
    n_img_tokens: int = 0
    # numerics / distribution
    dtype: str = "bfloat16"
    tp: int = 16                # model-axis size the head plan targets
    remat_group: int = 0        # 0 -> auto (largest divisor of n_layers <= 8)

    @property
    def head_dim_(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def vocab_padded(self) -> int:
        return math.ceil(self.vocab_size / VOCAB_ALIGN) * VOCAB_ALIGN

    def head_plan(self) -> HeadPlan:
        return plan_head_padding(self.n_heads, self.n_kv_heads, self.tp)

    @property
    def remat_group_(self) -> int:
        """Layers a group of the two-level remat (`remat="group"`)."""
        if self.remat_group:
            return self.remat_group
        for g in (8, 7, 6, 5, 4, 3, 2, 1):
            if self.n_layers % g == 0:
                return g
        return 1


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                   # train | prefill | decode

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


# the shape grid: every LM arch x these four
SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}

# every architecture of the reference: the dense, moe, vlm, ssm, hybrid and
# encdec families
ARCH_IDS = ("granite_20b", "grok1_314b", "internvl2_2b", "minicpm_2b",
            "mistral_large_123b", "qwen2p5_14b", "qwen3_moe_30b_a3b",
            "rwkv6_7b", "whisper_base", "zamba2_1p2b")

# the order `cells` walks the architectures in (the reference's registry
# order; ARCH_IDS above is sorted)
CELL_ORDER = ("zamba2_1p2b", "minicpm_2b", "granite_20b",
              "mistral_large_123b", "qwen2p5_14b", "rwkv6_7b",
              "internvl2_2b", "whisper_base", "grok1_314b",
              "qwen3_moe_30b_a3b")

# long_500k runs only for the sub-quadratic archs; whisper has a decoder
# (enc-dec), so its decode shapes run, with 500k skipped (full attention)
LONG_CONTEXT_ARCHS = ("zamba2_1p2b", "rwkv6_7b")


def get_config(arch: str, tiny: bool = False) -> ModelConfig:
    if arch not in ARCH_IDS:
        raise ValueError(f"{arch!r} is not an architecture; have {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{arch}")
    return mod.TINY if tiny else mod.CONFIG


def cells(include_skips: bool = False):
    """The (arch x shape) grid. Yields (arch, shape_name, runnable)."""
    for arch in CELL_ORDER:
        for sname in SHAPES:
            runnable = not (sname == "long_500k"
                            and arch not in LONG_CONTEXT_ARCHS)
            if include_skips or runnable:
                yield arch, sname, runnable
