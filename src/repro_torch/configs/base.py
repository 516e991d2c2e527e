"""Config schema: ModelConfig (architecture), ShapeConfig (one cell's batch
and sequence), the shape grid and the arch registry, copied from
`repro/configs/base.py`. One module per ported architecture lives next to
this file; each exports CONFIG (the published hyperparameters) and TINY (a
reduced same-family config for CPU tests). `param_count` and
`active_param_count` are the reference's approximate counts for the 6ND
arithmetic of the dry run and the roofline."""

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

    @property
    def has_attention(self) -> bool:
        return self.family not in ("ssm",)

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks), for 6ND math."""
        D, F, V = self.d_model, self.d_ff, self.vocab_size
        plan = None
        n = V * D * 2  # embed + lm_head (untied)
        for _ in range(self.n_layers):
            if self.family in ("dense", "moe", "vlm", "encdec"):
                if plan is None:
                    plan = self.head_plan()
                Dh = self.head_dim_
                n += D * (plan.n_q_pad + 2 * plan.n_kv_pad) * Dh + plan.n_q_pad * Dh * D
                if self.family == "moe" and self.n_experts:
                    n += self.n_experts * 3 * D * F + D * self.n_experts
                else:
                    n += 3 * D * F
            elif self.family == "hybrid":
                d_in = 2 * D
                n += D * (2 * d_in + 2 * self.ssm_state + d_in // 64) + d_in * D
            elif self.family == "ssm":
                n += 5 * D * D + 2 * D * F
        if self.family == "encdec":
            for _ in range(self.n_enc_layers):
                Dh = self.head_dim_
                n += 4 * D * self.n_heads * Dh + 2 * D * F
                n += 4 * D * self.n_kv_heads * Dh  # cross-attn kv
        return n

    def active_param_count(self) -> int:
        """MoE: parameters touched per token (for 6*N_active*D FLOPs math)."""
        if self.family != "moe" or not self.n_experts:
            return self.param_count()
        D, F = self.d_model, self.d_ff
        total = self.param_count()
        moe_all = self.n_layers * self.n_experts * 3 * D * F
        moe_active = self.n_layers * self.experts_per_token * 3 * D * F
        return total - moe_all + moe_active


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
