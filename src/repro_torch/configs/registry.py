"""Model configuration schema + registry for the 10 assigned architectures.

Every architecture is a selectable config (``--arch <id>`` in the launchers).
``reduced()`` yields the CPU-smoke-test variant of the same family (small
depth/width/experts/vocab); the FULL configs are exercised only through the
dry-run (ShapeDtypeStruct, no allocation).
"""

from __future__ import annotations

import dataclasses
import importlib
from dataclasses import dataclass, field

__all__ = ["ModelConfig", "ShapeSpec", "get_config", "list_configs", "SHAPES", "shapes_for"]


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads

    # attention
    attn_type: str = "gqa"  # gqa | mla | none
    rope_theta: float = 1e4
    mrope: bool = False  # qwen2-vl multimodal rotary
    mrope_sections: tuple[int, int, int] = (16, 24, 24)

    # MLA (deepseek)
    kv_lora_rank: int = 0
    qk_rope_head_dim: int = 0
    qk_nope_head_dim: int = 0
    v_head_dim: int = 0

    # MoE
    num_experts: int = 0
    num_experts_per_tok: int = 0
    num_shared_experts: int = 0
    moe_d_ff: int = 0
    first_dense_layers: int = 0
    capacity_factor: float = 1.25

    # SSM (mamba2)
    ssm_state_dim: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_ngroups: int = 1
    conv_width: int = 4

    # hybrid (zamba2): one shared attention block applied every `attn_every`
    # layers (weights shared across applications)
    attn_every: int = 0

    # encoder-decoder (whisper)
    encoder_layers: int = 0
    encoder_seq: int = 1500  # whisper-medium: 30s audio -> 1500 frames

    # frontend stub: model consumes precomputed embeddings, not raw tokens
    embed_inputs: bool = False

    # paged-serving cache family (serving.kvcache.FAMILIES key): which pooled
    # cache layout this arch decodes under ("gqa" | "mla" | "ssm" | "hybrid" |
    # "encdec").  "" -> derived (only plain GQA stacks derive one implicitly;
    # everything else must declare or it gets NO paged path — never a silent
    # dense fallback).
    cache_family: str = ""

    mlp_type: str = "swiglu"  # swiglu | gelu
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: str = "bfloat16"

    # True if the sequence-mixing backbone is sub-quadratic (SSM/hybrid):
    # eligibility for the long_500k shape
    subquadratic: bool = False

    notes: str = ""

    def __post_init__(self):
        if self.head_dim == 0 and self.num_heads > 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    # -- derived -----------------------------------------------------------
    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def d_inner(self) -> int:
        """SSM inner width."""
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def param_count(self) -> int:
        """Analytical parameter count (used for roofline MODEL_FLOPS)."""
        from repro_torch.models.model import param_count

        return param_count(self)

    def active_param_count(self) -> int:
        from repro_torch.models.model import param_count

        return param_count(self, active_only=True)

    def reduced(self) -> "ModelConfig":
        """Tiny same-family config for CPU smoke tests."""
        r = dict(
            name=self.name + "-reduced",
            num_layers=min(self.num_layers, 2 + (2 if self.attn_every else 0)),
            d_model=64,
            num_heads=4,
            num_kv_heads=min(self.num_kv_heads, 2) if self.num_kv_heads else 0,
            head_dim=16,
            d_ff=128,
            vocab_size=128,
        )
        if self.attn_every:
            r["attn_every"] = 2
            r["num_layers"] = 5  # 2 groups of (1 mamba + 1 attn) + 1 extra
        if self.is_moe:
            r.update(num_experts=4, num_experts_per_tok=2, moe_d_ff=32,
                     num_shared_experts=min(self.num_shared_experts, 1),
                     first_dense_layers=min(self.first_dense_layers, 1))
        if self.attn_type == "mla":
            r.update(kv_lora_rank=32, qk_rope_head_dim=8, qk_nope_head_dim=16,
                     v_head_dim=16)
        if self.ssm_state_dim:
            r.update(ssm_state_dim=16, ssm_head_dim=16)
        if self.encoder_layers:
            r.update(encoder_layers=2, encoder_seq=16)
        return dataclasses.replace(self, **r)


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}

ARCH_IDS = [
    "granite_34b",
    "internlm2_1_8b",
    "llama3_405b",
    "internlm2_20b",
    "zamba2_7b",
    "deepseek_v2_lite_16b",
    "qwen3_moe_235b_a22b",
    "qwen2_vl_2b",
    "whisper_medium",
    "mamba2_780m",
]


def shapes_for(cfg: ModelConfig) -> list[ShapeSpec]:
    """The assigned shape cells for this arch.  long_500k only for
    sub-quadratic backbones (skip noted in DESIGN.md §5)."""
    out = [SHAPES["train_4k"], SHAPES["prefill_32k"], SHAPES["decode_32k"]]
    if cfg.subquadratic:
        out.append(SHAPES["long_500k"])
    return out


def get_config(arch_id: str) -> ModelConfig:
    arch_id = arch_id.replace("-", "_")
    if arch_id not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch_id!r}; available: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{arch_id}")
    return mod.CONFIG


def list_configs() -> list[str]:
    return list(ARCH_IDS)
