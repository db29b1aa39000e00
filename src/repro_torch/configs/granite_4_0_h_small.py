"""granite-4.0-h-small [hybrid_moe]: 40L d_model=4096, 36 Mamba-2 mixers
(128 heads of 64, state 128, 1 group, conv 4) and 4 NoPE GQA layers (32
query heads, 8 KV heads of 128) at 5, 15, 25, 35; after every mixer 72
routed experts of 768 top 10 plus one shared SwiGLU of 1536; muP
multipliers; vocab=100352, tied embeddings
[huggingface.co/ibm-granite/granite-4.0-h-small config.json]

A port-only config: the registry (a pinned copy of the JAX package's)
cannot list it, and ``ModelConfig`` has no field for a per-layer type list
or the multipliers, so :class:`HybridMoEConfig` adds them.  Each layer is
``x + r * mixer(norm(x))`` then ``x + r * (moe(norm(x)) + shared(norm(x)))``
with ``r`` the residual multiplier; the embedding is scaled by
``embedding_multiplier`` and the logits divided by ``logits_scaling``.
``rope_theta`` 0 is the published ``position_embedding_type`` "nope": no
rotary positions in the attention layers.
"""

import dataclasses
from dataclasses import dataclass

from repro_torch.configs.registry import ModelConfig

LAYER_KINDS = ("mamba", "attention")


@dataclass(frozen=True)
class HybridMoEConfig(ModelConfig):
    """A stack of Mamba-2 and GQA mixers in the order ``layer_types``, each
    followed by a MoE block of routed experts and one shared expert of
    ``shared_d_ff``."""

    layer_types: tuple[str, ...] = ()
    embedding_multiplier: float = 1.0
    residual_multiplier: float = 1.0
    logits_scaling: float = 1.0
    # the softmax scale of the attention layers (0: 1/sqrt(head_dim))
    attention_multiplier: float = 0.0
    shared_d_ff: int = 0

    def __post_init__(self):
        super().__post_init__()
        object.__setattr__(self, "layer_types", tuple(self.layer_types))
        if len(self.layer_types) != self.num_layers:
            raise ValueError(f"{self.name}: {len(self.layer_types)} layer "
                             f"types for {self.num_layers} layers")
        bad = set(self.layer_types) - set(LAYER_KINDS)
        if bad:
            raise ValueError(f"{self.name}: layer types {sorted(bad)} are "
                             f"none of {LAYER_KINDS}")

    def reduced(self) -> "HybridMoEConfig":
        """Tiny config of the family for CPU tests: one period with both
        kinds, 8 experts top 3, a shared width of its own and the
        published multipliers."""
        return dataclasses.replace(
            self, name=self.name + "-reduced", num_layers=4,
            layer_types=("mamba", "mamba", "attention", "mamba"),
            d_model=64, num_heads=4, num_kv_heads=2, head_dim=16, d_ff=32,
            vocab_size=128, num_experts=8, num_experts_per_tok=3,
            moe_d_ff=32, shared_d_ff=48, ssm_state_dim=16, ssm_head_dim=16)


CONFIG = HybridMoEConfig(
    name="granite-4.0-h-small",
    family="hybrid_moe",
    num_layers=40,
    layer_types=("mamba",) * 5 + ("attention",) + ("mamba",) * 9
    + ("attention",) + ("mamba",) * 9 + ("attention",) + ("mamba",) * 9
    + ("attention",) + ("mamba",) * 4,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=768,  # intermediate_size: the width of one routed expert
    vocab_size=100352,
    rope_theta=0.0,  # position_embedding_type "nope"
    num_experts=72,
    num_experts_per_tok=10,
    num_shared_experts=1,
    moe_d_ff=768,
    shared_d_ff=1536,
    ssm_state_dim=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_ngroups=1,
    conv_width=4,
    embedding_multiplier=12.0,
    residual_multiplier=0.22,
    logits_scaling=16.0,
    attention_multiplier=0.0078125,
    norm_eps=1e-5,
    tie_embeddings=True,
    subquadratic=True,
    cache_family="hybrid",  # paged decode: attn block pools + mamba slabs
    notes="Granite 4.0-H Small (32B-A9B): Mamba-2 + NoPE GQA + MoE, muP.",
)
