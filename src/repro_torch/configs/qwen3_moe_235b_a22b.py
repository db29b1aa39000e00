"""qwen3-moe-235b-a22b [moe]: 94L d_model=4096 64H (GQA kv=4) moe_d_ff=1536
vocab=151936, MoE 128 experts top-8  [hf:Qwen/Qwen3-30B-A3B family]"""

from repro_torch.configs.registry import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    num_layers=94,
    d_model=4096,
    num_heads=64,
    num_kv_heads=4,
    head_dim=128,
    d_ff=1536,  # no dense layers; all layers MoE
    vocab_size=151936,
    num_experts=128,
    num_experts_per_tok=8,
    num_shared_experts=0,
    moe_d_ff=1536,
    first_dense_layers=0,
    mlp_type="swiglu",
    rope_theta=1e6,
    notes="Qwen3-MoE 235B-A22B: 128 experts, top-8, no shared expert.",
)
