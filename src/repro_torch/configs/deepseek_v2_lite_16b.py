"""deepseek-v2-lite-16b [moe]: 27L d_model=2048 16H d_ff(moe)=1408
vocab=102400, MLA kv_lora=512, MoE 64 routed top-6 + 2 shared
[arXiv:2405.04434; hf]

The assignment line reads "MoE 64e top-6 ... 2 shared+160 routed top-6"; the
"160 routed" matches full DeepSeek-V2, not Lite — we follow the Lite spec
(64 routed) per the primary "MoE 64e top-6" designation (DESIGN.md §5).
First layer is dense (d_ff = 10944 in HF config; we use the dense d_ff for
that layer).
"""

from repro_torch.configs.registry import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    num_layers=27,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,  # MLA: kv heads = q heads after decompression
    d_ff=10944,  # dense-layer FFN width (layer 0)
    vocab_size=102400,
    head_dim=192,  # qk_nope (128) + qk_rope (64)
    attn_type="mla",
    kv_lora_rank=512,
    qk_rope_head_dim=64,
    qk_nope_head_dim=128,
    v_head_dim=128,
    num_experts=64,
    num_experts_per_tok=6,
    num_shared_experts=2,
    moe_d_ff=1408,
    first_dense_layers=1,
    mlp_type="swiglu",
    cache_family="mla",  # paged decode over shared-latent block pools
    notes="DeepSeek-V2-Lite: MLA attention + fine-grained MoE.",
)
