"""zamba2-7b [hybrid]: 81L d_model=3584 32H (GQA kv=32) d_ff=14336
vocab=32000, ssm_state=64 — Mamba2 backbone + shared attention blocks
[arXiv:2411.15242]

Structure here: a shared (single-weight) attention+MLP block is applied
every 6th layer; the rest are Mamba2 blocks.  (Real Zamba2 adds per-use LoRA
deltas on the shared block; omitted — noted in DESIGN.md.)
"""

from repro_torch.configs.registry import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    num_layers=81,
    d_model=3584,
    num_heads=32,
    num_kv_heads=32,
    d_ff=14336,
    vocab_size=32000,
    ssm_state_dim=64,
    ssm_head_dim=64,
    ssm_expand=2,
    conv_width=4,
    attn_every=6,
    mlp_type="swiglu",
    subquadratic=True,  # Mamba2 backbone; attention is sparse-in-depth
    cache_family="hybrid",  # paged decode: attn block pools + mamba slabs
    notes="Zamba2-7B hybrid: Mamba2 layers + shared attn block every 6 layers.",
)
