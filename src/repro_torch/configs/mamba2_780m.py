"""mamba2-780m [ssm]: 48L d_model=1536 (attention-free) vocab=50280,
ssm_state=128 — SSD (state-space duality)  [arXiv:2405.21060]"""

from repro_torch.configs.registry import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-780m",
    family="ssm",
    num_layers=48,
    d_model=1536,
    num_heads=0,
    num_kv_heads=0,
    head_dim=0,
    attn_type="none",
    d_ff=0,  # no separate MLP: Mamba2 blocks only
    vocab_size=50280,
    ssm_state_dim=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_ngroups=1,
    conv_width=4,
    tie_embeddings=True,
    subquadratic=True,
    cache_family="ssm",  # paged decode over fixed-size state-slab pools
    notes="Mamba2-780m: pure SSD blocks, d_inner=3072, 48 heads of 64.",
)
