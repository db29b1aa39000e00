"""internlm2-20b [dense]: 48L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=92544  [arXiv:2403.17297; hf]"""

from repro_torch.configs.registry import ModelConfig

CONFIG = ModelConfig(
    name="internlm2-20b",
    family="dense",
    num_layers=48,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=16384,
    vocab_size=92544,
    mlp_type="swiglu",
    rope_theta=1e6,
    notes="InternLM2 20B, GQA.",
)
