"""internlm2-1.8b [dense]: 24L d_model=2048 16H (GQA kv=8) d_ff=8192
vocab=92544  [arXiv:2403.17297; hf]"""

from repro_torch.configs.registry import ModelConfig

CONFIG = ModelConfig(
    name="internlm2-1.8b",
    family="dense",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=92544,
    mlp_type="swiglu",
    rope_theta=1e6,
    notes="InternLM2 1.8B, GQA.",
)
