"""llama3-405b [dense]: 126L d_model=16384 128H (GQA kv=8) d_ff=53248
vocab=128256 — GQA, 128k vocab  [arXiv:2407.21783]"""

from repro_torch.configs.registry import ModelConfig

CONFIG = ModelConfig(
    name="llama3-405b",
    family="dense",
    num_layers=126,
    d_model=16384,
    num_heads=128,
    num_kv_heads=8,
    d_ff=53248,
    vocab_size=128256,
    mlp_type="swiglu",
    rope_theta=5e5,
    notes="Llama-3.1 405B.",
)
