"""granite-34b [dense]: 88L d_model=6144 48H (GQA kv=1 = MQA) d_ff=24576
vocab=49152 — llama-arch, code  [arXiv:2405.04324; hf]"""

from repro_torch.configs.registry import ModelConfig

CONFIG = ModelConfig(
    name="granite-34b",
    family="dense",
    num_layers=88,
    d_model=6144,
    num_heads=48,
    num_kv_heads=1,  # MQA
    d_ff=24576,
    vocab_size=49152,
    mlp_type="gelu",  # GPTBigCode-style 2-matrix MLP (the 34B total requires
    # it: swiglu at d_ff=24576 would give ~47B params)
    rope_theta=1e4,
    notes="Granite code 34B; multi-query attention (single KV head).",
)
