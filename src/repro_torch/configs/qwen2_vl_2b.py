"""qwen2-vl-2b [vlm]: 28L d_model=1536 12H (GQA kv=2) d_ff=8960 vocab=151936
— M-RoPE, dynamic resolution  [arXiv:2409.12191; hf]

Backbone only: the vision patch-embed frontend is a STUB — ``input_specs()``
provides precomputed, merged token embeddings (B, S, d_model) plus the
3-stream M-RoPE position ids (3, B, S) for (temporal, height, width).
"""

from repro_torch.configs.registry import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b",
    family="vlm",
    num_layers=28,
    d_model=1536,
    num_heads=12,
    num_kv_heads=2,
    d_ff=8960,
    vocab_size=151936,
    mrope=True,
    mrope_sections=(16, 24, 24),  # t/h/w splits of the 128-dim rotary space
    embed_inputs=True,
    mlp_type="swiglu",
    rope_theta=1e6,
    tie_embeddings=True,
    notes="Qwen2-VL 2B backbone; vision frontend stubbed via input_specs().",
)
