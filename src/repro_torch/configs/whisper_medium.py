"""whisper-medium [audio]: 24L(+24L enc) d_model=1024 16H d_ff=4096
vocab=51865 — enc-dec, conv frontend stubbed  [arXiv:2212.04356]

Backbone only: the log-mel + conv1d frontend is a STUB — ``input_specs()``
provides precomputed frame embeddings (B, 1500, d_model) for the encoder.
The decoder is a standard causal transformer with cross-attention.
"""

from repro_torch.configs.registry import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium",
    family="encdec",
    num_layers=24,  # decoder layers
    encoder_layers=24,
    encoder_seq=1500,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=4096,
    vocab_size=51865,
    mlp_type="gelu",
    tie_embeddings=True,  # whisper ties the decoder embedding and unembedding
    rope_theta=0.0,  # whisper uses learned/sinusoidal absolute positions
    embed_inputs=False,  # decoder consumes tokens; encoder consumes embeddings
    cache_family="encdec",  # paged self-KV + refcounted shared cross segments
    notes="Whisper-medium backbone; conv frontend stubbed via input_specs().",
)
