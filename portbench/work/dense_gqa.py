"""Needed FLOPs of a dense GQA decoder (InternLM2), from the published
configuration's keys: 2 x the parameters a token multiplies (attention
projections, the SwiGLU MLP; the embedding is a lookup, norms are not
products) and attention over each token's true context.  The LM head is
needed once per served token: at every decode token, and at a prompt's
last position only."""


def _dims(c):
    d, n, nkv = c["hidden_size"], c["num_attention_heads"], c["num_key_value_heads"]
    return d, n, nkv, d // n


def layer_params(c) -> int:
    d, n, nkv, hd = _dims(c)
    return d * hd * (n + 2 * nkv) + n * hd * d + 3 * d * c["intermediate_size"]


def body_params(c) -> int:
    """Parameters every token multiplies, the LM head left out."""
    return c["num_hidden_layers"] * layer_params(c)


def head_flops(c) -> int:
    return 2 * c["hidden_size"] * c["vocab_size"]


def attn_flops(c, ctx: int) -> int:
    """QK^T and PV of one query over ``ctx`` positions, every layer."""
    _, n, _, hd = _dims(c)
    return c["num_hidden_layers"] * 4 * n * hd * ctx


def decode_flops(c, length: int) -> int:
    """One decode token of a row that holds ``length`` tokens before it."""
    return 2 * body_params(c) + head_flops(c) + attn_flops(c, length + 1)


def prefill_flops(c, length: int) -> int:
    """A prompt of ``length`` tokens, causal, the head at its last token."""
    return (2 * body_params(c) * length + head_flops(c)
            + attn_flops(c, 1) * length * (length + 1) // 2)
