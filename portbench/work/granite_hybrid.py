"""Needed FLOPs of a hybrid Mamba-2 + attention decoder with a MoE block
after every mixer (Granite 4.0-H), from the published configuration's
keys: 2 x the parameters a token multiplies -- each Mamba-2 layer's input
and output projections, each attention layer's projections, in every
layer the router, the ``num_experts_per_tok`` routed experts and the
shared expert (never all ``num_local_experts``) -- plus each Mamba-2
layer's depthwise convolution and its recurrent state step (the state
decayed, the input added and the output read: 5 x heads x head width x
state width), and attention over each token's true context in the
attention layers only.  The LM head is needed once per served token."""


def _counts(c) -> tuple[int, int]:
    types = c["layer_types"]
    return types.count("mamba"), types.count("attention")


def _mamba_params(c) -> int:
    d, h = c["hidden_size"], c["mamba_n_heads"]
    d_in = h * c["mamba_d_head"]
    cdim = d_in + 2 * c["mamba_n_groups"] * c["mamba_d_state"]
    return d * (d_in + cdim + h) + d_in * d


def _attn_params(c) -> int:
    d, n, nkv = c["hidden_size"], c["num_attention_heads"], c["num_key_value_heads"]
    hd = d // n
    return d * hd * (n + 2 * nkv) + n * hd * d


def _moe_params(c) -> int:
    d = c["hidden_size"]
    return (3 * d * (c["num_experts_per_tok"] * c["intermediate_size"]
                     + c["shared_intermediate_size"])
            + d * c["num_local_experts"])


def body_flops(c) -> int:
    """A token's FLOPs in every layer but attention's context, the LM head
    left out."""
    nm, na = _counts(c)
    d_in = c["mamba_n_heads"] * c["mamba_d_head"]
    cdim = d_in + 2 * c["mamba_n_groups"] * c["mamba_d_state"]
    state = 5 * c["mamba_n_heads"] * c["mamba_d_head"] * c["mamba_d_state"]
    per_mamba = 2 * _mamba_params(c) + 2 * cdim * c["mamba_d_conv"] + state
    return (nm * per_mamba + na * 2 * _attn_params(c)
            + (nm + na) * 2 * _moe_params(c))


def head_flops(c) -> int:
    return 2 * c["hidden_size"] * c["vocab_size"]


def attn_flops(c, ctx: int) -> int:
    """QK^T and PV of one query over ``ctx`` positions, every attention
    layer."""
    return _counts(c)[1] * 4 * c["hidden_size"] * ctx


def decode_flops(c, length: int) -> int:
    """One decode token of a row that holds ``length`` tokens before it."""
    return body_flops(c) + head_flops(c) + attn_flops(c, length + 1)


def prefill_flops(c, length: int) -> int:
    """A prompt of ``length`` tokens, causal, the head at its last token."""
    return (body_flops(c) * length + head_flops(c)
            + attn_flops(c, 1) * length * (length + 1) // 2)
