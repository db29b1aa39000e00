"""Needed FLOPs of an MLA + MoE decoder (DeepSeek-V2-Lite), from the
published configuration's keys: 2 x the parameters a token multiplies --
MLA's projections (w_uk and w_uv once per token, as the absorbed decode
and the prefill's decompression each apply them), the dense layers'
MLP, in an expert layer the router, the ``num_experts_per_tok`` routed
experts and the shared experts (never all ``n_routed_experts``) -- and
attention over each token's true context: in decode the absorbed form
over the latent and the rotary key, in prefill the decompressed heads.
The LM head is needed once per served token."""


def _mla_params(c) -> int:
    d, n, r = c["hidden_size"], c["num_attention_heads"], c["kv_lora_rank"]
    pr, pn, hv = c["qk_rope_head_dim"], c["qk_nope_head_dim"], c["v_head_dim"]
    return d * n * (pn + pr) + d * (r + pr) + r * n * pn + r * n * hv + n * hv * d


def body_params(c) -> int:
    d, dense = c["hidden_size"], c["first_k_dense_replace"]
    expert = 3 * d * c["moe_intermediate_size"]
    moe = ((c["num_experts_per_tok"] + c["n_shared_experts"]) * expert
           + d * c["n_routed_experts"])
    return (c["num_hidden_layers"] * _mla_params(c)
            + dense * 3 * d * c["intermediate_size"]
            + (c["num_hidden_layers"] - dense) * moe)


def head_flops(c) -> int:
    return 2 * c["hidden_size"] * c["vocab_size"]


def decode_attn_flops(c, ctx: int) -> int:
    n, r, pr = c["num_attention_heads"], c["kv_lora_rank"], c["qk_rope_head_dim"]
    return c["num_hidden_layers"] * 2 * n * ctx * (2 * r + pr)


def prefill_attn_flops(c, ctx: int) -> int:
    n = c["num_attention_heads"]
    qk = c["qk_rope_head_dim"] + c["qk_nope_head_dim"]
    return c["num_hidden_layers"] * 2 * n * ctx * (qk + c["v_head_dim"])


def decode_flops(c, length: int) -> int:
    return 2 * body_params(c) + head_flops(c) + decode_attn_flops(c, length + 1)


def prefill_flops(c, length: int) -> int:
    return (2 * body_params(c) * length + head_flops(c)
            + prefill_attn_flops(c, 1) * length * (length + 1) // 2)
