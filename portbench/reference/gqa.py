"""Plain fp32 reference of a dense decoder with grouped-query attention
(InternLM2): pre-norm blocks of rotary GQA attention and a SwiGLU MLP,
untied LM head.  Keys read: hidden_size, num_attention_heads,
num_key_value_heads, intermediate_size, num_hidden_layers, vocab_size,
rms_norm_eps, rope_theta."""

from __future__ import annotations

from reference import plain as P


def logits(conf: dict, params, seqs, starts, cast=None):
    """fp32 logits at positions ``starts[i]..`` of each token sequence
    ``seqs[i]`` (1-D int tensors), teacher-forced; ``cast`` rounds every
    weight (the control's lower precision)."""
    d = conf["hidden_size"]
    n, nkv = conf["num_attention_heads"], conf["num_key_value_heads"]
    hd, eps, theta = d // n, conf["rms_norm_eps"], conf["rope_theta"]
    nl = conf["num_hidden_layers"]
    stack = params["layers"]
    if stack["attn"]["wq"].shape != (nl, d, n, hd):
        raise ValueError(f"weights do not match the config: wq "
                         f"{tuple(stack['attn']['wq'].shape)}")
    with P.fp32_exact():
        embed = params["embed"]
        xs = [P.upcast(embed[s.long()], cast) for s in seqs]
        for li in range(nl):
            w = P.upcast(P.layer(stack, li), cast)
            xs = [_block(x, w, n, nkv, hd, eps, theta) for x in xs]
        return P.head_logits(xs, starts, P.upcast(params["final_norm"]["scale"], cast),
                             P.upcast(params["lm_head"], cast), eps)


def _block(x, w, n, nkv, hd, eps, theta):
    s, d = x.shape
    a = w["attn"]
    h = P.rms_norm(x, w["ln1"]["scale"], eps)
    q = P.rope((h @ a["wq"].reshape(d, n * hd)).view(s, n, hd), theta)
    k = P.rope((h @ a["wk"].reshape(d, nkv * hd)).view(s, nkv, hd), theta)
    v = (h @ a["wv"].reshape(d, nkv * hd)).view(s, nkv, hd)
    g = n // nkv
    o = P.causal_attention(q, k.repeat_interleave(g, 1),
                           v.repeat_interleave(g, 1), P.scale(hd))
    x = x + o.reshape(s, n * hd) @ a["wo"].reshape(n * hd, d)
    m = w["mlp"]
    h = P.rms_norm(x, w["ln2"]["scale"], eps)
    return x + P.swiglu(h, m["w_gate"], m["w_up"], m["w_down"])
