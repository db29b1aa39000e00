"""Plain fp32 reference of a hybrid Mamba-2 + attention decoder with a
mixture of experts after every mixer (Granite 4.0-H, ``granitemoehybrid``),
as the published configuration states it.

Layer i is a Mamba-2 mixer or causal GQA attention, as ``layer_types``
says, then a MoE block; with r = ``residual_multiplier``:

    x = x + r * mixer(rms_norm(x))
    x = x + r * (routed(rms_norm(x)) + shared(rms_norm(x)))

The embedding is multiplied by ``embedding_multiplier`` and the logits
divided by ``logits_scaling``; the LM head is the embedding when
``tie_word_embeddings``.

Mamba-2 (``mamba_n_heads`` heads of ``mamba_d_head``, state
``mamba_d_state``, one group, no projection bias): one input projection
to (z, xBC, dt); a causal depthwise convolution of width ``mamba_d_conv``
with bias, then SiLU; x, B, C split from it; dt = softplus(dt + dt_bias),
A = -exp(A_log); the scan written out in its masked quadratic form, y_t =
sum over s <= t of (C_t . B_s) exp(dt_{s+1} A + ... + dt_t A) dt_s x_s,
plus the skip D x_t; the RMS norm of y * SiLU(z) over the whole inner
width (one group) times its scale; the output projection.

Attention: ``num_attention_heads`` query heads and ``num_key_value_heads``
KV heads of hidden_size / num_attention_heads, no rotary positions
(``position_embedding_type`` "nope"), softmax scale
``attention_multiplier``, no bias.

MoE: the router's logits (fp32), the top ``num_experts_per_tok`` of them,
a softmax over those; ``num_local_experts`` SwiGLU experts of
``intermediate_size``; one shared SwiGLU of ``shared_intermediate_size``.

Keys read: hidden_size, num_hidden_layers, layer_types, vocab_size,
rms_norm_eps, embedding_multiplier, residual_multiplier, logits_scaling,
attention_multiplier, num_attention_heads, num_key_value_heads,
position_embedding_type, attention_bias, mamba_n_heads, mamba_d_head,
mamba_d_state, mamba_n_groups, mamba_d_conv, mamba_conv_bias,
mamba_proj_bias, num_local_experts, num_experts_per_tok,
intermediate_size, shared_intermediate_size, tie_word_embeddings."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from reference import plain as P


def _refuse(conf: dict) -> None:
    """What this reference does not compute, refused by name."""
    if conf["position_embedding_type"] != "nope":
        raise NotImplementedError(
            f"position_embedding_type {conf['position_embedding_type']!r}: "
            f"this reference computes attention without positions only")
    if conf["mamba_n_groups"] != 1:
        raise NotImplementedError("Mamba-2 with more than one group")
    if (conf["attention_bias"] or conf["mamba_proj_bias"]
            or not conf["mamba_conv_bias"]):
        raise NotImplementedError("attention or projection biases, or a "
                                  "convolution without its bias")


def logits(conf: dict, params, seqs, starts, cast=None):
    """fp32 logits at positions ``starts[i]..`` of each token sequence
    ``seqs[i]`` (1-D int tensors), teacher-forced; ``cast`` rounds every
    weight (the control's lower precision)."""
    _refuse(conf)
    types = conf["layer_types"]
    if len(types) != conf["num_hidden_layers"]:
        raise ValueError("layer_types does not give every layer a kind")
    stacks = params["layers"]
    for kind in set(types):
        if stacks[kind]["ln1"]["scale"].shape[0] != types.count(kind):
            raise ValueError(f"weights do not match the config's {kind} "
                             f"layers")
    eps, r = conf["rms_norm_eps"], conf["residual_multiplier"]
    with P.fp32_exact():
        embed = params["embed"]
        xs = [P.upcast(embed[s.long()], cast) * conf["embedding_multiplier"]
              for s in seqs]
        seen = dict.fromkeys(stacks, 0)
        for kind in types:
            w = P.upcast(P.layer(stacks[kind], seen[kind]), cast)
            seen[kind] += 1
            mixer = _mamba if kind == "mamba" else _attention
            xs = [x + r * mixer(P.rms_norm(x, w["ln1"]["scale"], eps), w,
                                conf) for x in xs]
            hs = [P.rms_norm(x, w["ln2"]["scale"], eps) for x in xs]
            # tokens are independent in the MoE block: route them at once
            y = _moe(torch.cat(hs), w["moe"], conf)
            xs = [x + r * part for x, part in
                  zip(xs, torch.split(y, [h.shape[0] for h in hs]))]
        head = (P.upcast(embed, cast).T if conf["tie_word_embeddings"]
                else P.upcast(params["lm_head"], cast))
        out = P.head_logits(xs, starts,
                            P.upcast(params["final_norm"]["scale"], cast),
                            head, eps)
        return [o / conf["logits_scaling"] for o in out]


def _segsum(a):
    """a (H, S) -> (H, S, S): sum of a[:, s+1..t] at [:, t, s] for s <= t,
    -inf above the diagonal; summed along each row, not as a difference
    of running sums."""
    h, s = a.shape
    rows = a[:, :, None].expand(h, s, s)
    below = torch.ones(s, s, dtype=torch.bool, device=a.device).tril(-1)
    seg = torch.cumsum(rows.masked_fill(~below, 0.0), dim=1)
    on = torch.ones(s, s, dtype=torch.bool, device=a.device).tril(0)
    return seg.masked_fill(~on, float("-inf"))


def _mamba(h, w, conf):
    m = w["mamba"]
    s = h.shape[0]
    nh, hp = conf["mamba_n_heads"], conf["mamba_d_head"]
    n, width = conf["mamba_d_state"], conf["mamba_d_conv"]
    d_in = nh * hp
    z, xbc, dt = torch.split(h @ m["in_proj"], [d_in, d_in + 2 * n, nh], -1)
    # causal depthwise convolution with bias: weight (width, C) -> (C, 1, width)
    conv = F.conv1d(F.pad(xbc.T[None], (width - 1, 0)), m["conv_w"].T[:, None],
                    m["conv_b"], groups=xbc.shape[1])[0].T
    x, b, c = torch.split(F.silu(conv), [d_in, n, n], -1)
    x = x.view(s, nh, hp)
    dt = F.softplus(dt + m["dt_bias"])  # (S, H)
    a = -torch.exp(m["A_log"])  # (H,)
    decay = torch.exp(_segsum((dt * a).T))  # (H, t, s)
    mix = decay * (c @ b.T)[None] * dt.T[:, None, :]
    y = torch.einsum("hts,shp->thp", mix, x) + x * m["ssm_D"][None, :, None]
    y = P.rms_norm(y.reshape(s, d_in) * F.silu(z), m["gate_norm"],
                   conf["rms_norm_eps"])
    return y @ m["out_proj"]


def _attention(h, w, conf):
    s, d = h.shape
    a = w["attn"]
    n, nkv = conf["num_attention_heads"], conf["num_key_value_heads"]
    hd = d // n
    q = (h @ a["wq"].reshape(d, n * hd)).view(s, n, hd)
    k = (h @ a["wk"].reshape(d, nkv * hd)).view(s, nkv, hd)
    v = (h @ a["wv"].reshape(d, nkv * hd)).view(s, nkv, hd)
    g = n // nkv
    o = P.causal_attention(q, k.repeat_interleave(g, 1),
                           v.repeat_interleave(g, 1),
                           conf["attention_multiplier"])
    return o.reshape(s, n * hd) @ a["wo"].reshape(n * hd, d)


def _moe(h, m, conf):
    top, idx = torch.topk(h @ m["router"], conf["num_experts_per_tok"], -1)
    gates = torch.softmax(top, dim=-1)
    ex = m["experts"]
    out = torch.zeros_like(h)
    for e in torch.unique(idx).tolist():
        tok, slot = (idx == e).nonzero(as_tuple=True)
        y = P.swiglu(h[tok], ex["w_gate"][e], ex["w_up"][e], ex["w_down"][e])
        out.index_add_(0, tok, y * gates[tok, slot, None])
    sh = m["shared"]
    return out + P.swiglu(h, sh["w_gate"], sh["w_up"], sh["w_down"])
