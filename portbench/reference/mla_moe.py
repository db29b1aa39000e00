"""Plain fp32 reference of a decoder with multi-head latent attention and
a mixture of experts (DeepSeek-V2-Lite), as the served configuration
states it: MLA with no query compression (q_lora_rank null), the KV
latent of ``kv_lora_rank`` plus one shared rotary key of
``qk_rope_head_dim``, plain rotary positions (``rope_scaling`` null, or
YaRN at factor 1, which leaves the frequencies and the softmax scale as
they are), softmax scale 1/sqrt(qk_nope + qk_rope), no norm
on the latent; the first ``first_k_dense_replace`` layers dense (SwiGLU of
``intermediate_size``), the rest ``n_routed_experts`` routed experts of
``moe_intermediate_size`` with softmax top-``num_experts_per_tok`` routing
(renormalised over the chosen experts when ``norm_topk_prob``) plus
``n_shared_experts`` shared experts as one SwiGLU of their summed width."""

from __future__ import annotations

import torch

from reference import plain as P


def logits(conf: dict, params, seqs, starts, cast=None):
    """fp32 logits at positions ``starts[i]..`` of each sequence, as
    ``reference.gqa.logits``."""
    if not _plain_rope(conf["rope_scaling"]) or conf["kv_a_layernorm"]:
        raise NotImplementedError("YaRN rotary scaling above factor 1 and "
                                  "the KV latent's norm are not in this "
                                  "reference")
    eps = conf["rms_norm_eps"]
    n_dense = conf["first_k_dense_replace"]
    nl = conf["num_hidden_layers"]
    first, stack = params["first_layers"], params["layers"]
    if len(first) != n_dense or stack["ln1"]["scale"].shape[0] != nl - n_dense:
        raise ValueError("weights do not match the config's layer split")
    with P.fp32_exact():
        xs = [P.upcast(params["embed"][s.long()], cast) for s in seqs]
        for li in range(nl):
            w = P.upcast(first[li] if li < n_dense
                         else P.layer(stack, li - n_dense), cast)
            xs = [x + _mla(P.rms_norm(x, w["ln1"]["scale"], eps), w["attn"],
                           conf) for x in xs]
            hs = [P.rms_norm(x, w["ln2"]["scale"], eps) for x in xs]
            if "mlp" in w:
                m = w["mlp"]
                ys = [P.swiglu(h, m["w_gate"], m["w_up"], m["w_down"])
                      for h in hs]
            else:  # tokens are independent: route them all at once
                y = _moe(torch.cat(hs), w["moe"], conf)
                ys = list(torch.split(y, [h.shape[0] for h in hs]))
            xs = [x + y for x, y in zip(xs, ys)]
        return P.head_logits(xs, starts, P.upcast(params["final_norm"]["scale"], cast),
                             P.upcast(params["lm_head"], cast), eps)


def _plain_rope(scaling) -> bool:
    """True where ``rope_scaling`` leaves rotary positions plain. At
    factor 1 YaRN's interpolated frequencies equal the original ones, and
    its mscale, 0.1 m ln(factor) + 1 only above factor 1, is 1 on the
    rotary and on the softmax scale alike."""
    return scaling is None or (scaling.get("type") == "yarn"
                               and scaling.get("factor", 1) <= 1)


def _mla(h, a, conf):
    s, d = h.shape
    n, r = conf["num_attention_heads"], conf["kv_lora_rank"]
    pr, pn = conf["qk_rope_head_dim"], conf["qk_nope_head_dim"]
    hv, theta = conf["v_head_dim"], conf["rope_theta"]
    q = (h @ a["wq"].reshape(d, n * (pn + pr))).view(s, n, pn + pr)
    q_nope, q_rope = q[..., :pn], P.rope(q[..., pn:], theta)
    ckv = h @ a["w_dkv"]
    c, k_rope = ckv[:, :r], P.rope(ckv[:, None, r:], theta)
    k_nope = torch.einsum("sr,rnp->snp", c, a["w_uk"])
    v = torch.einsum("sr,rnv->snv", c, a["w_uv"])
    k = torch.cat([k_nope, k_rope.expand(s, n, pr)], dim=-1)
    o = P.causal_attention(torch.cat([q_nope, q_rope], dim=-1), k, v,
                           P.scale(pn + pr))
    return o.reshape(s, n * hv) @ a["wo"].reshape(n * hv, d)


def _moe(h, m, conf):
    k = conf["num_experts_per_tok"]
    probs = torch.softmax(h @ m["router"], dim=-1)
    top_p, idx = torch.topk(probs, k, dim=-1)
    if conf["norm_topk_prob"]:
        top_p = top_p / top_p.sum(-1, keepdim=True)
    ex = m["experts"]
    out = torch.zeros_like(h)
    for e in torch.unique(idx).tolist():
        tok, slot = (idx == e).nonzero(as_tuple=True)
        y = P.swiglu(h[tok], ex["w_gate"][e], ex["w_up"][e], ex["w_down"][e])
        out.index_add_(0, tok, y * top_p[tok, slot, None])
    sh = m["shared"]
    return out + P.swiglu(h, sh["w_gate"], sh["w_up"], sh["w_down"])
