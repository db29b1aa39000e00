"""Mixture-of-Experts layer of the port, single-device path.

Counterpart of ``repro/models/moe.py``: ``init_moe``, ``router_topk``,
``moe_dense`` and the single-device branch of ``moe_layer`` with its shared
experts.  On one device the reference runs ``moe_dense``: every expert on
every token, combined by the routing weights -- exact and dropless.  The
expert products are batched ``torch.matmul`` over the expert axis on the
weights' own (E, D, F) / (E, F, D) layout: the tokens are broadcast, the
expert stacks are never permuted or copied.  The expert-parallel branches
(``_dispatch``, ``_combine``, ``_moe_local``, ``_moe_replicated_body``,
``_moe_decode_tpdata``) come with the distributed slice (ROADMAP A11.5).

Routing: top-k over softmax(router logits) in fp32, renormalised over the
selected experts, plus the Switch-style load-balance auxiliary loss.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.layers import Params, dense_init, mlp


def init_moe(cfg, generator, dtype, device) -> Params:
    """The router is drawn in fp32 whatever ``dtype`` (as the reference)."""
    e, d, f = cfg.num_experts, cfg.d_model, cfg.moe_d_ff
    p: Params = {
        "router": dense_init(generator, (d, e), torch.float32, device,
                             scale=0.02),
        "experts": {
            "w_gate": dense_init(generator, (e, d, f), dtype, device,
                                 scale=1.0 / math.sqrt(d)),
            "w_up": dense_init(generator, (e, d, f), dtype, device,
                               scale=1.0 / math.sqrt(d)),
            "w_down": dense_init(generator, (e, f, d), dtype, device,
                                 scale=1.0 / math.sqrt(f)),
        },
    }
    if cfg.num_shared_experts:
        shared_f = cfg.moe_d_ff * cfg.num_shared_experts
        p["shared"] = {
            "w_gate": dense_init(generator, (d, shared_f), dtype, device),
            "w_up": dense_init(generator, (d, shared_f), dtype, device),
            "w_down": dense_init(generator, (shared_f, d), dtype, device),
        }
    return p


def router_topk(cfg, p: Params, x):
    """x (T, D) -> (idx (T,K), weights (T,K) in x's dtype, aux scalar)."""
    logits = torch.matmul(x.float(), p["router"])
    probs = torch.softmax(logits, dim=-1)
    top_p, idx = torch.topk(probs, cfg.num_experts_per_tok, dim=-1)
    weights = top_p / top_p.sum(dim=-1, keepdim=True)
    # load-balance aux loss (Switch-style): E * sum_e f_e * P_e; the
    # occupancy count is a scatter, not a bincount (which syncs on CUDA)
    e = cfg.num_experts
    occupancy = torch.zeros((e,), dtype=torch.float32, device=x.device)
    occupancy.index_add_(0, idx.reshape(-1),
                         torch.ones((idx.numel(),), device=x.device))
    aux = e * torch.sum(occupancy / idx.numel() * probs.mean(dim=0))
    return idx, weights.to(x.dtype), aux


def moe_dense(cfg, p: Params, x):
    """All experts on all tokens (exact, dropless): (B,S,D) -> ((B,S,D),
    aux)."""
    b, s, d = x.shape
    tokens = x.reshape(-1, d)
    idx, weights, aux = router_topk(cfg, p, tokens)
    ex = p["experts"]
    # (T, D) @ (E, D, F) broadcasts the tokens over the expert axis
    g = F.silu(torch.matmul(tokens, ex["w_gate"]))
    u = torch.matmul(tokens, ex["w_up"])
    y_all = torch.matmul(g * u, ex["w_down"])  # (E, T, D)
    combine = torch.zeros((tokens.shape[0], cfg.num_experts), dtype=x.dtype,
                          device=x.device)
    combine.scatter_add_(1, idx, weights)
    out = torch.einsum("te,etd->td", combine, y_all)
    return out.reshape(b, s, d), aux


def moe_layer(cfg, p: Params, x):
    """The single-device MoE layer: routed experts plus the shared ones.
    Returns (out (B,S,D), aux)."""
    out, aux = moe_dense(cfg, p, x)
    if "shared" in p:
        out = out + mlp(cfg, p["shared"], x)
    return out, aux
