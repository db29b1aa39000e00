"""Mixture-of-Experts layer.

Counterpart of ``repro/models/moe.py``, with its three execution paths,
all numerically equivalent (up to capacity drops):

  * dense      — every expert runs on every token, combined by routing
                 weights.  Exact (dropless); the single-device path and
                 the reference oracle for the distributed paths.
  * ep_a2a     — expert parallelism over the 'model' mesh axis: tokens
                 are dispatched into per-expert capacity buffers locally,
                 exchanged with one ``all_to_all_single``, computed on the
                 expert-owning rank, and returned with a second.  Used for
                 train/prefill (seq divisible by the model axis).
  * ep_replicated — tokens replicated over the model axis; each rank
                 computes only its local experts and the partial outputs
                 are summed.  Used for decode (seq length 1).

The port adds a fourth for the single-device decode step, where the
reference runs dense: ``moe_routed`` computes each token's chosen experts
only, in ``kernels.moe_experts.moe_routed_experts`` (on the card a
hand-written kernel that reads only the chosen experts' weights).  It
gives dense's result up to the order of fp32 sums; :func:`moe_route` takes
it only where no gradient is wanted and the call's rows are few enough
that an expert's share of them fits the kernel's row tile.

The reference's ``shard_map`` bodies run under ``local_map`` on the local
shards of DTensors (plain tensors are taken as replicated).  Its ``psum``
and ``pmean`` over the body's output become ``Partial`` placements of the
output, which DTensor reduces when it is redistributed: that reduction's
backward hands each rank the replicated gradient, as the transposes of
JAX's collectives do, where a bare ``all_reduce`` inside an autograd graph
would sum the ranks' copies of it.  The ``all_to_all`` exchanges are
``torch.distributed.nn.functional.all_to_all_single`` (its backward is
the reverse exchange).  The expert products are batched ``torch.matmul``
over the expert axis on the weights' own (E, D, F) / (E, F, D) layout: the
tokens are broadcast, the expert stacks are never permuted or copied.

Routing: top-k over softmax(router logits) in fp32, renormalised over the
selected experts, plus the Switch-style load-balance auxiliary loss.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.nn.functional import all_to_all_single
from torch.distributed.tensor import Partial, Replicate, Shard

from repro_torch.distributed import sharding as shd
from repro_torch.kernels.moe_experts import ROW_TILE, moe_routed_experts
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


# the most bytes that moe_dense's (E, T, D) expert outputs take at once.
# In one pass granite-4.0-h-small's 16 x 512-token prefill (E 72, D 4096,
# bf16) would take 4.83 GB, and its capture ran the card out of memory;
# deepseek-v2-lite's widest prefill (E 64, D 2048) is exactly this.
DENSE_PASS_BYTES = 2**31


def _dense_experts(experts: Params, tokens, combine):
    """Every expert on ``tokens`` (T, D), mixed by ``combine`` (T, E)."""
    # (T, D) @ (E, D, F) broadcasts the tokens over the expert axis
    g = F.silu(torch.matmul(tokens, experts["w_gate"]))
    u = torch.matmul(tokens, experts["w_up"])
    y_all = torch.matmul(g * u, experts["w_down"])  # (E, T, D)
    return torch.einsum("te,etd->td", combine, y_all)


def moe_dense(cfg, p: Params, x):
    """All experts on all tokens (exact, dropless): (B,S,D) -> ((B,S,D),
    aux).  The router sees every token at once; the experts take them in
    passes whose (E, T, D) outputs fit ``DENSE_PASS_BYTES`` (one pass
    while all of them fit)."""
    b, s, d = x.shape
    tokens = x.reshape(-1, d)
    idx, weights, aux = router_topk(cfg, p, tokens)
    combine = torch.zeros((tokens.shape[0], cfg.num_experts), dtype=x.dtype,
                          device=x.device)
    combine.scatter_add_(1, idx, weights)
    step = max(DENSE_PASS_BYTES // (cfg.num_experts * d * x.element_size()),
               1)
    parts = [_dense_experts(p["experts"], t, c) for t, c in
             zip(tokens.split(step), combine.split(step))]
    # one pass needs no copy into a joined output
    out = parts[0] if len(parts) == 1 else torch.cat(parts)
    return out.reshape(b, s, d), aux


def moe_routed(cfg, p: Params, x):
    """Each token through the experts it chose only (exact, dropless):
    (B,S,D) -> ((B,S,D), aux), the router and aux as ``moe_dense``'s."""
    b, s, d = x.shape
    tokens = x.reshape(-1, d)
    idx, weights, aux = router_topk(cfg, p, tokens)
    ex = p["experts"]
    out = moe_routed_experts(tokens, idx, weights, ex["w_gate"], ex["w_up"],
                             ex["w_down"])
    return out.reshape(b, s, d), aux


def moe_route(cfg, p: Params, x, rules=None) -> str:
    """The MoE layer's path for x (B,S,D) under ``rules``:
    "expert_parallel" on a mesh whose model axis is above 1; else "routed"
    for a decode step (S == 1) that wants no gradient -- grad disabled, or
    no input requiring it -- on values a device holds, whose B * K slots
    average at most one ROW_TILE an expert (T * K <= 16 * E: 170 rows at
    deepseek-v2-lite's E 64 / K 6, 115 at granite-4.0-h-small's E 72 /
    K 10); else "dense" (training, prefill, the meta tensors of static
    pricing, which hold no routing to follow, and wide decode calls, where
    the kernel's row tiles would stream an expert's weights more than once
    and dense's GEMMs read each once: at deepseek-v2-lite's widths the
    routed layer is 4.6x faster at 1 row, even from 32 to 128 rows and
    0.70x at 256, PERF.md)."""
    if not (rules is None or rules.mesh is None
            or shd.axis_size(rules.mesh, rules.model_axis) == 1):
        return "expert_parallel"
    ex = p["experts"]
    wants_grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (x, p["router"], ex["w_gate"], ex["w_up"],
                                  ex["w_down"]))
    fits = x.shape[0] * cfg.num_experts_per_tok <= ROW_TILE * cfg.num_experts
    if (x.shape[1] == 1 and not wants_grad and x.device.type != "meta"
            and fits):
        return "routed"
    return "dense"


def _expert_ffn(experts: Params, h):
    """h (E, C, D) -> (E, C, D), batched swiglu over experts."""
    g = F.silu(torch.matmul(h, experts["w_gate"]))
    u = torch.matmul(h, experts["w_up"])
    return torch.matmul(g * u, experts["w_down"])


def _dispatch(tokens, idx, weights, e: int, capacity: int):
    """Scatter tokens into per-expert capacity buffers.

    tokens (T, D); idx/weights (T, K).  Returns (buf (E*C, D), slot (T*K,),
    keep (T*K,)).  Slot assignment is in token order (first-come
    first-served within each expert), overflow tokens are dropped.
    """
    t, k = idx.shape
    flat_e = idx.reshape(-1)  # (T*K,)
    # one column more than E: the sentinel `e` gets an all-zero row, as
    # under jax.nn.one_hot
    oh = F.one_hot(flat_e, e + 1)[:, :e]  # (T*K, E)
    pos = torch.cumsum(oh, dim=0) - 1  # running count per expert
    safe_e = torch.clamp(flat_e, max=e - 1)
    pos_in_e = torch.gather(pos, 1, safe_e[:, None])[:, 0]
    # flat_e may carry the sentinel value `e` (non-local expert): always drop
    keep = (pos_in_e < capacity) & (flat_e < e)
    slot = torch.where(keep, flat_e * capacity + pos_in_e,
                       torch.full_like(flat_e, e * capacity))
    src = torch.repeat_interleave(tokens, k, dim=0)  # (T*K, D)
    buf = tokens.new_zeros((e * capacity + 1, tokens.shape[-1]))
    buf = buf.index_add(0, slot, src * keep[:, None].to(tokens.dtype))
    return buf[:-1], slot, keep


def _combine(buf_out, slot, keep, weights, t: int, k: int):
    """Gather expert outputs back to tokens and mix with routing weights."""
    d = buf_out.shape[-1]
    padded = torch.cat([buf_out, buf_out.new_zeros((1, d))], dim=0)
    safe_slot = torch.where(keep, slot, torch.full_like(slot, buf_out.shape[0]))
    y = padded[safe_slot]  # (T*K, D)
    y = y.reshape(t, k, d) * weights[..., None]
    return torch.sum(y, dim=1)


def _moe_local(cfg, router, experts, tokens, *, capacity: int, e_local: int,
               axis=None):
    """Per-rank MoE body (runs under local_map with ``axis`` the model
    axis' process group, or standalone if axis None with e_local ==
    num_experts)."""
    t, d = tokens.shape
    k = cfg.num_experts_per_tok
    e = cfg.num_experts
    idx, weights, aux = router_topk(cfg, {"router": router}, tokens)
    buf, slot, keep = _dispatch(tokens, idx, weights, e, capacity)

    if axis is not None:
        n = dist.get_world_size(axis)
        # (E, C, D) -> exchange so each rank holds its local experts'
        # tokens: row block j of E goes to rank j, and what arrives from
        # rank i lands as column block i of the capacity axis
        sent = buf.reshape(e, capacity, d)
        got = all_to_all_single(torch.empty_like(sent), sent, group=axis)
        h = got.reshape(n, e_local, capacity, d).transpose(0, 1)
        y = _expert_ffn(experts, h.reshape(e_local, n * capacity, d))
        # (E_local, n*C, D): column block j goes back to rank j
        back = y.reshape(e_local, n, capacity, d).transpose(0, 1).contiguous()
        y = all_to_all_single(torch.empty_like(back), back, group=axis)
        y = y.reshape(e * capacity, d)
    else:
        y = _expert_ffn(experts, buf.reshape(e, capacity, d)).reshape(e * capacity, d)

    out = _combine(y, slot, keep, weights, t, k)
    return out, aux


def _moe_replicated_body(cfg, router, experts, tokens, *, capacity: int, axis):
    """Decode path: tokens replicated over the model axis (``axis``, its
    process group); each rank runs its local experts only.  Returns its
    partial output, which the caller marks ``Partial`` over the model axis
    (the reference's psum), and aux."""
    t, d = tokens.shape
    k = cfg.num_experts_per_tok
    e = cfg.num_experts
    n = dist.get_world_size(axis)
    e_local = e // n
    shard = dist.get_rank(axis)
    idx, weights, aux = router_topk(cfg, {"router": router}, tokens)
    # mask to experts owned by this rank, re-indexed locally
    local = (idx // e_local) == shard
    local_idx = torch.where(local, idx % e_local, torch.full_like(idx, e_local))
    w_local = torch.where(local, weights, torch.zeros_like(weights))
    buf, slot, keep = _dispatch(tokens, local_idx, w_local, e_local, capacity)
    y = _expert_ffn(experts, buf.reshape(e_local, capacity, d)).reshape(-1, d)
    out = _combine(y, slot, keep, w_local, t, k)
    return out, aux


def _by_axis(rules, *, model, batch):
    """One placement per mesh dim: ``model`` on the model axis, ``batch``
    on the batch axes, ``Replicate()`` on any other (where the reference's
    body sees the same values on every rank)."""
    return [model if a == rules.model_axis else
            batch if a in rules.batch_axes else Replicate()
            for a in rules.mesh.mesh_dim_names]


def _run_body(rules, body, p, x, *, in_pls, grad_pls, out_pl, aux_pl):
    """``body(router, w_gate, w_up, w_down, x)`` under local_map, with the
    placements ``in_pls`` and gradient placements ``grad_pls`` of those
    five (plain tensors taken as replicated).  Returns (out in ``out_pl``,
    aux replicated)."""
    mesh = rules.mesh
    ex = p["experts"]
    args = [shd.as_dtensor(t, mesh) for t in (p["router"], ex["w_gate"],
                                           ex["w_up"], ex["w_down"], x)]
    out, aux = shd.local_call(body, args, in_pls, (out_pl, aux_pl), grad_pls)
    return out, aux.redistribute(placements=[Replicate()] * mesh.ndim)


def _moe_decode_tpdata(cfg, rules, p: Params, x):
    """§Perf decode path: expert FFN width sharded over the DP axes.

    Instead of FSDP-gathering ~GBs of expert weights per layer to process a
    few hundred tokens, gather the TOKENS (the redistribution of ``x`` to
    replicated over DP: ~MBs), compute each (expert-shard x FFN-slice)
    locally, and combine with a sum over the model axis (expert partials)
    + a reduce-scatter over the DP axes (FFN partials + return each rank
    its own batch slice): both are the ``Partial`` placements of the
    body's output."""
    import math as _math

    mesh, axis = rules.mesh, rules.model_axis
    batch = rules.batch()
    n_model = shd.axis_size(mesh, axis)
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    e_local = e // n_model
    b, s, d = x.shape
    t_all = b * s
    capacity = max(int(_math.ceil(t_all * k / e * cfg.capacity_factor)), 4)
    group = mesh.get_group(axis)

    def body(router, wg, wu, wd, xx):
        xa = xx.reshape(-1, d)  # every token: replicated over DP
        idx, weights, aux = router_topk(cfg, {"router": router}, xa)
        shard = dist.get_rank(group)
        local = (idx // e_local) == shard
        local_idx = torch.where(local, idx % e_local,
                                torch.full_like(idx, e_local))
        w_local = torch.where(local, weights, torch.zeros_like(weights))
        buf, slot, keep = _dispatch(xa, local_idx, w_local, e_local, capacity)
        hbuf = buf.reshape(e_local, capacity, d)
        g = F.silu(torch.matmul(hbuf, wg))
        u = torch.matmul(hbuf, wu)
        y = torch.matmul(g * u, wd).reshape(-1, d)
        out = _combine(y, slot, keep, w_local, t_all, k)  # (T, D)
        return out.reshape(xx.shape), aux

    dp = (tuple(rules.batch_axes) if len(rules.batch_axes) > 1
          else rules.batch_axes[0])
    # each rank holds partials over its experts and its FFN slice
    partial = _by_axis(rules, model=Partial(), batch=Partial())
    replicated = [Replicate()] * mesh.ndim
    w_in = [shd.placements(spec, mesh) for spec in
            (shd.P(axis, None, dp), shd.P(axis, None, dp),
             shd.P(axis, dp, None))]
    # aux is identical on every DP rank post-gather; the reference pmeans
    # it over DP when the tokens were sharded there
    aux_pl = (_by_axis(rules, model=Replicate(), batch=Partial("avg"))
              if rules.shard_batch else replicated)
    out, aux = _run_body(rules, body, p, x,
                         in_pls=[replicated, *w_in, replicated],
                         grad_pls=[partial, *w_in, partial],
                         out_pl=partial, aux_pl=aux_pl)
    return out.redistribute(placements=shd.placements(
        shd.P(batch, None, None), mesh)), aux


def moe_layer(cfg, p: Params, x):
    """Dispatching MoE layer: picks the execution path from the active
    sharding rules, as the reference does, and on a single device from the
    step (:func:`moe_route`).  Returns (out (B,S,D), aux_loss)."""
    b, s, d = x.shape
    rules = shd.current_rules()
    k = cfg.num_experts_per_tok
    e = cfg.num_experts

    route = moe_route(cfg, p, x, rules)
    if route == "routed":
        out, aux = moe_routed(cfg, p, x)
    elif route == "dense":
        out, aux = moe_dense(cfg, p, x)
    else:
        mesh = rules.mesh
        axis = rules.model_axis
        n = shd.axis_size(mesh, axis)
        batch = rules.batch()
        group = mesh.get_group(axis)
        replicated = [Replicate()] * mesh.ndim
        experts_in = [shd.placements(shd.P(axis, None, None), mesh)] * 3
        # gradients of weights the ranks of one DP shard share: partial sums
        # over the DP axes when each holds its own tokens
        dp_sum = Partial() if rules.shard_batch else Replicate()
        if e % n == 0 and s % n == 0 and s > 1:
            # EP with all_to_all: tokens seq-sharded over the model axis
            t_loc = (b * s) // (n * math.prod(shd.axis_size(mesh, a)
                                              for a in rules.batch_axes))
            capacity = max(_ceil_mult(t_loc * k / e * cfg.capacity_factor, 1), 4)

            def body(router, wg, wu, wd, xx):
                bb, ss, dd = xx.shape
                out, aux = _moe_local(
                    cfg, router, {"w_gate": wg, "w_up": wu, "w_down": wd},
                    xx.reshape(-1, dd), capacity=capacity, e_local=e // n,
                    axis=group)
                return out.reshape(bb, ss, dd), aux

            x_pl = shd.placements(shd.P(batch, axis, None), mesh)
            experts_grad = _by_axis(rules, model=Shard(0), batch=dp_sum)
            # aux is per rank; the reference pmeans it over every axis
            out, aux = _run_body(
                rules, body, p, x,
                in_pls=[replicated, *experts_in, x_pl],
                grad_pls=[_by_axis(rules, model=Partial(), batch=dp_sum),
                          *[experts_grad] * 3, x_pl],
                out_pl=x_pl,
                aux_pl=_by_axis(rules, model=Partial("avg"),
                                batch=Partial("avg")))
        elif e % n == 0 and rules.expert_ff_fsdp:
            from repro_torch.models import perf

            assert perf.current().moe_decode == "tp_data"
            out, aux = _moe_decode_tpdata(cfg, rules, p, x)
        elif e % n == 0:
            # decode: tokens replicated over model, partial sum combine
            t_loc = (b * s) // math.prod(shd.axis_size(mesh, a)
                                         for a in rules.batch_axes)
            capacity = max(_ceil_mult(t_loc * k / e * cfg.capacity_factor, 1), 4)

            def body(router, wg, wu, wd, xx):
                bb, ss, dd = xx.shape
                out, aux = _moe_replicated_body(
                    cfg, router, {"w_gate": wg, "w_up": wu, "w_down": wd},
                    xx.reshape(-1, dd), capacity=capacity, axis=group)
                return out.reshape(bb, ss, dd), aux

            x_pl = shd.placements(shd.P(batch, None, None), mesh)
            # the partial sums over the model axis: the reference's psum
            out_pl = [Partial() if a == axis else pl
                      for a, pl in zip(mesh.mesh_dim_names, x_pl)]
            experts_grad = _by_axis(rules, model=Shard(0), batch=dp_sum)
            # aux is computed on model-replicated tokens: it only varies
            # over the DP axes, so average over those alone
            out, aux = _run_body(
                rules, body, p, x,
                in_pls=[replicated, *experts_in, x_pl],
                grad_pls=[_by_axis(rules, model=Partial(), batch=dp_sum),
                          *[experts_grad] * 3, out_pl],
                out_pl=out_pl,
                aux_pl=_by_axis(rules, model=Replicate(),
                                batch=Partial("avg") if rules.shard_batch
                                else Replicate()))
            out = out.redistribute(placements=x_pl)
        else:
            # experts that do not split over the model axis: each rank runs
            # all of them on its own tokens (exact, dropless)
            def body(router, wg, wu, wd, xx):
                return moe_dense(cfg, {"router": router, "experts": {
                    "w_gate": wg, "w_up": wu, "w_down": wd}}, xx)

            x_pl = shd.placements(shd.P(batch, None, None), mesh)
            weights_grad = _by_axis(rules, model=Replicate(), batch=dp_sum)
            out, aux = _run_body(
                rules, body, p, x, in_pls=[replicated] * 4 + [x_pl],
                grad_pls=[weights_grad] * 4 + [x_pl], out_pl=x_pl,
                aux_pl=_by_axis(rules, model=Replicate(),
                                batch=Partial("avg") if rules.shard_batch
                                else Replicate()))

    if "shared" in p:
        out = out + mlp(cfg, p["shared"], x)
    return shd.shard_hidden(out), aux


def _ceil_mult(x: float, m: int) -> int:
    return int(math.ceil(x / m) * m)
