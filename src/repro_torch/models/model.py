"""Unified model API of the port.

    init_params(cfg, generator=, device=)     -> params tree
    init_cache(cfg, batch, max_seq)           -> dense decode cache
    init_paged_cache(cfg, blocks, block_size) -> block, slab or segment pools
    supports_paged(cfg)                       -> paged decode available?
    apply(cfg, params, batch, mode=...)       -> (logits, cache, aux)
    loss_fn(cfg, params, batch, ...)          -> (loss, metrics)
    param_count(cfg)                          -> analytical N (for rooflines)
    input_specs(cfg, shape)                   -> meta-device batch stand-ins

Counterpart of ``repro/models/model.py``.  The port has the dense GQA
decoder, the MoE decoder (GQA or MLA attention, with dense prefix layers),
the pure-SSM (Mamba-2) stack and the VLM backbone (M-RoPE, embedding
inputs) in ``transformer``, the hybrid (Mamba-2 + shared attention) stack
in ``hybrid``, the hybrid Mamba-2 + attention stack with a MoE block after
every mixer (granite-4.0-h) in ``hybrid_moe`` and the whisper-style
encoder-decoder in ``encdec``.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.distributed import sharding as shd
from repro_torch.models import encdec, hybrid, hybrid_moe, transformer

Params = Any


# families with a module of their own; the rest are ``transformer``'s
_FAMILIES = {"hybrid": hybrid, "hybrid_moe": hybrid_moe, "encdec": encdec}


def _family_mod(cfg):
    return _FAMILIES.get(cfg.family, transformer)


def init_params(cfg, *, generator, device=None) -> Params:
    return _family_mod(cfg).init_params(cfg, generator=generator,
                                        device=device)


def init_cache(cfg, batch: int, max_seq: int, dtype=None, *, device=None):
    return _family_mod(cfg).init_cache(cfg, batch, max_seq, dtype,
                                       device=device)


def cache_family(cfg) -> str | None:
    """The cache family (a ``serving.kvcache.FAMILIES`` key) this config
    pages under, or None when nothing resolves.  A declared
    ``cfg.cache_family`` always wins."""
    return _family_mod(cfg).cache_family(cfg)


def supports_paged(cfg) -> bool:
    """True when the family can run its decode cache in pooled form."""
    return _family_mod(cfg).supports_paged(cfg)


def init_paged_cache(cfg, num_blocks: int, block_size: int, dtype=None, *,
                     num_slabs: int = 0, num_segments: int = 0, device=None):
    """Pooled decode cache for the resolved cache family; the caller owns
    block tables and lengths (see serving/kvcache.py)."""
    return _family_mod(cfg).init_paged_cache(
        cfg, num_blocks, block_size, dtype, num_slabs=num_slabs,
        num_segments=num_segments, device=device)


def paged_pool_kinds(cfg) -> dict[str, str]:
    """Pools-dict key -> "block" | "slab" | "segment"."""
    return _family_mod(cfg).paged_pool_kinds(cfg)


def paged_insert_views(cfg, prefill_cache) -> dict:
    """Prefill-cache leaves arranged like the ``init_paged_cache`` pools
    ((L, B, ...) per leaf; the prefix layers' tuples stacked along a new
    leading axis) for the engine's insert scatter.  A family module with
    its own arrangement (the hybrid and enc-dec stacks) gives it."""
    mod = _family_mod(cfg)
    if hasattr(mod, "paged_insert_views"):
        return mod.paged_insert_views(cfg, prefill_cache)
    views = {"layers": prefill_cache["layers"]}
    if "first_layers" in prefill_cache:
        views["first_layers"] = tuple(
            torch.stack(leaves) for leaves in zip(*prefill_cache["first_layers"]))
    return views


def apply(cfg, params, batch, *, mode: str, cache=None, remat: bool = False,
          remat_policy: str | None = None):
    """batch: 'tokens' (B,S) -- or 'embeds' (B,S,D) with 'mrope_positions'
    (3,B,S) for the VLM stack -- plus 'frames' (B,T_enc,D) for the enc-dec
    stack's train and prefill, and the optional keys of its family's
    ``forward``.  ``remat_policy`` names a policy of
    ``transformer.REMAT_POLICIES`` (the reference passes the
    ``jax.checkpoint`` policy itself)."""
    return _family_mod(cfg).forward(cfg, params, batch, mode=mode, cache=cache,
                                    remat=remat, remat_policy=remat_policy)


def cross_entropy(logits, labels, *, z_loss: float = 0.0):
    """Stable CE in fp32; labels < 0 are masked out.  On DTensor logits
    the sums run on each rank's rows under ``local_map``, each row's
    vocab gathered whole first (DTensor has no rule for the gold gather
    on a split vocab, nor, in every release, for its backward), and the
    ranks' partial sums are added."""
    mesh = shd.mesh_of(logits, labels)
    if mesh is not None:
        logits = shd.whole_rows(shd.as_dtensor(logits, mesh))
        rows = list(logits.placements)  # shards of (B, S) only
        part = shd.partial_where_sharded(rows)
        total, count = shd.local_call(
            lambda lg, lb: _nll_sums(lg, lb, z_loss),
            (logits, shd.as_dtensor(labels, mesh)), (rows, rows),
            (part, part), (rows, rows))
    else:
        total, count = _nll_sums(logits, labels, z_loss)
    return total / count.clamp(min=1.0)


def _nll_sums(logits, labels, z_loss: float):
    """(sum of the unmasked rows' nll, their count), fp32."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.clamp(min=0).long()[..., None])[..., 0]
    nll = lse - gold
    if z_loss:
        nll = nll + z_loss * lse.square()
    mask = (labels >= 0).float()
    return (nll * mask).sum(), mask.sum()


def loss_fn(cfg, params, batch, *, remat: bool = True,
            remat_policy: str | None = None, aux_weight: float = 0.01):
    logits, _, aux = apply(cfg, params, batch, mode="train", remat=remat,
                           remat_policy=remat_policy)
    ce = cross_entropy(logits, batch["labels"])
    loss = ce + aux_weight * aux
    return loss, {"ce": ce, "aux": aux}


# --------------------------------------------------------------------------
# analytical parameter counts (roofline MODEL_FLOPS = 6*N*D or 6*N_active*D)
# --------------------------------------------------------------------------


def _attn_params(cfg) -> int:
    d = cfg.d_model
    if cfg.attn_type == "mla":
        r, pr, pn, hv, n = (cfg.kv_lora_rank, cfg.qk_rope_head_dim,
                            cfg.qk_nope_head_dim, cfg.v_head_dim, cfg.num_heads)
        return (d * n * (pn + pr) + d * (r + pr) + r * n * pn + r * n * hv
                + n * hv * d)
    nq, nkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    return d * hd * (nq + 2 * nkv) + nq * hd * d


def _mlp_params(d: int, f: int, mlp_type: str) -> int:
    return (3 if mlp_type == "swiglu" else 2) * d * f


def _mamba_params(cfg) -> int:
    d, din, h = cfg.d_model, cfg.d_inner, cfg.ssm_nheads
    cdim = din + 2 * cfg.ssm_ngroups * cfg.ssm_state_dim
    return (d * (din + cdim + h) + cfg.conv_width * cdim + cdim
            + 3 * h + din + din * d)


def param_count(cfg, *, active_only: bool = False) -> int:
    d, v = cfg.d_model, cfg.vocab_size
    total = v * d + d  # embedding + final norm
    if not cfg.tie_embeddings:
        total += d * v  # lm_head

    if cfg.family == "hybrid":
        g = cfg.num_layers // cfg.attn_every
        n_mamba = cfg.num_layers - g
        total += n_mamba * (_mamba_params(cfg) + d)
        total += _attn_params(cfg) + _mlp_params(d, cfg.d_ff, cfg.mlp_type) + 2 * d
        return total

    if cfg.family == "hybrid_moe":
        routed = cfg.num_experts_per_tok if active_only else cfg.num_experts
        moe = (routed * _mlp_params(d, cfg.moe_d_ff, "swiglu")
               + _mlp_params(d, cfg.shared_d_ff, "swiglu") + d * cfg.num_experts)
        for kind in cfg.layer_types:
            mixer = _mamba_params(cfg) if kind == "mamba" else _attn_params(cfg)
            total += mixer + moe + 2 * d
        return total

    if cfg.family == "encdec":
        enc = cfg.encoder_layers * (_attn_params(cfg)
                                    + _mlp_params(d, cfg.d_ff, cfg.mlp_type) + 2 * d)
        dec = cfg.num_layers * (2 * _attn_params(cfg)
                                + _mlp_params(d, cfg.d_ff, cfg.mlp_type) + 3 * d)
        return total + enc + dec + d  # + enc_norm

    if cfg.family == "ssm":
        return total + cfg.num_layers * (_mamba_params(cfg) + d)

    # dense / moe / vlm decoder
    for i in range(cfg.num_layers):
        total += _attn_params(cfg) + 2 * d
        if cfg.is_moe and i >= cfg.first_dense_layers:
            routed = cfg.num_experts_per_tok if active_only else cfg.num_experts
            total += routed * _mlp_params(d, cfg.moe_d_ff, "swiglu")
            total += cfg.num_shared_experts * _mlp_params(d, cfg.moe_d_ff, "swiglu")
            total += d * cfg.num_experts  # router
        else:
            total += _mlp_params(d, cfg.d_ff, cfg.mlp_type)
    return total


# --------------------------------------------------------------------------
# input stand-ins for a dry run (meta-device tensors: no allocation)
# --------------------------------------------------------------------------


def input_specs(cfg, shape, *, for_train: bool | None = None) -> dict:
    """Batch stand-ins for one step of the given ShapeSpec, as tensors on
    the meta device (the reference returns ``jax.ShapeDtypeStruct``s).

    train:   tokens+labels (B,S)   [+frames/embeds/mrope per family]
    prefill: tokens (B,S)          [+...]
    decode:  tokens (B,1), cache supplied separately by the launcher
    """
    b, s = shape.global_batch, shape.seq_len
    dt = getattr(torch, cfg.dtype)
    kind = shape.kind if for_train is None else ("train" if for_train else shape.kind)

    def sds(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    if kind == "train":
        batch = {"tokens": sds((b, s), torch.int32),
                 "labels": sds((b, s), torch.int32)}
        seq = (b, s)
    elif kind == "prefill":
        batch = {"tokens": sds((b, s), torch.int32)}
        seq = (b, s)
    else:  # decode: one new token against a cache of length s
        batch = {"tokens": sds((b, 1), torch.int32)}
        seq = (b, 1)

    if cfg.family == "vlm":
        # frontend stub: merged text+vision embeddings and M-RoPE positions
        # replace raw tokens entirely
        batch.pop("tokens", None)
        batch["embeds"] = sds((*seq, cfg.d_model), dt)
        batch["mrope_positions"] = sds((3, *seq), torch.int32)
    if cfg.family == "encdec" and kind != "decode":
        # frontend stub: precomputed encoder frame embeddings
        batch["frames"] = sds((b, cfg.encoder_seq, cfg.d_model), dt)
    return batch
