"""Hybrid Mamba-2 + attention stack with a MoE block after every mixer
(granite-4.0-h): the layer kinds follow ``cfg.layer_types``.

Layer ``i`` of kind ``mamba`` or ``attention`` computes, with ``r`` =
``cfg.residual_multiplier``,

    x = x + r * mixer(rms_norm(x))
    x = x + r * (moe(rms_norm(x)) + shared(rms_norm(x)))

where the mixer is a Mamba-2 block (``ssm.mamba2_block``) or GQA
attention with no rotary positions (``rope_theta`` 0) and the softmax
scale ``cfg.attention_multiplier``, and the MoE block is
``moe.moe_layer``: ``num_experts_per_tok`` of ``num_experts`` routed
experts of ``moe_d_ff`` plus one shared SwiGLU of ``shared_d_ff``.  The
embedding is multiplied by ``cfg.embedding_multiplier`` and the logits
divided by ``cfg.logits_scaling``.

Weights: ``layers`` holds one stack per kind, ``mamba`` (Lm, ...) and
``attention`` (La, ...), each led by its kind's layer count; layer ``i``
is entry ``j`` of its kind's stack, ``j`` the number of earlier layers of
that kind.  Caches follow the same split: the dense decode cache holds
``mamba`` (conv, state) (Lm, B, W-1, C) / (Lm, B, H, P, N) fp32 and
``attn`` (k, v) (La, B, max_seq, Nkv, H); paged decode rides the
``hybrid`` cache family's two pool kinds in one call, ``attn`` block pools
(La, NB, BS, Nkv, H), one plane per attention layer addressed through the
row's one block table, and ``mamba`` slab pools (Lm, NS, ...) addressed by
the row's slab id.  Decode caches and pools are updated in place.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch import resolve_device
from repro_torch.distributed import sharding as shd
from repro_torch.models import layers as L
from repro_torch.models import moe as MoE
from repro_torch.models import ssm as S
from repro_torch.models import transformer as T
# like zamba2's stack, it must declare the ``hybrid`` cache family
from repro_torch.models.hybrid import cache_family, supports_paged  # noqa: F401

# layer kind -> the key of its cache and pools
CACHE_KEY = {"mamba": "mamba", "attention": "attn"}


def counts(cfg) -> dict[str, int]:
    """Layers of each kind present, in ``CACHE_KEY`` order."""
    return {k: n for k in CACHE_KEY if (n := cfg.layer_types.count(k))}


def init_moe(cfg, generator, dtype, device):
    """The routed experts and router of ``moe.init_moe`` and one shared
    SwiGLU of its own width, ``cfg.shared_d_ff``."""
    p = MoE.init_moe(dataclasses.replace(cfg, num_shared_experts=0),
                     generator, dtype, device)
    p["shared"] = L.init_mlp(cfg, generator, dtype, device,
                             d_ff=cfg.shared_d_ff)
    return p


def init_layer(cfg, kind: str, generator, dtype, device):
    p = {"ln1": L.init_rms_norm(cfg.d_model, dtype, device)}
    if kind == "mamba":
        p["mamba"] = S.init_mamba2(cfg, generator, dtype, device)
    else:
        p["attn"] = L.init_attention(cfg, generator, dtype, device)
    p["ln2"] = L.init_rms_norm(cfg.d_model, dtype, device)
    p["moe"] = init_moe(cfg, generator, dtype, device)
    return p


def init_params(cfg, *, generator: torch.Generator, device=None):
    """Random weights: embedding, the stack of each kind (filled layer by
    layer, ``transformer._init_stacked``), final norm, head if untied."""
    device = resolve_device(device)
    dtype = T._dtype(cfg)
    params: dict = {
        "embed": L.embed_init(generator, (cfg.vocab_size, cfg.d_model),
                              dtype, device),
        "layers": {kind: T._init_stacked(
            n, lambda kind=kind: init_layer(cfg, kind, generator, dtype,
                                            device))
            for kind, n in counts(cfg).items()}}
    params["final_norm"] = L.init_rms_norm(cfg.d_model, dtype, device)
    if not cfg.tie_embeddings:
        params["lm_head"] = L.dense_init(
            generator, (cfg.d_model, cfg.vocab_size), dtype, device)
    return params


def _cache(cfg, rows: dict[str, int], seq: int, dtype, device) -> dict:
    """Zero caches of each kind present: ``rows["attention"]`` sequences
    (or blocks) of ``seq`` positions for ``attn``, ``rows["mamba"]``
    states (or slabs) for ``mamba``."""
    dt = T._dtype(cfg, dtype)
    return {CACHE_KEY[kind]: T._cache_leaves(
        cfg, (n,), rows[kind], None if kind == "mamba" else seq, dt, device,
        kind="mamba" if kind == "mamba" else "gqa")
        for kind, n in counts(cfg).items()}


def init_cache(cfg, batch: int, max_seq: int, dtype=None, *, device=None):
    """Zero dense decode cache: ``mamba`` (conv, state) (Lm, B, W-1, C) /
    (Lm, B, H, P, N) fp32, ``attn`` (k, v) (La, B, max_seq, Nkv, H) and
    ``pos`` (B,)."""
    device = resolve_device(device)
    cache = _cache(cfg, dict.fromkeys(CACHE_KEY, batch), max_seq, dtype,
                   device)
    cache["pos"] = torch.zeros((batch,), dtype=torch.int32, device=device)
    return cache


def init_paged_cache(cfg, num_blocks: int, block_size: int, dtype=None, *,
                     num_slabs: int = 0, num_segments: int = 0, device=None):
    """Both pool kinds: ``attn`` (k, v) block pools (La, NB, BS, Nkv, H),
    every attention layer addressing the row's one block table in its own
    plane; ``mamba`` (conv, state) slab pools (Lm, NS, W-1, C) and
    (Lm, NS, H, P, N) fp32."""
    if not supports_paged(cfg):
        raise NotImplementedError(
            f"paged decode cache unsupported for family={cfg.family!r}")
    return _cache(cfg, {"mamba": num_slabs, "attention": num_blocks},
                  block_size, dtype, resolve_device(device))


def paged_pool_kinds(cfg) -> dict[str, str]:
    return {CACHE_KEY[kind]: "slab" if kind == "mamba" else "block"
            for kind in counts(cfg)}


def paged_insert_views(cfg, prefill_cache) -> dict:
    """The prefill cache's leaves are laid out as the pools are: (La, B,
    max_seq, ...) and (Lm, B, ...)."""
    return {key: prefill_cache[key] for key in paged_pool_kinds(cfg)}


def _block(cfg, p, x, *, kind: str, mode: str, positions, layer_cache,
           lengths, step):
    """One layer: the mixer of ``kind``, then the MoE block, each added
    to the residual stream times ``cfg.residual_multiplier``.  Returns
    (x, the mixer's new cache, aux)."""
    r = cfg.residual_multiplier
    h = L.rms_norm(x, p["ln1"]["scale"], cfg.norm_eps)
    if kind == "mamba" and mode == "prefill":
        out, c = S.prefill_mamba_cache(cfg, p["mamba"], h, lengths=lengths)
    elif kind == "mamba":
        out, c = S.mamba2_block(cfg, p["mamba"], h, layer_cache=layer_cache)
    else:
        out, c = L.attention(
            cfg, p["attn"], h, positions=positions,
            cache="build" if mode == "prefill" else None,
            layer_cache=layer_cache, step=step,
            scale=cfg.attention_multiplier or None)
    x = x + out * r
    h = L.rms_norm(x, p["ln2"]["scale"], cfg.norm_eps)
    out, aux = MoE.moe_layer(cfg, p["moe"], h)
    return x + out * r, c, aux


def forward(cfg, params, batch, *, mode: str, cache=None, remat: bool = False,
            remat_policy: str | None = None):
    """batch: 'tokens' (B,S), optional 'lengths' (B,) true prompt lengths
    of a padded prefill (the Mamba-2 layers need them; the attention
    layers' padded KV is masked by decode) and 'max_seq' (the prefill
    cache's padded length).  Decode takes the dense cache of
    :func:`init_cache` or, when the cache holds ``block_tables`` or
    ``slab_ids``, the pools of :func:`init_paged_cache` with those and
    ``pos`` (B,).  Returns (logits, new_cache, aux_loss); ``remat``
    checkpoints each layer (``transformer.remat_layer``)."""
    x = T.embed_tokens(cfg, params, batch["tokens"]) * cfg.embedding_multiplier
    x = shd.shard_hidden(x)
    b, s, _ = x.shape
    if mode == "decode":
        positions = cache["pos"][:, None]
    else:
        positions = torch.arange(s, device=x.device).expand(b, s)
    lengths = batch.get("lengths") if mode == "prefill" else None
    paged = mode == "decode" and ("block_tables" in cache
                                  or "slab_ids" in cache)
    layers = {kind: T._layers(params["layers"][kind], n)
              for kind, n in counts(cfg).items()}
    built = {key: [] for key in paged_pool_kinds(cfg)}  # the prefill cache
    seen = dict.fromkeys(layers, 0)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    step = None  # the attention layers' shared values, once per step
    run = T.remat_layer(_block, remat, remat_policy)

    for kind in cfg.layer_types:
        j = seen[kind]
        seen[kind] += 1
        key = CACHE_KEY[kind]
        if mode != "decode":
            lc = None
        elif not paged:  # this layer's entry of each stacked leaf
            lc = (*(t[j] for t in cache[key]), cache["pos"])
        elif kind == "mamba":  # the slab pools, through each row's slab
            lc = (*cache[key], j, cache["slab_ids"])
        else:  # the block pools, through each row's block table
            lc = (*cache[key], j, cache["block_tables"], cache["pos"])
        if kind == "attention" and step is None:
            step = L.attention_step(cfg, positions, lc)
        x, c, aux = run(cfg, layers[kind][j], x, kind=kind, mode=mode,
                        positions=positions, layer_cache=lc, lengths=lengths,
                        step=step)
        aux_total = aux_total + aux
        if mode == "prefill":
            built[key].append(c)

    x = L.rms_norm(x, params["final_norm"]["scale"], cfg.norm_eps)
    logits = T.unembed(cfg, params, x).div_(cfg.logits_scaling)

    if mode == "train":
        return logits, None, aux_total
    if mode == "decode":
        out = {k: cache[k] for k in (*built, "block_tables", "slab_ids")
               if k in cache}
        out["pos"] = cache["pos"] + 1
        return logits, out, aux_total
    max_seq = batch.get("max_seq", s)
    out = {key: tuple(torch.stack(t) for t in zip(*caches))
           for key, caches in built.items()}
    if "attn" in out:  # only the attention layers' KV has positions to pad
        out["attn"] = tuple(T.pad_seq(t, 2, max_seq) for t in out["attn"])
    out["pos"] = (lengths.to(torch.int32) if lengths is not None
                  else torch.full((b,), s, dtype=torch.int32, device=x.device))
    return logits, out, aux_total
