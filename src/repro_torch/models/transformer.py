"""Decoder-only transformer stack of the port: dense GQA and pure-SSM
(Mamba-2) families.

Counterpart of ``repro/models/transformer.py``.  Layer parameters are
stacked along a leading L axis, as in the reference; a Python loop over
``range(L)`` on views of the stack replaces ``lax.scan``.  Decode caches
and paged pools are updated in place (the reference threads them through
the scan as carry and donates the buffers), so a decode step allocates no
copy of either.

Modes:
  train   -- causal forward, logits for all positions, no cache
  prefill -- causal forward + returns the decode cache
  decode  -- single-token step against a dense cache or, when the cache
             holds ``block_tables`` (GQA) or ``slab_ids`` (SSM), against
             block or slab pools
"""

from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import ssm as S


def _dtype(cfg, dtype=None) -> torch.dtype:
    return dtype if dtype is not None else getattr(torch, cfg.dtype)


# --------------------------------------------------------------------------
# per-layer init
# --------------------------------------------------------------------------


def _mixer_kind(cfg) -> str:
    if cfg.family == "ssm":
        return "mamba"
    return cfg.attn_type


def init_layer(cfg, generator, dtype, device, *, d_ff: int | None = None):
    p = {"ln1": L.init_rms_norm(cfg.d_model, dtype, device)}
    if _mixer_kind(cfg) == "mamba":
        p["mamba"] = S.init_mamba2(cfg, generator, dtype, device)
        return p  # SSM blocks: mixer only, no separate MLP
    p["attn"] = L.init_attention(cfg, generator, dtype, device)
    p["ln2"] = L.init_rms_norm(cfg.d_model, dtype, device)
    p["mlp"] = L.init_mlp(cfg, generator, dtype, device, d_ff=d_ff)
    return p


def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _layer(tree, i: int):
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def init_params(cfg, *, generator: torch.Generator, device=None):
    """Random weights with the reference's distributions (not its numbers:
    ``torch.Generator`` and ``jax.random`` differ)."""
    device = resolve_device(device)
    dtype = _dtype(cfg)
    params: dict = {
        "embed": L.embed_init(generator, (cfg.vocab_size, cfg.d_model),
                              dtype, device)}
    params["layers"] = _stack([
        init_layer(cfg, generator, dtype, device, d_ff=cfg.d_ff)
        for _ in range(cfg.num_layers)])
    params["final_norm"] = L.init_rms_norm(cfg.d_model, dtype, device)
    if not cfg.tie_embeddings:
        params["lm_head"] = L.dense_init(
            generator, (cfg.d_model, cfg.vocab_size), dtype, device)
    return params


# --------------------------------------------------------------------------
# block
# --------------------------------------------------------------------------


def block(cfg, p, x, *, positions, mode: str, layer_cache=None,
          lengths=None):
    """One transformer block.  Returns (x, new_layer_cache).  ``lengths``
    (B,) are the true prompt lengths of a padded prefill; only the SSM
    prefill needs them (pad positions would otherwise enter its state)."""
    h = L.rms_norm(x, p["ln1"]["scale"], cfg.norm_eps)
    if _mixer_kind(cfg) == "mamba":
        if mode == "prefill":
            out, new_cache = S.prefill_mamba_cache(cfg, p["mamba"], h,
                                                   lengths=lengths)
        else:
            out, new_cache = S.mamba2_block(cfg, p["mamba"], h,
                                            layer_cache=layer_cache)
        return x + out, new_cache
    out, new_cache = L.attention(
        cfg, p["attn"], h, positions=positions,
        cache="build" if mode == "prefill" else None, layer_cache=layer_cache)
    x = x + out
    h = L.rms_norm(x, p["ln2"]["scale"], cfg.norm_eps)
    return x + L.mlp(cfg, p["mlp"], h), new_cache


# --------------------------------------------------------------------------
# cache construction
# --------------------------------------------------------------------------


def init_cache(cfg, batch: int, max_seq: int, dtype=None, *, device=None):
    """Zero dense decode cache and the per-row position counter: (k, v)
    stacks (L, B, max_seq, Nkv, H), or for SSM stacks (conv, state) stacks
    (L, B, W-1, C) and (L, B, H, P, N) fp32."""
    device = resolve_device(device)
    dt = _dtype(cfg, dtype)
    n = cfg.num_layers
    if _mixer_kind(cfg) == "mamba":
        layers = (
            torch.zeros((n, batch, cfg.conv_width - 1, S.conv_dim(cfg)),
                        dtype=dt, device=device),
            torch.zeros((n, batch, cfg.ssm_nheads, cfg.ssm_head_dim,
                         cfg.ssm_state_dim), dtype=torch.float32,
                        device=device))
    else:
        shape = (n, batch, max_seq, cfg.num_kv_heads, cfg.head_dim)
        layers = tuple(torch.zeros(shape, dtype=dt, device=device)
                       for _ in range(2))
    return {"layers": layers,
            "pos": torch.zeros((batch,), dtype=torch.int32, device=device)}


def cache_family(cfg) -> str | None:
    """Resolve the cache family this stack pages under (a key into
    ``serving.kvcache.FAMILIES``).  A declared ``cfg.cache_family`` wins;
    otherwise only plain GQA-shaped stacks derive a family -- everything
    else must declare or gets None (no silent dense fallback)."""
    if getattr(cfg, "cache_family", ""):
        return cfg.cache_family
    if cfg.family in ("encdec", "hybrid"):
        return None
    return "gqa" if _mixer_kind(cfg) == "gqa" else None


def supports_paged(cfg) -> bool:
    """Stacks whose decode cache can run in pooled form: GQA k/v block
    pools and SSM state-slab pools (MLA latent pools come with ROADMAP
    A6)."""
    return cache_family(cfg) in ("gqa", "ssm")


def init_paged_cache(cfg, num_blocks: int, block_size: int, dtype=None, *,
                     num_slabs: int = 0, num_segments: int = 0, device=None):
    """Zero pooled decode cache, keyed as :func:`paged_pool_kinds`:

      gqa -- ``layers``: (k, v) block pools (L, NB, BS, Nkv, H)
      ssm -- ``layers``: (conv, state) slab pools (L, NS, W-1, C) and
             (L, NS, H, P, N) fp32 -- constant size, one slab per stream

    Block tables, slab ids and lengths are not part of it: the serving
    engine passes them per decode call."""
    if not supports_paged(cfg):
        raise NotImplementedError(
            f"paged decode cache of family {cache_family(cfg)!r} is not "
            "ported yet (ROADMAP A6-A9)")
    device = resolve_device(device)
    dt = _dtype(cfg, dtype)
    n = cfg.num_layers
    if cache_family(cfg) == "ssm":
        return {"layers": (
            torch.zeros((n, num_slabs, cfg.conv_width - 1, S.conv_dim(cfg)),
                        dtype=dt, device=device),
            torch.zeros((n, num_slabs, cfg.ssm_nheads, cfg.ssm_head_dim,
                         cfg.ssm_state_dim), dtype=torch.float32,
                        device=device))}
    shape = (n, num_blocks, block_size, cfg.num_kv_heads, cfg.head_dim)
    return {"layers": tuple(torch.zeros(shape, dtype=dt, device=device)
                            for _ in range(2))}


def paged_pool_kinds(cfg) -> dict[str, str]:
    """Pool-kind map for the engine's staging: pools-dict key -> "block" |
    "slab"."""
    return {"layers": "slab" if cache_family(cfg) == "ssm" else "block"}


# --------------------------------------------------------------------------
# forward
# --------------------------------------------------------------------------


def embed_tokens(cfg, params, tokens):
    return params["embed"][tokens.long()]


def unembed(cfg, params, x):
    """fp32 logits (the reference accumulates and returns fp32)."""
    table = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return torch.matmul(x.float(), table.float())


def forward(cfg, params, batch, *, mode: str, cache=None):
    """batch: dict with 'tokens' (B,S) (or 'embeds' (B,S,D) for stacks that
    take embeddings), optional 'lengths' (B,) true prompt lengths of a
    padded prefill and 'max_seq' (the prefill cache's padded length).
    Returns (logits, new_cache, aux_loss)."""
    if cfg.embed_inputs and "embeds" in batch:
        x = batch["embeds"]
    else:
        x = embed_tokens(cfg, params, batch["tokens"])
    b, s, _ = x.shape

    if mode == "decode":
        positions = cache["pos"][:, None]
    else:
        positions = torch.arange(s, device=x.device).expand(b, s)
    if cfg.rope_theta == 0.0 and _mixer_kind(cfg) != "mamba":
        raise NotImplementedError("absolute sinusoidal positions are ported "
                                  "with the enc-dec stack (ROADMAP A9)")

    stack = params["layers"]
    n_layers = stack["ln1"]["scale"].shape[0]
    paged = mode == "decode" and cache is not None and (
        "block_tables" in cache or "slab_ids" in cache)
    lengths = batch.get("lengths") if mode == "prefill" else None
    mamba = _mixer_kind(cfg) == "mamba"
    ks, vs = [], []
    for li in range(n_layers):
        if paged and mamba:
            lc = (*cache["layers"], li, cache["slab_ids"])
        elif paged:
            lc = (*cache["layers"], li, cache["block_tables"], cache["pos"])
        elif mode == "decode":
            kc, vc = cache["layers"]
            lc = (kc[li], vc[li], cache["pos"])
        else:
            lc = None
        x, c = block(cfg, _layer(stack, li), x, positions=positions,
                     mode=mode, layer_cache=lc, lengths=lengths)
        if mode == "prefill":
            ks.append(c[0])
            vs.append(c[1])

    x = L.rms_norm(x, params["final_norm"]["scale"], cfg.norm_eps)
    logits = unembed(cfg, params, x)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)

    if mode == "train":
        return logits, None, aux
    if mode == "prefill":
        # per-row true lengths: bucketed prefill batching pads same-bucket
        # prompts to a common length; rows past ``lengths[b]`` hold padding
        # KV that decode masks (and progressively overwrites)
        pos = (lengths.to(torch.int32) if lengths is not None
               else torch.full((b,), s, dtype=torch.int32, device=x.device))
        out_cache = {"layers": (torch.stack(ks), torch.stack(vs)), "pos": pos}
        if mamba:  # constant-size state: no sequence axis to pad
            return logits, out_cache, aux
        return logits, _pad_prefill_cache(cfg, out_cache,
                                          batch.get("max_seq", s)), aux
    out_cache = {"layers": cache["layers"], "pos": cache["pos"] + 1}
    for key in ("block_tables", "slab_ids"):
        if paged and key in cache:
            out_cache[key] = cache[key]
    return logits, out_cache, aux


def _pad_prefill_cache(cfg, cache, max_seq: int):
    """Grow the prefill cache's (L, B, S, ...) stacks to max_seq along the
    sequence axis with zeros."""

    def pad(x):
        if x.shape[2] >= max_seq:
            return x
        out = x.new_zeros((*x.shape[:2], max_seq, *x.shape[3:]))
        out[:, :, : x.shape[2]] = x
        return out

    cache = dict(cache)
    cache["layers"] = tuple(pad(t) for t in cache["layers"])
    return cache
